"""Workflow runtime of the port: the train and evaluation workflows
(context, run_train, run_evaluation with its prefix-memoized grid,
iteration checkpoints), model blobs, JSON codec and the engine (deploy)
server."""
