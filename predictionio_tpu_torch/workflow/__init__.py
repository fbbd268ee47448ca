"""Workflow runtime of the port: the train workflow (context, run_train,
iteration checkpoints), model blobs, JSON codec and the engine (deploy)
server. The evaluation workflow waits for the evaluation slice."""
