"""Workflow runtime of the port: model blobs, JSON codec and the engine
(deploy) server. The train and eval workflows arrive with the training
slice."""
