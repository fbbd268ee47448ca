"""Command-line tools of the port
(``python -m predictionio_tpu_torch.tools.cli``)."""
