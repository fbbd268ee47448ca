"""PyTorch/CUDA port of the prediction server, beside the JAX package.

The module tree mirrors ``predictionio_tpu`` so each module's
counterpart is found by path. The port imports ``torch`` and never
``jax`` nor any module of ``predictionio_tpu``: what it needs from the
host-only modules there it keeps as its own copy. Its entry points run
on the CUDA card unless the caller asks for the CPU (:mod:`.device`).

Slice 1 serves: ``QueryAPI`` loads an ALS model blob, quantizes it to
int8 and answers ``POST /queries.json`` through the micro-batcher and
the hand-written score->top-k kernel (``csrc/topk_fused.cu``). Slice 2
trains: ``pio train`` (``tools/cli.py``) reads the event store or the
synthetic generator, lays the ratings out on the card and runs explicit
ALS, each half-step ending in the hand-written batched solve
(``csrc/solve_gj.cu``), and stores the model blob.
"""

__version__ = "0.1.0"
