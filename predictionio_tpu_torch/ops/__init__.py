"""Compute ops of the port: plain PyTorch, plus the kernels written by
hand for Hopper where the JAX package has a Pallas kernel (``solve`` <-
``ops/solve_pallas.py``, ``topk_fused`` <- ``ops/topk_pallas.py``).
Kernels build on first use (:mod:`._kernels`), never on import."""
