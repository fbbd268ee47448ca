"""Batched small SPD solve: the ALS per-row normal equations (port of
``predictionio_tpu/ops/solve_pallas.py`` and of the Gauss-Jordan sweep in
``predictionio_tpu/ops/als.py::solve_factors``).

For n systems it solves ``(A + reg I) x = b`` by unpivoted Gauss-Jordan on
the augmented (r, r+1) matrix, with true division and every pivot's
magnitude floored at ``0.5 * reg``, its sign kept. Pivoting is not needed:
A is PSD and reg > 0 keeps every Schur diagonal >= reg; the floor bounds
the solution of a row whose Gram rounding made it indefinite (see the
reference's ``solve_factors`` docstring).

On a CUDA tensor :func:`solve_factors` launches the kernel written by hand
for Hopper (``csrc/solve_gj.cu``, kernel A) for every r <= 32, or raises;
on a CPU tensor it runs :func:`solve_gj_plain`, the reference's sweep
transcribed to torch. The kernel rounds every operation as the eager
plain version does, so the two agree bit for bit on the card. For r > 32
both devices call ``torch.linalg.solve`` on ``A + reg I``, as the
reference calls ``jnp.linalg.solve`` there.

Kernel A is one template, one instance per rank: a group of P x Q lanes
owns a system, each lane holding a cyclic share of its rows and columns
in registers (one lane at r <= 2 up to 4 x 4 lanes at r > 23). Per pivot
the lanes of the pivot row divide their entries once each and shuffle
them down their columns, and the factors travel along the rows. The
function is bound by bytes (each system's A read once), but the kernel
is bound by instruction issue above r = 5; PERF.md gives its times beside
the bound.

The reference makes its Pallas kernel opt-in (``PIO_ALS_SOLVER=pallas``
on a TPU) and otherwise runs the same sweep in XLA. The port has no XLA,
so on the card the kernel is the only solver: ``PIO_ALS_SOLVER`` is not
read, and either of its values means kernel A on ``cuda``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from predictionio_tpu_torch.ops import _kernels

#: ranks the kernel takes (the reference's limit)
MAX_RANK = 32

#: kernel launches since the last reset (the main path's proof that it
#: went through the kernel); bumped only where the kernel is launched
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def with_reg(A: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """``A + reg I`` over the batch, as the reference adds it."""
    r = A.shape[-1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    return A + reg[:, None, None] * eye[None]


def solve_gj_plain(A: torch.Tensor, b: torch.Tensor,
                   reg: torch.Tensor) -> torch.Tensor:
    """The reference's sweep (``ops/als.py:737-749``) in torch: r
    elementwise passes over the (n, r, r+1) augmented batch."""
    r = A.shape[-1]
    M = torch.cat([with_reg(A, reg), b[..., None]], dim=2)
    floor = (0.5 * reg)[:, None, None]
    for k in range(r):
        d0 = M[:, k:k + 1, k:k + 1]
        den = torch.where(d0 >= 0, torch.maximum(d0, floor),
                          torch.minimum(d0, -floor))
        piv = M[:, k:k + 1, :] / den
        M = M - M[:, :, k:k + 1] * piv
        M[:, k, :] = piv[:, 0, :]
    return M[:, :, r]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _kernels.load("solve_gj")
    fn = lib.pio_solve_gj
    if fn.argtypes is None:
        c = ctypes.c_void_p
        fn.argtypes = [c, c, c, c, ctypes.c_int, ctypes.c_int, c]
        fn.restype = ctypes.c_int
    return lib


def _launch(A: torch.Tensor, b: torch.Tensor,
            reg: torch.Tensor) -> torch.Tensor:
    global launches
    dev = A.device
    n, r = b.shape
    for name, t, shape in (("A", A, (n, r, r)), ("b", b, (n, r)),
                           ("reg", reg, (n,))):
        if t.dtype != torch.float32 or t.device != dev \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected a float32 tensor of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"the kernel takes ranks 1..{MAX_RANK}, got {r}")
    x = torch.empty((n, r), dtype=torch.float32, device=dev)
    if n == 0:
        return x
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pio_solve_gj(A.data_ptr(), b.data_ptr(), reg.data_ptr(),
                           x.data_ptr(), n, r, stream)
    if err != 0:
        raise RuntimeError(f"solve_gj kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return x


def solve_factors(A: torch.Tensor, b: torch.Tensor,
                  reg: torch.Tensor) -> torch.Tensor:
    """Batched ``(A + reg I) x = b`` over the leading axis: (n, r, r),
    (n, r), (n,) -> (n, r). Kernel A on a CUDA tensor, the plain sweep on
    a CPU tensor; ``torch.linalg.solve`` for r > 32."""
    r = A.shape[-1]
    if r > MAX_RANK:
        return torch.linalg.solve(with_reg(A, reg), b[..., None])[..., 0]
    if A.device.type == "cuda":
        return _launch(A.contiguous(), b.contiguous(), reg.contiguous())
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return solve_gj_plain(A, b, reg)
