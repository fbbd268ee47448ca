"""Fused int8 score -> mask -> per-tile top-k (port of
``predictionio_tpu/ops/topk_pallas.py``).

The item axis is cut into tiles of ``tile`` columns. For each tile and
each query row the kernel computes the exact int8 x int8 -> int32 dot
products, rescales them to fp32, masks the layout padding and reduces
the tile to its top ``min(k, tile)`` (score, global index) candidates by
repeated (max, lowest index at the max); the full score row never
reaches device memory. A merge of the ``n_tiles`` candidate lists then
gives the answer in the reference's two-key (-score, index) order. Any
global top-k element is in its own tile's top-k_local, so the result is
BIT-IDENTICAL (values, indices, ties) to ``ops.quant.topk_for_users_quant``
and to the JAX kernel.

On a CUDA tensor :func:`score_mask_topk_candidates` launches kernel B1
and :func:`merge_candidates` kernel B2, both written by hand for Hopper
(``csrc/topk_fused.cu``), or raise; on a CPU tensor they run
:func:`score_mask_topk_candidates_plain` and :func:`merge_candidates_plain`,
the same functions in torch, which play the role the Pallas interpret
mode plays in the JAX package.

``PIO_SERVE_FUSED``: "auto" (default) and "on" take this fused path,
"off" the plain int8 path of ``ops/quant.py``. ``PIO_SERVE_FUSED_TILE``
sets the tile (default 512).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any, NamedTuple, Optional, Tuple

import torch

from predictionio_tpu_torch.ops import _kernels

_DEF_TILE = 512

#: ops.topk.NEG_INF bit for bit
_NEG_INF = -3.4e38
_IMAX = 2 ** 31 - 1

#: launches of kernel B1 (candidates) and of kernel B2 (the merge) since
#: the last reset (the main path's proof that it went through the
#: kernels); each is bumped only where its kernel is launched
launches = 0
merge_launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches, merge_launches
    with _count_lock:
        launches = 0
        merge_launches = 0


def serve_tile() -> int:
    """The item-axis tile (``PIO_SERVE_FUSED_TILE``, default 512)."""
    try:
        t = int(os.environ.get("PIO_SERVE_FUSED_TILE", str(_DEF_TILE)))
    except ValueError:
        return _DEF_TILE
    return max(t, 1)


def fused_mode() -> str:
    """``PIO_SERVE_FUSED`` normalized to auto/on/off."""
    raw = os.environ.get("PIO_SERVE_FUSED", "").lower()
    if raw in ("0", "off"):
        return "off"
    if raw in ("1", "on"):
        return "on"
    return "auto"


def fused_choice() -> bool:
    """Use the fused path? "auto" and "on": yes (the kernel on the card,
    its plain version on the CPU); "off": the plain int8 path."""
    return fused_mode() != "off"


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def int8_scores(Q: torch.Tensor, su: torch.Tensor, vt_q: torch.Tensor,
                v_scale: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 dot products, rescaled as in the reference:
    ``float32(s32) * (su * sv)``. PyTorch has no int8/int32 matmul on
    CUDA, so the dot runs in float64 — exact while |sum| < 2**53 (rank x
    127**2 is far below) — and converts to int32, then fp32."""
    s32 = (Q.to(torch.float64) @ vt_q.to(torch.float64)).to(torch.int32)
    return s32.to(torch.float32) * (su[:, None] * v_scale[None, :])


def score_mask_topk_candidates_plain(
        Q: torch.Tensor, su: torch.Tensor, vt_q: torch.Tensor,
        v_scale: torch.Tensor, *, k_local: int, n_items: int, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in torch over gathered rows ``Q`` (b, r)
    int8 and scales ``su`` (b,): per-tile scores, padding masked, then
    ``k_local`` rounds of (max, lowest global index at the max) with the
    winner masked. Returns (b, n_tiles * k_local) fp32 values and int32
    global indices, tile-major."""
    b = Q.shape[0]
    n_pad = vt_q.shape[1]
    n_tiles = n_pad // tile
    scores = int8_scores(Q, su, vt_q, v_scale)
    gid = torch.arange(n_pad, dtype=torch.int32, device=scores.device)
    neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=scores.device)
    imax = torch.tensor(_IMAX, dtype=torch.int32, device=scores.device)
    scores = torch.where(gid < n_items, scores, neg).view(b, n_tiles, tile)
    gid = gid.view(1, n_tiles, tile)
    vals, idxs = [], []
    for _ in range(k_local):
        m = scores.amax(dim=2, keepdim=True)
        sel = torch.where(scores == m, gid, imax).amin(dim=2, keepdim=True)
        vals.append(m)
        idxs.append(sel)
        scores = torch.where(gid == sel, neg, scores)
    return (torch.cat(vals, dim=2).reshape(b, n_tiles * k_local),
            torch.cat(idxs, dim=2).reshape(b, n_tiles * k_local))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_c = ctypes.c_void_p
_i = ctypes.c_int


class _Library(NamedTuple):
    candidates: Any          # pio_topk_fused_candidates (B1)
    merge: Any               # pio_topk_merge (B2)
    max_tile: int            # widest tile B1 takes
    shared_lists: int        # lists a row may have before B2 needs a workspace


_lib: Optional[_Library] = None


def _library() -> _Library:
    """The built library's entry points and limits, looked up once."""
    global _lib
    if _lib is None:
        lib = _kernels.load("topk_fused")
        cand = lib.pio_topk_fused_candidates
        cand.argtypes = [_c, _c, _c, _c, _c, _c, _c,
                         _i, _i, _i, _i, _i, _i, _c]
        cand.restype = _i
        merge = lib.pio_topk_merge
        merge.argtypes = [_c, _c, _c, _c, _c, _i, _i, _i, _i, _c]
        merge.restype = _i
        lib.pio_topk_fused_max_tile.restype = _i
        lib.pio_topk_merge_shared_lists.restype = _i
        _lib = _Library(cand, merge, lib.pio_topk_fused_max_tile(),
                        lib.pio_topk_merge_shared_lists())
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           ndim: int, device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(
            f"{name}: expected a {ndim}-d {dtype} tensor on {device}, got "
            f"{t.dim()}-d {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(u_q, u_scale, vt_q, v_scale, user_ixs, *, k_local: int,
            n_items: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    dev = vt_q.device
    _check(u_q, "u_q", torch.int8, 2, dev)
    _check(u_scale, "u_scale", torch.float32, 1, dev)
    _check(vt_q, "vt_q", torch.int8, 2, dev)
    _check(v_scale, "v_scale", torch.float32, 1, dev)
    _check(user_ixs, "user_ixs", torch.int32, 1, dev)
    r, n_pad = vt_q.shape
    b = user_ixs.shape[0]
    if u_q.shape[1] != r or v_scale.shape[0] != n_pad \
            or u_scale.shape[0] != u_q.shape[0]:
        raise ValueError("u_q / u_scale / vt_q / v_scale shapes disagree")
    if tile < 1 or n_pad % tile:
        raise ValueError(f"n_pad {n_pad} is not a multiple of tile {tile}")
    lib = _library()
    if tile > lib.max_tile:
        raise ValueError(f"tile {tile} exceeds the kernel's {lib.max_tile} "
                         "columns")
    if not 1 <= k_local <= tile:
        raise ValueError(f"k_local {k_local} outside [1, tile={tile}]")
    width = (n_pad // tile) * k_local
    vals = torch.empty((b, width), dtype=torch.float32, device=dev)
    idx = torch.empty((b, width), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    err = lib.candidates(
        u_q.data_ptr(), u_scale.data_ptr(), vt_q.data_ptr(),
        v_scale.data_ptr(), user_ixs.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), b, r, n_pad, tile, k_local, n_items,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_fused candidates kernel launch failed: "
                           f"CUDA error {err}")
    with _count_lock:
        launches += 1
    return vals, idx


def _launch_merge(vals: torch.Tensor, idx: torch.Tensor, k: int,
                  k_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global merge_launches
    dev = vals.device
    _check(vals, "vals", torch.float32, 2, dev)
    _check(idx, "idx", torch.int32, 2, dev)
    b, width = vals.shape
    if idx.shape != vals.shape:
        raise ValueError("vals and idx shapes disagree")
    if k < 1 or k_local < 1 or width % k_local:
        raise ValueError(f"k {k} / k_local {k_local} do not fit "
                         f"{width} candidates")
    lib = _library()
    n_tiles = width // k_local
    k_out = min(k, width)
    out_v = torch.empty((b, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_out), dtype=torch.int32, device=dev)
    if b == 0:
        return out_v, out_i
    # the lists' heads, when a row has too many for shared memory
    work = (torch.empty((b, n_tiles, 2), dtype=torch.int32, device=dev)
            if n_tiles > lib.shared_lists else None)
    err = lib.merge(vals.data_ptr(), idx.data_ptr(), out_v.data_ptr(),
                    out_i.data_ptr(), None if work is None else work.data_ptr(),
                    b, n_tiles, k_local, k_out,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_fused merge kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        merge_launches += 1
    return out_v, out_i


def score_mask_topk_candidates(
        u_q: torch.Tensor, u_scale: torch.Tensor, vt_q: torch.Tensor,
        v_scale: torch.Tensor, user_ixs: torch.Tensor, *, k_local: int,
        n_items: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile candidates for the rows ``user_ixs`` (in bounds): kernel
    B1 on a CUDA tensor, the plain version on a CPU tensor."""
    if vt_q.device.type == "cuda":
        return _launch(u_q, u_scale, vt_q, v_scale, user_ixs,
                       k_local=k_local, n_items=n_items, tile=tile)
    if vt_q.device.type != "cpu":
        raise ValueError(f"unsupported device {vt_q.device}")
    ix = user_ixs.to(torch.int64)
    return score_mask_topk_candidates_plain(
        u_q.index_select(0, ix), u_scale.index_select(0, ix), vt_q,
        v_scale, k_local=k_local, n_items=n_items, tile=tile)


def merge_candidates_plain(vals: torch.Tensor, idx: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's two-key (-score, index) merge. Candidates lie in
    tile-major order and, within equal values, in ascending index, so a
    stable sort on -score alone reproduces the two-key order."""
    neg, order = torch.sort(-vals, dim=1, stable=True)
    return -neg[:, :k], idx.gather(1, order[:, :k])


def merge_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int, *,
                     k_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``min(k, width)`` candidates of each row in (value
    descending, index ascending) order, from ``n_tiles`` lists of
    ``k_local`` each as :func:`score_mask_topk_candidates` lays them out:
    kernel B2 on a CUDA tensor, :func:`merge_candidates_plain` on a CPU
    tensor."""
    if vals.device.type == "cuda":
        return _launch_merge(vals, idx, int(k), int(k_local))
    if vals.device.type != "cpu":
        raise ValueError(f"unsupported device {vals.device}")
    return merge_candidates_plain(vals, idx, int(k))


def topk_for_users_quant_fused(
        u_q: torch.Tensor, u_scale: torch.Tensor, vt_q: torch.Tensor,
        v_scale: torch.Tensor, user_ixs: torch.Tensor, *, k: int,
        n_items: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused quantized batched serve: per-tile candidates, then the
    merge (two kernel launches on the card). Bit-identical to
    ``ops.quant.topk_for_users_quant``."""
    k_local = min(int(k), int(tile))
    vals, idx = score_mask_topk_candidates(
        u_q, u_scale, vt_q, v_scale, user_ixs, k_local=k_local,
        n_items=n_items, tile=tile)
    return merge_candidates(vals, idx, int(k), k_local=k_local)


# ---------------------------------------------------------------------------
# warm-up registry entries (serving/aot.py; ``pio lint``'s aot-registration
# pass holds this module's kernel-launching defs to the registry)
# ---------------------------------------------------------------------------

def _register() -> None:
    from predictionio_tpu_torch.serving import aot
    aot.register_entry(
        "topk_for_users_quant_fused", topk_for_users_quant_fused,
        kind="serving",
        note="B1 + B2, the fused int8 flush: warmed per bucket by "
             "ALSAlgorithm.aot_serving_programs when the deploy resolved "
             "the fused path")
    aot.register_entry(
        "score_mask_topk_candidates", score_mask_topk_candidates,
        kind="serving",
        note="kernel B1: warmed inside topk_for_users_quant_fused and, "
             "once per slot, inside the sharded int8 serve")
    aot.register_entry(
        "merge_candidates", merge_candidates, kind="serving",
        note="kernel B2: warmed inside topk_for_users_quant_fused and "
             "the sharded int8 serve")


_register()
