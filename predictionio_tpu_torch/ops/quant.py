"""Quantized serving: int8 factor matrices with per-row fp32 scales (port
of the serving half of ``predictionio_tpu/ops/quant.py``).

Each factor row r_i stores ``q_i = round(r_i / s_i)`` as int8 with
``s_i = max|r_i| / 127``. Scoring never dequantizes: the int8 dot
products are exact integers, then ``s32 * (scale_u * scale_v)`` recovers
fp32 scores elementwise, so every quantized path — the plain one here
and the fused kernel (``ops/topk_fused.py``) — gives BIT-IDENTICAL
(values, indices), ties included, and both match the JAX package.

Quantization and the ranking-parity probe are host numpy, as in the
reference: they run once per model load, never on the query path.

Mode resolution (``ServerConfig.serve_quant``, env ``PIO_SERVE_QUANT``
wins): "off" serves fp32, "on" always quantizes, "auto" quantizes on the
card (``cuda``) and only when the ranking-parity probe clears the floor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import devicewatch, telemetry
from predictionio_tpu_torch.ops import topk_fused
from predictionio_tpu_torch.ops.topk import NEG_INF, stable_topk

#: symmetric int8 range: round(row / scale) lands in [-127, 127]
QMAX = 127.0

_F32 = 4


# ---------------------------------------------------------------------------
# quantization (host, once per model load)
# ---------------------------------------------------------------------------

def quantize_rows(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(q, scales)`` with ``q[i] = clip(round(M[i] / scales[i]), -127,
    127)`` and ``scales[i] = max|M[i]| / 127`` (1.0 for an all-zero row)."""
    M = np.asarray(M, dtype=np.float32)
    amax = np.abs(M).max(axis=1)
    scales = np.where(amax > 0, amax / QMAX, 1.0).astype(np.float32)
    q = np.clip(np.rint(M / scales[:, None]), -QMAX, QMAX).astype(np.int8)
    return q, scales


def dequantize_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """The fp32 matrix a (q, scales) pair represents."""
    return q.astype(np.float32) * np.asarray(scales, np.float32)[:, None]


@dataclasses.dataclass
class QuantizedFactors:
    """One model's factor matrices quantized, host numpy. ``recall`` /
    ``exact1`` hold the latest ranking-parity probe."""
    u_q: np.ndarray          # (n_users, rank) int8
    u_scale: np.ndarray      # (n_users,) fp32
    v_q: np.ndarray          # (n_items, rank) int8
    v_scale: np.ndarray      # (n_items,) fp32
    recall: Optional[float] = None
    exact1: Optional[float] = None

    @classmethod
    def from_factors(cls, user_factors, item_factors) -> "QuantizedFactors":
        u_q, u_scale = quantize_rows(user_factors)
        v_q, v_scale = quantize_rows(item_factors)
        return cls(u_q=u_q, u_scale=u_scale, v_q=v_q, v_scale=v_scale)

    @property
    def n_users(self) -> int:
        return int(self.u_q.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.v_q.shape[0])

    @property
    def rank(self) -> int:
        return int(self.u_q.shape[1])


# ---------------------------------------------------------------------------
# ranking-parity probe (the deploy-time gate value)
# ---------------------------------------------------------------------------

def ranking_parity(user_factors, item_factors, qf: QuantizedFactors,
                   k: int = 10, sample: int = 256) -> Dict[str, Any]:
    """recall@k and exact-match@1 of the quantized ranking against the
    fp32 ranking on a deterministic evenly spaced user sample, ties by
    lowest item index. Host numpy, deploy time only."""
    U = np.asarray(user_factors, np.float32)
    V = np.asarray(item_factors, np.float32)
    n_users, n_items = U.shape[0], V.shape[0]
    k = min(int(k), n_items)
    take = min(int(sample), n_users)
    ixs = np.unique(np.linspace(0, n_users - 1, take).astype(np.int64))
    sf = U[ixs] @ V.T
    s32 = qf.u_q[ixs].astype(np.int32) @ qf.v_q.astype(np.int32).T
    sq = s32.astype(np.float32) * (qf.u_scale[ixs][:, None]
                                   * qf.v_scale[None, :])
    top_f = np.argsort(-sf, axis=1, kind="stable")[:, :k]
    top_q = np.argsort(-sq, axis=1, kind="stable")[:, :k]
    inter = np.asarray([np.intersect1d(a, b).size
                        for a, b in zip(top_f, top_q)])
    return {
        "k": k,
        "sampledUsers": int(ixs.size),
        "recall": float(np.mean(inter / k)),
        "exact1": float(np.mean(top_f[:, 0] == top_q[:, 0])),
    }


def ranking_agreement(user_factors_a, item_factors_a,
                      user_factors_b, item_factors_b,
                      k: int = 10, sample: int = 256,
                      user_map: Optional[np.ndarray] = None,
                      item_map: Optional[np.ndarray] = None
                      ) -> Dict[str, Any]:
    """recall@k and exact-match@1 of factor pair B's ranking against
    factor pair A's, on the sample and tie rule of :func:`ranking_parity`,
    for any two models over a common vocabulary (autotrain's parity gate:
    a retrain candidate against the live generation). Host numpy.

    ``user_map`` / ``item_map`` align B's index space to A's: entry i is
    B's index for A's user / item i (identity when omitted). The figure
    reads "of A's top k, how many does B also rank top k"."""
    Ua = np.asarray(user_factors_a, np.float32)
    Va = np.asarray(item_factors_a, np.float32)
    Ub = np.asarray(user_factors_b, np.float32)
    Vb = np.asarray(item_factors_b, np.float32)
    n_users = Ua.shape[0]
    if user_map is None:
        user_map = np.arange(min(n_users, Ub.shape[0]), dtype=np.int64)
    else:
        user_map = np.asarray(user_map, np.int64)
    if item_map is None:
        item_map = np.arange(min(Va.shape[0], Vb.shape[0]),
                             dtype=np.int64)
    else:
        item_map = np.asarray(item_map, np.int64)
    n_common_users = int(user_map.shape[0])
    n_common_items = int(item_map.shape[0])
    if n_common_users == 0 or n_common_items == 0:
        return {"k": 0, "sampledUsers": 0, "commonItems": 0,
                "recall": 0.0, "exact1": 0.0}
    k = min(int(k), n_common_items)
    take = min(int(sample), n_common_users)
    pick = np.unique(np.linspace(0, n_common_users - 1,
                                 take).astype(np.int64))
    sa = Ua[pick] @ Va[item_map].T
    sb = Ub[user_map[pick]] @ Vb[item_map].T
    top_a = np.argsort(-sa, axis=1, kind="stable")[:, :k]
    top_b = np.argsort(-sb, axis=1, kind="stable")[:, :k]
    inter = np.asarray([np.intersect1d(a, b).size
                        for a, b in zip(top_a, top_b)])
    return {
        "k": k,
        "sampledUsers": int(pick.size),
        "commonItems": n_common_items,
        "recall": float(np.mean(inter / max(k, 1))),
        "exact1": float(np.mean(top_a[:, 0] == top_b[:, 0])),
    }


def recall_floor() -> float:
    """recall@k below which "auto" refuses to quantize
    (``PIO_SERVE_QUANT_RECALL_MIN``, default 0.99)."""
    try:
        return float(os.environ.get("PIO_SERVE_QUANT_RECALL_MIN", "0.99"))
    except ValueError:
        return 0.99


def accept_parity(parity: Dict[str, Any],
                  mode: Optional[str] = None) -> bool:
    """"on" always serves quantized; "auto" needs recall@k >= the floor."""
    if configured_mode(mode) == "on":
        return True
    return float(parity.get("recall", 0.0)) >= recall_floor()


# ---------------------------------------------------------------------------
# mode resolution: ServerConfig.serve_quant + PIO_SERVE_QUANT
# ---------------------------------------------------------------------------

_scope = threading.local()


def _normalize_mode(mode: str) -> str:
    m = (mode or "auto").lower()
    if m in ("0", "off"):
        return "off"
    if m in ("1", "on"):
        return "on"
    if m == "auto":
        return "auto"
    raise ValueError(f"serve-quant mode must be auto/on/off, got {mode!r}")


def configured_mode(mode: Optional[str] = None) -> str:
    """Effective mode: ``PIO_SERVE_QUANT`` wins over the config value."""
    env = os.environ.get("PIO_SERVE_QUANT", "")
    if env:
        return _normalize_mode(env)
    if mode is not None:
        return _normalize_mode(mode)
    return _normalize_mode(getattr(_scope, "mode", "auto"))


@contextlib.contextmanager
def deploy_scope(mode: str, device: device_mod.DeviceLike = None):
    """Install the deploy's serve-quant mode and device for the calling
    thread (``QueryAPI`` wraps ``prepare_serving`` in it). Validates the
    mode eagerly so a bad config fails the deploy, not a query."""
    _normalize_mode(mode)
    prev = (getattr(_scope, "mode", None), getattr(_scope, "device", None))
    _scope.mode, _scope.device = mode, device
    try:
        yield
    finally:
        _scope.mode, _scope.device = prev


def scoped_device() -> torch.device:
    """The device of the enclosing :func:`deploy_scope` (resolved by the
    device policy when the scope names none)."""
    return device_mod.resolve(getattr(_scope, "device", None))


def serving_enabled(mode: Optional[str] = None) -> bool:
    """Should prepare_serving quantize? "auto" is true on the card (the
    probe's verdict is :func:`accept_parity`'s half of the decision)."""
    m = configured_mode(mode)
    if m == "off":
        return False
    if m == "on":
        return True
    return scoped_device().type == "cuda"


def record_state(summary: Optional[Dict[str, Any]]) -> None:
    """Publish (or with None, clear) the live quantized-serving state:
    ``pio_serve_quant_mode``, the ``pio_serve_factor_bytes{dtype}``
    pair, ``pio_serve_quant_recall{metric}``, and the
    /debug/device.json quant block."""
    reg = telemetry.registry()
    active = bool(summary and summary.get("enabled"))
    reg.gauge(
        "pio_serve_quant_mode",
        "1 while the deployed factor matrices serve quantized (int8 + "
        "per-row scales); 0 = fp32 serving").labels().set(
            1.0 if active else 0.0)
    g_bytes = reg.gauge(
        "pio_serve_factor_bytes",
        "Deployed factor-matrix bytes by dtype: the live serving "
        "footprint (int8 includes the fp32 scale vectors) next to its "
        "fp32 equivalent", labelnames=("dtype",))
    g_recall = reg.gauge(
        "pio_serve_quant_recall",
        "Most recent deploy-time ranking-parity probe of the quantized "
        "path vs fp32 (recall@k and exact-match@1)",
        labelnames=("metric",))
    if active:
        g_bytes.labels(dtype="int8").set(float(summary.get("int8Bytes", 0)))
        g_bytes.labels(dtype="fp32").set(float(summary.get("fp32Bytes", 0)))
        if summary.get("recall") is not None:
            g_recall.labels(metric="recall").set(float(summary["recall"]))
        if summary.get("exact1") is not None:
            g_recall.labels(metric="exact1").set(float(summary["exact1"]))
    else:
        g_bytes.labels(dtype="int8").set(0.0)
        g_bytes.labels(dtype="fp32").set(0.0)
    devicewatch.note_quant(summary)


# ---------------------------------------------------------------------------
# the plain int8 serving path (PIO_SERVE_FUSED=off, and the inline query)
# ---------------------------------------------------------------------------

def _masked_scores(Q, su, vt_q, v_scale, n_items: int) -> torch.Tensor:
    scores = topk_fused.int8_scores(Q, su, vt_q, v_scale)
    gid = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(gid < n_items, scores,
                       torch.tensor(NEG_INF, dtype=torch.float32,
                                    device=scores.device))


def topk_for_users_quant(u_q: torch.Tensor, u_scale: torch.Tensor,
                         vt_q: torch.Tensor, v_scale: torch.Tensor,
                         user_ixs: torch.Tensor, *, k: int, n_items: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched quantized serve: B int8 row gathers, the exact int8 dot,
    the elementwise rescale, padding columns masked, stable top-k.
    ``user_ixs`` must be in bounds."""
    ix = user_ixs.to(torch.int64)
    scores = _masked_scores(u_q.index_select(0, ix),
                            u_scale.index_select(0, ix), vt_q, v_scale,
                            n_items)
    return stable_topk(scores, k)


def topk_for_user_quant(u_q: torch.Tensor, u_scale: torch.Tensor,
                        vt_q: torch.Tensor, v_scale: torch.Tensor,
                        user_ix: int, *, k: int, n_items: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inline single-query quantized serve; bit-identical to a row of the
    batched path."""
    ix = int(user_ix)
    scores = _masked_scores(u_q[ix:ix + 1], u_scale[ix:ix + 1], vt_q,
                            v_scale, n_items)
    vals, idx = stable_topk(scores, k)
    return vals[0], idx[0]


# ---------------------------------------------------------------------------
# fold-in publication (realtime/foldin.py): the touched rows re-quantized
# ---------------------------------------------------------------------------

def scatter_user_rows_quant(u_q: torch.Tensor, u_scale: torch.Tensor,
                            ixs: torch.Tensor, q_rows: torch.Tensor,
                            scales: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NEW ``(u_q, u_scale)`` with the int8 rows and their per-row scales
    replaced at ``ixs`` (in bounds; duplicate indices carry identical
    rows). Per-row symmetric quantization keeps the re-quantization of
    the touched rows local and exact; the caller swaps a rebuilt
    :class:`QuantizedServing` in one reference assignment."""
    ix = ixs.to(device=u_q.device, dtype=torch.int64)
    return (u_q.index_copy(0, ix, q_rows.to(u_q.device, torch.int8)),
            u_scale.index_copy(0, ix, scales.to(u_scale.device,
                                                torch.float32)))


def scatter_item_cols_quant(vt_q: torch.Tensor, v_scale: torch.Tensor,
                            ixs: torch.Tensor, q_rows: torch.Tensor,
                            scales: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The item side of :func:`scatter_user_rows_quant`: the items serve
    TRANSPOSED, so the folded item rows land as COLUMNS of ``vt_q``,
    with their per-item scales."""
    ix = ixs.to(device=vt_q.device, dtype=torch.int64)
    cols = q_rows.to(vt_q.device, torch.int8).T.contiguous()
    return (vt_q.index_copy(1, ix, cols),
            v_scale.index_copy(0, ix, scales.to(v_scale.device,
                                                torch.float32)))


def _quantized_rows(ixs, rows_fp32):
    q_rows, scales = quantize_rows(np.asarray(rows_fp32, np.float32))
    return (torch.from_numpy(np.asarray(ixs, np.int64).reshape(-1)),
            torch.from_numpy(q_rows), torch.from_numpy(scales))


# ---------------------------------------------------------------------------
# the device layout
# ---------------------------------------------------------------------------

def padded_items(n_items: int, tile: int) -> int:
    """The item columns the int8 layout holds: ``n_items`` rounded up to
    the fused kernel's tile."""
    return -(-max(n_items, 1) // tile) * tile


def layout_bytes(n_users: int, n_items: int, rank: int, *,
                 int8: bool) -> int:
    """Bytes the replicated serving layout of factors of these dims
    holds on the device, known before anything is placed: the four
    tensors of :meth:`QuantizedServing.build` (int8), or the two fp32
    matrices."""
    if not int8:
        return _F32 * rank * (n_users + n_items)
    n_pad = padded_items(n_items, topk_fused.serve_tile())
    return (rank + _F32) * n_users + (rank + _F32) * n_pad

@dataclasses.dataclass
class QuantizedServing:
    """One model's quantized factors on the serving device. The item
    matrix lives TRANSPOSED, ``(rank, n_pad)`` with n_pad rounded up to
    the fused kernel's tile and 0 scales on the pad columns, so one
    layout serves both the fused and the plain path. ``fused`` is
    resolved once at build (``PIO_SERVE_FUSED``)."""
    u_q: torch.Tensor        # (n_users, r) int8
    u_scale: torch.Tensor    # (n_users,) fp32
    vt_q: torch.Tensor       # (r, n_pad) int8
    v_scale: torch.Tensor    # (n_pad,) fp32, 0 on pad columns
    n_users: int
    n_items: int
    rank: int
    tile: int
    fused: bool
    device: torch.device
    recall: Optional[float] = None
    exact1: Optional[float] = None

    @classmethod
    def build(cls, qf: QuantizedFactors,
              device: device_mod.DeviceLike = None) -> "QuantizedServing":
        dev = device_mod.resolve(device)
        tile = topk_fused.serve_tile()
        n_items = qf.n_items
        n_pad = padded_items(n_items, tile)
        vt = np.zeros((qf.rank, n_pad), dtype=np.int8)
        vt[:, :n_items] = qf.v_q.T
        sv = np.zeros((n_pad,), dtype=np.float32)
        sv[:n_items] = qf.v_scale
        return cls(
            u_q=torch.from_numpy(np.ascontiguousarray(qf.u_q)).to(dev),
            u_scale=torch.from_numpy(qf.u_scale).to(dev),
            vt_q=torch.from_numpy(vt).to(dev),
            v_scale=torch.from_numpy(sv).to(dev),
            n_users=qf.n_users, n_items=n_items, rank=qf.rank,
            tile=tile, fused=topk_fused.fused_choice(), device=dev,
            recall=qf.recall, exact1=qf.exact1)

    def _checked(self, user_ixs) -> np.ndarray:
        """Host-side bounds check: an out-of-range row would read past
        the factor matrix on the card."""
        ixs = np.asarray(user_ixs, dtype=np.int32).reshape(-1)
        if ixs.size and (ixs.min() < 0 or ixs.max() >= self.n_users):
            raise IndexError(
                f"user index out of [0, {self.n_users}): "
                f"{ixs.min()}..{ixs.max()}")
        return ixs

    def topk(self, user_ixs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k for host ``user_ixs``: the fused path (the kernel
        on the card) or the plain int8 path."""
        ixs = torch.from_numpy(self._checked(user_ixs)).to(self.device)
        if self.fused:
            return topk_fused.topk_for_users_quant_fused(
                self.u_q, self.u_scale, self.vt_q, self.v_scale, ixs,
                k=int(k), n_items=self.n_items, tile=self.tile)
        return topk_for_users_quant(
            self.u_q, self.u_scale, self.vt_q, self.v_scale, ixs,
            k=int(k), n_items=self.n_items)

    def topk_one(self, user_ix, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        self._checked(user_ix)
        return topk_for_user_quant(
            self.u_q, self.u_scale, self.vt_q, self.v_scale, int(user_ix),
            k=int(k), n_items=self.n_items)

    def apply_user_rows(self, ixs, rows_fp32) -> "QuantizedServing":
        """A NEW QuantizedServing with ``rows_fp32`` re-quantized per row
        and scattered into the user matrix at ``ixs``; the item layout is
        untouched (fold-in's fixed item matrix). The caller publishes by
        swapping its model's ``quant`` reference, so every query in
        flight reads one consistent (rows, scales) pair."""
        ix, q_rows, scales = _quantized_rows(ixs, rows_fp32)
        new_q, new_s = scatter_user_rows_quant(
            self.u_q, self.u_scale, ix, q_rows, scales)
        return dataclasses.replace(self, u_q=new_q, u_scale=new_s)

    def apply_item_rows(self, ixs, rows_fp32) -> "QuantizedServing":
        """The item side of :meth:`apply_user_rows`: ``rows_fp32``
        re-quantized per row and scattered as COLUMNS of the transposed
        item layout at ``ixs`` (the item headroom padded at deploy;
        ``n_items`` counts it, so no shape changes)."""
        ix, q_rows, scales = _quantized_rows(ixs, rows_fp32)
        new_vt, new_s = scatter_item_cols_quant(
            self.vt_q, self.v_scale, ix, q_rows, scales)
        return dataclasses.replace(self, vt_q=new_vt, v_scale=new_s)

    def int8_bytes(self) -> int:
        """Logical footprint (int8 matrices + fp32 scales), pad excluded."""
        rows = self.n_users + self.n_items
        return rows * self.rank + rows * _F32

    def fp32_bytes(self) -> int:
        return (self.n_users + self.n_items) * self.rank * _F32

    def summary(self) -> Dict[str, Any]:
        return {
            "dtype": "int8",
            "fused": bool(self.fused),
            # the CPU runs the kernel's plain version, as the JAX
            # package's interpret mode does off the TPU
            "interpret": bool(self.fused and self.device.type == "cpu"),
            "tile": int(self.tile),
            "int8Bytes": self.int8_bytes(),
            "fp32Bytes": self.fp32_bytes(),
            "recall": self.recall,
            "exact1": self.exact1,
        }
