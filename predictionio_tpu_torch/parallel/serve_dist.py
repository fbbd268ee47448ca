"""Sharded serving: top-k answers from row-sharded factor matrices (port
of ``predictionio_tpu/parallel/serve_dist.py``).

Layout. Both factor matrices are cut into contiguous row blocks of
``rows_dev = ceil(n / n_slots)`` rows, one block per slot of a
:class:`~predictionio_tpu_torch.parallel.mesh.Mesh` (training's LPT deal
degenerates to this under serving's uniform per-row cost). A slot's
global ids are its base plus the local index, so ascending local order is
ascending global order and each slot's lowest-index tie rule composes
into the global one.

A query batch (the quantized form; the fp32 form is the same shape in
torch ops):

1. the batch's user rows: on a local mesh kernel B1 gathers them from
   this process's user rows itself; on a world mesh each rank
   contributes the rows it owns and an all_reduce sum (int32, exact)
   replicates them;
2. per slot, kernel B1 (``ops.topk_fused.score_mask_topk_candidates``)
   over the slot's int8 item block: exact int8 x int8 scores, the
   elementwise rescale, the slot's padding masked, per-tile top
   ``min(k, tile)`` candidates, whose indices take the slot's base;
3. the slots' candidate lists, gathered (a concatenation on one
   process, an all_gather between ranks) in slot order, go to ONE
   kernel B2 (``ops.topk_fused.merge_candidates``) call.

So a flush launches B1 once per slot and B2 once. B2 merges lists in
(value descending, lowest list) order; the lists are in ascending global
id, so its order is the two-key (-score, index) order. Scores are exact
integers rescaled elementwise, so the answers (values, indices, ties)
are BIT-IDENTICAL to the replicated B1 + B2 path and to the plain int8
path at every slot count. A slot's pad columns score -3.4e38 and carry
ids past the slot's real rows; ``k`` never exceeds the real item count,
so none reaches an answer. B2 takes any number of lists (its heads move
from shared memory to a workspace past its shared-memory limit), so the
gathered lists need no change to it.

The warm-up before ready runs the sharded serve once per bucket
(:func:`sharded_program_specs`). The reference's scatter program specs
have no counterpart: the fold-in scatters are torch index copies, which
build and load nothing, as on the replicated int8 layout.

Mode (``pio deploy --shard-serving auto/on/off``, ``PIO_SERVE_SHARD``
wins): "on" always shards, over every device of the deploy's world (one
on a one-card machine: one slot); "off" never; "auto" shards on a
multi-card accelerator world only, and stays replicated during a
``/reload``. Unlike the reference, a failed sharded layout fails the
deploy: there is no replicated fallback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import devicewatch, telemetry
from predictionio_tpu_torch.ops import topk_fused
from predictionio_tpu_torch.ops.topk import NEG_INF, stable_topk
from predictionio_tpu_torch.parallel import mesh as mesh_mod
from predictionio_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger("predictionio_tpu_torch.serve_dist")

#: the merge strategy this module implements (doctor and GET / show it)
MERGE_STRATEGY = "all_gather"

#: mesh axis name for serving shards (training's is "block")
AXIS = "shard"


# ---------------------------------------------------------------------------
# mode resolution: ServerConfig.shard_serving + PIO_SERVE_SHARD
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
    raise ValueError(f"shard-serving mode must be auto/on/off, got {mode!r}")


def configured_mode(mode: Optional[str] = None) -> str:
    """Effective mode: ``PIO_SERVE_SHARD`` wins over the config value."""
    env = os.environ.get("PIO_SERVE_SHARD", "")
    if env:
        return _normalize_mode(env)
    if mode is not None:
        return _normalize_mode(mode)
    return _normalize_mode(getattr(_scope, "mode", "auto"))


@contextlib.contextmanager
def deploy_scope(mode: str, reload: bool = False,
                 device: device_mod.DeviceLike = None):
    """Install the deploy's shard-serving mode (and device) for the
    calling thread; ``QueryAPI``'s load wraps ``prepare_serving`` in it.
    Validates eagerly, so a bad config fails the deploy, not a query."""
    _normalize_mode(mode)
    prev = (getattr(_scope, "mode", None), getattr(_scope, "reload", None),
            getattr(_scope, "device", None))
    _scope.mode, _scope.reload, _scope.device = mode, bool(reload), device
    try:
        yield
    finally:
        _scope.mode, _scope.reload, _scope.device = prev


def scoped_device() -> torch.device:
    """This process's device for the enclosing :func:`deploy_scope`."""
    return mesh_mod.process_device(getattr(_scope, "device", None))


def _multi_device_platform() -> bool:
    """A multi-card accelerator world? (Tests monkeypatch it to drive
    "auto".)"""
    return (mesh_mod.local_device_count() > 1
            and scoped_device().type == "cuda")


def serving_enabled(mode: Optional[str] = None) -> bool:
    """Should prepare_serving lay this model out sharded?"""
    m = configured_mode(mode)
    if m == "off":
        return False
    if m == "on":
        return True
    if getattr(_scope, "reload", False):
        return False
    return _multi_device_platform()


# ---------------------------------------------------------------------------
# partition-routed serving (the cross-process twin of the merge)
# ---------------------------------------------------------------------------

def parse_partition(spec: str) -> Tuple[int, int]:
    """Parse a ``--partition i/N`` scope into (index, count); 0 <= i < N,
    N >= 1, else ValueError, so a typo'd fleet never serves the wrong
    rows."""
    txt = str(spec).strip()
    try:
        left, right = txt.split("/", 1)
        index, count = int(left), int(right)
    except ValueError:
        raise ValueError(
            f"--partition must look like i/N (got {spec!r})") from None
    if count < 1 or not 0 <= index < count:
        raise ValueError(
            f"--partition index out of range: {index}/{count}")
    return index, count


def partition_rows(n_items: int, index: int, count: int) -> Tuple[int, int]:
    """Contiguous row range [lo, hi) of partition ``index`` of ``count``:
    the floor split every partition computes alone, so the fleet tiles
    [0, n_items) exactly."""
    lo = index * n_items // count
    hi = (index + 1) * n_items // count
    return lo, hi


def merge_candidates(values, gids, k: int):
    """Host twin of the merge: two-key stable sort by (-value, global
    index ascending), truncated to ``k``. ``values``/``gids`` are one
    query's concatenated per-partition candidates. Returns
    (merged_values, merged_gids, order), ``order`` indexing the
    concatenated inputs. Signed zeros tie here (-0.0 == +0.0)."""
    v = np.asarray(values)
    g = np.asarray(gids)
    order = np.lexsort((g, -v))[:max(int(k), 0)]
    return v[order], g[order], order


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def _rows_dev(n: int, n_dev: int) -> int:
    return max(-(-n // n_dev), 1)


def _padded(n: int, tile: int) -> int:
    return -(-n // tile) * tile


def layout_bytes(n_users: int, n_items: int, rank: int, *, int8: bool,
                 mesh: Optional[Mesh] = None) -> int:
    """Bytes :func:`shard_factors` places in this process for factors of
    these dims, known before it runs: per local slot, the user rows and
    the item block (int8 with their fp32 scales, the item block padded
    to the tile, or fp32)."""
    if mesh is None:
        mesh = mesh_mod.get_mesh(None, axis_name=AXIS,
                                 device=scoped_device())
    rows_u = _rows_dev(n_users, mesh.size)
    rows_i = _rows_dev(n_items, mesh.size)
    n_slots = len(mesh.local_slots)
    if not int8:
        return n_slots * 4 * rank * (rows_u + rows_i)
    n_pad = _padded(rows_i, topk_fused.serve_tile())
    return (rank + 4) * (n_slots * rows_u + n_slots * n_pad)


@dataclasses.dataclass
class ShardedFactors:
    """One model's factors laid out for sharded serving on ``mesh``.

    This process holds its slots' blocks on ``mesh.local_device``:
    ``user_rows`` is the concatenation of its slots' user blocks
    (``rows_dev_u`` rows each, zero rows past ``n_users``) and
    ``user_base`` the global id of its first row. ``item_shards[d]`` is
    slot d's item block: fp32 ``(rows_dev_i, rank)``, or for int8 the
    TRANSPOSED ``(rank, n_pad_i)`` block B1 reads (``n_pad_i`` =
    ``rows_dev_i`` rounded up to the tile, 0 scales on pad columns).
    Global item id = ``d * rows_dev_i`` + local column."""
    mesh: Mesh
    n_users: int
    n_items: int
    rank: int
    rows_dev_u: int
    rows_dev_i: int
    user_rows: torch.Tensor
    user_base: int
    item_shards: Dict[int, torch.Tensor]
    user_scales: Optional[torch.Tensor] = None
    item_scales: Optional[Dict[int, torch.Tensor]] = None
    dtype: str = "float32"
    tile: int = 0
    quant_recall: Optional[float] = None
    quant_exact1: Optional[float] = None

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def device(self) -> torch.device:
        return self.mesh.local_device

    def user_shard(self, d: int) -> torch.Tensor:
        """Slot ``d``'s user block (this process's slots only)."""
        lo = d * self.rows_dev_u - self.user_base
        return self.user_rows[lo:lo + self.rows_dev_u]

    def items_real(self, d: int) -> int:
        """Real item rows in slot ``d``'s block."""
        return max(0, min(self.rows_dev_i,
                          self.n_items - d * self.rows_dev_i))

    def per_shard_bytes(self) -> int:
        """One slot's factor bytes (padded rows included); int8 counts
        its fp32 per-row scales."""
        rows = self.rows_dev_u + self.rows_dev_i
        if self.dtype == "int8":
            return rows * self.rank + rows * 4
        return rows * self.rank * 4

    def topk(self, user_ixs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k for host ``user_ixs`` (in bounds): the drop-in
        replacement for the replicated call."""
        if self.dtype == "int8":
            return topk_for_users_sharded_quant(self, user_ixs, k)
        return topk_for_users_sharded(self, user_ixs, k)

    @property
    def user_capacity(self) -> int:
        """Padded user-row capacity (rows_dev_u * n_slots)."""
        return int(self.rows_dev_u) * self.n_shards

    @property
    def item_capacity(self) -> int:
        return int(self.rows_dev_i) * self.n_shards

    def apply_user_rows(self, ixs, rows_fp32) -> "ShardedFactors":
        """A NEW ShardedFactors with ``rows_fp32`` at global user rows
        ``ixs`` (int8 layouts re-quantize exactly those rows); each
        process applies the rows its slots own. The caller publishes by
        swapping its model's ``sharding`` reference."""
        ixs = np.asarray(ixs, dtype=np.int64).reshape(-1)
        rows = np.asarray(rows_fp32, dtype=np.float32).reshape(
            len(ixs), self.rank)
        if self.dtype == "int8":
            new_q, new_s = scatter_user_rows_sharded_quant(self, ixs, rows)
            return dataclasses.replace(self, user_rows=new_q,
                                       user_scales=new_s)
        return dataclasses.replace(
            self, user_rows=scatter_user_rows_sharded(self, ixs, rows))

    def apply_item_rows(self, ixs, rows_fp32) -> "ShardedFactors":
        """The item side of :meth:`apply_user_rows`: each folded item row
        lands in its owning slot's block (a column of the transposed int8
        block)."""
        ixs = np.asarray(ixs, dtype=np.int64).reshape(-1)
        rows = np.asarray(rows_fp32, dtype=np.float32).reshape(
            len(ixs), self.rank)
        items = dict(self.item_shards)
        scales = dict(self.item_scales) if self.item_scales else None
        if self.dtype == "int8":
            from predictionio_tpu_torch.ops.quant import quantize_rows
            q_rows, q_scales = quantize_rows(rows)
        for d in self.mesh.local_slots:
            m = (ixs // self.rows_dev_i) == d
            if not m.any():
                continue
            loc = torch.from_numpy(ixs[m] - d * self.rows_dev_i).to(
                self.device)
            if self.dtype == "int8":
                cols = torch.from_numpy(q_rows[m]).to(self.device).T
                items[d] = items[d].index_copy(1, loc, cols.contiguous())
                scales[d] = scales[d].index_copy(
                    0, loc, torch.from_numpy(q_scales[m]).to(self.device))
            else:
                items[d] = items[d].index_copy(
                    0, loc, torch.from_numpy(rows[m]).to(self.device))
        return dataclasses.replace(self, item_shards=items,
                                   item_scales=scales)

    def user_row(self, ix: int) -> np.ndarray:
        """The fp32 user row a query ranks with (dequantized for int8);
        this process's rows only."""
        lo = int(ix) - self.user_base
        if self.dtype == "int8":
            q = self.user_rows[lo].cpu().numpy()
            return q.astype(np.float32) * np.float32(
                self.user_scales[lo].item())
        return self.user_rows[lo].cpu().numpy()

    def item_row(self, ix: int) -> np.ndarray:
        d, lo = divmod(int(ix), self.rows_dev_i)
        if self.dtype == "int8":
            q = self.item_shards[d][:, lo].cpu().numpy()
            return q.astype(np.float32) * np.float32(
                self.item_scales[d][lo].item())
        return self.item_shards[d][lo].cpu().numpy()

    def summary(self) -> Dict[str, Any]:
        out = {
            "shards": self.n_shards,
            "merge": MERGE_STRATEGY,
            "rowsPerShard": {"users": self.rows_dev_u,
                             "items": self.rows_dev_i},
            "perShardFactorBytes": self.per_shard_bytes(),
        }
        if self.dtype == "int8":
            out["dtype"] = self.dtype
        return out

    def quant_summary(self) -> Dict[str, Any]:
        """The quant block of a sharded int8 layout (GET / "quant")."""
        rows = self.n_users + self.n_items
        return {
            "dtype": "int8",
            "shards": self.n_shards,
            "int8Bytes": rows * self.rank + rows * 4,
            "fp32Bytes": rows * self.rank * 4,
            "recall": self.quant_recall,
            "exact1": self.quant_exact1,
        }


def shard_factors(user_factors, item_factors,
                  n_shards: Optional[int] = None,
                  mesh: Optional[Mesh] = None,
                  quant: Optional[Any] = None,
                  device: device_mod.DeviceLike = None) -> ShardedFactors:
    """Lay a model's factor matrices out row-sharded for serving.

    Default mesh: the world's devices (``mesh.get_mesh(n_shards)``) on a
    "shard" axis. ``quant`` (an ``ops.quant.QuantizedFactors``) shards the
    int8 blocks and their fp32 per-row scales instead of the fp32
    matrices. Records the ``pio_serve_shards`` gauge and the
    /debug/device.json sharding block."""
    if mesh is None:
        mesh = mesh_mod.get_mesh(n_shards, axis_name=AXIS,
                                 device=device if device is not None
                                 else scoped_device())
    dev = mesh.local_device
    n_dev = mesh.size
    if quant is not None:
        U, V = quant.u_q, quant.v_q
    else:
        U = np.asarray(user_factors, dtype=np.float32)
        V = np.asarray(item_factors, dtype=np.float32)
    n_users, rank = U.shape
    n_items = V.shape[0]
    rows_u = _rows_dev(n_users, n_dev)
    rows_i = _rows_dev(n_items, n_dev)
    slots = mesh.local_slots
    base = slots[0] * rows_u

    def user_block(arr: np.ndarray) -> torch.Tensor:
        # this process's slots are contiguous: one block of rows
        out = np.zeros((len(slots) * rows_u,) + arr.shape[1:], arr.dtype)
        part = arr[base:base + len(slots) * rows_u]
        out[:part.shape[0]] = part
        return torch.from_numpy(out).to(dev)

    tile = topk_fused.serve_tile() if quant is not None else 0
    items: Dict[int, torch.Tensor] = {}
    item_scales: Optional[Dict[int, torch.Tensor]] = (
        {} if quant is not None else None)
    for d in slots:
        blk = V[d * rows_i:(d + 1) * rows_i]
        if quant is not None:
            n_pad = _padded(rows_i, tile)
            vt = np.zeros((rank, n_pad), dtype=np.int8)
            vt[:, :blk.shape[0]] = blk.T
            sv = np.zeros((n_pad,), dtype=np.float32)
            sv[:blk.shape[0]] = quant.v_scale[d * rows_i:(d + 1) * rows_i]
            items[d] = torch.from_numpy(vt).to(dev)
            item_scales[d] = torch.from_numpy(sv).to(dev)
        else:
            out = np.zeros((rows_i, rank), dtype=np.float32)
            out[:blk.shape[0]] = blk
            items[d] = torch.from_numpy(out).to(dev)
    extra: Dict[str, Any] = {}
    if quant is not None:
        extra = {"user_scales": user_block(np.asarray(quant.u_scale,
                                                      np.float32)),
                 "item_scales": item_scales, "dtype": "int8", "tile": tile,
                 "quant_recall": quant.recall,
                 "quant_exact1": quant.exact1}
    sharded = ShardedFactors(
        mesh=mesh, n_users=n_users, n_items=n_items, rank=rank,
        rows_dev_u=rows_u, rows_dev_i=rows_i, user_rows=user_block(U),
        user_base=base, item_shards=items, **extra)
    record_state(sharded.summary())
    logger.info("factors sharded for serving: %d users + %d items x r=%d "
                "(%s) over %d shard(s), %.1f MiB/shard", n_users, n_items,
                rank, sharded.dtype, n_dev,
                sharded.per_shard_bytes() / 2**20)
    return sharded


def record_state(summary: Optional[Dict[str, Any]]) -> None:
    """Publish (or with None, clear) the live sharded-serving layout: the
    ``pio_serve_shards`` gauge and the /debug/device.json sharding block
    `pio doctor`'s sharding line reads."""
    telemetry.registry().gauge(
        "pio_serve_shards",
        "Serving shards the deployed factor matrices are split over "
        "(0 = replicated single-device serving)").labels().set(
            float(summary.get("shards", 0)) if summary else 0.0)
    devicewatch.note_sharding(summary)


# ---------------------------------------------------------------------------
# the sharded serve
# ---------------------------------------------------------------------------

def _checked(sf: ShardedFactors, user_ixs) -> np.ndarray:
    ixs = np.asarray(user_ixs, dtype=np.int64).reshape(-1)
    if ixs.size and (ixs.min() < 0 or ixs.max() >= sf.user_capacity):
        raise IndexError(f"user index out of [0, {sf.user_capacity}): "
                         f"{ixs.min()}..{ixs.max()}")
    return ixs


def _replicated_rows(sf: ShardedFactors, ixs: np.ndarray,
                     rows: torch.Tensor, acc_dtype: torch.dtype
                     ) -> torch.Tensor:
    """The batch's rows of ``rows`` (this process's user-side tensor)
    replicated over a world mesh: each rank contributes the rows it owns,
    zeros elsewhere, and a sum fills in the rest exactly (x + 0 == x)."""
    local = torch.from_numpy(ixs - sf.user_base).to(sf.device)
    own = (local >= 0) & (local < rows.shape[0])
    part = rows.index_select(0, local.clamp(0, rows.shape[0] - 1))
    part = part.to(acc_dtype)
    mask = own.to(acc_dtype)
    part = part * (mask[:, None] if part.dim() == 2 else mask)
    return mesh_mod.all_reduce_sum(sf.mesh, part).to(rows.dtype)


def _gather_candidates(sf: ShardedFactors, vals: Dict[int, torch.Tensor],
                       idx: Dict[int, torch.Tensor]):
    """Every slot's candidate lists, in slot order, along the list axis."""
    return (mesh_mod.all_gather_blocks(sf.mesh, vals, dim=1),
            mesh_mod.all_gather_blocks(sf.mesh, idx, dim=1))


def topk_for_users_sharded_quant(sf: ShardedFactors, user_ixs, k: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded QUANTIZED top-k: B1 once per slot over its int8 item
    block, one B2 over every slot's lists. Bit-identical (values,
    indices, ties) to the replicated B1 + B2 path."""
    ixs = _checked(sf, user_ixs)
    k = int(k)
    k_local = min(k, sf.tile)
    if sf.mesh.distributed:
        b = int(ixs.shape[0])
        u_q = _replicated_rows(sf, ixs, sf.user_rows, torch.int32)
        u_s = _replicated_rows(sf, ixs, sf.user_scales, torch.float32)
        rows_ix = torch.arange(b, dtype=torch.int32, device=sf.device)
    else:
        u_q, u_s = sf.user_rows, sf.user_scales
        rows_ix = torch.from_numpy(ixs.astype(np.int32)).to(sf.device)
    vals, idx = {}, {}
    for d in sf.mesh.local_slots:
        v, i = topk_fused.score_mask_topk_candidates(
            u_q, u_s, sf.item_shards[d], sf.item_scales[d], rows_ix,
            k_local=k_local, n_items=sf.items_real(d), tile=sf.tile)
        vals[d] = v
        idx[d] = i + d * sf.rows_dev_i if d else i
    cand_v, cand_i = _gather_candidates(sf, vals, idx)
    return topk_fused.merge_candidates(cand_v, cand_i, k, k_local=k_local)


def topk_for_users_sharded(sf: ShardedFactors, user_ixs, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded fp32 top-k: per slot the scores over its item block,
    its padding masked, its stable top ``min(k, rows_dev_i)``; then the
    two-key merge of every slot's candidates. The contraction axis is
    never split, so each score is the replicated path's dot product up
    to the matmul's blocking (the tolerance class)."""
    ixs = _checked(sf, user_ixs)
    k = int(k)
    if sf.mesh.distributed:
        Q = _replicated_rows(sf, ixs, sf.user_rows, torch.float32)
    else:
        # _checked bounds ixs to [0, user_capacity), every user row of
        # a one-process mesh
        Q = sf.user_rows.index_select(  # pio-lint: allow=gather-clip
            0, torch.from_numpy(ixs - sf.user_base).to(sf.device))
    k_local = min(k, sf.rows_dev_i)
    vals, idx = {}, {}
    for d in sf.mesh.local_slots:
        scores = Q @ sf.item_shards[d].T
        col = torch.arange(sf.rows_dev_i, device=sf.device)
        scores = scores.masked_fill(col >= sf.items_real(d), NEG_INF)
        v, i = stable_topk(scores, k_local)
        vals[d], idx[d] = v, i + d * sf.rows_dev_i
    cand_v, cand_i = _gather_candidates(sf, vals, idx)
    return topk_fused.merge_candidates_plain(cand_v, cand_i, k)


# ---------------------------------------------------------------------------
# fold-in publication into the live sharded layout
# ---------------------------------------------------------------------------

def _owned(sf: ShardedFactors, ixs: np.ndarray):
    local = ixs - sf.user_base
    m = (local >= 0) & (local < sf.user_rows.shape[0])
    return m, torch.from_numpy(local[m]).to(sf.device)


def scatter_user_rows_sharded(sf: ShardedFactors, ixs: np.ndarray,
                              rows: np.ndarray) -> torch.Tensor:
    """A NEW fp32 user-rows tensor with the rows this process owns
    replaced (the update set is tiny and replicated to every process, so
    each keeps its own). ``ixs`` in bounds of the padded capacity;
    duplicates carry identical rows."""
    m, loc = _owned(sf, ixs)
    return sf.user_rows.index_copy(
        0, loc, torch.from_numpy(rows[m]).to(sf.device))


def scatter_user_rows_sharded_quant(sf: ShardedFactors, ixs: np.ndarray,
                                    rows: np.ndarray
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 twin: exactly the touched rows re-quantized (per-row
    scales keep it local and exact), rows and scales scattered."""
    from predictionio_tpu_torch.ops.quant import quantize_rows
    q_rows, scales = quantize_rows(rows)
    m, loc = _owned(sf, ixs)
    return (sf.user_rows.index_copy(
                0, loc, torch.from_numpy(q_rows[m]).to(sf.device)),
            sf.user_scales.index_copy(
                0, loc, torch.from_numpy(scales[m]).to(sf.device)))


# ---------------------------------------------------------------------------
# the warm-up's programs (serving/aot.py)
# ---------------------------------------------------------------------------

def sharded_program_specs(sharded: ShardedFactors, buckets: Iterable[int],
                          ks: Iterable[int]) -> List[Any]:
    """One warm-up program per (bucket, k): the sharded serve on row 0,
    ending in the host copy as a flush does. Bucket 1 is always in: the
    inline (batching-off) path serves through the same call."""
    from predictionio_tpu_torch.serving.aot import Program

    name = ("topk_for_users_sharded_quant" if sharded.dtype == "int8"
            else "topk_for_users_sharded")
    out: List[Any] = []
    for b in sorted({1, *(int(x) for x in buckets)}):
        for k in ks:
            def run(b=b, k=int(k)):
                vals, idx = sharded.topk(np.zeros(b, dtype=np.int32), k)
                return vals.cpu(), idx.cpu()
            out.append(Program(name, run))
    return out


# ---------------------------------------------------------------------------
# warm-up registry entries (serving/aot.py; ``pio lint``'s aot-registration
# pass holds this module's kernel-launching defs to the registry)
# ---------------------------------------------------------------------------

def _register() -> None:
    from predictionio_tpu_torch.serving import aot
    aot.register_entry(
        "topk_for_users_sharded", topk_for_users_sharded, kind="serving",
        note="the fp32 sharded serve: warmed per bucket (1 always) by "
             "sharded_program_specs")
    aot.register_entry(
        "topk_for_users_sharded_quant", topk_for_users_sharded_quant,
        kind="serving",
        note="the int8 sharded serve, B1 per slot and one B2: warmed "
             "per bucket (1 always) by sharded_program_specs")
    aot.register_entry(
        "scatter_user_rows_sharded", scatter_user_rows_sharded,
        kind="serving",
        note="fold-in publication into the fp32 sharded layout; torch's "
             "index_copy, not warmed")
    aot.register_entry(
        "scatter_user_rows_sharded_quant", scatter_user_rows_sharded_quant,
        kind="serving",
        note="fold-in publication into the int8 sharded layout; torch's "
             "index_copy, not warmed")


_register()
