"""Deterministic synthetic rating generator (the port's copy of
``predictionio_tpu/data/synthetic.py``, numpy only): the ML-20M-scale
``pio train --synthetic N`` surface without a dataset download.

- DETERMINISTIC: ``(seed, chunk_index)`` fully determines a chunk
  (``numpy.random.SeedSequence(entropy=seed, spawn_key=(chunk,))`` keys a
  fresh Philox stream per chunk), so both packages, and two runs, see
  byte-identical data from one seed;
- zipf-ish item popularity (``1/rank^a``), zipf-ish user activity and
  half-star ratings, in the columnar chunk schema of the event store's
  bulk read (entity_code / target_code / event_code / rating / time_ms
  against a synthesized string pool).

Surfaces: :func:`chunk_source` (the re-iterable chunk stream),
:func:`training_data` (synthetic events to a recommendation
``TrainingData`` through the in-core columnar encode),
:func:`env_config` (the ``PIO_SYNTHETIC_EVENTS`` / ``_SEED`` contract that
``pio train --synthetic N`` sets).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

#: event-time base for generated ratings (epoch millis; arbitrary but
#: fixed so event ids/timestamps are reproducible)
_BASE_MS = 1_600_000_000_000

#: fixed strings first in the pool, so code 0 is always "rate" and
#: entity/target codes are offset by 3
_FIXED_POOL = ("rate", "user", "item")


@dataclass(frozen=True)
class SyntheticConfig:
    """One reproducible synthetic dataset. ``n_users``/``n_items`` of 0
    derive ML-20M-like densities (~145 ratings/user, ~740/item), capped
    so the string pool and vocab dicts stay bounded at any event count."""
    n_events: int
    n_users: int = 0
    n_items: int = 0
    seed: int = 7
    chunk: int = 1 << 20
    user_exponent: float = 1.05   # zipf-ish user activity skew
    item_exponent: float = 0.8    # zipf-ish item popularity

    def resolved(self) -> "SyntheticConfig":
        n_users = self.n_users or min(max(self.n_events // 145, 16),
                                      2_000_000)
        n_items = self.n_items or min(max(self.n_events // 740, 16),
                                      400_000)
        chunk = max(min(self.chunk, max(self.n_events, 1)), 1)
        return replace(self, n_users=n_users, n_items=n_items, chunk=chunk)


def _zipf_cdf(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
    return np.cumsum(w / w.sum())


class ChunkSource:
    """Re-iterable chunk stream over one :class:`SyntheticConfig`.

    ``chunks()`` can be called any number of times (per-epoch re-scans);
    every pass yields byte-identical chunks because chunk ``c`` is drawn
    from its own counter-derived RNG stream. The CDFs are built once —
    O(n_users + n_items) host, the same order as the vocab itself."""

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg.resolved()
        self._u_cdf = _zipf_cdf(self.cfg.n_users, self.cfg.user_exponent)
        self._i_cdf = _zipf_cdf(self.cfg.n_items, self.cfg.item_exponent)

    @property
    def n_events(self) -> int:
        return self.cfg.n_events

    @property
    def n_chunks(self) -> int:
        c = self.cfg
        return max(-(-c.n_events // c.chunk), 1) if c.n_events else 0

    def pool(self) -> List[str]:
        """The synthesized string pool ("u<i>" / "i<j>" ids after the
        fixed strings) — built on demand, O(users + items) host."""
        c = self.cfg
        return (list(_FIXED_POOL)
                + [f"u{x}" for x in range(c.n_users)]
                + [f"i{x}" for x in range(c.n_items)])

    def chunk_codes(self, index: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
        """Raw (user, item, rating) draws of chunk ``index`` — dense int
        ids in [0, n_users/n_items), half-star float32 ratings."""
        c = self.cfg
        lo = index * c.chunk
        n = min(c.n_events - lo, c.chunk)
        if n <= 0:
            raise IndexError(index)
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=c.seed, spawn_key=(index,)))
        u = np.searchsorted(self._u_cdf, rng.random(n)).astype(np.int32)
        i = np.searchsorted(self._i_cdf, rng.random(n)).astype(np.int32)
        np.clip(u, 0, c.n_users - 1, out=u)
        np.clip(i, 0, c.n_items - 1, out=i)
        r = np.clip(np.round(rng.normal(3.5, 1.1, n) * 2) / 2,
                    0.5, 5.0).astype(np.float32)
        return u, i, r

    def chunks(self) -> Iterator[Dict[str, np.ndarray]]:
        """Columnar chunks in the event store's bulk-read schema, in
        order; codes index :meth:`pool` (entity = u + 3, target =
        i + 3 + n_users, event 0 = "rate")."""
        c = self.cfg
        for index in range(self.n_chunks):
            u, i, r = self.chunk_codes(index)
            n = u.shape[0]
            lo = index * c.chunk
            yield {
                "entity_code": u + np.int32(len(_FIXED_POOL)),
                "target_code": i + np.int32(len(_FIXED_POOL) + c.n_users),
                "event_code": np.zeros(n, np.int32),
                "rating": r,
                "time_ms": np.arange(lo, lo + n, dtype=np.int64) + _BASE_MS,
            }


def chunk_source(n_events: int, seed: int = 7, n_users: int = 0,
                 n_items: int = 0, chunk: int = 1 << 20) -> ChunkSource:
    """The library surface: a re-iterable synthetic chunk stream."""
    return ChunkSource(SyntheticConfig(
        n_events=n_events, n_users=n_users, n_items=n_items, seed=seed,
        chunk=chunk))


def training_data(n_events: int, seed: int = 7, n_users: int = 0,
                  n_items: int = 0, chunk: int = 1 << 20,
                  timings: Optional[Dict[str, float]] = None):
    """Synthetic events -> recommendation ``TrainingData`` through the
    same columnar encode the event-store read uses (vocab assignment and
    the buy mapping behave identically). In-core: the streamed read waits
    for a later slice (``store.check_train_stream``)."""
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.models.recommendation.data_source import (
        training_data_from_columnar,
    )

    src = chunk_source(n_events, seed=seed, n_users=n_users,
                       n_items=n_items, chunk=chunk)
    col = store.columnar_from_stream(
        src.pool(), src.chunks(), event_names=["rate", "buy"],
        timings=timings)
    return training_data_from_columnar(col)


def env_config() -> Optional[SyntheticConfig]:
    """The `pio train --synthetic N` contract: when PIO_SYNTHETIC_EVENTS
    is set (> 0), the recommendation DataSource trains on this config
    instead of reading the event store."""
    raw = os.environ.get("PIO_SYNTHETIC_EVENTS", "")
    if not raw:
        return None
    try:
        n = int(float(raw))
    except ValueError:
        return None
    if n <= 0:
        return None
    try:
        seed = int(os.environ.get("PIO_SYNTHETIC_SEED", "") or 7)
    except ValueError:
        seed = 7
    return SyntheticConfig(n_events=n, seed=seed)
