"""BiMap — the universal ID↔index encoder (the port's own copy of
``predictionio_tpu/data/bimap.py``; same class, same pickled state, so a
blob's vocabularies load into it).

Capability parity with the reference's BiMap
(data/src/main/scala/org/apache/predictionio/data/storage/BiMap.scala:28-167),
which every ALS template uses to encode string entity IDs to dense ints.

The reference builds the vocabulary with a Spark job
(`rdd.distinct().zipWithUniqueId()`, BiMap.scala:96-128). Here the build is a
single-pass host-side dict in first-appearance order (NOT sorted — matching
zipWithUniqueId's arbitrary-but-stable assignment), with a vectorized
numpy path for encoding large arrays destined for device memory.
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, List, Sequence, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    """Bidirectional map. Raises on non-injective input. Effectively
    immutable except for :meth:`add`, the append-only path the realtime
    fold-in layer uses to register new users against new factor rows."""

    def __init__(self, forward: Dict[K, V]):
        self._fwd: Dict[K, V] = dict(forward)
        self._rev: Dict[V, K] = {v: k for k, v in self._fwd.items()}
        if len(self._rev) != len(self._fwd):
            raise ValueError("BiMap values must be unique")

    # -- lookups (BiMap.scala:40-78) ---------------------------------------
    def __call__(self, k: K) -> V:
        return self._fwd[k]

    def get(self, k: K, default=None):
        return self._fwd.get(k, default)

    def contains(self, k: K) -> bool:
        return k in self._fwd

    __contains__ = contains

    def inverse(self) -> "BiMap[V, K]":
        inv = BiMap.__new__(BiMap)
        inv._fwd = self._rev
        inv._rev = self._fwd
        return inv

    def add(self, key: K, value: V) -> None:
        """Append one NEW pair (realtime fold-in registers a freshly
        folded user under its assigned factor row). The map stays
        injective — rebinding an existing key or value raises. Single
        dict inserts under the GIL, so concurrent ``get``/``inverse``
        readers (the serving threads) observe either the old or the new
        map, never a torn one; inverse() views share the same dicts and
        see the addition immediately."""
        if key in self._fwd:
            raise ValueError(f"BiMap key {key!r} is already bound")
        if value in self._rev:
            raise ValueError(f"BiMap value {value!r} is already bound")
        self._fwd[key] = value
        self._rev[value] = key

    def take(self, n: int) -> "BiMap[K, V]":
        return BiMap(dict(list(self._fwd.items())[:n]))

    def to_dict(self) -> Dict[K, V]:
        return dict(self._fwd)

    def __len__(self) -> int:
        return len(self._fwd)

    def __eq__(self, other) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __repr__(self) -> str:
        return f"BiMap({len(self._fwd)} entries)"

    # -- vectorized encode for device ingestion --------------------------------
    def encode_array(self, keys: Sequence[K], dtype=np.int32) -> np.ndarray:
        """Encode a sequence of keys to a dense integer array.

        Only valid for int-valued BiMaps (string_int / string_long).
        """
        return np.fromiter((self._fwd[k] for k in keys), dtype=dtype, count=len(keys))

    def decode_array(self, idx: np.ndarray) -> List[K]:
        return [self._rev[int(i)] for i in idx]

    # -- constructors (BiMap.scala:96-167) ----------------------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Distinct keys → contiguous int32 indices in first-appearance order."""
        fwd: Dict[str, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    @staticmethod
    def string_long(keys: Iterable[str]) -> "BiMap[str, int]":
        return BiMap.string_int(keys)

    @staticmethod
    def string_double(keys: Iterable[str]) -> "BiMap[str, float]":
        fwd: Dict[str, float] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = float(len(fwd))
        return BiMap(fwd)


class EntityMap(Generic[V]):
    """Typed entities + their id↔index BiMap (EntityMap.scala:69-99).

    `id_to_data` maps entityId → extracted object; `id_to_ix` assigns each
    id a dense index (first-appearance order) so entity attributes can be
    gathered into device arrays positionally: build an array where row
    `id_to_ix(eid)` holds eid's features and the index IS the embedding row.
    """

    def __init__(self, id_to_data: Dict[str, V],
                 id_to_ix: "BiMap[str, int]" = None):
        self.id_to_data = dict(id_to_data)
        self.id_to_ix: BiMap[str, int] = (
            id_to_ix if id_to_ix is not None
            else BiMap.string_int(self.id_to_data.keys()))

    def data(self, id_or_ix) -> V:
        if isinstance(id_or_ix, str):
            return self.id_to_data[id_or_ix]
        return self.id_to_data[self.id_to_ix.inverse()(int(id_or_ix))]

    def get_data(self, id_or_ix, default=None):
        try:
            return self.data(id_or_ix)
        except KeyError:
            return default

    def contains(self, entity_id: str) -> bool:
        return entity_id in self.id_to_data

    def __len__(self) -> int:
        return len(self.id_to_data)

    def __iter__(self):
        return iter(self.id_to_data)

    def take(self, n: int) -> "EntityMap[V]":
        new_ix = self.id_to_ix.take(n)
        return EntityMap(
            {k: v for k, v in self.id_to_data.items() if new_ix.contains(k)},
            new_ix)

    def __repr__(self) -> str:
        return f"EntityMap({len(self)} entities)"
