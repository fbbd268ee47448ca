"""JSON-backed typed property bags (the port's copy of
``predictionio_tpu/data/datamap.py``).

Behavioral parity with the reference's DataMap/PropertyMap
(data/src/main/scala/org/apache/predictionio/data/storage/DataMap.scala:45-245,
PropertyMap.scala:36-99): a `DataMap` wraps a JSON object; `get` on a missing
required key raises; `get_opt` returns None; `++`/`--` merge and key-removal
return new maps. `PropertyMap` adds first/lastUpdated timestamps produced by
the `$set/$unset/$delete` aggregator.

The storage representation here is plain Python JSON values (dict/list/str/
int/float/bool/None) rather than a json4s AST; semantics are the same.
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Any, Dict, Iterable, List, Optional


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


class DataMap:
    """An immutable mapping of property names to JSON values."""

    __slots__ = ("fields",)

    def __init__(self, fields: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "fields", dict(fields or {}))

    # -- construction -------------------------------------------------------
    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        obj = json.loads(s)
        if not isinstance(obj, dict):
            raise DataMapError("DataMap JSON must be an object")
        return cls(obj)

    # -- query --------------------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self.fields:
            raise DataMapError(f"The field {name} is required.")

    def contains(self, name: str) -> bool:
        return name in self.fields

    __contains__ = contains

    def get(self, name: str) -> Any:
        """Get a required field; raises DataMapError if absent or JSON null."""
        self.require(name)
        value = self.fields[name]
        if value is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        return value

    def get_opt(self, name: str, default: Any = None) -> Any:
        """Get an optional field; returns `default` when absent or null."""
        value = self.fields.get(name)
        return default if value is None else value

    def get_str(self, name: str) -> str:
        return str(self.get(name))

    def get_float(self, name: str) -> float:
        return float(self.get(name))

    def get_int(self, name: str) -> int:
        return int(self.get(name))

    def get_list(self, name: str) -> List[Any]:
        value = self.get(name)
        if not isinstance(value, list):
            raise DataMapError(f"The field {name} is not an array.")
        return value

    def get_string_list(self, name: str) -> List[str]:
        return [str(x) for x in self.get_list(name)]

    def extract(self, cls):
        """Deserialize the whole map into a dataclass-like `cls(**fields)`.

        Mirror of DataMap.extract[A] (DataMap.scala:170-180) with Python
        dataclasses instead of case classes.
        """
        return cls(**self.fields)

    # -- set ops ------------------------------------------------------------
    def union(self, other: "DataMap") -> "DataMap":
        """`this ++ that`: right-biased merge (DataMap.scala:197)."""
        merged = dict(self.fields)
        merged.update(other.fields)
        return DataMap(merged)

    def remove(self, keys: Iterable[str]) -> "DataMap":
        """`this -- keys` (DataMap.scala:204)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self.fields.items() if k not in drop})

    # -- misc ---------------------------------------------------------------
    @property
    def is_empty(self) -> bool:
        return not self.fields

    def key_set(self):
        return set(self.fields.keys())

    def to_json(self) -> str:
        return json.dumps(self.fields, sort_keys=True)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.fields)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DataMap) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.to_json())

    def __repr__(self) -> str:
        return f"DataMap({self.fields!r})"


class PropertyMap(DataMap):
    """A DataMap plus first/last updated times of the underlying `$set`s.

    Reference: PropertyMap.scala:36-99.
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Dict[str, Any]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.fields == other.fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        # A PropertyMap never equals a plain DataMap (PropertyMap.scala:62-70)
        return False

    def __hash__(self) -> int:
        return hash((self.to_json(), self.first_updated, self.last_updated))

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.fields!r}, firstUpdated={self.first_updated}, "
            f"lastUpdated={self.last_updated})"
        )
