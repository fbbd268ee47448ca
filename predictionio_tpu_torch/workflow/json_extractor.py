"""Typed JSON codec for queries, predictions, and params (the port's own
copy of ``predictionio_tpu/workflow/json_extractor.py``).

Reference: core/.../workflow/JsonExtractor.scala:37-167. The reference kept
two JSON stacks (json4s for Scala, Gson for Java); here one structural
dataclass codec covers both roles: `extract` builds a dataclass from a JSON
object (unknown fields rejected, like json4s strict mode), `to_json_obj`
renders one back (None fields dropped, matching json4s Option behavior).
"""

from __future__ import annotations

import dataclasses
import json
import types
import typing
from typing import Any, Optional, Type


def extract(cls: Optional[Type], obj: Any):
    """JSON value -> instance of cls (recursively over dataclass fields)."""
    if cls is None or cls is Any:
        return obj
    origin = typing.get_origin(cls)
    is_union = origin is typing.Union or origin is types.UnionType
    if obj is None:
        if cls is type(None) or (
                is_union and type(None) in typing.get_args(cls)):
            return None
        raise ValueError(f"null is not allowed for {cls}")
    if is_union:  # Optional[T] and unions, both typing.Union and X | Y
        args = [a for a in typing.get_args(cls) if a is not type(None)]
        last_err = None
        for a in args:
            try:
                return extract(a, obj)
            except (TypeError, ValueError) as e:
                last_err = e
        raise ValueError(f"cannot extract {obj!r} as {cls}: {last_err}")
    if origin in (list, tuple, set, frozenset):
        if not isinstance(obj, (list, tuple)):
            raise ValueError(f"expected an array for {cls}, got {obj!r}")
        args = typing.get_args(cls)
        if origin is tuple and args and args[-1] is Ellipsis:
            elem = args[0]
            return tuple(extract(elem, x) for x in obj)
        if origin is tuple and args:
            return tuple(extract(a, x) for a, x in zip(args, obj))
        elem = args[0] if args else None
        seq = [extract(elem, x) for x in obj]
        return origin(seq) if origin is not list else seq
    if origin is dict:
        if not isinstance(obj, dict):
            raise ValueError(f"expected an object for {cls}, got {obj!r}")
        _, vt = (typing.get_args(cls) or (None, None))
        return {k: extract(vt, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(cls):
        if not isinstance(obj, dict):
            raise ValueError(f"expected an object for {cls.__name__}, got {obj!r}")
        aliases = getattr(cls, "JSON_ALIASES", {})
        obj = {aliases.get(k, k): v for k, v in obj.items()}
        hints = typing.get_type_hints(cls)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(obj) - set(fields)
        if unknown:
            raise ValueError(
                f"unknown field(s) {sorted(unknown)} for {cls.__name__} "
                f"(accepts {sorted(fields)})")
        kwargs = {}
        for name, f in fields.items():
            if name in obj:
                kwargs[name] = extract(hints.get(name), obj[name])
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                raise ValueError(
                    f"field {name} is required for {cls.__name__}")
        return cls(**kwargs)
    # bool is an int subclass; reject bool-for-int/float confusions
    if cls in (int, float) and isinstance(obj, bool):
        raise ValueError(f"expected {cls.__name__}, got {obj!r}")
    if cls is float and isinstance(obj, int):
        return float(obj)
    if isinstance(cls, type) and not isinstance(obj, cls):
        raise ValueError(f"expected {cls.__name__}, got {obj!r}")
    return obj


def to_json_obj(obj: Any) -> Any:
    """Dataclass tree -> plain JSON value (None fields dropped)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = to_json_obj(getattr(obj, f.name))
            if v is not None:
                out[f.name] = v
        return out
    if isinstance(obj, dict):
        return {k: to_json_obj(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_json_obj(x) for x in obj]
    if hasattr(obj, "item") and callable(getattr(obj, "item", None)) and \
            getattr(obj, "shape", None) == ():
        return obj.item()  # 0-d numpy/torch scalars
    return obj


def extract_query(cls: Optional[Type], body: bytes):
    """HTTP body -> query object (CreateServer.scala:479-485)."""
    obj = json.loads(body.decode("utf-8"))
    if cls is None:
        return obj
    return extract(cls, obj)


def render(obj: Any) -> str:
    return json.dumps(to_json_obj(obj))
