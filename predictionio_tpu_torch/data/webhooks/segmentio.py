"""Segment.io webhook connector (the port's copy of
``predictionio_tpu/data/webhooks/segmentio.py``).

Reference: data/.../webhooks/segmentio/SegmentIOConnector.scala:24-309.
Maps the six segment.io message types (identify/track/alias/page/screen/
group) onto Events: entityType "user", entityId = userId|anonymousId,
event = message type, properties = type-specific fields (+ "context" when
present).
"""

from __future__ import annotations

from typing import Any, Dict

from predictionio_tpu_torch.data.webhooks import (
    ConnectorException, JsonConnector,
)


def _require(data: Dict[str, Any], field: str) -> Any:
    if field not in data:
        raise ConnectorException(
            f"Cannot extract {field} field from segment.io data.")
    return data[field]


class SegmentIOConnector(JsonConnector):

    #: type -> list of (source field, target property key, required)
    _TYPE_PROPS = {
        "identify": (("traits", "traits", False),),
        "track": (("properties", "properties", False), ("event", "event", True)),
        "alias": (("previous_id", "previous_id", True),),
        "page": (("name", "name", False), ("properties", "properties", False)),
        "screen": (("name", "name", False), ("properties", "properties", False)),
        "group": (("group_id", "group_id", True), ("traits", "traits", False)),
    }

    def to_event_json(self, data: Dict[str, Any]) -> Dict[str, Any]:
        if "version" not in data:
            raise ConnectorException(
                "Failed to get segment.io API version.")
        typ = _require(data, "type")
        if typ not in self._TYPE_PROPS:
            raise ConnectorException(
                f"Cannot convert unknown type {typ} to event JSON.")

        user_id = data.get("user_id") or data.get("anonymous_id")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields.")

        props: Dict[str, Any] = {}
        for src, dst, required in self._TYPE_PROPS[typ]:
            if src in data and data[src] is not None:
                props[dst] = data[src]
            elif required:
                raise ConnectorException(
                    f"Cannot convert {data} to event JSON: missing {src}.")
        if data.get("context") is not None:
            props["context"] = data["context"]

        out: Dict[str, Any] = {
            "event": typ,
            "entityType": "user",
            "entityId": user_id,
            "properties": props,
        }
        if data.get("timestamp") is not None:
            out["eventTime"] = data["timestamp"]
        return out
