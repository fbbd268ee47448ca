"""The SPI-demo webhook connector pair (the port's copy of
``predictionio_tpu/data/webhooks/examples.py``).

Reference: data/.../webhooks/examplejson/ExampleJsonConnector.scala and
data/.../webhooks/exampleform/ExampleFormConnector.scala — the pair of
documented example connectors new integrations copy from. Both accept two
payload types:

  userAction      -> entityType "user" event (context + two extra props)
  userActionItem  -> user->item event (context + two extra props)

The JSON variant takes nested objects; the form variant takes flat
key/value pairs with PHP-style bracketed context keys ("context[ip]").
Like the reference, these are NOT in the default connector registries
(WebhooksConnectors.scala registers only segmentio + mailchimp); they
exist as templates and are exercised by tests.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from predictionio_tpu_torch.data.webhooks import (
    ConnectorException, FormConnector, JsonConnector,
)


def _require(data: Dict[str, Any], field: str) -> Any:
    if field not in data:
        raise ConnectorException(f"The field '{field}' is required.")
    return data[field]


class ExampleJsonConnector(JsonConnector):
    """ExampleJsonConnector.scala:28-130."""

    def to_event_json(self, data: Dict[str, Any]) -> Dict[str, Any]:
        typ = _require(data, "type")
        if typ == "userAction":
            return self._user_action(data)
        if typ == "userActionItem":
            return self._user_action_item(data)
        raise ConnectorException(
            f"Cannot convert unknown type '{typ}' to Event JSON.")

    def _user_action(self, data: Dict[str, Any]) -> Dict[str, Any]:
        props: Dict[str, Any] = {
            "anotherProperty1": int(_require(data, "anotherProperty1")),
        }
        if data.get("context") is not None:
            props["context"] = data["context"]
        if data.get("anotherProperty2") is not None:
            props["anotherProperty2"] = data["anotherProperty2"]
        return {
            "event": _require(data, "event"),
            "entityType": "user",
            "entityId": _require(data, "userId"),
            "eventTime": _require(data, "timestamp"),
            "properties": props,
        }

    def _user_action_item(self, data: Dict[str, Any]) -> Dict[str, Any]:
        props: Dict[str, Any] = {"context": _require(data, "context")}
        if data.get("anotherPropertyA") is not None:
            props["anotherPropertyA"] = float(data["anotherPropertyA"])
        if data.get("anotherPropertyB") is not None:
            v = data["anotherPropertyB"]
            if not isinstance(v, bool):
                # bool("false") is True — reject like the reference's
                # typed extraction instead of storing an inverted value
                raise ConnectorException(
                    f"anotherPropertyB must be a boolean, got {v!r}")
            props["anotherPropertyB"] = v
        return {
            "event": _require(data, "event"),
            "entityType": "user",
            "entityId": _require(data, "userId"),
            "targetEntityType": "item",
            "targetEntityId": _require(data, "itemId"),
            "eventTime": _require(data, "timestamp"),
            "properties": props,
        }


class ExampleFormConnector(FormConnector):
    """ExampleFormConnector.scala:27-140: flat form fields, context
    encoded as bracketed keys ("context[ip]", "context[prop1]", ...)."""

    def to_event_json(self, data: Dict[str, str]) -> Dict[str, Any]:
        typ = _require(data, "type")
        try:
            if typ == "userAction":
                return self._user_action(data)
            if typ == "userActionItem":
                return self._user_action_item(data)
        except ConnectorException:
            raise
        except Exception as e:
            raise ConnectorException(
                f"Cannot convert {data} to event JSON. {e}") from e
        raise ConnectorException(
            f"Cannot convert unknown type {typ} to event JSON")

    @staticmethod
    def _context(data: Dict[str, str],
                 required: bool) -> Optional[Dict[str, Any]]:
        has = any(k.startswith("context[") for k in data)
        if not has:
            if required:
                raise ConnectorException(
                    "The field 'context[...]' is required.")
            return None
        ctx: Dict[str, Any] = {}
        if "context[ip]" in data:
            ctx["ip"] = data["context[ip]"]
        if "context[prop1]" in data:
            ctx["prop1"] = float(data["context[prop1]"])
        if "context[prop2]" in data:
            ctx["prop2"] = data["context[prop2]"]
        return ctx

    def _user_action(self, data: Dict[str, str]) -> Dict[str, Any]:
        props: Dict[str, Any] = {
            "anotherProperty1": int(_require(data, "anotherProperty1")),
        }
        ctx = self._context(data, required=False)
        if ctx is not None:
            props["context"] = ctx
        if data.get("anotherProperty2") is not None:
            props["anotherProperty2"] = data["anotherProperty2"]
        return {
            "event": _require(data, "event"),
            "entityType": "user",
            "entityId": _require(data, "userId"),
            "eventTime": _require(data, "timestamp"),
            "properties": props,
        }

    def _user_action_item(self, data: Dict[str, str]) -> Dict[str, Any]:
        props: Dict[str, Any] = {"context": self._context(data, required=True)}
        if data.get("anotherPropertyA") is not None:
            props["anotherPropertyA"] = float(data["anotherPropertyA"])
        if data.get("anotherPropertyB") is not None:
            v = str(data["anotherPropertyB"]).strip().lower()
            if v not in ("true", "false"):
                # Scala's .toBoolean throws on anything else
                raise ConnectorException(
                    f"anotherPropertyB must be 'true' or 'false', got "
                    f"{data['anotherPropertyB']!r}")
            props["anotherPropertyB"] = v == "true"
        return {
            "event": _require(data, "event"),
            "entityType": "user",
            "entityId": _require(data, "userId"),
            "targetEntityType": "item",
            "targetEntityId": _require(data, "itemId"),
            "eventTime": _require(data, "timestamp"),
            "properties": props,
        }


# ---------------------------------------------------------------------------
# reference payload fixtures for the PRODUCTION connectors
# ---------------------------------------------------------------------------
# One representative payload per message type of the default-registered
# connectors (segment.io JSON, MailChimp form), shaped after the vendor
# docs quoted in SegmentIOConnector.scala / MailChimpConnector.scala.
# tests/test_webhooks_connectors.py iterates these to prove every type
# converts end-to-end; new integrations can crib the shapes.

_SEG_CONTEXT = {
    "ip": "8.8.8.8",
    "library": {"name": "analytics-python", "version": "1.0.3"},
}

#: segment.io message type -> example webhook body (JSON object)
SEGMENTIO_EXAMPLES = {
    "identify": {
        "version": 2, "type": "identify", "user_id": "us1",
        "timestamp": "2015-02-23T22:28:55.387Z",
        "traits": {"name": "Ada", "plan": "enterprise"},
        "context": _SEG_CONTEXT,
    },
    "track": {
        "version": 2, "type": "track", "user_id": "us1",
        "timestamp": "2015-02-23T22:28:55.111Z",
        "event": "Registered",
        "properties": {"plan": "Pro Annual", "accountType": "Facebook"},
    },
    "alias": {
        "version": 2, "type": "alias", "user_id": "us1",
        "timestamp": "2015-02-23T22:28:55.111Z",
        "previous_id": "anon-42",
    },
    "page": {
        "version": 2, "type": "page", "anonymous_id": "anon-42",
        "timestamp": "2015-02-23T22:28:55.111Z",
        "name": "Docs", "properties": {"url": "/docs"},
    },
    "screen": {
        "version": 2, "type": "screen", "user_id": "us1",
        "timestamp": "2015-02-23T22:28:55.111Z",
        "name": "Home", "properties": {"variant": "b"},
    },
    "group": {
        "version": 2, "type": "group", "user_id": "us1",
        "timestamp": "2015-02-23T22:28:55.111Z",
        "group_id": "grp-7", "traits": {"industry": "Technology"},
    },
}

_MC_BASE = {
    "fired_at": "2009-03-26 21:35:57",
    "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
    "data[email]": "api@mailchimp.com", "data[email_type]": "html",
    "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[merges][INTERESTS]": "Group1,Group2",
    "data[ip_opt]": "10.20.10.30",
}

#: MailChimp callback type -> example form fields (flat key/value)
MAILCHIMP_EXAMPLES = {
    "subscribe": {**_MC_BASE, "type": "subscribe",
                  "data[ip_signup]": "10.20.10.30"},
    "unsubscribe": {**_MC_BASE, "type": "unsubscribe",
                    "data[action]": "unsub", "data[reason]": "manual",
                    "data[campaign_id]": "4fjk2ma9xd"},
    "profile": {**_MC_BASE, "type": "profile"},
    "upemail": {
        "type": "upemail", "fired_at": "2009-03-26 22:15:09",
        "data[list_id]": "a6b5da1054", "data[new_id]": "51da8c3259",
        "data[new_email]": "api+new@mailchimp.com",
        "data[old_email]": "api+old@mailchimp.com",
    },
    "cleaned": {
        "type": "cleaned", "fired_at": "2009-03-26 22:01:00",
        "data[list_id]": "a6b5da1054", "data[campaign_id]": "4fjk2ma9xd",
        "data[reason]": "hard", "data[email]": "api+gone@mailchimp.com",
    },
    "campaign": {
        "type": "campaign", "fired_at": "2009-03-26 21:31:21",
        "data[id]": "5aa2102003", "data[list_id]": "a6b5da1054",
        "data[subject]": "Test Campaign Subject", "data[status]": "sent",
        "data[reason]": "",
    },
}
