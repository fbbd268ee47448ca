"""MailChimp form webhook connector (the port's copy of
``predictionio_tpu/data/webhooks/mailchimp.py``).

Reference: data/.../webhooks/mailchimp/MailChimpConnector.scala:24-308.
Maps the six MailChimp callback types to events; timestamps arrive as
"yyyy-MM-dd HH:mm:ss" (taken as UTC, EventValidation.defaultTimeZone).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict

from predictionio_tpu_torch.data.webhooks import (
    ConnectorException, FormConnector,
)


def parse_mailchimp_datetime(s: str) -> str:
    """"yyyy-MM-dd HH:mm:ss" -> ISO-8601 UTC (MailChimpConnector.scala:59-64)."""
    try:
        t = _dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S")
    except ValueError as e:
        raise ConnectorException(f"Cannot parse fired_at {s!r}: {e}") from None
    return t.replace(tzinfo=_dt.timezone.utc).isoformat().replace("+00:00", "Z")


def _req(data: Dict[str, str], key: str) -> str:
    if key not in data:
        raise ConnectorException(
            f"The field '{key}' is required for MailChimp data.")
    return data[key]


class MailChimpConnector(FormConnector):

    def to_event_json(self, data: Dict[str, str]) -> Dict[str, Any]:
        typ = data.get("type")
        handlers = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }
        if typ is None:
            raise ConnectorException(
                "The field 'type' is required for MailChimp data.")
        if typ not in handlers:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp data type {typ} to event JSON")
        return handlers[typ](data)

    @staticmethod
    def _merges(data: Dict[str, str]) -> Dict[str, Any]:
        merges = {
            "EMAIL": _req(data, "data[merges][EMAIL]"),
            "FNAME": _req(data, "data[merges][FNAME]"),
            "LNAME": _req(data, "data[merges][LNAME]"),
        }
        if "data[merges][INTERESTS]" in data:
            merges["INTERESTS"] = data["data[merges][INTERESTS]"]
        return merges

    def _subscribe(self, d: Dict[str, str]) -> Dict[str, Any]:
        return {
            "event": "subscribe",
            "entityType": "user",
            "entityId": _req(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(d, "data[list_id]"),
            "eventTime": parse_mailchimp_datetime(_req(d, "fired_at")),
            "properties": {
                "email": _req(d, "data[email]"),
                "email_type": _req(d, "data[email_type]"),
                "merges": self._merges(d),
                "ip_opt": _req(d, "data[ip_opt]"),
                "ip_signup": _req(d, "data[ip_signup]"),
            },
        }

    def _unsubscribe(self, d: Dict[str, str]) -> Dict[str, Any]:
        return {
            "event": "unsubscribe",
            "entityType": "user",
            "entityId": _req(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(d, "data[list_id]"),
            "eventTime": parse_mailchimp_datetime(_req(d, "fired_at")),
            "properties": {
                "action": _req(d, "data[action]"),
                "reason": _req(d, "data[reason]"),
                "email": _req(d, "data[email]"),
                "email_type": _req(d, "data[email_type]"),
                "merges": self._merges(d),
                "ip_opt": _req(d, "data[ip_opt]"),
                "campaign_id": _req(d, "data[campaign_id]"),
            },
        }

    def _profile(self, d: Dict[str, str]) -> Dict[str, Any]:
        return {
            "event": "profile",
            "entityType": "user",
            "entityId": _req(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(d, "data[list_id]"),
            "eventTime": parse_mailchimp_datetime(_req(d, "fired_at")),
            "properties": {
                "email": _req(d, "data[email]"),
                "email_type": _req(d, "data[email_type]"),
                "merges": self._merges(d),
                "ip_opt": _req(d, "data[ip_opt]"),
            },
        }

    def _upemail(self, d: Dict[str, str]) -> Dict[str, Any]:
        return {
            "event": "upemail",
            "entityType": "user",
            "entityId": _req(d, "data[new_id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(d, "data[list_id]"),
            "eventTime": parse_mailchimp_datetime(_req(d, "fired_at")),
            "properties": {
                "new_email": _req(d, "data[new_email]"),
                "old_email": _req(d, "data[old_email]"),
            },
        }

    def _cleaned(self, d: Dict[str, str]) -> Dict[str, Any]:
        return {
            "event": "cleaned",
            "entityType": "list",
            "entityId": _req(d, "data[list_id]"),
            "eventTime": parse_mailchimp_datetime(_req(d, "fired_at")),
            "properties": {
                "campaignId": _req(d, "data[campaign_id]"),
                "reason": _req(d, "data[reason]"),
                "email": _req(d, "data[email]"),
            },
        }

    def _campaign(self, d: Dict[str, str]) -> Dict[str, Any]:
        return {
            "event": "campaign",
            "entityType": "campaign",
            "entityId": _req(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(d, "data[list_id]"),
            "eventTime": parse_mailchimp_datetime(_req(d, "fired_at")),
            "properties": {
                "subject": _req(d, "data[subject]"),
                "status": _req(d, "data[status]"),
                "reason": _req(d, "data[reason]"),
            },
        }
