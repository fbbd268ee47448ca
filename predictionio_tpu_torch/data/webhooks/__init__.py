"""Webhook connector SPI + registry (the port's copy of
``predictionio_tpu/data/webhooks/``).

Reference: data/src/main/scala/org/apache/predictionio/data/webhooks/
{JsonConnector.scala:32, FormConnector.scala:33, ConnectorUtil.scala,
WebhooksConnectors.scala}. A connector maps a third-party payload to the
Event JSON wire format; the event object itself is always built by
`Event.from_dict` so validation stays uniform (ConnectorUtil comment parity).
"""

from __future__ import annotations

import abc
from typing import Any, Dict

from predictionio_tpu_torch.data.event import Event


class ConnectorException(ValueError):
    """Raised when a payload cannot be converted (ConnectorException.scala)."""


class JsonConnector(abc.ABC):
    """JSON-body webhook connector (JsonConnector.scala:32)."""

    @abc.abstractmethod
    def to_event_json(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """Original webhook JSON object -> Event JSON object."""


class FormConnector(abc.ABC):
    """Form-encoded webhook connector (FormConnector.scala:33)."""

    @abc.abstractmethod
    def to_event_json(self, data: Dict[str, str]) -> Dict[str, Any]:
        """Form key/value pairs -> Event JSON object."""


def to_event(connector, data) -> Event:
    """Connector output -> validated Event (ConnectorUtil.toEvent)."""
    return Event.from_dict(connector.to_event_json(data))


def default_json_connectors() -> Dict[str, JsonConnector]:
    """Built-in JSON connectors (WebhooksConnectors.scala: segmentio)."""
    from predictionio_tpu_torch.data.webhooks.segmentio import (
        SegmentIOConnector,
    )
    return {"segmentio": SegmentIOConnector()}


def default_form_connectors() -> Dict[str, FormConnector]:
    """Built-in form connectors (WebhooksConnectors.scala: mailchimp)."""
    from predictionio_tpu_torch.data.webhooks.mailchimp import (
        MailChimpConnector,
    )
    return {"mailchimp": MailChimpConnector()}
