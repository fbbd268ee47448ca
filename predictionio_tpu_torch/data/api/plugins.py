"""Event-server plugin SPI (the port's copy of
``predictionio_tpu/data/api/plugins.py``).

Reference: data/.../api/EventServerPlugin.scala:21-30 and
EventServerPluginContext.scala — two plugin kinds, "inputblocker" (runs
synchronously in the request path, may raise to reject an event) and
"inputsniffer" (observes asynchronously). Discovery via Python entry-point
style registration instead of java.util.ServiceLoader.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from predictionio_tpu_torch.common.plugin_registry import PluginContextBase
from predictionio_tpu_torch.data.event import Event

logger = logging.getLogger("predictionio_tpu_torch.api.plugins")

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


class EventInfo:
    """The payload handed to plugins (EventServerPlugin.process signature)."""

    def __init__(self, app_id: int, channel_id: Optional[int], event: Event):
        self.app_id = app_id
        self.channel_id = channel_id
        self.event = event


class EventServerPlugin:
    """Subclass and set plugin_name/plugin_description/plugin_type."""

    plugin_name = ""
    plugin_description = ""
    plugin_type = INPUT_SNIFFER

    def process(self, event_info: EventInfo, context) -> None:
        """Blockers raise to reject; sniffers observe."""

    def handle_rest(self, app_id: int, channel_id: Optional[int],
                    args: Sequence[str]) -> str:
        """Answer GET /plugins/<type>/<name>/... (returns a JSON string)."""
        return "{}"


class EventServerPluginContext(PluginContextBase):
    """Plugin registry (EventServerPluginContext.scala:40-91)."""

    BLOCKER_KIND = INPUT_BLOCKER
    SNIFFER_KIND = INPUT_SNIFFER

    @property
    def input_blockers(self):
        return self.kind(INPUT_BLOCKER)

    @property
    def input_sniffers(self):
        return self.kind(INPUT_SNIFFER)
