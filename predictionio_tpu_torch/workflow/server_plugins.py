"""Engine-server plugin SPI (port of
``predictionio_tpu/workflow/server_plugins.py``).

Reference: core/.../workflow/EngineServerPlugin.scala:24-40 and
EngineServerPluginContext.scala:40-91 — "outputblocker" plugins transform
(or veto) each prediction synchronously; "outputsniffer" plugins observe
asynchronously and can answer REST calls under /plugins/.
"""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.common.plugin_registry import PluginContextBase

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EngineServerPlugin:
    plugin_name = ""
    plugin_description = ""
    plugin_type = OUTPUT_SNIFFER

    def process(self, engine_instance, query_obj, prediction_obj, context):
        """Blockers return the (possibly rewritten) prediction JSON object;
        sniffers' return value is ignored."""
        return prediction_obj

    def handle_rest(self, args: Sequence[str]) -> str:
        return "{}"

    def start(self, context) -> None:
        """Called once when the server starts (EngineServerPlugin.start)."""


class EngineServerPluginContext(PluginContextBase):
    BLOCKER_KIND = OUTPUT_BLOCKER
    SNIFFER_KIND = OUTPUT_SNIFFER

    @property
    def output_blockers(self):
        return self.kind(OUTPUT_BLOCKER)

    @property
    def output_sniffers(self):
        return self.kind(OUTPUT_SNIFFER)
