"""Shared two-kind plugin registry (the port's copy of
``predictionio_tpu/common/plugin_registry.py``).

Both daemons expose the same plugin shape (reference: ServiceLoader-backed
EventServerPluginContext.scala:40-91 and EngineServerPluginContext.scala):
a synchronous "blocker" kind and an observing "sniffer" kind, a
/plugins.json inventory, and /plugins/<type>/<name>/... REST handoff.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Sequence, Tuple


class PluginContextBase:
    """Registry over two plugin kinds; subclasses set BLOCKER_KIND and
    SNIFFER_KIND (the plugin_type strings, which double as the JSON keys
    pluralized)."""

    BLOCKER_KIND = ""
    SNIFFER_KIND = ""

    def __init__(self, plugins: Sequence[Any] = ()):
        self._by_kind: Dict[str, Dict[str, Any]] = {
            self.BLOCKER_KIND: {}, self.SNIFFER_KIND: {}}
        for p in plugins:
            self.register(p)

    def register(self, plugin) -> None:
        kind = plugin.plugin_type
        if kind not in self._by_kind:
            # a typo'd blocker silently demoted to sniffer would never
            # block — refuse the registration outright
            raise ValueError(
                f"plugin {plugin.plugin_name!r} has unknown plugin_type "
                f"{kind!r}; expected {self.BLOCKER_KIND!r} or "
                f"{self.SNIFFER_KIND!r}")
        self._by_kind[kind][plugin.plugin_name] = plugin

    def kind(self, plugin_type: str) -> Dict[str, Any]:
        return self._by_kind.get(plugin_type, {})

    def describe(self) -> Dict[str, Dict[str, Dict[str, str]]]:
        def block(ps: Dict[str, Any]):
            return {
                n: {"name": p.plugin_name,
                    "description": p.plugin_description,
                    "class": type(p).__module__ + "." + type(p).__qualname__}
                for n, p in ps.items()}
        return {"plugins": {
            kind + "s": block(ps) for kind, ps in self._by_kind.items()}}


def dispatch_plugin_rest(
    context: PluginContextBase,
    path: str,
    call: Callable[[Any, Sequence[str]], str],
) -> Tuple[int, Any]:
    """Answer GET /plugins/<type>/<name>/<args...>; `call(plugin, args)`
    adapts the per-daemon handle_rest signature."""
    segments = [s for s in path.split("/") if s][1:]  # drop "plugins"
    if len(segments) < 2:
        return 404, {"message": "Not Found"}
    plugin_type, plugin_name, *args = segments
    registry = context.kind(plugin_type)
    if plugin_name not in registry:
        return 404, {"message": "Not Found"}
    out = call(registry[plugin_name], args)
    try:
        return 200, json.loads(out)
    except ValueError:
        return 200, {"result": out}
