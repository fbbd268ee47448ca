"""Event Server: REST ingestion API (port of
``predictionio_tpu/data/api/``).

Reference: data/src/main/scala/org/apache/predictionio/data/api/
(EventServer.scala:147-592 routes; Stats.scala; EventServerPlugin.scala).
The route logic is a pure handler (`service.EventAPI`) so tests exercise
it without sockets; `http.serve_forever` wraps it in a threaded stdlib
HTTP server.
"""

from predictionio_tpu_torch.data.api.service import (
    EventAPI, EventServerConfig,
)
from predictionio_tpu_torch.data.api.stats import Stats
from predictionio_tpu_torch.data.api.plugins import EventServerPlugin

__all__ = ["EventAPI", "EventServerConfig", "Stats", "EventServerPlugin"]
