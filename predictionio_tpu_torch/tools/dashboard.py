"""Evaluation dashboard (:9000) (port of
``predictionio_tpu/tools/dashboard.py``). The telemetry routes answer
before the key check, as on every daemon.

Reference: tools/.../dashboard/Dashboard.scala:44-160 + the twirl template
(tools/src/main/twirl/.../index.scala.html): an HTML page listing completed
EvaluationInstances newest-first with links to per-instance detail pages
carrying the evaluator's HTML/JSON results.
"""

from __future__ import annotations

import html
from typing import Any, Dict, Optional, Tuple

from predictionio_tpu_torch.data.event import format_event_time
from predictionio_tpu_torch.data.storage import Storage, get_storage

Response = Tuple[int, Any]


class DashboardAPI:
    def __init__(self, storage: Optional[Storage] = None,
                 server_key: Optional[str] = None):
        from predictionio_tpu_torch.common import (
            devicewatch, history, slo,
        )
        from predictionio_tpu_torch.common.server_security import KeyAuth
        self.storage = storage if storage is not None else get_storage()
        self.auth = KeyAuth(server_key)
        devicewatch.install()
        slo.install()
        # /debug/history.json rings (one sampler thread per process)
        history.install()

    def handle(self, method: str, path: str,
               query: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               headers: Optional[Dict[str, str]] = None) -> Response:
        method = method.upper()
        path = (path or "/").rstrip("/") or "/"
        # probes + telemetry surface answer before auth, like every
        # other daemon: a load balancer or a scraper holds no key
        if path == "/healthz" and method == "GET":
            return 200, {"status": "ok"}
        headers = headers or {}
        from predictionio_tpu_torch.common import telemetry
        t = telemetry.handle_route(
            method, path, query,
            accept=headers.get("accept") or headers.get("Accept"))
        if t is not None:   # /metrics, /traces.json, /debug/*
            return t
        # KeyAuthentication.scala parity: reject before routing
        rejected = self.auth.gate(headers, query)
        if rejected is not None:
            return rejected
        if method != "GET":
            return 405, {"message": "method not allowed"}
        if path == "/":
            return 200, HtmlPayload(self._index())
        if path.startswith("/engine_instances/"):
            rest = path[len("/engine_instances/"):]
            if rest.endswith(".json"):
                return self._instance_json(rest[:-len(".json")])
            if rest.endswith(".html"):
                return self._instance_html(rest[:-len(".html")])
        return 404, {"message": "Not Found"}

    def _completed(self):
        instances = self.storage.get_meta_data_evaluation_instances()
        return sorted(instances.get_completed(),
                      key=lambda i: i.start_time, reverse=True)

    def _index(self) -> str:
        rows = "".join(
            f"<tr><td>{html.escape(i.id)}</td>"
            f"<td>{format_event_time(i.start_time)}</td>"
            f"<td>{format_event_time(i.end_time)}</td>"
            f"<td>{html.escape(i.evaluation_class)}</td>"
            f"<td>{html.escape(i.engine_params_generator_class)}</td>"
            f"<td>{html.escape(i.batch)}</td>"
            f"<td><a href='/engine_instances/{i.id}.html'>HTML</a> "
            f"<a href='/engine_instances/{i.id}.json'>JSON</a></td></tr>"
            for i in self._completed())
        return (
            "<!DOCTYPE html><html><head><title>PredictionIO Dashboard"
            "</title></head><body><h1>PredictionIO Dashboard</h1>"
            "<h2>Completed Evaluations</h2>"
            "<table border=1><tr><th>ID</th><th>Start Time</th>"
            "<th>End Time</th><th>Evaluation Class</th>"
            "<th>Engine Params Generator Class</th><th>Batch</th>"
            f"<th>Results</th></tr>{rows}</table></body></html>")

    def _get(self, instance_id: str):
        return self.storage.get_meta_data_evaluation_instances().get(
            instance_id)

    def _instance_json(self, instance_id: str) -> Response:
        i = self._get(instance_id)
        if i is None or i.status != "EVALCOMPLETED":
            return 404, {"message": "Not Found"}
        import json
        return 200, json.loads(i.evaluator_results_json or "{}")

    def _instance_html(self, instance_id: str) -> Response:
        i = self._get(instance_id)
        if i is None or i.status != "EVALCOMPLETED":
            return 404, {"message": "Not Found"}
        return 200, HtmlPayload(
            "<!DOCTYPE html><html><head><title>Evaluation "
            f"{html.escape(i.id)}</title></head><body>"
            f"<h1>Evaluation {html.escape(i.id)}</h1>"
            f"{i.evaluator_results_html}</body></html>")


class HtmlPayload(str):
    """Marker so the HTTP layer serves text/html instead of JSON."""
