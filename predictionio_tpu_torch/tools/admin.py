"""Admin REST API (:7071, experimental in the reference) (port of
``predictionio_tpu/tools/admin.py``). The telemetry routes answer
before the key check, as on every daemon.

Reference: tools/.../admin/AdminAPI.scala:39-130 and CommandClient.scala —
  GET    /                      -> status
  GET    /cmd/app               -> list apps
  POST   /cmd/app               -> create app {"name": ..., "id"?, "description"?}
  DELETE /cmd/app/{name}        -> delete app
  DELETE /cmd/app/{name}/data   -> wipe app event data
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.tools import apps as app_cmds
from predictionio_tpu_torch.tools.apps import CommandError

Response = Tuple[int, Any]


class AdminAPI:
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
        try:
            if path == "/" and method == "GET":
                return 200, {"status": "alive"}
            if path == "/cmd/app" and method == "GET":
                return 200, [self._desc(d)
                             for d in app_cmds.list_apps(self.storage)]
            if path == "/cmd/app" and method == "POST":
                try:
                    req = json.loads(body.decode("utf-8"))
                except ValueError as e:
                    return 400, {"message": str(e)}
                if "name" not in req:
                    return 400, {"message": "field name is required"}
                desc = app_cmds.create(
                    req["name"], app_id=req.get("id"),
                    description=req.get("description"),
                    storage=self.storage)
                return 201, self._desc(desc)
            if path.startswith("/cmd/app/") and method == "DELETE":
                rest = path[len("/cmd/app/"):]
                if rest.endswith("/data"):
                    app_cmds.data_delete(rest[:-len("/data")], delete_all=True,
                                         storage=self.storage)
                    return 200, {"message": "Data deleted."}
                app_cmds.delete(rest, storage=self.storage)
                return 200, {"message": "App deleted."}
            return 404, {"message": "Not Found"}
        except CommandError as e:
            return 400, {"message": str(e)}
        except Exception as e:
            return 500, {"message": str(e)}

    @staticmethod
    def _desc(d: app_cmds.AppDescription) -> Dict[str, Any]:
        return {
            "name": d.app.name,
            "id": d.app.id,
            "description": d.app.description,
            "accessKeys": [
                {"key": k.key, "events": list(k.events)} for k in d.keys],
        }
