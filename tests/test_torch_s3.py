"""The port's object-store Models backend (``data/storage/s3.py``)
against an in-process fake S3 server, mirrored from the reference's
``tests/test_s3_models.py``: the round trip, overwrite, a missing get,
delete, error surfacing and the key layout; and its SigV4 headers equal
to the reference's, exactly, for a fixed clock and fixed credentials."""

import datetime as dt
import hashlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from predictionio_tpu.data.storage import s3 as ref_s3
from predictionio_tpu.data.storage import StorageClientConfig as RefConfig
from predictionio_tpu_torch.data.storage import Model, Storage
from predictionio_tpu_torch.data.storage import StorageClientConfig
from predictionio_tpu_torch.data.storage import s3


class _FakeS3(BaseHTTPRequestHandler):
    store: dict = {}
    seen_headers: list = []
    fail_next: list = []       # status codes to force, consumed in order

    def _respond(self, status, body=b""):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):  # noqa: N802
        self.seen_headers.append(dict(self.headers.items()))
        if self.fail_next:
            return self._respond(self.fail_next.pop(0))
        n = int(self.headers.get("Content-Length") or 0)
        self.store[self.path] = self.rfile.read(n)
        self._respond(200)

    def do_GET(self):  # noqa: N802
        if self.fail_next:
            return self._respond(self.fail_next.pop(0))
        if self.path in self.store:
            self._respond(200, self.store[self.path])
        else:
            self._respond(404)

    def do_DELETE(self):  # noqa: N802
        if self.fail_next:
            return self._respond(self.fail_next.pop(0))
        self.store.pop(self.path, None)
        self._respond(204)

    def log_message(self, *a):
        pass


def _env(port, **extra):
    return {
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_SOURCES_S3_TYPE": "s3",
        "PIO_STORAGE_SOURCES_S3_ENDPOINT": f"http://127.0.0.1:{port}",
        "PIO_STORAGE_SOURCES_S3_BUCKET_NAME": "pio-models",
        "PIO_STORAGE_SOURCES_S3_BASE_PATH": "prod/models",
        "PIO_STORAGE_SOURCES_S3_ACCESS_KEY_ID": "AKIDEXAMPLE",
        "PIO_STORAGE_SOURCES_S3_SECRET_ACCESS_KEY": "secret",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3",
        **extra,
    }


@pytest.fixture()
def s3_storage():
    handler = type("H", (_FakeS3,), {"store": {}, "seen_headers": [],
                                     "fail_next": []})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield Storage(env=_env(server.server_address[1])), handler
    finally:
        server.shutdown()
        server.server_close()


def test_roundtrip_overwrite_delete(s3_storage):
    storage, handler = s3_storage
    models = storage.get_model_data_models()
    models.insert(Model(id="inst1", models=b"\x00blob-one"))
    got = models.get("inst1")
    assert got is not None and got.models == b"\x00blob-one"
    # key layout: /<bucket>/<BASE_PATH>/<namespace>-<id>
    assert "/pio-models/prod/models/pio_modeldata-inst1" in handler.store
    models.insert(Model(id="inst1", models=b"blob-two"))
    assert models.get("inst1").models == b"blob-two"
    assert models.get("missing") is None
    models.delete("inst1")
    assert models.get("inst1") is None


def test_sigv4_headers_present(s3_storage):
    storage, handler = s3_storage
    storage.get_model_data_models().insert(Model(id="x", models=b"y"))
    hdrs = handler.seen_headers[-1]
    auth = hdrs.get("authorization", "")
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/")
    assert "SignedHeaders=host;x-amz-content-sha256;x-amz-date" in auth
    assert hdrs.get("x-amz-content-sha256") == hashlib.sha256(
        b"y").hexdigest()


@pytest.mark.parametrize("verb,status,match", [
    ("PUT", 500, "PUT"), ("GET", 403, "403"), ("GET", 500, "GET"),
    ("DELETE", 500, "DELETE")])
def test_failures_surface(s3_storage, verb, status, match):
    storage, handler = s3_storage
    models = storage.get_model_data_models()
    handler.fail_next.append(status)
    with pytest.raises(IOError, match=match):
        if verb == "PUT":
            models.insert(Model(id="z", models=b"b"))
        elif verb == "GET":
            models.get("z")
        else:
            models.delete("z")


def test_missing_bucket_rejected():
    env = _env(1)
    del env["PIO_STORAGE_SOURCES_S3_BUCKET_NAME"]
    with pytest.raises((ValueError, RuntimeError), match="BUCKET_NAME"):
        Storage(env=env).get_model_data_models()


@pytest.mark.parametrize("props,method,path,body", [
    ({"ENDPOINT": "https://s3.us-east-1.amazonaws.com",
      "BUCKET_NAME": "b", "ACCESS_KEY_ID": "AKID", "SECRET_ACCESS_KEY": "s",
      "REGION": "us-east-1"}, "PUT", "/b/pio_modeldata-i%20d", b"blob"),
    ({"ENDPOINT": "http://minio:9000", "BUCKET_NAME": "m",
      "ACCESS_KEY_ID": "K2", "SECRET_ACCESS_KEY": "s2",
      "REGION": "eu-west-3", "SESSION_TOKEN": "tok"},
     "GET", "/m/models/pio_modeldata-x", b""),
    ({"ENDPOINT": "http://127.0.0.1:9", "BUCKET_NAME": "anon"},
     "DELETE", "/anon/k", b""),
])
def test_sigv4_signature_is_the_reference(monkeypatch, props, method, path,
                                          body):
    for name in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
                 "AWS_SESSION_TOKEN"):
        monkeypatch.delenv(name, raising=False)
    now = dt.datetime(2024, 7, 1, 12, 34, 56, tzinfo=dt.timezone.utc)
    sha = hashlib.sha256(body).hexdigest()
    a = ref_s3.StorageClient(RefConfig(properties=dict(props)))._sign(
        method, path, sha, now)
    b = s3.StorageClient(StorageClientConfig(properties=dict(props)))._sign(
        method, path, sha, now)
    assert a == b
    assert ("authorization" in b) == ("ACCESS_KEY_ID" in props)
