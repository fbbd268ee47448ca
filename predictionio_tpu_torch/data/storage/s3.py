"""S3-compatible object-store backend for the Models repository (port of
``predictionio_tpu/data/storage/s3.py``; host-only stdlib, the same
SigV4 signature for the same clock and credentials).

Reference: storage/s3/src/main/scala/org/apache/predictionio/data/storage/
s3/S3Models.scala:36-95 — durable shared model blobs keyed
``<BASE_PATH>/<namespace>-<id>`` in ``<BUCKET_NAME>``, so every host of a
multi-host deployment reads the same trained model without a shared
filesystem. (HDFSModels.scala:31-66 fills the same role; an S3-compatible
endpoint subsumes it for object stores like GCS interop / MinIO / Ceph.)

Implementation notes: the blob is the whole pickled model
(workflow/model_io.py), moved in ONE ranged-less GET/PUT — no multipart,
no SDK. The client is pure stdlib (http.client + hmac SigV4), because
this image bakes no boto3; any S3-compatible endpoint works via

  PIO_STORAGE_SOURCES_<N>_TYPE=s3
  PIO_STORAGE_SOURCES_<N>_ENDPOINT=https://s3.us-east-1.amazonaws.com
      (or http://minio:9000 etc.; path-style addressing is used)
  PIO_STORAGE_SOURCES_<N>_BUCKET_NAME=my-bucket
  PIO_STORAGE_SOURCES_<N>_BASE_PATH=models        (optional prefix)
  PIO_STORAGE_SOURCES_<N>_REGION=us-east-1        (default us-east-1)
  PIO_STORAGE_SOURCES_<N>_ACCESS_KEY_ID=...       (falls back to
  PIO_STORAGE_SOURCES_<N>_SECRET_ACCESS_KEY=...    AWS_* env vars;
                                                   unsigned if absent)

Only the Models DAO is provided, mirroring the reference (its s3 module
likewise backs nothing else); point METADATA/EVENTDATA at another source.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import http.client
import logging
import ssl
import urllib.parse
from typing import Optional, Tuple

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model

logger = logging.getLogger(__name__)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class StorageClient:
    """Connection settings + SigV4 signer for one S3-compatible source."""

    def __init__(self, config):
        self.config = config
        p = config.properties
        endpoint = p.get("ENDPOINT") or "https://s3.amazonaws.com"
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise ValueError(f"invalid s3 ENDPOINT {endpoint!r}")
        self.secure = u.scheme == "https"
        self.host = u.hostname
        self.port = u.port or (443 if self.secure else 80)
        self.bucket = p.get("BUCKET_NAME")
        if not self.bucket:
            raise ValueError(
                "Storage source of TYPE s3 requires BUCKET_NAME "
                "(S3Models.scala doAction contract)")
        self.base_path = (p.get("BASE_PATH") or "").strip("/")
        self.region = p.get("REGION", "us-east-1")
        import os
        self.access_key = p.get("ACCESS_KEY_ID",
                                os.environ.get("AWS_ACCESS_KEY_ID", ""))
        self.secret_key = p.get(
            "SECRET_ACCESS_KEY",
            os.environ.get("AWS_SECRET_ACCESS_KEY", ""))
        # temporary credentials (ECS/EKS/SSO) require the session token
        # to ride along as a signed header or every request 403s
        self.session_token = p.get(
            "SESSION_TOKEN", os.environ.get("AWS_SESSION_TOKEN", ""))
        self.timeout = float(p.get("TIMEOUT_S", "60"))

    # ---- SigV4 (rfc-style canonical request; path-style addressing) ------
    def _sign(self, method: str, path: str, payload_sha: str,
              now: _dt.datetime) -> dict:
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host_hdr = (self.host if self.port in (80, 443)
                    else f"{self.host}:{self.port}")
        headers = {"host": host_hdr, "x-amz-date": amz_date,
                   "x-amz-content-sha256": payload_sha}
        if not self.access_key:
            headers.pop("x-amz-date")
            return headers     # unsigned (test fakes, anonymous endpoints)
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed = ";".join(sorted(headers))
        # `path` arrives already percent-encoded (request() quotes once);
        # quoting again here would sign %25-escapes the wire never sends
        canonical = "\n".join([
            method, path, "",
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed, payload_sha])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

        def h(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = h(h(h(h(("AWS4" + self.secret_key).encode(), datestamp),
                  self.region), "s3"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}")
        return headers

    def request(self, method: str, key: str,
                body: bytes = b"") -> Tuple[int, bytes]:
        path = "/" + urllib.parse.quote(f"{self.bucket}/{key}")
        payload_sha = (hashlib.sha256(body).hexdigest() if body
                       else _EMPTY_SHA256)
        headers = self._sign(method, path, payload_sha,
                             _dt.datetime.now(_dt.timezone.utc))
        if body:
            headers["content-length"] = str(len(body))
        conn_cls = http.client.HTTPSConnection if self.secure \
            else http.client.HTTPConnection
        kwargs = {"timeout": self.timeout}
        if self.secure:
            kwargs["context"] = ssl.create_default_context()
        conn = conn_cls(self.host, self.port, **kwargs)
        try:
            conn.request(method, path, body=body or None, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()


class S3Models(base.Models):
    """S3Models.scala:36-95 parity: insert/get/delete one object per id."""

    def __init__(self, client: StorageClient, config, namespace: str):
        self.client = client
        self.namespace = namespace

    def _key(self, model_id: str) -> str:
        name = f"{self.namespace}-{model_id}"
        return f"{self.client.base_path}/{name}" if self.client.base_path \
            else name

    def insert(self, m: Model) -> None:
        status, body = self.client.request("PUT", self._key(m.id),
                                           m.models)
        if status not in (200, 201, 204):
            # reference logs and swallows; a lost model should fail the
            # train instead of surfacing at deploy as "no model data"
            raise IOError(
                f"S3 PUT {self._key(m.id)} failed: {status} {body[:200]!r}")

    def get(self, model_id: str) -> Optional[Model]:
        status, body = self.client.request("GET", self._key(model_id))
        if status == 200:
            return Model(id=model_id, models=body)
        if status == 404:
            return None
        if status == 403:
            # NOT mapped to None: a credential failure must not
            # masquerade as "no model data" at deploy. (S3 also answers
            # 403 for a MISSING key when the caller lacks s3:ListBucket —
            # grant it to get 404 semantics for absent models.)
            raise IOError(
                f"S3 GET {self._key(model_id)} returned 403: bad/absent "
                "credentials, or the key is missing and the principal "
                "lacks s3:ListBucket (which turns 404s into 403s)")
        raise IOError(
            f"S3 GET {self._key(model_id)} failed: {status} {body[:200]!r}")

    def delete(self, model_id: str) -> None:
        status, body = self.client.request("DELETE", self._key(model_id))
        if status not in (200, 204, 404):
            raise IOError(
                f"S3 DELETE {self._key(model_id)} failed: "
                f"{status} {body[:200]!r}")
