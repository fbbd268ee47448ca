"""Daemon security: shared-key auth + TLS for the HTTP servers (the port's
copy of ``predictionio_tpu/common/server_security.py``).

Reference: common/src/main/scala/.../authentication/KeyAuthentication.scala
(a configured server key checked against an `accessKey` request param) and
common/.../configuration/SSLConfiguration.scala (keystore-driven TLS for
spray-can). Here: the key comes from PIO_SERVER_KEY (or a CLI flag) and is
accepted either as an `X-PIO-Server-Key` header or an `accessKey` query
param (reference parity); TLS wraps the stdlib server socket with a PEM
cert/key pair from PIO_SSL_CERTFILE / PIO_SSL_KEYFILE.
"""

from __future__ import annotations

import hmac
import os
import ssl
from typing import Dict, Optional


def _digest_eq(given: str, expected: str) -> bool:
    """Constant-time string equality. compare_digest rejects non-ASCII str,
    so compare encoded bytes (surrogateescape keeps undecodable header
    bytes comparable instead of raising)."""
    return hmac.compare_digest(
        given.encode("utf-8", "surrogateescape"),
        expected.encode("utf-8", "surrogateescape"))


class KeyAuth:
    """Shared-secret gate for the dashboard/admin/storage daemons.

    key=None (and no PIO_SERVER_KEY) disables the check — matching the
    reference, where KeyAuthentication passes when no key is configured.
    """

    HEADER = "x-pio-server-key"
    PARAM = "accessKey"

    def __init__(self, key: Optional[str] = None):
        self.key = key if key is not None else (
            os.environ.get("PIO_SERVER_KEY") or None)

    def authorized(self, headers: Optional[Dict[str, str]],
                   query: Optional[Dict[str, str]]) -> bool:
        if not self.key:
            return True
        h = {k.lower(): v for k, v in (headers or {}).items()}
        # constant-time comparison: a plain == leaks key prefixes through
        # response timing
        if _digest_eq(h.get(self.HEADER, ""), self.key):
            return True
        return _digest_eq((query or {}).get(self.PARAM, ""), self.key)

    def gate(self, headers, query):
        """None when authorized, else the (status, payload) rejection."""
        if self.authorized(headers, query):
            return None
        return 401, {"message": "invalid server key"}


def ssl_context_from_env(
    certfile: Optional[str] = None,
    keyfile: Optional[str] = None) -> Optional[ssl.SSLContext]:
    """Build a server-side TLS context from explicit paths or
    PIO_SSL_CERTFILE / PIO_SSL_KEYFILE; None when TLS is not configured."""
    certfile = certfile or os.environ.get("PIO_SSL_CERTFILE")
    keyfile = keyfile or os.environ.get("PIO_SSL_KEYFILE")
    if not certfile:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile or None)
    return ctx


def maybe_wrap_ssl(server, certfile: Optional[str] = None,
                   keyfile: Optional[str] = None):
    """Wrap an http.server socket in TLS when configured; returns the
    scheme actually in effect ("https" or "http")."""
    ctx = ssl_context_from_env(certfile, keyfile)
    if ctx is None:
        return "http"
    server.socket = ctx.wrap_socket(server.socket, server_side=True)
    return "https"
