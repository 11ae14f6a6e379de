"""Shared stdlib HTTP client for the Kubernetes API server.

Both halves of the operator's k8s surface ride this one client: the pod
backend (kube_pod_api.py) and the custom-resource watch (kube_cr_source.py).
The reference routes all control flow through the API server
(the reference's docs/design/elastic-training-operator.md:16-18,53-55), so
this client speaks exactly the two protocols that requires: plain JSON
request/response for CRUD, and the chunked line-delimited JSON stream the
WATCH verb returns.

stdlib-only on purpose: the image carries no ``kubernetes`` client package,
and the surface we need (GET/POST/PUT/DELETE plus a streaming GET) is small.
In-cluster auth (service-account token + CA + namespace) is picked up from
the conventional mount path when ``base_url`` is empty; tests point
``base_url`` at a local fake API server over plain HTTP.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, Optional

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(f"k8s API {code}: {message}")
        self.code = code


class KubeClient:
    """Minimal k8s API-server client: JSON CRUD + watch streaming."""

    def __init__(
        self,
        base_url: str = "",
        namespace: str = "",
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        timeout: float = 10.0,
    ):
        if not base_url:
            # In-cluster defaults (the conventional env + SA mount).
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise ValueError(
                    "base_url not given and KUBERNETES_SERVICE_HOST unset "
                    "(not running in a cluster?)"
                )
            base_url = f"https://{host}:{port}"
            if token is None:
                try:
                    with open(f"{SA_DIR}/token") as f:
                        token = f.read().strip()
                except OSError:
                    token = None
            if ca_file is None:
                ca_file = f"{SA_DIR}/ca.crt"
            if not namespace:
                try:
                    with open(f"{SA_DIR}/namespace") as f:
                        namespace = f.read().strip()
                except OSError:
                    pass
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace or "default"
        self._token = token
        self._timeout = timeout
        self._ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            self._ctx = ssl.create_default_context(
                cafile=ca_file if ca_file else None
            )

    def _make_request(self, method: str, path: str,
                      body: Optional[Dict[str, Any]],
                      content_type: str = "application/json",
                      ) -> urllib.request.Request:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method
        )
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        return req

    def request(self, method: str, path: str,
                body: Optional[Dict[str, Any]] = None,
                content_type: str = "application/json") -> Dict[str, Any]:
        req = self._make_request(method, path, body, content_type)
        try:
            with urllib.request.urlopen(
                req, timeout=self._timeout, context=self._ctx
            ) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            raise KubeApiError(e.code, f"{method} {path}: {detail}") from e
        return json.loads(payload) if payload else {}

    def stream(self, path: str,
               read_timeout: float = 90.0) -> Iterator[Dict[str, Any]]:
        """GET ``path`` and yield one parsed JSON object per line as the
        server writes them — the k8s WATCH wire format. The iterator ends
        when the server closes the stream (watch timeoutSeconds elapsed);
        callers re-watch from their last resourceVersion."""
        req = self._make_request("GET", path, None)
        try:
            resp = urllib.request.urlopen(
                req, timeout=read_timeout, context=self._ctx
            )
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            raise KubeApiError(e.code, f"WATCH {path}: {detail}") from e
        try:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue  # torn line at stream teardown
        finally:
            resp.close()
