"""Real Kubernetes Deployment API client (stdlib HTTP/TLS; PyYAML only for
kubeconfig files, with a JSON fallback when PyYAML is absent).

The port's copy of ``kube_sqs_autoscaler_tpu/scale/kube.py``.  The YAML
import stays lazy: without PyYAML a JSON kubeconfig still works.

Reference counterpart: ``NewPodAutoScaler``'s client-go wiring
(``scale/scale.go:31-52``) plus the Get/Update calls
(``scale/scale.go:55,72,82,100``).  Same config resolution order:

- ``KUBE_CONFIG_PATH`` env var names a kubeconfig file
  (``scale/scale.go:32``); when unset/empty, fall back to in-cluster
  configuration (service-account token + CA at
  ``/var/run/secrets/kubernetes.io/serviceaccount``), exactly client-go's
  ``BuildConfigFromFlags("", path)`` behavior that the README deployment
  relies on.
- Config/client failure at construction raises :class:`KubeConfigError`
  with the reference's panic messages (``scale/scale.go:35,40``) — startup
  config errors are fatal, matching the reference's panic-not-error choice
  (documented in SURVEY §5 "failure detection").

API surface is the one the actuator needs (SURVEY §1 seam): typed GET and
full-object PUT of ``apps/v1`` Deployments in one namespace — deliberately
*not* the Scale subresource and with *no* conflict retry, preserving the
reference's read-modify-write shape (SURVEY §7.3).
"""

from __future__ import annotations

import json
import os
import ssl
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from base64 import b64decode
from dataclasses import dataclass
from pathlib import Path

from .objects import Deployment

SERVICE_ACCOUNT_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")


class KubeConfigError(RuntimeError):
    """Startup configuration failure (reference panics: ``scale/scale.go:35,40``)."""


class KubeApiError(RuntimeError):
    """A Deployment API call failed (non-2xx or transport error)."""

    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status


@dataclass
class ClusterConfig:
    """Resolved connection parameters for one apiserver."""

    server: str  # https://host:port
    token: str | None = None
    # In-cluster bound service-account tokens rotate on disk (~hourly on
    # modern clusters); when set, the token is re-read per request like
    # client-go does, instead of being frozen at startup.
    token_file: str | None = None
    ca_cert_path: str | None = None
    client_cert_path: str | None = None
    client_key_path: str | None = None
    skip_tls_verify: bool = False

    def bearer_token(self) -> str | None:
        if self.token_file:
            try:
                return Path(self.token_file).read_text().strip()
            except OSError:
                return self.token  # fall back to the startup token
        return self.token

    def ssl_context(self) -> ssl.SSLContext:
        context = ssl.create_default_context(
            cafile=self.ca_cert_path if self.ca_cert_path else None
        )
        if self.skip_tls_verify:
            context.check_hostname = False
            context.verify_mode = ssl.CERT_NONE
        if self.client_cert_path:
            context.load_cert_chain(self.client_cert_path, self.client_key_path)
        return context


def _materialize(data_b64: str, suffix: str) -> str:
    """Write base64 ``*-data`` kubeconfig fields to a temp file for ssl."""
    handle = tempfile.NamedTemporaryFile(
        mode="wb", suffix=suffix, delete=False, prefix="kubecfg-"
    )
    with handle:
        handle.write(b64decode(data_b64))
    return handle.name


def load_kubeconfig(path: str | Path) -> ClusterConfig:
    """Parse the current-context cluster/user from a kubeconfig file.

    Kubeconfigs are YAML; JSON is a YAML subset and kubectl accepts it too,
    so without PyYAML installed a JSON-format kubeconfig still works.
    """
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as err:
        raise KubeConfigError("Failed to configure incluster or local config") from err
    try:
        import yaml

        doc = yaml.safe_load(text)
    except ImportError:
        try:
            doc = json.loads(text)
        except ValueError as err:
            raise KubeConfigError(
                "Failed to configure incluster or local config: PyYAML is not "
                "installed and the kubeconfig is not JSON-formatted"
            ) from err
    except Exception as err:
        raise KubeConfigError("Failed to configure incluster or local config") from err
    if not isinstance(doc, dict):
        raise KubeConfigError("Failed to configure incluster or local config")

    def by_name(section: str, name: str) -> dict:
        for entry in doc.get(section, []) or []:
            if entry.get("name") == name:
                return entry.get(section.rstrip("s"), {}) or {}
        return {}

    current = doc.get("current-context", "")
    context = by_name("contexts", current)
    cluster = by_name("clusters", context.get("cluster", ""))
    user = by_name("users", context.get("user", ""))
    server = cluster.get("server")
    if not server:
        raise KubeConfigError("Failed to configure incluster or local config")

    ca_path = cluster.get("certificate-authority")
    if not ca_path and cluster.get("certificate-authority-data"):
        ca_path = _materialize(cluster["certificate-authority-data"], ".crt")
    cert_path = user.get("client-certificate")
    if not cert_path and user.get("client-certificate-data"):
        cert_path = _materialize(user["client-certificate-data"], ".crt")
    key_path = user.get("client-key")
    if not key_path and user.get("client-key-data"):
        key_path = _materialize(user["client-key-data"], ".key")

    return ClusterConfig(
        server=server.rstrip("/"),
        token=user.get("token"),
        ca_cert_path=ca_path,
        client_cert_path=cert_path,
        client_key_path=key_path,
        skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
    )


def load_incluster_config() -> ClusterConfig:
    """Service-account config, as the README deployment runs the controller."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = SERVICE_ACCOUNT_DIR / "token"
    if not host or not token_path.is_file():
        raise KubeConfigError("Failed to configure incluster or local config")
    ca_path = SERVICE_ACCOUNT_DIR / "ca.crt"
    return ClusterConfig(
        server=f"https://{host}:{port}",
        token=token_path.read_text().strip(),
        token_file=str(token_path),  # re-read per request; tokens rotate
        ca_cert_path=str(ca_path) if ca_path.is_file() else None,
    )


def load_config() -> ClusterConfig:
    """``KUBE_CONFIG_PATH`` file if set, else in-cluster (``scale/scale.go:32-33``)."""
    path = os.environ.get("KUBE_CONFIG_PATH")
    if path:
        return load_kubeconfig(path)
    return load_incluster_config()


class KubeDeploymentAPI:
    """``DeploymentAPI`` over the real apiserver REST interface."""

    def __init__(
        self,
        namespace: str,
        config: ClusterConfig | None = None,
        timeout: float = 10.0,
    ) -> None:
        # Constructor failure is fatal, like the reference's panics
        # (scale/scale.go:35,40).
        self.config = config or load_config()
        self.namespace = namespace
        self.timeout = timeout
        try:
            self._ssl_context: ssl.SSLContext | None = (
                self.config.ssl_context()
                if self.config.server.startswith("https")
                else None
            )
        except Exception as err:
            raise KubeConfigError("Failed to configure client") from err

    def _request(self, method: str, url: str, body: bytes | None = None) -> dict:
        headers = {"Accept": "application/json"}
        if body is not None:
            headers["Content-Type"] = "application/json"
        token = self.config.bearer_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        request = urllib.request.Request(url, data=body, headers=headers, method=method)
        try:
            with urllib.request.urlopen(
                request, timeout=self.timeout, context=self._ssl_context
            ) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as err:
            detail = err.read().decode("utf-8", "replace")
            message = detail[:512]
            try:  # apiserver Status objects carry the useful message
                message = json.loads(detail).get("message", message)
            except (ValueError, AttributeError):
                pass
            raise KubeApiError(
                f"{method} {url} -> HTTP {err.code}: {message}", status=err.code
            ) from err
        except urllib.error.URLError as err:
            raise KubeApiError(f"{method} {url} failed: {err.reason}") from err

    def _deployment_url(self, name: str) -> str:
        return (
            f"{self.config.server}/apis/apps/v1/namespaces/"
            f"{urllib.parse.quote(self.namespace)}/deployments/"
            f"{urllib.parse.quote(name)}"
        )

    def get(self, name: str) -> Deployment:
        return Deployment.from_raw(self._request("GET", self._deployment_url(name)))

    def update(self, deployment: Deployment) -> Deployment:
        # Full-object replace (PUT), not a patch and not the Scale
        # subresource — the reference's exact write shape (scale/scale.go:72).
        body = json.dumps(deployment.raw).encode("utf-8")
        return Deployment.from_raw(
            self._request("PUT", self._deployment_url(deployment.name), body)
        )
