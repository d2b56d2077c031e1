"""Admission webhook server: the reference's second binary.

A copy of the JAX package's module. Reference: cmd/webhook/main.go,
knative's sharedmain serving ``/default-resource`` (defaulting) and
``/validate-resource`` (validating) admission webhooks for the Provisioner
CRD, ``/config-validation`` for the config-logging ConfigMap, and a health
endpoint. Here: a stdlib ThreadingHTTPServer speaking the
``admission.k8s.io/v1`` AdmissionReview protocol. Defaulting answers with a
base64 JSONPatch, validation with allowed or denied and a message. Cloud
providers hook in through spi.CloudProvider.default/validate.

Run: ``python -m karpenter_tpu_torch.webhooks.server [--port 8443]``. TLS is
on by default: a Secret-backed CA and serving certificate with rotation
(webhooks/certs.py); the API server only calls HTTPS webhooks.
``--no-tls`` keeps plain HTTP (tests, or behind a TLS-terminating proxy).
``--cloud-provider fake`` resolves the port's fake provider; another name
goes through ``main.build_cloud_provider``. The process needs no card.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.api.codec import provisioner_from_manifest, provisioner_to_manifest
from karpenter_tpu_torch.cloudprovider.spi import CloudProvider
from karpenter_tpu_torch.controllers.logging_config import validate_config
from karpenter_tpu_torch.webhooks.admission import default_provisioner, validate_provisioner

log = logging.getLogger("karpenter.webhook")


def _json_patch(before: Dict[str, Any], after: Dict[str, Any],
                path: str = "") -> List[Dict[str, Any]]:
    """Minimal RFC-6902 diff (add/replace/remove) over nested dicts — enough
    for defaulting patches, which only fill in missing spec fields."""
    ops: List[Dict[str, Any]] = []
    for key in before:
        if key not in after:
            escaped = key.replace("~", "~0").replace("/", "~1")
            ops.append({"op": "remove", "path": f"{path}/{escaped}"})
    for key, value in after.items():
        here = f"{path}/{key.replace('~', '~0').replace('/', '~1')}"
        if key not in before:
            ops.append({"op": "add", "path": here, "value": value})
        elif isinstance(value, dict) and isinstance(before[key], dict):
            ops.extend(_json_patch(before[key], value, here))
        elif before[key] != value:
            ops.append({"op": "replace", "path": here, "value": value})
    return ops


def default_review(review: Dict[str, Any],
                   cloud_provider: Optional[CloudProvider] = None) -> Dict[str, Any]:
    """Handle a /default-resource AdmissionReview: decode, apply defaults,
    respond with a JSONPatch from the original to the defaulted object."""
    request = review.get("request") or {}
    obj = request.get("object") or {}
    provisioner = provisioner_from_manifest(obj)
    default_provisioner(provisioner, cloud_provider)
    defaulted = provisioner_to_manifest(provisioner)
    # defaulting only ever FILLS fields: keep add/replace under /spec and
    # drop every remove — the codec round-trip is lossy for fields it does
    # not model (status, unknown vendor keys), and those must survive
    patch = [op for op in _json_patch(obj, defaulted)
             if op["path"].startswith("/spec") and op["op"] != "remove"]
    response: Dict[str, Any] = {"uid": request.get("uid", ""), "allowed": True}
    if patch:
        response["patchType"] = "JSONPatch"
        response["patch"] = base64.b64encode(
            json.dumps(patch).encode()).decode()
    return _review_reply(response)


def validate_review(review: Dict[str, Any],
                    cloud_provider: Optional[CloudProvider] = None) -> Dict[str, Any]:
    """Handle a /validate-resource AdmissionReview."""
    request = review.get("request") or {}
    provisioner = provisioner_from_manifest(request.get("object") or {})
    errs = validate_provisioner(provisioner, cloud_provider)
    response: Dict[str, Any] = {"uid": request.get("uid", ""),
                                "allowed": not errs}
    if errs:
        response["status"] = {"code": 400, "message": "; ".join(errs)}
    return _review_reply(response)


def validate_config_review(review: Dict[str, Any]) -> Dict[str, Any]:
    """Handle /config-validation: the config-logging ConfigMap gate
    (cmd/webhook/main.go:84-92)."""
    request = review.get("request") or {}
    obj = request.get("object") or {}
    err = validate_config(dict(obj.get("data") or {}))
    response: Dict[str, Any] = {"uid": request.get("uid", ""),
                                "allowed": err is None}
    if err is not None:
        response["status"] = {"code": 400, "message": err}
    return _review_reply(response)


def _review_reply(response: Dict[str, Any]) -> Dict[str, Any]:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": response}


class AdmissionHandler(BaseHTTPRequestHandler):
    cloud_provider: Optional[CloudProvider] = None

    def log_message(self, fmt, *args):  # route through our logger
        log.debug(fmt, *args)

    def do_GET(self):
        if self.path in ("/healthz", "/readyz"):
            self._reply(200, b"ok", "text/plain")
        else:
            self._reply(404, b"not found", "text/plain")

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        uid = ""
        try:
            review = json.loads(self.rfile.read(length) or b"{}")
            uid = (review.get("request") or {}).get("uid", "")
            if self.path == "/default-resource":
                reply = default_review(review, self.cloud_provider)
            elif self.path == "/validate-resource":
                reply = validate_review(review, self.cloud_provider)
            elif self.path == "/config-validation":
                reply = validate_config_review(review)
            else:
                self._reply(404, b"not found", "text/plain")
                return
        except Exception as e:  # malformed review must not kill the server
            log.exception("admission request failed")
            # echo the request uid — the API server discards uid-mismatched
            # responses, which would swallow the error message
            reply = _review_reply({
                "uid": uid, "allowed": False,
                "status": {"code": 400, "message": f"bad request: {e}"}})
        self._reply(200, json.dumps(reply).encode(), "application/json")

    def _reply(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve(port: int = 8443,
          cloud_provider: Optional[CloudProvider] = None,
          cert_manager=None,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """With a ``certs.CertManager``, the socket serves HTTPS off the
    manager's live SSLContext — serving-cert rotation applies to new
    handshakes without restarting or rebinding."""
    handler = type("BoundAdmissionHandler", (AdmissionHandler,),
                   {"cloud_provider": cloud_provider})
    server = ThreadingHTTPServer((host, port), handler)
    if cert_manager is not None:
        server.socket = cert_manager.ssl_context().wrap_socket(
            server.socket, server_side=True)
        log.info("admission webhook listening on :%d (TLS)", server.server_address[1])
    else:
        log.info("admission webhook listening on :%d (plain HTTP)", server.server_address[1])
    return server


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The server's flags (``main``'s): port, TLS, namespace, kube backend
    and cloud provider."""
    parser = argparse.ArgumentParser(description="karpenter-tpu admission webhook")
    parser.add_argument("--port", type=int, default=8443)
    parser.add_argument("--tls", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--namespace",
                        default=os.environ.get("POD_NAMESPACE", "karpenter"))
    parser.add_argument("--kube-backend", choices=["in-cluster", "memory"],
                        default="in-cluster")
    # provider Default/Validate hooks run in the webhook exactly as the
    # registry wires them in the reference (v1alpha5/register.go:27-29)
    parser.add_argument("--cloud-provider", default="")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """Serve until SIGTERM (or Ctrl-C); returns 0."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cloud_provider = None
    if args.cloud_provider:
        from karpenter_tpu_torch.cloudprovider import spi

        if args.cloud_provider == "fake":
            import karpenter_tpu_torch.cloudprovider.fake.provider  # noqa: F401
            cloud_provider = spi.resolve("fake")
        else:
            from karpenter_tpu_torch.config.options import Options
            from karpenter_tpu_torch.main import build_cloud_provider

            cloud_provider = build_cloud_provider(
                Options(cloud_provider=args.cloud_provider))
    cert_manager = None
    rotation = None
    if args.tls:
        from karpenter_tpu_torch.webhooks import certs

        if args.kube_backend == "in-cluster":
            from karpenter_tpu_torch.runtime.kubeclient import KubeApiClient

            kube = KubeApiClient.in_cluster()
        else:
            from karpenter_tpu_torch.runtime.kubecore import KubeCore

            kube = KubeCore()
        cert_manager = certs.CertManager(kube, namespace=args.namespace)
        cert_manager.ensure()
        rotation = certs.start_rotation_thread(cert_manager)
        if hasattr(kube, "get_raw"):
            # stamp our CA into the live webhook configurations so the API
            # server trusts this endpoint (stable across serving-cert
            # rotations — the CA outlives them by design)
            try:
                n = certs.reconcile_ca_bundles(kube, cert_manager.ca.cert_pem)
                log.info("caBundle stamped into %d webhook configuration(s)", n)
            except Exception:  # noqa: BLE001 — apply may come later
                log.exception("caBundle reconcile failed; will serve anyway")
    server = serve(args.port, cloud_provider=cloud_provider,
                   cert_manager=cert_manager)
    # SIGTERM (how Kubernetes stops the pod) shuts the server down from a
    # thread of its own: shutdown() waits for serve_forever() to return
    try:
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=server.shutdown, daemon=True).start())
    except ValueError:  # not the main thread
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if rotation is not None:
            rotation.stop_event.set()
    log.info("admission webhook stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
