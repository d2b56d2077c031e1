"""Webhook TLS: a self-signed CA and a serving certificate with rotation.

A copy of the JAX package's module. Reference: cmd/webhook/main.go:49,57,
knative's certificates controller, which generates a CA and a serving
certificate, keeps them in a Secret, rotates them before expiry and
injects the caBundle into the webhook configurations so the API server
trusts the endpoint. The same lifecycle here:

- ``generate_ca`` / ``generate_serving_cert``: X.509 through the
  ``cryptography`` package, imported only when a certificate is made or
  read (a CA with the certSign usage; a serving certificate with the
  service DNS names the API server dials);
- ``CertManager``: Secret-backed ``ensure`` / ``rotate_if_needed``.
  ``ensure()`` loads a valid stored pair (so replicas share one identity)
  or mints and stores a new one, adopting another replica's pair when it
  loses the create race; ``rotate_if_needed()`` re-issues the serving
  certificate inside the rotation margin and reloads it into the live
  ``SSLContext``, so new handshakes take it with no rebind;
- ``inject_ca_bundle`` / ``reconcile_ca_bundles``: stamp the base64 CA into
  every ``clientConfig.caBundle`` of the (Validating|Mutating)
  WebhookConfigurations, through the API client's raw paths;
- ``start_rotation_thread``: the hourly rotation check.

The store is either the port's KubeCore or its API client.
"""

from __future__ import annotations

import base64
import datetime
import json
import logging
import ssl
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.api.core import ObjectMeta, Secret
from karpenter_tpu_torch.runtime.kubecore import AlreadyExists, NotFound

log = logging.getLogger("karpenter.webhook.certs")

SECRET_NAME = "karpenter-webhook-cert"
CA_CERT_KEY = "ca.crt"
CA_KEY_KEY = "ca.key"
SERVING_CERT_KEY = "tls.crt"
SERVING_KEY_KEY = "tls.key"

CA_LIFETIME_DAYS = 3650
SERVING_LIFETIME_DAYS = 30
ROTATION_MARGIN_DAYS = 7


@dataclass
class CertPair:
    cert_pem: bytes
    key_pem: bytes


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.generate_private_key(ec.SECP256R1())


def _key_pem(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())


def generate_ca(common_name: str = "karpenter-webhook-ca",
                days: int = CA_LIFETIME_DAYS) -> CertPair:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import NameOID

    key = _new_key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .add_extension(x509.KeyUsage(
            digital_signature=True, key_cert_sign=True, crl_sign=True,
            content_commitment=False, key_encipherment=False,
            data_encipherment=False, key_agreement=False,
            encipher_only=False, decipher_only=False), critical=True)
        .sign(key, hashes.SHA256())
    )
    from cryptography.hazmat.primitives import serialization

    return CertPair(cert.public_bytes(serialization.Encoding.PEM),
                    _key_pem(key))


def generate_serving_cert(ca: CertPair, dns_names: List[str],
                          days: int = SERVING_LIFETIME_DAYS) -> CertPair:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    ca_cert = x509.load_pem_x509_certificate(ca.cert_pem)
    ca_key = serialization.load_pem_private_key(ca.key_pem, password=None)
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(
            [x509.DNSName(n) for n in dns_names]), critical=False)
        .add_extension(x509.ExtendedKeyUsage(
            [ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return CertPair(cert.public_bytes(serialization.Encoding.PEM),
                    _key_pem(key))


def cert_not_after(cert_pem: bytes) -> datetime.datetime:
    from cryptography import x509

    return x509.load_pem_x509_certificate(cert_pem).not_valid_after_utc


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class CertManager:
    """Secret-backed CA + serving-cert lifecycle with live reload.

    One SSLContext is created per manager; rotation calls
    ``load_cert_chain`` on it again, which affects NEW handshakes only —
    in-flight connections finish on the old cert. The CA outlives serving
    certs by design (10 y vs 30 d), so the caBundle stays stable across
    serving-cert rotations.
    """

    def __init__(
        self,
        kube,
        namespace: str = "karpenter",
        secret_name: str = SECRET_NAME,
        dns_names: Optional[List[str]] = None,
        rotation_margin_days: float = ROTATION_MARGIN_DAYS,
    ):
        self.kube = kube
        self.namespace = namespace
        self.secret_name = secret_name
        self.dns_names = dns_names or [
            "karpenter-webhook", f"karpenter-webhook.{namespace}",
            f"karpenter-webhook.{namespace}.svc",
            f"karpenter-webhook.{namespace}.svc.cluster.local"]
        self.rotation_margin = datetime.timedelta(days=rotation_margin_days)
        self.ca: Optional[CertPair] = None
        self.serving: Optional[CertPair] = None
        self._ctx: Optional[ssl.SSLContext] = None
        self._lock = threading.Lock()

    # -- persistence ------------------------------------------------------
    def _load(self) -> Optional[Tuple[CertPair, CertPair]]:
        try:
            secret = self.kube.get("Secret", self.secret_name, self.namespace)
        except NotFound:
            return None
        data: Dict[str, str] = secret.data
        try:
            ca = CertPair(_unb64(data[CA_CERT_KEY]), _unb64(data[CA_KEY_KEY]))
            serving = CertPair(_unb64(data[SERVING_CERT_KEY]),
                               _unb64(data[SERVING_KEY_KEY]))
        except (KeyError, ValueError):
            return None
        return ca, serving

    def _store(self, adopt_on_conflict: bool = False) -> bool:
        """Persist our pair; returns True when OUR pair is the stored one.

        With ``adopt_on_conflict`` (bootstrap), losing the create race
        means another replica already minted an identity — ADOPT its pair
        instead of clobbering it: two replicas stamping different CAs
        would make API-server calls fail TLS on whichever lost the last
        write. Rotation (existing Secret, same CA) overwrites in place."""
        data = {
            CA_CERT_KEY: _b64(self.ca.cert_pem),
            CA_KEY_KEY: _b64(self.ca.key_pem),
            SERVING_CERT_KEY: _b64(self.serving.cert_pem),
            SERVING_KEY_KEY: _b64(self.serving.key_pem),
        }
        secret = Secret(metadata=ObjectMeta(name=self.secret_name,
                                            namespace=self.namespace),
                        data=data, type="kubernetes.io/tls")
        try:
            self.kube.create(secret)
            return True
        except AlreadyExists:
            pass
        if adopt_on_conflict:
            loaded = self._load()
            if loaded is not None:
                self.ca, self.serving = loaded
                return False
            # Secret exists but is malformed — ours is the repair
        def put(obj):
            obj.data = data

        self.kube.patch("Secret", self.secret_name, self.namespace, put)
        return True

    # -- lifecycle --------------------------------------------------------
    def ensure(self) -> None:
        """Load a valid shared pair or mint + persist a fresh one."""
        with self._lock:
            loaded = self._load()
            if loaded is not None:
                ca, serving = loaded
                if (cert_not_after(serving.cert_pem)
                        - datetime.datetime.now(datetime.timezone.utc)
                        > self.rotation_margin):
                    self.ca, self.serving = ca, serving
                    self._reload_ctx()
                    return
                self.ca = ca  # serving cert near expiry: keep CA, re-issue
            if self.ca is None:
                self.ca = generate_ca()
            self.serving = generate_serving_cert(self.ca, self.dns_names)
            # adopt-on-conflict ONLY on fresh bootstrap (nothing loaded):
            # losing that race means another replica minted the identity.
            # The near-expiry re-issue path has a Secret to overwrite — an
            # adopt there would reinstate the expiring pair it just replaced.
            stored_ours = self._store(adopt_on_conflict=loaded is None)
            self._reload_ctx()
            if stored_ours:
                log.info("webhook serving cert issued (expires %s)",
                         cert_not_after(self.serving.cert_pem).isoformat())
            else:
                log.info("adopted webhook cert minted by another replica")

    def rotate_if_needed(self) -> bool:
        """Re-issue the serving cert when inside the rotation margin; the
        live SSLContext picks it up for all subsequent handshakes."""
        with self._lock:
            remaining = (cert_not_after(self.serving.cert_pem)
                         - datetime.datetime.now(datetime.timezone.utc))
            if remaining > self.rotation_margin:
                return False
            self.serving = generate_serving_cert(self.ca, self.dns_names)
            self._store()
            self._reload_ctx()
            log.info("webhook serving cert rotated (expires %s)",
                     cert_not_after(self.serving.cert_pem).isoformat())
            return True

    # -- TLS plumbing -----------------------------------------------------
    def _reload_ctx(self) -> None:
        if self._ctx is None:
            self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        # load_cert_chain wants files; write to a private tmpdir
        with tempfile.TemporaryDirectory(prefix="kt-webhook-cert-") as d:
            cert_path, key_path = f"{d}/tls.crt", f"{d}/tls.key"
            with open(cert_path, "wb") as f:
                f.write(self.serving.cert_pem)
            with open(key_path, "wb") as f:
                f.write(self.serving.key_pem)
            self._ctx.load_cert_chain(cert_path, key_path)

    def ssl_context(self) -> ssl.SSLContext:
        if self._ctx is None:
            self.ensure()
        return self._ctx

    def ca_bundle_b64(self) -> str:
        if self.ca is None:
            self.ensure()
        return _b64(self.ca.cert_pem)


def inject_ca_bundle(manifest: Dict, ca_pem: bytes) -> Dict:
    """Stamp caBundle into every webhook clientConfig of a
    (Validating|Mutating)WebhookConfiguration manifest dict."""
    for hook in manifest.get("webhooks") or []:
        hook.setdefault("clientConfig", {})["caBundle"] = _b64(ca_pem)
    return manifest


MUTATING_PATH = ("/apis/admissionregistration.k8s.io/v1/"
                 "mutatingwebhookconfigurations/")
VALIDATING_PATH = ("/apis/admissionregistration.k8s.io/v1/"
                   "validatingwebhookconfigurations/")
DEFAULTING_WEBHOOK_NAME = "defaulting.webhook.karpenter.sh"
VALIDATION_WEBHOOK_NAME = "validation.webhook.karpenter.sh"
CONFIG_WEBHOOK_NAME = "config-validation.webhook.karpenter.sh"


def reconcile_ca_bundles(
    client,
    ca_pem: bytes,
    mutating: Tuple[str, ...] = (DEFAULTING_WEBHOOK_NAME,),
    validating: Tuple[str, ...] = (VALIDATION_WEBHOOK_NAME,
                                   CONFIG_WEBHOOK_NAME),
) -> int:
    """Patch the live (Mutating|Validating)WebhookConfiguration objects so
    the API server trusts this webhook's CA — the knative certificates
    controller does exactly this at startup and on CA change. Missing
    configurations are skipped (not yet applied); returns how many were
    stamped."""
    stamped = 0
    for base, names in ((MUTATING_PATH, mutating), (VALIDATING_PATH, validating)):
        for name in names:
            try:
                raw = client.get_raw(base + name)
            except NotFound:
                log.warning("webhook configuration %s not found; skipping", name)
                continue
            before = json.dumps(raw.get("webhooks") or [], sort_keys=True)
            inject_ca_bundle(raw, ca_pem)
            if json.dumps(raw.get("webhooks") or [], sort_keys=True) != before:
                client.put_raw(base + name, raw)
            stamped += 1
    return stamped


def start_rotation_thread(manager: CertManager, interval_s: float = 3600.0,
                          stop: Optional[threading.Event] = None) -> threading.Thread:
    stop = stop or threading.Event()

    def loop():
        while not stop.wait(interval_s):
            try:
                manager.rotate_if_needed()
            except Exception:  # noqa: BLE001 — rotation must never die
                log.exception("cert rotation check failed")

    t = threading.Thread(target=loop, daemon=True, name="cert-rotation")
    t.start()
    t.stop_event = stop  # type: ignore[attr-defined]
    return t
