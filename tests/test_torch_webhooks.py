"""The port's admission webhook (webhooks/) against the JAX package's.

- ``default_provisioner``, ``validate_provisioner`` and
  ``validate_constraints`` give the JAX package's verdicts and error
  strings on seeded manifests, valid and invalid.
- ``_json_patch`` and the three reviews give the JAX package's bytes.
- The server over plain HTTP, in process and as
  ``python -m karpenter_tpu_torch.webhooks.server --no-tls``.
- TLS (where ``cryptography`` is installed): CertManager's ensure,
  rotation and adopt-on-conflict on the port's KubeCore and over the wire,
  reconcile_ca_bundles, and a TLS handshake that takes a rotated serving
  certificate with no rebind.
"""

import base64
import json
import os
import random
import signal
import socket
import ssl
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from karpenter_tpu.api import codec as jax_codec
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.webhooks import admission as jax_admission
from karpenter_tpu.webhooks import server as jax_server
from karpenter_tpu_torch.api import codec as port_codec
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.runtime.kubeclient import KubeApiClient
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.runtime.stubserver import StubServer
from karpenter_tpu_torch.webhooks import admission as port_admission
from karpenter_tpu_torch.webhooks import server as port_server
from tests.test_torch_codec import MANIFEST, plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubProvider:
    """The JAX suite's provider hooks (tests/test_webhook_server.py) with
    one package's types: default adds an on-demand capacity type, validate
    wants an instanceProfile in the provider block."""

    def __init__(self, core):
        self.core = core

    def default(self, constraints):
        if constraints.requirements.capacity_types() is None:
            constraints.requirements = constraints.requirements.add(self.core.NodeSelectorRequirement(
                key="karpenter.sh/capacity-type", operator="In", values=["on-demand"]))

    def validate(self, constraints):
        if constraints.provider is not None and not constraints.provider.get("instanceProfile"):
            return "provider.instanceProfile: required"
        return None


JAX_PROVIDER, PORT_PROVIDER = StubProvider(jax_core), StubProvider(port_core)

LABEL_KEYS = ["team", "bad key!", "kubernetes.io/hostname", "node.kubernetes.io/instance-type",
              "foo.kubernetes.io/x", "kops.k8s.io/ig", "karpenter.sh/emptiness-timestamp",
              "example.com/tier", "-leading", "a" * 64]
LABEL_VALUES = ["ml", "", "bad value!", "x" * 64, "v1.2_3"]
TAINT_KEYS = ["", "dedicated", "bad key!", "example.com/gpu"]
OPERATORS = ["In", "NotIn", "Exists", "Gt"]
REQ_KEYS = ["topology.kubernetes.io/zone", "kubernetes.io/hostname",
            "karpenter.sh/capacity-type", "example.com/x"]


def seeded_manifest(seed):
    """A Provisioner manifest drawn from ``seed``; about half are valid."""
    rng = random.Random(seed)
    m = json.loads(json.dumps(MANIFEST))
    m["metadata"]["name"] = rng.choice(["default", "default", ""])
    spec = m["spec"]
    clean = rng.random() < 0.4
    spec["labels"] = {"team": "ml"} if clean else {
        rng.choice(LABEL_KEYS): rng.choice(LABEL_VALUES) for _ in range(rng.randrange(1, 4))}
    spec["taints"] = [{"key": "dedicated", "value": "ml", "effect": "NoSchedule"}] if clean else [
        {"key": rng.choice(TAINT_KEYS), "value": rng.choice(["", "ml", "bad value!"]),
         "effect": rng.choice(["NoSchedule", "NoExecute", "", "Sometimes"])}
        for _ in range(rng.randrange(0, 3))]
    if not clean:
        spec["requirements"] = [{"key": rng.choice(REQ_KEYS), "operator": rng.choice(OPERATORS),
                                 "values": ["a", "b"]} for _ in range(rng.randrange(0, 3))]
        spec["ttlSecondsAfterEmpty"] = rng.choice([None, 30, -1])
        spec["ttlSecondsUntilExpired"] = rng.choice([None, 60, -5])
        spec["provider"] = rng.choice([None, {}, {"instanceProfile": "p"}])
        for key in ("ttlSecondsAfterEmpty", "ttlSecondsUntilExpired", "provider"):
            if spec[key] is None:
                del spec[key]
    return m


SEEDS = range(24)


@pytest.mark.parametrize("seed", SEEDS)
def test_admission_verdicts_and_errors_equal_the_jax_package(seed):
    m = seeded_manifest(seed)
    jp, pp = jax_codec.provisioner_from_manifest(m), port_codec.provisioner_from_manifest(m)
    want = jax_admission.validate_provisioner(jp, JAX_PROVIDER)
    got = port_admission.validate_provisioner(pp, PORT_PROVIDER)
    assert got == want
    assert port_admission.validate_constraints(pp.spec.constraints) == \
        jax_admission.validate_constraints(jp.spec.constraints)
    jax_admission.default_provisioner(jp, JAX_PROVIDER)
    port_admission.default_provisioner(pp, PORT_PROVIDER)
    assert port_codec.provisioner_to_manifest(pp) == jax_codec.provisioner_to_manifest(jp)
    assert plain(pp) == plain(jp)


def test_the_seeds_reach_valid_and_invalid_verdicts():
    verdicts = [bool(port_admission.validate_provisioner(
        port_codec.provisioner_from_manifest(seeded_manifest(s)), PORT_PROVIDER)) for s in SEEDS]
    assert 0 < sum(verdicts) < len(verdicts)


def nested(rng, depth=0):
    return {rng.choice("abc/~"): (nested(rng, depth + 1) if depth < 2 and rng.random() < 0.4
                                   else rng.choice([1, "x", [1, 2], None]))
            for _ in range(rng.randrange(0, 4))}


@pytest.mark.parametrize("seed", range(8))
def test_json_patch_equals_the_jax_package(seed):
    rng = random.Random(seed)
    before, after = nested(rng), nested(rng)
    assert port_server._json_patch(before, after) == jax_server._json_patch(before, after)


def reviews(seed):
    m = seeded_manifest(seed)
    cm = {"metadata": {"name": "config-logging"},
          "data": random.Random(seed).choice([{"loglevel.solver": "shouty"},
                                              {"zap-logger-config": '{"level": "info"}'}])}
    return [("default", {"request": {"uid": f"u{seed}", "object": m}}),
            ("validate", {"request": {"uid": f"u{seed}", "object": m}}),
            ("config", {"request": {"uid": f"u{seed}", "object": cm}})]


@pytest.mark.parametrize("seed", range(8))
def test_reviews_give_the_jax_packages_bytes(seed):
    for which, review in reviews(seed):
        if which == "default":
            want = jax_server.default_review(review, JAX_PROVIDER)
            got = port_server.default_review(review, PORT_PROVIDER)
        elif which == "validate":
            want = jax_server.validate_review(review, JAX_PROVIDER)
            got = port_server.validate_review(review, PORT_PROVIDER)
        else:
            want = jax_server.validate_config_review(review)
            got = port_server.validate_config_review(review)
        assert json.dumps(got) == json.dumps(want)


# -- the server over plain HTTP -----------------------------------------------------

@pytest.fixture()
def servers():
    """The port's and the JAX package's servers, each on a port of its own."""
    out = []
    for mod, provider in ((port_server, PORT_PROVIDER), (jax_server, JAX_PROVIDER)):
        srv = mod.serve(port=0, cloud_provider=provider, host="127.0.0.1")
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        out.append((srv, t, f"http://127.0.0.1:{srv.server_address[1]}"))
    yield [base for _, _, base in out]
    for srv, t, _ in out:
        srv.shutdown()
        srv.server_close()
        t.join(5.0)


def post(base, path, body: bytes):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


PATHS = {"default": "/default-resource", "validate": "/validate-resource",
         "config": "/config-validation"}


def test_server_answers_as_the_jax_server(servers):
    port_base, jax_base = servers
    for seed in range(6):
        for which, review in reviews(seed):
            body = json.dumps(review).encode()
            assert post(port_base, PATHS[which], body) == post(jax_base, PATHS[which], body)
    bad_limits = json.loads(json.dumps(MANIFEST))
    bad_limits["spec"]["limits"] = {"resources": {"cpu": "not-a-quantity"}}
    for path, body in (("/default-resource", b"not json"), ("/nope", b"{}"),
                       ("/default-resource", json.dumps({"request": {
                           "uid": "uid-42", "object": bad_limits}}).encode())):
        assert post(port_base, path, body) == post(jax_base, path, body)
    status, reply = post(port_base, "/default-resource", json.dumps(
        {"request": {"uid": "uid-42", "object": bad_limits}}).encode())
    response = json.loads(reply)["response"]
    assert status == 200 and response["uid"] == "uid-42" and response["allowed"] is False
    with urllib.request.urlopen(port_base + "/healthz", timeout=10) as resp:
        assert resp.read() == b"ok"


def test_defaulting_patch_only_fills_the_spec(servers):
    port_base, _ = servers
    extended = json.loads(json.dumps(MANIFEST))
    extended["spec"]["weight"] = 10
    extended["spec"]["kubeletConfiguration"]["containerRuntime"] = "containerd"
    _, reply = post(port_base, "/default-resource", json.dumps(
        {"request": {"uid": "u", "object": extended}}).encode())
    patch = json.loads(base64.b64decode(json.loads(reply)["response"]["patch"]))
    assert patch and all(op["op"] != "remove" and op["path"].startswith("/spec") for op in patch)
    assert any("capacity-type" in json.dumps(op) for op in patch)
    assert all("weight" not in op["path"] and "containerRuntime" not in op["path"]
               for op in patch)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_module_serves_plain_http_and_stops_on_sigterm():
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.webhooks.server", "--no-tls",
         "--kube-backend", "memory", "--cloud-provider", "fake", "--port", str(port)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60.0
        body = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=2) as resp:
                    body = resp.read()
                break
            except OSError:
                time.sleep(0.1)
        assert body == b"ok"
        status, reply = post(f"http://127.0.0.1:{port}", "/validate-resource", json.dumps(
            {"request": {"uid": "u", "object": MANIFEST}}).encode())
        assert status == 200 and json.loads(reply)["response"]["allowed"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert "admission webhook stopped" in proc.stdout.read()


# -- TLS ------------------------------------------------------------------------------

@pytest.fixture()
def certs():
    pytest.importorskip("cryptography")
    from karpenter_tpu_torch.webhooks import certs

    return certs


@pytest.fixture(params=["memory", "wire"])
def store(request):
    """The CertManager's store: the port's KubeCore, or the API client on a
    stub over it."""
    if request.param == "memory":
        yield KubeCore(), KubeCore
        return
    stub = StubServer()
    client = KubeApiClient(stub.url)
    yield client, lambda: stub.core
    client.stop_watches()
    stub.stop()


def test_cert_manager_persists_and_a_second_replica_loads(certs, store):
    kube, _ = store
    m1 = certs.CertManager(kube, namespace="karpenter")
    m1.ensure()
    secret = kube.get("Secret", certs.SECRET_NAME, "karpenter")
    assert set(secret.data) == {"ca.crt", "ca.key", "tls.crt", "tls.key"}
    assert secret.type == "kubernetes.io/tls"
    m2 = certs.CertManager(kube, namespace="karpenter")
    m2.ensure()
    assert m2.serving.cert_pem == m1.serving.cert_pem and m2.ca.cert_pem == m1.ca.cert_pem


def test_near_expiry_reissues_keeping_the_ca(certs, store):
    import datetime

    kube, _ = store
    m = certs.CertManager(kube, namespace="karpenter")
    m.ensure()
    old_serving, old_ca = m.serving.cert_pem, m.ca.cert_pem
    m.serving = certs.generate_serving_cert(m.ca, m.dns_names, days=1)
    m._store()
    m2 = certs.CertManager(kube, namespace="karpenter")
    m2.ensure()
    assert m2.ca.cert_pem == old_ca and m2.serving.cert_pem != old_serving
    assert (certs.cert_not_after(m2.serving.cert_pem)
            - datetime.datetime.now(datetime.timezone.utc)) > m2.rotation_margin


def test_bootstrap_race_adopts_the_winner(certs, store):
    kube, _ = store
    winner = certs.CertManager(kube, namespace="karpenter")
    loser = certs.CertManager(kube, namespace="karpenter")
    winner.ensure()
    loser.ca = certs.generate_ca()
    loser.serving = certs.generate_serving_cert(loser.ca, loser.dns_names)
    assert loser._store(adopt_on_conflict=True) is False
    assert loser.ca.cert_pem == winner.ca.cert_pem
    assert loser.serving.cert_pem == winner.serving.cert_pem
    stored = kube.get("Secret", certs.SECRET_NAME, "karpenter")
    assert base64.b64decode(stored.data["ca.crt"]) == winner.ca.cert_pem


def test_reconcile_ca_bundles_stamps_live_configurations(certs):
    name = certs.DEFAULTING_WEBHOOK_NAME
    store = {certs.MUTATING_PATH + name: {
        "metadata": {"name": name},
        "webhooks": [{"name": name, "clientConfig": {"service": {"name": "w"}}}]}}
    puts = []

    class RawClient:
        def get_raw(self, path):
            if path not in store:
                raise NotFound(path)
            return json.loads(json.dumps(store[path]))

        def put_raw(self, path, body):
            puts.append(path)
            store[path] = body
            return body

    ca = certs.generate_ca()
    assert certs.reconcile_ca_bundles(RawClient(), ca.cert_pem) == 1  # validating not applied
    hook = store[certs.MUTATING_PATH + name]["webhooks"][0]
    assert base64.b64decode(hook["clientConfig"]["caBundle"]) == ca.cert_pem
    puts.clear()
    assert certs.reconcile_ca_bundles(RawClient(), ca.cert_pem) == 1 and puts == []
    manifest = {"webhooks": [{"name": "a", "clientConfig": {}}, {"name": "b"}]}
    for hook in certs.inject_ca_bundle(manifest, ca.cert_pem)["webhooks"]:
        assert base64.b64decode(hook["clientConfig"]["caBundle"]) == ca.cert_pem


def verify_context(ca_pem: bytes) -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    with tempfile.NamedTemporaryFile(suffix=".crt") as f:
        f.write(ca_pem)
        f.flush()
        ctx.load_verify_locations(f.name)
    return ctx


def peer_serial(port: int, ca_pem: bytes) -> int:
    from cryptography import x509

    with socket.create_connection(("localhost", port), timeout=10) as sock:
        with verify_context(ca_pem).wrap_socket(sock, server_hostname="localhost") as tls:
            der = tls.getpeercert(binary_form=True)
    return x509.load_der_x509_certificate(der).serial_number


def test_tls_handshake_survives_rotation_without_a_rebind(certs):
    kube = KubeCore()
    manager = certs.CertManager(kube, namespace="karpenter", dns_names=["localhost"])
    manager.ensure()
    server = port_server.serve(port=0, cloud_provider=PORT_PROVIDER, cert_manager=manager,
                               host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = server.socket.getsockname()[1]
    stop = threading.Event()
    try:
        review = json.dumps({"request": {"uid": "u-1", "object": MANIFEST}}).encode()
        req = urllib.request.Request(f"https://localhost:{port}/validate-resource", data=review)
        with urllib.request.urlopen(req, context=verify_context(manager.ca.cert_pem),
                                    timeout=10) as resp:
            assert json.loads(resp.read())["response"]["allowed"] is True
        with pytest.raises(Exception, match="(?i)certificate"):
            urllib.request.urlopen(req, context=verify_context(certs.generate_ca(
                "imposter").cert_pem), timeout=10)
        before = peer_serial(port, manager.ca.cert_pem)
        assert manager.rotate_if_needed() is False  # outside the margin
        manager.serving = certs.generate_serving_cert(manager.ca, manager.dns_names, days=1)
        manager._store()
        manager._reload_ctx()
        # the rotation thread finds the short-lived certificate and re-issues
        rotation = certs.start_rotation_thread(manager, interval_s=0.05, stop=stop)
        deadline = time.monotonic() + 10.0
        short = manager.serving.cert_pem
        while time.monotonic() < deadline and manager.serving.cert_pem == short:
            time.sleep(0.05)
        stop.set()
        rotation.join(5.0)
        after = peer_serial(port, manager.ca.cert_pem)
        assert after not in (before, None) and manager.serving.cert_pem != short
        stored = kube.get("Secret", certs.SECRET_NAME, "karpenter")
        assert base64.b64decode(stored.data["tls.crt"]) == manager.serving.cert_pem
        with urllib.request.urlopen(req, context=verify_context(manager.ca.cert_pem),
                                    timeout=10) as resp:
            assert json.loads(resp.read())["response"]["uid"] == "u-1"
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
        t.join(5.0)
