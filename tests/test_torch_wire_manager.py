"""The port's controller over the wire: main.build_manager, leader election
and main() against the stub API server (runtime/stubserver.py) through the
API client (runtime/kubeclient.py).

- build_manager over KubeApiClient binds a small config_12 window, every
  pod once, to the nodes the in-memory Manager makes from the same pods and
  the same seeded draws; the JAX package's build_manager over its client
  and its stub makes the same nodes.
- Leader election over the wire, round for round as the JAX package's:
  the same verdicts, the same Lease and the same requests.
- main() in process with ``--kube-backend in-cluster`` finds an HTTPS stub
  through KUBERNETES_SERVICE_HOST / _PORT and the service account
  directory (a token and the CA), boots, and stops with rc 0.
"""

import itertools
import random
import secrets
import ssl
import threading
import time
import uuid

import pytest

from karpenter_tpu import main as jax_main
from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.config import options as jax_options
from karpenter_tpu.ops import global_solve as jax_gops
from karpenter_tpu.runtime import kubeclient as jax_client
from karpenter_tpu.runtime import kubecore as jax_kubecore
from karpenter_tpu.runtime import leaderelection as jax_le
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch import main as port_main
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.config import options as port_options
from karpenter_tpu_torch.ops import global_solve as port_gops
from karpenter_tpu_torch.runtime import kubeclient as port_client
from karpenter_tpu_torch.runtime import kubecore as port_kubecore
from karpenter_tpu_torch.runtime import leaderelection as port_le
from karpenter_tpu_torch.runtime.stubserver import StubServer
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.utils import clock as port_clock
from tests.test_torch_controller import JAX, PORT, config12_catalog, config12_window
from tests.test_torch_kubeclient import JaxStub
from tests.test_torch_main_process import free_port, wait_ready

PROVIDER = "wire-config12"


@pytest.fixture(autouse=True)
def fresh_process_state():
    def reset():
        jax_pressure.set_monitor(None)
        port_pressure.set_monitor(None)
        jax_gops.SUPPORT.reset()
        port_gops.SUPPORT.reset()
        port_solve_mod.reset_executor_counts()

    reset()
    yield
    reset()


def seeded_draws(monkeypatch, pkg):
    """uuid4, the fake provider's node names and the hostname tokens from
    fixed seeds, so two runs draw the same."""
    rng, tokens = random.Random(1), random.Random(2)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
    monkeypatch.setattr(secrets, "token_hex", lambda n=16: f"{tokens.getrandbits(8 * n):0{2 * n}x}")
    monkeypatch.setattr(pkg.fake, "_name_counter", itertools.count())


def window_nodes(pkg, backend, monkeypatch, n=120, seed=3):
    """config_12's window of ``n`` pods under the package's build_manager,
    on the in-memory store (``memory``) or over the wire (``wire``, the
    pods created through a second client): the nodes as (name, instance
    type, the shapes of the pods on it), and the binds per pod."""
    seeded_draws(monkeypatch, pkg)
    catalog, pods = config12_window(pkg, seed, n)
    pkg.spi.register(PROVIDER, lambda: pkg.fake.FakeCloudProvider(catalog=config12_catalog(pkg)))
    jax = pkg.name == "jax"
    opts_mod = jax_options if jax else port_options
    extra = {} if jax else {"device": "cpu"}
    opts = opts_mod.Options(cluster_name="c", cluster_endpoint="e", cloud_provider=PROVIDER,
                            window_backend="ffd", pressure_rss_watermark_mb=0,
                            batch_idle_seconds=1.0, batch_max_seconds=10.0, **extra)
    stub = client = writer = None
    if backend == "memory":
        store = kube = (jax_kubecore if jax else port_kubecore).KubeCore()
        writer = kube
    else:
        stub = JaxStub() if jax else StubServer()
        store = stub.core
        client_mod = jax_client if jax else port_client
        kube = client = client_mod.KubeApiClient(stub.url)
        writer = client_mod.KubeApiClient(stub.url)
    manager = (jax_main if jax else port_main).build_manager(kube, opts)
    try:
        writer.create(pkg.Provisioner(metadata=pkg.core.ObjectMeta(name="default",
                                                                   namespace="default"),
                                      spec=pkg.ProvisionerSpec()))
        for p in pods:
            writer.create(p)
        manager.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if all(store.scan("Pod", lambda p: bool(p.spec.node_name))):
                break
            time.sleep(0.1)
        # read back as the controller reads: over the wire where it runs there
        listed = writer.list("Pod")
        node_list = writer.list("Node", namespace=None)
    finally:
        manager.stop()
        for c in (client, writer):
            if c is not None and hasattr(c, "stop_watches"):
                c.stop_watches()
        if stub is not None:
            stub.stop()
    label = pkg.wellknown.LABEL_INSTANCE_TYPE
    shape = {p.metadata.name: tuple(sorted((k, str(v)) for k, v in
                                           p.spec.containers[0].resources.requests.items()))
             for p in pods}
    by_node = {}
    for p in listed:
        by_node.setdefault(p.spec.node_name, []).append(shape[p.metadata.name])
    nodes = sorted((nd.metadata.name, nd.metadata.labels[label],
                    tuple(sorted(by_node.get(nd.metadata.name, [])))) for nd in node_list)
    return nodes, {p.metadata.name: p.spec.node_name for p in listed}


def test_wire_manager_binds_as_in_memory_and_as_the_jax_package(monkeypatch):
    got_nodes, got_binds = window_nodes(PORT, "wire", monkeypatch)
    assert len(got_binds) == 120 and all(got_binds.values())
    assert {node for node in got_binds.values()} <= {name for name, _, _ in got_nodes}
    mem_nodes, mem_binds = window_nodes(PORT, "memory", monkeypatch)
    assert got_nodes == mem_nodes and got_binds == mem_binds
    jax_nodes, _ = window_nodes(JAX, "wire", monkeypatch)
    assert got_nodes == jax_nodes


# -- leader election over the wire ----------------------------------------------------

def election_rounds(le_mod, clock_mod, stub, client_mod):
    """The JAX suite's election rounds (tests/test_leader_ratelimit.py) over
    the wire: each round's verdict and the stored holder."""
    clock_mod.DEFAULT.set(3_000_000.0)
    client = client_mod.KubeApiClient(stub.url)
    out = []
    try:
        a = le_mod.LeaderElector(client, identity="a", lease_duration=15)
        b = le_mod.LeaderElector(client, identity="b", lease_duration=15)

        def rnd(who, elector):
            out.append((who, elector.try_acquire_or_renew(),
                        stub.core.get("Lease", le_mod.LEASE_NAME).spec.holder_identity))

        rnd("a", a)
        rnd("b", b)
        clock_mod.DEFAULT.advance(5)
        rnd("a", a)
        rnd("b", b)
        clock_mod.DEFAULT.advance(16)  # a stopped renewing
        rnd("b", b)
        rnd("a", a)
        b._leading = True
        b.stop()  # releases the lease
        out.append(("release", None,
                    stub.core.get("Lease", le_mod.LEASE_NAME).spec.holder_identity))
        rnd("a", a)
        out.append(("lease", type(client.get("Lease", le_mod.LEASE_NAME)).__name__, None))
    finally:
        client.stop_watches()
        clock_mod.DEFAULT.reset()
    return out


def test_leader_election_over_the_wire_as_the_jax_package():
    assert port_le.LEASE_NAME == jax_le.LEASE_NAME
    jstub, pstub = JaxStub(), StubServer(log=True)
    try:
        want = election_rounds(jax_le, jax_clock, jstub, jax_client)
        got = election_rounds(port_le, port_clock, pstub, port_client)
    finally:
        jstub.stop()
        pstub.stop()
    assert got == want
    assert [r[1] for r in got[:6]] == [True, False, True, False, True, False]
    assert got[6][2] == "" and got[7][1] is True
    assert pstub.log == jstub.log


# -- main() with --kube-backend in-cluster ---------------------------------------------

def test_main_in_cluster_boots_over_https_and_stops(tmp_path, monkeypatch):
    pytest.importorskip("cryptography")
    from karpenter_tpu_torch.webhooks import certs

    ca = certs.generate_ca("stub-apiserver-ca")
    serving = certs.generate_serving_cert(ca, ["localhost"])
    (tmp_path / "ca.crt").write_bytes(ca.cert_pem)
    (tmp_path / "token").write_text("stub-token\n")
    (tmp_path / "tls.crt").write_bytes(serving.cert_pem)
    (tmp_path / "tls.key").write_bytes(serving.key_pem)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(str(tmp_path / "tls.crt"), str(tmp_path / "tls.key"))
    stub = StubServer(ssl_context=ctx)
    host, port = stub.url.rsplit("/", 1)[1].split(":")
    monkeypatch.setattr(port_client, "SERVICE_ACCOUNT_DIR", str(tmp_path))
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", host)
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", port)
    metrics = free_port()
    terminate, result = threading.Event(), []
    before = set(threading.enumerate())
    argv = ["--cluster-name", "wire", "--cluster-endpoint", stub.url, "--cloud-provider", "fake",
            "--kube-backend", "in-cluster", "--device", "cpu", "--metrics-port", str(metrics),
            "--leader-elect", "--namespace", "karpenter"]
    t = threading.Thread(target=lambda: result.append(port_main.main(argv, terminate)))
    t.start()
    try:
        assert wait_ready(metrics, t.is_alive) == "ok level=L0"
        # the process campaigned and watches over the wire
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not (
                stub.counts["watch pods"] and stub.counts["create leases"]):
            time.sleep(0.05)
        assert stub.counts["watch pods"] >= 1 and stub.counts["create leases"] == 1
        assert stub.core.get("Lease", port_le.LEASE_NAME, "karpenter").spec.holder_identity
    finally:
        terminate.set()
        t.join(30.0)
        stub.stop()
    assert not t.is_alive() and result == [0]
    assert stub.core.get("Lease", port_le.LEASE_NAME, "karpenter").spec.holder_identity == ""
    # main() stopped its client's watches: every watch thread it started ends
    watches = [th for th in set(threading.enumerate()) - before
               if th.name.startswith("watch-")]
    for th in watches:
        th.join(5.0)
    assert not [th.name for th in watches if th.is_alive()]


# -- pods of the window in flight stay pending --------------------------------------------

def test_the_window_in_flight_keeps_its_pods_pending():
    """The port's worker answers pending() for the pods of the window it is
    provisioning, until the window ends; the JAX package's answers for
    queued pods only, so its selection requeue re-offers a window that
    outlasts the requeue interval (over the wire: solved, launched and
    bound again, each bind a 409)."""
    from karpenter_tpu.controllers import provisioning as jax_prov
    from karpenter_tpu_torch.controllers import provisioning as port_prov_mod
    from tests.test_torch_controller import quiet_monitor

    seen = {}
    for pkg, prov_mod in ((JAX, jax_prov), (PORT, port_prov_mod)):
        catalog, pods = config12_window(pkg, 5, 12)
        kube = pkg.kube.KubeCore()
        provisioner = pkg.Provisioner(
            metadata=pkg.core.ObjectMeta(name="default", namespace="default"),
            spec=pkg.ProvisionerSpec(constraints=pkg.universe(catalog)))
        kube.create(provisioner)
        batcher = pkg.batcher.Batcher(idle_seconds=0.01, max_seconds=5.0,
                                      monitor=quiet_monitor(pkg))
        extra = {"device": "cpu"} if pkg is PORT else {}
        worker = prov_mod.ProvisionerWorker(provisioner, kube,
                                            pkg.fake.FakeCloudProvider(catalog=catalog),
                                            batcher=batcher, **extra)
        keys = [(p.metadata.namespace, p.metadata.name) for p in pods]
        during = []
        real = worker._provision_group

        def probe(eng, group, real=real, worker=worker, keys=keys, during=during):
            during.append([worker.pending(k) for k in keys])
            return real(eng, group)

        worker._provision_group = probe
        try:
            for p in pods:
                kube.create(p)
                worker.add(p, key=(p.metadata.namespace, p.metadata.name))
            before = [worker.pending(k) for k in keys]
            worker.provision()
            after = [worker.pending(k) for k in keys]
        finally:
            worker.stop()
        seen[pkg.name] = (before, during[0], after)
    assert seen["port"] == ([True] * 12, [True] * 12, [False] * 12)
    assert seen["jax"] == ([True] * 12, [False] * 12, [False] * 12)


# -- a relist while binds land ------------------------------------------------------------

def test_a_paged_list_reports_its_first_page_version():
    """The stub's pages are served at different times: a bind that lands
    after its pod's page was served must reach a watch from the LIST's
    version (else an informer cache swapped to the LIST keeps the unbound
    copy, and the selection controller re-offers a bound pod)."""
    import json
    import urllib.request

    stub = StubServer()
    try:
        core = stub.core
        catalog, pods = config12_window(PORT, 3, 6)
        for p in pods:
            core.create(p)
        url = f"{stub.url}/api/v1/namespaces/default/pods?limit=2"
        with urllib.request.urlopen(url) as r:
            first = json.loads(r.read())
        version, token = first["metadata"]["resourceVersion"], first["metadata"]["continue"]
        core.bind_pod(core.get("Pod", first["items"][0]["metadata"]["name"]), "n-1")
        while token:
            with urllib.request.urlopen(f"{url}&continue={token}") as r:
                page = json.loads(r.read())
            assert page["metadata"]["resourceVersion"] == version
            token = page["metadata"].get("continue")
        q = core.watch("Pod", since_rv=int(version))
        replayed = []
        while not q.empty():
            replayed.append((q.get().obj.metadata.name))
        core.unwatch(q)
        assert first["items"][0]["metadata"]["name"] in replayed
    finally:
        stub.stop()


def relist_during_binds(pkg, monkeypatch, n=300, delay_s=0.01, page=50):
    """config_12's window of ``n`` pods under ``pkg``'s build_manager over
    the port's stub, each binding POST slowed by ``delay_s`` and a node's
    pods bound one at a time, the client's LIST pages of ``page`` pods, and
    a 410 on the Pod watch at the first binding POST (a relist while binds
    land): the pods a later batcher window took again after they were
    bound, and the binding POSTs."""
    seeded_draws(monkeypatch, pkg)
    catalog, pods = config12_window(pkg, 3, n)
    pkg.spi.register(PROVIDER, lambda: pkg.fake.FakeCloudProvider(catalog=config12_catalog(pkg)))
    jax = pkg.name == "jax"
    opts = (jax_options if jax else port_options).Options(
        cluster_name="c", cluster_endpoint="e", cloud_provider=PROVIDER, window_backend="ffd",
        pressure_rss_watermark_mb=0, batch_idle_seconds=1.0, batch_max_seconds=10.0,
        **({} if jax else {"device": "cpu"}))
    client_mod = jax_client if jax else port_client
    monkeypatch.setattr(port_client, "BIND_WORKERS", 1)
    stub = StubServer()
    handler = stub.server.RequestHandlerClass
    real_post = handler.do_POST

    def slow_post(self):
        if self.path.endswith("/binding"):
            time.sleep(delay_s)
        return real_post(self)

    monkeypatch.setattr(handler, "do_POST", slow_post)
    bound_at = {}
    real_bind = stub.core.bind_pod

    def bind_pod(pod, node):
        out = real_bind(pod, node)
        bound_at.setdefault(pod.metadata.name, time.monotonic())
        return out

    stub.core.bind_pod = bind_pod
    batcher_mod = pkg.batcher
    windows, real_wait = [], batcher_mod.Batcher.wait

    def wait(self):
        items, seconds = real_wait(self)
        if items:
            windows.append((time.monotonic(), [
                next(x for x in (i if isinstance(i, tuple) else (i,))
                     if hasattr(x, "metadata")).metadata.name for i in items]))
        return items, seconds

    monkeypatch.setattr(batcher_mod.Batcher, "wait", wait)
    kube, writer = client_mod.KubeApiClient(stub.url), client_mod.KubeApiClient(stub.url)
    kube.list_page_size = page
    manager = (jax_main if jax else port_main).build_manager(kube, opts)
    try:
        writer.create(pkg.Provisioner(metadata=pkg.core.ObjectMeta(name="default",
                                                                   namespace="default"),
                                      spec=pkg.ProvisionerSpec()))
        for p in pods:
            writer.create(p)
        manager.start()
        armed, deadline = False, time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if not armed and stub.counts.get("create pods/binding", 0):
                stub.behavior["watch_410_next"] = "Pod"
                armed = True
            if all(stub.core.scan("Pod", lambda p: bool(p.spec.node_name))):
                break
            time.sleep(0.1)
        time.sleep(6.0)  # a selection re-verify (5 s) after the last bind
    finally:
        manager.stop()
        for c in (kube, writer):
            c.stop_watches()
        stub.stop()
    again = {name for t, names in windows for name in names
             if name in bound_at and bound_at[name] < t}
    return again, stub.counts.get("create pods/binding", 0), armed


def test_a_relist_during_binds_posts_each_bind_once(monkeypatch):
    """A relist while binds land (the 410 at the first binding POST) and a
    node's pods bound one at a time, as in the card's wire phase before
    binds went 8 at once: every pod bound, each binding POST once (a
    second would be a 409)."""
    again, posts, armed = relist_during_binds(PORT, monkeypatch, n=200)
    assert armed and posts == 200
