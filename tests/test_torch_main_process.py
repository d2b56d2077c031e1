"""The port's controller process (karpenter_tpu_torch/main.py) on the CPU.

- ``python -m karpenter_tpu_torch.main --device cpu`` serves /healthz,
  /readyz, /metrics and /debug/vars, answers 404 otherwise and exits 0 on
  SIGTERM; the flag sets tests/test_main_process.py omits exit 1.
- main() in process, from a thread (no signal handler there): recovery runs
  before the Manager starts, the Lease is released at exit, lost
  leadership exits 1, a failed warm-up fails the boot.
- build_manager registers the JAX package's eleven controllers with the
  same worker counts, and its window binds what the JAX package's
  build_manager binds, on the same pods and the same seeded draws.
- /readyz answers 503 while recovering, at L3 and on SLO burn, with the JAX
  package's bodies.
"""

import itertools
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

from karpenter_tpu import main as jax_main
from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.config import options as jax_options
from karpenter_tpu.obs import slo as jax_slo
from karpenter_tpu.ops import global_solve as jax_gops
from karpenter_tpu.runtime import kubecore as jax_kubecore
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu_torch import main as port_main
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.config import options as port_options
from karpenter_tpu_torch.obs import slo as port_slo
from karpenter_tpu_torch.ops import global_solve as port_gops
from karpenter_tpu_torch.runtime import kubecore as port_kubecore
from karpenter_tpu_torch.runtime.leaderelection import LEASE_NAME
from karpenter_tpu_torch.solver import solve as port_solve_mod
from tests.test_torch_controller import JAX, PORT, SHAPES, affinity_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--cluster-name", "smoke", "--cluster-endpoint", "http://localhost:6443",
        "--cloud-provider", "fake", "--kube-backend", "memory"]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def get(port, path, timeout=2.0):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:  # 4xx/5xx carry a status too
        return e.code, e.read().decode()


def wait_ready(port, alive, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if not alive():
            return None
        try:
            status, body = get(port, "/readyz")
            if status == 200:
                return body
        except OSError:
            pass
        time.sleep(0.1)
    return None


@pytest.fixture(autouse=True)
def fresh_process_state(monkeypatch):
    """build_manager installs process-wide pressure monitors: both are
    dropped after each test, with the supports and the executor counts."""
    def reset():
        jax_pressure.set_monitor(None)
        port_pressure.set_monitor(None)
        jax_gops.SUPPORT.reset()
        port_gops.SUPPORT.reset()
        port_solve_mod.reset_executor_counts()

    reset()
    monkeypatch.setattr(jax_solve_mod, "_WATCHDOG", jax_solve_mod._DeviceWatchdog())
    yield
    reset()


class TestSubprocess:
    def test_serves_and_exits_zero_on_sigterm(self, tmp_path):
        port = free_port()
        # one intra-op thread: the warm-up's CPU ops would otherwise spin a
        # full torch pool against the other test workers, past the deadline
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.main", *BASE, "--device", "cpu",
             "--metrics-port", str(port), "--leader-elect", "--solver-warmup",
             "--journal-dir", str(tmp_path / "journal")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # drain continuously: a chatty process filling the pipe buffer would
        # block in write() and deadlock the shutdown
        captured: list = []
        drainer = threading.Thread(target=lambda: captured.extend(proc.stdout), daemon=True)
        drainer.start()
        try:
            body = wait_ready(port, lambda: proc.poll() is None)
            assert body is not None, f"/readyz never answered:\n{''.join(captured)[-3000:]}"
            assert body == "ok level=L0"
            assert get(port, "/healthz") == (200, "ok level=L0")
            # the GC's first sweep lists the provider's instances once the
            # manager has started (on a worker thread: poll for it)
            series = 'karpenter_cloudprovider_duration_seconds_count{method="ListInstances"'
            deadline = time.monotonic() + 20.0
            while True:
                status, metrics = get(port, "/metrics")
                assert status == 200
                if series in metrics or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            assert series in metrics
            status, text = get(port, "/debug/vars")
            assert status == 200
            assert set(json.loads(text)) == {"metrics", "pressure", "solver", "ring",
                                             "trace", "flight", "slo"}
            assert get(port, "/nope")[0] == 404
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30.0) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10.0)
        drainer.join(5.0)
        log = "".join(captured)
        assert log.index("journal recovery") < log.index("karpenter-tpu started")
        assert "became leader" in log and "solver warmup" in log

    @pytest.mark.parametrize("argv,said", [
        (["--cloud-provider", "fake", "--kube-backend", "memory"], "invalid options"),
        # in-cluster without KUBERNETES_SERVICE_HOST fails the boot, as the
        # JAX package's does; it never falls back to the in-memory store
        ([*BASE, "--kube-backend", "in-cluster"], "boot failed: no in-cluster API server"),
        # the AWS provider validates; with no region and no instance
        # metadata service (a closed local port) building its clients fails
        # the boot with the JAX main's rc and exception
        ([*BASE, "--cloud-provider", "aws"], "ConnectionRefusedError"),
    ])
    def test_bad_options_exit_one(self, argv, said):
        drop = {"KUBERNETES_SERVICE_HOST", "AWS_REGION", "AWS_DEFAULT_REGION"}
        env = {k: v for k, v in os.environ.items() if k not in drop}
        env.update(PYTHONPATH=REPO,
                   AWS_EC2_METADATA_SERVICE_ENDPOINT=f"http://127.0.0.1:{free_port()}")

        def run(package):
            return subprocess.run([sys.executable, "-m", f"{package}.main", *argv],
                                  cwd=REPO, env=env, capture_output=True, text=True,
                                  timeout=60)

        proc = run("karpenter_tpu_torch")
        assert proc.returncode == 1
        assert said in proc.stderr
        if "aws" in argv:
            ref = run("karpenter_tpu")
            assert ref.returncode == proc.returncode
            assert ref.stderr.strip().splitlines()[-1] in proc.stderr


def run_main(argv, monkeypatch, kube=None):
    """main() on a thread of its own; returns (thread, terminate, result)."""
    kube = kube or port_kubecore.KubeCore()
    monkeypatch.setattr(port_main, "KubeCore", lambda: kube)
    terminate, result = threading.Event(), []
    t = threading.Thread(target=lambda: result.append(port_main.main(argv, terminate)))
    t.start()
    return t, terminate, result, kube


class TestInProcess:
    def test_recovery_before_start_and_lease_released(self, tmp_path, monkeypatch):
        order = []
        real_run = port_main.RecoveryController.run
        real_start = port_main.Manager.start
        monkeypatch.setattr(port_main.RecoveryController, "run",
                            lambda self: order.append("recovery") or real_run(self))
        monkeypatch.setattr(port_main.Manager, "start",
                            lambda self: order.append("start") or real_start(self))
        port = free_port()
        before = set(threading.enumerate())
        t, terminate, result, kube = run_main(
            [*BASE, "--device", "cpu", "--metrics-port", str(port), "--leader-elect",
             "--journal-dir", str(tmp_path)], monkeypatch)
        try:
            assert wait_ready(port, t.is_alive) == "ok level=L0"
            assert order == ["recovery", "start"]
            assert kube.get("Lease", LEASE_NAME).spec.holder_identity != ""
        finally:
            terminate.set()
            t.join(30.0)
        assert not t.is_alive() and result == [0]
        assert kube.get("Lease", LEASE_NAME).spec.holder_identity == ""
        # every thread main() started has ended but the daemon that waits on
        # `terminate` and the HTTP server's request threads
        alive = [th.name for th in set(threading.enumerate()) - before
                 if th.name.startswith(("pump-", "work-", "map-", "provisioner",
                                        "leader-election", "eviction-queue"))]
        assert alive == []

    def test_lost_leadership_exits_one(self, monkeypatch):
        class Flaky:
            def __init__(self, kube, identity, namespace, on_stopped_leading):
                self.on_stopped_leading = on_stopped_leading

            def start(self):
                threading.Timer(0.3, self.on_stopped_leading).start()

            def wait_for_leadership(self, interrupt=None):
                return True

            def stop(self):
                pass

        monkeypatch.setattr(port_main, "LeaderElector", Flaky)
        t, terminate, result, _ = run_main(
            [*BASE, "--device", "cpu", "--metrics-port", str(free_port()), "--leader-elect"],
            monkeypatch)
        t.join(30.0)
        assert result == [1]

    def test_a_failed_warmup_fails_the_boot(self, monkeypatch):
        def boom(*a, **kw):
            raise RuntimeError("no card (injected)")

        monkeypatch.setattr(port_main.solver_warmup, "warmup_pass", boom)
        opts = port_options.Options(cluster_name="c", cluster_endpoint="e", device="cpu",
                                    solver_warmup=True)
        with pytest.raises(RuntimeError, match="injected"):
            port_main.build_manager(port_kubecore.KubeCore(), opts)
        t, _, result, _ = run_main([*BASE, "--device", "cpu", "--solver-warmup",
                                    "--metrics-port", str(free_port())], monkeypatch)
        t.join(30.0)
        assert result == [1]


def test_build_manager_registers_the_jax_packages_controllers():
    jopts = jax_options.Options(cluster_name="c", cluster_endpoint="e",
                                pressure_rss_watermark_mb=0)
    popts = port_options.Options(cluster_name="c", cluster_endpoint="e", device="cpu",
                                 pressure_rss_watermark_mb=0)
    jm = jax_main.build_manager(jax_kubecore.KubeCore(), jopts)
    pm = port_main.build_manager(port_kubecore.KubeCore(), popts)
    want = [(type(c).__name__, w) for c, w in jm._controllers]
    got = [(type(c).__name__, w) for c, w in pm._controllers]
    assert got == want and len(got) == 11
    assert [c.kind() for c, _ in pm._controllers] == [c.kind() for c, _ in jm._controllers]
    assert pm.journal is None and pm.recovery is None
    gc_off = port_main.build_manager(port_kubecore.KubeCore(), port_options.Options(
        cluster_name="c", cluster_endpoint="e", device="cpu", gc_interval_seconds=0))
    assert "GarbageCollection" not in [type(c).__name__ for c in gc_off.controllers()]
    assert port_pressure.get_monitor().config.enabled is True


def pending_pods(pkg, n, seed):
    """``n`` pending pods of shapes every default fake type can hold."""
    rng = random.Random(seed)
    shapes = [s for s in SHAPES if s != ("2", "4Gi")]
    return [affinity_pod(pkg, f"mgr-{i:03d}", *rng.choice(shapes), []) for i in range(n)]


def manager_window(pkg, n, monkeypatch, seed=5):
    """The package's build_manager over a fresh API server, a Provisioner
    and ``n`` pending pods, the Manager started until every pod is bound;
    returns the nodes (name, instance type, the pods' request shapes) and
    the binds per pod."""
    rng = random.Random(1)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
    monkeypatch.setattr(pkg.fake, "_name_counter", itertools.count())
    jax = pkg.name == "jax"
    kube = (jax_kubecore if jax else port_kubecore).KubeCore()
    opts_mod = jax_options if jax else port_options
    extra = {} if jax else {"device": "cpu"}
    opts = opts_mod.Options(cluster_name="c", cluster_endpoint="e", window_backend="ffd",
                            pressure_rss_watermark_mb=0, batch_idle_seconds=0.5, **extra)
    manager = (jax_main if jax else port_main).build_manager(kube, opts)
    kube.create(pkg.Provisioner(metadata=pkg.core.ObjectMeta(name="default",
                                                             namespace="default"),
                                spec=pkg.ProvisionerSpec()))
    pods = pending_pods(pkg, n, seed)
    for p in pods:
        kube.create(p)
    manager.start()
    try:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            bound = [p for p in kube.list("Pod") if p.spec.node_name]
            if len(bound) == n:
                break
            time.sleep(0.05)
    finally:
        manager.stop()
    label = pkg.wellknown.LABEL_INSTANCE_TYPE
    shape = {p.metadata.name: tuple(sorted((k, str(v)) for k, v in
                                           p.spec.containers[0].resources.requests.items()))
             for p in pods}
    by_node = {}
    for p in kube.list("Pod"):
        by_node.setdefault(p.spec.node_name, []).append(shape[p.metadata.name])
    nodes = sorted((n.metadata.name, n.metadata.labels[label], tuple(sorted(by_node.get(
        n.metadata.name, [])))) for n in kube.list("Node"))
    return nodes, {p.metadata.name: p.spec.node_name for p in kube.list("Pod")}


def test_manager_window_binds_as_the_jax_build_manager(monkeypatch):
    """120 pending pods under each package's build_manager with the same
    draws: the same nodes (names, instance types and the shapes on each),
    every pod bound once; the port's window answered by the native ring."""
    want_nodes, want_binds = manager_window(JAX, 120, monkeypatch)
    got_nodes, got_binds = manager_window(PORT, 120, monkeypatch)
    assert all(got_binds.values()) and len(got_binds) == 120
    assert got_nodes == want_nodes
    assert port_solve_mod.solver_health()["executor_counts"] == {"native": 1}


@pytest.mark.parametrize("state,status,body", [
    ("plain", 200, "ok level=L0"),
    ("recovering", 503, "unhealthy level=L0 recovering"),
    ("l3", 503, "unhealthy level=L3"),
    ("burn", 503, "unhealthy level=L0 slo-burn=default"),
])
def test_readyz_answers_as_the_jax_handler(state, status, body, monkeypatch):
    """The same readiness states through both packages' servers."""
    class Recovering:
        def recovering(self):
            return True

    class Held:
        def __init__(self, level):
            self._level = level

        def level(self):
            return self._level

    got = []
    for main_mod, pressure, slo in ((jax_main, jax_pressure, jax_slo),
                                    (port_main, port_pressure, port_slo)):
        manager = type("M", (), {"healthz": lambda self: True})()
        if state == "recovering":
            manager.recovery = Recovering()
        pressure.set_monitor(Held(3 if state == "l3" else 0))
        monkeypatch.setattr(slo, "burning", lambda: ["default"] if state == "burn" else [])
        server = main_mod.serve_observability(manager, free_port())
        try:
            got.append((get(server.server_address[1], "/readyz"),
                        get(server.server_address[1], "/healthz")[0]))
        finally:
            server.shutdown()
            server.server_close()
    assert got[0] == got[1] == ((status, body), 200)


def test_debug_vars_has_the_jax_packages_keys():
    port_pressure.set_monitor(port_pressure.PressureMonitor(
        port_pressure.PressureConfig(rss_watermark_bytes=0)))
    jax_pressure.set_monitor(jax_pressure.PressureMonitor(
        jax_pressure.PressureConfig(rss_watermark_bytes=0), breaker_fn=lambda: False))
    got, want = port_main.debug_vars(), jax_main.debug_vars()
    assert set(got) == set(want)
    assert set(got["pressure"]) <= set(want["pressure"])
    json.dumps(got, default=str)
