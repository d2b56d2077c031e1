"""The port's API client (runtime/kubeclient.py) against its stub API server
(runtime/stubserver.py), and both against the JAX package's pair.

- The JAX suite's classes (tests/test_kubeclient.py) on the port's stub:
  CRUD, watch, the 410 resync that loses no events, 429 outside and on
  the eviction subresource, the PDB semantics, pagination and an expired
  continue token, the informer cache and its staleness bound, the status
  subresource, bookmarks and the relist metric.
- A differential: one seeded script of operations through the JAX client
  on the JAX stub and through the port's client on the port's stub gives
  the same request log (method, path, query, body) and the same decoded
  results; the JAX client on the port's stub gives the same again.
- Throttling moves ``karpenter_kube_client_throttle_seconds`` and the
  pressure monitor's throttle signal as the JAX pair does, under a pinned
  clock.

Every stub runs its watches as daemon threads; each test stops the
client's watches and the stub at teardown, and waits with a timeout.
"""

import io
import json
import os
import queue as queue_mod
import random
import threading
import time
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import pytest

from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import provisioner as jax_prov
from karpenter_tpu.metrics.pressure import KUBE_CLIENT_THROTTLE_SECONDS as JAX_THROTTLE
from karpenter_tpu.runtime import kubeclient as jax_client
from karpenter_tpu.runtime import kubecore as jax_kubecore
from karpenter_tpu.utils import ratelimit as jax_ratelimit
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import provisioner as port_prov
from karpenter_tpu_torch.api.core import (
    ConfigMap, LabelSelector, Node, NodeSelectorRequirement, ObjectMeta, Pod,
    PodDisruptionBudget, PodSpec,
)
from karpenter_tpu_torch.metrics.pressure import KUBE_CLIENT_THROTTLE_SECONDS as PORT_THROTTLE
from karpenter_tpu_torch.metrics.recovery import WATCH_RELIST_TOTAL
from karpenter_tpu_torch.runtime import kubeclient as port_client
from karpenter_tpu_torch.runtime.kubeclient import KubeApiClient
from karpenter_tpu_torch.runtime.kubecore import (
    AlreadyExists, Conflict, InternalError, NotFound, TooManyRequests,
)
from karpenter_tpu_torch.runtime.stubserver import StubServer
from karpenter_tpu_torch.utils import ratelimit as port_ratelimit
from karpenter_tpu_torch.utils import clock as port_clock
from tests.test_kubeclient import StubHandler as JaxStubHandler
from tests.test_torch_codec import plain
from tests.test_torch_controller import unschedulable_pod


@pytest.fixture()
def api():
    stub = StubServer()
    client = KubeApiClient(stub.url)
    yield stub.core, client, stub.behavior
    client.stop_watches()
    stub.stop()


def wait_cached(client, kind, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with client._cache_lock:
            if kind in client._cached_kinds:
                return
        time.sleep(0.02)
    raise AssertionError(f"{kind} never became cache-served")


def drain(q, want, deadline_s=10.0):
    """Events from ``q`` until ``want(seen)`` holds; ``seen`` counts names."""
    seen = {}
    deadline = time.time() + deadline_s
    while time.time() < deadline and not want(seen):
        try:
            ev = q.get(timeout=0.2)
        except queue_mod.Empty:
            continue
        seen[ev.obj.metadata.name] = seen.get(ev.obj.metadata.name, 0) + 1
    return seen


class TestCrud:
    def test_create_get_roundtrip(self, api):
        core, client, _ = api
        client.create(unschedulable_pod(requests={"cpu": "250m", "memory": "64Mi"},
                                        name="web-1"))
        got = client.get("Pod", "web-1")
        assert str(got.spec.containers[0].resources.requests["cpu"]) == "250m"
        assert got.status.conditions[0].reason == "Unschedulable"
        assert core.get("Pod", "web-1").metadata.name == "web-1"

    def test_not_found_and_conflict(self, api):
        _, client, _ = api
        with pytest.raises(NotFound):
            client.get("Pod", "missing")
        cm = ConfigMap(metadata=ObjectMeta(name="c"), data={"a": "1"})
        client.create(cm)
        with pytest.raises(AlreadyExists):
            client.create(cm)
        stale = client.get("ConfigMap", "c")
        stale.metadata.resource_version = 999
        with pytest.raises(Conflict):
            client.update(stale)

    def test_patch_retries_conflicts(self, api):
        core, client, _ = api
        client.create(ConfigMap(metadata=ObjectMeta(name="c"), data={"n": "0"}))
        calls = {"n": 0}

        def bump(obj):
            if calls["n"] == 0:
                calls["n"] += 1
                # a foreign write in between forces one 409
                core.patch("ConfigMap", "c", "default", lambda o: o.data.update(foreign="x"))
            obj.data["n"] = "1"

        client.patch("ConfigMap", "c", "default", bump)
        final = client.get("ConfigMap", "c")
        assert final.data["n"] == "1" and final.data["foreign"] == "x"

    def test_field_selector_pods_on_node(self, api):
        core, client, _ = api
        for i, node in enumerate(["n1", "n1", "n2"]):
            core.create(Pod(metadata=ObjectMeta(name=f"p{i}"), spec=PodSpec(node_name=node)))
        assert {p.metadata.name for p in client.pods_on_node("n1")} == {"p0", "p1"}

    def test_cluster_scoped_node(self, api):
        _, client, _ = api
        client.create(Node(metadata=ObjectMeta(name="node-a", namespace="")))
        assert client.get("Node", "node-a", "").metadata.name == "node-a"
        client.delete("Node", "node-a", "")
        with pytest.raises(NotFound):
            client.get("Node", "node-a", "")

    def test_bind_and_evict(self, api):
        core, client, _ = api
        pod = unschedulable_pod(name="b1")
        client.create(pod)
        client.bind_pod(pod, "node-z")
        assert core.get("Pod", "b1").spec.node_name == "node-z"
        assert client.bind_pods([pod], "node-y") != []  # bound once: the second conflicts
        client.evict_pod("b1")
        with pytest.raises(NotFound):
            core.get("Pod", "b1")

    def test_delete_preconditions_over_the_wire(self, api):
        core, client, _ = api
        cm = core.create(ConfigMap(metadata=ObjectMeta(name="pc"), data={"k": "1"}))
        stale_rv = cm.metadata.resource_version
        core.patch("ConfigMap", "pc", "default", lambda o: o.data.update({"k": "2"}))
        with pytest.raises(Conflict):
            client.delete("ConfigMap", "pc", precondition_rv=stale_rv)
        live = core.get("ConfigMap", "pc")
        assert live.data["k"] == "2"
        client.delete("ConfigMap", "pc", precondition_rv=live.metadata.resource_version)
        with pytest.raises(NotFound):
            core.get("ConfigMap", "pc")

    def test_update_strips_finalizer_over_the_wire(self, api):
        core, client, _ = api
        core.create(Node(metadata=ObjectMeta(name="nx", namespace="",
                                             finalizers=["karpenter.sh/termination"])))
        got = client.get("Node", "nx", "")
        got.metadata.finalizers = []
        got.metadata.labels["added"] = "yes"
        client.update(got)
        stored = core.get("Node", "nx", "")
        assert stored.metadata.finalizers == []
        assert stored.metadata.labels["added"] == "yes"

    def test_label_selector_operator_serialization(self, api):
        _, client, _ = api
        seen = {}
        client._request = lambda method, path, body=None, **kw: (
            seen.update(path=path) or {"items": []})
        client.list("Pod", namespace=None, label_selector=LabelSelector(
            match_labels={"team": "ml"},
            match_expressions=[
                NodeSelectorRequirement(key="app", operator="Exists"),
                NodeSelectorRequirement(key="gone", operator="DoesNotExist"),
                NodeSelectorRequirement(key="zone", operator="NotIn", values=["z1"]),
            ]))
        sel = parse_qs(urlsplit(seen["path"]).query)["labelSelector"][0]
        assert sel == "team=ml,app,!gone,zone notin (z1)"


class TestWatch:
    def test_watch_streams_events(self, api):
        core, client, _ = api
        core.create(Pod(metadata=ObjectMeta(name="pre")))
        q = client.watch("Pod")
        core.create(Pod(metadata=ObjectMeta(name="post")))
        seen = drain(q, lambda s: "pre" in s and "post" in s)
        assert "pre" in seen and "post" in seen

    def test_unwatch_stops_thread(self, api):
        """unwatch() severs the live stream: the thread ends at once, with
        no event to nudge it out of its read."""
        core, client, _ = api
        q = client.watch("Pod")
        core.create(Pod(metadata=ObjectMeta(name="settle")))
        q.get(timeout=10.0)
        threads = list(client._watch_threads)
        assert threads and all(t.is_alive() for t in threads)
        client.unwatch(q)
        for t in threads:
            t.join(5.0)
        assert not any(t.is_alive() for t in threads)

    def test_stop_watches_ends_every_thread(self, api):
        core, client, _ = api
        queues = [client.watch(kind) for kind in ("Pod", "Node", "Pod")]
        core.create(Pod(metadata=ObjectMeta(name="x")))
        queues[0].get(timeout=10.0)
        client.stop_watches()
        for t in client._watch_threads:
            t.join(5.0)
        assert not any(t.is_alive() for t in client._watch_threads)

    def test_watch_410_resync_loses_no_events(self, api):
        core, client, behavior = api
        core.create(Pod(metadata=ObjectMeta(name="before")))
        q = client.watch("Pod")
        assert q.get(timeout=10.0).obj.metadata.name == "before"
        behavior["watch_410_next"] = True
        core.create(Pod(metadata=ObjectMeta(name="trigger")))
        seen = {}
        deadline = time.time() + 15
        created_after = False
        while time.time() < deadline:
            if not created_after and behavior.get("watch_410_next") is None:
                core.create(Pod(metadata=ObjectMeta(name="after-410")))
                created_after = True
            try:
                ev = q.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            seen[ev.obj.metadata.name] = seen.get(ev.obj.metadata.name, 0) + 1
            if "after-410" in seen and seen.get("before", 0) >= 2:
                break
        assert "after-410" in seen, f"event lost across the 410 resync: {seen}"
        assert seen.get("before", 0) >= 2, f"no relist replay: {seen}"

    def test_stale_list_converges_via_watch_replay(self, api):
        core, client, behavior = api
        core.create(ConfigMap(metadata=ObjectMeta(name="fresh"), data={"k": "v"}))
        behavior["list_omit_once"] = "fresh"
        q = client.watch("ConfigMap")
        assert "fresh" in drain(q, lambda s: "fresh" in s)
        assert client.get("ConfigMap", "fresh").data["k"] == "v"

    def test_bookmark_events_are_swallowed(self, api):
        core, client, behavior = api
        q = client.watch("Pod")

        def drain_to(name):
            deadline = time.time() + 5.0
            while time.time() < deadline:
                ev = q.get(timeout=5.0)
                assert ev.obj.metadata.name, "a bookmark reached the consumer"
                if ev.obj.metadata.name == name:
                    return
            raise AssertionError(f"{name} never delivered")

        core.create(unschedulable_pod(name="bm-1"))
        drain_to("bm-1")
        behavior["bookmark_next"] = True
        core.create(unschedulable_pod(name="bm-2"))
        drain_to("bm-2")
        core.create(unschedulable_pod(name="bm-3"))
        drain_to("bm-3")
        with client._cache_lock:
            assert ("default", "") not in client._read_cache.get("Pod", {})


class TestThrottleAndEviction:
    def test_429_outside_eviction_retries_not_conflict(self, api):
        core, client, behavior = api
        core.create(ConfigMap(metadata=ObjectMeta(name="cm"), data={"k": "v"}))
        behavior["throttle_429"] = 1
        assert client.get("ConfigMap", "cm").data["k"] == "v"
        assert behavior["throttle_429"] == 0

    def test_429_on_eviction_is_typed_pdb_violation(self, api):
        core, client, behavior = api
        core.create(Pod(metadata=ObjectMeta(name="guarded")))
        behavior["evict_429"] = True
        with pytest.raises(TooManyRequests):
            client.evict_pod("guarded")

    def test_eviction_pdb_semantics_over_the_wire(self, api):
        core, client, _ = api
        for i in range(2):
            core.create(Pod(metadata=ObjectMeta(name=f"web-{i}", labels={"app": "web"}),
                            spec=PodSpec(node_name="n1")))
        core.create(PodDisruptionBudget(metadata=ObjectMeta(name="web-pdb"),
                                        selector=LabelSelector(match_labels={"app": "web"}),
                                        min_available=2))
        with pytest.raises(TooManyRequests):
            client.evict_pod("web-0")
        assert core.get("Pod", "web-0")
        core.create(PodDisruptionBudget(metadata=ObjectMeta(name="web-pdb-2"),
                                        selector=LabelSelector(match_labels={"app": "web"}),
                                        min_available=1))
        with pytest.raises(InternalError):
            client.evict_pod("web-0")
        core.delete("PodDisruptionBudget", "web-pdb", "default")
        core.create(Pod(metadata=ObjectMeta(name="web-2", labels={"app": "web"}),
                        spec=PodSpec(node_name="n1")))
        client.evict_pod("web-0")
        with pytest.raises(NotFound):
            core.get("Pod", "web-0")


class TestInformerReadCache:
    def counting(self, client):
        calls = {"n": 0}
        real = client._get_live

        def live(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        client._get_live = live
        return calls

    def test_get_served_locally_after_watch(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="cached-1"))
        client.watch("Pod")
        wait_cached(client, "Pod")
        calls = self.counting(client)
        assert client.get("Pod", "cached-1").metadata.name == "cached-1"
        assert calls["n"] == 0
        with pytest.raises(NotFound):
            client.get("Pod", "does-not-exist")  # a miss goes live
        assert calls["n"] == 1

    def test_watch_events_update_cache(self, api):
        core, client, _ = api
        client.watch("Pod")
        wait_cached(client, "Pod")
        core.create(unschedulable_pod(name="late-pod"))
        deadline = time.time() + 5
        while time.time() < deadline:
            with client._cache_lock:
                if ("default", "late-pod") in client._read_cache.get("Pod", {}):
                    break
            time.sleep(0.02)
        core.delete("Pod", "late-pod")
        deadline = time.time() + 5
        gone = False
        while time.time() < deadline and not gone:
            with client._cache_lock:
                gone = ("default", "late-pod") not in client._read_cache.get("Pod", {})
            time.sleep(0.02)
        assert gone, "a DELETED event did not evict the cache entry"

    def test_unwatch_feeder_disables_serving(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="p1"))
        q = client.watch("Pod")
        wait_cached(client, "Pod")
        client.unwatch(q)
        with client._cache_lock:
            assert "Pod" not in client._cached_kinds
            assert not client._read_cache.get("Pod")

    def test_cached_list_filters(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="labeled", labels={"team": "a"}))
        core.create(unschedulable_pod(name="other"))
        client.watch("Pod")
        wait_cached(client, "Pod")
        got = client.list("Pod", label_selector=LabelSelector(match_labels={"team": "a"}))
        assert [p.metadata.name for p in got] == ["labeled"]

    def test_stale_feeder_falls_through_live(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="stale-1"))
        client.watch("Pod")
        wait_cached(client, "Pod")
        calls = self.counting(client)
        client.get("Pod", "stale-1")
        assert calls["n"] == 0
        with client._cache_lock:
            client._cache_down_since["Pod"] = time.monotonic() - client.cache_staleness_s - 1.0
        client.get("Pod", "stale-1")
        assert calls["n"] == 1
        assert client._cache_list("Pod", None, None, None) is None
        with client._cache_lock:
            qid = client._cache_feeder["Pod"]
        client._cache_replace_kind("Pod", [core.get("Pod", "stale-1")], qid)
        client.get("Pod", "stale-1")
        assert calls["n"] == 1  # a fresh snapshot serves again

    def test_severed_stream_restores_serving(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="sever-1"))
        q = client.watch("Pod")
        wait_cached(client, "Pod")
        client._sever(client._watch_conns[id(q)])
        deadline = time.time() + 10.0
        restored = False
        while time.time() < deadline and not restored:
            with client._cache_lock:
                restored = ("Pod" in client._cached_kinds
                            and "Pod" not in client._cache_down_since
                            and WATCH_RELIST_TOTAL.collect().get(
                                (("kind", "Pod"), ("reason", "reconnect")), 0) > 0)
            time.sleep(0.02)
        assert restored

    def test_cached_pods_on_node_follow_binds_and_deletes(self, api):
        """pods_on_node from the cache's node index equals the store's
        through binds (the watch's and the client's own), moves and
        deletes."""
        core, client, _ = api
        for i in range(6):
            core.create(unschedulable_pod(name=f"pn-{i}"))
        client.watch("Pod")
        wait_cached(client, "Pod")

        def both(node):
            return ({p.metadata.name for p in client.pods_on_node(node)},
                    {p.metadata.name for p in core.pods_on_node(node)})

        client.bind_pods([core.get("Pod", "pn-0"), core.get("Pod", "pn-1")], "a")
        core.bind_pods([core.get("Pod", "pn-2")], "b")
        core.delete("Pod", "pn-1")
        deadline = time.time() + 5.0
        while time.time() < deadline and (both("a")[0] != both("a")[1]
                                          or both("b")[0] != both("b")[1]):
            time.sleep(0.02)
        assert both("a") == ({"pn-0"}, {"pn-0"}) and both("b") == ({"pn-2"}, {"pn-2"})
        assert both("nowhere") == (set(), set())

    def test_a_pod_this_client_binds_reads_bound_at_once(self, api):
        """Read your own binds: the cached pod takes its node when the bind
        answers, before any watch event (the JAX package's cache waits for
        the event). The feeder's stream updates are dropped here, so only
        the bind itself can have changed the entry."""
        core, client, _ = api
        pods = [unschedulable_pod(name=f"rb-{i}") for i in range(3)]
        for p in pods:
            core.create(p)
        client.watch("Pod")
        wait_cached(client, "Pod")
        client._cache_store = lambda kind, obj, qid: None
        assert client.bind_pods(pods[:2], "node-r") == []
        got = [client.read("Pod", p.metadata.name, "default", lambda o: o.spec.node_name)
               for p in pods]
        assert got == ["node-r", "node-r", ""]
        assert client.bind_pods(pods[:1], "node-s") != []  # the server's 409 stands
        assert client.read("Pod", "rb-0", "default", lambda o: o.spec.node_name) == "node-r"

    def test_lock_free_reads_hold_under_binds_and_relists(self, api):
        """Readers without the lock (get, read, scan, pods_on_node) while
        the client binds and the feeder relists twice, with more threads
        than cores and a short switch interval: no reader fails, and once
        the watch has caught up the cache and its node index equal the
        store."""
        import sys

        core, client, behavior = api
        names = [f"lf-{i:03d}" for i in range(120)]
        for name in names:
            core.create(unschedulable_pod(name=name))
        client.watch("Pod")
        wait_cached(client, "Pod")
        errors, stop = [], threading.Event()

        def reader(seed):
            rng = random.Random(seed)
            try:
                while not stop.is_set():
                    name = rng.choice(names)
                    client.get("Pod", name)
                    client.read("Pod", name, "default", lambda p: p.spec.node_name)
                    client.pods_on_node(f"n{rng.randrange(4)}")
                    client.scan("Pod", lambda p: p.metadata.name)
            except Exception as e:  # noqa: BLE001 — any failure is the finding
                errors.append(repr(e))

        readers = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(4 * (os.cpu_count() or 1))]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in readers:
                t.start()
            for i, name in enumerate(names):
                if i in (40, 80):
                    behavior["watch_410_next"] = "Pod"
                client.bind_pods([core.get("Pod", name)], f"n{i % 4}")
        finally:
            stop.set()
            for t in readers:
                t.join(10.0)
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in readers) and errors == []
        deadline = time.time() + 10.0
        while time.time() < deadline:
            cached = {p.metadata.name: p.spec.node_name for p in client.list("Pod")}
            if all(cached.get(n) for n in names):
                break
            time.sleep(0.05)
        assert cached == {p.metadata.name: p.spec.node_name for p in core.list("Pod")}
        for node in ("n0", "n1", "n2", "n3"):
            assert ({p.metadata.name for p in client.pods_on_node(node)}
                    == {p.metadata.name for p in core.pods_on_node(node)})

    def test_write_path_stays_live(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="patched"))
        client.watch("Pod")
        wait_cached(client, "Pod")
        client.patch("Pod", "patched", "default",
                     lambda p: p.metadata.annotations.update({"x": "y"}))
        assert core.get("Pod", "patched").metadata.annotations["x"] == "y"


class TestListPagination:
    def test_list_follows_continue_tokens(self, api):
        core, client, behavior = api
        for i in range(7):
            core.create(unschedulable_pod(name=f"page-{i}"))
        client.list_page_size = 3
        behavior["list_requests"] = 0
        assert sorted(p.metadata.name for p in client.list("Pod")) == [
            f"page-{i}" for i in range(7)]
        assert behavior["list_requests"] == 3

    def test_watch_relist_paginates(self, api):
        core, client, _ = api
        for i in range(5):
            core.create(unschedulable_pod(name=f"wp-{i}"))
        client.list_page_size = 2
        q = client.watch("Pod")
        seen = drain(q, lambda s: len(s) == 5)
        assert set(seen) == {f"wp-{i}" for i in range(5)}
        wait_cached(client, "Pod")
        assert len(client.list("Pod")) == 5

    def test_expired_continue_token_restarts_list(self, api):
        core, client, behavior = api
        for i in range(7):
            core.create(unschedulable_pod(name=f"exp-{i}"))
        client.list_page_size = 3
        behavior["list_410_once"] = True
        assert sorted(p.metadata.name for p in client.list("Pod")) == [
            f"exp-{i}" for i in range(7)]
        assert "list_410_once" not in behavior

    def test_selector_filters_compose_with_pagination(self, api):
        core, client, _ = api
        for i in range(6):
            core.create(unschedulable_pod(name=f"sel-{i}",
                                          labels={"team": "a" if i % 2 == 0 else "b"}))
        client.list_page_size = 2
        got = client.list("Pod", label_selector=LabelSelector(match_labels={"team": "a"}))
        assert sorted(p.metadata.name for p in got) == ["sel-0", "sel-2", "sel-4"]


class TestStatusSubresource:
    def test_status_subresource_contract_over_the_wire(self, api):
        core, client, _ = api
        prov = port_prov.Provisioner()
        prov.metadata.name = "sub"
        core.create(prov)
        client.patch("Provisioner", "sub", "default", lambda p: port_prov.set_condition(
            p.status.conditions, "Active", "True", "WorkerRunning", now=1_700_000_000.0))
        cond = port_prov.get_condition(core.get("Provisioner", "sub").status.conditions,
                                       "Active")
        assert cond is not None and cond.status == "True"
        item = client._item("Provisioner", "sub", "default")
        raw = client._request("GET", item)
        raw["spec"]["ttlSecondsAfterEmpty"] = 60
        raw["status"] = {}  # the main PUT must not clear status
        client._request("PUT", item, raw)
        stored = core.get("Provisioner", "sub")
        assert stored.spec.ttl_seconds_after_empty == 60
        assert port_prov.get_condition(stored.status.conditions, "Active") is not None

    def test_status_put_ignores_spec_changes(self, api):
        core, client, _ = api
        prov = port_prov.Provisioner()
        prov.metadata.name = "sub2"
        prov.spec.ttl_seconds_after_empty = 10
        core.create(prov)
        item = client._item("Provisioner", "sub2", "default")
        raw = client._request("GET", item)
        raw["spec"]["ttlSecondsAfterEmpty"] = 999
        raw["status"] = {"resources": {"cpu": "4"}}
        client._request("PUT", item + "/status", raw)
        stored = core.get("Provisioner", "sub2")
        assert stored.spec.ttl_seconds_after_empty == 10
        assert str(stored.status.resources["cpu"]) == "4"


class TestWatchRelistMetric:
    def totals(self, kind):
        out = {"expired": 0.0, "reconnect": 0.0}
        for labels, v in WATCH_RELIST_TOTAL.collect().items():
            d = dict(labels)
            if d.get("kind") == kind:
                out[d.get("reason")] = v
        return out

    def test_initial_list_is_not_a_relist(self, api):
        core, client, _ = api
        before = self.totals("Node")
        q = client.watch("Node")
        core.create(Node(metadata=ObjectMeta(name="n0", namespace="")))
        assert q.get(timeout=10.0).obj.metadata.name == "n0"
        assert self.totals("Node") == before

    def test_410_expiry_counts_an_expired_relist(self, api):
        core, client, behavior = api
        before = self.totals("Pod")
        core.create(Pod(metadata=ObjectMeta(name="seed")))
        q = client.watch("Pod")
        q.get(timeout=10.0)
        behavior["watch_410_next"] = "Pod"
        core.create(Pod(metadata=ObjectMeta(name="trigger")))
        seen = drain(q, lambda s: s.get("seed", 0) >= 2, 15.0)
        assert seen.get("seed", 0) >= 2, f"no relist replay: {seen}"
        assert self.totals("Pod")["expired"] >= before["expired"] + 1

    def test_stub_counts_requests_by_verb_and_resource(self):
        stub = StubServer()
        client = KubeApiClient(stub.url)
        try:
            pod = unschedulable_pod(name="c1")
            client.create(pod)
            client.get("Pod", "c1")
            client.list("Pod")
            client.bind_pod(pod, "n1")
            client.delete("Pod", "c1")
        finally:
            stub.stop()
        assert dict(stub.counts) == {"create pods": 1, "get pods": 1, "list pods": 1,
                                     "create pods/binding": 1, "delete pods": 1}

    def test_stub_process_stores_its_objects_file_first(self, tmp_path):
        """``--objects FILE``: the stub's own process stores one copy of each
        object of the file a name, as if each had been created, before it
        prints its URL."""
        import subprocess
        import sys
        import urllib.request

        seed = tmp_path / "objects.json"
        seed.write_text(json.dumps([
            {"kind": "Pod", "object": port_client._encode(unschedulable_pod(name="a")),
             "names": ["seeded-0", "seeded-1"]},
            {"kind": "Pod", "object": port_client._encode(unschedulable_pod(
                name="b", requests={"cpu": "250m"})), "names": ["copy-0", "copy-1"]}]))
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.runtime.stubserver",
             "--objects", str(seed)], stdout=subprocess.PIPE, text=True)
        try:
            url = json.loads(proc.stdout.readline())["url"]
            client = KubeApiClient(url)
            got = {p.metadata.name: p for p in client.list("Pod")}
            assert sorted(got) == ["copy-0", "copy-1", "seeded-0", "seeded-1"]
            assert got["seeded-1"].metadata.resource_version == 2
            assert len({p.metadata.uid for p in got.values()}) == 4
            assert str(got["copy-1"].spec.containers[0].resources.requests["cpu"]) == "250m"
            with urllib.request.urlopen(f"{url}/stub/state", timeout=30.0) as r:
                state = json.loads(r.read())
            assert state["counts"].get("create pods", 0) == 0 and state["pods"] == 4
        finally:
            proc.terminate()
            assert proc.wait(timeout=30) == 0


class TestSharedStream:
    """Every watch of a kind shares one LIST and one stream, and their
    decoded objects; pods_on_node read in place."""

    def events(self, q, want, deadline_s=10.0):
        """Events from ``q`` until ``want(names seen)`` holds."""
        out = []
        deadline = time.time() + deadline_s
        while time.time() < deadline and not want({e.obj.metadata.name for e in out}):
            try:
                out.append(q.get(timeout=0.2))
            except queue_mod.Empty:
                continue
        return out

    def test_watches_of_a_kind_share_one_list_and_stream(self):
        stub = StubServer()
        client = KubeApiClient(stub.url)
        try:
            for i in range(3):
                stub.core.create(unschedulable_pod(name=f"s-{i}"))
            early = [client.watch("Pod") for _ in range(2)]
            wait_cached(client, "Pod")
            late = client.watch("Pod")  # joins with the cached snapshot
            stub.core.create(unschedulable_pod(name="s-3"))
            every = {f"s-{i}" for i in range(4)}
            got = [self.events(q, lambda names: names >= every) for q in early + [late]]
            assert [{e.obj.metadata.name for e in evs} for evs in got] == [every] * 3
            # one decoded object for all three watches and the read cache
            last = [next(e.obj for e in evs if e.obj.metadata.name == "s-3") for evs in got]
            assert last[0] is last[1] is last[2]
            assert last[0] is client._cache_ref("Pod", "s-3", "default")
            assert stub.counts["list pods"] == 1 and stub.counts["watch pods"] == 1
            assert len(client._watch_threads) == 1
        finally:
            client.stop_watches()
            stub.stop()

    def test_unwatching_the_first_watch_keeps_the_stream_for_the_rest(self, api):
        core, client, _ = api
        core.create(unschedulable_pod(name="kept-0"))
        first, second = client.watch("Pod"), client.watch("Pod")
        wait_cached(client, "Pod")
        client.unwatch(first)
        core.create(unschedulable_pod(name="kept-1"))
        assert "kept-1" in drain(second, lambda s: "kept-1" in s)
        assert first.empty() or all(e.obj.metadata.name == "kept-0"
                                    for e in list(first.queue))
        with client._cache_lock:
            assert "Pod" in client._cached_kinds
        threads = list(client._watch_threads)
        client.unwatch(second)  # the last: the stream ends, reads go live
        for t in threads:
            t.join(5.0)
        assert not any(t.is_alive() for t in threads)
        with client._cache_lock:
            assert "Pod" not in client._cached_kinds and not client._read_cache.get("Pod")

    def test_scan_pods_on_node_reads_what_pods_on_node_lists(self, api):
        core, client, _ = api
        for i in range(5):
            core.create(unschedulable_pod(name=f"on-{i}"))
        core.bind_pods([core.get("Pod", f"on-{i}") for i in range(3)], "a")

        def both(kube, node):
            return (sorted(kube.scan_pods_on_node(node, lambda p: p.metadata.name)),
                    sorted(p.metadata.name for p in kube.pods_on_node(node)))

        want = (["on-0", "on-1", "on-2"], ["on-0", "on-1", "on-2"])
        assert both(core, "a") == both(client, "a") == want  # the client live
        client.watch("Pod")
        wait_cached(client, "Pod")
        assert both(client, "a") == want  # from the cache's node index
        assert both(core, "none") == both(client, "none") == ([], [])


# -- the differential: one script through both packages' pairs ------------------------

class LoggingJaxStub(JaxStubHandler):
    """The JAX package's stub, logging each request as the port's does."""

    def _logged(self, handle):
        length = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(length) if length else b""
        split = urlsplit(self.path)
        self.log.append((self.command, split.path,
                         {k: v for k, v in sorted(parse_qs(split.query).items())},
                         json.loads(data) if data else None))
        # the handler reads the body again; the connection's own stream
        # comes back for the next request on it (keep-alive)
        conn_rfile, self.rfile = self.rfile, io.BytesIO(data)
        try:
            handle()
        finally:
            self.rfile = conn_rfile

    def do_GET(self):
        self._logged(super().do_GET)

    def do_POST(self):
        self._logged(super().do_POST)

    def do_PUT(self):
        self._logged(super().do_PUT)

    def do_DELETE(self):
        self._logged(super().do_DELETE)


class JaxStub:
    def __init__(self):
        self.core = jax_kubecore.KubeCore()
        self.log = []
        handler = type("S", (LoggingJaxStub,), {"core": self.core, "behavior": {},
                                                "log": self.log})
        server_cls = type("Stub", (ThreadingHTTPServer,),
                          {"request_queue_size": 128, "daemon_threads": True})
        self.server = server_cls(("127.0.0.1", 0), handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(5.0)


def script(client, c, prov_mod, seed):
    """A seeded script of API operations through ``client`` with the types
    of core module ``c``: each outcome as ("ok", decoded) or ("error", the
    exception's class)."""
    rng = random.Random(seed)
    out = []
    client.list_page_size = rng.choice([2, 3, 500])

    def call(fn, *args, **kw):
        try:
            got = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — the typed error is the outcome
            out.append(("error", type(e).__name__))
            return None
        out.append(("ok", plain(got)))
        return got

    def pod(name):
        return c.Pod(metadata=c.ObjectMeta(name=name, uid=f"u-{name}",
                                           labels={"team": rng.choice("ab")}),
                     spec=c.PodSpec(containers=[c.Container(
                         resources=c.ResourceRequirements.make(requests={
                             "cpu": f"{rng.randrange(1, 8) * 250}m",
                             "memory": f"{rng.randrange(1, 5) * 128}Mi"}))]),
                     status=c.PodStatus(phase="Pending", conditions=[c.PodCondition(
                         type="PodScheduled", status="False", reason="Unschedulable")]))

    pods = [f"p{i}" for i in range(rng.randrange(4, 9))]
    nodes = [f"n{i}" for i in range(3)]
    for name in pods:
        call(client.create, pod(name))
    for name in nodes:
        call(client.create, c.Node(metadata=c.ObjectMeta(
            name=name, namespace="", labels={"zone": rng.choice(["z1", "z2"])},
            finalizers=["karpenter.sh/termination"])))
    call(client.create, c.ConfigMap(metadata=c.ObjectMeta(name="cm"), data={"n": "0"}))
    call(client.create, c.ConfigMap(metadata=c.ObjectMeta(name="cm"), data={"n": "0"}))
    call(client.create, c.Secret(metadata=c.ObjectMeta(name="s", namespace="karpenter"),
                                 data={"tls.crt": "QUJD"}, type="kubernetes.io/tls"))
    call(client.create, c.Lease(metadata=c.ObjectMeta(name="lease"), spec=c.LeaseSpec(
        holder_identity="a", acquire_time=1_700_000_000.0, renew_time=1_700_000_000.0)))
    prov = prov_mod.Provisioner(metadata=c.ObjectMeta(name="default"))
    call(client.create, prov)
    for _ in range(12):
        op = rng.randrange(9)
        name = rng.choice(pods)
        if op == 0:
            call(client.get, "Pod", name)
        elif op == 1:
            call(client.list, "Pod", label_selector=c.LabelSelector(
                match_labels={"team": rng.choice("ab")}))
        elif op == 2:
            call(client.bind_pods, [pod(name)], rng.choice(nodes))
        elif op == 3:
            call(client.pods_on_node, rng.choice(nodes))
        elif op == 4:
            call(client.patch, "ConfigMap", "cm", "default",
                 lambda o: o.data.update(n=str(rng.randrange(100))))
        elif op == 5:
            stale = client.get("ConfigMap", "cm")
            stale.metadata.resource_version -= rng.randrange(2)
            call(client.update, stale)
        elif op == 6:
            call(client.evict_pod, name)
        elif op == 7:
            call(client.patch, "Provisioner", "default", "default",
                 lambda p: prov_mod.set_condition(p.status.conditions, "Active",
                                                  rng.choice(["True", "False"]), "R",
                                                  now=1_700_000_000.0))
        else:
            node = rng.choice(nodes)
            live = client.get("Node", node, "")
            call(client.delete, "Node", node, "",
                 precondition_rv=live.metadata.resource_version - rng.randrange(2))
    call(client.get, "Secret", "s", "karpenter")
    call(client.get, "Lease", "lease")
    call(client.get, "Provisioner", "default")
    call(client.list, "Node", namespace=None)
    call(client.list, "Pod")
    return out


def run_script(client_mod, stub, c, prov_mod, seed):
    client = client_mod.KubeApiClient(stub.url)
    try:
        return script(client, c, prov_mod, seed)
    finally:
        client.stop_watches()


@pytest.fixture()
def pinned_clocks():
    from karpenter_tpu.utils import clock as jax_clock

    jax_clock.DEFAULT.set(1_700_000_000.0)
    port_clock.DEFAULT.set(1_700_000_000.0)
    yield
    jax_clock.DEFAULT.reset()
    port_clock.DEFAULT.reset()


@pytest.mark.parametrize("seed", range(4))
def test_script_gives_the_jax_pairs_requests_and_results(seed, pinned_clocks):
    jstub, pstub, cross = JaxStub(), StubServer(log=True), StubServer(log=True)
    try:
        want = run_script(jax_client, jstub, jax_core, jax_prov, seed)
        got = run_script(port_client, pstub, port_core, port_prov, seed)
        # the JAX client against the port's stub
        crossed = run_script(jax_client, cross, jax_core, jax_prov, seed)
    finally:
        for s in (jstub, pstub, cross):
            s.stop()
    assert [o for o, _ in want].count("error") > 0  # the script reaches the errors
    for i, (a, b) in enumerate(zip(jstub.log, pstub.log)):
        assert a == b, f"seed {seed}: request {i} differs: {a} != {b}"
    assert len(jstub.log) == len(pstub.log) == len(cross.log)
    assert got == want
    assert crossed == want and cross.log == jstub.log


# -- throttling and the pressure monitor ------------------------------------------------

class PinnedTime:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += s


def throttle_run(client_mod, ratelimit, pressure_mod, histogram, stub_url):
    """Twelve GETs through a 2 QPS / 3 burst bucket on a pinned clock, the
    package's monitor on the same clock: per request the wait, the level
    and the decayed signal; then the histogram's count and sum deltas."""
    t = PinnedTime()
    kw = {} if pressure_mod is port_pressure else {"breaker_fn": lambda: False}
    monitor = pressure_mod.PressureMonitor(
        pressure_mod.PressureConfig(rss_watermark_bytes=0), timefunc=t.now, **kw)
    pressure_mod.set_monitor(monitor)
    client = client_mod.KubeApiClient(stub_url)
    client._limiter = ratelimit.TokenBucket(2, 3, timefunc=t.now, sleepfunc=t.sleep)
    before = {lv: (s, n) for lv, (_, s, n) in histogram.collect().items()}
    steps = []
    try:
        for i in range(12):
            try:
                client.get("ConfigMap", "missing")
            except Exception as e:  # noqa: BLE001 — NotFound in both packages
                assert type(e).__name__ == "NotFound"
            if i == 8:
                t.t += 60.0  # two time constants: the signal decays
            steps.append((round(t.t, 9), int(monitor.evaluate()),
                          monitor.signals()["throttle_seconds"]))
    finally:
        pressure_mod.set_monitor(None)
    after = histogram.collect()
    s0, n0 = before.get((), (0.0, 0))
    _, s1, n1 = after[()]
    return steps, round(s1 - s0, 9), n1 - n0


def test_throttle_moves_the_histogram_and_monitor_as_the_jax_pair():
    jstub, pstub = JaxStub(), StubServer()
    try:
        want = throttle_run(jax_client, jax_ratelimit, jax_pressure, JAX_THROTTLE, jstub.url)
        got = throttle_run(port_client, port_ratelimit, port_pressure, PORT_THROTTLE,
                           pstub.url)
    finally:
        jstub.stop()
        pstub.stop()
    assert got == want
    steps, total, count = got
    assert count == 6 and total == 3.0  # the 4th to 9th request waited 0.5 s each
    assert max(level for _, level, _ in steps) == 2  # 2 s of waits is L2
    assert steps[-1][2] < steps[7][2]  # decayed after the idle minute
