"""The port's delta-marshal arena, versioned catalog encoding and device
buffer ring (B13) against the JAX package's and against a cold marshal.

Mirrors tests/test_marshal_delta.py and tests/test_marshal_cache.py. The
contract is the encoder's exactness rule: every cache is versioned, a
version mismatch means a rebuild, and no input (churn, a provisioner spec
change, an intern-table rollover, a vocabulary rebind, a reset landing
mid-window) may produce bytes that differ from a cold marshal and encode,
or from the JAX package's encode of the same stream. Pods and catalogs
are built separately in each package from numpy seeds 1, 7 and 42, and
both packages' process-wide caches (intern tables, arenas, catalog
encodings, rings) are reset before each comparison. Every comparison is
exact. The ring's counters are held equal to the JAX ``DeviceRing``'s over
the same solve sequence; the port runs on the CPU, where the ring's
refill is a plain in-place copy.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wellknown
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.ops import encode as jax_enc
from karpenter_tpu.solver import adapter as jax_adapter
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import pipeline as jax_pipeline
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.ops import encode as enc_mod
from karpenter_tpu_torch.ops import feasibility
from karpenter_tpu_torch.solver import adapter
from karpenter_tpu_torch.solver import batch_solve
from karpenter_tpu_torch.solver import pipeline
from karpenter_tpu_torch.solver import solve as solve_mod
from tests.test_torch_solve import canonical

SEEDS = (1, 7, 42)
SHAPES = [(100, 64), (250, 128), (500, 256), (1000, 512), (2000, 1024), (4000, 4096)]


class Pkg:
    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.core = jax_core if jax else port_core
        self.wk = jax_wellknown if jax else port_wellknown
        self.fake = jax_fake if jax else port_fake
        self.universe = jax_universe if jax else solve_mod.universe_constraints
        self.enc = jax_enc if jax else enc_mod
        self.adapter = jax_adapter if jax else adapter
        self.pipeline = jax_pipeline if jax else pipeline

    def pod(self, cpu_m, mem_mi, **limits):
        c = self.core
        return c.Pod(spec=c.PodSpec(containers=[c.Container(
            resources=c.ResourceRequirements.make(
                requests={"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"},
                limits=limits or None))]))

    def narrowed(self, constraints, zones):
        """``constraints`` with the zone key narrowed (a spec change)."""
        req = self.core.NodeSelectorRequirement(
            key=self.wk.LABEL_TOPOLOGY_ZONE, operator="In", values=list(zones))
        if self.name == "jax":
            out = constraints.deepcopy()
            out.requirements = out.requirements.add(req)
            return out
        return PortConstraints(requirements=constraints.requirements.add(req))

    def solve(self, constraints, pods, catalog, daemons=(), **cfg):
        if self.name == "jax":
            return jax_solve_mod.solve(constraints, pods, catalog, daemons=daemons,
                                       config=jax_config(**cfg))
        return solve_mod.solve(constraints, pods, catalog, daemons=daemons, device="cpu",
                               config=solve_mod.SolverConfig(**{"device_min_pods": 0, **cfg}))

    def solve_batch(self, problems, **cfg):
        if self.name == "jax":
            return jax_batch.solve_batch(problems, jax_config(**cfg))
        return batch_solve.solve_batch(problems, solve_mod.SolverConfig(
            **{"device_min_pods": 0, **cfg}), device="cpu")


def jax_config(**cfg):
    """The JAX package's device path at any size, inline, unhedged."""
    return jax_solve_mod.SolverConfig(device_min_pods=1, device_timeout_s=0,
                                      device_hedge=False, **cfg)


JAX, PORT = Pkg("jax"), Pkg("port")


class Stream:
    """Seeded draws for a window stream; one Stream per package, same seed."""

    def __init__(self, pkg, seed):
        self.pkg = pkg
        self.g = np.random.default_rng(seed)

    def pods(self, n):
        return [self.pkg.pod(*SHAPES[int(i)]) for i in self.g.integers(len(SHAPES), size=n)]

    def churn(self, pods, frac):
        """Replace ``frac`` of the pod objects with fresh ones."""
        idx = self.g.permutation(len(pods))[:int(len(pods) * frac)]
        for i in idx:
            pods[int(i)] = self.pkg.pod(*SHAPES[int(self.g.integers(len(SHAPES)))])


def reset_all():
    """Both packages' process-wide marshal, encode and ring state."""
    for pkg in (JAX, PORT):
        pkg.enc.reset_marshal_arena()
        pkg.enc.clear_catalog_encoding_cache()
        pkg.pipeline.reset_ring()


@pytest.fixture(autouse=True)
def fresh_state():
    reset_all()
    feasibility.reset_heals()
    yield
    reset_all()


def cold_clear(pkg, pods):
    """No arena, no per-pod entries, no cached catalog arrays."""
    keys = ("_marshal", "_arena_row") if pkg.name == "jax" else (adapter._CACHE_KEY,
                                                                   adapter._ROW_KEY)
    for p in pods:
        for k in keys:
            p.__dict__.pop(k, None)
    pkg.enc.reset_marshal_arena()
    pkg.enc.clear_catalog_encoding_cache()


def marshal_key(pkg, pods):
    vecs, required, sids = pkg.adapter.marshal_pods_interned(pods)
    return list(vecs), required, None if sids is None else sids[0].tolist()


def window_encode(pkg, catalog, constraints, pods, daemons=()):
    """The window's marshal, versioned packables and encode, as raw bytes."""
    vecs, required, sids = pkg.adapter.marshal_pods_interned(pods)
    packables, _st, ver = pkg.adapter.build_packables_versioned(
        catalog, constraints, pods, list(daemons), required=required)
    e = pkg.enc.encode(vecs, list(range(len(pods))), packables, pad=False, sids=sids,
                       catalog_version=ver)
    return (e.shapes.tobytes(), e.counts.tobytes(), e.totals.tobytes(),
            e.reserved0.tobytes(), e.valid.tobytes(), e.shape_pods, e.scales, e.pods_unit)


class TestDeltaEqualsCold:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_churned_marshal_equals_cold_and_jax(self, seed):
        """Five windows with 20 % object churn: the delta marshal equals a
        cold one (vectors, required set, interned ids) and the JAX
        package's (vectors, required set)."""
        js, ps = Stream(JAX, seed), Stream(PORT, seed)
        jpods, ppods = js.pods(300), ps.pods(300)
        cold_clear(PORT, ppods)
        marshal_key(PORT, ppods)
        for _ in range(5):
            js.churn(jpods, 0.2)
            ps.churn(ppods, 0.2)
            delta = marshal_key(PORT, ppods)
            # the unchurned pods answered from their arena rows
            assert enc_mod.marshal_arena().stats()["hits"] >= len(ppods) // 2
            cold_clear(PORT, ppods)
            assert marshal_key(PORT, ppods) == delta
            want = marshal_key(JAX, jpods)
            assert delta[:2] == want[:2]

    @pytest.mark.parametrize("seed", SEEDS)
    def test_encode_equals_cold_and_jax(self, seed):
        """The full window encode through the versioned catalog arrays:
        delta = cold = the JAX package's, on raw bytes."""
        jcat, pcat = jax_fake.instance_types(8), port_fake.instance_types(8)
        jc, pc = JAX.universe(jcat), PORT.universe(pcat)
        js, ps = Stream(JAX, seed), Stream(PORT, seed)
        jpods, ppods = js.pods(200), ps.pods(200)
        window_encode(PORT, pcat, pc, ppods)  # warm
        rebuilds = enc_mod.CATALOG_REBUILDS
        for _ in range(3):
            js.churn(jpods, 0.1)
            ps.churn(ppods, 0.1)
            warm = window_encode(PORT, pcat, pc, ppods)
            assert enc_mod.CATALOG_REBUILDS == rebuilds  # the catalog arrays were reused
            cold_clear(PORT, ppods)
            assert window_encode(PORT, pcat, pc, ppods) == warm
            rebuilds = enc_mod.CATALOG_REBUILDS
            assert warm == window_encode(JAX, jcat, jc, jpods)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_spec_change_rollover_and_rebind_keep_encodings(self, seed, monkeypatch):
        """Alternating provisioner specs, an adapter intern table at a cap of
        4 shapes (a rollover every window) and a feasibility vocab rebind
        before every other window: each window's encode equals its cold
        encode and the JAX package's."""
        jcat, pcat = jax_fake.instance_types(8), port_fake.instance_types(8)
        jbase, pbase = JAX.universe(jcat), PORT.universe(pcat)
        specs = {"jax": [jbase, JAX.narrowed(jbase, ["test-zone-1", "test-zone-2"])],
                 "port": [pbase, PORT.narrowed(pbase, ["test-zone-1", "test-zone-2"])]}
        monkeypatch.setattr(adapter, "_INTERN_MAX", 4)
        monkeypatch.setattr(adapter, "_VEC_INTERN", {})
        monkeypatch.setattr(adapter, "_VEC_BY_ID", [])
        gen0 = adapter._INTERN_GEN
        js, ps = Stream(JAX, seed), Stream(PORT, seed)
        jpods, ppods = js.pods(120), ps.pods(120)
        arena_gens = []
        for w in range(6):
            js.churn(jpods, 0.1)
            ps.churn(ppods, 0.1)
            if w % 2:
                feasibility.reset_intern_table()
            warm = window_encode(PORT, pcat, specs["port"][w % 2], ppods)
            arena_gens.append(enc_mod.marshal_arena().stats()["generation"])
            cold_clear(PORT, ppods)
            assert window_encode(PORT, pcat, specs["port"][w % 2], ppods) == warm
            assert warm == window_encode(JAX, jcat, specs["jax"][w % 2], jpods)
        assert adapter._INTERN_GEN > gen0
        assert arena_gens == sorted(arena_gens) and arena_gens[-1] > arena_gens[0]


class TestInvalidation:
    def test_each_change_mints_a_version_and_refills(self):
        """A catalog refresh, a spec change, a daemon change and a change of
        the required set each mint a new packables version, and the next
        solve refills the catalog tensors instead of reusing them; the same
        inputs repeat their version and copy only the counts."""
        def catalog():
            # pod ENI on every type: the ENI-requiring window keeps them all
            return [port_spi.make_instance_type(name=f"e-{i}", cpu=str(2 * (i + 1)),
                                                memory=f"{4 * (i + 1)}Gi", pods="40",
                                                aws_pod_eni="4") for i in range(6)]

        cat = catalog()
        base = PORT.universe(cat)
        pods = Stream(PORT, 3).pods(60)
        eni_pods = pods[:-1] + [PORT.pod(100, 64, **{"vpc.amazonaws.com/pod-eni": "1"})]
        daemon = [PORT.pod(50, 32)]
        cases = {
            "repeat": (cat, base, pods, []),
            "catalog-refresh": (catalog(), base, pods, []),
            "spec-change": (cat, PORT.narrowed(base, ["test-zone-1", "test-zone-2"]), pods, []),
            "daemon-change": (cat, base, pods, daemon),
            "required-change": (cat, base, eni_pods, []),
        }
        _, _, v0 = adapter.build_packables_versioned(cat, base, pods, [])
        ring = pipeline.get_ring()
        PORT.solve(base, pods, cat)
        for name, (c, cons, ps, ds) in cases.items():
            _, _, v = adapter.build_packables_versioned(c, cons, ps, ds)
            before = ring.counters()
            PORT.solve(cons, ps, c, daemons=ds)
            after = ring.counters()
            delta = {k: after[k] - before[k] for k in ("allocations", "refills", "reuses")}
            if name == "repeat":
                assert v == v0
                assert delta == {"allocations": 0, "refills": 1, "reuses": 7}, delta
            else:
                assert v != v0, name
                # totals, reserved0, valid, last_valid and pods_unit carry
                # the new catalog token, and the counts refill as always
                assert delta["refills"] >= 6 and delta["allocations"] == 0, (name, delta)
            # back to the base inputs for the next case
            PORT.solve(base, pods, cat)

    def test_invalidate_drops_the_marshal_and_the_arena_row(self):
        pod = PORT.pod(100, 64)
        adapter.marshal_pods_interned([pod])
        assert adapter._ROW_KEY in pod.__dict__
        pod.spec.containers[0].resources = port_core.ResourceRequirements.make(
            requests={"cpu": "300m", "memory": "128Mi"})
        adapter.invalidate_pod_marshal(pod)
        vecs, _, sids = adapter.marshal_pods_interned([pod])
        assert list(vecs) == [adapter.pod_vector(pod)]
        assert adapter.interned_vecs_snapshot(sids[0], sids[1]) == [adapter.pod_vector(pod)]


class TestChaos:
    def test_mid_window_reset_never_stale(self, monkeypatch):
        pods = Stream(PORT, 5).pods(60)
        marshal_key(PORT, pods)  # warm rows
        real_gather = enc_mod.MarshalArena.gather
        hits = {"n": 0}

        def chaotic_gather(self, rows, generation):
            if hits["n"] < 2:
                hits["n"] += 1
                enc_mod.reset_marshal_arena()  # the concurrent reset
                return None
            return real_gather(self, rows, generation)

        monkeypatch.setattr(enc_mod.MarshalArena, "gather", chaotic_gather)
        vecs, _, sids = adapter.marshal_pods_interned(pods)
        monkeypatch.setattr(enc_mod.MarshalArena, "gather", real_gather)
        oracle = [adapter.pod_vector(p) for p in pods]
        assert list(vecs) == oracle and hits["n"] == 2
        assert adapter.interned_vecs_snapshot(sids[0], sids[1]) == oracle

    @pytest.mark.parametrize("seed", SEEDS)
    def test_threaded_marshal_with_concurrent_resets(self, seed):
        """Worker threads marshal while a chaos thread resets the arena and
        both intern tables mid-window: every window equals pod_vector."""
        st = Stream(PORT, seed)
        windows = [st.pods(40) for _ in range(4)]
        oracles = [[adapter.pod_vector(p) for p in w] for w in windows]
        stop = threading.Event()
        errors = []

        def chaos():
            while not stop.is_set():
                enc_mod.reset_marshal_arena()
                feasibility.reset_intern_table()

        def worker(i):
            try:
                for _ in range(30):
                    vecs, _req, sids = adapter.marshal_pods_interned(windows[i])
                    if list(vecs) != oracles[i]:
                        errors.append(f"window {i}: stale marshal")
                        return
                    snap = None if sids is None else adapter.interned_vecs_snapshot(*sids)
                    if snap is not None and snap != oracles[i]:
                        errors.append(f"window {i}: stale interned ids")
                        return
            except Exception as e:  # pragma: no cover - failure detail
                errors.append(f"window {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(windows))]
        chaos_t = threading.Thread(target=chaos)
        chaos_t.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        chaos_t.join()
        assert not errors, errors


# -- the device ring ----------------------------------------------------------

def batch_window(pkg, seed, n_problems=3, per=40):
    """``n_problems`` schedules over one catalog, one zone each."""
    cat = pkg.fake.instance_types(12)
    base = pkg.universe(cat)
    st = Stream(pkg, seed)
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    return [jax_batch.Problem(constraints=pkg.narrowed(base, [zones[b % 3]]),
                              pods=st.pods(per + 5 * b), instance_types=cat)
            if pkg.name == "jax" else
            batch_solve.Problem(constraints=pkg.narrowed(base, [zones[b % 3]]),
                                pods=st.pods(per + 5 * b), instance_types=cat)
            for b in range(n_problems)]


def solo_problem(pkg, seed, n=80, n_types=8):
    cat = pkg.fake.instance_types(n_types)
    return pkg.universe(cat), Stream(pkg, seed).pods(n), cat


def counters(pkg):
    c = pkg.pipeline.get_ring().counters()
    return {k: c[k] for k in ("allocations", "refills", "reuses", "slots")}


class TestDeviceRing:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_counters_equal_the_jax_ring(self, seed):
        """The same solve sequence in both packages, the counters compared
        after every step: solo solves (one chunk, and many chunks that
        resume and compact), a repeat of each, and host-filtered batched
        windows (one chunk, and many), each twice. Steady state: 0
        allocations, with reuses."""
        steps = []
        for chunk_iters in (64, 2):
            steps.append(("solo", chunk_iters))
            steps.append(("solo", chunk_iters))
        for chunk_iters in (64, 3):
            steps.append(("batch", chunk_iters))
            steps.append(("batch", chunk_iters))
        inputs = {p.name: (solo_problem(p, seed), batch_window(p, seed)) for p in (JAX, PORT)}
        history = {"jax": [], "port": []}
        for pkg in (JAX, PORT):
            (cons, pods, cat), probs = inputs[pkg.name]
            for kind, chunk_iters in steps:
                if kind == "solo":
                    res = [pkg.solve(cons, pods, cat, chunk_iters=chunk_iters)]
                else:
                    res = pkg.solve_batch(probs, chunk_iters=chunk_iters, device_filter=False)
                history[pkg.name].append((counters(pkg), [r.node_count for r in res]))
        assert history["port"] == history["jax"]
        # a repeat of the same step allocates nothing and reuses
        for i in range(1, len(steps), 2):
            prev, cur = history["port"][i - 1][0], history["port"][i][0]
            assert cur["allocations"] == prev["allocations"], steps[i]
            assert cur["reuses"] > prev["reuses"], steps[i]

    def test_fused_window_repeat_allocates_nothing(self):
        probs = batch_window(PORT, 7)
        r1 = PORT.solve_batch(probs)
        c1 = counters(PORT)
        r2 = PORT.solve_batch(probs)
        c2 = counters(PORT)
        assert [r.node_count for r in r1] == [r.node_count for r in r2]
        assert c2["allocations"] == c1["allocations"] > 0
        assert c2["reuses"] - c1["reuses"] >= 5   # shapes, totals, reserved0, pods_unit, prices
        assert c2["refills"] - c1["refills"] == 2  # counts and dropped

    def test_donate_parity_with_no_donate(self):
        cons, pods, cat = solo_problem(PORT, 9, n=120)
        a = PORT.solve(cons, pods, cat, device_donate=True, chunk_iters=4)
        b = PORT.solve(cons, pods, cat, device_donate=False, chunk_iters=4)
        assert canonical(a, pods) == canonical(b, pods)
        probs = batch_window(PORT, 9)
        a = PORT.solve_batch(probs, device_donate=True, chunk_iters=3)
        b = PORT.solve_batch(probs, device_donate=False, chunk_iters=3)
        assert [canonical(x, p.pods) for x, p in zip(a, probs)] == \
            [canonical(x, p.pods) for x, p in zip(b, probs)]

    def test_in_use_slots_are_never_refilled_or_evicted_at_depth_3(self):
        """Three windows dispatched before any fetch (the pipeline's
        deepest): each holds a slot of its own, a fourth acquire of another
        signature evicts only free slots, and each window's answer equals
        its serial solve."""
        dev = solve_mod.resolve_device("cpu")
        windows = [batch_window(PORT, s) for s in (1, 1, 7)]
        serial = [[canonical(r, p.pods) for r, p in zip(PORT.solve_batch(w), w)]
                  for w in windows]
        ring = pipeline.get_ring()
        handles = [batch_solve.dispatch_batch(w, solve_mod.SolverConfig(device_min_pods=0),
                                              device=dev)
                   for w in windows]
        slots = [h.device_run._slot for h in handles]
        assert len({id(s) for s in slots}) == 3 and all(s.in_use for s in slots)
        shapes = [h.device_run.shapes_d.clone() for h in handles]
        # a burst of other signatures: more slots than max_slots, so the ring
        # must evict, and only free slots may go
        for n in range(3):
            other = ring.acquire(("other", n))
            ring.fill(other, "x", np.arange(4 + n, dtype=np.int32), dev)
            ring.release(other)
        assert all(s in ring._slots for s in slots)
        for h, before in zip(handles, shapes):
            assert np.array_equal(h.device_run.shapes_d.numpy(), before.numpy())
        got = [[canonical(r, p.pods) for r, p in zip(h.fetch(), w)]
               for h, w in zip(handles, windows)]
        assert got == serial
        assert not any(s.in_use for s in slots)

    def test_use_after_release_raises(self):
        """A fetched window's device tensors raise: its slot belongs to the
        next window, which refills them in place (the JAX package's read
        of a donated buffer raises the same way)."""
        dev = solve_mod.resolve_device("cpu")
        probs = batch_window(PORT, 42)
        handle = batch_solve.dispatch_batch(probs, solve_mod.SolverConfig(device_min_pods=0),
                                            device=dev)
        run = handle.device_run
        shapes_ptr = run.shapes_d.data_ptr()
        handle.fetch()
        assert run.launches >= 1 and run.buckets  # host counts stay readable
        for name in ("shapes_d", "counts_d", "totals_d", "valid_d", "maxfit_d"):
            with pytest.raises(RuntimeError, match="released"):
                getattr(run, name)
        # the next window of the same buckets refills the same memory
        again = batch_solve.dispatch_batch(probs, solve_mod.SolverConfig(device_min_pods=0),
                                           device=dev)
        assert again.device_run.shapes_d.data_ptr() == shapes_ptr
        again.fetch()

    def test_token_reuse_refill_in_place_and_hand_back(self):
        dev = solve_mod.resolve_device("cpu")
        ring = pipeline.DeviceRing()
        host = np.arange(6, dtype=np.int32)
        slot = ring.acquire(pipeline.DeviceRing.signature({"totals": host}))
        tok = ("cat", 1, (1, 1), 6)
        a = ring.fill(slot, "totals", host, dev, token=tok)
        assert ring.fill(slot, "totals", host, dev, token=tok) is a
        c = ring.fill(slot, "totals", host + 2, dev, token=("cat", 2, (1, 1), 6))
        assert c is a and np.array_equal(c.numpy(), host + 2)  # written in place
        ring.hand_back(slot, totals=c)
        ring.fill(slot, "totals", host + 2, dev, token=("cat", 2, (1, 1), 6))
        assert ring.counters() == {"allocations": 1, "refills": 2, "reuses": 1, "slots": 1}
        b = ring.fill(slot, "totals", np.arange(7, dtype=np.int32), dev)
        assert b is not a and ring.counters()["allocations"] == 2
        ring.release(slot)
