"""The port's capacity garbage collector against the JAX package's, on the CPU.

The cases of the JAX package's GC tests, each driven through both
packages with the same node names and nonces (each fake provider's name
counter from 0, one seeded ``uuid.uuid4`` sequence) and both clocks on the
same timeline: an orphaned instance reaped after the grace window and
spared before it, its attribution in the ledger, a backed instance left
alone, a ghost Node deleted after the grace window, a foreign provider's
Node never touched, a sweep skipped when the provider cannot enumerate,
and a journal-covered nonce skipped. Each compares the provider ledger,
the Nodes, the provider's deletions, the controller's requeue and the
``gc_*`` counters' moves. Exact.
"""

import itertools
import random
import uuid
from types import SimpleNamespace

import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wk
from karpenter_tpu.api.constraints import Constraints as JaxConstraints
from karpenter_tpu.api.requirements import Requirements as JaxRequirements
from karpenter_tpu.chaos import inject as jax_inject
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers import gc as jax_gc
from karpenter_tpu.metrics.registry import DEFAULT as JAX_REGISTRY
from karpenter_tpu.runtime import journal as jax_jr
from karpenter_tpu.runtime import kubecore as jax_kube
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wk
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.api.requirements import Requirements as PortRequirements
from karpenter_tpu_torch.chaos import inject as port_inject
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.controllers import gc as port_gc
from karpenter_tpu_torch.metrics.registry import DEFAULT as PORT_REGISTRY
from karpenter_tpu_torch.runtime import journal as port_jr
from karpenter_tpu_torch.runtime import kubecore as port_kube
from karpenter_tpu_torch.utils import clock as port_clock

JAX = SimpleNamespace(name="jax", core=jax_core, wk=jax_wk, Constraints=JaxConstraints,
                      Requirements=JaxRequirements, inject=jax_inject, fake=jax_fake, gc=jax_gc,
                      registry=JAX_REGISTRY, jr=jax_jr, kube=jax_kube, clock=jax_clock)
PORT = SimpleNamespace(name="port", core=port_core, wk=port_wk, Constraints=PortConstraints,
                       Requirements=PortRequirements, inject=port_inject, fake=port_fake,
                       gc=port_gc, registry=PORT_REGISTRY, jr=port_jr, kube=port_kube,
                       clock=port_clock)
GRACE = 60.0
T0 = 1_700_000_000.0
COUNTERS = ("gc_instances_terminated_total", "gc_nodes_removed_total")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pkg in (JAX, PORT):
        pkg.inject.uninstall()
        pkg.clock.DEFAULT.reset()


def constraints(pkg):
    wk, c = pkg.wk, pkg.core
    return pkg.Constraints(
        labels={wk.PROVISIONER_NAME_LABEL: "unit"},
        requirements=pkg.Requirements([
            c.NodeSelectorRequirement(key=wk.LABEL_TOPOLOGY_ZONE, operator="In",
                                      values=["test-zone-1"]),
            c.NodeSelectorRequirement(key=wk.LABEL_CAPACITY_TYPE, operator="In",
                                      values=["on-demand"])]))


def leak_instance(pkg, provider):
    """One unit launched whose bind never runs (crash-before-bind)."""
    pkg.inject.install(pkg.inject.FaultPlan(1, [pkg.inject.FaultSpec(
        "provider", "create", "crash-before-bind", 1)], window=1))
    errs = provider.create(constraints(pkg), provider.catalog, 1,
                           lambda n: pytest.fail("bind ran despite the crash"))
    pkg.inject.uninstall()
    assert errs and "injected crash before bind" in errs[0]
    return provider.list_instances()[-1]


def create_backed(pkg, kube, provider):
    bound = []

    def bind(node):
        kube.create(node)
        bound.append(node)

    assert provider.create(constraints(pkg), provider.catalog, 1, bind) == [None]
    return bound[0]


def gc_counts(pkg):
    return {n: sum(pkg.registry.counter(n).collect().values()) for n in COUNTERS}


def case_leak_reaped_after_grace(pkg, kube, provider, gc):
    record = leak_instance(pkg, provider)
    pkg.clock.DEFAULT.set(T0 + GRACE + 1)
    return {"requeue": gc.reconcile("capacity-gc", ""), "reaped": record.instance_id}


def case_young_leak_spared(pkg, kube, provider, gc):
    leak_instance(pkg, provider)
    return {"requeue": gc.reconcile("capacity-gc", "")}


def case_attribution(pkg, kube, provider, gc):
    r = leak_instance(pkg, provider)
    return {"record": (r.provisioner_name, bool(r.launch_nonce), r.created_unix, r.zone,
                       r.instance_type, r.capacity_type)}


def case_backed_untouched(pkg, kube, provider, gc):
    node = create_backed(pkg, kube, provider)
    pkg.clock.DEFAULT.set(T0 + GRACE + 1)
    gc.reconcile("capacity-gc", "")
    kube.get("Node", node.metadata.name, "")
    return {}


def case_ghost_deleted_after_grace(pkg, kube, provider, gc):
    node = create_backed(pkg, kube, provider)
    provider.delete_instance(provider.list_instances()[0].instance_id)
    gc.reconcile("capacity-gc", "")
    young = [n.metadata.name for n in kube.list("Node")]
    pkg.clock.DEFAULT.set(T0 + GRACE + 1)
    gc.reconcile("capacity-gc", "")
    return {"young": young, "gone": node.metadata.name}


def case_foreign_nodes_invisible(pkg, kube, provider, gc):
    c = pkg.core
    kube.create(c.Node(metadata=c.ObjectMeta(name="alien", namespace=""),
                       spec=c.NodeSpec(provider_id="gce:///zone-x/alien-1")))
    pkg.clock.DEFAULT.set(T0 + GRACE + 1)
    gc.reconcile("capacity-gc", "")
    kube.get("Node", "alien", "")
    return {}


def case_enumeration_failure_skips(pkg, kube, provider, gc):
    create_backed(pkg, kube, provider)

    def boom():
        raise RuntimeError("provider API down")

    provider.list_instances = boom
    pkg.clock.DEFAULT.set(T0 + GRACE + 1)
    requeue = gc.reconcile("capacity-gc", "")
    del provider.list_instances
    return {"requeue": requeue}


def case_journal_covered_skipped(pkg, kube, provider, gc, tmp):
    j = pkg.jr.IntentJournal(tmp, fsync=False)
    gc.journal = j
    nonce = pkg.jr.new_nonce()
    iid = j.open_intent("fleet-launch", nonce=nonce, quantity=1)
    with pkg.jr.preassigned_nonce(nonce):
        leak_instance(pkg, provider)
    pkg.clock.DEFAULT.set(T0 + GRACE + 1)
    gc.reconcile("capacity-gc", "")
    kept = len(provider.list_instances())
    j.close(iid, outcome="abandoned")
    gc.reconcile("capacity-gc", "")
    return {"kept": kept}


CASES = [case_leak_reaped_after_grace, case_young_leak_spared, case_attribution,
         case_backed_untouched, case_ghost_deleted_after_grace, case_foreign_nodes_invisible,
         case_enumeration_failure_skips, case_journal_covered_skipped]


def run(pkg, case, monkeypatch, tmp):
    rng = random.Random(3)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
    monkeypatch.setattr(pkg.fake, "_name_counter", itertools.count())
    pkg.clock.DEFAULT.set(T0)
    kube = pkg.kube.KubeCore()
    provider = pkg.fake.FakeCloudProvider(catalog=pkg.fake.instance_types(4))
    gc = pkg.gc.GarbageCollection(kube, provider, interval_seconds=0.05, grace_seconds=GRACE)
    before = gc_counts(pkg)
    args = (pkg, kube, provider, gc) + ((tmp,) if case is case_journal_covered_skipped else ())
    seen = case(*args)
    after = gc_counts(pkg)
    seen.update(
        ledger=sorted((r.instance_id, r.launch_nonce, r.zone) for r in provider.list_instances()),
        nodes=sorted((n.metadata.name, n.metadata.deletion_timestamp is not None)
                     for n in kube.list("Node")),
        deleted=sorted(provider.deleted),
        counters={n: after[n] - before[n] for n in COUNTERS},
        wiring=(gc.kind(), gc.seeds()))
    return seen


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_gc_equals_the_jax_gc(case, monkeypatch, tmp_path):
    j = run(JAX, case, monkeypatch, str(tmp_path / "jax"))
    p = run(PORT, case, monkeypatch, str(tmp_path / "port"))
    assert p == j
    if case is case_leak_reaped_after_grace:
        assert p["ledger"] == [] and p["reaped"] in p["deleted"]
        assert p["counters"]["gc_instances_terminated_total"] == 1
    if case is case_young_leak_spared:
        assert len(p["ledger"]) == 1 and p["deleted"] == []
    if case is case_attribution:
        assert p["record"] == ("unit", True, T0, "test-zone-1", "fake-it-0", "on-demand")
    if case is case_ghost_deleted_after_grace:
        assert p["young"] == [p["gone"]] and p["nodes"] == []
        assert p["counters"]["gc_nodes_removed_total"] == 1
    if case in (case_backed_untouched, case_foreign_nodes_invisible,
                case_enumeration_failure_skips):
        assert len(p["nodes"]) == 1 and p["counters"] == {n: 0 for n in COUNTERS}
    if case is case_journal_covered_skipped:
        assert p["kept"] == 1 and p["ledger"] == []
    assert p["wiring"] == (None, [("capacity-gc", "")])
