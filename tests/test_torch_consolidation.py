"""The port's ConsolidationController against the JAX package's, on the CPU.

The same seeded cluster is stored in each package's API server (nodes with
the termination finalizer, bound pods, a Provisioner with consolidation on,
the fake provider's priced catalog); one reconcile of each package's
controller must drain the same nodes in the same order (the Node events
that stamp a deletion time, in order). The scenarios cover the
candidate filters: PodDisruptionBudget headroom and misconfiguration,
do-not-evict, soft affinity and unknown instance types, at one and at the
default eight drains a pass. The port runs with ``device="cpu"``.
"""

import importlib
import queue

import numpy as np
import pytest
import torch

from tests.test_torch_whatif import BOTH, JAX, PORT, random_fleet, running_pod

SEEDS = (1, 7, 42)
SCENARIOS = ("plain", "pdb", "pdb-misconfigured", "do-not-evict", "soft-affinity",
             "unknown-type", "mixed")


def store_cluster(P, seed, scenario, n_nodes=16):
    """The seeded fleet of ``random_fleet`` (unconstrained) stored in a new
    API server of package ``P``, with the scenario's filters applied from
    the same draws. Returns (kube, provider)."""
    c, wk = P.core, P.wk
    rng = np.random.RandomState(1000 + seed)
    catalog, nodes, pods_by = random_fleet(P, seed, n_nodes=n_nodes, constrained=False)
    kube = P.kube.KubeCore()
    kube.create(P.prov.Provisioner(metadata=c.ObjectMeta(name="default"),
                                   spec=P.prov.ProvisionerSpec(consolidation_enabled=True)))
    provider = P.fake.FakeCloudProvider(catalog=catalog)
    mixed = scenario == "mixed"
    for i, node in enumerate(nodes):
        node.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
        if (scenario == "unknown-type" or mixed) and rng.rand() < 0.25:
            node.metadata.labels[wk.LABEL_INSTANCE_TYPE] = "retired-type"
        kube.create(node)
        for pod in pods_by[node.metadata.name]:
            r = rng.rand()
            if (scenario in ("pdb", "pdb-misconfigured") or mixed) and r < 0.4:
                pod.metadata.labels["app"] = "web"
            if (scenario == "do-not-evict" or mixed) and rng.rand() < 0.1:
                pod.metadata.annotations[wk.DO_NOT_EVICT_ANNOTATION] = "true"
            if (scenario == "soft-affinity" or mixed) and rng.rand() < 0.4:
                pod.metadata.labels["team"] = "t"
                key = "kubernetes.io/hostname" if rng.rand() < 0.5 else wk.LABEL_TOPOLOGY_ZONE
                pod.spec.affinity = c.Affinity(pod_affinity=c.PodAffinity(preferred=[
                    c.WeightedPodAffinityTerm(weight=int(rng.randint(20, 100)),
                                              term=c.PodAffinityTerm(
                        topology_key=key,
                        label_selector=c.LabelSelector(match_labels={"team": "t"})))]))
            kube.create(pod)
    if scenario in ("pdb", "mixed"):
        kube.create(c.PodDisruptionBudget(
            metadata=c.ObjectMeta(name="web"),
            selector=c.LabelSelector(match_labels={"app": "web"}),
            min_available=int(rng.randint(1, 8))))
    if scenario == "pdb-misconfigured":
        kube.create(c.PodDisruptionBudget(
            metadata=c.ObjectMeta(name="web"),
            selector=c.LabelSelector(match_labels={"app": "web"}),
            min_available=1, max_unavailable="50%"))
    return kube, provider


def drained_in_order(P, seed, scenario, max_actions):
    kube, provider = store_cluster(P, seed, scenario)
    events = kube.watch("Node")
    while not events.empty():
        events.get_nowait()
    ctl_cls = importlib.import_module(P.root + ".controllers.consolidation") \
        .ConsolidationController
    kw = {"device": "cpu"} if P is PORT else {}
    ctl = ctl_cls(kube, provider=provider, max_actions_per_pass=max_actions, **kw)
    requeue = ctl.reconcile("default")
    order = []
    while True:
        try:
            e = events.get_nowait()
        except queue.Empty:
            break
        if e.type == "MODIFIED" and e.obj.metadata.deletion_timestamp is not None \
                and e.obj.metadata.name not in order:
            order.append(e.obj.metadata.name)
    return requeue, order, ctl


class TestControllerParity:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("scenario", SCENARIOS)
    def test_drains_the_same_nodes_in_order(self, seed, scenario):
        jr, jorder, _ = drained_in_order(JAX, seed, scenario, 8)
        pr, porder, ctl = drained_in_order(PORT, seed, scenario, 8)
        assert (jr, jorder) == (pr, porder)
        lw = ctl.last_window
        assert lw["drained"] == porder
        if lw["candidates"]:
            assert lw["executor"] in ("device-whatif", "host-whatif")
            assert lw["kernel_ms"] is None  # the CPU has no CUDA events

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("scenario", ("plain", "mixed"))
    def test_one_drain_a_pass(self, seed, scenario):
        _, jorder, _ = drained_in_order(JAX, seed, scenario, 1)
        _, porder, _ = drained_in_order(PORT, seed, scenario, 1)
        assert jorder == porder and len(porder) <= 1

    def test_the_seeds_exercise_the_filters(self):
        # the differential scenarios must actually filter and drain
        filtered, drained = {}, 0
        for seed in SEEDS:
            for scenario in SCENARIOS:
                _, order, ctl = drained_in_order(PORT, seed, scenario, 8)
                drained += len(order)
                for reason, n in ctl.last_window["filtered"].items():
                    filtered[reason] = filtered.get(reason, 0) + n
        assert drained > 0
        assert set(filtered) == {"pdb", "do-not-evict", "soft-affinity"}

    def test_disabled_provisioner_is_not_consolidated(self):
        for P in BOTH:
            kube, provider = store_cluster(P, 1, "plain")
            kube.patch("Provisioner", "default", "default",
                       lambda p: setattr(p.spec, "consolidation_enabled", False))
            ctl_cls = importlib.import_module(
                P.root + ".controllers.consolidation").ConsolidationController
            kw = {"device": "cpu"} if P is PORT else {}
            assert ctl_cls(kube, provider=provider, **kw).reconcile("default") is None


class TestDefaultDevice:
    def test_construction_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid")
        from karpenter_tpu_torch.controllers.consolidation import ConsolidationController

        with pytest.raises(RuntimeError, match="CUDA"):
            ConsolidationController(PORT.kube.KubeCore())

    def test_explicit_cpu_is_taken(self):
        from karpenter_tpu_torch.controllers.consolidation import ConsolidationController

        ctl = ConsolidationController(PORT.kube.KubeCore(), device="cpu")
        assert ctl.device == torch.device("cpu")


class TestCost:
    @pytest.mark.parametrize("capacity_type", ["on-demand", "spot"])
    def test_node_price_and_plan_cost_equal(self, capacity_type):
        out = []
        for P in BOTH:
            Offering = importlib.import_module(P.root + ".cloudprovider.spi").Offering
            catalog = [P.fake.make_instance_type(
                f"t{i}", cpu=str(2 ** i), memory=f"{2 ** (i + 1)}Gi", pods="20",
                price=0.1 * 2 ** i,
                offerings=[Offering(ct, "z1") for ct in ("on-demand", "spot")])
                for i in range(3)]
            prices = [P.cost.node_price(it, capacity_type) for it in catalog]
            pods = [running_pod(P, f"p{j}", cpu="700m", memory="300Mi") for j in range(9)]
            if P is PORT:
                constraints = P.solve.universe_constraints(catalog)
                result = P.solve.solve(constraints, pods, catalog, device="cpu")
            else:
                constraints = importlib.import_module(
                    "karpenter_tpu.controllers.provisioning").universe_constraints(catalog)
                result = P.solve.solve(constraints, pods, catalog)
            out.append((prices, P.cost.plan_cost(result.packings, constraints.requirements)))
        assert out[0] == out[1]
