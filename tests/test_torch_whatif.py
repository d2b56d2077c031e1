"""The port's what-if window (B9) against the JAX package's, on the CPU.

The same seeded numpy draws build both packages' fleets (nodes, pods,
catalogs); the port runs with ``device="cpu"``, where ``whatif_scan`` is its
plain version. Every comparison is exact:

- ``encode_window`` field by field (``kept``, ``scales``, ``compat`` and
  every padded device array), seeds 1/7/42 and the unencodable window;
- ``whatif_scan_plain`` against ``_whatif_jit`` (XLA on the CPU) on
  ``feasible`` and on every slot, including the candidate whose first pod
  fits nowhere and whose second is still placed (the scan never breaks);
- ``feasible`` against both packages' ``host_whatif``, the slots on
  feasible rows only (host_whatif stops at a candidate's first failure);
- ``plan_window``'s actions, ``repack_plan``, ``removable_nodes``,
  ``fleet_prices`` and ``soft_affinity_loss`` in both packages;
- the global kernel's design (bins strided over threads, a thread's
  first fit, the block minimum, the owner's debit) and the staged
  kernel's (resources folded out, valid pods by chunk ballots, compat
  packed into column words of the four bins a lane owns in each block of
  128, the first fit over the marked blocks) emulated in numpy against the plain
  version, on chip_smoke's fuzz windows; the fold alone against the
  plain version on the original inputs; the launch geometry per bin
  bucket.

The shared builders here serve the other ``test_torch_*`` files of the
node-removal slice.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.solver.whatif import WhatIfConfig, _whatif_jit
from karpenter_tpu_torch.ops import whatif_cuda
from karpenter_tpu_torch.ops.whatif_cuda import whatif_scan, whatif_scan_plain

SEEDS = (1, 7, 42)


def _pkg(root):
    def m(sub):
        return importlib.import_module(f"{root}.{sub}")
    return SimpleNamespace(
        root=root, core=m("api.core"), wk=m("api.wellknown"), res=m("utils.resources"),
        fake=m("cloudprovider.fake.provider"), cons=m("models.consolidate"),
        cost=m("models.cost"), ow=m("ops.whatif"), sw=m("solver.whatif"),
        kube=m("runtime.kubecore"), clock=m("utils.clock"),
        prov=m("api.provisioner"), constraints=m("api.constraints"),
        solve=m("solver.solve"))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")
BOTH = (JAX, PORT)


# -- builders, one per package from the same draws --------------------------

def priced_catalog(P):
    mk = P.fake.make_instance_type
    return [mk("small", cpu="2", memory="4Gi", pods="20", price=0.10),
            mk("medium", cpu="4", memory="8Gi", pods="40", price=0.19),
            mk("large", cpu="8", memory="16Gi", pods="80", price=0.40)]


def running_node(P, name, it, capacity_type="on-demand", provisioner="default",
                 zone="test-zone-1", taints=(), type_name=None):
    c, wk = P.core, P.wk
    rl = {"cpu": str(it.cpu), "memory": str(it.memory), "pods": str(it.pods)}
    return c.Node(
        metadata=c.ObjectMeta(name=name, namespace="", labels={
            wk.LABEL_INSTANCE_TYPE: type_name or it.name,
            wk.LABEL_CAPACITY_TYPE: capacity_type,
            wk.LABEL_TOPOLOGY_ZONE: zone,
            wk.PROVISIONER_NAME_LABEL: provisioner}),
        spec=c.NodeSpec(taints=[c.Taint(key=k, value=v, effect="NoSchedule")
                                for k, v in taints]),
        status=c.NodeStatus(
            capacity=P.res.parse_resource_list(rl),
            allocatable=P.res.parse_resource_list(rl),
            conditions=[c.NodeCondition(type="Ready", status="True", reason="KubeletReady")]))


def running_pod(P, name, cpu="500m", memory="256Mi", node="", labels=None,
                selector=None, tolerations=(), daemonset=False, annotations=None,
                preferred=None):
    """A pod; ``selector`` a node selector dict, ``tolerations`` (key,
    value) pairs, ``preferred`` (weight, topology key, match labels) of a
    preferred pod-affinity term."""
    c = P.core
    pod = c.Pod(
        metadata=c.ObjectMeta(name=name, uid=name, labels=dict(labels or {}),
                              annotations=dict(annotations or {})),
        spec=c.PodSpec(
            node_name=node, node_selector=dict(selector or {}),
            tolerations=[c.Toleration(key=k, operator="Equal", value=v, effect="NoSchedule")
                         for k, v in tolerations],
            containers=[c.Container(resources=c.ResourceRequirements.make(
                requests={"cpu": cpu, "memory": memory}))]))
    if daemonset:
        pod.metadata.owner_references.append(c.OwnerReference(kind="DaemonSet", name="ds"))
    if preferred is not None:
        w, key, match = preferred
        pod.spec.affinity = c.Affinity(pod_affinity=c.PodAffinity(preferred=[
            c.WeightedPodAffinityTerm(weight=w, term=c.PodAffinityTerm(
                topology_key=key, label_selector=c.LabelSelector(match_labels=dict(match))))]))
    return pod


def random_fleet(P, seed, n_nodes=12, constrained=True):
    """A seeded fleet over the priced catalog: mixed node sizes and zones,
    0-4 small pods each; with ``constrained`` some nodes tainted, some pods
    tolerating, some pinned to a zone and some DaemonSet pods."""
    rng = np.random.RandomState(seed)
    catalog = priced_catalog(P)
    nodes, pods_by = [], {}
    for i in range(n_nodes):
        it = catalog[rng.randint(len(catalog))]
        zone = f"test-zone-{1 + rng.randint(2)}"
        taints = [("dedicated", "gpu")] if constrained and rng.rand() < 0.2 else []
        ct = "spot" if rng.rand() < 0.3 else "on-demand"
        node = running_node(P, f"n{i}", it, capacity_type=ct, zone=zone, taints=taints)
        nodes.append(node)
        pods = []
        for j in range(rng.randint(5)):
            sel = {P.wk.LABEL_TOPOLOGY_ZONE: zone} if constrained and rng.rand() < 0.2 else None
            tol = [("dedicated", "gpu")] if constrained and rng.rand() < 0.3 else []
            pods.append(running_pod(
                P, f"p{i}-{j}", cpu=f"{rng.choice([100, 250, 500, 1000])}m",
                memory=f"{rng.choice([64, 128, 256, 512])}Mi", node=f"n{i}",
                selector=sel, tolerations=tol,
                daemonset=constrained and rng.rand() < 0.1))
        pods_by[node.metadata.name] = pods
    return catalog, nodes, pods_by


def window_of(P, nodes, pods_by, catalog):
    """(bins, candidate indices, movable pods, savings) as the controller
    builds them."""
    bins = [P.cons.node_bin(n, pods_by[n.metadata.name]) for n in nodes]
    prices, _ = P.cons.fleet_prices(nodes, catalog)
    cand_idx, cand_movable, savings = [], [], []
    for i, n in enumerate(nodes):
        movable, ok = P.cons.reschedulable_pods(pods_by[n.metadata.name])
        if not ok or not movable:
            continue
        cand_idx.append(i)
        cand_movable.append(movable)
        savings.append(prices[n.metadata.name])
    return bins, cand_idx, cand_movable, savings


def encodings(seed, **kw):
    out = []
    for P in BOTH:
        catalog, nodes, pods_by = random_fleet(P, seed, **kw)
        bins, ci, cm, sav = window_of(P, nodes, pods_by, catalog)
        out.append((P.ow.encode_window(bins, ci, cm), sav, nodes, pods_by, catalog))
    return out


def jit_answer(enc):
    f, s = _whatif_jit(*enc.d_compat.shape)(enc.d_pods, enc.d_valid, enc.d_compat,
                                            enc.d_free0, enc.d_cand_bin)
    return np.asarray(f), np.asarray(s)


def plain_answer(enc):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (enc.d_pods, enc.d_valid, enc.d_compat, enc.d_free0, enc.d_cand_bin)]
    f, s = whatif_scan_plain(*t)
    return f.numpy(), s.numpy()


def random_tensors(rng, NB, KB, BB):
    """A random padded window in the kernel's ABI (numpy), with negative
    free values, own bins of -1, all-invalid rows and all-zero compat rows."""
    pods = np.zeros((NB, KB, 8), np.int32)
    pods[:, :, 0] = rng.randint(1, 50, (NB, KB))
    pods[:, :, 1] = rng.randint(1, 50, (NB, KB))
    pods[:, :, 2] = 1
    valid = np.arange(KB)[None, :] < rng.randint(0, KB + 1, NB)[:, None]
    valid[rng.rand(NB) < 0.2] = rng.rand(KB) < 0.5
    compat = rng.rand(NB, KB, BB) < rng.choice([0.3, 0.8, 1.0])
    compat[rng.rand(NB) < 0.15] = False
    free0 = np.zeros((BB, 8), np.int32)
    free0[:, 0] = rng.randint(-20, 120, BB)
    free0[:, 1] = rng.randint(-20, 120, BB)
    free0[:, 2] = rng.randint(-1, 4, BB)
    cand_bin = rng.randint(-1, BB, NB).astype(np.int32)
    return pods, valid, compat, free0, cand_bin


def fail_then_place():
    """One candidate, two pods: the first (larger) fits nowhere, the second
    fits bin 1 only."""
    pods = np.zeros((4, 4, 8), np.int32)
    pods[0, 0, :3] = (1000, 1000, 1)
    pods[0, 1, :3] = (10, 10, 1)
    valid = np.zeros((4, 4), bool)
    valid[0, :2] = True
    compat = np.ones((4, 4, 4), bool)
    free0 = np.zeros((4, 8), np.int32)
    free0[0, :3] = (5, 5, 1)
    free0[1, :3] = (50, 50, 1)
    cand_bin = np.array([3, -1, -1, -1], np.int32)
    return pods, valid, compat, free0, cand_bin


def jit_on(arrays):
    f, s = _whatif_jit(*arrays[2].shape)(*arrays)
    return np.asarray(f), np.asarray(s)


def plain_on(arrays):
    f, s = whatif_scan_plain(*[torch.from_numpy(a) for a in arrays])
    return f.numpy(), s.numpy()


# -- encode_window -----------------------------------------------------------

ENC_FIELDS = ("n", "k", "b", "cand_bin", "kept", "scales", "compat", "d_pods", "d_valid",
              "d_compat", "d_free0", "d_cand_bin")


def assert_same_encoding(a, b):
    for name in ENC_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name
    assert [[v for v, _ in ps] for ps in a.cand_pods] == \
        [[v for v, _ in ps] for ps in b.cand_pods]
    assert [[p.metadata.name for _, p in ps] for ps in a.cand_pods] == \
        [[p.metadata.name for _, p in ps] for ps in b.cand_pods]


class TestEncodeWindow:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("constrained", [False, True])
    def test_equals_the_jax_encoding(self, seed, constrained):
        (je, *_), (pe, *_) = encodings(seed, constrained=constrained)
        assert je.device_ready and pe.device_ready
        assert_same_encoding(je, pe)

    def test_unencodable_window_equal_and_host_answered(self):
        # coprime byte-level memory requests push the GCD to 1 and the
        # scaled column past int32: no device tensors in either package
        encs = []
        for P in BOTH:
            catalog = priced_catalog(P)
            nodes = [running_node(P, f"n{i}", catalog[2]) for i in range(2)]
            pods_by = {"n0": [running_pod(P, "a", cpu="100m", memory="3")],
                       "n1": [running_pod(P, "b", cpu="100m", memory="7")]}
            bins, ci, cm, _ = window_of(P, nodes, pods_by, catalog)
            encs.append(P.ow.encode_window(bins, ci, cm))
        assert not encs[0].device_ready and not encs[1].device_ready
        assert_same_encoding(*encs)
        feas, _, executor = PORT.sw.solve_window(encs[1], device="cpu")
        assert executor == "host-whatif"
        assert list(feas) == [True, True]

    def test_no_receiver_window_is_host_answered(self):
        # every bin full: pruning keeps none (bk == 0), the host answers
        P = PORT
        catalog = priced_catalog(P)
        nodes = [running_node(P, f"n{i}", catalog[0]) for i in range(2)]
        pods_by = {n.metadata.name: [running_pod(P, f"{n.metadata.name}-p", cpu="2",
                                                 memory="1Gi")] for n in nodes}
        bins, ci, cm, _ = window_of(P, nodes, pods_by, catalog)
        enc = P.ow.encode_window(bins, ci, cm)
        assert enc.kept is not None and len(enc.kept) == 0 and not enc.device_ready
        feas, slots, executor = P.sw.solve_window(enc, device="cpu")
        assert executor == "host-whatif" and list(feas) == [False, False]


# -- the scan ----------------------------------------------------------------

class TestScan:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("constrained", [False, True])
    def test_plain_equals_whatif_jit_on_every_slot(self, seed, constrained):
        (je, *_), (pe, *_) = encodings(seed, constrained=constrained)
        f_jit, s_jit = jit_answer(je)
        f, s = plain_answer(pe)
        assert np.array_equal(f, f_jit) and np.array_equal(s, s_jit)

    @pytest.mark.parametrize("seed", range(12))
    def test_plain_equals_whatif_jit_on_random_windows(self, seed):
        rng = np.random.RandomState(100 + seed)
        shape = [(4, 4, 4), (8, 4, 16), (16, 8, 32), (32, 16, 64)][seed % 4]
        arrays = random_tensors(rng, *shape)
        f_jit, s_jit = jit_on(arrays)
        f, s = plain_on(arrays)
        assert np.array_equal(f, f_jit) and np.array_equal(s, s_jit)

    def test_fail_then_place_candidate(self):
        # _whatif_jit keeps placing after a failure; so must the port
        arrays = fail_then_place()
        f_jit, s_jit = jit_on(arrays)
        f, s = plain_on(arrays)
        assert not f_jit[0] and s_jit[0, :2].tolist() == [-1, 1]
        assert np.array_equal(f, f_jit) and np.array_equal(s, s_jit)

    def test_fail_then_place_differs_from_host_mirror_only_in_slots(self):
        # the reference's two answers differ on the infeasible row's slots
        # (host_whatif breaks at the first failure): the port follows the
        # device program, and feasible agrees
        P = PORT
        catalog = [P.fake.make_instance_type("t", cpu="4", memory="8Gi", pods="10", price=1.0)]
        nodes = [running_node(P, "cand", catalog[0]), running_node(P, "small", catalog[0]),
                 running_node(P, "roomy", catalog[0])]
        pods_by = {"cand": [running_pod(P, "big", cpu="3"), running_pod(P, "tiny", cpu="100m")],
                   "small": [running_pod(P, "fill", cpu="3500m")],
                   "roomy": [running_pod(P, "half", cpu="2")]}
        bins, ci, cm, _ = window_of(P, nodes, pods_by, catalog)
        enc = P.ow.encode_window(bins, [0], [cm[0]])
        feas, slots, executor = P.sw.solve_window(enc, device="cpu")
        host_feas, host_slots = P.ow.host_whatif(enc)
        assert executor == "device-whatif"
        assert not feas[0] and not host_feas[0]
        assert slots[0].tolist() == [-1, 1] and host_slots[0].tolist() == [-1, -1]

    def test_cpu_tensors_take_the_plain_version(self):
        arrays = random_tensors(np.random.RandomState(3), 8, 4, 16)
        before = whatif_cuda.LAUNCHES
        f, s = whatif_scan(*[torch.from_numpy(a) for a in arrays])
        assert whatif_cuda.LAUNCHES == before
        f2, s2 = plain_on(arrays)
        assert np.array_equal(f.numpy(), f2) and np.array_equal(s.numpy(), s2)


def emulate_kernel(arrays, threads):
    """csrc/whatif.cu's algorithm in numpy: bins strided over ``threads``,
    each thread's first fit in ascending order, the block minimum, the
    owner's debit of its own rows (structure of arrays)."""
    pods, valid, compat, free0, cand_bin = arrays
    NB, KB, R = pods.shape
    BB = free0.shape[0]
    feasible = np.ones(NB, bool)
    slots = np.full((NB, KB), -1, np.int32)
    for i in range(NB):
        rows = free0.T.copy()  # [r, b]
        for k in range(KB):
            if not valid[i, k]:
                continue
            best = []
            for t in range(threads):
                for b in range(t, BB, threads):
                    if b == cand_bin[i] or not compat[i, k, b]:
                        continue
                    if (rows[:, b] >= pods[i, k]).all():
                        best.append(b)
                        break
            if not best:
                feasible[i] = False
                continue
            chosen = min(best)
            assert chosen % threads in range(threads)
            rows[:, chosen] -= pods[i, k]
            slots[i, k] = chosen
    return feasible, slots


class TestKernelDesign:
    @pytest.mark.parametrize("seed", range(4))
    def test_strided_first_fit_equals_plain(self, seed):
        rng = np.random.RandomState(200 + seed)
        shape = [(4, 4, 4), (8, 8, 64), (6, 4, 100), (4, 16, 40)][seed]
        arrays = random_tensors(rng, *shape)
        want = plain_on(arrays)
        for threads in (32, whatif_cuda.launch_threads(shape[2]), 7):
            got = emulate_kernel(arrays, threads)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

    def test_launch_shape_and_shared_memory_line(self):
        assert [whatif_cuda.launch_threads(b) for b in (4, 32, 33, 512, 1024, 1 << 22)] == \
            [32, 32, 64, 512, 512, 512]
        # free rows of BB = 4096 (128 KiB) fit a block's 227 KiB; 8192 do not
        assert whatif_cuda.free_rows_in_shared(4096)
        assert not whatif_cuda.free_rows_in_shared(8192)

    @pytest.mark.parametrize("BB, kernel, threads, shared_bytes, groups, blocks", [
        (4, "staged", 160, 14856, 1, 1), (32, "staged", 160, 14856, 1, 1),
        (128, "staged", 160, 14856, 1, 1), (512, "staged", 160, 27528, 1, 4),
        (1024, "staged", 160, 44424, 1, 8), (2048, "staged", 160, 86792, 2, 16),
        (4096, "staged", 160, 171528, 4, 32), (8192, "global", 512, 0, None, None),
        (1 << 22, "global", 512, 0, None, None)])
    def test_launch_geometry_per_bucket(self, BB, kernel, threads, shared_bytes, groups, blocks):
        # PERF.md's geometry table: the staged kernel (5 warps, the free
        # rows and two chunk buffers in shared memory) up to BB = 4096,
        # whose 171,528 bytes fit a block's 227 KiB less the static margin;
        # the global kernel (free rows in a global scratch) from 8192
        g = whatif_cuda.launch_geometry(BB)
        assert (g["kernel"], g["threads"], g["shared_bytes"]) == (kernel, threads, shared_bytes)
        assert (g.get("groups"), g.get("blocks")) == (groups, blocks)
        assert whatif_cuda.free_rows_in_shared(BB) == (kernel == "staged")
        assert shared_bytes <= whatif_cuda.SHARED_OPTIN_BYTES - whatif_cuda.SHARED_MARGIN_BYTES


# -- the staged kernel's design (csrc/whatif.cu whatif_staged_kernel) ---------

U32 = np.uint64(0xFFFFFFFF)


def pack4(w):
    """csrc/whatif.cu pack4 on uint64 arrays holding 32-bit words: bit 7 of
    each nonzero byte, gathered onto bits 28..31 by one multiply."""
    hi = (((w & np.uint64(0x7f7f7f7f)) + np.uint64(0x7f7f7f7f)) | w) & np.uint64(0x80808080)
    return ((hi * np.uint64(0x00204081)) & U32) >> np.uint64(28)


def column_words(row, g, BB):
    """One compat row's column words of group g, a lane each: bit 4q + e of
    lane l's word is bin 1024g + 128q + 4l + e; each lane's four bytes of a
    block are one little-endian 32-bit load, packed by pack4."""
    out = np.zeros(32, np.uint64)
    for lane in range(32):
        for q in range(8):
            b = 1024 * g + 128 * q + 4 * lane
            if b + 4 <= BB:
                word = np.uint64(int.from_bytes(row[b:b + 4].astype(np.uint8).tobytes(), "little"))
                out[lane] |= pack4(word) << np.uint64(4 * q)
    return out


def emulate_staged(arrays):
    """csrc/whatif.cu's staged kernel in numpy: the active dimensions over a
    candidate's valid pods, padded to 3, 4 or 8 with folded ones; smask
    (bin exists, not the own bin, folded free values >= 0) in column words;
    chunks of 32 pods by their valid ballot; column words packed from
    4-byte loads, ANDed with smask, and their OR over the lanes; the step
    walks the marked blocks of 128 bins in order, each lane tests its four
    bins, the lowest lane with a fit takes its lowest fitting bin and
    debits it; a pod equal to the chunk's last valid one (vector and
    compat row) fails where that one failed and goes into its bin of
    block 0 without a search while it fits."""
    pods, valid, compat, free0, cand_bin = arrays
    NB, KB, R = pods.shape
    BB = free0.shape[0]
    assert BB % 4 == 0  # the 4-byte loads (the kernel reads bytes otherwise)
    groups = -(-BB // 1024)
    bbr = -(-BB // 128) * 128
    feasible = np.ones(NB, bool)
    slots = np.full((NB, KB), -1, np.int32)
    lanes = np.arange(32)
    for i in range(NB):
        v = valid[i].astype(bool)
        if not v.any():
            continue
        active = [r for r in range(R) if (pods[i][v][:, r] != 0).any()]
        folded = [r for r in range(R) if r not in active]
        nstep = 3 if len(active) <= 3 else 4 if len(active) <= 4 else R
        dims = (active + folded)[:nstep]
        b = np.arange(bbr)
        ok = (b < BB) & (b != cand_bin[i])
        for r in folded:
            ok[:BB] &= free0[:, r] >= 0
        okbytes = np.zeros(groups * 1024, np.uint8)
        okbytes[:bbr] = ok
        smask = [column_words(okbytes, g, groups * 1024) for g in range(groups)]
        rows = np.zeros((nstep, groups * 1024), np.int64)
        rows[:, :BB] = free0[:, dims].T
        prev = None  # (k, bin) of the last valid pod of the chunk
        for c in range(-(-KB // 32)):
            prev = None
            for t in range(32):
                k = 32 * c + t
                if k >= KB or not valid[i, k]:
                    continue
                vec = pods[i, k, dims].astype(np.int64)
                if prev is not None and np.array_equal(pods[i, k], pods[i, prev[0]]) \
                        and np.array_equal(compat[i, k].astype(bool), compat[i, prev[0]].astype(bool)):
                    # a run of the same pod: where the last one went, while it fits
                    b_prev = prev[1]
                    if b_prev < 0:
                        feasible[i] = False
                        prev = (k, -1)
                        continue
                    if b_prev < 128 and (rows[:, b_prev] >= vec).all():
                        rows[:, b_prev] -= vec
                        slots[i, k] = b_prev
                        prev = (k, b_prev)
                        continue
                placed = False
                for g in range(groups):
                    cw = column_words(compat[i, k], g, BB) & smask[g]
                    blocks = int(np.bitwise_or.reduce(cw))
                    while blocks and not placed:
                        q = ((blocks & -blocks).bit_length() - 1) >> 2
                        base = 1024 * g + 128 * q + 4 * lanes
                        nib = (cw >> np.uint64(4 * q)) & np.uint64(0xF)
                        bins = base[:, None] + np.arange(4)[None, :]  # [lane, e]
                        fit = ((nib[:, None] >> np.arange(4, dtype=np.uint64)[None, :])
                               & np.uint64(1)).astype(bool)
                        fit &= (rows[:, bins] >= vec[:, None, None]).all(0)
                        hit = fit.any(1)
                        if hit.any():
                            lane = int(np.argmax(hit))
                            chosen = int(bins[lane, np.argmax(fit[lane])])
                            rows[:, chosen] -= vec
                            slots[i, k] = chosen
                            placed = True
                        blocks &= ~(0xF << (4 * q))
                    if placed:
                        break
                if not placed:
                    feasible[i] = False
                prev = (k, int(slots[i, k]))
    return feasible, slots


def smoke_case(seed, NB, KB, BB, kind):
    """chip_smoke.whatif_case's window on the CPU, as numpy arrays."""
    return [t.numpy() for t in chip_smoke.whatif_case(
        np.random.default_rng(seed), NB, KB, BB, "cpu", kind)]


def folded_answer(arrays):
    """whatif_scan_plain on the folded inputs, a candidate at a time: its
    static resources' free0 >= 0 ANDed into compat and then zeroed, its own
    bin cleared from compat (and cand_bin -1)."""
    pods, valid, compat, free0, cand_bin = arrays
    NB, KB, R = pods.shape
    feas, slots = [], []
    for i in range(NB):
        v = valid[i].astype(bool)
        static = [r for r in range(R) if not (pods[i][v][:, r] != 0).any()]
        f0 = free0.copy()
        cmp = compat[i:i + 1].astype(bool).copy()
        cmp &= (free0[:, static] >= 0).all(1)[None, None, :]
        f0[:, static] = 0
        if 0 <= cand_bin[i] < free0.shape[0]:
            cmp[..., cand_bin[i]] = False
        f, s = plain_on([pods[i:i + 1], valid[i:i + 1], cmp, f0, np.array([-1], np.int32)])
        feas.append(f)
        slots.append(s)
    return np.concatenate(feas), np.concatenate(slots)


STAGED_CASES = [(1, 8, 4, 4, None), (2, 16, 8, 64, None), (3, 16, 8, 32, "edges"),
                (4, 8, 8, 1024, "edges"), (5, 4, 4, 2048, "edges"), (6, 8, 64, 64, "scattered"),
                (7, 8, 40, 96, "one_long"), (8, 4, 96, 16, "edges"), (9, 8, 8, 100, None),
                (10, 4, 6, 4096, "edges"), (11, 8, 64, 256, "replicas"),
                (12, 16, 40, 128, "replicas")]


class TestStagedKernelDesign:
    def test_pack4_maps_every_byte_to_its_bit(self):
        rng = np.random.RandomState(0)
        b = rng.choice([0, 1, 2, 128, 255], size=(4096, 4)).astype(np.uint8)
        want = ((b != 0) * (1 << np.arange(4))).sum(1)
        got = pack4(b.view("<u4").ravel().astype(np.uint64))
        assert np.array_equal(got.astype(np.int64), want)

    @pytest.mark.parametrize("seed, NB, KB, BB, kind", STAGED_CASES)
    def test_staged_design_equals_plain(self, seed, NB, KB, BB, kind):
        arrays = smoke_case(seed, NB, KB, BB, kind)
        want = plain_on(arrays)
        got = emulate_staged(arrays)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

    @pytest.mark.parametrize("seed, NB, KB, BB, kind", STAGED_CASES)
    def test_fold_is_exact(self, seed, NB, KB, BB, kind):
        arrays = smoke_case(seed, NB, KB, BB, kind)
        want = plain_on(arrays)
        got = folded_answer(arrays)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# -- host mirror, plan -------------------------------------------------------

class TestHostMirrorAndPlan:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_feasible_equals_both_host_mirrors(self, seed):
        (je, *_), (pe, *_) = encodings(seed)
        feas, slots, executor = PORT.sw.solve_window(pe, device="cpu")
        assert executor == "device-whatif"
        for P, enc in ((JAX, je), (PORT, pe)):
            hf, hs = P.ow.host_whatif(enc)
            assert np.array_equal(feas, hf)
            assert np.array_equal(slots[feas], hs[feas])

    @pytest.mark.parametrize("seed", SEEDS)
    def test_plan_window_equals_jax(self, seed):
        (je, jsav, *_), (pe, psav, pnodes, ppods, _) = encodings(seed)
        assert jsav == psav
        jf, _, _ = JAX.sw.solve_window(je, WhatIfConfig(device_min_cells=0))
        pf, _, _ = PORT.sw.solve_window(pe, device="cpu")
        assert np.array_equal(jf, pf)
        targets = [i for _, i in sorted(
            (len(PORT.cons.reschedulable_pods(ppods[n.metadata.name])[0]), i)
            for i, n in enumerate(pnodes))]
        jp = JAX.sw.plan_window(je, jf, jsav, max_drains=len(pnodes),
                                incremental_targets=targets)
        pp = PORT.sw.plan_window(pe, pf, psav, max_drains=len(pnodes),
                                 incremental_targets=targets)
        assert [(a.cand, a.bin, a.placements, a.saving) for a in jp.actions] == \
            [(a.cand, a.bin, a.placements, a.saving) for a in pp.actions]
        assert (jp.reclaimed_per_hour, jp.evaluated, jp.feasible) == \
            (pp.reclaimed_per_hour, pp.evaluated, pp.feasible)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_every_drain_replays_on_fresh_bins(self, seed):
        _, (pe, psav, nodes, pods_by, _) = encodings(seed)
        feas, _, _ = PORT.sw.solve_window(pe, device="cpu")
        plan = PORT.sw.plan_window(pe, feas, psav, max_drains=len(nodes))
        vbins = [PORT.cons.node_bin(n, pods_by[n.metadata.name]) for n in nodes]
        drained = set()
        for action in plan.actions:
            movable = [p for _, p in pe.cand_pods[action.cand]]
            surviving = [b for j, b in enumerate(vbins) if j != action.bin and j not in drained]
            assert PORT.cons.place_onto(movable, surviving, commit=True) is not None
            drained.add(action.bin)
        received = {b for a in plan.actions for b in a.placements}
        assert not received & set(plan.drained_bins)

    def test_dispatch_without_a_device_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid")
        _, (pe, *_) = encodings(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.sw.dispatch_window(pe)

    def test_fetch_is_idempotent_and_translates_kept(self):
        _, (pe, *_) = encodings(7)
        handle = PORT.sw.dispatch_window(pe, device="cpu")
        first = handle.fetch()
        assert handle.fetch() is first
        feas, slots, _ = first
        placed = slots[slots >= 0]
        assert set(placed.tolist()) <= set(int(b) for b in pe.kept)


# -- the consolidation models ------------------------------------------------

class TestModels:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_removable_nodes_equal(self, seed):
        names = []
        for P in BOTH:
            _, nodes, pods_by = random_fleet(P, seed)
            names.append([n.metadata.name for n in
                          P.cons.removable_nodes(nodes, pods_by, max_actions=len(nodes))])
        assert names[0] == names[1]

    @pytest.mark.parametrize("seed", SEEDS)
    def test_fleet_prices_equal(self, seed):
        out = []
        for P in BOTH:
            catalog, nodes, _ = random_fleet(P, seed)
            nodes[0].metadata.labels[P.wk.LABEL_INSTANCE_TYPE] = "retired"
            prices, unknown = P.cons.fleet_prices(nodes, catalog)
            out.append((prices, [n.metadata.name for n in unknown]))
        assert out[0] == out[1]

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("backend", ["ffd", "relax"])
    def test_repack_plan_equal(self, seed, backend):
        plans = []
        for P in BOTH:
            catalog, nodes, pods_by = random_fleet(P, seed, n_nodes=8, constrained=False)
            constraints = P.solve.universe_constraints(catalog) if P is PORT else \
                importlib.import_module("karpenter_tpu.controllers.provisioning") \
                .universe_constraints(catalog)
            kw = {"device": "cpu"} if P is PORT else {}
            plans.append(P.cons.repack_plan(nodes, pods_by, constraints, catalog,
                                            backend=backend, **kw))
        j, p = plans
        assert (j.planned_nodes, j.current_nodes, j.saves) == \
            (p.planned_nodes, p.current_nodes, p.saves)
        assert j.current_cost_per_hour == p.current_cost_per_hour
        assert j.planned_cost_per_hour == pytest.approx(p.planned_cost_per_hour, abs=1e-9)
        assert (j.relax is None) == (p.relax is None)
        if backend == "relax":
            assert (j.relax.used, j.relax.reason) == (p.relax.used, p.relax.reason)

    @pytest.mark.parametrize("key", ["kubernetes.io/hostname", "topology.kubernetes.io/zone"])
    @pytest.mark.parametrize("switch", ["1", "0"])
    def test_soft_affinity_loss_equal(self, key, switch, monkeypatch):
        monkeypatch.setenv("KARPENTER_SOFT_AFFINITY", switch)
        out = []
        for P in BOTH:
            catalog = priced_catalog(P)
            nodes = [running_node(P, f"n{i}", catalog[1], zone=f"test-zone-{1 + i % 2}")
                     for i in range(4)]
            pods_by = {
                "n0": [running_pod(P, "a", labels={"app": "x"},
                                   preferred=(40, key, {"app": "y"})),
                       running_pod(P, "b", labels={"app": "y"})],
                "n1": [running_pod(P, "c", labels={"app": "y"})],
                "n2": [running_pod(P, "d", labels={"app": "y"},
                                   preferred=(7, key, {"app": "x"}))],
                "n3": []}
            out.append([P.ow.soft_affinity_loss(n, pods_by[n.metadata.name], nodes, pods_by,
                                                0.001) for n in nodes])
        assert out[0] == out[1]
        if switch == "1":
            assert out[1][0] > 0.0
