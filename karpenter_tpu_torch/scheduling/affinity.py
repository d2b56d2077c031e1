"""Pod-pod affinity/anti-affinity as just-in-time node selectors.

A copy of the JAX package's ``scheduling/affinity.py``. The topology-spread
trick (scheduling/topology.py, scheduler.go:69-72) carries over: affinity
decisions are injected into pods as node selectors *before* constraint
grouping, so the solver stays oblivious to them. Supported surface:
**required** podAffinity / podAntiAffinity terms on any topology key, with
selector operators In / NotIn / Exists / DoesNotExist (what the match
program, ops/feasibility.affinity_match_matrix, compiles), plus
**preferred** terms, which never constrain feasibility: they become
weighted soft votes priced into the window scoring program (ops/policy.py)
and the consolidation what-if (ops/whatif.soft_affinity_loss).

Because this provisioner only creates NEW nodes (fresh, unique hostnames),
the peer set of an affinity decision is the provisioning window itself:
anti-affinity against running pods is vacuously satisfied on provisioned
capacity and positive affinity can only be satisfied by co-provisioned
peers. Within the window:

- **Affinity** edges (i's required term matches j's labels, same
  namespace, same topology key) are symmetric co-location demands:
  connected components share ONE domain, so they group into one schedule
  and pack together.
- **Anti-affinity** conflicts (either pod's required anti term matches the
  other's labels, same namespace, same key) force distinct domains, which
  puts the two sides into different schedules, and different schedules
  launch disjoint node sets.
- A conflict INSIDE one co-location component, or a required term no
  window peer matches and the pod cannot anchor itself (the lonely term),
  is unsatisfiable: its pods are marked ``_affinity_unsat`` and stamped
  with the empty hostname domain, so they fail validation like topology's
  no-domain case and stay Pending.

**Domains per topology key.** For the hostname key a domain is a fresh
``secrets.token_hex(4)`` value appended to the window constraints as an
``In`` requirement. For topology-*valued* keys (zone,
``karpenter.sh/node-group``, any key the provisioner's requirements carry
an In-vocabulary for) domains are values of that vocabulary, intersected
with every member's own pinned requirement for the key; anti-conflicting
components greedily take distinct values in (min member index, sorted
value) order. An empty pick is unsatisfiable.

**Preferred (soft) terms.** After required injection, each pod's preferred
terms vote ``±weight`` for every (key, value) its matching window peers
are pinned to. The votes land on ``pod.__dict__["_soft_affinity"]`` as
``{(key, value): signed_weight}``; the scheduler folds them into the group
key. ``KARPENTER_SOFT_AFFINITY=0`` disables extraction entirely.
"""

from __future__ import annotations

import os
import secrets
from typing import Dict, List, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.api.requirements import pod_requirements
from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.ops import feasibility

SOFT_AFFINITY_ENV = "KARPENTER_SOFT_AFFINITY"


def soft_enabled() -> bool:
    """Preferred-term kill switch: default ON, 0/false/off disables."""
    return os.environ.get(SOFT_AFFINITY_ENV, "1").strip().lower() not in (
        "0", "false", "off")


def _required_terms(pod: Pod, anti: bool) -> list:
    """Required terms of one side (affinity / anti), any topology key."""
    aff = pod.spec.affinity
    if aff is None:
        return []
    side = aff.pod_anti_affinity if anti else aff.pod_affinity
    if side is None:
        return []
    return [t for t in side.required
            if t.topology_key and t.label_selector is not None]


def _preferred_terms(pod: Pod, anti: bool) -> list:
    """(weight, term) pairs of one side's preferred list; zero-weight and
    selector-less terms are inert (kube weight range is 1-100)."""
    aff = pod.spec.affinity
    if aff is None:
        return []
    side = aff.pod_anti_affinity if anti else aff.pod_affinity
    if side is None:
        return []
    return [(int(w.weight), w.term) for w in side.preferred
            if w.term.topology_key and w.term.label_selector is not None
            and int(w.weight) != 0]


def has_affinity(pod: Pod) -> bool:
    if _required_terms(pod, False) or _required_terms(pod, True):
        return True
    return soft_enabled() and bool(
        _preferred_terms(pod, False) or _preferred_terms(pod, True))


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class AffinityGroups:
    """One injection pass per provisioning window (Scheduler.solve); the
    match matrix runs on ``device`` (default: the CUDA device; ``"cpu"``
    runs the same torch ops on the CPU)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def inject(self, constraints: Constraints, pods: List[Pod]) -> None:
        participants = [p for p in pods if has_affinity(p)]
        if not participants:
            return
        for pod in pods:
            pod.__dict__.pop("_affinity_unsat", None)
            pod.__dict__.pop("_soft_affinity", None)

        # dedupe both matrix axes: selectors by signature (scalar-sig rows
        # keep their LabelSelector object for the oracle), peers by
        # (namespace, labels) — affinity terms scope to the pod's namespace
        selectors: List = []
        sel_idx: Dict[tuple, int] = {}
        peer_sigs: List[tuple] = []
        peer_idx: Dict[tuple, int] = {}
        pod_peer: List[int] = []

        def sel_of(sel) -> int:
            sig = feasibility.selector_signature(sel)
            key = sig if sig is not None else ("scalar", id(sel))
            i = sel_idx.get(key)
            if i is None:
                i = sel_idx[key] = len(selectors)
                selectors.append(sel)
            return i

        for pod in pods:
            sig = feasibility.labels_signature(pod.metadata.labels)
            i = peer_idx.get(sig)
            if i is None:
                i = peer_idx[sig] = len(peer_sigs)
                peer_sigs.append(sig)
            pod_peer.append(i)

        # required terms bucketed by topology key: key -> per-pod selector
        # rows for each side. Hostname first, then the valued keys in
        # sorted order — keys are independent (distinct node_selector
        # entries) so order only fixes determinism.
        n = len(pods)
        aff_by_key: Dict[str, List[List[int]]] = {}
        anti_by_key: Dict[str, List[List[int]]] = {}
        for i, pod in enumerate(pods):
            for anti, table in ((False, aff_by_key), (True, anti_by_key)):
                for t in _required_terms(pod, anti):
                    rows = table.setdefault(t.topology_key, [[] for _ in range(n)])
                    rows[i].append(sel_of(t.label_selector))

        # preferred terms: pod -> [(signed weight, key, selector row)]
        soft = soft_enabled()
        pref: List[List[Tuple[int, str, int]]] = [[] for _ in range(n)]
        if soft:
            for i, pod in enumerate(pods):
                for w, t in _preferred_terms(pod, False):
                    pref[i].append((w, t.topology_key, sel_of(t.label_selector)))
                for w, t in _preferred_terms(pod, True):
                    pref[i].append((-w, t.topology_key, sel_of(t.label_selector)))

        matrix = feasibility.affinity_match_matrix(selectors, peer_sigs, self.device)

        def matches(rows: List[int], j: int) -> bool:
            pj = pod_peer[j]
            return any(matrix[s, pj] for s in rows)

        keys = sorted(set(aff_by_key) | set(anti_by_key),
                      key=lambda k: (k != wellknown.LABEL_HOSTNAME, k))
        empty = [[] for _ in range(n)]
        for key in keys:
            self._inject_key(
                constraints, pods, key,
                aff_by_key.get(key, empty), anti_by_key.get(key, empty),
                matches)

        if soft and any(pref):
            self._soft_votes(pods, pref, matches)

    # -- required terms, one topology key ------------------------------------
    def _inject_key(self, constraints: Constraints, pods: List[Pod],
                    key: str, aff_terms: List[List[int]],
                    anti_terms: List[List[int]], matches) -> None:
        n = len(pods)
        ns = [p.metadata.namespace for p in pods]
        uf = _UnionFind(n)
        conflicts: List[Tuple[int, int]] = []
        lonely: List[int] = []  # required affinity with no peer in window
        for i in range(n):
            if not (aff_terms[i] or anti_terms[i]):
                continue
            attracted = False
            for j in range(n):
                if i == j or ns[i] != ns[j]:
                    continue
                if aff_terms[i] and matches(aff_terms[i], j):
                    uf.union(i, j)
                    attracted = True
                if anti_terms[i] and matches(anti_terms[i], j):
                    conflicts.append((i, j))
            if aff_terms[i] and not attracted and not matches(aff_terms[i], i):
                # no window peer matches and the pod can't anchor its own
                # term (kube-scheduler's first-pod rule needs a self-match);
                # a fresh node can never satisfy it — shed, don't misplace
                lonely.append(i)

        comp_pods: Dict[int, List[int]] = {}
        for i in range(n):
            comp_pods.setdefault(uf.find(i), []).append(i)
        needs_domain: Dict[int, bool] = {}
        unsat: Dict[int, bool] = {}
        for i in lonely:
            unsat[uf.find(i)] = True
        for root, members in comp_pods.items():
            needs_domain[root] = len(members) > 1 and any(
                aff_terms[i] or anti_terms[i] for i in members)
        conflict_roots: Dict[int, set] = {}
        for i, j in conflicts:
            ri, rj = uf.find(i), uf.find(j)
            if ri == rj:
                unsat[ri] = True  # must co-locate AND must separate
            else:
                needs_domain[ri] = True
                needs_domain[rj] = True
                conflict_roots.setdefault(ri, set()).add(rj)
                conflict_roots.setdefault(rj, set()).add(ri)

        if key == wellknown.LABEL_HOSTNAME:
            domains: List[str] = []
            for root, members in comp_pods.items():
                if unsat.get(root):
                    self._mark_unsat(pods, members)
                    continue
                if not needs_domain.get(root):
                    continue
                domain = secrets.token_hex(4)
                domains.append(domain)
                for i in members:
                    pods[i].spec.node_selector = {
                        **pods[i].spec.node_selector,
                        wellknown.LABEL_HOSTNAME: domain,
                    }
            if domains:
                # admit fresh domains exactly like hostname topology spread
                constraints.requirements.items.append(NodeSelectorRequirement(
                    key=wellknown.LABEL_HOSTNAME, operator="In",
                    values=domains))
            return

        # topology-valued key: domains are interned values from the window
        # constraints' vocabulary; no fresh domains, no requirement append
        vocab = constraints.requirements.requirement(key)
        chosen: Dict[int, str] = {}
        roots = sorted(comp_pods, key=lambda r: min(comp_pods[r]))
        for root in roots:
            members = comp_pods[root]
            if unsat.get(root):
                self._mark_unsat(pods, members)
                continue
            if not needs_domain.get(root):
                continue
            if vocab is None:
                # the provisioner doesn't label nodes with this key: no
                # launched node can ever satisfy the term — shed
                self._mark_unsat(pods, members)
                continue
            allowed = set(vocab)
            for i in members:
                own = pod_requirements(pods[i]).requirement(key)
                if own is not None:
                    allowed &= own
            taken = {chosen[r] for r in conflict_roots.get(root, ())
                     if r in chosen}
            pick = sorted(v for v in allowed if v not in taken)
            if not pick:
                self._mark_unsat(pods, members)  # vocabulary exhausted
                continue
            chosen[root] = pick[0]
            for i in members:
                pods[i].spec.node_selector = {
                    **pods[i].spec.node_selector, key: pick[0]}

    @staticmethod
    def _mark_unsat(pods: List[Pod], members: List[int]) -> None:
        for i in members:
            pods[i].__dict__["_affinity_unsat"] = True
            pods[i].spec.node_selector = {
                **pods[i].spec.node_selector,
                wellknown.LABEL_HOSTNAME: "",
            }

    # -- preferred terms → soft votes -----------------------------------------
    @staticmethod
    def _soft_votes(pods: List[Pod],
                    pref: List[List[Tuple[int, str, int]]], matches) -> None:
        """Each preferred term votes its signed weight once per (key, value)
        any matching same-namespace window peer is pinned to. Peers vote
        with their DETERMINED value (node_selector after required/topology
        injection), so soft scoring follows hard placement. Pods already
        proven unsatisfiable carry no votes and receive none."""
        n = len(pods)
        ns = [p.metadata.namespace for p in pods]
        for i in range(n):
            if not pref[i] or pods[i].__dict__.get("_affinity_unsat"):
                continue
            votes: Dict[Tuple[str, str], int] = {}
            for w, key, row in pref[i]:
                vals = set()
                for j in range(n):
                    if i == j or ns[i] != ns[j]:
                        continue
                    if pods[j].__dict__.get("_affinity_unsat"):
                        continue
                    if not matches([row], j):
                        continue
                    v = pods[j].spec.node_selector.get(key)
                    if v:
                        vals.add(v)
                for v in vals:
                    votes[(key, v)] = votes.get((key, v), 0) + w
            votes = {kv: w for kv, w in votes.items() if w}
            if votes:
                pods[i].__dict__["_soft_affinity"] = votes
