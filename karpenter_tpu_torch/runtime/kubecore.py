"""In-memory Kubernetes API server for the port's controllers.

A trimmed copy of the JAX package's store (``runtime/kubecore.py``): the
API-server semantics the provisioning path reads and writes, in process.

- create, get, read and scan (no copy), list, patch (read-modify-write
  under the store lock) and delete, with a monotonically increasing
  resourceVersion.
- Delete sets deletionTimestamp when finalizers are present; the object is
  only removed once its finalizer list empties.
- Watch: per-subscriber event queues with ADDED/MODIFIED/DELETED.
- Field index on pod spec.nodeName for O(1) pods-on-node lookups.
- Binding subresource for pods: one pod (``bind_pod``, the stub API
  server's binding POST), or a node's worth under one lock.
- Eviction subresource with PodDisruptionBudget semantics (``evict_pod``),
  over namespace indexes of pods and PDBs.

Objects live in per-kind stripes, each with its own RLock; a stripe's dict
IS the by-kind index. The stripe-creation guard is never acquired while a
stripe lock is held; an operation over two kinds (the eviction) takes
their stripes in sorted order. ``_watchers`` is copy-on-write:
``watch``/``unwatch`` replace it under ``_watch_lock`` and ``_notify``
iterates a snapshot. resourceVersion is one shared ``itertools.count``.
Delete takes the resourceVersion precondition (the stub API server's
DeleteOptions). Left out, since no port controller calls them yet:
meta-only watches and the single-lock reference layout.
"""

from __future__ import annotations

import itertools
import queue
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.api.core import LabelSelector, Pod
from karpenter_tpu_torch.utils import clock
from karpenter_tpu_torch.utils.fastcopy import deep_copy


class ApiError(Exception):
    pass


class NotFound(ApiError):
    pass


class AlreadyExists(ApiError):
    pass


class Conflict(ApiError):
    pass


class TooManyRequests(ApiError):
    """HTTP 429 from the eviction subresource: the eviction would violate a
    PodDisruptionBudget."""


class InternalError(ApiError):
    """HTTP 500: for eviction, the PDB configuration is ambiguous (more than
    one PodDisruptionBudget selects the pod, or one sets both fields)."""


def _scaled_int_or_percent(value, expected: int, pdb_name: str) -> int:
    """apimachinery's GetScaledValueFromIntOrPercent with roundUp=true:
    integers pass through; "N%" resolves to ceil(N × expected / 100).
    Anything else is a malformed PDB → 500."""
    if isinstance(value, bool):  # bool is an int subclass; reject explicitly
        raise InternalError(f"PDB {pdb_name}: invalid IntOrString {value!r}")
    if isinstance(value, int):
        return value
    if isinstance(value, str) and value.endswith("%"):
        try:
            percent = int(value[:-1])
        except ValueError:
            raise InternalError(
                f"PDB {pdb_name}: invalid percentage {value!r}")
        return -((-percent * expected) // 100)  # ceil for non-negative
    raise InternalError(f"PDB {pdb_name}: invalid IntOrString {value!r}")


@dataclass
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    obj: object


Key = Tuple[str, str, str]  # (kind, namespace, name)


class _Meta:
    """Metadata stub carried by meta-only watch events."""

    __slots__ = ("name", "namespace")

    def __init__(self, name: str, namespace: str):
        self.name = name
        self.namespace = namespace


class MetaObj:
    """Lightweight object for meta-only watches: kind + metadata
    (name/namespace) and nothing else. Watch pumps that only enqueue
    reconcile keys (runtime/manager.py) read exactly these fields, so they
    are spared a deep copy of the object per event."""

    __slots__ = ("kind", "metadata")

    def __init__(self, kind: str, name: str, namespace: str):
        self.kind = kind
        self.metadata = _Meta(name, namespace)


def _key(obj) -> Key:
    return (obj.kind, obj.metadata.namespace, obj.metadata.name)


class _Stripe:
    """One kind's slice of the store: its lock and its objects. The dict
    doubles as the by-kind index, so list-by-kind never filters."""

    __slots__ = ("key", "lock", "objects")

    def __init__(self, key: str):
        self.key = key
        self.lock = threading.RLock()
        self.objects: Dict[Key, object] = {}


class KubeCore:
    """Threadsafe in-memory object store with API-server semantics, striped
    by kind (see the module docstring)."""

    def __init__(self):
        # stripe map: created on first touch of a kind, never removed.
        # _stripes_guard orders stripe creation against the watch(None)
        # world-snapshot; plain dict reads are the lock-free fast path
        # (stripes are add-only, and dict get is atomic under the GIL).
        self._stripes: Dict[str, _Stripe] = {}
        self._stripes_guard = threading.Lock()
        self._rv = itertools.count(1)
        self._uid = itertools.count(1)
        self._watch_lock = threading.Lock()
        self._watchers: List[Tuple[Optional[str], "queue.Queue[Event]", bool]] = []
        # the spec.nodeName field index: node name → pod keys, maintained on
        # every pod mutation so pods_on_node is O(pods on that node). Inner
        # dicts are ordered sets, so iteration keeps insertion order. Only
        # ever touched under the Pod stripe's lock.
        self._pods_by_node: Dict[str, Dict[Key, None]] = {}
        # namespace indexes for the eviction subresource's PDB lookup and
        # healthy count; namespace is part of the key, so they change only
        # on create and delete. Pod index under the Pod stripe's lock, PDB
        # index under the PodDisruptionBudget stripe's lock.
        self._pods_by_namespace: Dict[str, Dict[Key, None]] = {}
        self._pdbs_by_namespace: Dict[str, Dict[Key, None]] = {}

    # -- stripes -------------------------------------------------------------
    def _stripe(self, kind: str) -> _Stripe:
        s = self._stripes.get(kind)
        if s is None:
            with self._stripes_guard:
                s = self._stripes.setdefault(kind, _Stripe(kind))
        return s

    @contextmanager
    def _multi_stripe(self, *kinds: str):
        """The stripes of ``kinds``, locked in sorted order. Every stripe is
        resolved before any lock is taken, so the creation guard is never
        acquired under a stripe lock."""
        ordered = [self._stripe(k) for k in sorted(set(kinds))]
        for s in ordered:
            s.lock.acquire()
        try:
            yield
        finally:
            for s in reversed(ordered):
                s.lock.release()

    @contextmanager
    def _world(self):
        """Every existing stripe, locked in sorted order, with stripe
        creation blocked (guard held) — the watch(kind=None) initial-replay
        snapshot. A create of a brand-new kind waits on the guard until
        the watcher is registered, so its ADDED cannot be lost between the
        replay and the registration."""
        with self._stripes_guard:
            ordered = [self._stripes[k] for k in sorted(self._stripes)]
            for s in ordered:
                s.lock.acquire()
            try:
                yield ordered
            finally:
                for s in reversed(ordered):
                    s.lock.release()

    # -- helpers ------------------------------------------------------------
    def _next_rv(self) -> int:
        return next(self._rv)

    def _reindex(self, key: Key, old, new) -> None:
        """Maintain the nodeName and namespace indexes across any mutation.
        Caller holds the subject kind's stripe lock."""
        kind, ns = key[0], key[1]
        if kind == "PodDisruptionBudget":
            self._ns_index(self._pdbs_by_namespace, ns, key, old, new)
            return
        if kind != "Pod":
            return
        self._ns_index(self._pods_by_namespace, ns, key, old, new)
        old_node = old.spec.node_name if old is not None else None
        new_node = new.spec.node_name if new is not None else None
        if old_node == new_node:
            return
        if old_node:
            bucket = self._pods_by_node.get(old_node)
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del self._pods_by_node[old_node]
        if new_node:
            self._pods_by_node.setdefault(new_node, {})[key] = None

    @staticmethod
    def _ns_index(index: Dict[str, Dict[Key, None]], ns: str, key: Key,
                  old, new) -> None:
        """Add or remove ``key`` in a namespace index; updates are no-ops."""
        if old is None and new is not None:
            index.setdefault(ns, {})[key] = None
        elif new is None and old is not None:
            bucket = index.get(ns)
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del index[ns]

    def _notify(self, event_type: str, obj) -> None:
        # safe with or without any stripe lock held: _watchers is
        # copy-on-write, so iterating a snapshot reference cannot see a
        # resize
        meta = None
        for kind, q, meta_only in self._watchers:
            if kind is None or kind == obj.kind:
                if meta_only:
                    if meta is None:
                        meta = MetaObj(obj.kind, obj.metadata.name, obj.metadata.namespace)
                    q.put(Event(event_type, meta))
                else:
                    q.put(Event(event_type, deep_copy(obj)))

    # -- watch --------------------------------------------------------------
    def watch(self, kind: Optional[str] = None, meta_only: bool = False,
              since_rv: Optional[int] = None) -> "queue.Queue[Event]":
        """Subscribe to events for a kind (None = all). Existing objects are
        replayed as ADDED, matching informer initial-list semantics; with
        ``since_rv`` only those changed after that resourceVersion (a watch
        that resumes from a LIST, as the stub API server's does).
        ``meta_only`` delivers :class:`MetaObj` stubs (kind + name/namespace)
        instead of deep copies, for subscribers that only enqueue keys.
        Registration is atomic with the replay against the subject
        stripe(s), so a concurrent write lands either in the replay OR as a
        later event — never lost, never torn."""
        q: "queue.Queue[Event]" = queue.Queue()

        def _replay(objects) -> None:
            for obj in objects:
                if since_rv is not None and obj.metadata.resource_version <= since_rv:
                    continue
                if kind is None or obj.kind == kind:
                    stub = (MetaObj(obj.kind, obj.metadata.name, obj.metadata.namespace)
                            if meta_only else deep_copy(obj))
                    q.put(Event("ADDED", stub))

        if kind is None:
            with self._world() as stripes:
                for s in stripes:
                    _replay(s.objects.values())
                with self._watch_lock:
                    self._watchers = self._watchers + [(kind, q, meta_only)]
        else:
            s = self._stripe(kind)
            with s.lock:
                _replay(s.objects.values())
                with self._watch_lock:
                    self._watchers = self._watchers + [(kind, q, meta_only)]
        return q

    def unwatch(self, q) -> None:
        with self._watch_lock:
            self._watchers = [w for w in self._watchers if w[1] is not q]

    # -- CRUD ---------------------------------------------------------------
    def create(self, obj):
        s = self._stripe(obj.kind)
        with s.lock:
            k = _key(obj)
            if k in s.objects:
                raise AlreadyExists(f"{k} already exists")
            obj = deep_copy(obj)
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.uid = obj.metadata.uid or f"uid-{next(self._uid)}"
            if obj.metadata.creation_timestamp is None:
                obj.metadata.creation_timestamp = clock.now()
            s.objects[k] = obj
            self._reindex(k, None, obj)
            self._notify("ADDED", obj)
            return deep_copy(obj)

    def get(self, kind: str, name: str, namespace: str = "default"):
        s = self._stripe(kind)
        with s.lock:
            obj = s.objects.get((kind, namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return deep_copy(obj)

    def scan(self, kind: str, fn) -> List:
        """Apply ``fn`` to every live object of ``kind`` under the kind's
        stripe lock, WITHOUT copying, and return the results. ``fn`` must
        treat the object as read-only and must not retain it."""
        s = self._stripe(kind)
        with s.lock:
            return [fn(obj) for obj in s.objects.values()]

    def read(self, kind: str, name: str, namespace: str, fn):
        """Apply ``fn`` to one live object under the stripe lock (no copy);
        raises NotFound. Same read-only contract as :meth:`scan`."""
        s = self._stripe(kind)
        with s.lock:
            obj = s.objects.get((kind, namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return fn(obj)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
        field: Optional[Tuple[str, str]] = None,
    ) -> List:
        """List objects. ``field`` supports the spec.nodeName pod index."""
        s = self._stripe(kind)
        with s.lock:
            if field is not None:
                fname, fval = field
                if fname != "spec.nodeName":
                    raise ApiError(f"unsupported field selector {fname}")
                if kind == "Pod":
                    # indexed path: only this node's pods are touched (the
                    # index holds Pod keys, which live in this stripe)
                    candidates = [s.objects[key] for key in
                                  self._pods_by_node.get(fval, ())]
                else:
                    candidates = [o for o in s.objects.values()
                                  if getattr(o.spec, "node_name", None) == fval]
            else:
                candidates = list(s.objects.values())
            out = []
            for obj in candidates:
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if label_selector is not None and not label_selector.matches(obj.metadata.labels):
                    continue
                out.append(deep_copy(obj))
            return out

    def patch(self, kind: str, name: str, namespace: str, fn: Callable[[object], None]):
        """Read-modify-write with retry-free server-side apply semantics:
        fn mutates the live copy under the stripe lock."""
        s = self._stripe(kind)
        with s.lock:
            stored = s.objects.get((kind, namespace, name))
            if stored is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            obj = deep_copy(stored)
            fn(obj)
            obj.metadata.deletion_timestamp = stored.metadata.deletion_timestamp
            obj.metadata.resource_version = self._next_rv()
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                del s.objects[(kind, namespace, name)]
                self._reindex((kind, namespace, name), stored, None)
                self._notify("DELETED", obj)
                return deep_copy(obj)
            s.objects[(kind, namespace, name)] = obj
            self._reindex((kind, namespace, name), stored, obj)
            self._notify("MODIFIED", obj)
            return deep_copy(obj)

    def update(self, obj):
        """Full update with optimistic concurrency (a stale resourceVersion
        raises Conflict); finalizer-empty deleted objects are removed. The
        leader elector's lease renewal is its caller."""
        s = self._stripe(obj.kind)
        with s.lock:
            k = _key(obj)
            stored = s.objects.get(k)
            if stored is None:
                raise NotFound(f"{k} not found")
            if obj.metadata.resource_version != stored.metadata.resource_version:
                raise Conflict(
                    f"{k}: stale resourceVersion "
                    f"{obj.metadata.resource_version} != {stored.metadata.resource_version}")
            obj = deep_copy(obj)
            # deletionTimestamp is immutable via update
            obj.metadata.deletion_timestamp = stored.metadata.deletion_timestamp
            obj.metadata.resource_version = self._next_rv()
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                del s.objects[k]
                self._reindex(k, stored, None)
                self._notify("DELETED", obj)
                return deep_copy(obj)
            s.objects[k] = obj
            self._reindex(k, stored, obj)
            self._notify("MODIFIED", obj)
            return deep_copy(obj)

    def delete(self, kind: str, name: str, namespace: str = "default",
               precondition_rv=None):
        """Delete; with finalizers present, only stamps deletionTimestamp.
        ``precondition_rv``: DeleteOptions.preconditions.resourceVersion —
        the delete conflicts unless the live object still carries exactly
        this resourceVersion."""
        s = self._stripe(kind)
        with s.lock:
            return self._delete_locked(s, kind, name, namespace, precondition_rv)

    def _delete_locked(self, s: _Stripe, kind: str, name: str, namespace: str,
                       precondition_rv=None):
        """Delete body; the caller holds ``s``'s lock (the eviction holds
        the Pod and PDB stripes, so its check-then-delete is one step)."""
        k = (kind, namespace, name)
        stored = s.objects.get(k)
        if stored is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        if precondition_rv is not None and \
                str(stored.metadata.resource_version) != str(precondition_rv):
            raise Conflict(
                f"{kind} {namespace}/{name}: delete precondition failed "
                f"(resourceVersion {stored.metadata.resource_version} "
                f"!= {precondition_rv})")
        if stored.metadata.finalizers:
            if stored.metadata.deletion_timestamp is None:
                # k8s semantics: deletionTimestamp = request time + the
                # pod's grace period (a FUTURE time)
                grace = getattr(getattr(stored, "spec", None),
                                "termination_grace_period_seconds", 0) or 0
                stored.metadata.deletion_timestamp = clock.now() + grace
                stored.metadata.resource_version = self._next_rv()
                self._notify("MODIFIED", stored)
            return deep_copy(stored)
        del s.objects[k]
        self._reindex(k, stored, None)
        self._notify("DELETED", stored)
        return deep_copy(stored)

    # -- subresources -------------------------------------------------------
    def bind_pod(self, pod: Pod, node_name: str) -> None:
        """Binding subresource: sets spec.nodeName exactly once (a bound
        pod conflicts)."""
        s = self._stripe("Pod")
        with s.lock:
            k = ("Pod", pod.metadata.namespace, pod.metadata.name)
            stored = s.objects.get(k)
            if stored is None:
                raise NotFound(f"pod {k} not found")
            if stored.spec.node_name:
                raise Conflict(f"pod {pod.metadata.name} already bound to {stored.spec.node_name}")
            stored.spec.node_name = node_name
            stored.metadata.resource_version = self._next_rv()
            self._reindex(k, None, stored)  # was unbound: nothing to remove
        self._notify("MODIFIED", stored)

    def bind_pods(self, pods: List[Pod], node_name: str) -> List[str]:
        """Bulk binding: bind every pod to ``node_name`` under ONE lock
        acquisition (a node's worth of binds — the provisioning hot loop
        previously paid a lock round-trip and watcher fan-out per pod).
        Returns per-pod error strings for the pods that failed; successful
        pods are bound (spec.nodeName set once) and notified."""
        errs: List[str] = []
        bound: List[object] = []
        s = self._stripe("Pod")
        with s.lock:
            for pod in pods:
                k = ("Pod", pod.metadata.namespace, pod.metadata.name)
                stored = s.objects.get(k)
                if stored is None:
                    errs.append(f"pod {k} not found")
                    continue
                if stored.spec.node_name:
                    errs.append(f"pod {pod.metadata.name} already bound "
                                f"to {stored.spec.node_name}")
                    continue
                stored.spec.node_name = node_name
                stored.metadata.resource_version = self._next_rv()
                self._reindex(k, None, stored)  # was unbound
                bound.append(stored)
        # notify OUTSIDE the lock: full-copy watchers pay a deep copy per
        # event, and a node's worth of copies inside the critical section
        # would stall every concurrent read behind the bind (review r5).
        # An event may therefore carry object state slightly NEWER than the
        # bind it announces (same coalescing a real informer's watch cache
        # performs); controllers here are level-triggered by design.
        for stored in bound:
            self._notify("MODIFIED", stored)
        return errs

    def evict_pod(self, name: str, namespace: str = "default") -> None:
        """Eviction subresource with PodDisruptionBudget semantics:

        - more than one PDB selects the pod → 500 InternalError;
        - the one PDB sets both minAvailable and maxUnavailable → 500;
        - evicting would drop the PDB's healthy selected pods below its
          desired count → 429 TooManyRequests;
        - otherwise the pod is deleted.

        A pod is healthy when it is scheduled (spec.nodeName set) and not
        terminating (no deletionTimestamp). Both fields are IntOrString; a
        percentage resolves against the selected pods of the namespace,
        rounded up, and maxUnavailable gives desired = expected − resolved.
        The Pod and PodDisruptionBudget stripes are held together, in sorted
        order, across the check and the delete, so that two evictions
        cannot both pass the budget check."""
        pod_stripe = self._stripe("Pod")
        pdb_stripe = self._stripe("PodDisruptionBudget")
        with self._multi_stripe("Pod", "PodDisruptionBudget"):
            pod = pod_stripe.objects.get(("Pod", namespace, name))
            if pod is not None:
                matching = []
                for pk in self._pdbs_by_namespace.get(namespace, ()):
                    o = pdb_stripe.objects[pk]
                    if o.selector is not None and o.selector.matches(pod.metadata.labels):
                        matching.append(o)
                if len(matching) > 1:
                    raise InternalError(
                        f"pod {namespace}/{name}: found more than one "
                        f"PodDisruptionBudget ({len(matching)}) — misconfigured")
                min_a = matching[0].min_available if matching else None
                max_u = matching[0].max_unavailable if matching else None
                if min_a is not None and max_u is not None:
                    raise InternalError(
                        f"pod {namespace}/{name}: PDB {matching[0].metadata.name} "
                        "sets both minAvailable and maxUnavailable — misconfigured")
                if min_a is not None or max_u is not None:
                    pdb = matching[0]
                    expected = healthy = 0
                    for pk in self._pods_by_namespace.get(namespace, ()):
                        o = pod_stripe.objects[pk]
                        if not pdb.selector.matches(o.metadata.labels):
                            continue
                        expected += 1
                        if o.spec.node_name and o.metadata.deletion_timestamp is None:
                            healthy += 1
                    if min_a is not None:
                        desired = _scaled_int_or_percent(min_a, expected, pdb.metadata.name)
                    else:
                        desired = expected - _scaled_int_or_percent(
                            max_u, expected, pdb.metadata.name)
                    # evicting a pod that is not counted healthy moves nothing
                    loss = 1 if (pod.spec.node_name
                                 and pod.metadata.deletion_timestamp is None) else 0
                    if healthy - loss < desired:
                        raise TooManyRequests(
                            f"pod {namespace}/{name}: eviction would violate PDB "
                            f"{pdb.metadata.name} ({healthy} healthy, {desired} required)")
            self._delete_locked(pod_stripe, "Pod", name, namespace)

    # -- convenience indexes -------------------------------------------------
    def pods_on_node(self, node_name: str) -> List[Pod]:
        return self.list("Pod", namespace=None, field=("spec.nodeName", node_name))

    def scan_pods_on_node(self, node_name: str, fn) -> List:
        """Apply ``fn`` to every pod bound to ``node_name`` (the index, no
        copy) under the Pod stripe's lock. Same read-only contract as
        :meth:`scan`."""
        s = self._stripe("Pod")
        with s.lock:
            return [fn(s.objects[key]) for key in self._pods_by_node.get(node_name, ())]
