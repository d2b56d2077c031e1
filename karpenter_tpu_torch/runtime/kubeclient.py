"""Kubernetes API-server client over stdlib HTTP.

A copy of the JAX package's client: a drop-in for runtime.kubecore.KubeCore
(the same duck-typed surface: get/read/scan/list/create/update/patch/
delete/watch/unwatch/bind_pods/evict_pod/pods_on_node) that speaks JSON to
a live API server, the production backend the reference reaches through
controller-runtime's client. It is hand-rolled on http.client: bearer-token
auth and the cluster CA for in-cluster use (``KubeApiClient.in_cluster()``,
``--kube-backend in-cluster``), plain base URLs against a stub server
(runtime/stubserver.py).

Semantics matched to KubeCore:

- optimistic concurrency: update PUTs the caller's resourceVersion, 409 is
  Conflict; patch() is read-modify-write with bounded conflict retries;
- finalizer-aware delete (the server itself stamps deletionTimestamp);
- watch(kind) returns a queue of Event(type, obj) fed by the kind's one
  background streaming thread (the LIST replayed as ADDED, then
  ?watch=true from that resourceVersion, a relist on every reconnect and
  on 410 expiry, counted in ``karpenter_watch_relist_total``);
- pods_on_node uses the server-side spec.nodeName fieldSelector;
- watched kinds are read from a watch-fed informer cache with a staleness
  bound;
- every request takes a token of the 200 QPS / 300 burst budget; a wait
  is observed in ``karpenter_kube_client_throttle_seconds`` and fed to the
  pressure monitor's throttle signal.

Two differences from the JAX package's client: a pod this client binds
takes its node in the informer cache at once (``_cache_bound``), where the
JAX package's cache waits for the watch event; and every watch of a kind
shares one stream and its decoded objects (controller-runtime's shared
informer), where the JAX package's client opens a LIST and a stream, and
decodes every object, once for each watch.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import queue
import random
import socket
import ssl
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import quote, urlencode, urlsplit

from karpenter_tpu_torch.api import codec, codec_core
from karpenter_tpu_torch.api.core import LabelSelector, Pod
from karpenter_tpu_torch.metrics.pressure import KUBE_CLIENT_THROTTLE_SECONDS
from karpenter_tpu_torch.metrics.recovery import WATCH_RELIST_TOTAL
from karpenter_tpu_torch.pressure.monitor import get_monitor
from karpenter_tpu_torch.runtime.kubecore import (
    AlreadyExists, ApiError, Conflict, Event, InternalError, NotFound,
    TooManyRequests,
)
from karpenter_tpu_torch.utils.fastcopy import deep_copy
from karpenter_tpu_torch.utils.ratelimit import TokenBucket
from karpenter_tpu_torch.utils.resources import parse_resource_list

log = logging.getLogger("karpenter.kubeclient")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ResourceExpired(ApiError):
    """HTTP 410 Gone / watch ERROR with reason=Expired: the requested
    resourceVersion fell out of the server's watch cache (the most common
    real-apiserver watch failure). Recovery = re-list + re-watch from the
    fresh resourceVersion; the watch loop does that immediately."""


# binding POSTs in flight at once within one bind_pods call
BIND_WORKERS = 8

WATCH_BACKOFF_BASE_S = 1.0
WATCH_BACKOFF_CAP_S = 30.0


def _reconnect_delay(attempt: int, rand=None) -> float:
    """Equal-jitter exponential backoff for watch reconnects: ceiling =
    min(cap, base·2^(attempt−1)), delay uniform in [ceiling/2, ceiling].

    A fixed 1 s pause meant every watcher of a crashed apiserver
    reconnected in lockstep at 1 Hz forever — a reconnect stampede on
    recovery and no deference during a long outage. Equal jitter (vs full
    jitter's [0, ceiling]) keeps a floor of half the ceiling, so attempt 1
    still retries within 0.5–1 s — a transient blip stays cheap — while a
    persistent outage decays to ~15–30 s probes. The first successful
    re-list resets the attempt counter. ``rand`` is injectable so tests
    pin the jitter."""
    ceiling = min(WATCH_BACKOFF_CAP_S,
                  WATCH_BACKOFF_BASE_S * (2 ** max(0, attempt - 1)))
    return (rand or random).uniform(ceiling / 2, ceiling)

# kind → (api prefix, plural, cluster-scoped)
ROUTES: Dict[str, Tuple[str, str, bool]] = {
    "Pod": ("/api/v1", "pods", False),
    "Node": ("/api/v1", "nodes", True),
    "ConfigMap": ("/api/v1", "configmaps", False),
    "Secret": ("/api/v1", "secrets", False),
    "PersistentVolumeClaim": ("/api/v1", "persistentvolumeclaims", False),
    "PersistentVolume": ("/api/v1", "persistentvolumes", True),
    "DaemonSet": ("/apis/apps/v1", "daemonsets", False),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", False),
    "StorageClass": ("/apis/storage.k8s.io/v1", "storageclasses", True),
    "Provisioner": ("/apis/karpenter.sh/v1alpha5", "provisioners", False),
}


def _decode(kind: str, obj: Dict) -> object:
    if kind == "Provisioner":
        p = codec.provisioner_from_manifest(obj)
        p.metadata.resource_version = int(
            (obj.get("metadata") or {}).get("resourceVersion") or 0)
        status = obj.get("status") or {}
        p.status.resources = parse_resource_list(
            {k: str(v) for k, v in (status.get("resources") or {}).items()})
        return p
    return codec_core.decode(kind, obj)


def _merge(raw: Dict, enc: Dict) -> Dict:
    """Deep-merge encoded (owned) fields onto the server's raw JSON: dicts
    recurse, everything else (incl. lists) is replaced. Owned list/dict
    fields are always present in the encoding — even empty — so their
    removal is expressible; absent keys mean 'unmodeled, preserve'."""
    out = dict(raw)
    for k, v in enc.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _encode(obj) -> Dict:
    if obj.kind == "Provisioner":
        manifest = codec.provisioner_to_manifest(obj)
        if obj.metadata.resource_version:
            manifest["metadata"]["resourceVersion"] = str(
                obj.metadata.resource_version)
        # status (resources for the limits check, conditions for health)
        # is emitted by provisioner_to_manifest itself — overriding it
        # here would drop conditions on every real-client write and turn
        # the condition refresh into a self-sustaining watch loop
        return manifest
    return codec_core.encode_obj(obj)


class _WatchStream:
    """Severable handle on one live watch stream. Holds BOTH the
    HTTPConnection and the raw socket captured at request time: for a
    close-delimited response http.client detaches the socket inside
    getresponse() (conn.sock → None while the response keeps the fd via
    makefile), so conn alone is not enough to interrupt a blocked read."""

    __slots__ = ("conn", "sock")

    def __init__(self, conn: http.client.HTTPConnection):
        self.conn = conn
        self.sock = None  # filled in right after conn.request()


class KubeApiClient:
    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        timeout: float = 30.0,
        qps: float = 200.0,
        burst: int = 300,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        # the reference's kube API budget (options.go:39-40)
        self._limiter = TokenBucket(qps, burst)
        split = urlsplit(self.base_url)
        self._host = split.hostname or "localhost"
        self._port = split.port or (443 if split.scheme == "https" else 80)
        self._https = split.scheme == "https"
        if self._https:
            if insecure:
                self._ssl = ssl._create_unverified_context()
            else:
                self._ssl = ssl.create_default_context(cafile=ca_file)
        else:
            self._ssl = None
        self._watch_threads: List[threading.Thread] = []
        self._watch_stop = threading.Event()
        # the queues each kind's stream delivers to, swapped whole on a
        # change; the stream's cache writes and deliveries, and a watch
        # joining a running stream with its snapshot, take _fanout_lock, so
        # a late watch misses no event
        self._subscribers: Dict[str, List["queue.Queue[Event]"]] = {}
        self._fanout_lock = threading.Lock()
        # live streaming connection per kind's stream (keyed by its feeder
        # queue's id), so unwatch() can close it and unblock the thread's
        # read immediately (not after the 300 s socket timeout)
        self._watch_conns: Dict[int, "_WatchStream"] = {}
        # one persistent keep-alive connection PER THREAD: the controller
        # plane issues thousands of small requests per provisioning pass,
        # and a connection per request both costs a TCP handshake each and
        # overruns the apiserver's accept backlog under the 64-worker
        # selection plane (observed as ECONNRESET at 1k-pod wire load)
        self._local = threading.local()
        # chunked LISTs (reflector default): pages of this many items via
        # limit/continue; 0 = unpaginated single response
        self.list_page_size: int = 500
        # informer read cache (the controller-runtime cached-client analog,
        # the reference's client cache/indexer): kinds with an active watch
        # serve get/list/scan/read from watch-fed local state instead of
        # the wire. The Go reference reads its informer cache for free —
        # without this, the selection plane's requeue re-verification GETs
        # alone saturate the 200 QPS budget at the 10k-pod regime. Writes
        # (update/patch/delete/create) always go to the server; staleness
        # semantics match controller-runtime (optimistic concurrency
        # conflicts catch stale writes; patch re-reads LIVE).
        # kind → {(namespace, name): object}; "" is a cluster-scoped kind's
        # namespace. Entries are replaced whole, never changed in place, and
        # a kind's dict is swapped whole on a relist, so a reader takes a
        # reference with one dict lookup (atomic under the GIL) and reads
        # or copies it without the lock; the lock serializes the writers
        # and the walks over a kind. The JAX package takes the lock for
        # every read and copies under it: at 10k pods its 64 selection
        # workers convoy on it and the provisioning worker's binds wait.
        self._cache_lock = threading.Lock()
        self._read_cache: Dict[str, Dict[Tuple[str, str], object]] = {}
        # the cached pods of each node (the spec.nodeName field selector)
        self._pods_by_node: Dict[str, set] = {}
        # SINGLE-WRITER cache: one stream per kind writes it, keyed by its
        # "feeder" (the queue of the first watch opened for the kind) — its
        # LIST and stream run sequentially in one thread, so snapshot
        # replaces can never race a concurrent stream's deletes (the
        # classic informer resync hazard). Later watches of the kind share
        # that stream. A kind serves reads only after its stream's first
        # LIST lands (_cached_kinds).
        self._cache_feeder: Dict[str, int] = {}   # kind → id(feeder queue)
        self._cached_kinds: set = set()           # kinds safe to serve
        # staleness bound (controller-runtime informers resync; this client
        # instead stops SERVING a kind whose feeder stream has been down
        # longer than this — reads fall through live until the reconnect
        # re-list lands, so a partitioned watch cannot serve ever-staler
        # pods/nodes to the selection/provisioning planes indefinitely)
        self._cache_down_since: Dict[str, float] = {}
        # bind_pods' POSTs, each thread on its own keep-alive connection;
        # made at the first bind, ended by stop_watches()
        self._binder: Optional[ThreadPoolExecutor] = None
        self._binder_lock = threading.Lock()
        self.cache_staleness_s: float = 30.0

    @classmethod
    def in_cluster(cls, qps: float = 200.0, burst: int = 300) -> "KubeApiClient":
        """Build from the pod service account (the in-cluster default)."""
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(f"{SERVICE_ACCOUNT_DIR}/token") as f:
            token = f.read().strip()
        return cls(f"https://{host}:{port}", token=token,
                   ca_file=f"{SERVICE_ACCOUNT_DIR}/ca.crt",
                   qps=qps, burst=burst)

    # -- transport -----------------------------------------------------------
    def _conn(self, timeout: Optional[float] = None) -> http.client.HTTPConnection:
        if self._https:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout or self.timeout,
                context=self._ssl)
        return http.client.HTTPConnection(
            self._host, self._port, timeout=timeout or self.timeout)

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        h = {"Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if content_type:
            h["Content-Type"] = content_type
        return h

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 content_type: str = "application/json",
                 _throttle_retries: int = 2) -> Dict:
        waited = self._limiter.acquire()
        if waited > 0:
            # bucket saturation is a first-class pressure signal: the
            # control plane is producing API calls faster than its budget
            KUBE_CLIENT_THROTTLE_SECONDS.observe(waited)
            get_monitor().note_throttle(waited)
        payload = json.dumps(body) if body is not None else None
        headers = self._headers(content_type if body is not None else None)
        # transport ring: a stale keep-alive (server closed it idle) or a
        # reset mid-flight gets ONE retry on a fresh connection — client-go
        # does the same; a connection blip must not fail a reconcile.
        # Non-idempotent POSTs are only retried when the failure happened
        # BEFORE the request was fully sent (send-phase errors) — and to
        # keep POSTs off stale sockets in the first place, a connection
        # idle past the typical server keep-alive window is proactively
        # replaced (a small request body writes "successfully" into a
        # half-closed socket, so the send-phase guard alone can't see it).
        now = time.monotonic()
        if getattr(self._local, "conn", None) is not None and \
                now - getattr(self._local, "last_used", 0.0) > 30.0:
            self._drop_conn()
        self._local.last_used = now
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = self._local.conn = self._conn()
            sent = False
            try:
                conn.request(method, path, body=payload, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                break
            except (ConnectionError, http.client.HTTPException, OSError) as e:
                self._drop_conn()
                retriable = method in ("GET", "PUT", "DELETE") or not sent
                if attempt == 0 and retriable:
                    continue
                raise ApiError(f"{method} {path}: transport failure: {e}")
        try:
            if resp.status == 404:
                raise NotFound(f"{method} {path}: not found")
            if resp.status == 409:
                if method == "POST":
                    raise AlreadyExists(f"{method} {path}: already exists")
                raise Conflict(f"{method} {path}: conflict")
            if resp.status == 410:
                raise ResourceExpired(f"{method} {path}: gone (410)")
            if resp.status == 429:
                # only the eviction subresource uses 429 to mean "PDB would
                # be violated" (typed TooManyRequests so the eviction queue
                # mirrors eviction.go:94-101); anywhere else it is
                # API-Priority-and-Fairness throttling — honor Retry-After
                # and retry in place
                if path.split("?")[0].endswith("/eviction"):
                    raise TooManyRequests(
                        f"{method} {path}: too many requests (PDB)")
                if _throttle_retries > 0:
                    retry_after = resp.getheader("Retry-After")
                    try:
                        delay = max(0.0, min(float(retry_after), 5.0))
                    except (TypeError, ValueError):
                        delay = 1.0
                    time.sleep(delay)
                    return self._request(method, path, body, content_type,
                                         _throttle_retries - 1)
                raise ApiError(f"{method} {path}: HTTP 429: rate limited")
            if resp.status == 500:
                # typed for the eviction queue's PDB-misconfiguration
                # branch (eviction.go:94-97); InternalError is an ApiError,
                # so all other 500 handling is unchanged
                raise InternalError(
                    f"{method} {path}: HTTP 500: {data[:300]!r}")
            if resp.status >= 300:
                raise ApiError(
                    f"{method} {path}: HTTP {resp.status}: {data[:300]!r}")
            return json.loads(data) if data else {}
        except http.client.HTTPException:
            # response-state confusion on the shared connection: drop it so
            # the next request starts clean
            self._drop_conn()
            raise

    # -- paths ---------------------------------------------------------------
    def _collection(self, kind: str, namespace: Optional[str]) -> str:
        prefix, plural, cluster = ROUTES[kind]
        if cluster or namespace is None:
            return f"{prefix}/{plural}"
        return f"{prefix}/namespaces/{quote(namespace)}/{plural}"

    def _item(self, kind: str, name: str, namespace: str) -> str:
        prefix, plural, cluster = ROUTES[kind]
        if cluster:
            return f"{prefix}/{plural}/{quote(name)}"
        return f"{prefix}/namespaces/{quote(namespace or 'default')}/{plural}/{quote(name)}"

    # -- CRUD ----------------------------------------------------------------
    def _cache_is_serving(self, kind: str) -> bool:
        """A kind serves reads only while its feeder stream is connected or
        down for less than the staleness bound (single lookups: no lock
        needed)."""
        if kind not in self._cached_kinds:
            return False
        down = self._cache_down_since.get(kind)
        return down is None or (
            time.monotonic() - down < self.cache_staleness_s)

    def _cache_list(self, kind: str, namespace, label_selector, field):
        """List served from the watch-fed cache when the kind is watched
        (controller-runtime cached-client List semantics); None = go live."""
        if field is not None and (field[0] != "spec.nodeName" or kind != "Pod"):
            return None  # unsupported locally: go live
        with self._cache_lock:
            if not self._cache_is_serving(kind):
                return None
            objs = self._read_cache.get(kind, {})
            if field is not None:
                objs = [objs[k] for k in self._pods_by_node.get(field[1], ())]
            else:
                objs = list(objs.values())
        return [deep_copy(obj) for obj in objs
                if (namespace is None or obj.metadata.namespace == namespace)
                and (label_selector is None or label_selector.matches(obj.metadata.labels))]

    def scan(self, kind: str, fn):
        """KubeCore.scan analog. Cache-served kinds snapshot the object
        references under the lock, then map OUTSIDE it — ``fn`` may call
        back into the client (get/list take the same non-reentrant lock),
        and entries are replaced wholesale, never mutated in place, so the
        read-only contract holds without holding the lock."""
        with self._cache_lock:
            objs = (list(self._read_cache.get(kind, {}).values())
                    if self._cache_is_serving(kind) else None)
        if objs is not None:
            return [fn(obj) for obj in objs]
        return [fn(obj) for obj in self.list(kind)]

    def read(self, kind: str, name: str, namespace: str, fn):
        """KubeCore.read analog: cache-served when watched; a miss falls
        through live (a just-created object may not have reached the watch
        yet). ``fn`` runs outside the lock (see scan)."""
        obj = self._cache_ref(kind, name, namespace)
        if obj is not None:
            return fn(obj)
        return fn(self._get_live(kind, name, namespace))

    def _cache_key(self, kind: str, name: str,
                   namespace: Optional[str]) -> Tuple[str, str]:
        return ("" if ROUTES[kind][2] else (namespace or "default"), name)

    def _cache_ref(self, kind: str, name: str, namespace: Optional[str]):
        """The cached object itself (not a copy), or None; lock-free (see
        ``_read_cache``)."""
        if not self._cache_is_serving(kind):
            return None
        return self._read_cache.get(kind, {}).get(self._cache_key(kind, name, namespace))

    def _cache_lookup(self, kind: str, name: str, namespace: Optional[str]):
        obj = self._cache_ref(kind, name, namespace)
        return deep_copy(obj) if obj is not None else None

    def _cache_put(self, kind: str, key, obj) -> None:
        """Call under _cache_lock: store ``obj`` (None drops the entry)
        and keep the pods' node index."""
        objs = self._read_cache.setdefault(kind, {})
        old = objs.pop(key, None) if obj is None else objs.get(key)
        if obj is not None:
            objs[key] = obj
        if kind != "Pod":
            return
        was = old.spec.node_name if old is not None else ""
        now = obj.spec.node_name if obj is not None else ""
        if was != now and was:
            on = self._pods_by_node.get(was)
            if on is not None:
                on.discard(key)
                if not on:
                    del self._pods_by_node[was]
        if now:
            self._pods_by_node.setdefault(now, set()).add(key)

    def _cache_drop_kind(self, kind: str) -> None:
        """Call under _cache_lock."""
        self._read_cache.pop(kind, None)
        if kind == "Pod":
            self._pods_by_node = {}

    def _cache_store(self, kind: str, obj, qid: int) -> None:
        """Store the stream's decoded object itself: the watches' events
        carry the same object, and neither is ever changed in place."""
        key = self._cache_key(kind, obj.metadata.name, obj.metadata.namespace)
        with self._cache_lock:
            if self._cache_feeder.get(kind) != qid:
                return  # a stream the kind no longer has
            self._cache_put(kind, key, obj)

    def _cache_delete(self, kind: str, obj, qid: int) -> None:
        key = self._cache_key(kind, obj.metadata.name, obj.metadata.namespace)
        with self._cache_lock:
            if self._cache_feeder.get(kind) != qid:
                return
            self._cache_put(kind, key, None)

    def _cache_replace_kind(self, kind: str, objs, qid: int) -> None:
        """Swap in the feeder's fresh LIST snapshot (purges objects deleted
        during a watch gap) and mark the kind cache-served. A non-feeder or
        already-unwatched queue (stop_watches raced the LIST) writes
        nothing — stale threads can never re-seed a purged cache."""
        fresh = {self._cache_key(kind, o.metadata.name, o.metadata.namespace): o
                 for o in objs}
        by_node: Dict[str, set] = {}
        if kind == "Pod":
            for key, obj in fresh.items():
                if obj.spec.node_name:
                    by_node.setdefault(obj.spec.node_name, set()).add(key)
        with self._cache_lock:
            if self._cache_feeder.get(kind) != qid:
                return
            # swapped whole: a lock-free reader sees the old snapshot or the
            # new one, never a kind half refilled
            self._read_cache[kind] = fresh
            if kind == "Pod":
                self._pods_by_node = by_node
            self._cached_kinds.add(kind)
            self._cache_down_since.pop(kind, None)  # fresh snapshot landed

    def get(self, kind: str, name: str, namespace: str = "default"):
        cached = self._cache_lookup(kind, name, namespace)
        if cached is not None:
            return cached
        # miss falls through LIVE (an object created moments ago may not
        # have reached the watch yet — strictly fresher than an informer)
        return self._get_live(kind, name, namespace)

    def _get_live(self, kind: str, name: str, namespace: str = "default"):
        return _decode(kind, self._request("GET", self._item(kind, name, namespace)))

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[LabelSelector] = None,
             field: Optional[Tuple[str, str]] = None) -> List:
        cached = self._cache_list(kind, namespace, label_selector, field)
        if cached is not None:
            return cached
        params = {}
        if label_selector is not None:
            parts = [f"{k}={v}" for k, v in label_selector.match_labels.items()]
            for e in label_selector.match_expressions:
                if e.operator == "In":
                    parts.append(f"{e.key} in ({','.join(e.values)})")
                elif e.operator == "NotIn":
                    parts.append(f"{e.key} notin ({','.join(e.values)})")
                elif e.operator == "Exists":
                    parts.append(e.key)
                elif e.operator == "DoesNotExist":
                    parts.append(f"!{e.key}")
                else:
                    raise ApiError(f"unsupported selector operator {e.operator}")
            params["labelSelector"] = ",".join(parts)
        if field is not None:
            params["fieldSelector"] = f"{field[0]}={field[1]}"
        items, _ = self._list_pages(self._collection(kind, namespace), params)
        return [_decode(kind, item) for item in items]

    def _list_pages(self, path: str, params: Dict[str, str]):
        """Chunked LIST (client-go reflector semantics): request
        ``limit=list_page_size`` and follow ``metadata.continue`` until the
        snapshot is exhausted. A big cluster's 50k-pod collection comes
        back as bounded responses instead of one giant body; the returned
        resourceVersion identifies the consistent snapshot (every page
        carries the same one) and seeds the subsequent watch."""
        for attempt in range(3):
            items: List[Dict] = []
            rv = ""
            cont = None
            try:
                while True:
                    q = dict(params)
                    if self.list_page_size:
                        q["limit"] = str(self.list_page_size)
                    if cont:
                        q["continue"] = cont
                    body = self._request(
                        "GET", path + ("?" + urlencode(q) if q else ""))
                    items.extend(body.get("items", []))
                    meta = body.get("metadata") or {}
                    rv = meta.get("resourceVersion", rv) or rv
                    cont = meta.get("continue")
                    if not cont:
                        return items, rv
            except ResourceExpired:
                # continue token expired mid-pagination (etcd compaction /
                # token TTL on a slow multi-page list) — client-go's
                # ListPager restarts with a fresh list; so do we, bounded
                if attempt == 2:
                    raise
                log.info("paginated list %s expired mid-walk; restarting",
                         path)

    def create(self, obj):
        path = self._collection(obj.kind, obj.metadata.namespace)
        return _decode(obj.kind, self._request("POST", path, _encode(obj)))

    def update(self, obj):
        """Read-merge-write: the codec models a SUBSET of each kind, so a
        bare re-encode would erase server-side fields it does not know
        (kubelet-owned node fields, defaulted pod fields, …). The current
        raw JSON is fetched and the encoded (owned) fields merged onto it;
        the caller's resourceVersion is what gets PUT, so optimistic
        concurrency still conflicts on staleness."""
        path = self._item(obj.kind, obj.metadata.name, obj.metadata.namespace)
        raw = self._request("GET", path)
        merged = _merge(raw, _encode(obj))
        merged.setdefault("metadata", {})["resourceVersion"] = str(
            obj.metadata.resource_version)
        if obj.kind == "Provisioner" and "status" in merged:
            # the CRD declares the status subresource: the main PUT ignores
            # status, so it must be written separately
            status = merged["status"]
            out = self._request("PUT", path, merged)
            merged["metadata"]["resourceVersion"] = (
                out.get("metadata") or {}).get("resourceVersion", "0")
            merged["status"] = status
            try:
                out = self._request("PUT", path + "/status", merged)
            except NotFound:  # stub servers without the subresource
                pass
            return _decode(obj.kind, out)
        return _decode(obj.kind, self._request("PUT", path, merged))

    def patch(self, kind: str, name: str, namespace: str,
              fn: Callable[[object], None], retries: int = 4):
        """Read-modify-write with bounded optimistic-concurrency retries
        (KubeCore.patch holds a lock; a real server needs the retry loop)."""
        last: Optional[Conflict] = None
        for _ in range(retries):
            # LIVE read: a cached (stale) object would re-conflict until
            # the watch catches up — the write path never reads the cache
            obj = self._get_live(kind, name, namespace)
            fn(obj)
            try:
                return self.update(obj)
            except Conflict as e:
                last = e
        raise last or Conflict(f"patch {kind} {namespace}/{name}: retries exhausted")

    def delete(self, kind: str, name: str, namespace: str = "default",
               precondition_rv=None):
        body = None
        if precondition_rv is not None:
            # DeleteOptions with preconditions — the apiserver answers 409
            # when the live resourceVersion no longer matches
            body = {"apiVersion": "v1", "kind": "DeleteOptions",
                    "preconditions": {
                        "resourceVersion": str(precondition_rv)}}
        return self._request(
            "DELETE", self._item(kind, name, namespace), body) or None

    # -- raw access ----------------------------------------------------------
    # For kinds without a modeled codec (e.g. admissionregistration
    # webhook configurations, patched by the webhook's cert reconciler).
    def get_raw(self, path: str) -> Dict:
        return self._request("GET", path)

    def put_raw(self, path: str, body: Dict) -> Dict:
        return self._request("PUT", path, body)

    # -- subresources --------------------------------------------------------
    def bind_pod(self, pod: Pod, node_name: str) -> None:
        path = self._item("Pod", pod.metadata.name, pod.metadata.namespace) + "/binding"
        self._request("POST", path, {
            "apiVersion": "v1", "kind": "Binding",
            "metadata": {"name": pod.metadata.name,
                         "namespace": pod.metadata.namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
        })
        self._cache_bound(pod, node_name)

    def _cache_bound(self, pod: Pod, node_name: str) -> None:
        """Read your own binds: the cached copy of a pod this client bound
        takes its node at once, before the watch delivers the bind. The
        JAX package's cache waits for the watch, which lags a window's
        binds by seconds at 10k pods: the selection requeue and the next
        window's provisionability check then read the pods as Pending and
        solve, launch and bind them again (ROADMAP §C). A later watch event
        or relist snapshot replaces the entry as before."""
        key = self._cache_key("Pod", pod.metadata.name, pod.metadata.namespace)
        with self._cache_lock:
            cached = self._read_cache.get("Pod", {}).get(key)
        if cached is None or cached.spec.node_name:
            return
        bound = deep_copy(cached)
        bound.spec.node_name = node_name
        with self._cache_lock:
            # unless the watch got there first; entries are replaced whole
            if self._read_cache.get("Pod", {}).get(key) is cached:
                self._cache_put("Pod", key, bound)

    def bind_pods(self, pods: List[Pod], node_name: str) -> List[str]:
        """Bulk-bind parity with kubecore.bind_pods: the real API has no
        batch Binding verb, so this is one POST per pod with per-pod error
        capture, up to BIND_WORKERS at once, as the reference binds a node's
        pods in parallel (workqueue.ParallelizeUntil, provisioner.go:
        159-198; the JAX package's client posts them one after another).
        The errors come in the pods' order."""
        def bind(pod) -> Optional[str]:
            try:
                self.bind_pod(pod, node_name)
            except ApiError as e:
                return f"pod {pod.metadata.namespace}/{pod.metadata.name}: {e}"
            return None

        if len(pods) > 1:
            with self._binder_lock:
                if self._binder is None:
                    self._binder = ThreadPoolExecutor(BIND_WORKERS,
                                                      thread_name_prefix="kube-bind")
                binder = self._binder
            outcomes = list(binder.map(bind, pods))
        else:
            outcomes = [bind(pod) for pod in pods]
        return [e for e in outcomes if e is not None]

    def evict_pod(self, name: str, namespace: str = "default") -> None:
        path = self._item("Pod", name, namespace) + "/eviction"
        self._request("POST", path, {
            "apiVersion": "policy/v1", "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        })

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return self.list("Pod", namespace=None,
                         field=("spec.nodeName", node_name))

    def scan_pods_on_node(self, node_name: str, fn) -> List:
        """KubeCore.scan_pods_on_node analog: ``fn`` on the cached pods of
        the node's index, outside the lock and without copying (see scan);
        a kind not cache-served lists live."""
        with self._cache_lock:
            if self._cache_is_serving("Pod"):
                objs = self._read_cache.get("Pod", {})
                pods = [objs[k] for k in self._pods_by_node.get(node_name, ())]
            else:
                pods = None
        if pods is None:
            pods = self.pods_on_node(node_name)
        return [fn(p) for p in pods]

    # -- watch ---------------------------------------------------------------
    def watch(self, kind: Optional[str] = None,
              meta_only: bool = False) -> "queue.Queue[Event]":
        """Streamed watch with informer semantics: LIST replayed as ADDED,
        then ?watch=true from the list's resourceVersion. EVERY reconnect
        redoes the LIST — a watch without a resourceVersion replays
        nothing, so events from the disconnect gap would otherwise be lost
        (controllers are level-triggered, so duplicate ADDEDs are safe).

        The first watch of a kind starts its stream; a later one joins it
        and gets the cached snapshot as ADDED (or the first LIST, if it has
        not landed yet): a stream for each watch would decode every pod
        once a watch, five times for the Manager's five Pod watches, the
        controller's largest GIL cost at 10k pods. Events carry the stream's
        decoded objects, shared by every watch of the kind and the read
        cache: read-only, as scan's are (``meta_only`` is accepted for
        kubecore.watch signature parity and has nothing left to skip)."""
        assert kind is not None, "the API client watches one kind at a time"
        q: "queue.Queue[Event]" = queue.Queue()
        with self._fanout_lock:
            subscribers = self._subscribers.get(kind)
            if subscribers:
                if kind in self._cached_kinds:
                    for obj in list(self._read_cache.get(kind, {}).values()):
                        q.put(Event("ADDED", obj))
                self._subscribers[kind] = subscribers + [q]
                return q
            self._subscribers[kind] = [q]
            with self._cache_lock:
                # the first watch for the kind keys its stream and cache
                self._cache_feeder[kind] = id(q)
        t = threading.Thread(target=self._watch_loop, args=(kind, q),
                             daemon=True, name=f"watch-{kind}")
        t.start()
        self._watch_threads.append(t)
        return q

    @staticmethod
    def _sever(entry) -> None:
        """Force-unblock any thread reading this stream: close() alone does
        not reliably interrupt a concurrent recv(); shutdown() does. The
        shutdown must target the RAW socket captured at request time
        (entry.sock), not conn.sock — a close-delimited watch response
        (no Content-Length, no chunking) makes http.client detach the
        socket from the connection inside getresponse() (conn.sock becomes
        None, the response keeps the fd via makefile), so a conn-level
        shutdown silently misses the fd the stream thread is blocked on."""
        for sock in (entry.sock, entry.conn.sock):
            if sock is None:
                continue
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            entry.conn.close()
        except OSError:
            pass

    def unwatch(self, q) -> None:
        """Stop delivery (KubeCore parity); the last watch of a kind also
        ends its stream: severing the live connection unblocks the thread
        from its streaming read so it exits now, and the kind's reads go
        live again."""
        with self._fanout_lock:
            kind = next((k for k, subscribers in self._subscribers.items()
                         if any(w is q for w in subscribers)), None)
            if kind is None:
                return
            rest = [w for w in self._subscribers[kind] if w is not q]
            if rest:
                self._subscribers[kind] = rest
                return
            self._subscribers.pop(kind, None)
            with self._cache_lock:
                qid = self._cache_feeder.pop(kind, None)
                self._cached_kinds.discard(kind)
                self._cache_down_since.pop(kind, None)
                self._cache_drop_kind(kind)
        conn = self._watch_conns.pop(qid, None) if qid is not None else None
        if conn is not None:
            self._sever(conn)

    def stop_watches(self) -> None:
        """End every watch (its thread and stream) and the bind pool's
        threads."""
        self._watch_stop.set()
        with self._binder_lock:
            binder, self._binder = self._binder, None
        if binder is not None:
            binder.shutdown(wait=True)
        with self._fanout_lock:
            self._subscribers.clear()
            with self._cache_lock:
                self._cache_feeder.clear()
                self._cached_kinds.clear()
                self._cache_down_since.clear()
                self._read_cache.clear()
                self._pods_by_node.clear()
        for key in list(self._watch_conns):
            conn = self._watch_conns.pop(key, None)
            if conn is not None:
                self._sever(conn)

    def _mark_feeder_down(self, kind: str, qid: int) -> None:
        with self._cache_lock:
            if self._cache_feeder.get(kind) == qid:
                self._cache_down_since.setdefault(kind, time.monotonic())

    def _watch_active(self, kind: str, qid: int) -> bool:
        """Whether the stream keyed ``qid`` is still the kind's."""
        return not self._watch_stop.is_set() and self._cache_feeder.get(kind) == qid

    def _watch_loop(self, kind: str, feeder: "queue.Queue[Event]") -> None:
        # the stream is keyed by its feeder's id; the thread holds the
        # feeder, so the id is not reused while the stream can still run
        qid = id(feeder)
        path = self._collection(kind, None)
        attempt = 0
        # None until the first snapshot lands; after that every further
        # pass is a full relist-and-reconcile forced by a gap — counted by
        # reason: "expired" (410, resourceVersion aged out of the watch
        # cache) vs "reconnect" (stream ended or errored)
        relist_reason: Optional[str] = None
        while self._watch_active(kind, qid):
            try:
                raw_items, rv = self._list_pages(path, {})
                attempt = 0  # fresh snapshot landed: the server is back
                objs = [_decode(kind, item) for item in raw_items]
                with self._fanout_lock:
                    if not self._watch_active(kind, qid):
                        return
                    # seed/refresh the read cache from the LIST snapshot and
                    # mark the kind cache-served (readers never see a
                    # partial snapshot); a re-list after a watch gap purges
                    # deletions
                    self._cache_replace_kind(kind, objs, qid)
                    if relist_reason is not None:
                        WATCH_RELIST_TOTAL.inc(kind=kind, reason=relist_reason)
                    events = [Event("ADDED", obj) for obj in objs]
                    for q in self._subscribers.get(kind, ()):
                        for event in events:
                            q.put(event)
                relist_reason = "reconnect"
                try:
                    self._stream(kind, path, rv, qid)
                finally:
                    # stream ended (server close, outage, unwatch): start
                    # the staleness clock — reads go live once it exceeds
                    # cache_staleness_s, until the reconnect re-list lands
                    self._mark_feeder_down(kind, qid)
            except ResourceExpired as e:
                # 410/Expired means our resourceVersion aged out of the
                # watch cache — a full re-list is REQUIRED and sufficient.
                # A short pause (vs the 1 s outage backoff below) guards
                # against a server that answers 410 persistently: without
                # it the loop would re-list at the full QPS budget and
                # flood the queue with duplicate ADDEDs
                if not self._watch_active(kind, qid):
                    return
                log.info("watch %s expired, resyncing: %s", kind, e)
                relist_reason = "expired"
                self._watch_stop.wait(0.2)
            except (ApiError, OSError, ValueError,
                    http.client.HTTPException) as e:
                # HTTPException covers IncompleteRead (truncated chunked
                # stream) and ResponseNotReady (unwatch closing the conn
                # mid-handshake) — an uncaught one would kill this thread
                # while the queue stays registered, silently ending all
                # events for the kind
                if not self._watch_active(kind, qid):
                    return
                attempt += 1
                delay = _reconnect_delay(attempt)
                log.debug("watch %s reconnecting in %.2fs (attempt %d): %s",
                          kind, delay, attempt, e)
                self._watch_stop.wait(delay)

    def _stream(self, kind: str, path: str, rv: str, qid: int) -> None:
        # bookmarks are requested as keepalive traffic only: this client
        # DELIBERATELY does not resume from a bookmark rv — every reconnect
        # re-lists (watch loop above), which doubles as the informer-cache
        # resync (purges deletions missed in the gap). rv-resume would need
        # the reflector's gap-replay machinery (and a 410 fallback) for a
        # benefit the 5-min catalog cadence doesn't demand.
        params = {"watch": "true", "allowWatchBookmarks": "true"}
        if rv:
            params["resourceVersion"] = rv
        conn = self._conn(timeout=300.0)
        entry = _WatchStream(conn)
        self._watch_conns[qid] = entry
        try:
            if not self._watch_active(kind, qid):
                return  # unwatch raced the re-list; never open the stream
            conn.request("GET", path + "?" + urlencode(params),
                         headers=self._headers())
            # capture the raw socket NOW: getresponse() may detach it from
            # the connection (close-delimited response), after which only
            # this reference lets unwatch() interrupt the blocking read
            entry.sock = conn.sock
            if not self._watch_active(kind, qid):
                return  # unwatch raced between registration and connect
            resp = conn.getresponse()
            if resp.status == 410:
                raise ResourceExpired(f"watch {kind}: gone (410)")
            if resp.status >= 300:
                raise ApiError(f"watch {kind}: HTTP {resp.status}")
            buf = b""
            while self._watch_active(kind, qid):
                chunk = resp.read1(65536)
                if not chunk:
                    return  # server closed; reconnect (re-list first)
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    event = json.loads(line)
                    etype = event.get("type", "")
                    if etype == "ERROR":
                        # the in-band expiry signal: a Status object with
                        # code 410 / reason Expired mid-stream
                        obj = event.get("object") or {}
                        if (obj.get("code") == 410
                                or obj.get("reason") in ("Expired", "Gone")):
                            raise ResourceExpired(f"watch {kind}: {obj}")
                        raise ApiError(f"watch {kind}: {obj}")
                    if etype == "BOOKMARK":
                        # periodic resourceVersion checkpoint (sent when
                        # allowWatchBookmarks is requested): not an object
                        # event — it must neither touch the cache nor
                        # enqueue a reconcile (the decoded object is an
                        # empty shell whose "" name would reconcile junk)
                        continue
                    obj = _decode(kind, event.get("object") or {})
                    with self._fanout_lock:
                        if not self._watch_active(kind, qid):
                            return
                        if etype == "DELETED":
                            self._cache_delete(kind, obj, qid)
                        elif etype in ("ADDED", "MODIFIED"):
                            self._cache_store(kind, obj, qid)
                        out = Event(etype, obj)
                        for q in self._subscribers.get(kind, ()):
                            q.put(out)
        finally:
            # sever the entry itself (not just whatever is still in the
            # dict): if unwatch already popped it, the pop here is a no-op
            # but the socket still needs closing from this side
            if self._watch_conns.get(qid) is entry:
                del self._watch_conns[qid]
            self._sever(entry)
