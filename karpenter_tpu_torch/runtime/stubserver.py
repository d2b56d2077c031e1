"""Stub Kubernetes API server over HTTP, backed by the port's KubeCore.

A test double, never part of the controller process: ``main.py`` does not
import it. The CPU tests and ``chip_smoke.py`` run the API client
(runtime/kubeclient.py) and the Manager against it, so every read, write
and watch crosses a socket through the port's codecs. It speaks enough of
the Kubernetes REST protocol for that: collections and items, the
spec.nodeName field selector and equality label selectors, limit/continue
paging, the binding and eviction subresources (with KubeCore's PDB
semantics), the Provisioner CRD's status subresource, DeleteOptions
preconditions and ``?watch=true`` streams. A LIST reports the newest
resourceVersion it listed (a paged one, the version of its first page, as
an API server's snapshot would) and a watch from a resourceVersion
replays only the objects changed since (a deletion in between is not
replayed: the client relists on every reconnect).

Faults, set in ``behavior`` (or over HTTP, ``POST /stub/behavior``):

- ``watch_410_next``: after the next streamed event, emit an ERROR Status
  (code 410, reason Expired) and close, the API server's watch-cache
  expiry; a kind's name instead of True arms it on that kind's watches;
- ``bookmark_next``: a BOOKMARK event after the next streamed event;
- ``throttle_429``: serve this many 429 + Retry-After: 0 answers to GETs;
- ``evict_429``: the eviction subresource answers 429;
- ``list_410_once``: a LIST with a continue token answers 410 once;
- ``list_omit_once``: the next LIST leaves out the object of this name.

``behavior["list_requests"]`` counts the LISTs served; ``counts`` counts
every request by verb and resource (``"create pods/binding"``);
``GET /stub/state`` returns both with the pods stored and bound; with
``log=True`` every request is kept as (method, path, query, body). Run ``python -m karpenter_tpu_torch.runtime.stubserver
[--port N] [--objects FILE]`` for a server of its own process: it stores the
objects of FILE as if each had been created, then prints ``{"url": ...}``
and serves until SIGTERM. FILE is a JSON list of ``{"kind": ..., "object":
<its wire form>, "names": [...]}``, one copy of the object a name, each
with a fresh uid.
"""

from __future__ import annotations

import argparse
import json
import queue as queue_mod
import signal
import sys
import threading
import time
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlsplit

from karpenter_tpu_torch.runtime.kubeclient import ROUTES, _decode, _encode
from karpenter_tpu_torch.runtime.kubecore import (
    AlreadyExists, Conflict, InternalError, KubeCore, NotFound, TooManyRequests,
)

PLURALS = {plural: kind for kind, (_, plural, _c) in ROUTES.items()}
# a LIST whose next page has not come for this long is abandoned
LIST_CHAIN_TTL_S = 30.0


class StubHandler(BaseHTTPRequestHandler):
    core: KubeCore = None
    protocol_version = "HTTP/1.1"
    # the headers and the body go out in two writes: with Nagle on, the
    # body waits for the client's delayed ACK of the headers (~40 ms a
    # request on Linux)
    disable_nagle_algorithm = True
    behavior: dict = None
    counts: Counter = None
    log: Optional[list] = None
    lock: threading.Lock = None
    # per LIST query paging now: [the earliest first page's version, the
    # LISTs paging, the last page's time]
    list_starts: dict = None
    stopping: threading.Event = None
    # a watch stream with no event for this long ends (the client relists)
    watch_idle_s: float = 5.0

    def log_message(self, *a):
        pass

    def _send(self, code, body=b""):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _parse(self):
        split = urlsplit(self.path)
        parts = [p for p in split.path.split("/") if p]
        qs = parse_qs(split.query)
        # /api/v1/... or /apis/group/v1/...
        parts = parts[2:] if parts[0] == "api" else parts[3:]
        namespace = None
        if parts and parts[0] == "namespaces":
            namespace = parts[1]
            parts = parts[2:]
        kind = PLURALS.get(parts[0]) if parts else None
        name = parts[1] if len(parts) > 1 else None
        sub = parts[2] if len(parts) > 2 else None
        return kind, namespace, name, sub, qs

    def _note(self, verb: str, kind: str, sub: Optional[str], body=None) -> None:
        resource = ROUTES[kind][1] + (f"/{sub}" if sub else "")
        with self.lock:
            self.counts[f"{verb} {resource}"] += 1
            if self.log is not None:
                split = urlsplit(self.path)
                self.log.append((self.command, split.path,
                                 {k: v for k, v in sorted(parse_qs(split.query).items())},
                                 body))

    def _namespace(self, kind, namespace):
        return "" if ROUTES[kind][2] else (namespace or "default")

    def _control(self) -> bool:
        """``/stub/state`` and ``/stub/behavior``: the test's own channel."""
        if not self.path.startswith("/stub/"):
            return False
        if self.command == "POST" and self.path == "/stub/behavior":
            update = self._body()
            with self.lock:
                self.behavior.update(update)
            self._send(200, b"{}")
        elif self.command == "GET" and self.path == "/stub/state":
            bound = self.core.scan("Pod", lambda p: bool(p.spec.node_name))
            with self.lock:
                state = {"behavior": dict(self.behavior), "counts": dict(self.counts),
                         "pods": len(bound), "pods_bound": sum(bound)}
            self._send(200, json.dumps(state).encode())
        else:
            self._send(404, b"{}")
        return True

    def do_GET(self):
        if self._control():
            return
        kind, namespace, name, _, qs = self._parse()
        watching = qs.get("watch") == ["true"]
        self._note("get" if name else "watch" if watching else "list", kind, None)
        if self.behavior.get("throttle_429", 0) > 0:
            with self.lock:
                self.behavior["throttle_429"] -= 1
            self.send_response(429)
            self.send_header("Retry-After", "0")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if name:
            try:
                obj = self.core.get(kind, name, self._namespace(kind, namespace))
            except NotFound:
                return self._send(404, b"{}")
            return self._send(200, json.dumps(_encode(obj)).encode())
        field = None
        if "fieldSelector" in qs:
            fname, fval = qs["fieldSelector"][0].split("=", 1)
            field = (fname, fval)
        if watching:
            since = qs.get("resourceVersion", [""])[0]
            return self._watch(kind, int(since) if since else None)
        if "continue" in qs and self.behavior.pop("list_410_once", None):
            # expired continue token (etcd compaction, token TTL): the API
            # server answers 410 Gone mid-pagination
            return self._send(410, b'{"kind":"Status","code":410}')
        pairs = []
        if "labelSelector" in qs:
            # equality terms only: enough for the client's match_labels
            pairs = [t.split("=", 1) for t in qs["labelSelector"][0].split(",")
                     if "=" in t and " in " not in t and " notin " not in t]
        omit = self.behavior.pop("list_omit_once", None)
        newest = [0]

        def key(o):
            if namespace is not None and o.metadata.namespace != namespace:
                return None
            if field is not None and getattr(o.spec, "node_name", None) != field[1]:
                return None
            if o.metadata.name == omit:
                # a LIST served from a watch cache that has not yet seen a
                # recent write: the object exists but is missing here
                return None
            if not all(o.metadata.labels.get(k) == v for k, v in pairs):
                return None
            newest[0] = max(newest[0], o.metadata.resource_version)
            return (o.metadata.namespace or "", o.metadata.name)

        # limit/continue over a stable ordering (the API server pages by
        # etcd key order; name order is the analog). The keys are scanned
        # without copies; only the page's objects are encoded.
        keys = sorted(k for k in self.core.scan(kind, key) if k is not None)
        limit = int(qs.get("limit", ["0"])[0] or 0)
        offset = int(qs.get("continue", ["0"])[0] or 0)
        # the newest object listed: a watch from it sees every later change
        # (a LIST that left an object out reports an older version, so the
        # watch delivers what it missed). The pages of a LIST are served at
        # different times, so while any LIST of the same query is paging
        # every page reports the version its earliest first page saw: a
        # watch from it replays each change made while the pages were read
        # (more than one LIST's changes at worst, which a level-triggered
        # client reads twice). From its last page alone, a change made
        # after an object's page was served would be in no page and in no
        # watch, and an informer cache swapped to the LIST would keep the
        # object's stale copy. A paging abandoned for LIST_CHAIN_TTL_S
        # lapses.
        chain = (kind, namespace, limit, tuple(qs.get("labelSelector", [])),
                 tuple(qs.get("fieldSelector", [])))
        more = bool(limit) and offset + limit < len(keys)
        now = time.monotonic()
        with self.lock:
            start = self.list_starts.get(chain)
            if start is not None and now - start[2] > LIST_CHAIN_TTL_S:
                del self.list_starts[chain]
                start = None
            version = newest[0] if start is None else min(newest[0], start[0])
            if offset == 0 and more:
                self.list_starts[chain] = [version, (start[1] if start else 0) + 1, now]
            elif start is not None:
                start[2] = now
                if offset and not more:
                    start[1] -= 1
                    if start[1] <= 0:
                        del self.list_starts[chain]
        meta = {"resourceVersion": str(version)}
        if more:
            page = keys[offset:offset + limit]
            meta["continue"] = str(offset + limit)
        else:
            page = keys[offset:]
        with self.lock:
            self.behavior["list_requests"] = self.behavior.get("list_requests", 0) + 1
        items = []
        for ns, name in page:
            try:
                items.append(self.core.read(kind, name, self._namespace(kind, ns), _encode))
            except NotFound:  # deleted since the scan
                pass
        body = {"kind": f"{kind}List", "metadata": meta, "items": items}
        self._send(200, json.dumps(body).encode())

    def _armed(self, key: str, kind: str) -> bool:
        """Pop a one-shot stream fault armed for every kind (True) or for
        this kind (its name)."""
        with self.lock:
            value = self.behavior.get(key)
            if value is True or value == kind:
                del self.behavior[key]
                return True
        return False

    def _watch(self, kind, since_rv=None):
        q = self.core.watch(kind, since_rv=since_rv)
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        try:
            idle = 0.0
            while not self.stopping.is_set() and idle < self.watch_idle_s:
                try:
                    event = q.get(timeout=0.2)
                except queue_mod.Empty:
                    idle += 0.2
                    continue
                idle = 0.0
                lines = [{"type": event.type, "object": _encode(event.obj)}]
                if self._armed("bookmark_next", kind):
                    lines.append({"type": "BOOKMARK", "object": {
                        "kind": kind, "metadata": {"resourceVersion": "9999"}}})
                expire = self._armed("watch_410_next", kind)
                if expire:
                    lines.append({"type": "ERROR", "object": {
                        "kind": "Status", "code": 410, "reason": "Expired",
                        "message": "too old resource version"}})
                self.wfile.write(b"".join(json.dumps(x).encode() + b"\n" for x in lines))
                self.wfile.flush()
                if expire:
                    return
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            self.core.unwatch(q)

    def _body(self):
        return json.loads(self.rfile.read(int(self.headers["Content-Length"])))

    def do_POST(self):
        if self._control():
            return
        kind, namespace, name, sub, _ = self._parse()
        body = self._body()
        self._note("create", kind, sub, body)
        if sub == "binding":
            try:
                pod = self.core.get("Pod", name, namespace)
                self.core.bind_pod(pod, body["target"]["name"])
            except NotFound:
                return self._send(404, b"{}")
            except Conflict:
                return self._send(409, b"{}")
            return self._send(201, b"{}")
        if sub == "eviction":
            if self.behavior.get("evict_429"):
                self.send_response(429)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            try:
                self.core.evict_pod(name, namespace)
            except NotFound:
                return self._send(404, b"{}")
            except TooManyRequests:
                # the eviction would breach a PodDisruptionBudget
                return self._send(429, b'{"kind":"Status","code":429,'
                                       b'"reason":"TooManyRequests"}')
            except InternalError:
                # more than one PDB matches: a misconfiguration, 500
                return self._send(500, b'{"kind":"Status","code":500,'
                                       b'"message":"found more than one '
                                       b'PodDisruptionBudget"}')
            return self._send(201, b"{}")
        try:
            created = self.core.create(_decode(kind, body))
        except AlreadyExists:
            return self._send(409, b"{}")
        self._send(201, json.dumps(_encode(created)).encode())

    def do_PUT(self):
        kind, namespace, name, sub, _ = self._parse()
        body = self._body()
        self._note("update", kind, sub, body)
        obj = _decode(kind, body)
        try:
            if kind == "Provisioner":
                # a CRD with the status subresource: the main PUT ignores
                # status changes, PUT .../status ignores all but status
                stored = self.core.get(kind, name, namespace or "default")
                if sub == "status":
                    incoming_status = obj.status
                    incoming_rv = obj.metadata.resource_version
                    obj = _decode(kind, _encode(stored))
                    obj.metadata.resource_version = incoming_rv
                    obj.status = incoming_status
                else:
                    obj.status = stored.status
            updated = self.core.update(obj)
        except Conflict:
            return self._send(409, b"{}")
        except NotFound:
            return self._send(404, b"{}")
        self._send(200, json.dumps(_encode(updated)).encode())

    def do_DELETE(self):
        kind, namespace, name, _, _ = self._parse()
        length = int(self.headers.get("Content-Length") or 0)
        opts = json.loads(self.rfile.read(length)) if length else None
        self._note("delete", kind, None, opts)
        precondition_rv = ((opts or {}).get("preconditions") or {}).get("resourceVersion")
        try:
            self.core.delete(kind, name, self._namespace(kind, namespace),
                             precondition_rv=precondition_rv)
        except Conflict:
            return self._send(409, b'{"kind":"Status","code":409}')
        except NotFound:
            return self._send(404, b"{}")
        self._send(200, b"{}")


class StubServer:
    """A running stub: ``url``, the backing ``core``, the live ``behavior``
    dict, the ``counts`` and (with ``log=True``) the request ``log``."""

    def __init__(self, core: Optional[KubeCore] = None, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None, watch_idle_s: float = 5.0,
                 log: bool = False):
        self.core = core if core is not None else KubeCore()
        self.behavior: dict = {}
        self.counts: Counter = Counter()
        self.log: Optional[List[tuple]] = [] if log else None
        self._stopping = threading.Event()
        handler = type("BoundStub", (StubHandler,), {
            "core": self.core, "behavior": self.behavior, "counts": self.counts,
            "log": self.log, "lock": threading.Lock(), "list_starts": {},
            "stopping": self._stopping,
            "watch_idle_s": watch_idle_s})
        # an API server accepts far more than the stdlib backlog of 5; the
        # Manager's worker pools overrun it (ECONNRESET under load)
        server_cls = type("Stub", (ThreadingHTTPServer,),
                          {"request_queue_size": 128, "daemon_threads": True})
        self.server = server_cls((host, port), handler)
        scheme = "http"
        if ssl_context is not None:
            self.server.socket = ssl_context.wrap_socket(self.server.socket, server_side=True)
            scheme = "https"
        name = "localhost" if host in ("127.0.0.1", "0.0.0.0") else host
        self.url = f"{scheme}://{name}:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True,
                                       name="stub-apiserver")
        self.thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop serving; open watch streams end within 0.2 s."""
        self._stopping.set()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="stub Kubernetes API server (a test double)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--watch-idle-seconds", type=float, default=5.0)
    parser.add_argument("--objects", help="a JSON list of {kind, object, names} to store first")
    args = parser.parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    core = KubeCore()
    if args.objects:
        with open(args.objects) as f:
            for item in json.load(f):
                obj = _decode(item["kind"], item["object"])
                obj.metadata.uid = ""
                for name in item["names"]:
                    obj.metadata.name = name
                    core.create(obj)
    stub = StubServer(core=core, host=args.host, port=args.port,
                      watch_idle_s=args.watch_idle_seconds)
    print(json.dumps({"url": stub.url}), flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    t0 = time.monotonic()
    stub.stop()
    print(json.dumps({"stopped_s": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
