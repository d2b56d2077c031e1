"""Lease-based leader election.

Reference: cmd/controller/main.go:80-81 enables controller-runtime's leader
election so only one replica provisions. Same protocol here over
coordination.k8s.io/v1 Leases (client-go semantics, simplified): acquire if
absent or expired, renew while leading, step down on a lost renewal.
Time flows through utils.clock so tests travel in time deterministically.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from karpenter_tpu_torch.api.core import Lease, LeaseSpec, ObjectMeta
from karpenter_tpu_torch.runtime.kubecore import AlreadyExists, ApiError, Conflict, NotFound
from karpenter_tpu_torch.utils import clock

log = logging.getLogger("karpenter.leaderelection")

LEASE_NAME = "karpenter-leader-election"


class LeaderElector:
    def __init__(
        self,
        kube,
        identity: str,
        namespace: str = "default",
        lease_name: str = LEASE_NAME,
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.kube = kube
        self.identity = identity
        self.namespace = namespace
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes election rounds against stop()'s release so an
        # in-flight round can't re-acquire a lease stop() just released
        self._round_lock = threading.Lock()

    # -- protocol ------------------------------------------------------------
    def try_acquire_or_renew(self) -> bool:
        """One election round; returns whether we hold the lease now."""
        if self._stop.is_set():
            return False
        now = clock.now()
        try:
            lease = self.kube.get("Lease", self.lease_name, self.namespace)
        except NotFound:
            lease = Lease(
                metadata=ObjectMeta(name=self.lease_name, namespace=self.namespace),
                spec=LeaseSpec(holder_identity=self.identity,
                               lease_duration_seconds=int(self.lease_duration),
                               acquire_time=now, renew_time=now))
            try:
                self.kube.create(lease)
                return True
            except (AlreadyExists, Conflict):
                return False  # raced; next round re-reads

        spec = lease.spec
        expired = spec.renew_time is None or now - spec.renew_time > self.lease_duration
        if spec.holder_identity != self.identity and not expired:
            return False
        try:
            if spec.holder_identity != self.identity:
                spec.acquire_time = now  # takeover of an expired lease
                spec.holder_identity = self.identity
            spec.renew_time = now
            self.kube.update(lease)
            return True
        except (Conflict, NotFound):
            return False  # raced with another candidate
        except ApiError as e:
            log.warning("lease update failed: %s", e)
            return False

    # -- loop ----------------------------------------------------------------
    def run(self) -> None:
        """Blocks until stop(): campaigns, then renews. Transitions fire the
        callbacks; losing the lease while leading is fatal for the
        callbacks' owner (main.py exits and is restarted)."""
        while not self._stop.is_set():
            try:
                with self._round_lock:
                    held = self.try_acquire_or_renew()
            except Exception as e:  # noqa: BLE001 — a transient API error
                # must DEMOTE, not kill the thread: a silently dead elector
                # that believes it leads is the split brain this exists to
                # prevent
                log.warning("election round failed: %s", e)
                held = False
            if held and not self._leading:
                self._leading = True
                log.info("became leader: %s", self.identity)
                if self.on_started_leading:
                    self.on_started_leading()
            elif not held and self._leading:
                self._leading = False
                log.error("lost leadership: %s", self.identity)
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            self._stop.wait(self.renew_period if held else min(self.renew_period, 2.0))

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True, name="leader-election")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # wait out any in-flight round (it sees _stop and cannot acquire),
        # THEN release — otherwise a concurrent round could re-acquire the
        # lease about to be given up, stranding it on a dead identity
        with self._round_lock:
            # best-effort release so the next candidate needn't wait out
            # the full lease (client-go's ReleaseOnCancel); unconditional:
            # the patch no-ops unless we are the recorded holder
            released = []
            try:
                def release(lease):
                    if lease.spec.holder_identity == self.identity:
                        lease.spec.holder_identity = ""
                        lease.spec.renew_time = None
                        released.append(True)
                self.kube.patch("Lease", self.lease_name, self.namespace, release)
            except ApiError:
                pass
            if released:
                log.info("released lease %s/%s: %s", self.namespace, self.lease_name,
                         self.identity)
            self._leading = False
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(self.renew_period + 1.0)

    def is_leader(self) -> bool:
        return self._leading

    def wait_for_leadership(self, timeout: Optional[float] = None,
                            interrupt: Optional[threading.Event] = None) -> bool:
        """Block until this candidate leads (or timeout, or ``interrupt`` is
        set — e.g. the process's SIGTERM event, so a standby replica parked
        here still honors shutdown). Campaigning must already be running
        via start(). The deadline runs on wall time: this waits on real
        threads, not the injectable test clock."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            if interrupt is not None and interrupt.is_set():
                return False
            if self._leading:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            self._stop.wait(0.05)
        return False
