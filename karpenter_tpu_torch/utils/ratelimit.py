"""Token-bucket rate limiter.

A copy of the JAX package's module. Reference budgets enforced with it:
the kube client's 200 QPS / 300 burst (options.go:39-40,
cmd/controller/main.go:66; runtime/kubeclient.py) and EC2 CreateFleet's
2 QPS / 100 burst (aws/cloudprovider.go:41-46).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Optional


class TokenBucket:
    """Blocking token bucket: ``acquire()`` waits until a token is
    available. ``burst`` tokens accumulate at ``qps`` per second."""

    def __init__(self, qps: float, burst: int,
                 timefunc: Optional[Callable[[], float]] = None,
                 sleepfunc: Optional[Callable[[float], None]] = None):
        assert qps > 0 and burst >= 1
        self.qps = float(qps)
        self.burst = float(burst)
        self._now = timefunc or _time.monotonic
        self._sleep = sleepfunc or _time.sleep
        self._tokens = self.burst
        self._last = self._now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._now()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        """Non-blocking: take a token if available."""
        with self._lock:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def acquire(self, n: float = 1.0) -> float:
        """Blocking: returns the seconds waited."""
        waited = 0.0
        while True:
            with self._lock:
                self._refill()
                if self._tokens >= n:
                    self._tokens -= n
                    return waited
                need = (n - self._tokens) / self.qps
            self._sleep(need)
            waited += need
