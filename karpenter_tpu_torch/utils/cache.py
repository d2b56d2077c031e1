"""TTL cache keyed on the injectable clock.

A copy of the JAX package's module. Reference: the go-cache instances threaded through the AWS provider
(pkg/cloudprovider/aws/cloudprovider.go:47-55, instancetypes.go:35-41).
Reading time through utils.clock lets TTL tests time-travel the same way
the reference swaps injectabletime.Now.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from karpenter_tpu_torch.utils import clock


class TTLCache:
    """A small thread-safe expiring map (go-cache equivalent)."""

    def __init__(self, ttl_seconds: float):
        self.ttl = ttl_seconds
        self._data: Dict[Any, Tuple[float, Any]] = {}
        self._lock = threading.Lock()

    def get(self, key) -> Optional[Any]:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return None
            expires, value = entry
            if clock.now() >= expires:
                del self._data[key]
                return None
            return value

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def set(self, key, value) -> None:
        """Insert or refresh; always extends the TTL (the reference calls
        SetDefault even on repeat ICE errors to extend the window,
        instancetypes.go:189-192)."""
        with self._lock:
            self._data[key] = (clock.now() + self.ttl, value)

    def delete(self, key) -> None:
        with self._lock:
            self._data.pop(key, None)

    def flush(self) -> None:
        with self._lock:
            self._data.clear()

    def keys(self):
        return [k for k in list(self._data) if self.get(k) is not None]
