"""Injectable clock (reference: pkg/utils/injectabletime/time.go).

The API server stamps creation and deletion times through this module so
tests can travel in time deterministically.
"""

from __future__ import annotations

import time as _time
from typing import Optional


class Clock:
    """A monotonically advancing, test-overridable clock."""

    def __init__(self):
        self._override: Optional[float] = None

    def now(self) -> float:
        return self._override if self._override is not None else _time.time()

    def set(self, t: float) -> None:
        self._override = t

    def advance(self, seconds: float) -> None:
        self._override = self.now() + seconds

    def reset(self) -> None:
        self._override = None


# Process-wide default, mirroring injectabletime.Now being a package var.
DEFAULT = Clock()


def now() -> float:
    return DEFAULT.now()
