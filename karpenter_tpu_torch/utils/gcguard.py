"""Defer Python's garbage collector out of the solve.

The solve allocates heavily (the marshal's gathers, shape groups, packing
records); a generational collection landing mid-solve adds to the tail.
:class:`gc_deferred` holds collection inside the solve and lets it run
between provisioning passes, where nobody waits on it.

Reentrant and thread-safe: a depth counter tracks nested and concurrent
sections, and collection comes back on only when the last one exits. If
the application had already turned collection off, the guard leaves it
alone.
"""

from __future__ import annotations

import gc
import threading

_lock = threading.Lock()
_depth = 0
_we_disabled = False


class gc_deferred:
    """Context manager: collection off inside, restored when the outermost
    section exits."""

    def __enter__(self):
        global _depth, _we_disabled
        with _lock:
            if _depth == 0 and gc.isenabled():
                gc.disable()
                _we_disabled = True
            _depth += 1
        return self

    def __exit__(self, *exc):
        global _depth, _we_disabled
        with _lock:
            _depth -= 1
            if _depth == 0 and _we_disabled:
                gc.enable()
                _we_disabled = False
        return False
