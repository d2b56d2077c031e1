"""Solver profiling: ``torch.profiler`` ranges around the solve.

The reference's only latency visibility is its Prometheus histograms; the
port keeps that trio (metrics/registry.py) and, as the JAX package does
with ``jax.profiler.TraceAnnotation``, labels the solve's device stages:

- ``trace(name)``: a ``torch.profiler.record_function`` range. It shows
  in a ``torch.profiler`` session beside the kernels launched inside it,
  and becomes an NVTX range under ``torch.autograd.profiler.emit_nvtx``.
  Near-zero cost when no profiler is active. A range attributes the
  kernels it *launches*: a CUDA launch is asynchronous, so a range around
  a dispatch holds its kernels and a range around a fetch holds only the
  copies it waits on.

The JAX package's ``start_server`` (the jax.profiler HTTP server that its
``main.py`` starts) has no counterpart until the port has its entry
points; there, a ``torch.profiler`` session is started in-process.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def trace(name: str):
    """Label a solver stage in profiler traces (``record_function``)."""
    with torch.profiler.record_function(name):
        yield
