"""Metrics for the pipelined provisioning hot loop (solver/pipeline.py).

Four series, all on the process-wide registry (exposed with the
``karpenter_`` prefix by registry.expose()):

- ``karpenter_pipeline_depth``                 gauge — effective pipeline
  depth of the most recent provisioning window (configured depth at L0;
  collapses to 1 at pressure L1+, so a sustained 1 here under a depth-2
  config is the ladder speaking, not a bug)
- ``karpenter_pipeline_stage_seconds``         histogram, ``stage`` label —
  per-chunk wall time by stage: ``marshal`` (schedule + problem build +
  encode + async dispatch), ``device`` (blocking fetch/materialize of the
  in-flight batch), ``launch_bind`` (cloud create + node object + binds)
- ``karpenter_solver_overlap_seconds_total``   counter — cumulative seconds
  each dispatched batch spent in flight before its fetch began, i.e. device
  time hidden behind host launch/bind + marshal work. This is an upper
  bound on wall time saved versus the serial sum (the device may finish
  early inside the span); in serial mode (depth 1) it is ~0 by construction
  because every fetch immediately follows its dispatch.
- ``karpenter_pipeline_dispatch_wait_seconds`` histogram — per-chunk wait
  between dispatch completing and the fetch starting (queueing delay a
  handle experiences inside the pipeline's bounded window)

Device ring and adaptive depth:

- ``karpenter_solver_device_bytes_in_use``     gauge — bytes the CUDA
  caching allocator holds in tensors, summed over the solver mesh's
  devices (``parallel/mesh.device_bytes_in_use``); 0 without a card.
- ``karpenter_pipeline_ring_allocations_total`` counter — fresh device
  buffer allocations made by the ring (slot creation, bucket change,
  compaction re-bucket). FLAT in steady state — the zero-allocation
  acceptance gate reads this.
- ``karpenter_pipeline_ring_refills_total``    counter — in-place
  refills of existing ring buffers (the steady-state path: same device
  memory, new chunk data).

Persistent device catalog:

- ``karpenter_pipeline_ring_reuses_total``     counter — fills skipped
  entirely because the slot already holds the SAME content (token match:
  the versioned catalog encoding or identical bytes). Zero host→device
  transfer — the steady-state catalog path.

``pipeline_depth`` now reports the ADAPTIVE effective depth: the
per-window overlap measurement steps it 1↔2↔3 (solver/pipeline.py
_AdaptiveDepth), and pressure L1+ still collapses it to 1.
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

PIPELINE_DEPTH = DEFAULT.gauge(
    "pipeline_depth",
    "Effective provisioning pipeline depth of the last window "
    "(1=serial; collapses to 1 at pressure L1+)")
PIPELINE_STAGE_SECONDS = DEFAULT.histogram(
    "pipeline_stage_seconds",
    "Per-chunk pipeline stage wall time "
    "(stage=marshal|device|launch_bind)")
SOLVER_OVERLAP_SECONDS_TOTAL = DEFAULT.counter(
    "solver_overlap_seconds_total",
    "Seconds dispatched batches spent in flight while the host did other "
    "pipeline work (upper bound on wall saved vs the serial sum)")
PIPELINE_DISPATCH_WAIT_SECONDS = DEFAULT.histogram(
    "pipeline_dispatch_wait_seconds",
    "Seconds between a chunk's async dispatch completing and its fetch "
    "starting inside the pipeline window")
SOLVER_DEVICE_BYTES_IN_USE = DEFAULT.gauge(
    "solver_device_bytes_in_use",
    "Live device memory across the solver mesh in bytes "
    "(memory_stats where available, else live-buffer sizes; best-effort)")
PIPELINE_RING_ALLOCATIONS_TOTAL = DEFAULT.counter(
    "pipeline_ring_allocations_total",
    "Fresh device buffer allocations by the solver ring (slot creation / "
    "bucket change); flat in steady state")
PIPELINE_RING_REFILLS_TOTAL = DEFAULT.counter(
    "pipeline_ring_refills_total",
    "In-place donation-aliased refills of existing ring buffers "
    "(steady-state chunk intake: zero fresh device allocation)")
PIPELINE_RING_REUSES_TOTAL = DEFAULT.counter(
    "pipeline_ring_reuses_total",
    "Ring fills skipped because the slot already holds the same content "
    "(catalog token match: zero host-to-device transfer)")
