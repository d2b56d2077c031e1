"""Boot warm-up and the kernel library directory.

A cold process pays, inside its first window, the build of three
libraries (the pack kernel and the what-if kernel with nvcc, the native
host ring with the C++ compiler), their loads, the CUDA context and the
first launch of each bucket. Two measures, both wired from
config/options.py:

- :func:`configure_compilation_cache` points the library directory
  (``build_dir.PATH``) at a durable directory. The libraries are
  named by their sources' digests, so a restart loads them instead of
  building: the port's counterpart of JAX's persistent compilation cache.
- :func:`warmup_pass` (``--solver-warmup``) builds and loads the three
  libraries, then walks the (shape bucket × type bucket) ladder with a
  throwaway one-pod problem per bucket, through the entries the serving
  path launches: ``pack_chunk`` with ``compute_maxfit`` (the solo solve),
  ``pack_batch`` (a batched window) and, with ``include_ring``, a solo
  ``models.ffd.DeviceRun`` whose ``DeviceRing`` slot stays resident, so a
  first solve at that bucket refills it instead of allocating.

The ladder defaults to the buckets real windows land in first (shapes ≤
``DEFAULT_WARM_MAX_SHAPES``, types ≤ ``DEFAULT_WARM_MAX_TYPES``), shape
buckets largest first: the ring keeps ``DeviceRing.max_slots`` slots, so
the smallest shape buckets are the ones left resident.

Unlike the JAX package, which warms on a background thread and logs and
swallows every failure (an XLA compile takes 20–40 s there), a warm-up
error raises: main.py runs the pass before any controller starts, so a
broken card or build fails the boot instead of the first window. The
builds are cached by digest and a bucket is one launch, so the pass is
short.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import build_dir
from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.solver.solve import SolverConfig

log = logging.getLogger("karpenter.solver.warmup")

DEFAULT_WARM_MAX_SHAPES = 2048
DEFAULT_WARM_MAX_TYPES = 256


def default_ladder():
    """The default (shape buckets, type buckets): shapes ≤
    DEFAULT_WARM_MAX_SHAPES largest first, types ≤ DEFAULT_WARM_MAX_TYPES."""
    from karpenter_tpu_torch.ops.encode import SHAPE_BUCKETS, TYPE_BUCKETS

    return (sorted((b for b in SHAPE_BUCKETS if b <= DEFAULT_WARM_MAX_SHAPES), reverse=True),
            [b for b in TYPE_BUCKETS if b <= DEFAULT_WARM_MAX_TYPES])


def configure_compilation_cache(cache_dir: str) -> bool:
    """Build and load the kernel libraries in ``cache_dir`` (created if
    missing); False, and nothing changed, for an empty name. Takes effect
    for libraries not yet loaded in this process."""
    if not cache_dir:
        return False
    os.makedirs(cache_dir, exist_ok=True)
    build_dir.PATH = Path(cache_dir)
    log.info("kernel library directory: %s", cache_dir)
    return True


def build_libraries(device: torch.device) -> None:
    """Build every library the serving path loads, each compiler started at
    once on a thread of its own, then load them: the native ring always,
    the two CUDA kernels on a CUDA device. The first failure raises."""
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.ops import pack_cuda, whatif_cuda

    builds = [native.build]
    if device.type == "cuda":
        builds += [pack_cuda.build, whatif_cuda.build]
    errors = []

    def run(build):
        try:
            build()
        except BaseException as e:  # re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(b,), name="warmup-build")
               for b in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    native.load()
    if device.type == "cuda":
        with torch.cuda.device(device):
            pack_cuda._library()
            whatif_cuda._library()


def synthetic_encoding(S: int, T: int):
    """A one-pod problem already at the (S, T) bucket, in the solver's
    encoding: shape 0 holds the pod, type 0 takes it, the rest is padding."""
    from karpenter_tpu_torch.ops.encode import encoding_from_arrays
    from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES

    shapes = np.zeros((S, NUM_RESOURCES), np.int32)
    shapes[0, :] = 1
    counts = np.zeros((S,), np.int32)
    counts[0] = 1
    totals = np.zeros((T, NUM_RESOURCES), np.int32)
    totals[0, :] = 64
    reserved0 = np.zeros((T, NUM_RESOURCES), np.int32)
    valid = np.zeros((T,), bool)
    valid[0] = True
    return encoding_from_arrays(shapes, counts, totals, reserved0, valid,
                                last_valid=0, pods_unit=1, shape_pods=[[0]],
                                num_shapes=1, num_types=1)


def warmup_pass(config: Optional[SolverConfig] = None,
                shape_buckets: Optional[Sequence[int]] = None,
                type_buckets: Optional[Sequence[int]] = None,
                include_ring: bool = True,
                device: DeviceLike = None) -> int:
    """Build and load the libraries, then drive the ladder on ``device``
    (default: the CUDA device); returns the number of (bucket pair × entry)
    runs. Raises on the first failure."""
    from karpenter_tpu_torch.models.ffd import DeviceRun
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.ops.pack import compute_maxfit

    config = config or SolverConfig()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    build_libraries(dev)
    default_shapes, default_types = default_ladder()
    shape_buckets = default_shapes if shape_buckets is None else shape_buckets
    type_buckets = default_types if type_buckets is None else type_buckets
    L = config.chunk_iters
    runs = 0
    for S in shape_buckets:
        for T in type_buckets:
            enc = synthetic_encoding(S, T)
            shapes, counts, totals, reserved0 = (
                torch.from_numpy(a).to(dev) for a in
                (enc.shapes, enc.counts, enc.totals, enc.reserved0))
            valid = torch.from_numpy(enc.valid).to(dev)
            dropped = torch.zeros_like(counts)
            maxfit = compute_maxfit(shapes, totals, reserved0, valid)
            pack_cuda.pack_chunk(shapes, counts, dropped, totals, reserved0, valid,
                                 0, 1, L, maxfit=maxfit).cpu()
            # two problems: the smallest window that joins a batch
            two = lambda t: t[None].expand(2, *t.shape).contiguous()  # noqa: E731
            ones = torch.ones(2, dtype=torch.int32, device=dev)
            pack_cuda.pack_batch(two(shapes), two(counts), two(dropped), two(totals),
                                 two(reserved0), two(valid), ones - 1, ones, L).cpu()
            runs += 2
            if include_ring:
                DeviceRun([enc], [None], L, dev, donate=True, solo=True).finish()
                runs += 1
    log.info("solver warmup: %d runs over %d×%d buckets in %.3fs", runs,
             len(shape_buckets), len(type_buckets), time.perf_counter() - t0)
    return runs
