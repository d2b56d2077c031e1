"""The directory the port's compiled libraries are built into and loaded
from: the pack, what-if and type-shard kernels
(``ops.pack_cuda.nvcc_build``) and the native host ring (``native``). Each
library is named by its source's digest. ``solver.warmup.configure_compilation_cache`` points ``PATH`` at a
durable directory; a library already loaded keeps the path it came from.
"""

from pathlib import Path

PATH = Path(__file__).resolve().parent / "build"
