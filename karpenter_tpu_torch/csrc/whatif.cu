// Batched what-if first fit for Hopper (sm_90a): for each consolidation
// candidate, first-fit its pods, in order, into every bin of the window but
// its own, and report whether every valid pod was placed and where.
//
// Replaces the XLA device program karpenter_tpu/solver/whatif.py::_whatif_jit
// (a jax.vmap over candidates of a jax.lax.scan over pods). It computes
// exactly what that program computes, slots included: the scan never stops
// at a pod that fits nowhere, so the later pods of an infeasible candidate
// are still placed (and debited) where they fit.
//
// Inputs, as ops/whatif.encode_window pads them (NB, KB, BB powers of two):
//   pods     (NB, KB, R) int32, GCD-scaled reserve vectors
//   valid    (NB, KB)    uint8 0/1
//   compat   (NB, KB, BB) uint8 0/1
//   free0    (BB, R)     int32, may be negative (an overcommitted node)
//   cand_bin (NB,)       int32, the candidate's own bin, or -1
// Outputs: feasible (NB,) uint8 and slots (NB, KB) int32 (bin or -1).
//
// What bounds it on this card: latency. Each candidate is a chain of KB
// dependent steps (a pod's placement changes the free rows the next pod
// sees); its bytes (compat once, pods, free0) and its compares over the
// card's peaks are microseconds (PERF.md).
//
// What the design does about it:
// - One thread block per candidate, all candidates at once; the candidates
//   are independent, so nothing crosses blocks.
// - The bins are strided across the block's threads: thread t owns the bins
//   b = t (mod blockDim) and is the only thread that ever reads or writes
//   their free rows. A thread tests its bins in ascending order and stops
//   at its first fit, which is its lowest; the block takes the minimum over
//   threads (warp __reduce_min_sync, then the warps' minima through shared
//   memory), which is the lowest bin that fits. The owner of the chosen bin
//   debits it. Since a free row is touched by its owner alone, the debit
//   needs no barrier; the one barrier of a step publishes the warps' minima,
//   double-buffered by the parity of the barriers passed, so a fast warp
//   never overwrites a slot a slow one still reads.
// - A pod that is not valid places nothing and leaves `feasible` alone, as
//   in _whatif_jit; the block skips its search (valid is uniform across the
//   block, so the branch does not diverge).
// - The candidate's free rows, structure of arrays (resource-major, so a
//   warp's 32 consecutive bins are 32 consecutive words), live in shared
//   memory when BB·R·4 bytes fit the block's opt-in (ops/whatif_cuda
//   decides and passes use_smem), else in the candidate's slice of a global
//   scratch that the wrapper allocates.
// - compat[i, k, :] is contiguous in b, so a warp's loads coalesce.
// - Only compares and subtractions: no division, so no floor-division trap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkt_whatif.so whatif.cu
// (karpenter_tpu_torch/ops/whatif_cuda.py builds it at first use and binds
// kt_whatif with ctypes.)

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int R = 8;  // resource dimensions (solver/host_ffd.NUM_RESOURCES)
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(MAX_THREADS)
whatif_kernel(const int* __restrict__ pods, const unsigned char* __restrict__ valid,
              const unsigned char* __restrict__ compat, const int* __restrict__ free0,
              const int* __restrict__ cand_bin, unsigned char* __restrict__ feasible,
              int* __restrict__ slots, int* __restrict__ scratch, int KB, int BB,
              int use_smem) {
  extern __shared__ int smem_free[];
  __shared__ int warp_min[2][MAX_WARPS];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  // this candidate's free rows, [r * BB + b]
  int* rows = use_smem ? smem_free : scratch + static_cast<size_t>(i) * BB * R;
  for (int b = tid; b < BB; b += nthreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) rows[r * BB + b] = free0[b * R + r];
  }
  // no barrier: every row is read and written by the thread that copied it

  const int own = cand_bin[i];
  const int* pod_row = pods + static_cast<size_t>(i) * KB * R;
  const unsigned char* valid_row = valid + static_cast<size_t>(i) * KB;
  const unsigned char* compat_row = compat + static_cast<size_t>(i) * KB * BB;
  int* slot_row = slots + static_cast<size_t>(i) * KB;
  bool ok = true;
  int phase = 0;  // barriers passed: the parity that picks warp_min's buffer

  for (int k = 0; k < KB; ++k) {
    if (!valid_row[k]) {
      if (tid == 0) slot_row[k] = -1;
      continue;
    }
    int vec[R];
#pragma unroll
    for (int r = 0; r < R; ++r) vec[r] = __ldg(pod_row + k * R + r);
    const unsigned char* cmp = compat_row + static_cast<size_t>(k) * BB;

    int best = INT_MAX;
    for (int b = tid; b < BB; b += nthreads) {
      if (b == own || !cmp[b]) continue;
      bool fits = true;
#pragma unroll
      for (int r = 0; r < R; ++r) fits &= rows[r * BB + b] >= vec[r];
      if (fits) {
        best = b;
        break;
      }
    }
    best = __reduce_min_sync(FULL_MASK, best);
    const int buf = phase++ & 1;
    if (lane == 0) warp_min[buf][warp] = best;
    __syncthreads();
    const int chosen = __reduce_min_sync(
        FULL_MASK, lane < nwarps ? warp_min[buf][lane] : INT_MAX);

    if (chosen == INT_MAX) {
      ok = false;
      if (tid == 0) slot_row[k] = -1;
    } else {
      if (chosen % nthreads == tid) {
#pragma unroll
        for (int r = 0; r < R; ++r) rows[r * BB + chosen] -= vec[r];
      }
      if (tid == 0) slot_row[k] = chosen;
    }
  }
  if (tid == 0) feasible[i] = ok ? 1 : 0;
}

}  // namespace

extern "C" int kt_whatif(const int* pods, const unsigned char* valid,
                         const unsigned char* compat, const int* free0,
                         const int* cand_bin, unsigned char* feasible, int* slots,
                         int* scratch, int NB, int KB, int BB, int threads,
                         int use_smem, void* stream) {
  // threads: whole warps, at most MAX_THREADS (ops/whatif_cuda.launch_threads)
  if (NB < 1 || KB < 1 || BB < 1 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || (!use_smem && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = use_smem ? static_cast<size_t>(BB) * R * sizeof(int) : 0;
  if (use_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        whatif_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  whatif_kernel<<<NB, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      pods, valid, compat, free0, cand_bin, feasible, slots, scratch, KB, BB, use_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_whatif_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
