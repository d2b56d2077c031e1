// Fused FFD chunk solve for Hopper (sm_90a): up to L node decisions of one
// first-fit-decreasing packing problem in one launch.
//
// Replaces the TPU kernel karpenter_tpu/ops/pack_pallas.py::_pack_kernel
// (pl.pallas_call at pack_pallas.py:373). It computes exactly what that
// kernel computes, record for record, including its row contract: a row past
// `done` or with q == 0 holds chosen = -1, q = 0 and packed = 0. The Pallas
// kernel's 128-lane blocked shape layout and its float32 `_floordiv_small`
// division are workarounds for the TPU's vector unit and are not carried
// over: every division here is exact int32, with an explicit floor.
//
// What bounds it on this card: latency, not bytes or arithmetic. A chunk is
// a serial chain of node decisions; each decision is a greedy walk over the
// descending shapes in which every step depends on the reservation left by
// the step before. Its bytes over 3.35 TB/s and its integer operations over
// the card's peak come to well under a millisecond (PERF.md), while the
// chain is hundreds to thousands of dependent steps of 8 integer divisions
// per type, issued by one CTA on one of the 132 SMs.
//
// What the design does about it: one CTA per problem (the grid is 1; a
// batched window makes the batch the grid). Threads stride over the T type
// columns; each type's running reservation, pod count and stop flag live in
// shared memory. The fill walk needs no block synchronisation: a type's
// fill depends only on its own state and the node-wide `smallest_fits`, and
// a stopped type never restarts within a decision, so each thread walks the
// shapes from the largest remaining one and stops when all its types have
// stopped. Block reductions (shared-memory atomicMin) pick the chosen type
// and the fast-forward count; thread 0 replays the chosen column into the
// output row and keeps the first/last live shape indices, which only move
// inward over a chunk. counts, maxfit and the packed rows stay in global
// memory (L2-resident), so shape buckets up to 32768 fit. Making it fast
// (types split across the SMs of a cluster, the replay folded into the
// fill, divisions by per-shape constants) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkt_pack.so pack.cu
// (karpenter_tpu_torch/ops/pack_cuda.py builds it at first use and binds
// kt_pack_chunk with ctypes.)

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int R = 8;        // resource dimensions (solver/host_ffd.NUM_RESOURCES)
constexpr int R_PODS = 2;   // the pods dimension (solver/host_ffd.R_PODS)
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// int32 addition with two's-complement wrap, as XLA and torch compute it
// (signed overflow is undefined in C++).
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// One greedy step of one type column over one shape with count > 0, for an
// active (not stopped) type: packable.go:111-130 for a whole shape at once.
// Preconditions (encode guarantees them): 0 <= res <= tot, count >= 1.
__device__ __forceinline__ int greedy_step(const int (&tot)[R], int (&res)[R],
                                           const int (&shp)[R], int count,
                                           const int (&sf)[R], int& npacked,
                                           int& stopped) {
  int kfit = INT_MAX;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (shp[r] > 0) kfit = min(kfit, floor_div(tot[r] - res[r], shp[r]));
  }
  const int k = min(max(kfit, 0), count);
  bool full = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    res[r] += k * shp[r];
    // early exit: the smallest remaining pod reaches a nonzero total
    full |= (tot[r] > 0) && (wrap_add(res[r], sf[r]) >= tot[r]);
  }
  npacked += k;
  if (k < count && (full || npacked == 0)) stopped = 1;
  return k;
}

__global__ void __launch_bounds__(MAX_THREADS)
pack_kernel(const int* __restrict__ shapes,      // (S, R)
            const int* __restrict__ counts_in,   // (S,)
            const int* __restrict__ dropped_in,  // (S,)
            const int* __restrict__ totals,      // (T, R)
            const int* __restrict__ reserved0,   // (T, R)
            const unsigned char* __restrict__ valid,  // (T,) bool
            const int* __restrict__ prices,      // (T,) or null
            const int* __restrict__ maxfit,      // (S,)
            int S, int T, int L, int last_valid, int pods_unit,
            int cost_tiebreak,
            int* __restrict__ out) {             // flat buffer
  extern __shared__ int smem[];
  int* resv_s = smem;              // (R, T): resv_s[r * T + t]
  int* npk_s = smem + R * T;       // (T,)
  int* stp_s = npk_s + T;          // (T,)
  __shared__ int sh_lo, sh_hi, sh_done, sh_end;
  __shared__ int sh_best_price, sh_chosen, sh_min_term;
  __shared__ int sh_sf[R];

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  int* counts = out;
  int* dropped = out + S;
  int* done_out = out + 2 * S;
  int* chosen_out = done_out + 1;
  int* q_out = chosen_out + L;
  int* packed_out = q_out + L;

  for (int i = tid; i < S; i += nth) {
    counts[i] = counts_in[i];
    dropped[i] = dropped_in[i];
  }
  for (int i = tid; i < L; i += nth) {
    chosen_out[i] = -1;
    q_out[i] = 0;
  }
  const long long n_packed = static_cast<long long>(L) * S;
  for (long long i = tid; i < n_packed; i += nth) packed_out[i] = 0;
  __syncthreads();
  if (tid == 0) {
    int lo = 0;
    while (lo < S && counts[lo] <= 0) ++lo;
    int hi = S - 1;
    while (hi > lo && counts[hi] <= 0) --hi;
    sh_lo = lo;
    sh_hi = hi;
    sh_done = lo >= S;
  }
  __syncthreads();

  for (int it = 0; it < L && !sh_done; ++it) {
    const int lo = sh_lo;  // largest remaining shape
    const int hi = sh_hi;  // smallest remaining shape
    if (tid < R) {
      // fits() uses raw requests, no implicit pods:1 (packable.go:118,146)
      sh_sf[tid] = max(shapes[hi * R + tid] - (tid == R_PODS ? pods_unit : 0), 0);
    }
    if (tid == 0) {
      sh_best_price = INT_MAX;
      sh_chosen = INT_MAX;
      sh_min_term = INT_MAX;
    }
    __syncthreads();
    int sf[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sf[r] = sh_sf[r];

    // pass 1: greedy-fill every type column over the descending shapes
    bool any_active = false;
    for (int t = tid; t < T; t += nth) {
#pragma unroll
      for (int r = 0; r < R; ++r) resv_s[r * T + t] = reserved0[t * R + r];
      npk_s[t] = 0;
      stp_s[t] = valid[t] ? 0 : 1;
      any_active |= valid[t] != 0;
    }
    for (int s = lo; any_active && s <= hi; ++s) {
      const int count = counts[s];
      if (count <= 0) continue;  // a count-0 shape is a no-op
      int shp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) shp[r] = shapes[s * R + r];
      any_active = false;
      for (int t = tid; t < T; t += nth) {
        if (stp_s[t]) continue;
        int tot[R], res[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          tot[r] = __ldg(&totals[t * R + r]);
          res[r] = resv_s[r * T + t];
        }
        int np = npk_s[t];
        int st = 0;
        greedy_step(tot, res, shp, count, sf, np, st);
#pragma unroll
        for (int r = 0; r < R; ++r) resv_s[r * T + t] = res[r];
        npk_s[t] = np;
        stp_s[t] = st;
        any_active |= st == 0;
      }
    }
    __syncthreads();

    // max pods at the largest viable type; first (or cheapest) type tying it
    const int max_pods = npk_s[last_valid];
    if (cost_tiebreak) {
      for (int t = tid; t < T; t += nth) {
        if (valid[t] && npk_s[t] == max_pods) atomicMin(&sh_best_price, prices[t]);
      }
      __syncthreads();
    }
    const int best_price = sh_best_price;
    for (int t = tid; t < T; t += nth) {
      if (valid[t] && npk_s[t] == max_pods &&
          (!cost_tiebreak || prices[t] == best_price)) {
        atomicMin(&sh_chosen, t);
      }
    }
    __syncthreads();
    const int chosen = sh_chosen;
    const bool nothing = max_pods == 0;
    int* row = packed_out + static_cast<long long>(it) * S;

    // pass 2: replay the chosen column into its output row (each column's
    // fill is independent of the others, so the replay is exact)
    if (tid == 0) {
      int end = lo;
      if (chosen < T) {
        int tot[R], res[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          tot[r] = totals[chosen * R + r];
          res[r] = reserved0[chosen * R + r];
        }
        int np = 0;
        int st = 0;
        for (int s = lo; s <= hi && !st; ++s) {
          end = s + 1;
          const int count = counts[s];
          if (count <= 0) continue;
          int shp[R];
#pragma unroll
          for (int r = 0; r < R; ++r) shp[r] = shapes[s * R + r];
          row[s] = greedy_step(tot, res, shp, count, sf, np, st);
        }
      }
      sh_end = end;
    }
    __syncthreads();
    const int end = sh_end;

    // exact fast-forward: every packed shape must stay strictly above
    // maxfit through all q repeats (docs/solver.md §4); the numerator can
    // be negative (then q = 1) and maxfit can be INT32_MAX, so it is formed
    // in 64 bits
    if (!nothing) {
      for (int s = lo + tid; s < end; s += nth) {
        const int pv = row[s];
        if (pv > 0) {
          const long long numer =
              static_cast<long long>(counts[s]) - maxfit[s] - 1;
          const long long term = numer < 0 ? -1 : numer / pv;
          atomicMin(&sh_min_term, static_cast<int>(min(term, (long long)INT_MAX)));
        }
      }
    }
    __syncthreads();
    int q = 0;
    if (!nothing) {
      q = static_cast<int>(max(1LL, min(1LL + sh_min_term, (long long)INT_MAX)));
    }
    for (int s = lo + tid; s < end; s += nth) {
      const int pv = row[s];
      if (pv > 0) counts[s] -= q * pv;
    }
    if (tid == 0) {
      if (nothing) {
        // drop path: the largest remaining shape fits nowhere
        // (packer.go:124-128); every pod of it fails identically
        dropped[lo] += counts[lo];
        counts[lo] = 0;
      } else {
        chosen_out[it] = chosen;
        q_out[it] = q;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int l = lo, h = hi;
      while (l <= h && counts[l] <= 0) ++l;
      while (h > l && counts[h] <= 0) --h;
      sh_lo = l;
      sh_hi = h;
      sh_done = l > h;
    }
    __syncthreads();
  }
  if (tid == 0) *done_out = sh_done;
}

}  // namespace

extern "C" int kt_pack_chunk(const int* shapes, const int* counts,
                             const int* dropped, const int* totals,
                             const int* reserved0, const unsigned char* valid,
                             const int* prices, const int* maxfit, int S,
                             int T, int L, int last_valid, int pods_unit,
                             int cost_tiebreak, int* out, void* stream) {
  if (S <= 0 || T <= 0 || L < 0 || last_valid < 0 || last_valid >= T ||
      (cost_tiebreak && prices == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = min(MAX_THREADS, ((T + 31) / 32) * 32);
  const size_t smem = static_cast<size_t>(R + 2) * T * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pack_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      shapes, counts, dropped, totals, reserved0, valid, prices, maxfit, S, T,
      L, last_valid, pods_unit, cost_tiebreak, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
