// One node decision's fill walk over one shard of the instance-type axis,
// for Hopper (sm_90a).
//
// Replaces the per-device body of the TPU's type-axis SPMD solve,
// karpenter_tpu/parallel/type_sharded.py::_local_pack, up to its
// collectives: node_iter's shape walk (type_sharded.py:94-146). Each
// shard's types walk the live shapes (count > 0) from the largest to the
// smallest, every type greedily first-fitting as many of each shape as its
// remaining capacity takes; the decision that follows (which type, how many
// nodes) is made across the shards by the collectives of
// parallel/type_sharded.py. It computes exactly what that walk computes:
// the XLA body's 8-shape blocks and its exit once every type has stopped
// are speed only, and a row it skips holds 0, as here.
//
// Inputs (int32 unless noted, R = 8 resources a row):
//   shapes    (S, R)   the problem's shapes, descending, replicated
//   counts    (S,)     pods left of each shape, replicated
//   totals    (T, R)   this shard's types' capacities
//   reserved0 (T, R)   their initial reservations
//   valid     (T,)     uint8 (torch.bool), nonzero = valid
//   pods_unit          the implicit pod each shape carries on R_PODS
// Outputs: npacked (T,), pods each type took; k (S, T), each type's fill of
// each shape (0 outside the walk and after the type stopped).
//
// What bounds it on this card: latency. The walk is a chain of dependent
// shape steps per type (a step's fill depends on the reservation the last
// left), and its bytes (the k rows written) and integer operations over
// the card's peaks are microseconds at config_8's (32, 2048) (PERF.md).
// The design keeps each type's state in registers: one thread a type, its
// reservation and capacity rows (8 ints each), stopped and npacked, so a
// step reads only the shape row and its count, which every thread of the
// block reads at once (one broadcast load). The block finds the live range
// and the smallest live shape itself, so the caller needs no host read of
// the counts. Types are independent: a grid of blocks over the types, no
// synchronisation after the prologue. Floor division as Python's and
// JAX's `//` (the capacity left of a type is not negative for an input
// that keeps 0 <= reserved0 <= totals, but the walk does not rely on it).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int R = 8;
constexpr int R_PODS = 2;
constexpr int THREADS = 256;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// int32 addition that wraps, as the plain version's int32 tensors do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(THREADS)
type_fill_kernel(const int* __restrict__ shapes, const int* __restrict__ counts,
                 const int* __restrict__ totals, const int* __restrict__ reserved0,
                 const unsigned char* __restrict__ valid, int S, int T,
                 int pods_unit, int* __restrict__ npacked_out,
                 int* __restrict__ k_out) {
  __shared__ int s_lo, s_hi;
  __shared__ int s_fits[R];
  if (threadIdx.x == 0) {
    s_lo = S;
    s_hi = -1;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    if (counts[s] > 0) {
      atomicMin(&s_lo, s);
      atomicMax(&s_hi, s);
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    // the smallest live shape less the implicit pod: what must still fit
    // for a type not to be full
    int v = 0;
    if (s_hi >= 0) {
      v = shapes[s_hi * R + threadIdx.x] - (threadIdx.x == R_PODS ? pods_unit : 0);
    }
    s_fits[threadIdx.x] = v > 0 ? v : 0;
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;

  int tot[R], res[R], fits[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tot[r] = totals[t * R + r];
    res[r] = reserved0[t * R + r];
    fits[r] = s_fits[r];
  }
  bool stopped = valid[t] == 0;
  int npk = 0;
  for (int s = 0; s < S; ++s) {
    int kv = 0;
    if (!stopped && s >= lo && s <= hi) {
      const int c = counts[s];
      if (c > 0) {
        int sh[R];
        int kfit = INT_MAX;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sh[r] = shapes[s * R + r];
          if (sh[r] > 0) kfit = min(kfit, floordiv(tot[r] - res[r], sh[r]));
        }
        kv = min(max(kfit, 0), c);
        bool full = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          res[r] = wrap_add(res[r], kv * sh[r]);
          full |= tot[r] > 0 && wrap_add(res[r], fits[r]) >= tot[r];
        }
        npk += kv;
        if (kv < c && (full || npk == 0)) stopped = true;
      }
    }
    k_out[static_cast<long long>(s) * T + t] = kv;
  }
  npacked_out[t] = npk;
}

}  // namespace

// One launch on `stream`: 0, or the CUDA error of a refused launch.
extern "C" int kt_type_fill(const int* shapes, const int* counts, const int* totals,
                            const int* reserved0, const unsigned char* valid, int S,
                            int T, int pods_unit, int* npacked, int* k, void* stream) {
  if (shapes == nullptr || counts == nullptr || totals == nullptr ||
      reserved0 == nullptr || valid == nullptr || npacked == nullptr ||
      k == nullptr || S <= 0 || T <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (T + THREADS - 1) / THREADS;
  type_fill_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      shapes, counts, totals, reserved0, valid, S, T, pods_unit, npacked, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_type_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
