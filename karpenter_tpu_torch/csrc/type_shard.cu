// One node decision over one shard of the instance-type axis, for Hopper
// (sm_90a): the fill walk of the shard's types, the max-pods probe, the
// shard's tie key and the winner's fill column, in one launch.
//
// Replaces the per-device body of the TPU's type-axis SPMD solve,
// karpenter_tpu/parallel/type_sharded.py::_local_pack, up to its
// cross-shard reductions: node_iter's shape walk (type_sharded.py:94-146)
// and each shard's part of the decision (:150-182). Each shard's types walk
// the live shapes (count > 0) from the largest to the smallest, every type
// greedily first-fitting as many of each shape as its remaining capacity
// takes. The decision then needs:
// - max_pods, the pods the globally last valid type packs (packer.go:
//   167-170). A type's walk depends only on its own row, the shapes and the
//   counts, so every shard walks that type itself from its row (`probe`, a
//   launch argument replicated once a chunk): no collective.
// - the shard's candidate: the least int64 key price * 2^32 + global index
//   over its ties (valid & npacked == max_pods; price 0 unless the cost
//   tie-break is on), the max int64 where it has none, and that type's fill
//   column (S,). The least key over the shards (parallel/type_sharded.py)
//   is the decision: its column is the pack vector, its low word the chosen
//   type. Signed keys order (price, index) for any int32 price.
// It computes exactly what the XLA body computes: its 8-shape blocks and
// its exit once every type has stopped are speed only.
//
// Inputs (int32 unless noted, R = 8 resources a row):
//   shapes    (S, R)    the problem's shapes, descending, replicated
//   counts    (S,)      pods left of each shape, replicated
//   totals    (T, R)    this shard's types' capacities
//   reserved0 (T, R)    their initial reservations
//   valid     (T,)      uint8 (torch.bool), nonzero = valid
//   prices    (T,)      micro-$, read only with the cost tie-break (may be null)
//   probe     (2R + 1,) the last valid type's totals, reserved0 and valid
//   offset              the shard's first global type index
//   pods_unit           the implicit pod each shape carries on R_PODS
// Scratch: k (S, T) the walk's fills; work (2,) int64, the shard's running
// minimum key (INT64_MAX between launches) and the block ticket (0), both
// restored by the last block.
// Output: out (4 + S, rounded up to even) int32: the key's low and high
// words, max_pods, the chosen index (INT32_MAX for the sentinel key), then
// the winner's column (0 where it has no tie).
//
// What bounds it on this card: latency. The walk is a chain of dependent
// shape steps a type, and its bytes and integer operations over the card's
// peaks are nanoseconds at config_8's (32, 256) (PERF.md). Before this
// design a step waited on device memory (the count and the shape row) and
// on run-time integer division over all 8 resources: ~1,340 cycles a step,
// 0.0217 ms a call. Here:
// - The shapes, counts and per-shape division constants are staged in
//   shared memory before the walk, in tiles of TILE shapes that every
//   thread of the block walks in step (one barrier a tile; a problem of up
//   to TILE live shapes is one tile). A step reads only shared memory and
//   registers and has no branch (an inactive walker keeps a fill of 0), so
//   the resources' quotients interleave and four unrolled steps' records
//   load ahead of them.
// - Only the resources some live shape asks for are walked (3 of the 8 for
//   cpu, memory and pods, as csrc/pack.cu does): the others keep their
//   reservation, so their part of the full test is fixed per type.
// - Division by per-shape constants, as csrc/pack.cu does (:40-45, the
//   fill walk's umulhi plus one exact correction): a divisor record m =
//   (2^32 - 1) / d a (shape, resource), built when the tile is staged. A
//   negative capacity left needs no quotient: its floor is negative and
//   the fill clamps to 0.
// - A thread a type, its reservation and capacity in registers; TYPES
//   types a block, so the types of a shard spread over T / TYPES SMs. Each
//   block has one more warp, whose first lane walks the probe row, so every
//   block knows max_pods without waiting on another.
// - The block's least key by warp shuffles, an atomic minimum into the
//   shard's work word, and a ticket: the last block to finish reads the
//   winner, copies its column from the fills and writes the output. No
//   host read and no second launch.
// What is left is the step's own dependent chain (subtract, umulhi,
// correction, minimum, reserve, full test, stop test) a shape, and the
// prologue's and the ticket's round trips to device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkt_type_shard.so type_shard.cu
// (karpenter_tpu_torch/ops/type_shard_cuda.py builds it at first use and
// binds kt_shard_candidate with ctypes.)

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int R = 8;
constexpr int R_PODS = 2;
constexpr int TYPES = 64;              // types a block: two warps
constexpr int THREADS = TYPES + 32;    // and a warp whose first lane walks the probe
constexpr int TILE = 128;              // shapes staged at once
constexpr int HEADER = 4;              // key low, key high, max_pods, chosen
constexpr unsigned FULL_MASK = 0xffffffffu;

// int32 addition that wraps, as the plain version's int32 tensors do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// the n-th set bit of m (n from 0)
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int q = 0; q < n; ++q) m &= m - 1;
  return __ffs(m) - 1;
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// floor(a / d) for 0 <= a < 2^31 and d >= 1 with m = (2^32 - 1) / d: the
// high word of a * m is the quotient or one less, and one correction makes
// it exact (ops/pack_cuda.floor_div_by_constant)
__device__ __forceinline__ int div_by_constant(int a, int d, unsigned m) {
  const unsigned ua = static_cast<unsigned>(a);
  const unsigned q = __umulhi(ua, m);
  return static_cast<int>(q + (ua - q * static_cast<unsigned>(d) >= static_cast<unsigned>(d) ? 1u : 0u));
}

// The walk of the block's walkers (a type of the shard a thread, and the
// probe) over the live shapes, NW resources a step: the requested ones
// (some live shape asks for them), padded with others to NW. tot, res and
// fits are the walker's rows in the order of rmap; full_fixed the part of
// the full test of the resources not walked, which never changes. Writes
// each type's fill of every shape row to k_out and returns its pods
// packed.
template <int NW>
__device__ int walk(int (&tot)[R], int (&res)[R], const int (&fits)[R], bool full_fixed,
                    bool stopped, bool is_type, bool is_walker, const int* __restrict__ shapes,
                    const int* __restrict__ counts, const int* rmap, int lo, int hi, int S,
                    int T, int t, int (*s_shape)[R], unsigned (*s_magic)[R], int* s_count,
                    int* __restrict__ k_out) {
  const int tid = threadIdx.x;
  int npk = 0;
  int walked = lo;  // shapes [lo, walked) walked; rows never reached hold 0
  for (int base = lo; base <= hi; base += TILE) {
    const int n = min(TILE, hi - base + 1);
    for (int i = tid; i < n * NW; i += THREADS) {
      const int s = i / NW, a = i % NW;
      const int d = shapes[(base + s) * R + rmap[a]];
      s_shape[s][a] = d;
      s_magic[s][a] = d > 0 ? 0xffffffffu / static_cast<unsigned>(d) : 0u;
    }
    for (int i = tid; i < n; i += THREADS) s_count[i] = counts[base + i];
    __syncthreads();
    // a step is branch-free: an inactive walker (stopped, or a count-0
    // shape) computes and keeps kv = 0, so every walker runs one
    // instruction stream and the steps' shared loads go ahead of them
    int* kp = k_out + static_cast<size_t>(base) * T + t;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int c = s_count[i];
      const bool active = !stopped && c > 0;
      int kfit = INT_MAX;
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        // a resource the shape does not ask for bounds nothing; a
        // negative capacity left bounds the fill below 0
        const int d = s_shape[i][a];
        const int x = wrap_sub(tot[a], res[a]);
        const int q = div_by_constant(x, max(d, 1), s_magic[i][a]);
        kfit = min(kfit, d > 0 ? (x < 0 ? -1 : q) : INT_MAX);
      }
      const int kv = active ? min(max(kfit, 0), c) : 0;
      bool full = full_fixed;
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        res[a] = wrap_add(res[a], wrap_mul(kv, s_shape[i][a]));
        full |= tot[a] > 0 && wrap_add(res[a], fits[a]) >= tot[a];
      }
      npk = wrap_add(npk, kv);
      stopped = stopped || (active && kv < c && (full || npk == 0));
      if (is_type) *kp = kv;
      kp += T;
    }
    walked = base + n;
    // every walker of the block stopped: the later shapes are no-ops (the
    // barrier also guards the tile before it is staged again)
    if (!__syncthreads_or(is_walker && !stopped)) break;
  }
  if (is_type) {
    for (int s = 0; s < lo && s < S; ++s) k_out[static_cast<size_t>(s) * T + t] = 0;
    for (int s = walked; s < S; ++s) k_out[static_cast<size_t>(s) * T + t] = 0;
    __threadfence();  // the fills reach the last block, whichever it is
  }
  return npk;
}

__global__ void __launch_bounds__(THREADS)
candidate_kernel(const int* __restrict__ shapes, const int* __restrict__ counts,
                 const int* __restrict__ totals, const int* __restrict__ reserved0,
                 const unsigned char* __restrict__ valid, const int* __restrict__ prices,
                 const int* __restrict__ probe, int S, int T, int offset, int pods_unit,
                 int* __restrict__ k_out, long long* __restrict__ work, int* __restrict__ out) {
  __shared__ int s_shape[TILE][R];
  __shared__ unsigned s_magic[TILE][R];
  __shared__ int s_count[TILE];
  __shared__ int s_lo, s_hi, s_max_pods, s_last;
  __shared__ unsigned s_requested;
  __shared__ int s_fits[R], s_rmap[R];
  __shared__ long long s_key[THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = blockIdx.x * TYPES + tid;
  const bool is_type = tid < TYPES && t < T;
  const bool is_probe = tid == TYPES;
  const bool is_walker = is_type || is_probe;

  // the walker's rows, read first: their loads overlap the prologue's
  int tot0[R] = {}, res0[R] = {};
  bool stopped = true;
  if (is_walker) {
    const int* trow = is_type ? totals + static_cast<size_t>(t) * R : probe;
    const int* rrow = is_type ? reserved0 + static_cast<size_t>(t) * R : probe + R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tot0[r] = trow[r];
      res0[r] = rrow[r];
    }
    stopped = is_type ? valid[t] == 0 : probe[2 * R] == 0;
  }
  if (tid == 0) {
    s_lo = S;
    s_hi = -1;
    s_requested = 0;
  }
  __syncthreads();
  // the live range and the resources some live shape asks for: each
  // thread's, the warp's, then one shared atomic a warp
  int lo_t = S, hi_t = -1;
  unsigned req_t = 0;
  for (int s = tid; s < S; s += THREADS) {
    if (counts[s] > 0) {
      lo_t = min(lo_t, s);
      hi_t = max(hi_t, s);
#pragma unroll
      for (int r = 0; r < R; ++r) req_t |= (shapes[s * R + r] != 0 ? 1u : 0u) << r;
    }
  }
  lo_t = __reduce_min_sync(FULL_MASK, lo_t);
  hi_t = __reduce_max_sync(FULL_MASK, hi_t);
  req_t = __reduce_or_sync(FULL_MASK, req_t);
  if (lane == 0) {
    atomicMin(&s_lo, lo_t);
    atomicMax(&s_hi, hi_t);
    atomicOr(&s_requested, req_t);
  }
  __syncthreads();
  // walked resources (s_rmap): the ones some live shape asks for, then
  // the others; a resource no live shape asks for keeps its reservation,
  // so its part of the full test is fixed
  const unsigned requested = s_requested;
  const int nreq = __popc(requested);
  const int nw = nreq <= 3 ? 3 : R;
  if (tid < R) {
    // the smallest live shape less the implicit pod: what must still fit
    // for a type not to be full
    int v = 0;
    if (s_hi >= 0) v = shapes[s_hi * R + tid] - (tid == R_PODS ? pods_unit : 0);
    s_fits[tid] = v > 0 ? v : 0;
    s_rmap[tid] = tid < nreq ? nth_bit(requested, tid) : nth_bit(~requested & 0xffu, tid - nreq);
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  int tot[R], res[R], fits[R];
  bool full_fixed = false;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int ra = s_rmap[a];
    int tr = tot0[0], rr = res0[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      tr = ra == r ? tot0[r] : tr;
      rr = ra == r ? res0[r] : rr;
    }
    tot[a] = tr;
    res[a] = rr;
    fits[a] = s_fits[ra];
    if (a >= nw) full_fixed |= tr > 0 && wrap_add(rr, fits[a]) >= tr;
  }

  int npk;
  if (nw == 3)
    npk = walk<3>(tot, res, fits, full_fixed, stopped, is_type, is_walker, shapes, counts, s_rmap,
                  lo, hi, S, T, t, s_shape, s_magic, s_count, k_out);
  else
    npk = walk<R>(tot, res, fits, full_fixed, stopped, is_type, is_walker, shapes, counts, s_rmap,
                  lo, hi, S, T, t, s_shape, s_magic, s_count, k_out);
  if (is_probe) s_max_pods = npk;
  __syncthreads();

  // this block's least key over its ties
  long long key = LLONG_MAX;
  if (is_type && valid[t] != 0 && npk == s_max_pods) {
    const long long price = prices != nullptr ? prices[t] : 0;
    key = price * 4294967296LL + static_cast<long long>(offset + t);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_down_sync(FULL_MASK, key, o));
  if (lane == 0) s_key[tid >> 5] = key;
  __syncthreads();
  if (tid == 0) {
    long long best = s_key[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) best = min(best, s_key[w]);
    if (best != LLONG_MAX) atomicMin(work, best);
    __threadfence();
    const unsigned long long ticket =
        atomicAdd(reinterpret_cast<unsigned long long*>(work + 1), 1ull);
    s_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: the shard's winner, its column, the work words reset
  if (tid == 0) {
    __threadfence();
    s_key[0] = atomicExch(reinterpret_cast<unsigned long long*>(work), 0x7fffffffffffffffull);
    work[1] = 0;
  }
  __syncthreads();
  const long long best = s_key[0];
  const int w = best == LLONG_MAX ? -1 : static_cast<int>(static_cast<unsigned>(best)) - offset;
  for (int s = tid; s < S; s += THREADS) {
    out[HEADER + s] = w >= 0 ? __ldcg(k_out + static_cast<size_t>(s) * T + w) : 0;
  }
  if (tid == 0) {
    out[0] = static_cast<int>(static_cast<unsigned>(best));
    out[1] = static_cast<int>(static_cast<unsigned>(static_cast<unsigned long long>(best) >> 32));
    out[2] = s_max_pods;
    out[3] = w >= 0 ? offset + w : INT_MAX;
    if (S & 1) out[HEADER + S] = 0;
  }
}

}  // namespace

// One launch on `stream`: 0, or the CUDA error of a refused launch.
extern "C" int kt_shard_candidate(const int* shapes, const int* counts, const int* totals,
                                  const int* reserved0, const unsigned char* valid,
                                  const int* prices, const int* probe, int S, int T,
                                  int offset, int pods_unit, int* k, long long* work,
                                  int* out, void* stream) {
  if (shapes == nullptr || counts == nullptr || totals == nullptr || reserved0 == nullptr ||
      valid == nullptr || probe == nullptr || k == nullptr || work == nullptr ||
      out == nullptr || S <= 0 || T <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (T + TYPES - 1) / TYPES;
  candidate_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      shapes, counts, totals, reserved0, valid, prices, probe, S, T, offset, pods_unit, k,
      work, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_shard_candidate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
