// Fused FFD chunk solve for Hopper (sm_90a): up to L node decisions of one
// first-fit-decreasing packing problem in one launch of one thread-block
// cluster.
//
// Replaces the TPU kernel karpenter_tpu/ops/pack_pallas.py::_pack_kernel
// (pl.pallas_call at pack_pallas.py:373). It computes exactly what that
// kernel computes, record for record, including its row contract: a row past
// `done` or with q == 0 holds chosen = -1, q = 0 and packed = 0. The Pallas
// kernel's 128-lane blocked shape layout and its float32 `_floordiv_small`
// division are workarounds for the TPU's vector unit and are not carried
// over: every division here is exact.
//
// What bounds it on this card: latency. A chunk is a serial chain of node
// decisions; each decision is a greedy walk over the live shapes, descending,
// in which each type's step depends on the reservation its previous step
// left. Its bytes and its integer operations over the card's peaks come to
// well under a millisecond (PERF.md); the chain is thousands of dependent
// steps, and the largest types walk it to its end: the warp that holds them
// sets the time, one step after the other.
//
// What the design does about it:
// - The T type columns are split across a cluster of up to 8 CTAs (one SM
//   each), one type per thread; each type's state (capacity left per
//   resource, pods packed, stopped, log length) lives in registers through
//   the walk. A type's walk depends only on its own state and on the
//   node-wide smallest_fits, and a stopped type never restarts, so the walk
//   needs no synchronisation; a CTA walks while any of its types is active.
// - The step is short and has no branch: only the resources some shape
//   requests are walked (3 of the 8 for cpu, memory and pods; the others
//   cannot change, and their part of the early-exit test is a per-type
//   constant), UNROLL steps run between checks that a type is active, with
//   their records and counts loaded before the first of them, and the log
//   append is a predicated store. The caller passes the mask of the
//   resources its shapes request (ops/pack_cuda.requested_mask); the kernel
//   is compiled for 3 and for 8 walked resources, and the launch takes the
//   3-resource body when the mask has at most 3 bits (on the H100 it walks
//   the high-cardinality chunk 1.69x faster than the 8-resource body, and
//   one kernel holding both bodies gave it the 8-resource one's registers
//   and schedule; PERF.md).
// - Division by per-shape constants: every divisor in the walk is a shape's
//   resource, fixed for the launch. The prologue stores, per (shape,
//   resource), d, -d, m = (2^32-1) / d and a bias that makes a divisor of 0
//   unbounding; the walk divides a numerator n < 2^31 as umulhi(n, m) plus
//   one exact correction (ops/pack_cuda.py emulates and tests it). The fill
//   walk has no hardware integer division.
// - Each CTA keeps the live shapes (count > 0, in walk order) and their
//   counts in its own shared memory, compacted by a block-wide prefix sum
//   after each decision, and stages the walk's divisor records from its own
//   copy of the table in double-buffered tiles with cp.async, so no per-step
//   global load sits in the chain.
// - One cluster barrier per decision. Each CTA has one more warp, whose
//   first lane walks last_valid, so max_pods is known in every CTA without
//   a barrier; the (price, index) minimum of the tie and the winner's log
//   length then go through distributed shared memory to every CTA.
//   Reduction slots and logs are double-buffered by the decision's parity,
//   so a fast CTA never overwrites what a slow one still reads.
// - No serial replay: each type logs (live position, k) for its steps with
//   k > 0 into a global scratch. After the barrier every CTA reads the
//   chosen type's log in parallel: the fast-forward minimum, the count
//   updates (applied by every CTA to its own copy, so counts never cross
//   CTAs) and, in CTA 0, the scatter into the output row.
//
// A log longer than its bound (log_cap, from ops/pack_cuda.compute_log_bound)
// or a decision without a tying type ends the chunk with the done word set
// to -1; ops/pack.unpack_flat raises on it. No row is written from a cut log.
//
// A batch of B independent problems (the Pallas kernel under jax.vmap,
// karpenter_tpu/parallel/sharded_pack.py:90) is one launch of the same
// kernel over a grid of B clusters: problem b is the cluster at
// blockIdx.y, every pointer is offset to its rows, and the walk, the
// reductions and the DSMEM exchange use the rank inside the cluster as
// before. last_valid and pods_unit are per-problem device arrays
// (last_valid comes from the device feasibility mask and is never read on
// the host); a last_valid outside [0, T) sets the done word to -1, and a
// problem whose last_valid type is not valid (a mask row with no feasible
// type) drops its shapes like the reference, whose max_pods is then 0.
// With B = 1 it is the one-problem launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkt_pack.so pack.cu
// (karpenter_tpu_torch/ops/pack_cuda.py builds it at first use and binds
// kt_pack with ctypes.)

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 8;               // resource dimensions (solver/host_ffd.NUM_RESOURCES)
constexpr int R_PODS = 2;          // the pods dimension (solver/host_ffd.R_PODS)
constexpr int MAX_CLUSTER = 8;     // portable cluster size
constexpr int MAX_TYPE_THREADS = 512;
constexpr int MAX_THREADS = MAX_TYPE_THREADS + 32;  // and the last_valid warp
constexpr int TILE = 64;           // live shapes per staged tile
constexpr int MAX_STRIDE = 32;     // u32 words per shape in the divisor table
constexpr int COMPACT_E = 8;       // list entries per thread per compaction round
constexpr int UNROLL = 4;          // walk steps per check that a type is active
constexpr int FF_REGS = 2;         // chosen-log entries a thread keeps in registers
constexpr int DONE_ERROR = -1;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr unsigned UNBOUNDED = 0x7ffffffeu;  // + the correction's 1 = INT_MAX

// Every array carries a leading problem axis of B (1 for one problem).
struct Params {
  const int* shapes;         // (B, S, R)
  const int* counts_in;      // (B, S)
  const int* dropped_in;     // (B, S)
  const int* totals;         // (B, T, R)
  const int* reserved0;      // (B, T, R)
  const unsigned char* valid;  // (B, T) bool
  const int* prices;         // (B, T) or null
  const int* maxfit;         // (B, S)
  const int* last_valid;     // (B,)
  const int* pods_unit;      // (B,)
  unsigned* consts;          // (B, cluster, S, MAX_STRIDE) scratch: divisor records
  int2* log;                 // (B, 2, T, log_cap) scratch: (live position, k)
  int* out;                  // (B, flat) buffers
  int S, T, L, cost_tiebreak;
  int log_cap;               // entries per type log
  unsigned used;             // the resources some shape requests, a bit each
  int types_per_cta;
  int type_threads;          // threads holding types; the next warp walks last_valid
};

struct Reduce {
  unsigned long long key[MAX_CLUSTER];  // per CTA rank: min (price, type) of the tie
  int nlog[MAX_CLUSTER];                // per CTA rank: that type's log length
};

struct Shared {
  Reduce red[2];             // written remotely; indexed by decision parity
  unsigned long long key;
  int key_nlog;
  int max_pods;
  int term;
  int dead;
  int n_live;
  int warp_total[MAX_THREADS / 32];
  // this problem's rows that the decisions use: set once by thread 0 and
  // read from here, so they take no registers through the walk
  const int* prices;
  const int* maxfit;
  int2* log;
  int* out;
  int pods_unit;
};

// a divisor record: d, -d, m, bias, NRK words each, padded to 16 bytes
__host__ __device__ constexpr int stride_of(int nrk) { return (4 * nrk + 3) / 4 * 4; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// int32 words of one problem's flat buffer (ops/pack.flat_size)
__host__ __device__ constexpr size_t flat_size(int S, int L) {
  return 2 * static_cast<size_t>(S) + 1 + 2 * static_cast<size_t>(L) +
         static_cast<size_t>(L) * S;
}

// shared bytes of the live list: counts (S + UNROLL) then shape indices (S)
__host__ __device__ constexpr size_t list_bytes(int S) {
  return align16((static_cast<size_t>(S) + UNROLL) * 4 + static_cast<size_t>(S) * 2);
}

// 16 bytes global -> shared, asynchronously, through L1 (the table is this
// CTA's own copy, so L1 holds it across decisions where it fits)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const size_t s = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(s) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stable in-place compaction of the first n entries of (cnt, live) to those
// with cnt > 0. Each round reads nt*COMPACT_E entries into registers before
// its first barrier and writes them no further right than where it read
// them, so no round overwrites an entry not yet read.
__device__ void compact(int* cnt, unsigned short* live, int n, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  int out = 0;
  for (int base = 0; base < n; base += nt * COMPACT_E) {
    int c[COMPACT_E];
    unsigned short l[COMPACT_E];
    int mine = 0;
#pragma unroll
    for (int e = 0; e < COMPACT_E; ++e) {
      const int i = base + tid * COMPACT_E + e;
      c[e] = i < n ? cnt[i] : 0;
      l[e] = i < n ? live[i] : 0;
      mine += c[e] > 0;
    }
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh.warp_total[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nw; ++w) {
      const int v = sh.warp_total[w];
      before += w < warp ? v : 0;
      total += v;
    }
    int pos = out + before + incl - mine;
#pragma unroll
    for (int e = 0; e < COMPACT_E; ++e) {
      if (c[e] > 0) {
        cnt[pos] = c[e];
        live[pos] = l[e];
        ++pos;
      }
    }
    out += total;
    __syncthreads();
  }
  if (tid == 0) sh.n_live = out;
  __syncthreads();
}

// cp.async the divisor records of live entries [first, first + TILE) into a
// tile; the caller waits and synchronises before reading it. The entries
// padding the list to n_pad get a zero record: its quotient is 1, so with
// their count of 0 the step is a no-op (shared memory holds whatever an
// earlier launch left, which is no record at all).
template <int STRIDE>
__device__ __forceinline__ void stage(unsigned* tile, int first, int n, int n_pad,
                                      const unsigned short* live,
                                      const unsigned* consts) {
  constexpr int CHUNKS = STRIDE / 4;  // 16-byte pieces per record
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += blockDim.x) {
    const int e = i / CHUNKS, c = i % CHUNKS;
    unsigned* dst = tile + e * STRIDE + c * 4;
    if (first + e < n) {
      cp_async16(dst, consts + live[first + e] * MAX_STRIDE + c * 4);
    } else if (first + e < n_pad) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The fast-forward term of one packed shape: every packed shape must stay
// strictly above maxfit through all q repeats (docs/solver.md §4); the
// numerator can be negative (then q = 1) and maxfit can be INT32_MAX, so it
// is formed in 64 bits.
__device__ __forceinline__ int ff_term(int count, int maxfit, int k) {
  const long long numer = static_cast<long long>(count) - maxfit - 1;
  const long long term = numer < 0 ? -1 : numer / k;
  return static_cast<int>(min(term, static_cast<long long>(INT_MAX)));
}

// The whole chunk, for NRK walked resources (the used ones, in slots
// 0..nu-1; slots past nu are inert: divisor 0, total 0).
template <int NRK>
__device__ __forceinline__ void solve(const Params& p, Shared& sh, int* cnt,
                                      unsigned short* live, unsigned* tiles) {
  constexpr int STRIDE = stride_of(NRK);
  const unsigned used = p.used;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int S = p.S, T = p.T, L = p.L, cap = p.log_cap;
  const int nu = __popc(used);

  // this cluster's problem: its rows of every array
  const size_t b = blockIdx.y;
  const int* shapes = p.shapes + b * S * R;
  const int* counts_in = p.counts_in + b * S;
  const int* dropped_in = p.dropped_in + b * S;
  const int* totals = p.totals + b * T * R;
  const int* reserved0 = p.reserved0 + b * T * R;
  const unsigned char* valid = p.valid + b * T;
  const int last_valid = __ldg(&p.last_valid[b]);
  const bool lv_ok = last_valid >= 0 && last_valid < T;
  int* const out_row = p.out + b * flat_size(S, L);
  if (tid == 0) {
    sh.prices = p.prices ? p.prices + b * T : nullptr;
    sh.maxfit = p.maxfit + b * S;
    sh.log = p.log + b * 2 * T * cap;
    sh.out = out_row;
    sh.pods_unit = __ldg(&p.pods_unit[b]);
  }

  int rmap[NRK];  // slot -> resource
  {
    unsigned rest = used;
#pragma unroll
    for (int i = 0; i < NRK; ++i) {
      rmap[i] = rest ? __ffs(rest) - 1 : 0;
      rest &= rest - 1;
    }
  }

  // prologue: this CTA's copy of the divisor table, outputs, live list
  unsigned* consts = p.consts + (b * C + rank) * S * MAX_STRIDE;
  for (int s = tid; s < S; s += nt) {
    unsigned rec[STRIDE];
#pragma unroll
    for (int i = 0; i < STRIDE; ++i) rec[i] = 0;
#pragma unroll
    for (int i = 0; i < NRK; ++i) {
      const int v = i < nu ? __ldg(&shapes[s * R + rmap[i]]) : 0;
      const unsigned d = v > 0 ? static_cast<unsigned>(v) : 0u;
      rec[i] = d;
      rec[NRK + i] = 0u - d;
      rec[2 * NRK + i] = d ? 0xffffffffu / d : 0u;
      rec[3 * NRK + i] = d ? 0u : UNBOUNDED;
    }
    uint4* dst = reinterpret_cast<uint4*>(consts + s * MAX_STRIDE);
#pragma unroll
    for (int c = 0; c < STRIDE / 4; ++c) {
      dst[c] = make_uint4(rec[4 * c], rec[4 * c + 1], rec[4 * c + 2], rec[4 * c + 3]);
    }
  }
  // the flat row: counts S | dropped S | done 1 | chosen L | q L | packed L*S
  if (rank == 0) {
    for (int i = tid; i < S; i += nt) {
      out_row[i] = counts_in[i];
      out_row[S + i] = dropped_in[i];
    }
    for (int i = tid; i < L; i += nt) {
      out_row[2 * S + 1 + i] = -1;
      out_row[2 * S + 1 + L + i] = 0;
    }
  }
  const long long n_packed = static_cast<long long>(L) * S;
  for (long long i = rank * nt + tid; i < n_packed; i += static_cast<long long>(C) * nt) {
    out_row[2 * S + 1 + 2 * L + i] = 0;
  }
  for (int i = tid; i < S; i += nt) {
    cnt[i] = counts_in[i];
    live[i] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  compact(cnt, live, S, sh);

  // the type this thread walks, its constants in registers for the launch;
  // the lanes of the last warp walk nothing but its first, last_valid, and
  // it only if that type is valid (else max_pods is 0, as in the reference)
  const bool shadow = tid >= p.type_threads;
  const int t = shadow ? (lv_ok ? last_valid : 0) : rank * p.types_per_cta + tid;
  const bool exists = shadow ? lane == 0 && lv_ok : tid < p.types_per_cta && t < T;
  const bool walks = exists && valid[t] != 0;
  const bool ties = !shadow && walks;                     // takes part in the tie
  const int my_cap = shadow ? 0 : cap;                    // the shadow logs nothing
  int tot[NRK], avl0[NRK];
#pragma unroll
  for (int i = 0; i < NRK; ++i) {
    tot[i] = exists && i < nu ? __ldg(&totals[t * R + rmap[i]]) : 0;
    avl0[i] = exists && i < nu ? tot[i] - __ldg(&reserved0[t * R + rmap[i]]) : 0;
  }
  // the early-exit test on a resource no shape requests: smallest_fits is 0
  // there and the reservation stays reserved0
  bool fixed_full = false;
  if (exists) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!((used >> r) & 1u)) {
        const int tr = __ldg(&totals[t * R + r]);
        fixed_full |= tr > 0 && __ldg(&reserved0[t * R + r]) >= tr;
      }
    }
  }

  cluster.sync();  // zeroed rows visible cluster-wide, every CTA started

  bool error = !lv_ok;  // uniform over the cluster, like every exit below
  for (int it = 0; lv_ok && it < L; ++it) {
    const int n = sh.n_live;
    if (n == 0) break;
    const int par = it & 1;
    const int lo_s = live[0], hi_s = live[n - 1];

    // fits() uses raw requests, no implicit pods:1 (packable.go:118,146).
    // The early-exit test per walked resource, res + smallest_fits >= total
    // with two's-complement wrap as XLA and torch add, is thr - avl >= total
    // with thr = total + smallest_fits (res = total - avl); a total of 0
    // never tests true, and there avl stays 0, so thr = INT_MIN does that.
    int avl[NRK], thr[NRK];
#pragma unroll
    for (int i = 0; i < NRK; ++i) {
      const int sf = max(static_cast<int>(consts[hi_s * MAX_STRIDE + i]) -
                             (rmap[i] == R_PODS ? sh.pods_unit : 0), 0);
      avl[i] = avl0[i];
      thr[i] = tot[i] > 0 ? static_cast<int>(static_cast<unsigned>(tot[i]) +
                                             static_cast<unsigned>(sf))
                          : INT_MIN;
    }
    int np = 0, nl = 0;
    bool act = walks;
    int2* logs = sh.log + static_cast<size_t>(par) * T * cap;
    int2* my_log = logs + static_cast<size_t>(shadow ? 0 : t) * cap;

    // the fill: greedy over the live shapes (packable.go:111-130 for a whole
    // shape at once), tiles of divisor records double-buffered, UNROLL
    // steps between checks that the type is still active; the entries
    // padding the list to a multiple of UNROLL have count 0, a no-op step
    const int n_pad = (n + UNROLL - 1) / UNROLL * UNROLL;
    if (tid < UNROLL) cnt[n + tid] = 0;
    if (__syncthreads_or(act)) {
      stage<STRIDE>(tiles, 0, n, n_pad, live, consts);
      cp_async_wait_all();
      __syncthreads();
      for (int base = 0, b = 0;; base += TILE, b ^= 1) {
        const int end = min(base + TILE, n_pad);
        const unsigned* cur = tiles + b * TILE * MAX_STRIDE;
        if (end < n) {
          stage<STRIDE>(tiles + (b ^ 1) * TILE * MAX_STRIDE, end, n, n_pad, live, consts);
        }
        for (int e0 = base; act && e0 < end; e0 += UNROLL) {
          // the group's records and counts, loaded before its steps
          unsigned ws[UNROLL][STRIDE];
          int counts[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const uint4* rec = reinterpret_cast<const uint4*>(cur + (e0 + u - base) * STRIDE);
#pragma unroll
            for (int c = 0; c < STRIDE / 4; ++c) {
              const uint4 v = rec[c];
              ws[u][4 * c] = v.x;
              ws[u][4 * c + 1] = v.y;
              ws[u][4 * c + 2] = v.z;
              ws[u][4 * c + 3] = v.w;
            }
            counts[u] = cnt[e0 + u];
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int e = e0 + u;
            const unsigned* w = ws[u];
            const int count = counts[u];
            int k = act ? count : 0;
#pragma unroll
            for (int i = 0; i < NRK; ++i) {
              // floor(avl / d) for 0 <= avl < 2^31: umulhi is the quotient
              // or one less, and one correction makes it exact
              const unsigned a = static_cast<unsigned>(avl[i]);
              const unsigned q = __umulhi(a, w[2 * NRK + i]);
              const unsigned rem = a + q * w[NRK + i];
              k = min(k, static_cast<int>(q + w[3 * NRK + i] + (rem >= w[i] ? 1u : 0u)));
            }
            bool full = fixed_full;
#pragma unroll
            for (int i = 0; i < NRK; ++i) {
              avl[i] += k * static_cast<int>(w[NRK + i]);
              full = full | (static_cast<int>(static_cast<unsigned>(thr[i]) -
                                              static_cast<unsigned>(avl[i])) >= tot[i]);
            }
            np += k;
            const bool logged = k > 0;
            if (logged & (nl < my_cap)) __stcg(&my_log[nl], make_int2(e, k));
            nl += logged;
            act = act & ((k >= count) | (!full & (np != 0)));
          }
        }
        cp_async_wait_all();
        if (!__syncthreads_or(act) || end >= n) break;
      }
    }

    // max pods at the largest viable type: every CTA walked it
    if (shadow && exists) sh.max_pods = np;
    if (tid == 0) {
      sh.key = NO_KEY;
      sh.term = INT_MAX;
      sh.dead = 0;
    }
    __syncthreads();
    const int max_pods = sh.max_pods;

    // the first (or cheapest, then first) type tying it: min over
    // (price, index) across the cluster, never the first CTA to arrive
    unsigned long long key = NO_KEY;
    if (ties && np == max_pods) {
      const unsigned long long price =
          p.cost_tiebreak ? (static_cast<unsigned>(__ldg(&sh.prices[t])) ^ 0x80000000u) : 0u;
      key = (price << 32) | static_cast<unsigned>(t);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL_MASK, key, o));
    if (lane == 0 && key != NO_KEY) atomicMin(&sh.key, key);
    __syncthreads();
    const unsigned long long cta_best = sh.key;
    if (ties && cta_best != NO_KEY && t == static_cast<int>(cta_best & 0xffffffffu)) {
      sh.key_nlog = nl;
    }
    __syncthreads();
    if (tid < C) {
      Reduce* r = cluster.map_shared_rank(&sh.red[par], tid);
      r->key[rank] = cta_best;
      r->nlog[rank] = sh.key_nlog;
    }
    cluster.sync();
    unsigned long long best = NO_KEY;
    int nlc = -1;
    for (int c = 0; c < C; ++c) {
      if (sh.red[par].key[c] < best) {
        best = sh.red[par].key[c];
        nlc = sh.red[par].nlog[c];
      }
    }
    const int chosen = best == NO_KEY ? -1 : static_cast<int>(best & 0xffffffffu);
    const bool nothing = max_pods == 0;

    int q = 0;
    int* const out = sh.out;  // counts S | dropped S | done 1 | chosen L | q L | packed
    if (!nothing) {
      if (chosen < 0 || nlc > cap) {
        error = true;  // uniform over the cluster: every CTA read the same
        break;
      }
      const int2* lg = logs + static_cast<size_t>(chosen) * cap;
      const int* maxfit = sh.maxfit;
      int2 en[FF_REGS];
      int term = INT_MAX;
#pragma unroll
      for (int r = 0; r < FF_REGS; ++r) {
        const int i = tid + r * nt;
        en[r] = i < nlc ? __ldcg(&lg[i]) : make_int2(0, 0);
        if (i < nlc) {
          term = min(term, ff_term(cnt[en[r].x], __ldg(&maxfit[live[en[r].x]]), en[r].y));
        }
      }
      for (int i = tid + FF_REGS * nt; i < nlc; i += nt) {
        const int2 e = __ldcg(&lg[i]);
        term = min(term, ff_term(cnt[e.x], __ldg(&maxfit[live[e.x]]), e.y));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) term = min(term, __shfl_xor_sync(FULL_MASK, term, o));
      if (lane == 0) atomicMin(&sh.term, term);
      __syncthreads();
      q = static_cast<int>(max(1LL, min(1LL + sh.term, static_cast<long long>(INT_MAX))));
      int* row = out + 2 * S + 1 + 2 * L + static_cast<long long>(it) * S;
      auto apply = [&](int2 e) {
        const int s = live[e.x];
        const int c = cnt[e.x] - q * e.y;
        cnt[e.x] = c;
        if (c <= 0) sh.dead = 1;
        if (rank == 0) {
          row[s] = e.y;
          out[s] = c;
        }
      };
#pragma unroll
      for (int r = 0; r < FF_REGS; ++r) {
        if (tid + r * nt < nlc) apply(en[r]);
      }
      for (int i = tid + FF_REGS * nt; i < nlc; i += nt) apply(__ldcg(&lg[i]));
    } else if (tid == 0) {
      // drop path: the largest remaining shape fits nowhere
      // (packer.go:124-128); every pod of it fails identically
      if (rank == 0) {
        out[S + lo_s] += cnt[0];
        out[lo_s] = 0;
      }
      cnt[0] = 0;
      sh.dead = 1;
    }
    if (rank == 0 && tid == 0 && !nothing) {
      out[2 * S + 1 + it] = chosen;
      out[2 * S + 1 + L + it] = q;
    }
    __syncthreads();
    if (sh.dead) compact(cnt, live, n, sh);
  }
  if (rank == 0 && tid == 0) sh.out[2 * S] = error ? DONE_ERROR : (sh.n_live == 0 ? 1 : 0);
  cluster.sync();  // no CTA leaves while another may still address its shared memory
}

template <int NRK>
__global__ void __launch_bounds__(MAX_THREADS, 1) pack_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  int* cnt = reinterpret_cast<int*>(smem);  // S + UNROLL: the padding has count 0
  unsigned short* live = reinterpret_cast<unsigned short*>(cnt + p.S + UNROLL);
  unsigned* tiles = reinterpret_cast<unsigned*>(smem + list_bytes(p.S));
  solve<NRK>(p, sh, cnt, live, tiles);
}

}  // namespace

// B problems of one (S, T) bucket in one launch, a cluster per problem,
// every array with a leading axis of B (1 for one problem); last_valid and
// pods_unit are (B,) int32 on the device. Scratch
// (device, int32 words): consts B*cluster*S*32, log B*2*T*log_cap*2; out B
// rows of the flat buffer. used: a bit for each resource some shape
// requests (more bits are allowed: a resource no shape requests walks as a
// no-op).
extern "C" int kt_pack(const int* shapes, const int* counts, const int* dropped,
                       const int* totals, const int* reserved0,
                       const unsigned char* valid, const int* prices,
                       const int* maxfit, const int* last_valid,
                       const int* pods_unit, int B, int S, int T, int L,
                       int cost_tiebreak,
                       int used, int cluster, int log_cap, void* consts,
                       void* log, int* out, void* stream) {
  if (last_valid == nullptr || pods_unit == nullptr || used < 0 || B < 1 ||
      B > 65535 || S <= 0 || S > 65536 || T <= 0 || L < 0 ||
      (cost_tiebreak && prices == nullptr) || used >= (1 << R) || cluster < 1 ||
      cluster > MAX_CLUSTER || log_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tpc = (T + cluster - 1) / cluster;
  const int type_threads = (tpc + 31) / 32 * 32;
  if (type_threads > MAX_TYPE_THREADS) return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p = {};
  p.shapes = shapes;
  p.counts_in = counts;
  p.dropped_in = dropped;
  p.totals = totals;
  p.reserved0 = reserved0;
  p.valid = valid;
  p.prices = prices;
  p.maxfit = maxfit;
  p.last_valid = last_valid;
  p.pods_unit = pods_unit;
  p.consts = static_cast<unsigned*>(consts);
  p.log = static_cast<int2*>(log);
  p.out = out;
  p.S = S;
  p.T = T;
  p.L = L;
  p.cost_tiebreak = cost_tiebreak;
  p.log_cap = log_cap;
  p.used = static_cast<unsigned>(used);
  p.types_per_cta = tpc;
  p.type_threads = type_threads;
  const size_t smem = list_bytes(S) + 2 * TILE * MAX_STRIDE * sizeof(unsigned);
  // 3 walked resources when the shapes request at most 3, else all 8
  void (*kernel)(Params) = __builtin_popcount(p.used) <= 3 ? pack_kernel<3> : pack_kernel<8>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);  // a cluster per problem: blockIdx.y is the problem
  cfg.blockDim = dim3(type_threads + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, p);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
