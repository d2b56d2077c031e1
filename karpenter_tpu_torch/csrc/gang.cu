// Gang co-pack first fit for Hopper (sm_90a): for each gang of a window,
// first-fit its members, in order, into its own copy of the window's shared
// pool of prospective nodes, and report whether every valid member was
// placed and where.
//
// Replaces the XLA device program karpenter_tpu/solver/gang.py::_gang_jit
// (gang.py:56-79: a jax.vmap over gangs of a jax.lax.scan over members). It
// computes exactly what that program computes, slots included: the scan
// never stops at a member that fits nowhere (its slot is -1 and the gang is
// infeasible), so the later members of an infeasible gang are still placed
// (and debited) where they fit. There is no own bin.
//
// Inputs, as ops/gang.encode_gang_window pads them (GB, KB, BB powers of
// two; any shape is taken):
//   pods   (GB, KB, R) int32, GCD-scaled reserve vectors
//   valid  (GB, KB)    uint8, nonzero = a real member
//   compat (GB, BB)    uint8, nonzero = the gang may use the bin (the carve
//                      verdict already ANDed in): one row a gang
//   free0  (BB, R)     int32, may be negative (an overcommitted seed node)
// Outputs: feasible (GB,) uint8 and slots (GB, KB) int32 (bin or -1).
//
// What bounds it on this card: latency. A gang is a chain of dependent
// member steps (a placement changes what the next member sees), and its
// bytes (a compat row, the members, the free0 rows first fit reaches) and
// compares over the card's peaks are nanoseconds (PERF.md). The what-if
// kernel (csrc/whatif.cu), which answered gang windows before, staged a
// private copy of every bin's free rows a gang (171,528 B of shared memory
// at BB = 4096: one block an SM, eight waves at full width) and a compat
// row a member, though a gang has one compat row and first fit reaches only
// the first bins. The design here keeps what a gang owns small, so that the
// whole window is resident at once, and keeps the step on chip:
// - A warp a gang, four gangs a block, no barrier: warps never wait on
//   each other.
// - A shared, read-only pool. Every gang starts from the same free0 and
//   its pool differs from it only at the bins its own members took (at
//   most min(KB, BB)). Those debits are private, copy on write: a table of
//   (bin, free values) entries, entry e held by lane e % 32 (the first 32
//   in registers, the rest spilled to the gang's state). Every other bin is
//   read from free0, which all gangs share through L1 and L2.
// - The compat row is packed to bits as the search first reaches it, 32
//   bins a word and eight words at once (their byte loads in flight
//   together), so a search skips a word of incompatible bins without
//   touching device memory. A lane's free0 row is read when the search
//   first tests its word and is cached with it; a bin with a folded
//   resource below 0 (below) leaves the word then. A bin's bit is cleared
//   when a member takes it (it moves to the table), so a word holds the
//   compatible bins still at free0. The gang's state is those words (BB /
//   32) and the spilled entries; at full width (1,024 x 16 x 4,096) 512 B
//   a gang, and the window runs in one wave.
// - A member step: each lane tests its table entries (a register compare
//   for the first 32), a warp minimum names the lowest taken bin that fits;
//   then the words below it, from bin 0 up, are tested 32 bins at a time
//   against free0 (the lane's bin's free0 row is cached in registers with
//   its word), and a ballot names the lowest fit. The lower of the two
//   wins; a taken bin is debited by the lane that holds its entry, an
//   untaken one becomes a new entry. The members' vectors are loaded 32 at
//   a time, one a lane, and broadcast with shuffles; the slots are stored
//   32 at a time.
// - Replicas (a member with the vector of the last valid one: a slice's
//   workers, a gang's identical pods) skip the search, exactly, as in
//   csrc/whatif.cu:67-71: every bin below the last one's did not fit that
//   vector and has not grown, so a replica goes into the last one's bin
//   while it fits (one vote of the lanes), fails where the last one failed,
//   and otherwise searches from the last one's word up. The search also
//   starts past the leading words that hold no untaken compatible bin
//   (bits are only ever cleared).
// - Static resources are folded out, exactly, as in csrc/whatif.cu:35-43.
//   A dimension on which every valid member of the gang asks for 0 is
//   never debited, so its fit test is the constant free0[b][r] >= 0: it is
//   ANDed into the bin's bit when the word is first tested, and a step compares
//   only the active dimensions (cpu, memory and the pod slot in a real
//   window), padded to 3, 4 or 8 with folded ones.
// - Two geometries (ops/gang_cuda.launch_geometry picks by shape): the
//   gangs' state in shared memory while four gangs' state fits 48 KB (BB up
//   to 8,192 with up to 300-odd spilled entries), else in a global scratch
//   the wrapper allocates (a window with one huge gang or pool). The code
//   is the same; only the state's address space differs.
//
// Only compares, subtractions and bit operations: no division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkt_gang.so gang.cu
// (karpenter_tpu_torch/ops/gang_cuda.py builds it at first use and binds
// kt_gang with ctypes.)

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int R = 8;  // resource dimensions (solver/host_ffd.NUM_RESOURCES)
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 4;  // gangs a block
constexpr int THREADS = WARPS * 32;
constexpr int ENTRY = R + 1;  // words of a spilled entry: bin, then free values
constexpr int AHEAD = 8;      // column words packed at once: 256 bins
// dynamic shared memory the shared geometry may use (no opt-in needed)
constexpr int SHARED_LIMIT = 48 * 1024;

// int32 words of a gang's state: the column words, then the entries past
// the 32 the lanes hold (ops/gang_cuda.state_words mirrors it)
__host__ __device__ long long state_words(int KB, int BB) {
  const long long cap = KB < BB ? KB : BB;
  return (BB + 31LL) / 32 + (cap > 32 ? (cap - 32) * ENTRY : 0);
}

// the n-th set bit of m (n from 0)
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int q = 0; q < n; ++q) m &= m - 1;
  return __ffs(m) - 1;
}

// dimension a of the step: the active ones first, then folded ones
__device__ __forceinline__ int step_dim(unsigned active, int na, int a) {
  return a < na ? nth_bit(active, a) : nth_bit(~active & 0xffu, a - na);
}

// int32 subtraction that wraps, as the XLA program's and the plain
// version's int32 arithmetic does
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

template <int NA>
__device__ __forceinline__ bool fits(const int (&f)[NA], const int (&v)[NA]) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < NA; ++a) ok = ok && f[a] >= v[a];
  return ok;
}

// One gang's scan by one warp. state: the gang's column words, then its
// spilled entries (shared or global memory).
template <int NA>
__device__ void scan(const int* __restrict__ pod_row, const unsigned char* __restrict__ valid_row,
                     const unsigned char* __restrict__ compat_row, const int* __restrict__ free0,
                     int* state, unsigned active, int na, int KB, int BB,
                     int* __restrict__ slot_row, unsigned char* __restrict__ feasible_out) {
  const int lane = threadIdx.x & 31;
  unsigned* words = reinterpret_cast<unsigned*>(state);
  int* spill = state + (BB + 31) / 32;
  const unsigned folded = ~active & 0xffu;
  int dim[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) dim[a] = step_dim(active, na, a);

  // the entry this lane holds in registers: entry `lane`
  int eb = -1;
  int ef[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) ef[a] = 0;
  int n = 0;       // entries (taken bins)
  int hi = 0;      // column words packed: chunks [0, hi)
  int cc = -1;     // the chunk cached in registers: its word and this lane's free0 values
  unsigned wc = 0;
  int f[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) f[a] = 0;
  int zc = 0;  // the chunks below zc hold no untaken compatible bin
  // the last valid member: its vector and its bin (-1: it fit nowhere)
  bool have_prev = false;
  int pv[NA], pchosen = -1;
#pragma unroll
  for (int a = 0; a < NA; ++a) pv[a] = 0;
  bool ok = true;

  for (int k0 = 0; k0 < KB; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < KB;
    const unsigned m0 = __ballot_sync(FULL_MASK, in && valid_row[k] != 0);
    unsigned m = m0;
    int mv[NA];  // member k's step dimensions
#pragma unroll
    for (int a = 0; a < NA; ++a) mv[a] = in ? __ldg(pod_row + static_cast<size_t>(k) * R + dim[a]) : 0;
    int myslot = -1;
    while (m) {
      const int t = __ffs(m) - 1;
      m &= m - 1;
      int v[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) v[a] = __shfl_sync(FULL_MASK, mv[a], t);
      // the same vector as the last member (a replica): every bin below the
      // last one's bin did not fit it and has not grown since, and if it
      // fit nowhere, this one fits nowhere
      bool same = have_prev;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        same = same && v[a] == pv[a];
        pv[a] = v[a];
      }
      have_prev = true;
      if (same && pchosen < 0) {
        ok = false;
        if (lane == t) myslot = -1;
        continue;
      }
      if (same) {  // it goes where the last one went while that bin fits
        const bool hold = eb == pchosen && fits<NA>(ef, v);
        if (__any_sync(FULL_MASK, hold)) {
          if (hold) {
#pragma unroll
            for (int a = 0; a < NA; ++a) ef[a] = wrap_sub(ef[a], v[a]);
          }
          if (lane == t) myslot = pchosen;
          continue;
        }
      }

      // the lowest taken bin that fits: this lane's entries
      int best = INT_MAX, beste = -1;
      if (eb >= 0 && fits<NA>(ef, v)) {
        best = eb;
        beste = lane;
      }
      for (int e = lane + 32; e < n; e += 32) {
        const int* ent = spill + (e - 32) * ENTRY;
        int g[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) g[a] = ent[1 + a];
        if (fits<NA>(g, v) && ent[0] < best) {
          best = ent[0];
          beste = e;
        }
      }
      const int bt = __reduce_min_sync(FULL_MASK, best);

      // the lowest untaken bin below it that fits, 32 bins a step
      const int limit = bt < BB ? bt : BB;
      int bu = INT_MAX;
      for (int c = same ? max(zc, pchosen >> 5) : zc; 32 * c < limit; ++c) {
        if (c >= hi) {
          // pack the next AHEAD words of the compat row, their byte loads
          // in flight together
          const int n = min(AHEAD, (BB + 31) / 32 - hi);
          bool bits[AHEAD];
#pragma unroll
          for (int j = 0; j < AHEAD; ++j) {
            const int b = 32 * (hi + j) + lane;
            bits[j] = j < n && b < BB && compat_row[b] != 0;
          }
#pragma unroll
          for (int j = 0; j < AHEAD; ++j) {
            const unsigned w = __ballot_sync(FULL_MASK, bits[j]);
            if (j < n) words[hi + j] = w;  // every lane: one address, one value
          }
          hi += n;
        }
        if (c != cc) {
          const unsigned w = words[c];
          if (w == 0) {
            zc += c == zc;
            continue;
          }
          // the chunk into the cache: each lane's free0 row; a bin with a
          // folded dimension below 0 fits no member of this gang and
          // leaves the word for good
          const int b = 32 * c + lane;
          bool keep = false;
          if (b < BB) {
            int row[R];
#pragma unroll
            for (int r = 0; r < R; ++r) row[r] = __ldg(free0 + static_cast<size_t>(b) * R + r);
            unsigned neg = 0;
#pragma unroll
            for (int r = 0; r < R; ++r) neg |= (row[r] < 0 ? 1u : 0u) << r;
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              int x = row[0];
#pragma unroll
              for (int r = 1; r < R; ++r) x = dim[a] == r ? row[r] : x;
              f[a] = x;
            }
            keep = !(neg & folded);
          }
          wc = w & __ballot_sync(FULL_MASK, keep);
          words[c] = wc;
          cc = c;
        }
        if (wc == 0) {
          zc += c == zc;
          continue;
        }
        const unsigned hit = __ballot_sync(FULL_MASK, ((wc >> lane) & 1u) && fits<NA>(f, v));
        if (hit) {
          const int b = 32 * c + __ffs(hit) - 1;
          if (b < bt) bu = b;
          break;
        }
      }

      int chosen = -1;
      if (bu != INT_MAX) {
        // a new entry, from the owner lane's free0 values; the bin leaves
        // its word
        const int owner = bu & 31;
        int nf[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) nf[a] = __shfl_sync(FULL_MASK, wrap_sub(f[a], v[a]), owner);
        if (n < 32) {
          if (lane == n) {
            eb = bu;
#pragma unroll
            for (int a = 0; a < NA; ++a) ef[a] = nf[a];
          }
        } else if (lane == (n & 31)) {
          int* ent = spill + (n - 32) * ENTRY;
          ent[0] = bu;
#pragma unroll
          for (int a = 0; a < NA; ++a) ent[1 + a] = nf[a];
        }
        ++n;
        wc &= ~(1u << owner);
        words[cc] = wc;
        chosen = bu;
      } else if (bt != INT_MAX) {
        if (best == bt) {  // the one lane that holds the taken bin's entry
          if (beste < 32) {
#pragma unroll
            for (int a = 0; a < NA; ++a) ef[a] = wrap_sub(ef[a], v[a]);
          } else {
            int* ent = spill + (beste - 32) * ENTRY;
#pragma unroll
            for (int a = 0; a < NA; ++a) ent[1 + a] = wrap_sub(ent[1 + a], v[a]);
          }
        }
        chosen = bt;
      } else {
        ok = false;
      }
      pchosen = chosen;
      if (lane == t) myslot = chosen;
    }
    if ((m0 >> lane) & 1u) slot_row[k] = myslot;
  }
  if (lane == 0) *feasible_out = ok ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
gang_kernel(const int* __restrict__ pods, const unsigned char* __restrict__ valid,
            const unsigned char* __restrict__ compat, const int* __restrict__ free0,
            unsigned char* __restrict__ feasible, int* __restrict__ slots,
            int* __restrict__ scratch, int GB, int KB, int BB) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= GB) return;
  const int* pod_row = pods + static_cast<size_t>(g) * KB * R;
  const unsigned char* valid_row = valid + static_cast<size_t>(g) * KB;
  const unsigned char* compat_row = compat + static_cast<size_t>(g) * BB;
  int* slot_row = slots + static_cast<size_t>(g) * KB;
  const long long words = state_words(KB, BB);
  int* state = scratch != nullptr ? scratch + g * words : smem + warp * words;

  // the dimensions some valid member asks for (bit R: some member is
  // valid); an invalid member's slot is -1
  unsigned dims = 0;
  for (int k = lane; k < KB; k += 32) {
    if (valid_row[k] != 0) {
      dims |= 1u << R;
#pragma unroll
      for (int r = 0; r < R; ++r) dims |= (pod_row[static_cast<size_t>(k) * R + r] != 0 ? 1u : 0u) << r;
    } else {
      slot_row[k] = -1;
    }
  }
  dims = __reduce_or_sync(FULL_MASK, dims);
  if (!(dims >> R)) {  // no valid member: nothing to place
    if (lane == 0) feasible[g] = 1;
    return;
  }
  const unsigned active = dims & 0xffu;
  const int na = __popc(active);
  if (na <= 3)
    scan<3>(pod_row, valid_row, compat_row, free0, state, active, na, KB, BB, slot_row, feasible + g);
  else if (na <= 4)
    scan<4>(pod_row, valid_row, compat_row, free0, state, active, na, KB, BB, slot_row, feasible + g);
  else
    scan<R>(pod_row, valid_row, compat_row, free0, state, active, na, KB, BB, slot_row, feasible + g);
}

}  // namespace

// One launch on `stream`: 0, or the CUDA error of a refused launch.
// scratch == nullptr: the shared geometry (four gangs' state must fit
// SHARED_LIMIT); else the global one, scratch holding GB gangs' state
// (ops/gang_cuda.launch_geometry).
extern "C" int kt_gang(const int* pods, const unsigned char* valid, const unsigned char* compat,
                       const int* free0, unsigned char* feasible, int* slots, int* scratch,
                       int GB, int KB, int BB, void* stream) {
  if (pods == nullptr || valid == nullptr || compat == nullptr || free0 == nullptr ||
      feasible == nullptr || slots == nullptr || GB < 1 || KB < 1 || BB < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long shared = scratch != nullptr ? 0 : WARPS * state_words(KB, BB) * 4;
  if (shared > SHARED_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (GB + WARPS - 1) / WARPS;
  gang_kernel<<<blocks, THREADS, static_cast<size_t>(shared), static_cast<cudaStream_t>(stream)>>>(
      pods, valid, compat, free0, feasible, slots, scratch, GB, KB, BB);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_gang_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
