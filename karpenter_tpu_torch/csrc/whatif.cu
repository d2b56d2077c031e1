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
//   valid    (NB, KB)    uint8, nonzero = valid
//   compat   (NB, KB, BB) uint8, nonzero = compatible
//   free0    (BB, R)     int32, may be negative (an overcommitted node)
//   cand_bin (NB,)       int32, the candidate's own bin, or -1
// Outputs: feasible (NB,) uint8 and slots (NB, KB) int32 (bin or -1).
//
// What bounds it on this card: latency. Each candidate is a chain of
// dependent pod steps (a pod's placement changes the free rows the next pod
// sees), run by one warp; its bytes (each valid pod's compat row once,
// pods, free0) and its compares over the card's peaks are microseconds
// (PERF.md). So the design keeps the chain short: everything a step reads
// is on chip before it runs, a step is a handful of shared loads, compares
// and ballots, and replicas skip it.
//
// Two kernels, one per geometry (ops/whatif_cuda.launch_geometry picks):
//
// whatif_staged_kernel, BB <= 4096 (a candidate's free rows fit shared
// memory). A block of 5 warps per candidate (4 blocks an SM: 96
// registers a thread, and 528 blocks at once on 132 SMs, so a 512-candidate
// window runs in one wave). Warp 0 steps through the pods; warps 1-4 stage
// the inputs on chip ahead of it, so that the step loop reads only shared
// memory and registers:
// - Static resources are folded out, exactly. A dimension r on which every
//   valid pod of the candidate asks for 0 is never debited, so its free
//   value stays free0[b][r] for the whole scan and its fit test is the
//   constant free0[b][r] >= 0. The prologue ANDs that constant, and the
//   exclusion of the candidate's own bin, into one bit a bin (smask); the
//   step compares only the active dimensions (cpu, memory and the pod slot
//   in a real window), padded to 3, 4 or 8 with folded ones (whose compare
//   is then true wherever the bin's bit is set).
// - The bins go to the stepping warp's lanes in fours: lane l owns bins
//   1024g + 128q + 4l + e (group g, block q < 8, e < 4), so one 32-bit
//   column word a lane and group holds a pod's compat bit for each of its
//   32 bins there (bit 4q + e), and the lane reads its four bins of a
//   block with one 16-byte shared load a resource. Only lane l ever reads
//   or debits its bins, so a step needs no barrier at all.
// - Pods are taken in chunks of 32: one ballot over the chunk's valid
//   flags is its list of valid pods, and the stepping warp walks its set
//   bits; invalid pods cost their slot = -1 store in the prologue and no
//   step. A producer warp reads a valid pod's compat row with coalesced
//   4-byte loads (eight a lane and group: its 4 bins of each block), packs
//   each word's four bytes into four bits (an add and a mask mark the
//   nonzero bytes, a multiply and a shift gather them), ANDs smask in, ORs
//   the lanes' words (the blocks holding any compatible bin) and stores
//   both; two pods at a time, their loads issued together. Chunks go
//   through two buffers behind named barriers (bar.arrive / bar.sync, FULL
//   and EMPTY a buffer): the producers stage chunk c + 1 while warp 0 steps
//   chunk c.
// - A step walks the blocks that hold a compatible bin in ascending order;
//   each lane tests its four bins of the block against the pod, a ballot
//   of the lanes with a fit names the lowest (lanes are in bin order), and
//   that lane debits its lowest fitting bin. With BB <= 1024 and up to 4
//   step dimensions, block 0 (where first fit puts most pods) lives in
//   registers, the next pod's inputs are read before the current pod's
//   search, and a run of the same pod (a Deployment's replicas: the same
//   vector and compat bits) skips the search: it fails where the first
//   one failed, or fills the first one's bin of block 0 while it fits,
//   because the bins below that bin did not fit this pod and have not
//   changed.
//
// whatif_global_kernel, BB > 4096 (MAX_WINDOW_CELLS makes such windows
// small in NB x KB): one block per candidate, the bins strided over its
// threads, each thread's first fit, the block minimum through shared memory
// (one barrier a step) and the owner's debit; the free rows in the
// candidate's slice of a global scratch that the wrapper allocates.
//
// Only compares, subtractions and bit operations: no division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkt_whatif.so whatif.cu
// (karpenter_tpu_torch/ops/whatif_cuda.py builds it at first use, binds
// kt_whatif with ctypes and calls kt_whatif_init once per device.)

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int R = 8;  // resource dimensions (solver/host_ffd.NUM_RESOURCES)
constexpr unsigned FULL_MASK = 0xffffffffu;

// -- the staged kernel --------------------------------------------------------

constexpr int STAGED_WARPS = 5;  // warp 0 steps, the others stage
constexpr int STAGED_THREADS = STAGED_WARPS * 32;
constexpr int PRODUCERS = STAGED_WARPS - 1;
constexpr int CHUNK = 32;  // pods a chunk: one ballot of valid flags
constexpr int NBUF = 2;    // chunk buffers
constexpr int GROUP = 1024;  // bins a column word covers: 8 blocks of 128
constexpr int BLOCK = 128;   // bins a block: four a lane
constexpr int PODS_AT_ONCE = 2;  // pods a producer warp loads together (<= 4)
// shared memory a block can opt in to on sm_90 (232,448 bytes), less a
// margin for the kernel's static shared memory
constexpr int SHARED_OPTIN = 227 * 1024;
constexpr int STATIC_MARGIN = 1024;
// named barriers (0 is __syncthreads)
constexpr int BAR_FULL = 1;                 // + buffer: a chunk staged
constexpr int BAR_EMPTY = BAR_FULL + NBUF;  // + buffer: a chunk stepped
constexpr int BAR_PRODUCERS = BAR_EMPTY + NBUF;
// producer 0's pod positions in a chunk, t = 0 (mod PRODUCERS); producer
// pw's are these shifted by pw
constexpr unsigned positions_of_producer_0() {
  unsigned m = 0;
  for (int t = 0; t < CHUNK; t += PRODUCERS) m |= 1u << t;
  return m;
}
constexpr unsigned POSITIONS = positions_of_producer_0();

// Shared memory of the staged kernel, in 32-bit words, for BB bins: the
// free rows of all R dimensions (bbr = BB rounded up to whole blocks
// each), a byte a bin of its negative dimensions, smask (a column word a
// group and lane), and NBUF chunk buffers of column words (CHUNK pods x
// groups x 32 lanes), their ORs (CHUNK x groups), pod vectors (CHUNK x R)
// and a valid mask each. ops/whatif_cuda.staged_shared_bytes mirrors it.
struct Layout {
  int groups, bbr;
  __host__ __device__ explicit Layout(int BB)
      : groups((BB + GROUP - 1) / GROUP), bbr((BB + BLOCK - 1) / BLOCK * BLOCK) {}
  __host__ __device__ int rows() const { return 0; }
  __host__ __device__ int neg() const { return R * bbr; }
  __host__ __device__ int smask() const { return neg() + bbr / 4; }
  __host__ __device__ int cw() const { return smask() + groups * 32; }
  __host__ __device__ int cw_buffer() const { return CHUNK * groups * 32; }
  __host__ __device__ int ors() const { return cw() + NBUF * cw_buffer(); }
  __host__ __device__ int vec() const { return ors() + NBUF * CHUNK * groups; }
  __host__ __device__ int cmask() const { return vec() + NBUF * CHUNK * R; }
  __host__ __device__ int words() const { return cmask() + NBUF; }
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// four bytes -> four bits, byte q to bit q, a bit set where the byte is
// not 0: bit 7 of each byte set where the byte is not 0 (its low seven
// bits plus 0x7f carry into bit 7 unless they are 0; no carry leaves the
// byte), then the products of 0x00204081 land bit 8q + 7 on bit 28 + q
// with no carry
__device__ __forceinline__ unsigned pack4(unsigned w) {
  const unsigned hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (hi * 0x00204081u) >> 28;
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

// the bins of a lane's four (bit e: bin e) where every step dimension fits
template <int NA>
__device__ __forceinline__ unsigned fits4(unsigned nibble, const int4 (&r)[NA],
                                          const int (&v)[NA]) {
  bool f0 = nibble & 1u, f1 = nibble & 2u, f2 = nibble & 4u, f3 = nibble & 8u;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    f0 = f0 && r[a].x >= v[a];
    f1 = f1 && r[a].y >= v[a];
    f2 = f2 && r[a].z >= v[a];
    f3 = f3 && r[a].w >= v[a];
  }
  return (f0 ? 1u : 0u) | (f1 ? 2u : 0u) | (f2 ? 4u : 0u) | (f3 ? 8u : 0u);
}

// r less v in the bins of the one-hot nibble oh
__device__ __forceinline__ int4 debit4(int4 r, int v, unsigned oh) {
  r.x -= (oh & 1u) ? v : 0;
  r.y -= (oh & 2u) ? v : 0;
  r.z -= (oh & 4u) ? v : 0;
  r.w -= (oh & 8u) ? v : 0;
  return r;
}

// The producers (warps 1..4): smask, then every chunk's valid mask, pod
// vectors (the step dimensions), column words and their ORs into its
// buffer.
__device__ void stage(const int* __restrict__ pod_row, const unsigned char* __restrict__ valid_row,
                      const unsigned char* __restrict__ compat_row, int* smem, Layout L,
                      unsigned active, int na, int nstep, int own, int KB, int BB) {
  const int lane = threadIdx.x & 31;
  const int ptid = threadIdx.x - 32;
  const int pw = ptid >> 5;
  const unsigned folded = ~active & 0xffu;
  // smask: the bin exists, is not the candidate's own, and no folded
  // dimension's free value is negative. Warp g builds group g's words: in
  // block q lane l owns bins 1024g + 128q + 4l + e, bit 4q + e of its word,
  // and reads their negative-dimension bytes as one word.
  if (pw < L.groups) {
    const unsigned* neg = reinterpret_cast<const unsigned*>(smem + L.neg());
    unsigned word = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int b = pw * GROUP + q * BLOCK + 4 * lane;
      if (b < L.bbr) {
        const unsigned nw = neg[b / 4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = b + e < BB && b + e != own && !((nw >> (8 * e)) & folded);
          word |= (ok ? 1u : 0u) << (4 * q + e);
        }
      }
    }
    reinterpret_cast<unsigned*>(smem + L.smask())[pw * 32 + lane] = word;
  }
  bar_sync(BAR_PRODUCERS, PRODUCERS * 32);

  const unsigned* smask = reinterpret_cast<const unsigned*>(smem + L.smask());
  const bool aligned4 = BB % 4 == 0 && (reinterpret_cast<uintptr_t>(compat_row) & 3u) == 0;
  const int dim = step_dim(active, na, lane & (R - 1));
  const unsigned positions = POSITIONS << pw;
  const int nchunks = (KB + CHUNK - 1) / CHUNK;
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c % NBUF;
    if (c >= NBUF) bar_sync(BAR_EMPTY + buf, STAGED_THREADS);
    const int k0 = c * CHUNK;
    const unsigned vmask =
        __ballot_sync(FULL_MASK, k0 + lane < KB && valid_row[k0 + lane] != 0);
    unsigned* cw = reinterpret_cast<unsigned*>(smem + L.cw()) + buf * L.cw_buffer();
    unsigned* ors = reinterpret_cast<unsigned*>(smem + L.ors()) + buf * CHUNK * L.groups;
    int* vec = smem + L.vec() + buf * CHUNK * R;
    if (pw == 0 && lane == 0) reinterpret_cast<unsigned*>(smem + L.cmask())[buf] = vmask;
    unsigned mine = vmask & positions;
    while (mine) {
      // up to PODS_AT_ONCE pods; a missing one repeats the last and stores
      // nothing
      int t[PODS_AT_ONCE];
      int n = 0;
#pragma unroll
      for (int p = 0; p < PODS_AT_ONCE; ++p) {
        t[p] = mine ? __ffs(mine) - 1 : t[p > 0 ? p - 1 : 0];
        if (mine) {
          mine &= mine - 1;
          ++n;
        }
      }
      {  // lanes pR + a copy step dimension a of pod p
        int tp = t[0];
#pragma unroll
        for (int p = 1; p < PODS_AT_ONCE; ++p) tp = lane / R == p ? t[p] : tp;
        if (lane < PODS_AT_ONCE * R && (lane & (R - 1)) < nstep)
          vec[tp * R + (lane & (R - 1))] = pod_row[(k0 + tp) * R + dim];
      }
      for (int g = 0; g < L.groups; ++g) {
        unsigned w[PODS_AT_ONCE][8];
        if (aligned4) {
#pragma unroll
          for (int p = 0; p < PODS_AT_ONCE; ++p) {
            const unsigned char* row = compat_row + static_cast<size_t>(k0 + t[p]) * BB;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int b = g * GROUP + q * BLOCK + 4 * lane;
              w[p][q] = b + 4 <= BB ? __ldg(reinterpret_cast<const unsigned*>(row + b)) : 0u;
            }
          }
        } else {  // compat at an odd address or BB not a multiple of 4
#pragma unroll
          for (int p = 0; p < PODS_AT_ONCE; ++p) {
            const unsigned char* row = compat_row + static_cast<size_t>(k0 + t[p]) * BB;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int b = g * GROUP + q * BLOCK + 4 * lane;
              unsigned x = 0;
#pragma unroll 1
              for (int e = 0; e < 4 && b + e < BB; ++e) x |= static_cast<unsigned>(row[b + e]) << (8 * e);
              w[p][q] = x;
            }
          }
        }
        const unsigned sm = smask[g * 32 + lane];
#pragma unroll
        for (int p = 0; p < PODS_AT_ONCE; ++p) {
          unsigned col = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) col |= pack4(w[p][q]) << (4 * q);
          col &= sm;
          const unsigned any = __reduce_or_sync(FULL_MASK, col);
          if (p < n) {
            cw[(t[p] * L.groups + g) * 32 + lane] = col;
            if (lane == 0) ors[t[p] * L.groups + g] = any;
          }
        }
      }
    }
    bar_arrive(BAR_FULL + buf, STAGED_THREADS);
  }
}

// One pod's first fit over every group (BB > 1024): walk the blocks its
// ORs mark, in ascending order; the lowest lane with a fit debits its
// lowest fitting bin. Returns the bin or -1 (the same in every lane).
template <int NA>
__device__ __forceinline__ int place_groups(const unsigned* cw_pod, const unsigned* ors_pod,
                                            int* const (&rp)[NA], const int (&vec)[NA],
                                            int groups, int lane) {
  for (int g = 0; g < groups; ++g) {
    const unsigned c = cw_pod[g * 32 + lane];
    unsigned blocks = ors_pod[g];
    while (blocks) {
      const int q = (__ffs(blocks) - 1) >> 2;
      const int off = g * GROUP + q * BLOCK;
      int4 r[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) r[a] = *reinterpret_cast<const int4*>(rp[a] + off);
      const unsigned fit = fits4<NA>((c >> (4 * q)) & 0xfu, r, vec);
      const unsigned hit = __ballot_sync(FULL_MASK, fit != 0);
      if (hit) {
        const int owner = __ffs(hit) - 1;
        const unsigned oh = lane == owner ? fit & (0u - fit) : 0u;
        if (oh) {
#pragma unroll
          for (int a = 0; a < NA; ++a)
            *reinterpret_cast<int4*>(rp[a] + off) = debit4(r[a], vec[a], oh);
        }
        const int e = (__ballot_sync(FULL_MASK, oh & 0xau) ? 1 : 0) |
                      (__ballot_sync(FULL_MASK, oh & 0xcu) ? 2 : 0);
        return off + 4 * owner + e;
      }
      blocks &= ~(0xfu << (4 * q));
    }
  }
  return -1;
}

// The stepping warp (warp 0): each chunk's valid pods in order. rp[a] is
// the lane's first bin in the free row of step dimension a. With one group
// (BB <= 1024) and up to 4 step dimensions (the fast path): the lane's
// four bins of block 0 (where first fit places most pods) live in
// registers; the next pod's vector and words are read before the current
// pod's search; the owner lane of the chosen bin debits it; and a run of
// the same pod (replicas: the same vector and compat row) goes where the
// first one went without a search: nowhere if it failed, else into its
// bin of block 0 as many times as fit.
template <int NA>
__device__ void step(int* smem, Layout L, unsigned active, int na, int KB,
                     int* __restrict__ slot_row, unsigned char* __restrict__ feasible_out) {
  const int lane = threadIdx.x & 31;
  int* rp[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) rp[a] = smem + L.rows() + step_dim(active, na, a) * L.bbr + 4 * lane;
  const bool fast = NA <= 4 && L.groups == 1;
  int4 b0[NA];  // block 0, on the fast path
#pragma unroll
  for (int a = 0; a < NA; ++a) b0[a] = *reinterpret_cast<const int4*>(rp[a]);
  bool ok = true;
  const int nchunks = (KB + CHUNK - 1) / CHUNK;
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c % NBUF;
    bar_sync(BAR_FULL + buf, STAGED_THREADS);
    unsigned m = reinterpret_cast<const unsigned*>(smem + L.cmask())[buf];
    const unsigned* cw = reinterpret_cast<const unsigned*>(smem + L.cw()) + buf * L.cw_buffer();
    const unsigned* ors =
        reinterpret_cast<const unsigned*>(smem + L.ors()) + buf * CHUNK * L.groups;
    const int* vec = smem + L.vec() + buf * CHUNK * R;
    int* slots_c = slot_row + c * CHUNK;
    if (fast) {
      int t = m ? __ffs(m) - 1 : 0;
      int vn[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) vn[a] = vec[t * R + a];
      unsigned coln = cw[t * 32 + lane], blocksn = ors[t];
      // pops the next pod of m into t and reads the one after it ahead
      auto advance = [&](int (&v)[NA], unsigned& col, unsigned& blocks) {
        t = __ffs(m) - 1;
        m &= m - 1;
#pragma unroll
        for (int a = 0; a < NA; ++a) v[a] = vn[a];
        col = coln;
        blocks = blocksn;
        const int tn = m ? __ffs(m) - 1 : t;
#pragma unroll
        for (int a = 0; a < NA; ++a) vn[a] = vec[tn * R + a];
        coln = cw[tn * 32 + lane];
        blocksn = ors[tn];
      };
      // whether the next pod is this one again: the same vector and the
      // same compatible bins, so it goes where this one went or further
      auto next_same = [&](const int (&v)[NA], unsigned col) {
        bool same = m != 0;
#pragma unroll
        for (int a = 0; a < NA; ++a) same = same && vn[a] == v[a];
        return __all_sync(FULL_MASK, same && coln == col);
      };
      while (m) {
        int v[NA];
        unsigned col, blocks;
        advance(v, col, blocks);
        int chosen = -1;
        unsigned oh = 0;  // block 0's chosen bin, one-hot in its owner lane
        if (blocks & 0xfu) {  // block 0, in registers
          const unsigned fit = fits4<NA>(col & 0xfu, b0, v);
          const unsigned hit = __ballot_sync(FULL_MASK, fit != 0);
          if (hit) {
            const int owner = __ffs(hit) - 1;
            oh = lane == owner ? fit & (0u - fit) : 0u;
#pragma unroll
            for (int a = 0; a < NA; ++a) b0[a] = debit4(b0[a], v[a], oh);
            chosen = 4 * owner + ((__ballot_sync(FULL_MASK, oh & 0xau) ? 1 : 0) |
                                  (__ballot_sync(FULL_MASK, oh & 0xcu) ? 2 : 0));
          }
          blocks &= ~0xfu;
        }
        while (chosen < 0 && blocks) {  // blocks 1..7, in shared memory
          const int q = (__ffs(blocks) - 1) >> 2;
          int4 r[NA];
#pragma unroll
          for (int a = 0; a < NA; ++a) r[a] = *reinterpret_cast<const int4*>(rp[a] + q * BLOCK);
          const unsigned fit = fits4<NA>((col >> (4 * q)) & 0xfu, r, v);
          const unsigned hit = __ballot_sync(FULL_MASK, fit != 0);
          if (hit) {
            const int owner = __ffs(hit) - 1;
            const unsigned own = lane == owner ? fit & (0u - fit) : 0u;
            if (own) {
#pragma unroll
              for (int a = 0; a < NA; ++a)
                *reinterpret_cast<int4*>(rp[a] + q * BLOCK) = debit4(r[a], v[a], own);
            }
            chosen = q * BLOCK + 4 * owner + ((__ballot_sync(FULL_MASK, own & 0xau) ? 1 : 0) |
                                              (__ballot_sync(FULL_MASK, own & 0xcu) ? 2 : 0));
          }
          blocks &= ~(0xfu << (4 * q));
        }
        ok &= chosen >= 0;
        slots_c[t] = chosen;  // every lane: one address, one value
        if (chosen < 0) {
          // the same pod again fails again: no bin changed
          while (next_same(v, col)) {
            advance(v, col, blocks);
            slots_c[t] = -1;
          }
        } else if (chosen < BLOCK && next_same(v, col)) {
          // the same pod again goes into the same bin while it fits: the
          // bins below it did not fit this vector and have not changed.
          // The bin's free values, in every lane, until the run ends.
          const int owner = chosen >> 2;
          const int e = chosen & 3;
          int fb[NA];
          bool fits = true;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            fb[a] = __shfl_sync(FULL_MASK, e == 0 ? b0[a].x : e == 1 ? b0[a].y
                                           : e == 2 ? b0[a].z : b0[a].w, owner);
            fits = fits && fb[a] >= v[a];
          }
          int copies = 0;
          while (fits) {
            advance(v, col, blocks);
            slots_c[t] = chosen;
            ++copies;
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              fb[a] -= v[a];
              fits = fits && fb[a] >= v[a];
            }
            fits = fits && next_same(v, col);
          }
#pragma unroll
          for (int a = 0; a < NA; ++a) b0[a] = debit4(b0[a], v[a] * copies, oh);
        }
      }
    } else {
      while (m) {
        const int t = __ffs(m) - 1;
        m &= m - 1;
        int v[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) v[a] = vec[t * R + a];
        const int chosen =
            place_groups<NA>(cw + t * L.groups * 32, ors + t * L.groups, rp, v, L.groups, lane);
        ok &= chosen >= 0;
        if (lane == 0) slots_c[t] = chosen;
      }
    }
    if (c + NBUF < nchunks) bar_arrive(BAR_EMPTY + buf, STAGED_THREADS);
  }
  if (lane == 0) *feasible_out = ok ? 1 : 0;
}

__global__ void __launch_bounds__(STAGED_THREADS, 4)
whatif_staged_kernel(const int* __restrict__ pods, const unsigned char* __restrict__ valid,
                     const unsigned char* __restrict__ compat, const int* __restrict__ free0,
                     const int* __restrict__ cand_bin, unsigned char* __restrict__ feasible,
                     int* __restrict__ slots, int KB, int BB) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned warp_dims[STAGED_WARPS];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* pod_row = pods + static_cast<size_t>(i) * KB * R;
  const unsigned char* valid_row = valid + static_cast<size_t>(i) * KB;
  const unsigned char* compat_row = compat + static_cast<size_t>(i) * KB * BB;
  int* slot_row = slots + static_cast<size_t>(i) * KB;
  const Layout L(BB);

  // the free rows of every dimension and a byte a bin of its negative
  // ones (the loop unrolled so that a thread's loads are in flight
  // together); the dimensions some valid pod asks for (bit 8: some pod is
  // valid); an invalid pod's slot is -1
  unsigned char* neg = reinterpret_cast<unsigned char*>(smem + L.neg());
#pragma unroll 4
  for (int b = tid; b < L.bbr; b += STAGED_THREADS) {
    unsigned n = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = b < BB ? __ldg(free0 + static_cast<size_t>(b) * R + r) : 0;
      smem[L.rows() + r * L.bbr + b] = v;
      n |= (v < 0 ? 1u : 0u) << r;
    }
    neg[b] = static_cast<unsigned char>(n);
  }
  unsigned dims = 0;
  for (int k = tid; k < KB; k += STAGED_THREADS) {
    int vk[R];
#pragma unroll
    for (int r = 0; r < R; ++r) vk[r] = pod_row[k * R + r];
    if (valid_row[k] != 0) {
      dims |= 1u << R;
#pragma unroll
      for (int r = 0; r < R; ++r) dims |= (vk[r] != 0 ? 1u : 0u) << r;
    } else {
      slot_row[k] = -1;
    }
  }
  dims = __reduce_or_sync(FULL_MASK, dims);
  if (lane == 0) warp_dims[warp] = dims;
  __syncthreads();
  dims = 0;
#pragma unroll
  for (int w = 0; w < STAGED_WARPS; ++w) dims |= warp_dims[w];
  if (!(dims >> R)) {  // no valid pod: nothing to place
    if (tid == 0) feasible[i] = 1;
    return;
  }
  const unsigned active = dims & 0xffu;
  const int na = __popc(active);
  const int nstep = na <= 3 ? 3 : na <= 4 ? 4 : R;
  if (warp == 0) {
    if (nstep == 3)
      step<3>(smem, L, active, na, KB, slot_row, feasible + i);
    else if (nstep == 4)
      step<4>(smem, L, active, na, KB, slot_row, feasible + i);
    else
      step<R>(smem, L, active, na, KB, slot_row, feasible + i);
  } else {
    stage(pod_row, valid_row, compat_row, smem, L, active, na, nstep, cand_bin[i], KB, BB);
  }
}

// -- the global kernel (BB > 4096) --------------------------------------------

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

__global__ void __launch_bounds__(MAX_THREADS)
whatif_global_kernel(const int* __restrict__ pods, const unsigned char* __restrict__ valid,
                     const unsigned char* __restrict__ compat, const int* __restrict__ free0,
                     const int* __restrict__ cand_bin, unsigned char* __restrict__ feasible,
                     int* __restrict__ slots, int* __restrict__ scratch, int KB, int BB) {
  __shared__ int warp_min[2][MAX_WARPS];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  // this candidate's free rows, [r * BB + b]; thread t owns the bins
  // b = t (mod blockDim) and is the only thread that reads or writes them
  int* rows = scratch + static_cast<size_t>(i) * BB * R;
  for (int b = tid; b < BB; b += nthreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) rows[r * BB + b] = free0[b * R + r];
  }

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

size_t staged_smem_bytes(int BB) {
  return static_cast<size_t>(Layout(BB).words()) * sizeof(int);
}

}  // namespace

// Once per device, before the first launch: the staged kernel's opt-in to
// the most dynamic shared memory it launches with (a block's 227 KiB less
// the static margin; the launch then sets nothing).
extern "C" int kt_whatif_init() {
  return static_cast<int>(cudaFuncSetAttribute(whatif_staged_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SHARED_OPTIN - STATIC_MARGIN));
}

// use_smem: the staged kernel (threads must be its STAGED_THREADS, and its
// shared memory for BB must fit); else the global kernel with the free
// rows in scratch (NB x R x BB int32) and threads in whole warps up to 512
// (ops/whatif_cuda.launch_geometry).
extern "C" int kt_whatif(const int* pods, const unsigned char* valid,
                         const unsigned char* compat, const int* free0,
                         const int* cand_bin, unsigned char* feasible, int* slots,
                         int* scratch, int NB, int KB, int BB, int threads,
                         int use_smem, void* stream) {
  if (NB < 1 || KB < 1 || BB < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_smem) {
    const size_t smem = staged_smem_bytes(BB);
    if (threads != STAGED_THREADS || smem > static_cast<size_t>(SHARED_OPTIN - STATIC_MARGIN))
      return static_cast<int>(cudaErrorInvalidValue);
    whatif_staged_kernel<<<NB, STAGED_THREADS, smem, s>>>(pods, valid, compat, free0, cand_bin,
                                                          feasible, slots, KB, BB);
  } else {
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    whatif_global_kernel<<<NB, threads, 0, s>>>(pods, valid, compat, free0, cand_bin, feasible,
                                                slots, scratch, KB, BB);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kt_whatif_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
