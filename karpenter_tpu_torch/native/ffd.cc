// Native host-side FFD pack kernel (the native host ring).
//
// The port's solver has three executors over the same encoded problem
// (karpenter_tpu_torch/ops/encode.py):
//   1. the CUDA pack kernel (csrc/pack.cu)    — windows at or above the gate
//   2. this C++ kernel                        — problems under the gate
//   3. the per-pod Python oracle (host_ffd)   — Go-parity reference
// All three are differentially tested to the node count. The algorithm is
// the shape-level greedy with fast-forward: semantics of the reference Go
// packer's packWithLargestPod loop (packer.go:114-141,167-198) lifted from
// per-pod to per-shape, identical to ops/pack.py / models/ffd.solve_ffd_numpy.
// It is the JAX package's karpenter_tpu/native/ffd.cc, function for function.
//
// Inputs arrive pre-scaled (encode()'s GCD scaling keeps every value within
// int32), so int64 arithmetic here cannot overflow: k*shape <= 2^31 * 2^31.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int64_t kInf = INT64_C(2147483647);  // matches _INT32_MAX fast-forward
}

extern "C" {

// Packs counts[s] pods of shapes[s] onto instances of types totals[t].
// Returns the number of (chosen, qty, packed[s]) records written, or -1 if
// max_records was too small. All matrices are row-major.
//
//   shapes    (S, R)  per-shape reserve vector (pods dim includes the +1)
//   counts    (S,)    pods per shape; CONSUMED (copied internally)
//   totals    (T, R)  instance capacity, ascending packable order
//   reserved0 (T, R)  overhead + daemons already reserved
//   pods_unit         one pod in device units on the pods dimension
//   r_pods            index of the pods dimension
//
// Outputs:
//   out_chosen  (max_records,)     instance-type index per record
//   out_qty     (max_records,)     identical nodes for this record
//   out_packed  (max_records, S)   pods-per-shape on each such node
//   out_dropped (S,)               unpackable pods per shape
//   prices    (T,) effective micro-$/h per type, or nullptr; with
//             cost_tiebreak != 0 the cheapest max-pods type wins the tie
//             (capacity order on price ties) — beyond-reference cost mode.
int64_t kt_ffd_pack(
    const int64_t* shapes, const int64_t* counts_in,
    const int64_t* totals, const int64_t* reserved0,
    int64_t S, int64_t T, int64_t R, int64_t pods_unit, int64_t r_pods,
    int64_t* out_chosen, int64_t* out_qty, int64_t* out_packed,
    int64_t* out_dropped, int64_t max_records,
    const int64_t* prices, int64_t cost_tiebreak) {
  std::vector<int64_t> counts(counts_in, counts_in + S);
  std::vector<int64_t> dropped(S, 0);

  // maxfit[s]: most pods of shape s any EMPTY instance fits — the
  // fast-forward validity bound (docs/solver.md).
  std::vector<int64_t> maxfit(S, 0);
  for (int64_t s = 0; s < S; ++s) {
    int64_t best = 0;
    for (int64_t t = 0; t < T; ++t) {
      int64_t k = kInf;
      for (int64_t r = 0; r < R; ++r) {
        const int64_t need = shapes[s * R + r];
        if (need > 0) {
          const int64_t avail = totals[t * R + r] - reserved0[t * R + r];
          const int64_t kr = avail >= 0 ? avail / need : 0;
          if (kr < k) k = kr;
        }
      }
      if (k > best) best = k;
    }
    maxfit[s] = best;
  }


  std::vector<int64_t> reserved(T * R);
  std::vector<char> stopped(T);
  std::vector<int64_t> npacked(T);
  std::vector<int64_t> k_all(S * T);
  std::vector<int64_t> smallest_fits(R);

  int64_t n_records = 0;
  for (;;) {
    int64_t largest = -1, smallest = -1;
    for (int64_t s = 0; s < S; ++s) {
      if (counts[s] > 0) {
        if (largest < 0) largest = s;
        smallest = s;
      }
    }
    if (largest < 0) break;

    for (int64_t r = 0; r < R; ++r) {
      int64_t v = shapes[smallest * R + r];
      if (r == r_pods) v -= pods_unit;
      smallest_fits[r] = v > 0 ? v : 0;
    }

    std::memcpy(reserved.data(), reserved0, sizeof(int64_t) * T * R);
    std::fill(stopped.begin(), stopped.end(), 0);
    std::fill(npacked.begin(), npacked.end(), 0);
    std::fill(k_all.begin(), k_all.end(), 0);

    // One pass largest→smallest shape; per type, pack as many as fit. A type
    // "stops" at its first failure once it is full-for-the-smallest-shape or
    // still empty — the early-exit upper bound of packer.go:167-198.
    for (int64_t s = 0; s < S; ++s) {
      if (counts[s] == 0) continue;
      for (int64_t t = 0; t < T; ++t) {
        if (stopped[t]) continue;
        int64_t k = kInf;
        for (int64_t r = 0; r < R; ++r) {
          const int64_t need = shapes[s * R + r];
          if (need > 0) {
            const int64_t avail = totals[t * R + r] - reserved[t * R + r];
            const int64_t kr = avail >= 0 ? avail / need : 0;
            if (kr < k) k = kr;
          }
        }
        if (k > counts[s]) k = counts[s];
        if (k < 0) k = 0;
        const bool failure = k < counts[s];
        for (int64_t r = 0; r < R; ++r) reserved[t * R + r] += k * shapes[s * R + r];
        bool full = false;
        for (int64_t r = 0; r < R; ++r) {
          if (totals[t * R + r] > 0 &&
              reserved[t * R + r] + smallest_fits[r] >= totals[t * R + r]) {
            full = true;
            break;
          }
        }
        npacked[t] += k;
        if (failure && (full || npacked[t] == 0)) stopped[t] = 1;
        k_all[s * T + t] = k;
      }
    }

    const int64_t max_pods = npacked[T - 1];
    if (max_pods == 0) {
      dropped[largest] += counts[largest];
      counts[largest] = 0;
      continue;
    }
    int64_t chosen = 0;
    while (npacked[chosen] != max_pods) ++chosen;
    if (cost_tiebreak && prices != nullptr) {
      for (int64_t t = chosen + 1; t < T; ++t) {
        if (npacked[t] == max_pods && prices[t] < prices[chosen]) chosen = t;
      }
    }

    // fast-forward: emit q identical nodes at once. Validity (ops/pack.py,
    // proof in docs/solver.md): every packed shape must stay STRICTLY
    // above maxfit through all repeated rounds — that keeps every type's
    // clip inactive (so all simulated fills and the tie-break repeat) and
    // every failure flag strict, which is what arms the is_full_for early
    // exit. The final round where equality would be reached runs live.
    int64_t min_terms = kInf;
    for (int64_t s = 0; s < S; ++s) {
      const int64_t kv = k_all[s * T + chosen];
      if (kv > 0) {
        const int64_t diff = counts[s] - maxfit[s] - 1;
        // floor division to match numpy
        int64_t q = diff / kv;
        if (diff % kv != 0 && ((diff < 0) != (kv < 0))) --q;
        if (q < min_terms) min_terms = q;
      }
    }
    int64_t q = 1 + min_terms;
    if (q < 1) q = 1;
    if (n_records >= max_records) return -1;
    out_chosen[n_records] = chosen;
    out_qty[n_records] = q;
    for (int64_t s = 0; s < S; ++s) {
      const int64_t kv = k_all[s * T + chosen];
      out_packed[n_records * S + s] = kv;
      counts[s] -= q * kv;
    }
    ++n_records;
  }

  std::memcpy(out_dropped, dropped.data(), sizeof(int64_t) * S);
  return n_records;
}

// Per-POD Go-semantics oracle: a direct transcription of the reference
// packer's loop (packer.go:109-141 pack, packer.go:167-198
// packWithLargestPod, packable.go:111-130 pack_one) — NOT the shape-level
// greedy above. It exists so benchmark parity at 50k pods is asserted
// against genuinely per-pod semantics (the Python per-pod oracle,
// solver/host_ffd.py, is too slow beyond ~5k pods).
//
// Pods are implicit: the descending per-pod sort order the Go packer uses
// (packer.go:100-108, extended to the full resource vector as in
// host_ffd.pack) equals the encoded shape order expanded by counts, since
// encode() sorts shapes by the same descending key and pods of equal shape
// are interchangeable. Within one pack_one pass, after a pod of shape s
// fails to reserve, every later pod of the same shape fails identically
// (reservations only grow and is_full_for reads unchanged state), so the
// skip-and-continue quirk (packable.go:111-130) collapses to skip-to-next-
// shape without changing semantics.
//
// Outputs one record PER NODE (qty is always 1), in SPARSE form: record i
// covers pairs [out_offsets[i], out_offsets[i+1]) of
// (out_pair_shape, out_pair_count). A dense (records × S) matrix would be
// O(pods × S) at high cardinality (50k nodes × 50k shapes ≈ 20 GB); the
// pair total is instead bounded by Σ pods-per-node ≤ pods, so callers
// allocate max_pairs = pods + S and never reallocate. Returns the record
// count, or -1 if either capacity was too small.
int64_t kt_ffd_pack_per_pod(
    const int64_t* shapes, const int64_t* counts_in,
    const int64_t* totals, const int64_t* reserved0,
    int64_t S, int64_t T, int64_t R, int64_t pods_unit, int64_t r_pods,
    int64_t* out_chosen, int64_t* out_offsets,
    int64_t* out_pair_shape, int64_t* out_pair_count,
    int64_t* out_dropped, int64_t max_records, int64_t max_pairs) {
  std::vector<int64_t> counts(counts_in, counts_in + S);
  std::vector<int64_t> dropped(S, 0);
  std::vector<int64_t> reserved(R);
  std::vector<int64_t> smallest_raw(R);
  // per-pack_one (shape, pods) pairs — only touched shapes, so commit cost
  // is O(pods-per-node), independent of S
  std::vector<std::pair<int64_t, int64_t>> pairs, chosen_pairs;

  // Active-shape skip list: next[s] = first shape index >= s with
  // counts > 0 (S terminates). Consumed shapes are unlinked lazily with
  // path compression during traversal, so pack_one visits only live
  // shapes — at high cardinality (tens of thousands of distinct shapes) a
  // plain counts[s]==0 skip scan would cost O(S) per type per node and
  // dominate everything.
  std::vector<int64_t> next(S + 1);
  for (int64_t s = 0; s <= S; ++s) next[s] = s;
  auto advance = [&](int64_t s) -> int64_t {
    int64_t cur = s;
    while (cur < S && counts[cur] == 0) {
      int64_t hop = next[cur];
      cur = (hop > cur) ? hop : cur + 1;
    }
    if (cur > s) next[s] = cur;  // compress for the next traversal
    return cur;
  };

  // pack_one (packable.go:111-130) of the remaining pod list onto type t.
  // Returns pods packed; fills `pairs` with (shape, packed>0) entries.
  // smallest_raw is the LAST pod's raw requests (no implicit pods:1) for
  // the is_full_for early exit (packable.go:145-155).
  //
  // Failure-run jump: shapes are sorted descending LEXICOGRAPHICALLY with
  // CPU as the primary dimension (encode() mirrors host_ffd.pack's sort),
  // so once a pod fails and the pack continues (skip-and-continue,
  // packable.go:128-130), every following shape with cpu > free_cpu must
  // also fail its fit test — and since `reserved` is unchanged across a
  // run of consecutive failures, is_full_for is CONSTANT over the run
  // (checked once, at the run's first failure). Binary-searching past the
  // cpu-infeasible prefix therefore preserves semantics exactly while
  // cutting the wandering tail at high shape cardinality from O(S) fit
  // tests to O(log S) per free-capacity level.
  auto cpu_jump = [&](int64_t s, int64_t free_cpu) -> int64_t {
    // smallest index > s with shapes[idx][0] <= free_cpu (cpu is dim 0,
    // non-increasing); returns S when none
    int64_t lo = s + 1, hi = S;
    while (lo < hi) {
      const int64_t mid = lo + (hi - lo) / 2;
      if (shapes[mid * R + 0] > free_cpu) lo = mid + 1; else hi = mid;
    }
    return lo;
  };

  auto pack_one = [&](int64_t t) -> int64_t {
    for (int64_t r = 0; r < R; ++r) reserved[r] = reserved0[t * R + r];
    pairs.clear();
    int64_t total_packed = 0;
    for (int64_t s = advance(0); s < S;) {
      int64_t got = 0;
      bool stop = false, give_up = false, failed = false;
      for (int64_t j = 0; j < counts[s]; ++j) {
        bool fits = true;
        for (int64_t r = 0; r < R; ++r) {
          if (reserved[r] + shapes[s * R + r] > totals[t * R + r]) {
            fits = false;
            break;
          }
        }
        if (fits) {
          for (int64_t r = 0; r < R; ++r) reserved[r] += shapes[s * R + r];
          ++got;
          ++total_packed;
          continue;
        }
        // is_full_for(smallest remaining pod): >= against any nonzero total
        for (int64_t r = 0; r < R; ++r) {
          if (totals[t * R + r] != 0 &&
              reserved[r] + smallest_raw[r] >= totals[t * R + r]) {
            stop = true;  // rest unpacked (early exit)
            break;
          }
        }
        if (!stop && total_packed == 0) give_up = true;  // empty pack
        failed = true;
        break;  // this pod unpacked; later same-shape pods fail identically
      }
      if (got > 0) pairs.emplace_back(s, got);
      if (give_up) return 0;
      if (stop) return total_packed;
      if (failed) {
        // skip the cpu-infeasible run in O(log S); memory-bound failures
        // inside the jump target region still step shape by shape
        const int64_t free_cpu = totals[t * R + 0] - reserved[0];
        const int64_t tgt = cpu_jump(s, free_cpu);
        s = advance(tgt > s + 1 ? tgt : s + 1);
      } else {
        s = advance(s + 1);
      }
    }
    return total_packed;
  };

  int64_t n_records = 0, n_pairs = 0;
  for (;;) {
    const int64_t largest = advance(0);
    if (largest >= S) break;
    int64_t smallest = largest;
    for (int64_t s = largest; s < S; s = advance(s + 1)) smallest = s;
    for (int64_t r = 0; r < R; ++r) {
      int64_t v = shapes[smallest * R + r];
      if (r == r_pods) v -= pods_unit;
      smallest_raw[r] = v;
    }

    // probe the LARGEST type for the max-pods upper bound (packer.go:170)
    const int64_t max_pods = pack_one(T - 1);
    if (max_pods == 0) {
      // drop the single largest pod (packer.go:124-128)
      dropped[largest] += 1;
      counts[largest] -= 1;
      continue;
    }
    // first (smallest) type achieving the bound wins (packer.go:174-183)
    int64_t chosen = -1;
    for (int64_t t = 0; t < T; ++t) {
      if (pack_one(t) == max_pods) {
        chosen = t;
        chosen_pairs = pairs;
        break;
      }
    }
    if (chosen < 0) {  // unreachable: T-1 achieved max_pods above
      chosen = T - 1;
      pack_one(T - 1);
      chosen_pairs = pairs;
    }

    if (n_records >= max_records) return -1;
    if (n_pairs + static_cast<int64_t>(chosen_pairs.size()) > max_pairs)
      return -1;
    out_chosen[n_records] = chosen;
    out_offsets[n_records] = n_pairs;
    for (const auto& [s, got] : chosen_pairs) {
      out_pair_shape[n_pairs] = s;
      out_pair_count[n_pairs] = got;
      ++n_pairs;
      counts[s] -= got;
    }
    ++n_records;
  }
  out_offsets[n_records] = n_pairs;

  std::memcpy(out_dropped, dropped.data(), sizeof(int64_t) * S);
  return n_records;
}

}  // extern "C"
