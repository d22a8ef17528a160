// K2 and K3: the window-start half of the keyed-candidate placement program.
//
// K2 replaces nomad_tpu/scheduler/kernels.py:415-428 (_keyed_program.local_fn:
// the masked BestFit-v3 score pass over [T, N] and lax.top_k per key).
//   k2_score    one thread per (key, row): fit & eligibility & distinct-hosts
//               mask, K1 score - counts * penalty + noise, -inf where masked.
//   launch_select  nf0 (feasible rows) and the K rows of each key with the
//               smallest (score desc, row asc) u64 keys, in that order, as
//               lax.top_k orders them, -inf entries included: a radix
//               select spread over the card (grid-wide 12-bit histogram
//               passes until the keys in play fit one block, a grid-wide
//               compaction, a one-block finish that sorts the K keys). Its
//               state is initialised by k2_score's first block per key.
//   (launch_select lives in select.cuh, shared with csrc/mesh.cu.)
// Bound on the card: the score pass reads capacity, usage, score_cap, noise,
// counts, bans and masks once (bytes); the select re-reads the [T, N] scores
// from L2 once per grid pass and once to compact. At the slice's N = 16384
// both are a few microseconds of launch and latency; at 1,048,576 rows the
// score pass's bytes dominate.
//
// K3 replaces nomad_tpu/scheduler/kernels.py:444-506 (candidate packets, sort
// by global row, first-occurrence dedup, the per-key trim to the global top-K
// only when T * K_trim < n_cand, the re-sort and the keep mask rebuilt from
// scratch). It sorts unique u64 keys (row << 32 | position): sorting unique
// keys is the stable sort by row the reference does. The candidate packets
// themselves are not built: the replay (K4a) gathers each candidate's row
// data from the node arrays by row, which holds the same values the packets
// would carry.
// Without the trim (every path of the port: score_topk makes kc = min(K, n),
// so T * kc == n_cand) the keys are cut into tiles of 1,024 (not per key:
// T = 1 on the served path would leave one segment), one block a tile:
//   sort          a bitonic network over four keys a thread: the stages
//                 within a thread in registers, within a warp by shuffles,
//                 across warps through shared memory (9 barriers a tile
//                 against the 78 of one block sorting the served window's
//                 4,096 keys);
//   place         each key's index in the merged order is its rank in its
//                 tile plus, per other tile, the count of keys below it (a
//                 binary search in shared memory); the largest of those
//                 keys is its predecessor, whose row decides keep
//                 (csrc/mesh.cu K9's scheme).
// Two launches through a global buffer of sorted tiles: k3_tile_sort,
// k3_place. (One launch of a thread block cluster, whose blocks read each
// other's sorted tiles from distributed shared memory, measured slower on
// the H100: 0.0147 against 0.0105 ms at the served window.)
// With the trim one block runs the whole merge (k3_merge), on no main path.
// Bound: bytes (the candidates once, rows and keep out: tens of KB), so
// latency: two launches of a few blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score.cuh"
#include "select.cuh"

namespace {

constexpr int kScoreThreads = 256;
constexpr int kMergeThreads = 1024;
constexpr int kSmemSortMax = 4096;  // u64 keys sorted in shared memory
constexpr int kTileKeys = 1024;     // K3: keys a tile block sorts
constexpr int kKeysPerThread = 4;   // K3: keys a sorting thread holds
constexpr int kSortThreads = kTileKeys / kKeysPerThread;
constexpr int kPlaceTiles = 4;      // K3: tiles staged in shared memory at once

__global__ void k2_score(const float* __restrict__ capacity,
                         const float* __restrict__ score_cap,
                         const float* __restrict__ usage,
                         const uint8_t* __restrict__ tg_masks,
                         const int32_t* __restrict__ counts,
                         const float* __restrict__ key_demands,
                         const float* __restrict__ noise,
                         const uint8_t* __restrict__ banned, float penalty,
                         int distinct, int n, int r_dims,
                         float* __restrict__ masked0,
                         SelectState* __restrict__ sel_states,
                         unsigned int* __restrict__ sel_hist, int kc) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (blockIdx.x == 0) select_init(sel_states, sel_hist, t, n, kc);
  if (row >= n) return;
  const float* cap = capacity + static_cast<int64_t>(row) * r_dims;
  const float* use = usage + static_cast<int64_t>(row) * r_dims;
  const float* d = key_demands + static_cast<int64_t>(t) * r_dims;
  bool ok = tg_masks[static_cast<int64_t>(t) * n + row] != 0 &&
            !(distinct && banned[row]);
  for (int k = 0; k < r_dims; ++k) ok = ok && (__fsub_rn(cap[k], use[k]) >= d[k]);
  float s = NOMAD_NEG_INF;
  if (ok) {
    const float base = bestfit_score(__fadd_rn(use[0], d[0]),
                                     __fadd_rn(use[1], d[1]),
                                     score_cap[2 * row], score_cap[2 * row + 1]);
    s = adjusted_score(base, counts[row], penalty, noise[row]);
  }
  masked0[static_cast<int64_t>(t) * n + row] = s;
}

// Compare-exchange of the keys at a lower and a higher position: ascending
// (up) keeps the smaller key at the lower position.
__device__ __forceinline__ void k3_cas(uint64_t& lo, uint64_t& hi, bool up) {
  if ((lo > hi) == up) {
    const uint64_t t = lo;
    lo = hi;
    hi = t;
  }
}

// One block per tile: keys (row << 32 | position) of candidates
// [blockIdx.x * kTileKeys, +kTileKeys), ~0 past n_cand, sorted ascending
// into skeys. Thread t holds the keys at positions 4t .. 4t + 3. Stage
// (k, j) of the network meets positions p and p ^ j, the lower keeping the
// smaller key when (p & k) == 0: j = 1, 2 inside a thread's registers,
// j = 4 .. 64 between lanes of a warp by shuffles, j >= 128 through shared
// memory (9 barriers a tile).
__global__ void __launch_bounds__(kSortThreads)
    k3_tile_sort(const int32_t* __restrict__ cand, int n_cand,
                 uint64_t* __restrict__ skeys) {
  __shared__ uint64_t s[kTileKeys];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileKeys;
  uint64_t key[kKeysPerThread];
#pragma unroll
  for (int e = 0; e < kKeysPerThread; ++e) {
    const int64_t gi = base + kKeysPerThread * t + e;
    key[e] = gi < n_cand
                 ? (static_cast<uint64_t>(static_cast<uint32_t>(cand[gi])) << 32) |
                       static_cast<uint32_t>(gi)
                 : ~0ull;
  }
  for (int k = 2; k <= kTileKeys; k <<= 1) {
    if (k >= 256) {
      // Partners 32 threads or more apart. A thread reads back and later
      // rewrites only its own slots, so the barrier before each stage
      // orders every other access.
#pragma unroll
      for (int e = 0; e < kKeysPerThread; ++e) s[kKeysPerThread * t + e] = key[e];
      __syncthreads();
      for (int j = k >> 1; j >= 128; j >>= 1) {
        for (int q = t; q < kTileKeys / 2; q += kSortThreads) {
          const int p = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          uint64_t a = s[p];
          uint64_t b = s[p + j];
          k3_cas(a, b, (p & k) == 0);
          s[p] = a;
          s[p + j] = b;
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < kKeysPerThread; ++e) key[e] = s[kKeysPerThread * t + e];
    }
    // For k >= 8 the direction bit lies above a thread's four positions.
    const bool up = ((kKeysPerThread * t) & k) == 0;
    for (int j = (k >> 1) < 64 ? (k >> 1) : 64; j >= 4; j >>= 1) {
      const int lanes = j / kKeysPerThread;
      const bool lower = (t & lanes) == 0;
#pragma unroll
      for (int e = 0; e < kKeysPerThread; ++e) {
        const uint64_t other = __shfl_xor_sync(0xffffffffu, key[e], lanes);
        key[e] = (lower == up) ? (other < key[e] ? other : key[e])
                               : (other > key[e] ? other : key[e]);
      }
    }
    if (k >= 4) {
      k3_cas(key[0], key[2], up);
      k3_cas(key[1], key[3], up);
      k3_cas(key[0], key[1], up);
      k3_cas(key[2], key[3], up);
    } else {
      k3_cas(key[0], key[1], true);
      k3_cas(key[2], key[3], false);
    }
  }
#pragma unroll
  for (int e = 0; e < kKeysPerThread; ++e)
    skeys[base + kKeysPerThread * t + e] = key[e];
}

// One block per sorted tile g, one thread per key: its index in the merged
// order and its keep bit (the predecessor's row differs), written to rows
// and keep. The tiles pass through shared memory kPlaceTiles at a time
// (all four of the served window's 4,096 keys at once).
__global__ void __launch_bounds__(kTileKeys)
    k3_place(const uint64_t* __restrict__ skeys, int n_cand, int n_tiles,
             int32_t* __restrict__ rows_out, uint8_t* __restrict__ keep_out) {
  __shared__ uint64_t s[kPlaceTiles * kTileKeys];
  const int g = blockIdx.x;
  const int j = threadIdx.x;
  const uint64_t* own = skeys + static_cast<int64_t>(g) * kTileKeys;
  const uint64_t key = own[j];
  int dst = j;
  bool has_pred = j > 0;
  uint64_t pred = has_pred ? own[j - 1] : 0;
  for (int h0 = 0; h0 < n_tiles; h0 += kPlaceTiles) {
    const int nh = n_tiles - h0 < kPlaceTiles ? n_tiles - h0 : kPlaceTiles;
    __syncthreads();
    for (int q = 0; q < nh; ++q)
      s[q * kTileKeys + j] = skeys[static_cast<int64_t>(h0 + q) * kTileKeys + j];
    __syncthreads();
    for (int q = 0; q < nh; ++q) {
      if (h0 + q == g) continue;
      const uint64_t* tile = s + q * kTileKeys;
      int lo = 0;
      for (int step = kTileKeys; step > 0; step >>= 1)
        if (lo + step <= kTileKeys && tile[lo + step - 1] < key) lo += step;
      if (lo > 0) {
        dst += lo;
        const uint64_t below = tile[lo - 1];
        if (!has_pred || below > pred) {
          pred = below;
          has_pred = true;
        }
      }
    }
  }
  // Padding keys (~0) sort last in the last tile and are never below a
  // real key, so the real keys' indices cover [0, n_cand).
  if (g * kTileKeys + j >= n_cand) return;
  rows_out[dst] = static_cast<int32_t>(key >> 32);
  keep_out[dst] = (!has_pred || (pred >> 32) != (key >> 32)) ? 1 : 0;
}

// The trim's one-block merge. rows_out/keep_out hold T * k_trim entries;
// rows_all/keep_all [n_cand] and sel [T * k_trim] are its scratch.
__global__ void k3_merge(const int32_t* __restrict__ cand,
                         const float* __restrict__ masked0, int n, int n_keys,
                         int n_cand, int k_trim,
                         uint64_t* __restrict__ gbuf,
                         int32_t* __restrict__ rows_all,
                         uint8_t* __restrict__ keep_all,
                         int32_t* __restrict__ sel,
                         int32_t* __restrict__ rows_out,
                         uint8_t* __restrict__ keep_out) {
  extern __shared__ uint64_t sbuf[];
  const int n_pow2 = next_pow2(n_cand);
  uint64_t* buf = n_pow2 <= kSmemSortMax ? sbuf : gbuf;

  // Stable sort of the T * K candidates by row (ties keep key-major order).
  for (int i = threadIdx.x; i < n_pow2; i += blockDim.x)
    buf[i] = i < n_cand ? (static_cast<uint64_t>(static_cast<uint32_t>(cand[i])) << 32) |
                              static_cast<uint32_t>(i)
                        : ~0ull;
  __syncthreads();
  block_bitonic_sort(buf, n_pow2);
  for (int i = threadIdx.x; i < n_cand; i += blockDim.x)
    rows_all[i] = static_cast<int32_t>(buf[i] >> 32);
  __syncthreads();
  for (int i = threadIdx.x; i < n_cand; i += blockDim.x)
    keep_all[i] = (i == 0 || rows_all[i] != rows_all[i - 1]) ? 1 : 0;
  __syncthreads();

  // Per-key trim: each key's top k_trim by (window-start score desc,
  // position asc), duplicates scoring -inf so one row fills one slot.
  for (int t = 0; t < n_keys; ++t) {
    const float* m = masked0 + static_cast<int64_t>(t) * n;
    for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) {
      if (i < n_cand) {
        const float s = keep_all[i] ? m[rows_all[i]] : NOMAD_NEG_INF;
        buf[i] = desc_score_key(s, static_cast<uint32_t>(i));
      } else {
        buf[i] = ~0ull;
      }
    }
    __syncthreads();
    block_bitonic_sort(buf, n_pow2);
    for (int j = threadIdx.x; j < k_trim; j += blockDim.x)
      sel[t * k_trim + j] = static_cast<int32_t>(buf[j] & 0xffffffffu);
    __syncthreads();
  }
  // Re-sort the kept set by row and rebuild keep from scratch: copies of a
  // row are identical, so first occurrence alone is the right mask.
  const int n_out = n_keys * k_trim;
  const int out_pow2 = next_pow2(n_out);
  for (int j = threadIdx.x; j < out_pow2; j += blockDim.x)
    buf[j] = j < n_out ? (static_cast<uint64_t>(static_cast<uint32_t>(rows_all[sel[j]])) << 32) |
                             static_cast<uint32_t>(j)
                       : ~0ull;
  __syncthreads();
  block_bitonic_sort(buf, out_pow2);
  for (int j = threadIdx.x; j < n_out; j += blockDim.x)
    rows_out[j] = static_cast<int32_t>(buf[j] >> 32);
  __syncthreads();
  for (int j = threadIdx.x; j < n_out; j += blockDim.x)
    keep_out[j] = (j == 0 || rows_out[j] != rows_out[j - 1]) ? 1 : 0;
}

}  // namespace

extern "C" {

// Bytes of the select's work buffer for n_keys keys (K2's and K8's).
int64_t nomad_select_work_bytes(int n_keys) { return select_work_bytes(n_keys); }

// K2. masked0 [T, N] f32, nf0 [T] i32, unordered [T, kc] i32 (scratch),
// cand [T, kc] i32, work nomad_select_work_bytes(T) bytes (scratch).
// Returns cudaGetLastError() after the launches.
int nomad_score_topk(const float* capacity, const float* score_cap,
                     const float* usage, const uint8_t* tg_masks,
                     const int32_t* counts, const float* key_demands,
                     const float* noise, const uint8_t* banned, float penalty,
                     int distinct, int n, int r_dims, int n_keys, int kc,
                     float* masked0, int32_t* nf0, int32_t* unordered,
                     int32_t* cand, void* work, cudaStream_t stream) {
  const SelectWork sw = select_work(work, n_keys);
  dim3 score_grid((n + kScoreThreads - 1) / kScoreThreads, n_keys);
  k2_score<<<score_grid, kScoreThreads, 0, stream>>>(
      capacity, score_cap, usage, tg_masks, counts, key_demands, noise, banned,
      penalty, distinct, n, r_dims, masked0, sw.states, sw.hist, kc);
  launch_select(masked0, n, n_keys, kc, work, nf0, unordered, cand, stream);
  return static_cast<int>(cudaGetLastError());
}

// K3. Without trim: gbuf holds n_cand rounded up to a multiple of 1,024
// u64 (the sorted tiles), rows_out/keep_out [n_cand]. With trim: gbuf holds
// next_pow2(n_cand) u64 when that exceeds the shared-memory sort,
// rows_all/keep_all [n_cand] and sel, rows_out, keep_out [T * k_trim].
int nomad_merge_candidates(const int32_t* cand, const float* masked0, int n,
                           int n_keys, int n_cand, int k_trim, int trim,
                           uint64_t* gbuf, int32_t* rows_all, uint8_t* keep_all,
                           int32_t* sel, int32_t* rows_out, uint8_t* keep_out,
                           cudaStream_t stream) {
  if (!trim) {
    const int n_tiles = (n_cand + kTileKeys - 1) / kTileKeys;
    if (n_tiles > 0) {
      k3_tile_sort<<<n_tiles, kSortThreads, 0, stream>>>(cand, n_cand, gbuf);
      k3_place<<<n_tiles, kTileKeys, 0, stream>>>(gbuf, n_cand, n_tiles,
                                                  rows_out, keep_out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int n_pow2 = 1;
  while (n_pow2 < n_cand) n_pow2 <<= 1;
  const size_t smem = n_pow2 <= kSmemSortMax ? n_pow2 * sizeof(uint64_t) : 0;
  k3_merge<<<1, kMergeThreads, smem, stream>>>(cand, masked0, n, n_keys, n_cand,
                                               k_trim, gbuf, rows_all,
                                               keep_all, sel, rows_out,
                                               keep_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
