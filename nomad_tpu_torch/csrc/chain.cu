// K4a: the sequential placement chain, rescoring only what a step changed.
//
// Replaces two reference programs that share one step body:
//   scan mode    nomad_tpu/scheduler/kernels.py:88-152 (_make_step + the
//                lax.scan of place_batch) and :155-189 (place_batch_multi,
//                whose per-step `reset` reloads counts and bans): the table
//                is every node row.
//   replay mode  nomad_tpu/scheduler/kernels.py:508-560 (the replay scan of
//                _keyed_program over the merged candidates, then the final
//                usage scatter-SET): the table is K3's candidate rows, and
//                n_feasible is nf0[t] + sum(ok now) - sum(ok at window start).
// Each step: fit & eligibility & not (distinct and banned) mask, K1 score -
// counts * penalty + noise, an argmax that breaks ties to the lowest table
// index (the lowest row: the table is row-sorted), then the winner's
// usage/count/ban update in placement order.
//
// Design. An entry's score and feasibility depend only on its own state
// (usage, count, ban) and on the step's key t and demand d, and a step
// changes the state of one entry at most: its winner. So the whole table is
// rescored only on a trigger step: the first, a `reset` (counts and bans
// reload), a change of t, or a change of d (replay: of validity, which
// zeroes d; scan: of any demand bit). A trigger is a full pass of the block:
// each warp scores 128-entry segments, keeps each segment's best (score
// desc, index asc) and counts the feasible entries; warp 0 then holds in
// each lane the best of a contiguous group of segments. Every other step is
// warp 0 alone, with no block barrier: it applies the winner's update and
// rescores that one entry (the winner was feasible, so it stays so unless
// distinct hosts bans it or it no longer fits). A winner whose score did
// not fall is still the best; otherwise warp 0 re-reduces its segment and
// then the group bests. A warp's argmax is two redux instructions: the max
// of an order-preserving u32 of the score, then the min index among the
// lanes holding it. n_ok moves by the winner's change of feasibility.
// Each entry keeps its fit slack, cap - use per dimension (the fit test's
// own rounded subtraction), and its first two usage dimensions (the score's
// inputs) beside the full usage rows, so a full pass reads neither capacity
// nor the full usage. Replay gathers each candidate's capacity, eligibility
// bits, count and ban once at the start, contiguous by table index. The
// state a full pass reads lives in shared memory as far as it fits (a
// 4,096-entry replay table with R = 5 takes about 214 KB of the 220 KB
// budget), the rest in global memory, one generic pointer per array, so one
// code path serves both; a variant compiled with every such array in shared
// memory addresses them as shared. On an incremental step the winner's
// capacity and upper usage dimensions come from global memory: they are
// issued first and used last, and the score and the reductions run
// meanwhile as if the winner still fits; the rare step where it does not
// reduces again. Results go out 32 steps at a time, and a run of padding
// steps, which changes nothing, is emitted at once.
//
// Bound on the card: latency. An incremental step is one warp's chain of
// dependent operations: shared-memory reads, the score (two divisions, two
// exp2f), two redux pairs. A full pass is one block's pass over the table.
// The bytes the chain must move (inputs once, outputs once) are a few
// hundred KB, microseconds at 3.35 TB/s.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "score.cuh"

namespace {

constexpr int kChainThreads = 1024;
constexpr int kWarps = kChainThreads / 32;
constexpr int kMaxDims = 16;
constexpr int kNodeDims = 5;              // the node table's resource dims
constexpr int kMaxBitKeys = 32;           // keys whose eligibility is a bit
constexpr int kSeg = 128;                 // table entries per segment
constexpr int kPerLane = kSeg / 32;       // a lane's entries in a segment
constexpr int kSmemBudget = 220 * 1024;   // dynamic shared memory for state
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kOk = 1;     // flags: feasible at the current (t, d)
constexpr uint8_t kBan = 2;    // flags: banned (distinct hosts)
constexpr uint8_t kBan0 = 4;   // flags: banned at window start

// The chain's arrays. Those up to kElig claim shared memory in this order
// as far as the budget allows; the others, and those that do not fit, live
// in global memory: flags and counts in c_ban and c_cnt, stat read from the
// inputs by row, the rest in the caller's work buffer (scan mode reads cap
// and cnt0 in place). The full usage rows are always in global memory (the
// usage state: c_use in replay, usage_out in scan).
enum ChainArray {
  kTrig, kValid, kReset, kSegKey, kSegIdx, kScore, kFlags, kCount, kUse01,
  kStat, kSlack, kElig, kCap, kCnt0, kNumArrays
};
constexpr int kLastShared = kElig;

struct ChainArgs {
  const float* capacity;
  const float* score_cap;
  const float* usage;
  const uint8_t* tg_masks;
  const int32_t* counts0;
  const uint8_t* banned0;
  const float* noise;
  const float* demands;
  const int32_t* tg_ids;
  const uint8_t* valid;
  const uint8_t* reset;
  float penalty;
  int distinct;
  int n;
  int r_dims;
  int n_keys;
  int n_steps;
  int n_table;
  const int32_t* rows;
  const uint8_t* keep;
  const float* masked0;
  const int32_t* nf0;
  int32_t* ok0_sum;
  float* packed;
  float* usage_out;
  int32_t* win;
  float* table_use;            // [n_table, R] the usage state
  void* home[kNumArrays];      // each array in global memory
  int soff[kNumArrays];        // its offset in dynamic shared memory, or -1
};

// The arrays as the kernel addresses them.
struct Tables {
  uint32_t* trig;   // [ceil(P/32)] bit j%32 of word j/32: step j rescores all
  uint32_t* vbits;  // [ceil(P/32)] step j is valid
  uint32_t* rbits;  // [ceil(P/32)] step j resets counts and bans
  uint32_t* segk;   // [n_seg] each segment's best score key
  int32_t* segi;    // [n_seg] and its table index
  float* score;     // [n_table] masked score at the current (t, d)
  uint8_t* flags;   // [n_table] kOk | kBan | kBan0
  int32_t* cnt;     // [n_table] job count
  float* use01;     // [n_table, 2] usage dimensions 0 and 1
  float* stat;      // [n_table, 3] score_cap and noise, or null: by row
  float* slack;     // [n_table, R] cap - use, rounded as the fit test rounds
  uint32_t* elig;   // [n_table] bit t: eligible for key t and kept, or null
  float* cap;       // [n_table, R] capacity by entry
  int32_t* cnt0;    // [n_table] window-start job count by entry
  float* use;       // [n_table, R] usage (global)
};

__global__ void copy_f32(const float* __restrict__ src, float* __restrict__ dst,
                         int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

__device__ __forceinline__ int clamp_key(int t, int n_keys) {
  return min(max(t, 0), n_keys - 1);
}

// Order-preserving u32 of a score: a larger score maps higher, and -0.0 and
// +0.0 map alike, as they compare equal.
__device__ __forceinline__ uint32_t score_key(float s) {
  if (s == 0.0f) s = 0.0f;
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Fold (k, i) into the running best (bk, bi) by (key desc, index asc).
__device__ __forceinline__ void take(uint32_t k, int i, uint32_t& bk, int& bi) {
  if (k > bk || (k == bk && i < bi)) {
    bk = k;
    bi = i;
  }
}

// The warp's best (key desc, index asc), in every lane: the max key, then
// the min index among the lanes holding it.
__device__ __forceinline__ void warp_best(uint32_t& bk, int& bi) {
  const uint32_t wk = __reduce_max_sync(kFull, bk);
  bi = __reduce_min_sync(kFull, bk == wk ? bi : INT_MAX);
  bk = wk;
}

__device__ __forceinline__ bool eligible(const ChainArgs& a, const Tables& tb,
                                         int c, int t, bool replay) {
  if (tb.elig != nullptr) return (tb.elig[c] >> t) & 1u;
  const int r = replay ? a.rows[c] : c;
  return a.tg_masks[static_cast<int64_t>(t) * a.n + r] != 0 &&
         (!replay || a.keep[c] != 0);
}

// score_cap and noise of table entry c.
__device__ __forceinline__ void statics(const ChainArgs& a, const Tables& tb,
                                        int c, bool replay, float& s0,
                                        float& s1, float& nz) {
  if (tb.stat != nullptr) {
    s0 = tb.stat[3 * c];
    s1 = tb.stat[3 * c + 1];
    nz = tb.stat[3 * c + 2];
  } else {
    const int64_t r = replay ? a.rows[c] : c;
    s0 = a.score_cap[2 * r];
    s1 = a.score_cap[2 * r + 1];
    nz = a.noise[r];
  }
}

// The whole block rescores every entry at the published (t, d), reloading
// counts and bans on a reset; each segment's best goes to segk/segi and each
// warp's feasible count to warp_ok. Lane l takes entries l, l + 32, ... of a
// segment.
template <int kR>
__device__ __forceinline__ void full_pass(const ChainArgs& a, const Tables& tb,
                                          int n_seg, bool replay, int lane,
                                          int warp, const float* cur_d, int t,
                                          bool rs, int* warp_ok) {
  const int R = kR > 0 ? kR : a.r_dims;
  int ok_n = 0;
  for (int s = warp; s < n_seg; s += kWarps) {
    uint32_t bk = 0;
    int bi = INT_MAX;
#pragma unroll 1
    for (int e = 0; e < kPerLane; ++e) {
      const int c = s * kSeg + 32 * e + lane;
      if (c >= a.n_table) break;
      const uint8_t f = tb.flags[c];
      const bool ban = (f & (rs ? kBan0 : kBan)) != 0;
      const int cn = rs ? tb.cnt0[c] : tb.cnt[c];
      const float* sl = tb.slack + static_cast<int64_t>(c) * R;
      int fit = 1;
      for (int k = 0; k < R; ++k) fit &= sl[k] >= cur_d[k];
      const bool ok = fit && eligible(a, tb, c, t, replay) &&
                      !(a.distinct && ban);
      float sc = NOMAD_NEG_INF;
      if (ok) {
        float s0, s1, nz;
        statics(a, tb, c, replay, s0, s1, nz);
        const float base = bestfit_score(__fadd_rn(tb.use01[2 * c], cur_d[0]),
                                         __fadd_rn(tb.use01[2 * c + 1], cur_d[1]),
                                         s0, s1);
        sc = adjusted_score(base, cn, a.penalty, nz);
      }
      tb.score[c] = sc;
      tb.flags[c] = (f & kBan0) | (ban ? kBan : 0) | (ok ? kOk : 0);
      if (rs) tb.cnt[c] = cn;
      ok_n += ok;
      take(score_key(sc), c, bk, bi);
    }
    warp_best(bk, bi);
    if (lane == 0) {
      tb.segk[s] = bk;
      tb.segi[s] = bi;
    }
  }
  ok_n = __reduce_add_sync(kFull, ok_n);
  if (lane == 0) warp_ok[warp] = ok_n;
}

// replay: rows/keep/masked0/nf0 are set and the table is n_table candidates.
// scan: rows == nullptr and the table is the n node rows. kShared: every
// array up to kElig that the mode uses is in shared memory, so the compiler
// addresses those before kElig as shared (the served window's shape);
// otherwise each pointer is generic. kR: the resource dimensions when known
// at compile time (the node table's 5), so that every per-dimension loop
// unrolls exactly; 0 reads them from r_dims.
template <bool kShared, int kR>
__global__ void __launch_bounds__(kChainThreads, 1)
    k4a_chain(const ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cur_d[kMaxDims];
  __shared__ int cur_t;
  __shared__ int cur_rs;
  __shared__ int warp_ok[kWarps];

  // The eligibility bits may be absent (scan mode, or over kMaxBitKeys
  // keys): their pointer stays generic so that it can be null.
  void* p[kNumArrays];
#pragma unroll
  for (int k = 0; k < kNumArrays; ++k)
    p[k] = (kShared && k < kElig) || a.soff[k] >= 0
               ? static_cast<void*>(smem + a.soff[k])
               : a.home[k];
  const Tables tb{static_cast<uint32_t*>(p[kTrig]),
                  static_cast<uint32_t*>(p[kValid]),
                  static_cast<uint32_t*>(p[kReset]),
                  static_cast<uint32_t*>(p[kSegKey]),
                  static_cast<int32_t*>(p[kSegIdx]),
                  static_cast<float*>(p[kScore]),
                  static_cast<uint8_t*>(p[kFlags]),
                  static_cast<int32_t*>(p[kCount]),
                  static_cast<float*>(p[kUse01]),
                  static_cast<float*>(p[kStat]),
                  static_cast<float*>(p[kSlack]),
                  static_cast<uint32_t*>(p[kElig]),
                  static_cast<float*>(p[kCap]),
                  static_cast<int32_t*>(p[kCnt0]),
                  a.table_use};
  const bool replay = a.rows != nullptr;
  const int R = kR > 0 ? kR : a.r_dims;
  const int n_table = a.n_table;
  const int n_steps = a.n_steps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_seg = (n_table + kSeg - 1) / kSeg;
  const int group = (n_seg + 31) / 32;   // segments per lane of warp 0
  const int n_words = (n_steps + 31) / 32;

  // Window-start state of every table entry; replay also gathers each
  // candidate's static row data and its usage (scan mode chains in
  // usage_out, already a copy of usage).
  for (int c = threadIdx.x; c < n_table; c += kChainThreads) {
    const int r = replay ? a.rows[c] : c;
    tb.flags[c] = a.banned0[r] ? (kBan | kBan0) : 0;
    tb.cnt[c] = a.counts0[r];
    if (replay) tb.cnt0[c] = a.counts0[r];
    if (tb.elig != nullptr) {
      uint32_t bits = 0;
      if (a.keep[c])
        for (int t = 0; t < a.n_keys; ++t)
          bits |= static_cast<uint32_t>(
                      a.tg_masks[static_cast<int64_t>(t) * a.n + r] != 0)
                  << t;
      tb.elig[c] = bits;
    }
    if (tb.stat != nullptr) {
      tb.stat[3 * c] = a.score_cap[2 * static_cast<int64_t>(r)];
      tb.stat[3 * c + 1] = a.score_cap[2 * static_cast<int64_t>(r) + 1];
      tb.stat[3 * c + 2] = a.noise[r];
    }
    for (int k = 0; k < R; ++k) {
      const float cap = a.capacity[static_cast<int64_t>(r) * R + k];
      const float u = a.usage[static_cast<int64_t>(r) * R + k];
      if (replay) {
        tb.cap[static_cast<int64_t>(c) * R + k] = cap;
        tb.use[static_cast<int64_t>(c) * R + k] = u;
      }
      if (k < 2) tb.use01[2 * c + k] = u;
      tb.slack[static_cast<int64_t>(c) * R + k] = __fsub_rn(cap, u);
    }
  }
  // Trigger, validity and reset bits, one warp per 32 steps. Out-of-range
  // keys clamp, as the reference's gathers do; nothing reads outside the
  // tables.
  for (int q = warp; q < n_words; q += kWarps) {
    const int j = q * 32 + lane;
    bool tr = false;
    bool v = false;
    bool rs = false;
    if (j < n_steps) {
      v = a.valid[j] != 0;
      rs = a.reset != nullptr && a.reset[j] != 0;
      tr = j == 0 || rs ||
           clamp_key(a.tg_ids[j], a.n_keys) !=
               clamp_key(a.tg_ids[j - 1], a.n_keys);
      if (!tr && replay) {
        tr = v != (a.valid[j - 1] != 0);  // padding steps zero the demand
      } else if (!tr) {
        const float* dj = a.demands + static_cast<int64_t>(j) * R;
        for (int k = 0; k < R; ++k)
          tr = tr || __float_as_uint(dj[k]) != __float_as_uint(dj[k - R]);
      }
    }
    const uint32_t tw = __ballot_sync(kFull, tr);
    const uint32_t vw = __ballot_sync(kFull, v);
    const uint32_t rw = __ballot_sync(kFull, rs);
    if (lane == 0) {
      tb.trig[q] = tw;
      tb.vbits[q] = vw;
      tb.rbits[q] = rw;
    }
  }
  if (replay) {
    // sum over kept candidates of the window-start feasibility, per key
    // (ok at window start <=> a finite window-start score).
    for (int t = 0; t < a.n_keys; ++t) {
      int cnt = 0;
      for (int c = threadIdx.x; c < n_table; c += kChainThreads)
        cnt += a.keep[c] &&
               a.masked0[static_cast<int64_t>(t) * a.n + a.rows[c]] !=
                   NOMAD_NEG_INF;
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) warp_ok[warp] = cnt;
      __syncthreads();
      if (warp == 0) {
        const int total =
            __reduce_add_sync(kFull, lane < kWarps ? warp_ok[lane] : 0);
        if (lane == 0) a.ok0_sum[t] = total;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // Warp 0's registers: the current best, lane l's group of segments
  // [l * group, (l + 1) * group) and its best, the feasible count, the run's
  // key and nf base (replay), its demand (lane k holds d[k]), the next
  // chunk's keys (lane l: step 32 (q + 1) + l), and this chunk's results
  // (lane l: step 32 q + l; bit l of `found_bits` set where it placed).
  uint32_t top_k = 0;
  int top_i = 0;
  uint32_t gk = 0;
  int gi = INT_MAX;
  const int g_lo = lane * group;
  const int g_hi = min(g_lo + group, n_seg);
  int n_ok = 0;
  int t = 0;
  int nf_base = 0;
  float d_lane = 0.0f;
  float d0 = 0.0f;
  float d1 = 0.0f;
  int t_next = lane < n_steps ? clamp_key(a.tg_ids[lane], a.n_keys) : 0;
  float o_sc = NOMAD_NEG_INF;
  int o_nf = 0;
  int o_win = 0;
  uint32_t found_bits = 0;

  // Entry bi's score became sc, below the old best: its segment's best,
  // lane l's group best, then the best of all.
  auto reduce_entry = [&](int bi, float sc) {
    const int seg = bi / kSeg;
    const uint32_t key_new = score_key(sc);
    uint32_t sk = 0;
    int si = INT_MAX;
    // Branch-free: a lane's entries ascend, so a strictly greater key is
    // the only one that displaces its best; entries past the table key 0.
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = seg * kSeg + 32 * e + lane;
      const uint32_t k0 = score_key(tb.score[min(c, n_table - 1)]);
      const uint32_t k = c == bi ? key_new : (c < n_table ? k0 : 0u);
      si = k > sk ? c : si;
      sk = k > sk ? k : sk;
    }
    warp_best(sk, si);
    if (lane == 0) {
      tb.segk[seg] = sk;
      tb.segi[seg] = si;
    }
    if (group == 1) {
      gk = lane == seg ? sk : gk;
      gi = lane == seg ? si : gi;
    } else if (seg >= g_lo && seg < g_hi) {
      gk = 0;
      gi = INT_MAX;
      for (int s = g_lo; s < g_hi; ++s) {
        if (s == seg)
          take(sk, si, gk, gi);
        else
          take(tb.segk[s], tb.segi[s], gk, gi);
      }
    }
    uint32_t k = gk;
    int i = gi;
    warp_best(k, i);
    top_k = k;
    top_i = i;
  };

  // One valid step by warp 0 alone (a trigger's full pass is done).
  auto step = [&](int j, uint32_t tw, int b, int q) {
    const int bi = top_i;
    // Everything the step may read about the best entry, issued at once:
    // shared memory for the score, global memory for the rest.
    const uint8_t fb = tb.flags[bi];
    const float bv = tb.score[bi];
    const int cn = tb.cnt[bi] + 1;
    const float u0 = tb.use01[2 * bi];
    const float u1 = tb.use01[2 * bi + 1];
    float s0, s1, nz;
    statics(a, tb, bi, replay, s0, s1, nz);
    const float u_old =
        lane < R ? tb.use[static_cast<int64_t>(bi) * R + lane] : 0.0f;
    const float cap =
        lane < R ? tb.cap[static_cast<int64_t>(bi) * R + lane] : 0.0f;
    const bool found = (fb & kOk) != 0;
    if (lane == b) {
      o_sc = bv;
      o_nf = replay ? nf_base + n_ok : n_ok;
      o_win = bi;
    }
    if (!found) return;
    found_bits |= 1u << b;
    // The next step rescores everything anyway: skip the incremental one.
    const bool next_full =
        j + 1 >= n_steps ||
        (b < 31 ? ((tw >> (b + 1)) & 1u) : (tb.trig[q + 1] & 1u));
    // Every lane computes the winner's next score (no shuffles).
    const float u0_new = __fadd_rn(u0, d0);
    const float u1_new = __fadd_rn(u1, d1);
    float sc = NOMAD_NEG_INF;
    if (!next_full && !a.distinct) {
      // Feasible before at this (t, d): eligible and kept, so only the ban
      // and the fit can change. Score and reduce as if it still fits.
      const float base = bestfit_score(__fadd_rn(u0_new, d0),
                                       __fadd_rn(u1_new, d1), s0, s1);
      sc = adjusted_score(base, cn, a.penalty, nz);
    }
    if (!next_full) {
      const uint32_t key_new = score_key(sc);
      if (key_new >= top_k) {
        // The best only rose: it stays the best of its segment, its group
        // and the table.
        if (lane == 0) tb.segk[bi / kSeg] = key_new;
        if (bi / kSeg >= g_lo && bi / kSeg < g_hi) gk = key_new;
        top_k = key_new;
      } else {
        reduce_entry(bi, sc);
      }
    }
    // The winner's new usage and slack, from its global row.
    const float u_new =
        lane == 0 ? u0_new : (lane == 1 ? u1_new : __fadd_rn(u_old, d_lane));
    const float sl = __fsub_rn(cap, u_new);
    const bool fit = __ballot_sync(kFull, lane < R && !(sl >= d_lane)) == 0;
    bool ok_new = false;
    if (!next_full) {
      ok_new = !a.distinct && fit;
      if (!a.distinct && !fit) {
        sc = NOMAD_NEG_INF;   // it no longer fits: reduce again
        reduce_entry(bi, sc);
      }
      n_ok += ok_new ? 0 : -1;
    }
    __syncwarp();
    if (lane < R) {
      tb.use[static_cast<int64_t>(bi) * R + lane] = u_new;
      tb.slack[static_cast<int64_t>(bi) * R + lane] = sl;
    }
    if (lane < 2) tb.use01[2 * bi + lane] = u_new;
    if (lane == 0) {
      tb.cnt[bi] = cn;
      tb.flags[bi] = (fb & kBan0) | kBan | (ok_new ? kOk : 0);
      tb.score[bi] = sc;
    }
    __syncwarp();
  };

  for (int q = 0; q < n_words; ++q) {
    const uint32_t tw = tb.trig[q];
    const uint32_t vw = tb.vbits[q];
    const uint32_t rw = tb.rbits[q];
    const int steps = min(32, n_steps - q * 32);
    // This chunk's keys, and the next chunk's in flight.
    const int t_chunk = t_next;
    if (warp == 0 && (q + 1) * 32 + lane < n_steps)
      t_next = clamp_key(a.tg_ids[(q + 1) * 32 + lane], a.n_keys);
    // Warp 0 runs every step; a trigger's full pass (the whole block) comes
    // first, and its step then opens the next run of steps.
    int b = 0;
    for (uint32_t rem = tw;; rem &= rem - 1) {
      const int nb = rem != 0 ? __ffs(rem) - 1 : steps;
      if (warp == 0) {
        while (b < nb) {
          if ((vw >> b) & 1u) {
            step(q * 32 + b, tw, b, q);
            ++b;
            continue;
          }
          // A run of padding steps changes nothing: each of them up to the
          // next valid step or trigger emits the same result.
          const uint32_t later = vw & ~((2u << b) - 1u);
          const int e = min(nb, later != 0 ? __ffs(later) - 1 : 32);
          if (lane >= b && lane < e) {
            o_sc = NOMAD_NEG_INF;
            o_nf = replay ? nf_base + n_ok : n_ok;
            o_win = top_i;
          }
          b = e;
        }
      }
      if (rem == 0) break;
      const int j = q * 32 + nb;
      if (warp == 0) {
        // Publish the run's key, demand and reset for the full pass.
        t = __shfl_sync(kFull, t_chunk, nb);
        const bool v = (vw >> nb) & 1u;
        if (lane < R)
          d_lane = replay ? (v ? a.demands[t * R + lane] : 0.0f)
                          : a.demands[static_cast<int64_t>(j) * R + lane];
        if (replay) nf_base = a.nf0[t] - a.ok0_sum[t];
        d0 = __shfl_sync(kFull, d_lane, 0);
        d1 = __shfl_sync(kFull, d_lane, 1);
        if (lane < R) cur_d[lane] = d_lane;
        if (lane == 0) {
          cur_t = t;
          cur_rs = (rw >> nb) & 1u;
        }
      }
      __syncthreads();
      full_pass<kR>(a, tb, n_seg, replay, lane, warp, cur_d, cur_t,
                    cur_rs != 0, warp_ok);
      __syncthreads();
      if (warp == 0) {
        n_ok = __reduce_add_sync(kFull, lane < kWarps ? warp_ok[lane] : 0);
        gk = 0;
        gi = INT_MAX;
        for (int s = g_lo; s < g_hi; ++s) take(tb.segk[s], tb.segi[s], gk, gi);
        uint32_t k = gk;
        int i = gi;
        warp_best(k, i);
        top_k = k;
        top_i = i;
      }
      b = nb;   // the next turn's run of steps opens with step nb
    }
    if (warp == 0 && lane < steps) {
      // The chunk's results, one coalesced store per field. The argmax's
      // table index goes out on every step, found or not (the mesh's warm
      // step reads the winner's chained usage from c_use with it).
      const int j = q * 32 + lane;
      const bool f = (found_bits >> lane) & 1u;
      float* out = a.packed + 3 * static_cast<int64_t>(j);
      out[0] = f ? static_cast<float>(replay ? a.rows[o_win] : o_win) : -1.0f;
      out[1] = f ? o_sc : NOMAD_NEG_INF;
      out[2] = static_cast<float>(o_nf);
      if (a.win != nullptr) a.win[j] = o_win;
    }
    found_bits = 0;
  }
  __syncthreads();

  if (replay) {
    // Scatter-SET of the final candidate usage; kept rows are unique and
    // duplicates drop, so the write order is immaterial.
    for (int c = threadIdx.x; c < n_table; c += kChainThreads) {
      if (!a.keep[c]) continue;
      const int r = a.rows[c];
      for (int k = 0; k < R; ++k)
        a.usage_out[static_cast<int64_t>(r) * R + k] =
            tb.use[static_cast<int64_t>(c) * R + k];
    }
  }
}

inline int64_t align16(int64_t x) { return (x + 15) & ~static_cast<int64_t>(15); }

// Bytes of each array; zero for one that a mode reads in place or not at all.
void chain_bytes(int n_table, int n_steps, int r_dims, int n_keys, bool replay,
                 int64_t* bytes) {
  const int64_t words = (static_cast<int64_t>(n_steps) + 31) / 32;
  const int64_t segs = (static_cast<int64_t>(n_table) + kSeg - 1) / kSeg;
  const int64_t nt = n_table;
  bytes[kTrig] = bytes[kValid] = bytes[kReset] = align16(4 * words);
  bytes[kSegKey] = bytes[kSegIdx] = align16(4 * segs);
  bytes[kScore] = align16(4 * nt);
  bytes[kFlags] = align16(nt);
  bytes[kCount] = align16(4 * nt);
  bytes[kUse01] = align16(8 * nt);
  bytes[kStat] = align16(12 * nt);
  bytes[kSlack] = align16(4 * nt * r_dims);
  bytes[kElig] = replay && n_keys <= kMaxBitKeys ? align16(4 * nt) : 0;
  bytes[kCap] = replay ? align16(4 * nt * r_dims) : 0;
  bytes[kCnt0] = replay ? align16(4 * nt) : 0;
}

// The arrays whose global home is the work buffer.
bool in_work(int k) { return k != kFlags && k != kCount && k != kStat; }

}  // namespace

extern "C" {

// Bytes of the work buffer nomad_placement_chain takes (the most any mode
// needs at this shape).
int64_t nomad_placement_chain_work_bytes(int n_table, int n_steps, int r_dims) {
  int64_t bytes[kNumArrays];
  chain_bytes(n_table, n_steps, r_dims, 1, true, bytes);
  int64_t total = 0;
  for (int k = 0; k < kNumArrays; ++k)
    if (in_work(k)) total += bytes[k];
  return total;
}

// usage_out starts as a copy of usage (a grid-wide copy launched first); the
// chain then runs in one block. In scan mode pass c_use = usage_out and rows
// = keep = masked0 = nf0 = ok0_sum = nullptr. c_cnt [n_table] and c_ban
// [n_table] are scratch; work holds work_bytes (at least
// nomad_placement_chain_work_bytes). win [n_steps] (nullable) receives each
// step's argmax table index. Returns cudaGetLastError().
int nomad_placement_chain(
    const float* capacity, const float* score_cap, const float* usage,
    const uint8_t* tg_masks, const int32_t* counts0, const uint8_t* banned0,
    const float* noise, const float* demands, const int32_t* tg_ids,
    const uint8_t* valid, const uint8_t* reset, float penalty, int distinct,
    int n, int r_dims, int n_keys, int n_steps, int n_table,
    const int32_t* rows, const uint8_t* keep, const float* masked0,
    const int32_t* nf0, float* c_use, int32_t* c_cnt, uint8_t* c_ban,
    int32_t* ok0_sum, float* packed, float* usage_out, int32_t* win,
    void* work, int64_t work_bytes, cudaStream_t stream) {
  if (r_dims > kMaxDims || r_dims < 2 || n_table < 1 || n_steps < 0 ||
      n_keys < 1 ||
      work_bytes < nomad_placement_chain_work_bytes(n_table, n_steps, r_dims))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool replay = rows != nullptr;
  ChainArgs a{capacity, score_cap, usage, tg_masks, counts0, banned0, noise,
              demands, tg_ids, valid, reset, penalty, distinct, n, r_dims,
              n_keys, n_steps, n_table, rows, keep, masked0, nf0, ok0_sum,
              packed, usage_out, win, replay ? c_use : usage_out, {}, {}};
  int64_t bytes[kNumArrays];
  chain_bytes(n_table, n_steps, r_dims, n_keys, replay, bytes);
  char* w = static_cast<char*>(work);
  for (int k = 0; k < kNumArrays; ++k) {
    if (!in_work(k)) continue;
    a.home[k] = bytes[k] > 0 ? w : nullptr;
    w += bytes[k];
  }
  a.home[kFlags] = c_ban;
  a.home[kCount] = c_cnt;
  a.home[kStat] = nullptr;   // read from score_cap and noise by row
  if (!replay) {
    a.home[kCap] = const_cast<float*>(capacity);
    a.home[kCnt0] = const_cast<int32_t*>(counts0);
  }
  int64_t used = 0;
  bool shared = true;
  for (int k = 0; k < kNumArrays; ++k) {
    if (k <= kLastShared && bytes[k] > 0 && used + bytes[k] <= kSmemBudget) {
      a.soff[k] = static_cast<int>(used);
      used += bytes[k];
    } else {
      a.soff[k] = -1;
      shared = shared && (k > kLastShared || bytes[k] == 0);
    }
  }
  const auto kernel =
      r_dims == kNodeDims ? (shared ? k4a_chain<true, kNodeDims>
                                    : k4a_chain<false, kNodeDims>)
                          : (shared ? k4a_chain<true, 0> : k4a_chain<false, 0>);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t total = static_cast<int64_t>(n) * r_dims;
  if (total > 0)
    copy_f32<<<static_cast<unsigned int>((total + 255) / 256), 256, 0,
               stream>>>(usage, usage_out, total);
  kernel<<<1, kChainThreads, static_cast<size_t>(used), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
