// K6-K10: the shard-local keyed mesh pipeline (the reference's
// _MeshKeyedProgram, nomad_tpu/scheduler/kernels.py:712-977).
//
// The mesh's S shards are logical shards: row slices of the node tables, each
// on its shard's device. A cold window runs K7 once over every shard's rows
// and K8 once over every shard, each shard's packet from its own rows only,
// the packets meet on the lead device, and K9 merges them into the resident
// candidate pool; every window (cold or warm) then runs K2, K3 and K4a over
// the pool taken as a table and K10 for the rest of the reference's warm
// step.
//
//   K6 nomad_mesh_pack     replaces pack_fn (:745-756): capacity [N,R],
//                          score_cap [N,2], counts i32, noise, banned bool ->
//                          the packed node-static table f32 [N, R+5]. A
//                          coalesced tile copy: one block stages a tile of
//                          256 rows in shared memory (capacity read as the
//                          tile's contiguous rows * R floats, score_cap as
//                          float2, counts, noise and banned one per thread)
//                          and writes the tile's contiguous rows * (R+5)
//                          floats as 16-byte vectors, scalars only past the
//                          last whole vector. Bound: bytes (37 in, 40 out
//                          per row at R = 5).
//   K7 nomad_apply_ring    replaces _apply_ring / apply_ring_full (:758-775,
//                          :964-967): last-write-wins scatter of the pending
//                          winner ring [cap, 1+R] into usage [n, R] rows
//                          [row_base, row_base + n), written to a new
//                          tensor. On logical shards one call covers every
//                          shard (row_base 0): a ring entry's row belongs to
//                          one shard, so that is the per-shard applications
//                          laid end to end. Two launches: a mark pass (one
//                          thread per ring entry) atomicMaxes ring positions
//                          into an int scratch [n] that holds -1 between
//                          calls (the reference's scatter-max), and a write
//                          pass (a 256-row tile per block, staged through
//                          shared memory so reads and writes coalesce)
//                          copies each row from its last ring entry or the
//                          old usage and puts back -1 where the mark pass
//                          wrote, so no fill pass runs. Bound: bytes (the
//                          usage read and written once, the ring's row
//                          column read once).
//   K8 nomad_cold_packet   replaces a_cold (:777-817): one call over the S
//                          logical shards of n_loc rows each (S = 1 with a
//                          row_base is one shard's stage, kept for a mesh
//                          over several cards). The masked score per key
//                          [T, S n_loc] read from the packed table (the
//                          K1/K2 arithmetic) in one pass; read as [T S,
//                          n_loc], segment g = t S + s is exactly shard s's
//                          rows of key t, so K2's select and rank
//                          (select.cuh: a radix select spread over the
//                          card) take each segment's feasible count and
//                          top-B rows by (score desc, local row asc), as a
//                          per-shard call would; then the packets [S T B,
//                          W = 6+2R+T] in the reference's column layout,
//                          the feasible counts [S, T] and the top-B values
//                          [S, T, B], written straight in the exchange's
//                          (shard, key, b) order. Seven launches a call
//                          (eight when B is over the select's 4,096-key
//                          sort). Bound: bytes (the table, usage and masks
//                          once).
//   K9 nomad_pool_build    replaces pool_build (:819-836): the S*T*B packet
//                          rows in ascending (global row, position) order,
//                          first-occurrence keep, pool_use, tau[t] = max_s
//                          vals[s, t, B-1], nf0 = sum_s nf0_s, and the
//                          pool's columns as K2 and K4a read a table (rows,
//                          capacity, score_cap, counts, bans, noise,
//                          eligibility AND keep as [T, C]); the packed pool
//                          [C, W] itself is never written. The packets are
//                          S*T segments of B rows (one per shard and key),
//                          so two launches over the card: one block per
//                          segment sorts its B unique u64 keys (row << 32 |
//                          position) by bitonic sort, in shared memory up to
//                          16,384 keys and in place in the key buffer
//                          beyond; then one thread per row places it at its
//                          rank in its own segment plus, for every other
//                          segment, the count of keys below its own (a
//                          binary search, eight segments' searches
//                          interleaved), and the largest of those keys is
//                          its predecessor in the merged order, which
//                          decides keep. That thread gathers the row's
//                          columns straight to their final index. Exact for
//                          any packet: the keys are unique. Bound: bytes
//                          (under 2.5 MB at the 1M-row shape); the sort's
//                          barriers set its time.
//   K10 nomad_warm_finish  replaces the rest of warm_step (:870-878,
//                          :942-962) after K2 (window-start pass over the
//                          pool), K3 (sorted selection, first-occurrence
//                          dedup) and K4a (replay over the pool): the
//                          exactness certificate and its flag, the next
//                          window's nf0, the pool-index -> global-row
//                          translation of the packed result, and the ring
//                          append (a copy of the ring with the window's
//                          [P, 1+R] winner delta at ring_n, clamped as
//                          dynamic_update_slice clamps). One launch over
//                          the card: blocks of pool rows count per key
//                          (scores above tau, rows feasible after the
//                          window) into a small scratch with atomicAdd, and
//                          the last of them, found by an atomic ticket,
//                          writes nf0_2 and the flag and zeroes the scratch
//                          (no fill launch); other blocks copy the ring as
//                          16-byte vectors around the delta, whose rows and
//                          packed one thread per step writes. ring2 is a
//                          new tensor: a window whose certificate fails is
//                          re-run from the old ring. Bound: bytes (the
//                          ring read and written, 3.1 MB at the served
//                          mesh's 65,536-row ring).
//
// Float contract: K8 scores with score.cuh's rounded intrinsics in the
// reference's order of operations (-fmad=false), so it and its plain version
// agree bit for bit; every other kernel here only moves and compares floats.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockThreads = 1024;
constexpr int kPackRows = 256;       // K6: rows a block stages
constexpr int kApplyRows = 256;      // K7's write pass: rows per block
constexpr int kSmemSortKeys = 16384;  // K9 sorts a segment in shared memory up to this
constexpr int kSearchLanes = 8;       // K9: segments searched side by side
constexpr int kFinishRows = 1024;     // K10: pool rows a reduce block counts
constexpr int kCopyVecs = 1024;       // K10: 16-byte ring vectors a copy block moves

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// ------------------------------------------------------------------ K6

// One block per tile of `tile` rows (a multiple of 4): the tile's rows
// staged in shared memory as [rows, R + 5], capacity read as its
// contiguous rows * R floats, score_cap as float2 (two floats when vec_sc
// is 0), the rest one per thread; then the tile's contiguous rows * (R + 5)
// floats written out, as 16-byte vectors when vec_out (the table 16-byte
// aligned; every tile starts on a vector, since tile is a multiple of 4)
// and as scalars past the last whole vector.
__global__ void __launch_bounds__(kThreads) k6_pack(
    const float* __restrict__ capacity, const float* __restrict__ score_cap,
    const int32_t* __restrict__ counts, const float* __restrict__ noise,
    const uint8_t* __restrict__ banned, int n, int r_dims, int tile,
    int vec_sc, int vec_out, float* __restrict__ table) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int w = r_dims + 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int rows = static_cast<int>(n - row0 < tile ? n - row0 : tile);
  const float* cap = capacity + row0 * r_dims;
  const int n_cap = rows * r_dims;
  for (int e = threadIdx.x; e < n_cap; e += blockDim.x) {
    const int j = e / r_dims;
    stage[j * w + (e - j * r_dims)] = cap[e];
  }
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    const int64_t i = row0 + j;
    float* out = stage + j * w + r_dims;
    if (vec_sc) {
      const float2 v = reinterpret_cast<const float2*>(score_cap)[i];
      out[0] = v.x;
      out[1] = v.y;
    } else {
      out[0] = score_cap[2 * i];
      out[1] = score_cap[2 * i + 1];
    }
    out[2] = static_cast<float>(counts[i]);
    out[3] = noise[i];
    out[4] = banned[i] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int n_el = rows * w;
  float* dst = table + row0 * w;
  int e0 = 0;
  if (vec_out) {
    const int n_vec = n_el >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x) dst4[v] = stage4[v];
    e0 = n_vec << 2;
  }
  for (int e = e0 + threadIdx.x; e < n_el; e += blockDim.x) dst[e] = stage[e];
}

// ------------------------------------------------------------------ K7

// One thread per ring entry: the last entry per owned row wins. pos holds
// -1 on entry for every row.
__global__ void k7_mark(const float* __restrict__ ring, int ring_rows,
                        int r_dims, int row_base, int n_rows,
                        int32_t* __restrict__ pos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ring_rows) return;
  const float rf = ring[static_cast<int64_t>(i) * (r_dims + 1)];
  if (!(rf >= 0.0f)) return;  // padding / not-found entries carry -1
  const int drow = static_cast<int>(rf) - row_base;
  if (drow >= 0 && drow < n_rows) atomicMax(&pos[drow], i);
}

// One block per kApplyRows rows: the tile of old usage through shared
// memory, each marked row overwritten from its ring entry (and its pos put
// back to -1), the tile written out.
__global__ void k7_write(const float* __restrict__ usage,
                         const float* __restrict__ ring,
                         int32_t* __restrict__ pos, int n_rows, int r_dims,
                         float* __restrict__ out) {
  extern __shared__ float tile[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kApplyRows;
  const int rows = static_cast<int>(
      n_rows - row0 < kApplyRows ? n_rows - row0 : kApplyRows);
  const int n_el = rows * r_dims;
  const float* src = usage + row0 * r_dims;
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) tile[e] = src[e];
  __syncthreads();
  if (threadIdx.x < rows) {
    const int p = pos[row0 + threadIdx.x];
    if (p >= 0) {
      pos[row0 + threadIdx.x] = -1;
      const float* ent = ring + static_cast<int64_t>(p) * (r_dims + 1) + 1;
      for (int k = 0; k < r_dims; ++k) tile[threadIdx.x * r_dims + k] = ent[k];
    }
  }
  __syncthreads();
  float* dst = out + row0 * r_dims;
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) dst[e] = tile[e];
}

// ------------------------------------------------------------------ K8

// One thread per (key, row) over every shard's rows: K2's window-start
// score pass, reading capacity, score_cap, the count, noise and the ban
// from the packed table. Block x of key t also starts the select of
// segments t S + s for s = x, x + gridDim.x, ...
__global__ void k8_score(const float* __restrict__ table,
                         const float* __restrict__ usage,
                         const uint8_t* __restrict__ masks, int64_t mask_ld,
                         const float* __restrict__ key_demands, float penalty,
                         int distinct, int n, int n_loc, int n_shards,
                         int r_dims, float* __restrict__ masked0,
                         SelectState* __restrict__ sel_states,
                         unsigned int* __restrict__ sel_hist, int b_buf) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  for (int s = blockIdx.x; s < n_shards; s += gridDim.x)
    select_init(sel_states, sel_hist, t * n_shards + s, n_loc, b_buf);
  if (row >= n) return;
  const int w = r_dims + 5;
  const float* tab = table + static_cast<int64_t>(row) * w;
  const float* use = usage + static_cast<int64_t>(row) * r_dims;
  const float* d = key_demands + static_cast<int64_t>(t) * r_dims;
  bool ok = masks[static_cast<int64_t>(t) * mask_ld + row] != 0 &&
            !(distinct && tab[r_dims + 4] > 0.5f);
  for (int k = 0; k < r_dims; ++k) ok = ok && (__fsub_rn(tab[k], use[k]) >= d[k]);
  float s = NOMAD_NEG_INF;
  if (ok) {
    const float base = bestfit_score(__fadd_rn(use[0], d[0]),
                                     __fadd_rn(use[1], d[1]), tab[r_dims],
                                     tab[r_dims + 1]);
    s = adjusted_score(base, tab[r_dims + 2], penalty, tab[r_dims + 3]);
  }
  masked0[static_cast<int64_t>(t) * n + row] = s;
}

// One thread per packet row i = (s T + t) B + b, the exchange's order: the
// b-th selected local row of segment g = t S + s, its columns in the
// reference's layout [row, capacity(R), score_cap(2), usage(R), counts,
// banned, noise, elig(T)], its value, and (b = 0) the segment's feasible
// count at nf_all[s, t].
__global__ void k8_packet(const float* __restrict__ table,
                          const float* __restrict__ usage,
                          const uint8_t* __restrict__ masks, int64_t mask_ld,
                          const float* __restrict__ masked0,
                          const int32_t* __restrict__ cand,
                          const int32_t* __restrict__ nf_sel, int n_keys,
                          int n_shards, int n, int n_loc, int b_buf,
                          int r_dims, int row_base, float* __restrict__ pkt,
                          int32_t* __restrict__ nf_all,
                          float* __restrict__ vals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(n_shards) * n_keys * b_buf) return;
  const int st = static_cast<int>(i / b_buf);
  const int b = static_cast<int>(i - static_cast<int64_t>(st) * b_buf);
  const int s = st / n_keys;
  const int t = st - s * n_keys;
  const int g = t * n_shards + s;
  const int row = s * n_loc + cand[static_cast<int64_t>(g) * b_buf + b];
  const int w_tab = r_dims + 5;
  const int w = 6 + 2 * r_dims + n_keys;
  const float* tab = table + static_cast<int64_t>(row) * w_tab;
  const float* use = usage + static_cast<int64_t>(row) * r_dims;
  float* out = pkt + i * w;
  out[0] = static_cast<float>(row + row_base);
  for (int k = 0; k < r_dims; ++k) out[1 + k] = tab[k];
  out[1 + r_dims] = tab[r_dims];
  out[2 + r_dims] = tab[r_dims + 1];
  for (int k = 0; k < r_dims; ++k) out[3 + r_dims + k] = use[k];
  out[3 + 2 * r_dims] = tab[r_dims + 2];
  out[4 + 2 * r_dims] = tab[r_dims + 4] > 0.5f ? 1.0f : 0.0f;
  out[5 + 2 * r_dims] = tab[r_dims + 3];
  for (int q = 0; q < n_keys; ++q)
    out[6 + 2 * r_dims + q] =
        masks[static_cast<int64_t>(q) * mask_ld + row] != 0 ? 1.0f : 0.0f;
  vals[i] = masked0[static_cast<int64_t>(t) * n + row];
  if (b == 0) nf_all[st] = nf_sel[g];
}

// ------------------------------------------------------------------ K9

// One block per segment g (B packet rows): its keys row << 32 | position,
// the row's sign bit flipped so unsigned order is the int32 order, sorted
// into skeys[g * ld, g * ld + B) (ld = next_pow2(B)). Block 0 also writes
// tau and nf0.
__global__ void k9_sort(const float* __restrict__ cand, int b_buf, int w,
                        int ld, const int32_t* __restrict__ nf_all,
                        const float* __restrict__ vals_all, int n_shards,
                        int n_keys, uint64_t* __restrict__ skeys,
                        float* __restrict__ tau, int32_t* __restrict__ nf0) {
  extern __shared__ uint64_t sbuf[];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * b_buf;
  uint64_t* seg = skeys + static_cast<int64_t>(blockIdx.x) * ld;
  const bool in_smem = ld <= kSmemSortKeys;
  uint64_t* buf = in_smem ? sbuf : seg;
  for (int i = threadIdx.x; i < ld; i += blockDim.x) {
    if (i < b_buf) {
      const uint32_t row = static_cast<uint32_t>(
          static_cast<int32_t>(cand[(first + i) * w]));
      buf[i] = (static_cast<uint64_t>(row ^ 0x80000000u) << 32) |
               static_cast<uint32_t>(first + i);
    } else {
      buf[i] = ~0ull;
    }
  }
  __syncthreads();
  block_bitonic_sort(buf, ld);
  if (in_smem)
    for (int i = threadIdx.x; i < b_buf; i += blockDim.x) seg[i] = buf[i];
  if (blockIdx.x != 0) return;
  for (int t = threadIdx.x; t < n_keys; t += blockDim.x) {
    float m = vals_all[static_cast<int64_t>(t) * b_buf + b_buf - 1];
    int32_t s_nf = nf_all[t];
    for (int s = 1; s < n_shards; ++s) {
      m = fmaxf(m, vals_all[(static_cast<int64_t>(s) * n_keys + t) * b_buf +
                            b_buf - 1]);
      s_nf += nf_all[s * n_keys + t];
    }
    tau[t] = m;
    nf0[t] = s_nf;
  }
}

// One thread per packet row, taken in sorted-segment order: its index in
// the merged order (its rank in its segment plus, per other segment, the
// keys below it: a binary search by powers of two from top = the largest
// power of two <= B), its predecessor there (the largest key below it of
// any segment) for keep, and its columns gathered to that index.
__global__ void k9_place(const float* __restrict__ cand,
                         const uint64_t* __restrict__ skeys, int ld, int n_seg,
                         int b_buf, int top, int w, int r_dims, int n_keys,
                         float* __restrict__ pool_use,
                         uint8_t* __restrict__ keep, int32_t* __restrict__ rows,
                         float* __restrict__ cap, float* __restrict__ sc,
                         int32_t* __restrict__ cnt, uint8_t* __restrict__ ban,
                         float* __restrict__ noise,
                         uint8_t* __restrict__ elig) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_cand = n_seg * b_buf;
  if (i >= n_cand) return;
  const int g = i / b_buf;
  const int j = i - g * b_buf;
  const uint64_t* own = skeys + static_cast<int64_t>(g) * ld;
  const uint64_t key = own[j];
  int dst = j;
  bool has_pred = j > 0;
  uint64_t pred = has_pred ? own[j - 1] : 0;
  for (int h0 = 0; h0 < n_seg; h0 += kSearchLanes) {
    int lo[kSearchLanes];
#pragma unroll
    for (int q = 0; q < kSearchLanes; ++q) lo[q] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int q = 0; q < kSearchLanes; ++q) {
        const int h = h0 + q;
        const int probe = lo[q] + step;
        if (h < n_seg && h != g && probe <= b_buf &&
            skeys[static_cast<int64_t>(h) * ld + probe - 1] < key)
          lo[q] = probe;
      }
    }
#pragma unroll
    for (int q = 0; q < kSearchLanes; ++q) {
      const int h = h0 + q;
      if (h >= n_seg || h == g || lo[q] == 0) continue;
      dst += lo[q];
      const uint64_t below = skeys[static_cast<int64_t>(h) * ld + lo[q] - 1];
      if (!has_pred || below > pred) {
        pred = below;
        has_pred = true;
      }
    }
  }
  const bool kept = !has_pred || (pred >> 32) != (key >> 32);
  const float* src = cand + static_cast<int64_t>(key & 0xffffffffu) * w;
  keep[dst] = kept ? 1 : 0;
  rows[dst] = static_cast<int32_t>(src[0]);
  for (int k = 0; k < r_dims; ++k) {
    cap[static_cast<int64_t>(dst) * r_dims + k] = src[1 + k];
    pool_use[static_cast<int64_t>(dst) * r_dims + k] = src[3 + r_dims + k];
  }
  sc[2 * static_cast<int64_t>(dst)] = src[1 + r_dims];
  sc[2 * static_cast<int64_t>(dst) + 1] = src[2 + r_dims];
  cnt[dst] = static_cast<int32_t>(src[3 + 2 * r_dims]);
  ban[dst] = src[4 + 2 * r_dims] > 0.5f ? 1 : 0;
  noise[dst] = src[5 + 2 * r_dims];
  for (int t = 0; t < n_keys; ++t)
    elig[static_cast<int64_t>(t) * n_cand + dst] =
        (kept && src[6 + 2 * r_dims + t] > 0.5f) ? 1 : 0;
}

// ----------------------------------------------------------------- K10

// Sum of v over the block (kThreads threads); meaningful in thread 0.
__device__ int block_sum(int v, int* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int q = 0; q < kThreads / 32; ++q) total += warp_buf[q];
  __syncthreads();
  return total;
}

// One launch, three kinds of block by blockIdx.x:
//   [0, n_red)          reduce: key t = b / tiles, pool rows
//                       [tile * kFinishRows, +kFinishRows): the rows scoring
//                       above tau and the rows feasible after the window,
//                       added into scratch[2t], scratch[2t + 1]; then a
//                       ticket, and the last block to take one writes nf0_2
//                       and flag and puts the scratch back to zero.
//   [n_red, +n_copy)    copy: the ring as a flat run of floats, 16-byte
//                       vectors when aligned, kCopyVecs vectors a block,
//                       leaving out the delta's floats.
//   the rest            delta: one thread per step, its packed row in global
//                       rows and its [1 + R] ring row at start + step.
// The counts are integers, so the atomics' order changes no bit of nf0_2.
__global__ void __launch_bounds__(kThreads) k10_finish(
    const float* __restrict__ masked0, const float* __restrict__ cap,
    const float* __restrict__ pool_use2, const uint8_t* __restrict__ elig,
    const uint8_t* __restrict__ ban, const float* __restrict__ key_demands,
    int distinct, const float* __restrict__ tau,
    const int32_t* __restrict__ nf0, const int32_t* __restrict__ n_fin,
    int n_pool, int n_keys, int r_dims, int k_sel, int tiles, int n_red,
    const float* __restrict__ packed_loc, const int32_t* __restrict__ win,
    const float* __restrict__ c_use, const int32_t* __restrict__ pool_rows,
    const float* __restrict__ ring, int ring_rows, int start, int n_steps,
    int n_copy, int vec, int32_t* __restrict__ scratch,
    float* __restrict__ packed, int32_t* __restrict__ nf0_2,
    float* __restrict__ ring2, float* __restrict__ flag) {
  const int b = blockIdx.x;
  if (b < n_red) {
    __shared__ int warp_buf[kThreads / 32];
    __shared__ bool last;
    const int t = b / tiles;
    const int c0 = (b - t * tiles) * kFinishRows;
    const int c1 = c0 + kFinishRows < n_pool ? c0 + kFinishRows : n_pool;
    int above = 0;
    int ok_f = 0;
    if (t < n_keys) {
      const float* m = masked0 + static_cast<int64_t>(t) * n_pool;
      const float* d = key_demands + static_cast<int64_t>(t) * r_dims;
      const float tt = tau[t];
      for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
        above += m[c] > tt;
        bool ok = elig[static_cast<int64_t>(t) * n_pool + c] != 0 &&
                  !(distinct && ban[c]);
        for (int k = 0; k < r_dims; ++k)
          ok = ok && (__fsub_rn(cap[static_cast<int64_t>(c) * r_dims + k],
                                pool_use2[static_cast<int64_t>(c) * r_dims + k]) >=
                      d[k]);
        ok_f += ok;
      }
    }
    above = block_sum(above, warp_buf);
    ok_f = block_sum(ok_f, warp_buf);
    if (threadIdx.x == 0) {
      if (t < n_keys) {
        atomicAdd(&scratch[2 * t], above);
        atomicAdd(&scratch[2 * t + 1], ok_f);
      }
      __threadfence();
      last = atomicAdd(&scratch[2 * n_keys], 1) == n_red - 1;
    }
    __syncthreads();
    if (!last) return;
    // Every other block's counts landed before its ticket.
    __threadfence();
    int uncertified = 0;
    for (int q = threadIdx.x; q < n_keys; q += kThreads) {
      const int n_above = atomicExch(&scratch[2 * q], 0);
      const int n_ok = atomicExch(&scratch[2 * q + 1], 0);
      uncertified |= !(n_above >= k_sel || n_fin[q] >= nf0[q]);
      nf0_2[q] = nf0[q] + (n_ok - n_fin[q]);
    }
    uncertified = __syncthreads_or(uncertified);
    if (threadIdx.x == 0) {
      *flag = uncertified ? 1.0f : 0.0f;
      scratch[2 * n_keys] = 0;
    }
    return;
  }
  const int w1 = r_dims + 1;
  if (b < n_red + n_copy) {
    const int64_t total = static_cast<int64_t>(ring_rows) * w1;
    const int64_t d0 = static_cast<int64_t>(start) * w1;
    const int64_t d1 = d0 + static_cast<int64_t>(n_steps) * w1;
    const int64_t f_lo = static_cast<int64_t>(b - n_red) * kCopyVecs * 4;
    const int64_t f_hi =
        f_lo + kCopyVecs * 4 < total ? f_lo + kCopyVecs * 4 : total;
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(ring);
      float4* dst = reinterpret_cast<float4*>(ring2);
      for (int64_t f = f_lo + 4 * threadIdx.x; f < f_hi; f += 4 * kThreads) {
        if (f + 4 <= d0 || f >= d1) {
          dst[f >> 2] = src[f >> 2];
        } else {
          for (int e = 0; e < 4; ++e)
            if (f + e < d0 || f + e >= d1) ring2[f + e] = ring[f + e];
        }
      }
    } else {
      for (int64_t f = f_lo + threadIdx.x; f < f_hi; f += kThreads)
        if (f < d0 || f >= d1) ring2[f] = ring[f];
    }
    return;
  }
  const int j = (b - n_red - n_copy) * kThreads + threadIdx.x;
  if (j >= n_steps) return;
  const float* src = packed_loc + 3 * static_cast<int64_t>(j);
  const float loc = src[0];
  const float row =
      loc >= 0.0f ? static_cast<float>(pool_rows[static_cast<int>(loc)]) : -1.0f;
  float* out = packed + 3 * static_cast<int64_t>(j);
  out[0] = row;
  out[1] = src[1];
  out[2] = src[2];
  float* dst = ring2 + static_cast<int64_t>(start + j) * w1;
  const float* u = c_use + static_cast<int64_t>(win[j]) * r_dims;
  dst[0] = row;
  for (int k = 0; k < r_dims; ++k) dst[1 + k] = u[k];
}

}  // namespace

extern "C" {

// K6. table [n, r_dims + 5] f32.
int nomad_mesh_pack(const float* capacity, const float* score_cap,
                    const int32_t* counts, const float* noise,
                    const uint8_t* banned, int n, int r_dims, float* table,
                    cudaStream_t stream) {
  const int w = r_dims + 5;
  int tile = kPackRows;
  while (tile > 4 && static_cast<size_t>(tile) * w * sizeof(float) > 48 * 1024)
    tile >>= 1;
  if (r_dims < 1 || static_cast<size_t>(tile) * w * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int vec_sc = reinterpret_cast<uintptr_t>(score_cap) % 8 == 0;
    const int vec_out = reinterpret_cast<uintptr_t>(table) % 16 == 0;
    const unsigned int blocks =
        static_cast<unsigned int>((static_cast<int64_t>(n) + tile - 1) / tile);
    k6_pack<<<blocks, kThreads, tile * w * sizeof(float), stream>>>(
        capacity, score_cap, counts, noise, banned, n, r_dims, tile, vec_sc,
        vec_out, table);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7. usage/out [n_rows, r_dims] (rows row_base.. of the table: one shard,
// or every shard with row_base 0), ring [ring_rows, 1 + r_dims], pos
// [n_rows] int scratch holding -1 on entry, left so.
int nomad_apply_ring(const float* usage, const float* ring, int ring_rows,
                     int r_dims, int row_base, int n_rows, int32_t* pos,
                     float* out, cudaStream_t stream) {
  // Refused before the mark pass, so a refusal never leaves marks in pos.
  if (r_dims < 1 || r_dims * kApplyRows * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    if (ring_rows > 0)
      k7_mark<<<blocks_for(ring_rows), kThreads, 0, stream>>>(
          ring, ring_rows, r_dims, row_base, n_rows, pos);
    const unsigned int blocks = static_cast<unsigned int>(
        (static_cast<int64_t>(n_rows) + kApplyRows - 1) / kApplyRows);
    k7_write<<<blocks, kApplyRows, kApplyRows * r_dims * sizeof(float),
               stream>>>(usage, ring, pos, n_rows, r_dims, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8. S = n_shards shards of n_loc rows, rows [s n_loc, (s + 1) n_loc) of
// table [S n_loc, r_dims + 5], usage [S n_loc, r_dims] and masks [n_keys,
// S n_loc] (row stride mask_ld). Outputs, in the exchange's layout: pkt
// [S n_keys b_buf, 6 + 2 r_dims + n_keys] in (shard, key, b) order whose
// row column is row_base + the row, nf_all [S, n_keys] i32 and vals [S,
// n_keys, b_buf]. Scratch: masked0 [n_keys, S n_loc], nf_sel [n_keys S],
// unordered and cand [n_keys S, b_buf], and work
// (nomad_select_work_bytes(n_keys S) bytes), which the call initializes.
int nomad_cold_packet(const float* table, const float* usage,
                      const uint8_t* masks, int64_t mask_ld,
                      const float* key_demands, float penalty, int distinct,
                      int n_loc, int n_shards, int r_dims, int n_keys,
                      int b_buf, int row_base, float* masked0, int32_t* nf_sel,
                      int32_t* unordered, int32_t* cand, float* pkt,
                      int32_t* nf_all, float* vals, void* work,
                      cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(n_loc) * n_shards;
  const int64_t n_seg = static_cast<int64_t>(n_keys) * n_shards;
  if (r_dims < 2 || n_keys < 1 || n_shards < 1 || b_buf < 1 ||
      b_buf > n_loc || n > INT32_MAX || n_seg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const SelectWork sw = select_work(work, static_cast<int>(n_seg));
  dim3 score_grid(blocks_for(n), n_keys);
  k8_score<<<score_grid, kThreads, 0, stream>>>(
      table, usage, masks, mask_ld, key_demands, penalty, distinct,
      static_cast<int>(n), n_loc, n_shards, r_dims, masked0, sw.states,
      sw.hist, b_buf);
  launch_select(masked0, n_loc, static_cast<int>(n_seg), b_buf, work, nf_sel,
                unordered, cand, stream);
  k8_packet<<<blocks_for(n_seg * b_buf), kThreads, 0, stream>>>(
      table, usage, masks, mask_ld, masked0, cand, nf_sel, n_keys, n_shards,
      static_cast<int>(n), n_loc, b_buf, r_dims, row_base, pkt, nf_all, vals);
  return static_cast<int>(cudaGetLastError());
}

// K9. cand [n_seg * b_buf, w] (the exchanged packets: n_seg = S * T
// segments of b_buf rows), nf_all [S, T] i32, vals_all [S, T, b_buf] f32;
// skeys [n_seg * next_pow2(b_buf)] u64 is scratch.
int nomad_pool_build(const float* cand, int n_seg, int b_buf, int w,
                     const int32_t* nf_all, const float* vals_all,
                     int n_shards, int n_keys, int r_dims, uint64_t* skeys,
                     float* pool_use, uint8_t* keep, float* tau, int32_t* nf0,
                     int32_t* rows, float* cap, float* sc, int32_t* cnt,
                     uint8_t* ban, float* noise, uint8_t* elig,
                     cudaStream_t stream) {
  if (n_seg < 1 || b_buf < 1) return static_cast<int>(cudaErrorInvalidValue);
  int ld = 1;
  while (ld < b_buf) ld <<= 1;
  const int top = ld == b_buf ? ld : ld >> 1;
  const size_t smem =
      ld <= kSmemSortKeys ? static_cast<size_t>(ld) * sizeof(uint64_t) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k9_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads =
      ld / 2 < 32 ? 32 : (ld / 2 > kBlockThreads ? kBlockThreads : ld / 2);
  k9_sort<<<n_seg, threads, smem, stream>>>(cand, b_buf, w, ld, nf_all,
                                            vals_all, n_shards, n_keys, skeys,
                                            tau, nf0);
  k9_place<<<blocks_for(static_cast<int64_t>(n_seg) * b_buf), kThreads, 0,
             stream>>>(cand, skeys, ld, n_seg, b_buf, top, w, r_dims, n_keys,
                       pool_use, keep, rows, cap, sc, cnt, ban, noise, elig);
  return static_cast<int>(cudaGetLastError());
}

// K10. masked0 [T, C] and n_fin [T] from K2 over the pool; packed_loc [P, 3]
// (pool indices), win [P] and c_use [n_sel, R] from K4a; pool_use2 [C, R] is
// K4a's usage_out. Outputs packed [P, 3] (global rows), nf0_2 [T], ring2
// [ring_rows, 1 + R] and flag (one f32). scratch [2T + 1] i32 holds 0 on
// entry and is left so; vec says ring and ring2 are 16-byte aligned and
// ring_rows * (1 + R) is a multiple of 4.
int nomad_warm_finish(const float* masked0, const int32_t* n_fin,
                      const float* packed_loc, const int32_t* win,
                      const float* c_use, const int32_t* pool_rows,
                      const float* cap, const float* pool_use2,
                      const uint8_t* elig, const uint8_t* ban,
                      const float* key_demands, int distinct, const float* tau,
                      const int32_t* nf0, const float* ring, int ring_rows,
                      int ring_n, int n_pool, int n_keys, int r_dims,
                      int n_steps, int k_sel, float* packed, int32_t* nf0_2,
                      float* ring2, float* flag, int32_t* scratch, int vec,
                      cudaStream_t stream) {
  if (n_steps > ring_rows) return static_cast<int>(cudaErrorInvalidValue);
  const int start = ring_n < 0 ? 0
                    : (ring_n > ring_rows - n_steps ? ring_rows - n_steps
                                                    : ring_n);
  const int tiles =
      n_pool > kFinishRows ? (n_pool + kFinishRows - 1) / kFinishRows : 1;
  const int n_red = n_keys > 0 ? n_keys * tiles : 1;
  const int64_t floats = static_cast<int64_t>(ring_rows) * (r_dims + 1);
  const int n_copy =
      static_cast<int>((floats + kCopyVecs * 4 - 1) / (kCopyVecs * 4));
  const int n_delta = (n_steps + kThreads - 1) / kThreads;
  k10_finish<<<n_red + n_copy + n_delta, kThreads, 0, stream>>>(
      masked0, cap, pool_use2, elig, ban, key_demands, distinct, tau, nf0,
      n_fin, n_pool, n_keys, r_dims, k_sel, tiles, n_red, packed_loc, win,
      c_use, pool_rows, ring, ring_rows, start, n_steps, n_copy, vec, scratch,
      packed, nf0_2, ring2, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
