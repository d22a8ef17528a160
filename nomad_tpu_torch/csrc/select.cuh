// Selection building blocks shared by K2 (keyed.cu) and K8 (mesh.cu): each
// translation unit that includes this header gets its own copy of these
// kernels and device functions.
//
//   launch_select      per key t, nf0[t] (its feasible rows) and the kc rows
//                      of masked0[t] with the smallest (score desc, row asc)
//                      u64 keys (desc_score_key), in that order. A radix
//                      select spread over the card:
//       select_init    (in block 0 of the score kernel that writes masked0)
//                      the per-key state and a zeroed histogram;
//       sel_pass       x kGridPasses, grid-wide: each block histograms a
//                      12-bit digit of the keys still in play in shared
//                      memory (warp-aggregated atomics) and adds it to the
//                      key's global histogram; the last block to arrive
//                      finds the digit of the kc-th key and narrows the
//                      prefix. A pass returns at once when the keys in play
//                      number at most kSelCap or are all to be taken;
//       sel_compact    grid-wide: counts nf0, appends every row below the
//                      prefix to the output and buffers the keys in play
//                      when they fit kSelCap, warp-aggregated;
//       sel_finish     one block per key: an 8-bit radix select over the
//                      keys in play (from shared memory, or read again from
//                      the scores when over kSelCap of them tie on the top
//                      36 bits), appending the rest of the kc rows, then a
//                      bitonic sort of the kc keys in shared memory that
//                      writes them in (score desc, row asc) order exactly as
//                      lax.top_k orders them, -inf entries included.
//                      Keys are unique (the row is the low word), so the
//                      selected set is fully determined and the order of
//                      the atomics cannot change it.
//   k2_rank            for kc above kSelCap only: one thread per selected
//                      row, its rank among the key's kc selected keys.
//   block_bitonic_sort ascending sort of a power-of-two count of u64 keys by
//                      one block (shared or global memory).
//
// Bound of the select: it reads the [T, n] scores once per grid pass from
// L2 (two on the port's data before the survivors fit) and once more to
// compact, so at a shard's 131,072 rows it is a few launches of a few
// microseconds each, not the 4 B/row of bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score.cuh"

namespace {

constexpr int kRankThreads = 256;
constexpr int kSelThreads = 256;          // grid pass and compaction blocks
constexpr int kSelRowsPerBlock = 1024;    // rows per block before it strides
constexpr int kSelMaxBlocks = 264;        // two per SM of an H100
constexpr int kDigitBits = 12;            // a grid pass's digit
constexpr int kBins = 1 << kDigitBits;
constexpr int kGridPasses = 3;            // resolves the score word + 4 bits
constexpr int kSelCap = 4096;             // survivors the finish holds
constexpr int kFinishThreads = 1024;
constexpr int kFinishBits = 8;            // the finish's digit
constexpr unsigned kSelFull = 0xffffffffu;

// One 128-byte line per key: K8 selects S*T segments in one call, and its
// compaction's per-warp atomics on n_out, n_cand and nf would otherwise
// meet on the few lines that hold every segment's counters.
struct alignas(128) SelectState {
  unsigned long long prefix;  // resolved high bits of the kc-th key
  int lo;                     // lowest resolved bit; 64 before any pass
  int k_rem;                  // keys still to take among those in play
  int m;                      // keys in play (matching prefix above lo)
  int done;                   // no grid pass left to run
  unsigned int arrive;        // blocks through the current pass
  int n_out;                  // rows appended by the compaction
  int n_cand;                 // survivors buffered for the finish
  int nf;                     // feasible rows
};

// Work buffer of launch_select: the states, then [T, kBins] u32 histograms,
// then [T, kSelCap] u64 survivor keys.
inline int64_t select_state_bytes(int n_keys) {
  return (static_cast<int64_t>(n_keys) * sizeof(SelectState) + 15) & ~15LL;
}

inline int64_t select_work_bytes(int n_keys) {
  return select_state_bytes(n_keys) +
         static_cast<int64_t>(n_keys) * kBins * sizeof(unsigned int) +
         static_cast<int64_t>(n_keys) * kSelCap * sizeof(uint64_t);
}

// Whether key k is in play: equal to prefix p at and above bit lo.
__device__ __forceinline__ bool in_play(uint64_t k, uint64_t p, int lo) {
  return lo >= 64 || (k >> lo) == (p >> lo);
}

// Ascending bitonic sort of n_pow2 u64 keys by one block (blockDim a
// multiple of 32). A stage whose partner distance j is under 32 pairs
// elements inside one warp's 32-aligned run, so only the stages that cross
// warps, or follow one that did, end in a block barrier.
__device__ void block_bitonic_sort(uint64_t* buf, int n_pow2) {
  for (int k = 2; k <= n_pow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = buf[i];
          const uint64_t b = buf[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            buf[i] = b;
            buf[ixj] = a;
          }
        }
      }
      const int next_j = j > 1 ? j >> 1 : k;
      if (j >= 32 || next_j >= 32)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Exclusive prefix sum of v over a block of kSelThreads threads.
__device__ unsigned int block_exclusive_sum(unsigned int v,
                                            unsigned int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int o = __shfl_up_sync(kSelFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  unsigned int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  return before + incl - v;
}

// The per-key state and a zeroed histogram: block 0 of the score kernel
// that writes key t's scores runs it, before any pass.
__device__ __forceinline__ void select_init(SelectState* __restrict__ states,
                                            unsigned int* __restrict__ hist,
                                            int t, int n, int kc) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    hist[static_cast<int64_t>(t) * kBins + b] = 0;
  if (threadIdx.x == 0) {
    SelectState s{};
    s.lo = 64;
    s.k_rem = kc;
    s.m = n;
    s.done = n <= kSelCap || kc == n;
    states[t] = s;
  }
}

__global__ void __launch_bounds__(kSelThreads)
    sel_pass(const float* __restrict__ masked0, int n,
             SelectState* __restrict__ states, unsigned int* __restrict__ hist) {
  __shared__ unsigned int h[kBins];
  __shared__ unsigned int warp_tot[kSelThreads / 32];
  __shared__ bool last;
  const int t = blockIdx.y;
  SelectState* st = states + t;
  if (st->done) return;
  const int lo = st->lo;
  const uint64_t prefix = st->prefix;
  const int dlo = lo > kDigitBits ? lo - kDigitBits : 0;
  const int n_bins = 1 << (lo - dlo);
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < kBins; b += kSelThreads) h[b] = 0;
  __syncthreads();
  const float* m = masked0 + static_cast<int64_t>(t) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSelThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kSelThreads; base < n;
       base += stride) {
    const int i = static_cast<int>(base) + threadIdx.x;
    int digit = -1;
    if (i < n) {
      const uint64_t key = desc_score_key(m[i], static_cast<uint32_t>(i));
      if (in_play(key, prefix, lo))
        digit = static_cast<int>((key >> dlo) & static_cast<uint64_t>(n_bins - 1));
    }
    const unsigned int peers = __match_any_sync(kSelFull, digit);
    if (digit >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&h[digit], static_cast<unsigned int>(__popc(peers)));
  }
  __syncthreads();
  unsigned int* gh = hist + static_cast<int64_t>(t) * kBins;
  for (int b = threadIdx.x; b < n_bins; b += kSelThreads)
    if (h[b] != 0) atomicAdd(&gh[b], h[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&st->arrive, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The last block: every other block's histogram is in gh. Find the digit
  // whose bin holds the k_rem-th key in play and narrow the prefix to it.
  __threadfence();
  constexpr int kPer = kBins / kSelThreads;
  unsigned int c[kPer];
  unsigned int sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int b = threadIdx.x * kPer + e;
    c[e] = b < n_bins ? __ldcg(&gh[b]) : 0u;
    sum += c[e];
  }
  const unsigned int excl = block_exclusive_sum(sum, warp_tot);
  const unsigned int k_rem = static_cast<unsigned int>(st->k_rem);
  if (excl < k_rem && k_rem <= excl + sum) {
    unsigned int cum = excl;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (cum + c[e] >= k_rem) {
        const unsigned int rem = k_rem - cum;
        st->prefix = prefix | (static_cast<uint64_t>(threadIdx.x * kPer + e) << dlo);
        st->lo = dlo;
        st->k_rem = static_cast<int>(rem);
        st->m = static_cast<int>(c[e]);
        st->done = dlo == 0 || c[e] <= static_cast<unsigned int>(kSelCap) ||
                   c[e] == rem;
        break;
      }
      cum += c[e];
    }
  }
  for (int e = 0; e < kPer; ++e) {
    const int b = threadIdx.x * kPer + e;
    if (b < n_bins) gh[b] = 0;
  }
  if (threadIdx.x == 0) st->arrive = 0;
}

// Appends `take` lanes' values at consecutive positions from *count.
template <typename T>
__device__ __forceinline__ void warp_append(bool take, T value, int* count,
                                            T* out) {
  const int lane = threadIdx.x & 31;
  const unsigned int ballot = __ballot_sync(kSelFull, take);
  if (ballot == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(kSelFull, base, 0);
  if (take) out[base + __popc(ballot & ((1u << lane) - 1u))] = value;
}

__global__ void __launch_bounds__(kSelThreads)
    sel_compact(const float* __restrict__ masked0, int n, int kc,
                SelectState* __restrict__ states,
                uint64_t* __restrict__ cand_keys,
                int32_t* __restrict__ unordered) {
  const int t = blockIdx.y;
  SelectState* st = states + t;
  const int lo = st->lo;
  const uint64_t prefix = st->prefix;
  const bool take_all = st->k_rem == st->m;
  const bool buffer = !take_all && st->m <= kSelCap;
  const float* m = masked0 + static_cast<int64_t>(t) * n;
  int32_t* out = unordered + static_cast<int64_t>(t) * kc;
  uint64_t* buf = cand_keys + static_cast<int64_t>(t) * kSelCap;
  int feasible = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSelThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kSelThreads; base < n;
       base += stride) {
    const int i = static_cast<int>(base) + threadIdx.x;
    bool sel = false;
    bool keep = false;
    uint64_t key = 0;
    if (i < n) {
      const float s = m[i];
      feasible += s != NOMAD_NEG_INF;
      key = desc_score_key(s, static_cast<uint32_t>(i));
      const bool play = in_play(key, prefix, lo);
      sel = play ? take_all : key < prefix;
      keep = play && buffer;
    }
    warp_append<int32_t>(sel, i, &st->n_out, out);
    warp_append<uint64_t>(keep, key, &st->n_cand, buf);
  }
  feasible = __reduce_add_sync(kSelFull, feasible);
  if ((threadIdx.x & 31) == 0 && feasible != 0) atomicAdd(&st->nf, feasible);
}

__global__ void __launch_bounds__(kFinishThreads)
    sel_finish(const float* __restrict__ masked0, int n,
               const SelectState* __restrict__ states,
               const uint64_t* __restrict__ cand_keys, int kc, int sort,
               int32_t* __restrict__ nf0, int32_t* __restrict__ unordered,
               int32_t* __restrict__ cand) {
  __shared__ uint64_t keys[kSelCap];
  __shared__ unsigned int h[1 << kFinishBits];
  __shared__ uint64_t s_prefix;
  __shared__ int s_lo;
  __shared__ int s_krem;
  __shared__ int s_m;
  __shared__ int s_pos;
  const int t = blockIdx.x;
  const SelectState st = states[t];
  const float* m = masked0 + static_cast<int64_t>(t) * n;
  int32_t* sel = unordered + static_cast<int64_t>(t) * kc;
  if (threadIdx.x == 0) nf0[t] = st.nf;
  if (st.k_rem != st.m) {
    // The keys in play: buffered by the compaction, or (over kSelCap of
    // them) read again from the scores.
    const bool local = st.m <= kSelCap;
    const int count = local ? st.m : n;
    if (local)
      for (int i = threadIdx.x; i < count; i += kFinishThreads)
        keys[i] = cand_keys[static_cast<int64_t>(t) * kSelCap + i];
    if (threadIdx.x == 0) {
      s_prefix = st.prefix;
      s_lo = st.lo;
      s_krem = st.k_rem;
      s_m = st.m;
      s_pos = 0;
    }
    __syncthreads();
    auto key_at = [&](int i) -> uint64_t {
      return local ? keys[i] : desc_score_key(m[i], static_cast<uint32_t>(i));
    };
    const int lane = threadIdx.x & 31;
    constexpr int kFinBins = 1 << kFinishBits;
    constexpr int kPer = kFinBins / 32;
    // Narrow until every key in play is taken (at bit 0 one key is).
    while (s_krem < s_m && s_lo > 0) {
      const uint64_t prefix = s_prefix;
      const int lo = s_lo;
      const int dlo = lo > kFinishBits ? lo - kFinishBits : 0;
      const unsigned int dmask = (1u << (lo - dlo)) - 1u;
      for (int b = threadIdx.x; b < kFinBins; b += kFinishThreads) h[b] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < count; i += kFinishThreads) {
        const uint64_t key = key_at(i);
        if (in_play(key, st.prefix, st.lo) && in_play(key, prefix, lo))
          atomicAdd(&h[static_cast<unsigned int>(key >> dlo) & dmask], 1u);
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        unsigned int c[kPer];
        unsigned int sum = 0;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          c[e] = h[lane * kPer + e];
          sum += c[e];
        }
        unsigned int incl = sum;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned int o = __shfl_up_sync(kSelFull, incl, off);
          if (lane >= off) incl += o;
        }
        const unsigned int k_rem = static_cast<unsigned int>(s_krem);
        unsigned int cum = incl - sum;
        if (cum < k_rem && k_rem <= incl) {
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            if (cum + c[e] >= k_rem) {
              s_prefix = prefix | (static_cast<uint64_t>(lane * kPer + e) << dlo);
              s_lo = dlo;
              s_krem = static_cast<int>(k_rem - cum);
              s_m = static_cast<int>(c[e]);
              break;
            }
            cum += c[e];
          }
        }
      }
      __syncthreads();
    }
    // Take every key in play below the prefix or in play at its end.
    const uint64_t prefix = s_prefix;
    const int lo = s_lo;
    int32_t* out = sel + (kc - st.k_rem);
    for (int i = threadIdx.x; i < count; i += kFinishThreads) {
      const uint64_t key = key_at(i);
      if (in_play(key, st.prefix, st.lo) &&
          (key < prefix || in_play(key, prefix, lo)))
        out[atomicAdd(&s_pos, 1)] = static_cast<int32_t>(key & 0xffffffffu);
    }
  }
  if (!sort) return;
  // The kc selected rows in (score desc, row asc) order: their keys sorted
  // in shared memory (the picks above are visible after the barrier).
  __syncthreads();
  const int n_pow2 = next_pow2(kc);
  for (int i = threadIdx.x; i < n_pow2; i += kFinishThreads) {
    if (i < kc) {
      const int row = sel[i];
      keys[i] = desc_score_key(m[row], static_cast<uint32_t>(row));
    } else {
      keys[i] = ~0ull;
    }
  }
  __syncthreads();
  block_bitonic_sort(keys, n_pow2);
  for (int i = threadIdx.x; i < kc; i += kFinishThreads)
    cand[static_cast<int64_t>(t) * kc + i] =
        static_cast<int32_t>(keys[i] & 0xffffffffu);
}

// The select's work buffer, cut into its parts.
struct SelectWork {
  SelectState* states;
  unsigned int* hist;
  uint64_t* cand_keys;
};

inline SelectWork select_work(void* work, int n_keys) {
  char* w = static_cast<char*>(work);
  return {reinterpret_cast<SelectState*>(w),
          reinterpret_cast<unsigned int*>(w + select_state_bytes(n_keys)),
          reinterpret_cast<uint64_t*>(
              w + select_state_bytes(n_keys) +
              static_cast<int64_t>(n_keys) * kBins * sizeof(unsigned int))};
}

__global__ void k2_rank(const float* __restrict__ masked0,
                        const int32_t* __restrict__ unordered, int n, int kc,
                        int32_t* __restrict__ cand);

// The select's launches for n_keys keys over [n_keys, n] scores, after the
// score kernel that ran select_init; work holds select_work_bytes(n_keys)
// bytes. Writes nf0 and cand [n_keys, kc] (unordered [n_keys, kc] is
// scratch). The caller checks cudaGetLastError() after its last launch.
inline void launch_select(const float* masked0, int n, int n_keys, int kc,
                          void* work, int32_t* nf0, int32_t* unordered,
                          int32_t* cand, cudaStream_t stream) {
  const SelectWork sw = select_work(work, n_keys);
  int blocks = (n + kSelRowsPerBlock - 1) / kSelRowsPerBlock;
  blocks = blocks < 1 ? 1 : (blocks > kSelMaxBlocks ? kSelMaxBlocks : blocks);
  const dim3 grid(blocks, n_keys);
  for (int p = 0; p < kGridPasses; ++p)
    sel_pass<<<grid, kSelThreads, 0, stream>>>(masked0, n, sw.states, sw.hist);
  sel_compact<<<grid, kSelThreads, 0, stream>>>(masked0, n, kc, sw.states,
                                                sw.cand_keys, unordered);
  const bool sort = kc <= kSelCap;
  sel_finish<<<n_keys, kFinishThreads, 0, stream>>>(
      masked0, n, sw.states, sw.cand_keys, kc, sort, nf0, unordered, cand);
  if (!sort) {
    const dim3 rank_grid((kc + kRankThreads - 1) / kRankThreads, n_keys);
    k2_rank<<<rank_grid, kRankThreads, 0, stream>>>(masked0, unordered, n, kc,
                                                    cand);
  }
}

__global__ void k2_rank(const float* __restrict__ masked0,
                        const int32_t* __restrict__ unordered, int n, int kc,
                        int32_t* __restrict__ cand) {
  __shared__ uint64_t tile[kRankThreads];
  const int t = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* m = masked0 + static_cast<int64_t>(t) * n;
  const int32_t* sel = unordered + static_cast<int64_t>(t) * kc;
  uint64_t mine = ~0ull;
  int row = 0;
  if (i < kc) {
    row = sel[i];
    mine = desc_score_key(m[row], static_cast<uint32_t>(row));
  }
  int rank = 0;
  for (int base = 0; base < kc; base += kRankThreads) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] =
        j < kc ? desc_score_key(m[sel[j]], static_cast<uint32_t>(sel[j])) : ~0ull;
    __syncthreads();
    const int lim = min(kRankThreads, kc - base);
    for (int q = 0; q < lim; ++q) rank += tile[q] < mine;
    __syncthreads();
  }
  if (i < kc) cand[static_cast<int64_t>(t) * kc + rank] = row;
}

}  // namespace
