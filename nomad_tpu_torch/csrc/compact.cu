// K5: a window's placement results compacted to what the host build reads.
//
// Replaces nomad_tpu/scheduler/kernels.py:204-224 (compact_window, the
// jitted reduction of packed3 [E, P, 3] = (chosen row, score, n_feasible)
// before the device->host copy):
//   chosen[e, p]  = (int32) packed3[e, p, 0], truncated toward zero as
//                   XLA's f32->s32 convert is (row -1.0 becomes -1);
//   scores[e, p]  = packed3[e, p, 1], copied bit for bit;
//   nf_last[e]    = (int32) packed3[e, last_idx[e], 2];
//   ok[e]         = every placement found a row or is padding
//                   (all_p(chosen >= 0 || !valid)).
// last_idx must lie in [0, P); it is clamped there so a bad index cannot
// read outside the eval's rows.
//
// The served worker hands the four outputs as parts of one pinned host
// block, mapped for the device: the kernel's stores cross PCIe and no
// device->host copy follows. So the stores must be whole lines: a block
// takes epb = max(1, kTile / P) consecutive evals, whose chosen and scores
// rows are one contiguous run of epb * P words each, written by
// consecutive threads (128-byte lines when P divides kTile), and the
// block's nf_last and ok entries are written by its first threads side by
// side after one __syncthreads. A flag per eval in shared memory collects
// the ok reduction. kTile is one placement a thread: the kernel's time is
// the latency of its loads and stores, and more placements a thread
// lengthen that chain (four a thread took 0.0033 ms on the device at E =
// 64, P = 64, one a thread 0.0018, both into device memory on an H100).
// Bound: bytes, over PCIe. At the storm's shape (E = 64, P = 64) it reads
// 53 KB from device memory and writes 33 KB to the host, 0.5 us at PCIe
// Gen5's 64 GB/s each way; the launch dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;   // placements a block covers (at least
                                  // one eval)

__global__ void k5_compact(const float* __restrict__ packed3,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ last_idx, int e, int p,
                           int epb, int32_t* __restrict__ chosen,
                           float* __restrict__ scores,
                           int32_t* __restrict__ nf_last,
                           uint8_t* __restrict__ ok) {
  __shared__ int bad[kTile];
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, e - e0);
  for (int i = threadIdx.x; i < ne; i += blockDim.x) bad[i] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(e0) * p;
  const int64_t count = static_cast<int64_t>(ne) * p;
  for (int64_t j = threadIdx.x; j < count; j += blockDim.x) {
    const float* src = packed3 + (base + j) * 3;
    const int32_t c = __float2int_rz(src[0]);
    chosen[base + j] = c;
    scores[base + j] = src[1];
    if (c < 0 && valid[base + j]) bad[j / p] = 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ne; i += blockDim.x) {
    const int ev = e0 + i;
    int li = last_idx[ev];
    li = li < 0 ? 0 : (li >= p ? p - 1 : li);
    nf_last[ev] = __float2int_rz(
        packed3[(static_cast<int64_t>(ev) * p + li) * 3 + 2]);
    ok[ev] = bad[i] ? 0 : 1;
  }
}

}  // namespace

// Returns cudaGetLastError(). Inputs are contiguous device arrays:
// packed3 [e, p, 3] f32, valid [e, p] bytes, last_idx [e] int32. Outputs
// are device addresses (device memory, or pinned host memory mapped for the
// device): chosen [e, p] int32, scores [e, p] f32, nf_last [e] int32,
// ok [e] bytes.
extern "C" int nomad_compact_window(const float* packed3, const uint8_t* valid,
                                    const int32_t* last_idx, int e, int p,
                                    int32_t* chosen, float* scores,
                                    int32_t* nf_last, uint8_t* ok,
                                    cudaStream_t stream) {
  if (e > 0 && p > 0) {
    const int epb = p >= kTile ? 1 : kTile / p;
    k5_compact<<<(e + epb - 1) / epb, kThreads, 0, stream>>>(
        packed3, valid, last_idx, e, p, epb, chosen, scores, nf_last, ok);
  }
  return static_cast<int>(cudaGetLastError());
}
