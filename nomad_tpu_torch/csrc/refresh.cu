// K4b: the node table's dirty-row refresh on the device.
//
// Replaces nomad_tpu/tensor/node_table.py:754-776 (_scatter_refresh, the
// jitted split of one packed [k, 1 + R + 2 + R] block into rows, capacity,
// score_cap and usage, then three row scatter-SETs).
//
// The block usually lies in pinned host memory (the node table's staging
// ring) and is read in place over PCIe through its mapped device address:
// no upload and no stream sync precede the launch. A thread per packed row
// reading its 2R + 3 floats at a (2R + 3)-float stride would send every
// float over PCIe as its own request, so a block first loads a tile of
// kTileRows rows as contiguous 16-byte words into shared memory (a tile of
// 128 rows starts on a 16-byte boundary for any R), then its threads take
// one (row, column) each and scatter the three column groups into
// capacity, score_cap and usage in device memory. Rows outside [0, n) drop,
// as the reference's scatter drops rows past the table. Chunks pad their
// tail by repeating a row with identical values, so duplicate writes are
// benign.
// Bound: bytes, and over PCIe rather than HBM. At the storm's 128-row chunk
// (R = 5) it reads 6,656 bytes from the host (0.10 us at PCIe Gen5's 64 GB/s
// each way) and writes 6,144 bytes to HBM; a read from host memory costs a
// PCIe round trip of a microsecond or so, once per tile, since every load
// of a tile is in flight together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;   // a multiple of 4: tiles stay 16-byte aligned

__global__ void k4b_refresh(const float* __restrict__ packed, int k, int n,
                            int r_dims, float* __restrict__ capacity,
                            float* __restrict__ score_cap,
                            float* __restrict__ usage) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  const int width = 2 * r_dims + 3;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t left = k - row0;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;
  const float* src = packed + row0 * width;
  const int n_floats = rows * width;
  const int n_vec = n_floats / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) tile4[i] = src4[i];
  for (int i = 4 * n_vec + threadIdx.x; i < n_floats; i += blockDim.x)
    tile[i] = src[i];
  __syncthreads();
  // Column c of a row: capacity for c < R, score_cap for c < R + 2, usage
  // after; its value sits at p[1 + c] in the packed row.
  const int cols = 2 * r_dims + 2;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    const float* p = tile + r * width;
    const int row = __float2int_rz(p[0]);
    if (row < 0 || row >= n) continue;
    const float v = p[1 + c];
    if (c < r_dims)
      capacity[static_cast<int64_t>(row) * r_dims + c] = v;
    else if (c < r_dims + 2)
      score_cap[2 * static_cast<int64_t>(row) + (c - r_dims)] = v;
    else
      usage[static_cast<int64_t>(row) * r_dims + (c - r_dims - 2)] = v;
  }
}

}  // namespace

// packed: the device address of k packed rows (device memory, or pinned
// host memory mapped for the device), 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a misaligned block or a
// row too wide for the tile's 48 KB of shared memory.
extern "C" int nomad_scatter_refresh(const float* packed, int k, int n,
                                     int r_dims, float* capacity,
                                     float* score_cap, float* usage,
                                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * kTileRows * (2 * r_dims + 3);
  if (reinterpret_cast<uintptr_t>(packed) % 16 != 0 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0)
    k4b_refresh<<<(k + kTileRows - 1) / kTileRows, kThreads, smem, stream>>>(
        packed, k, n, r_dims, capacity, score_cap, usage);
  return static_cast<int>(cudaGetLastError());
}
