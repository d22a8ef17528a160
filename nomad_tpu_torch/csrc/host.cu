// Host-side entries of the kernel library: no TPU kernel behind them.
//
// nomad_host_device_ptr asks CUDA for the device address of pinned host
// memory. K4b reads its refresh block, and K5 writes its outputs, through
// that address (zero-copy over PCIe), so no copy and no stream sync sits
// between the host and those kernels. The address is never assumed to
// equal the host pointer: with unified addressing it does, but CUDA is
// the one to say so, and memory it has not mapped is an error.
//
// nomad_empty launches a kernel that does nothing: the launch floor a
// measurement holds a small kernel's time against.

#include <cuda_runtime.h>

namespace {

__global__ void k_empty() {}

}  // namespace

// Returns the cudaError_t of cudaHostGetDevicePointer; *dev is null unless
// it succeeded. A failure is cleared from the thread's last error, so the
// next launch check does not report it as its own.
extern "C" int nomad_host_device_ptr(void* host, void** dev) {
  *dev = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(dev, host, 0);
  if (err != cudaSuccess) {
    *dev = nullptr;
    cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" int nomad_empty(cudaStream_t stream) {
  k_empty<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
