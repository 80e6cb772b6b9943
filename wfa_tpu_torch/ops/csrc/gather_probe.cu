// Wide-gather probe for Hopper (sm_90a): out[r, j] = tab[r, idx[r, j]] for
// a table of 128 int32 per row and W indices per row.
//
// Replaces tools/dev_gather_probe.py::k_wide, which asks whether a
// take_along_axis from one [8, 128] table vreg over [8, 2048] indices lowers
// on the TPU, and at what cost.  Here a 2-D grid covers rows x chunks of
// kChunk columns: each block stages its row's 512-byte table in shared
// memory, then streams the indices in and the results out 16 bytes (int4) a
// thread a load, each thread keeping kVec loads in flight.  An index outside
// 0..127 counts by its low 7 bits, so no read leaves the row's table (the
// plain version, torch.gather, raises on it instead).
//
// What bounds it on this card: bytes (the indices read and the results
// written once, 8 bytes per element, against one shared-memory read).  At
// the TPU's [8, 2048] it is one small launch and its time is the launch's.
// The plain version is wfa_tpu_torch/ops/gather_probe.py::k_wide_plain.
//
// Build: as wfa_distance.cu (wfa_tpu_torch/ops/_build.py).
#include <cstdint>

#include <cuda_runtime.h>

#include "wfa_common.cuh"

namespace {

constexpr int kTab = 128;                 // table entries per row
constexpr int kThreads = 128;
constexpr int kVec = 4;                   // int4 loads a thread keeps in flight
constexpr int kChunk = kThreads * kVec * 4;   // columns per block

__global__ void __launch_bounds__(kThreads)
k_wide_kernel(const int* __restrict__ tab, const int4* __restrict__ idx,
              int4* __restrict__ out, int W) {
  __shared__ int row_tab[kTab];
  const int r = blockIdx.y;
  row_tab[threadIdx.x] = tab[static_cast<size_t>(r) * kTab + threadIdx.x];
  __syncthreads();
  const int w4 = W / 4;
  const size_t row = static_cast<size_t>(r) * w4;
  const int first = blockIdx.x * (kChunk / 4) + threadIdx.x;
  int4 in[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = first + k * kThreads;
    if (c < w4) in[k] = idx[row + c];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = first + k * kThreads;
    if (c < w4) {
      out[row + c] = make_int4(row_tab[in[k].x & (kTab - 1)],
                               row_tab[in[k].y & (kTab - 1)],
                               row_tab[in[k].z & (kTab - 1)],
                               row_tab[in[k].w & (kTab - 1)]);
    }
  }
}

}  // namespace

extern "C" {

// The probe on `stream`: tab [R, 128] int32, idx [R, W] int32 in 0..127,
// out [R, W] int32 (16-byte aligned, contiguous); returns a cudaError_t
// (0 = ok).  W a multiple of 4; R at most 65535 (the grid's y extent).
int k_wide_launch(const void* tab, const void* idx, void* out, int R, int W,
                  int device, void* stream) {
  if (R < 0 || R > 65535 || W < 0 || W % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0 || W == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kChunk - 1) / kChunk, R);
  k_wide_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int4*>(idx),
      static_cast<int4*>(out), W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
