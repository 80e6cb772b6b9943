// Ring-row traffic probe for Hopper (sm_90a): K4's access pattern without
// its arithmetic.
//
// Replaces tools/dev_dma_bw.py::kernel, which measures the TPU's HBM <-> VMEM
// copy rate for a wavefront ring's rows: per step 4 rows in and 3 rows out,
// each written row the row read + 1.  Here the rows are K4's: one block per
// slab ring[b] of R rows x W int32 (R = 3A), and the step is the TPU
// kernel's with its output aliased onto its input, as K4's ring is one
// buffer: at step i, with row = i % (R - 5), read rows row .. row + 3 and
// write rows row .. row + 2 as the values read + 1.  acc[b] is the sum
// (mod 2^32) of every value the block read, so no read can be elided.  One
// block barrier per step, as K4 pays one per score.  Its plain version is
// wfa_tpu_torch/ops/ring_bw.py::ring_bw_plain.
//
// What bounds it on this card: bytes.  Each step moves 28 W bytes per
// block; a launch whose slabs fit the 50 MB L2 runs at L2's rate, a wider
// one at HBM's.  tools/torch_ring_bw.py takes the rate from the difference
// of two step counts, as the TPU tool does.
//
// Build: as wfa_distance.cu (wfa_tpu_torch/ops/_build.py).
#include <cstdint>

#include <cuda_runtime.h>

#include "wfa_common.cuh"

namespace {

constexpr int kReads = 4;
constexpr int kWrites = 3;
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
ring_bw_kernel(int* ring, int R, int W, int steps, int* __restrict__ acc) {
  __shared__ uint32_t partial[kMaxThreads / 32];
  const int tid = threadIdx.x;
  const int span = R - kReads - 1;
  // Plain loads and stores: the slab is read and written in this launch.
  int* slab = ring + static_cast<size_t>(blockIdx.x) * R * W;
  uint32_t sum = 0;
  for (int i = 0; i < steps; ++i) {
    int* rows = slab + static_cast<size_t>(i % span) * W;
    for (int j = tid; j < W; j += blockDim.x) {
      int v[kReads];
#pragma unroll
      for (int c = 0; c < kReads; ++c) {
        v[c] = rows[c * W + j];
        sum += static_cast<uint32_t>(v[c]);
      }
#pragma unroll
      for (int c = 0; c < kWrites; ++c) rows[c * W + j] = v[c] + 1;
    }
    __syncthreads();
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
  if ((tid & 31) == 0) partial[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    uint32_t total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += partial[w];
    acc[blockIdx.x] = static_cast<int>(total);
  }
}

}  // namespace

extern "C" {

// The probe on `stream`: ring [B, R, W] int32 (updated in place), acc [B]
// int32 out; returns a cudaError_t (0 = ok).  R > 5, W a multiple of 32.
int ring_bw_launch(void* ring, int B, int R, int W, int steps, void* acc,
                   int device, void* stream) {
  if (B == 0) return 0;
  if (R <= kReads + 1 || W <= 0 || W % 32 != 0 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = W < kMaxThreads ? W : kMaxThreads;
  ring_bw_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ring), R, W, steps, static_cast<int*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
