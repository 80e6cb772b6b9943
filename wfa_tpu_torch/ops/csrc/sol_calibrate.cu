// Speed-of-light calibration kernels for Hopper (sm_90a): the three
// primitive costs the wavefront kernels K1-K4 are built from, each on
// [G, 8, 128] int32 tiles, one block per tile.  G = 1 is the TPU function;
// G > 1 runs independent tiles, so a launch with the card full of blocks
// measures throughput where G = 1 measures latency.
//
// vpu_ops_kernel replaces benchmarks/sol_calibrate.py::bench_vpu_ops: per
// element, `iters` x 16 reps of the dependent chain
//     v = v * 1103515245 + 12345; v ^= v >>> 5; v += v << 3;
//     v = max(v, v ^ 255)
// (8 source ops a rep, wrapping mod 2^32, >>> a logical shift, max signed).
// One thread per element (1024 threads); the 16 reps are unrolled and
// `iters` is a runtime argument, so the compiler folds nothing.  Bound by
// operations: at G = 1 it reads the dependent-op latency, with the card full
// the int32 issue rate.  nvcc fuses the multiply-add and v + (v << 3) into
// one instruction each, so a rep is fewer instructions than source ops
// (tools/torch_sol_calibrate.py counts them in the SASS).
//
// gather_chain_kernel replaces sol_calibrate.py::bench_gather: `iters` x 16
// reps of v = take_along_axis(v, idx0 ^ (v & 127), axis=1), each row of 128
// lanes gathering from itself.  A row spans 4 warps, so __shfl_sync cannot
// serve it: the tile sits in shared memory in two ping-pong buffers, idx0 in
// a register, and each step is a store, one __syncthreads and a dependent
// shared load; an idx0 outside 0..127 counts by its low 7 bits, so no read
// leaves the row.  Two buffers make one barrier a step enough: a thread
// writes a buffer again only after every thread has passed the next step's
// barrier, so after its last read of it.  Bound by operations; it reads the
// latency of the shared-memory round trip plus the barrier.
//
// scalar_sync_kernel replaces sol_calibrate.py::bench_scalar_sync: `iters`
// times m = max over the tile's 1024 values (signed), then every value + 1
// if m > 0, else - 1 (wrapping).  A block-wide max is a warp reduction
// (__reduce_max_sync), partials in shared memory, one warp reducing them and
// the result broadcast through shared memory: two __syncthreads an
// iteration.  The block has 1024 threads (one value each) or 512 threads
// (two each); the second is the termination test K1-K4 pay at every score
// (wfa_distance.cu's block is 512 threads).  Bound by operations.
//
// Their plain versions are wfa_tpu_torch/ops/sol_calibrate.py::*_plain.
// Build: as wfa_distance.cu (wfa_tpu_torch/ops/_build.py).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wfa_common.cuh"

namespace {

constexpr int kTile = 8 * 128;   // values in a tile
constexpr int kRow = 128;        // lanes of a row
constexpr int kInner = 16;       // reps in one iteration, as INNER on the TPU

__global__ void __launch_bounds__(kTile)
vpu_ops_kernel(const int* __restrict__ x, int* __restrict__ out, int iters) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  uint32_t v = static_cast<uint32_t>(x[i]);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kInner; ++r) {
      v = v * 1103515245u + 12345u;
      v ^= v >> 5;
      v += v << 3;
      const int s = static_cast<int>(v);
      v = static_cast<uint32_t>(max(s, s ^ 255));
    }
  }
  out[i] = static_cast<int>(v);
}

__global__ void __launch_bounds__(kTile)
gather_chain_kernel(const int* __restrict__ x, const int* __restrict__ idx0,
                    int* __restrict__ out, int iters) {
  __shared__ int buf[2][kTile];
  const int t = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + t;
  const int row = t & ~(kRow - 1);
  const int base = idx0[i] & (kRow - 1);   // 0..127 for a valid idx0
  int v = x[i];
  int p = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kInner; ++r) {
      buf[p][t] = v;
      __syncthreads();
      v = buf[p][row + (base ^ (v & (kRow - 1)))];
      p ^= 1;
    }
  }
  out[i] = v;
}

template <int kPer>
__global__ void __launch_bounds__(kTile / kPer)
scalar_sync_kernel(const int* __restrict__ x, int* __restrict__ out, int iters) {
  constexpr int kThreads = kTile / kPer;
  constexpr int kWarps = kThreads / 32;
  __shared__ int partial[kWarps];
  __shared__ int tile_max;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = x[base + j * kThreads + t];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    int m = v[0];
#pragma unroll
    for (int j = 1; j < kPer; ++j) m = max(m, v[j]);
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if ((t & 31) == 0) partial[t >> 5] = m;
    __syncthreads();
    if (t < 32) {
      int w = t < kWarps ? partial[t] : INT_MIN;
      w = __reduce_max_sync(0xFFFFFFFFu, w);
      if (t == 0) tile_max = w;
    }
    __syncthreads();
    const uint32_t step = tile_max > 0 ? 1u : 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = static_cast<int>(static_cast<uint32_t>(v[j]) + step);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[base + j * kThreads + t] = v[j];
}

}  // namespace

extern "C" {

// Each entry point runs one kernel on `stream` over G tiles of [8, 128]
// int32 (x, idx0 in; out out; all contiguous) and returns a cudaError_t
// (0 = ok).  iters >= 0.
int vpu_ops_launch(const void* x, void* out, int G, int iters, int device,
                   void* stream) {
  if (G < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  vpu_ops_kernel<<<G, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

int gather_chain_launch(const void* x, const void* idx0, void* out, int G,
                        int iters, int device, void* stream) {
  if (G < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_chain_kernel<<<G, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(idx0),
      static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

// threads: 1024 (one value each) or 512 (two each).
int scalar_sync_launch(const void* x, void* out, int G, int iters, int threads,
                       int device, void* stream) {
  if (G < 0 || iters < 0 || (threads != kTile && threads != kTile / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int*>(x);
  auto* o = static_cast<int*>(out);
  if (threads == kTile) {
    scalar_sync_kernel<1><<<G, threads, 0, s>>>(xi, o, iters);
  } else {
    scalar_sync_kernel<2><<<G, threads, 0, s>>>(xi, o, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` threads of kernel `which` (0 vpu_ops, 1 gather_chain,
// 2 scalar_sync) that one SM holds at once, into *blocks.
int sol_blocks_per_sm(int which, int threads, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (which) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, vpu_ops_kernel,
                                                          threads, 0);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gather_chain_kernel, threads, 0);
      break;
    case 2:
      err = threads == kTile
                ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, scalar_sync_kernel<1>, threads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, scalar_sync_kernel<2>, threads, 0);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
