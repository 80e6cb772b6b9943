// K3: the backward walk over K2's choice table, for Hopper (sm_90a).
//
// Replaces wfa_tpu/ops/traceback_pallas.py::_traceback_kernel (launched by
// traceback_batch_device_impl and fused after the alignment kernel by
// align_cigar_fused_impl).  Its plain version is
// wfa_tpu_torch/ops/traceback_torch.py::traceback_batch_device; the two give
// the same op streams and op counts.
//
// Each finished alignment of nonzero distance walks from (M, distance,
// tlen - plen) back to the origin.  At score d on diagonal k it reads the
// 4-bit choice at nibble d & 7 of choice[d >> 3, b, k - lo(d)], with
// lo(d) = lo_trace[b, d] in banded mode and -W/2 in exact mode, and appends
// one 2-bit op (SUB in M, INS in I, DEL in D) to a backward op stream of 16
// ops per int32 word.  It writes the fused row the host reads in one copy:
// out[b] = (distance, finished, n_ops, 0, ops[0 .. opw)).  n_ops is -1 for a
// corrupt walk (a diagonal outside [0, W), an op stream past opw * 16 ops,
// or a walk that does not end at d == 0, k == 0 in M), which sends the pair
// to the CPU, and 0 where there is no walk (unfinished, or distance 0).
//
// Design: one thread per alignment, reading one choice word per step from
// global memory.  The walk visits rows in falling score order, starting at
// the rows K2 stored last, so most reads should hit L2.
//
// What bounds it on this card: the latency of one dependent global load per
// step (the next diagonal and score depend on the choice just read), not
// bytes or operations: a walk of n steps costs n load latencies.  The
// simple design does nothing about it; a warp per alignment with the rows
// staged in shared memory is later work.
//
// Build: as wfa_distance.cu (wfa_tpu_torch/ops/_build.py).
#include <cstdint>

#include <cuda_runtime.h>

#include "wfa_common.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
wfa_traceback_kernel(const int* __restrict__ choice, int num_chunks,
                     const int* __restrict__ lo_trace, int lo_stride,
                     const int* __restrict__ dist,
                     const unsigned char* __restrict__ fin,
                     const int* __restrict__ target_k, int B, int W, int x,
                     int o, int e, int opw, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int* row = out + static_cast<size_t>(b) * (4 + opw);
  int* ops = row + 4;
  const int distance = dist[b];
  const bool finished = fin[b] != 0;
  const bool walk = finished && distance > 0;

  int d = walk ? distance : 0;
  int k = target_k[b];
  int mat = 0;  // 0 = M, 1 = I, 2 = D
  int p = 0;    // ops emitted
  uint32_t acc = 0;
  bool err = false;
  const int max_ops = opw * wfa::kOpsPerWord;
  while (d > 0) {
    const int lo = lo_trace != nullptr
                       ? lo_trace[static_cast<size_t>(b) * lo_stride + d]
                       : -(W / 2);
    const int j = k - lo;
    const int r = d >> 3;
    if (j < 0 || j >= W || r >= num_chunks) {
      err = true;
      break;
    }
    const uint32_t word = static_cast<uint32_t>(
        choice[(static_cast<size_t>(r) * B + b) * W + j]);
    const int ch = (word >> (4 * (d & 7))) & 0xF;
    int op;
    if (mat == 0) {
      op = wfa::kOpSub;
      const int from = ch & 3;
      if (from == wfa::kMFromX) {
        d -= x;
      } else {
        mat = from == wfa::kMFromI ? 1 : 2;
      }
    } else if (mat == 1) {
      op = wfa::kOpIns;
      if (ch & wfa::kIExtBit) {
        d -= e;
      } else {
        mat = 0;
        d -= o + e;
      }
      --k;
    } else {
      op = wfa::kOpDel;
      if (ch & wfa::kDExtBit) {
        d -= e;
      } else {
        mat = 0;
        d -= o + e;
      }
      ++k;
    }
    acc |= static_cast<uint32_t>(op) << (2 * (p & 15));
    if ((p & 15) == 15) {
      ops[p >> 4] = static_cast<int>(acc);
      acc = 0;
    }
    ++p;
    if (p >= max_ops) {
      err = true;
      break;
    }
  }
  // The partial last word, then zeros to the end of the row.
  int w = p >> 4;
  if ((p & 15) != 0) ops[w++] = static_cast<int>(acc);
  for (; w < opw; ++w) ops[w] = 0;

  const bool ok = !err && d == 0 && k == 0 && mat == 0;
  row[0] = distance;
  row[1] = finished ? 1 : 0;
  row[2] = walk ? (ok ? p : -1) : 0;
  row[3] = 0;
}

}  // namespace

extern "C" {

// K3 on `stream` over B alignments; returns a cudaError_t (0 = ok).
// choice: [num_chunks, B, W] int32 (K2's table); lo_trace: [B, lo_stride]
// int32 by score, or null in exact mode; dist/target_k: [B] int32;
// fin: [B] bool; out: [B, 4 + opw] int32.
int wfa_traceback_launch(const void* choice, int num_chunks,
                         const void* lo_trace, int lo_stride, const void* dist,
                         const void* fin, const void* target_k, int B, int W,
                         int x, int o, int e, int opw, void* out, int device,
                         void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kThreads - 1) / kThreads;
  wfa_traceback_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(choice), num_chunks,
      static_cast<const int*>(lo_trace), lo_stride,
      static_cast<const int*>(dist), static_cast<const unsigned char*>(fin),
      static_cast<const int*>(target_k), B, W, x, o, e, opw,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
