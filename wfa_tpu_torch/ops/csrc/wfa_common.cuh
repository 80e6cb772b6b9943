// Definitions shared by the port's CUDA sources (wfa_distance.cu: K1, K2
// and K4; wfa_traceback.cu: K3; the probes and calibration kernels use only
// the error string).  Each source is built into a shared library of its own
// (wfa_tpu_torch/ops/_build.py), so each carries its own copy of the C entry
// point below.
#pragma once

#include <cuda_runtime.h>

namespace wfa {

constexpr int kNull = -32000;  // wfa_tpu_torch.types.OFFSET_NULL

// 2-bit ops of the backward op stream (wfa_tpu_torch.types.AffineOp).
constexpr int kOpIns = 1;
constexpr int kOpSub = 2;
constexpr int kOpDel = 3;

// 4-bit backtrace choice of one (score, diagonal): bits 0-1 give M's source,
// bit 2 says I came from gap-extend, bit 3 the same for D
// (wfa_tpu_torch.traceback.M_FROM_*).
constexpr int kMFromX = 0;
constexpr int kMFromI = 1;
constexpr int kMFromD = 2;
constexpr int kIExtBit = 4;
constexpr int kDExtBit = 8;

constexpr int kScoresPerWord = 8;   // 4-bit choices per int32 table word
constexpr int kOpsPerWord = 16;     // 2-bit ops per int32 stream word

}  // namespace wfa

extern "C" const char* wfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
