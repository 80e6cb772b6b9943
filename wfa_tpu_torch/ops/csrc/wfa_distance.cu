// K1: batched gap-affine WFA, distance mode, for Hopper (sm_90a).
//
// Replaces wfa_tpu/ops/engine_pallas.py::_wfa_kernel with
// compute_cigar=False and ring_hbm=False (exact and adaptive-band windows).
// Its plain version is wfa_tpu_torch/ops/engine_torch.py::align_batch_device;
// the two agree in every lane, including the score reported by lanes that
// run out of steps.
//
// Design: one thread block per alignment, diagonals across threads (thread t
// owns diagonals t, t + blockDim.x, ...).  The [3A, W] M/I/D ring and the
// per-slot window base/extent live in dynamic shared memory; the packed
// sequences are read from global memory (L2).  The control flow comes from
// the host schedule (wfa_tpu.schedule.build_schedule: score, out slot and
// the three parent slots, -1 for a missing parent), so the kernel has no
// existence bitmasks and no working-set limit other than shared memory.
// Each score costs one block barrier (two on re-centre steps); a block
// stops as soon as its alignment is done.
//
// What bounds it on this card: the LCP extension of the one on-path
// diagonal is serial and divergent (its warp loops while the other 31 lanes
// idle), and every score pays a block-wide barrier.  Making it fast (a
// warp-cooperative extension, several alignments per block) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (wfa_tpu_torch/ops/_build.py).  Plain C entry
// points, bound with ctypes.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNull = -32000;     // wfa_tpu.types.OFFSET_NULL
constexpr int kBig = 1 << 20;     // window bound standing in for a missing parent
constexpr int kMaxThreads = 512;
constexpr int kScratchInts = 66;  // argmin partials (2 per warp, <= 32 warps) + 2

// Shared-memory bytes for one block; wfa_tpu_torch.ops.engine_cuda.smem_bytes
// holds the same formula.
__host__ __device__ inline size_t smem_bytes(int A, int W) {
  return sizeof(int) * (3 * static_cast<size_t>(A) * W + 2 * A + kScratchInts);
}

// Word idx of a packed row; words past the row read as zero (the plain
// version pads one zero word and clamps to it).
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int nw, int idx) {
  return idx < nw ? __ldg(row + idx) : 0u;
}

// The 16 bases starting at base pos (>= 0) as one u32, first base in the
// high bits.  No shift by 32: phase 0 never reads the second word.
__device__ __forceinline__ uint32_t load16(const uint32_t* row, int nw, int pos) {
  const int idx = pos >> 4;
  const int sh = 2 * (pos & 15);
  const uint32_t hi = word_at(row, nw, idx) << sh;
  if (sh == 0) return hi;
  return hi | (word_at(row, nw, idx + 1) >> (32 - sh));
}

// Bits past the sequence end count as mismatches; a shift of 32 is 0.
__device__ __forceinline__ uint32_t tail_mask(int nxt, int limit) {
  const int sh = min(2 * max(nxt - limit, 0), 32);
  return sh == 32 ? 0u : (0xFFFFFFFFu << sh);
}

// LCP extension of offset off on diagonal k (engine_torch._extend).
__device__ int extend(int off, int k, const uint32_t* pat, const uint32_t* txt,
                      int nw, int plen, int tlen) {
  int v = off - k;
  int h = off;
  if (off < 0 || v > plen || h > tlen) return kNull;
  int acc = 0;
  bool active = v < plen && h < tlen;
  while (active) {
    const int vc = min(max(v, 0), plen);
    const int hc = min(max(h, 0), tlen);
    uint32_t diff = load16(pat, nw, vc) ^ load16(txt, nw, hc);
    diff |= ~tail_mask(vc + 16, plen) | ~tail_mask(hc + 16, tlen);
    const int eq = __clz(static_cast<int>(diff)) >> 1;  // __clz(0) == 32 -> 16
    acc += eq;
    v += eq;
    h += eq;
    active = eq == 16 && v < plen && h < tlen;
  }
  return off + acc;
}

// (offset, op) packed so that max() picks the larger offset, ties by op.
// A multiply, not a shift: shifting a negative int left is undefined.
__device__ __forceinline__ int pack(int off, int op) { return off * 4 + op; }

// Parent window read at a shifted position; outside [0, ext] reads NULL.
__device__ __forceinline__ int window_read(const int* row, int rel, int ext) {
  return (rel < 0 || rel > ext) ? kNull : row[rel];
}

// Lexicographic min of (value, index): the first index wins a tie.
__device__ __forceinline__ void argmin_merge(int& v, int& j, int ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

template <bool kBanded>
__global__ void __launch_bounds__(kMaxThreads)
wfa_distance_kernel(const uint32_t* __restrict__ pat,
                    const uint32_t* __restrict__ txt, int nw,
                    const int* __restrict__ plen_arr,
                    const int* __restrict__ tlen_arr,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ sched, int num_steps,
                    int unfinished_score, int A, int W, int band,
                    int* __restrict__ dist_out,
                    unsigned char* __restrict__ fin_out) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // Invalid lanes (N bases, oversized) report distance 0, unfinished.
  if (!valid[b]) {
    if (tid == 0) {
      dist_out[b] = 0;
      fin_out[b] = 0;
    }
    return;
  }

  const uint32_t* P = pat + static_cast<size_t>(b) * nw;
  const uint32_t* T = txt + static_cast<size_t>(b) * nw;
  const int plen = plen_arr[b];
  const int tlen = tlen_arr[b];
  const int target_k = tlen - plen;
  const int target_off = tlen;
  const int W2 = W / 2;

  int* M = smem;
  int* I = M + A * W;
  int* D = I + A * W;
  int* win_lo = D + A * W;
  int* win_ext = win_lo + A;
  int* scratch = win_ext + A;

  for (int i = tid; i < 3 * A * W; i += nthreads) smem[i] = kNull;
  for (int a = tid; a < A; a += nthreads) {
    win_lo[a] = 0;
    win_ext[a] = 0;
  }
  __syncthreads();

  // Score 0: extension of diagonal 0, at window index 0 (banded) or W/2.
  if (tid == 0) {
    const int init = extend(0, 0, P, T, nw, plen, tlen);
    M[kBanded ? 0 : W2] = init;
    scratch[0] = init;
  }
  __syncthreads();
  if (target_k == 0 && scratch[0] == target_off) {
    if (tid == 0) {
      dist_out[b] = 0;
      fin_out[b] = 1;
    }
    return;
  }

  for (int s = 0; s < num_steps; ++s) {
    const int* row = sched + 5 * s;
    const int d = row[0];
    const int oslot = row[1];
    const int sx = row[2];
    const int soe = row[3];
    const int se = row[4];

    int lo_n = -W2;
    int ext_n = W - 1;
    if (kBanded) {
      // Grow from the parents' windows, clamp to W shrinking hi first.
      const int hi_x = sx < 0 ? -kBig : win_lo[sx] + win_ext[sx];
      const int lo_x = sx < 0 ? kBig : win_lo[sx];
      const int hi_oe = soe < 0 ? -kBig : win_lo[soe] + win_ext[soe];
      const int lo_oe = soe < 0 ? kBig : win_lo[soe];
      const int hi_e = se < 0 ? -kBig : win_lo[se] + win_ext[se];
      const int lo_e = se < 0 ? kBig : win_lo[se];
      int hi_n = max(hi_x, max(hi_oe, hi_e) + 1);
      lo_n = min(lo_x, min(lo_oe, lo_e) - 1);
      const int t = max((hi_n - lo_n) - (W - 1), 0);
      hi_n -= (t + 1) / 2;
      lo_n += t / 2;

      // Re-centre every `band` scores on MDI steps once the M[d-x] window
      // is at full width: on the first diagonal of least distance to the
      // target, unless the sentinel 2*(plen+tlen) is no worse.  The
      // condition is uniform across the block.
      if (d % band == 0 && sx >= 0 && (soe >= 0 || se >= 0) &&
          win_ext[sx] >= W - 1) {
        const int lox = win_lo[sx];
        const int extx = win_ext[sx];
        const int* mx = M + sx * W;
        int best = INT_MAX;
        int best_j = INT_MAX;
        for (int j = tid; j < extx; j += nthreads) {
          const int m = mx[j];
          if (m >= 0) {
            argmin_merge(best, best_j, max(plen - (m - (lox + j)), tlen - m), j);
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const int ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
          const int oj = __shfl_down_sync(0xFFFFFFFFu, best_j, off);
          argmin_merge(best, best_j, ov, oj);
        }
        const int warp = tid >> 5;
        if ((tid & 31) == 0) {
          scratch[2 + 2 * warp] = best;
          scratch[3 + 2 * warp] = best_j;
        }
        __syncthreads();
        best = INT_MAX;
        best_j = INT_MAX;
        for (int w = 0; w < (nthreads >> 5); ++w) {
          argmin_merge(best, best_j, scratch[2 + 2 * w], scratch[3 + 2 * w]);
        }
        const int center = best < 2 * (tlen + plen) ? lox + best_j : lox;
        lo_n = center - W2;
        hi_n = lo_n + W - 1;
      }
      ext_n = hi_n - lo_n;
    }

    int* Mo = M + oslot * W;
    int* Io = I + oslot * W;
    int* Do = D + oslot * W;
    for (int j = tid; j < W; j += nthreads) {
      if (kBanded && j > ext_n) {
        Mo[j] = kNull;
        Io[j] = kNull;
        Do[j] = kNull;
        continue;
      }
      int i_open, i_ext, d_open, d_ext, x_off, k;
      if (kBanded) {
        // Child lane j is diagonal lo_n + j; each parent is read at its
        // own window base.
        const int r_oe = soe < 0 ? 0 : lo_n - win_lo[soe] + j;
        const int r_e = se < 0 ? 0 : lo_n - win_lo[se] + j;
        const int r_x = sx < 0 ? 0 : lo_n - win_lo[sx] + j;
        i_open = soe < 0 ? kNull : window_read(M + soe * W, r_oe - 1, win_ext[soe]);
        d_open = soe < 0 ? kNull : window_read(M + soe * W, r_oe + 1, win_ext[soe]);
        i_ext = se < 0 ? kNull : window_read(I + se * W, r_e - 1, win_ext[se]);
        d_ext = se < 0 ? kNull : window_read(D + se * W, r_e + 1, win_ext[se]);
        x_off = sx < 0 ? kNull : window_read(M + sx * W, r_x, win_ext[sx]);
        k = lo_n + j;
      } else {
        i_open = (soe < 0 || j == 0) ? kNull : M[soe * W + j - 1];
        d_open = (soe < 0 || j == W - 1) ? kNull : M[soe * W + j + 1];
        i_ext = (se < 0 || j == 0) ? kNull : I[se * W + j - 1];
        d_ext = (se < 0 || j == W - 1) ? kNull : D[se * W + j + 1];
        x_off = sx < 0 ? kNull : M[sx * W + j];
        k = j - W2;
      }
      // Recurrence with the reference's tie-break: gap-extend (2) beats
      // gap-open (1); for M, DEL (3) beats SUB (2) beats INS (1).  The
      // >> 2 unpack is an arithmetic shift.
      const int i_new = max(pack(i_open + 1, 1), pack(i_ext + 1, 2)) >> 2;
      const int d_new = max(pack(d_open, 1), pack(d_ext, 2)) >> 2;
      const int m_pb = max(max(pack(x_off + 1, 2), pack(d_new, 3)), pack(i_new, 1));
      Mo[j] = extend(m_pb >> 2, k, P, T, nw, plen, tlen);
      Io[j] = i_new;
      Do[j] = d_new;
    }
    if (kBanded && tid == 0) {
      win_lo[oslot] = lo_n;
      win_ext[oslot] = ext_n;
    }
    __syncthreads();

    // Termination: M[tlen - plen] == tlen; banded also stops, unfinished,
    // when the target diagonal overshoots.
    if (abs(target_k) <= d) {
      const int rel = target_k - lo_n;
      const int m_at_t = (rel < 0 || rel > ext_n) ? kNull : Mo[rel];
      const bool hit = m_at_t == target_off;
      if (hit || (kBanded && m_at_t > target_off)) {
        if (tid == 0) {
          dist_out[b] = d;
          fin_out[b] = hit ? 1 : 0;
        }
        return;
      }
    }
  }
  // Out of steps: unfinished, reported at the last score + 1.
  if (tid == 0) {
    dist_out[b] = unfinished_score;
    fin_out[b] = 0;
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over B alignments; returns a cudaError_t (0 = ok).
// pat/txt: [B, nw] packed u32 rows; plen/tlen: [B] int32; valid: [B] bool;
// sched: [num_steps, 5] int32 (score, out, mx, moe, ide slots);
// dist: [B] int32 out; fin: [B] bool out.  W must be a multiple of 32.
int wfa_distance_launch(const void* pat, const void* txt, int nw,
                        const void* plen, const void* tlen, const void* valid,
                        const void* sched, int num_steps, int unfinished_score,
                        int A, int W, int band, void* dist, void* fin, int B,
                        int device, void* stream) {
  if (B == 0) return 0;
  if (W <= 0 || W % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(A, W);
  const int threads = W < kMaxThreads ? W : kMaxThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(pat);
  const auto* t = static_cast<const uint32_t*>(txt);
  const auto* pl = static_cast<const int*>(plen);
  const auto* tl = static_cast<const int*>(tlen);
  const auto* v = static_cast<const unsigned char*>(valid);
  const auto* sc = static_cast<const int*>(sched);
  auto* dd = static_cast<int*>(dist);
  auto* ff = static_cast<unsigned char*>(fin);
  if (band > 0) {
    err = cudaFuncSetAttribute(wfa_distance_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wfa_distance_kernel<true><<<B, threads, smem, st>>>(
        p, t, nw, pl, tl, v, sc, num_steps, unfinished_score, A, W, band, dd, ff);
  } else {
    err = cudaFuncSetAttribute(wfa_distance_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wfa_distance_kernel<false><<<B, threads, smem, st>>>(
        p, t, nw, pl, tl, v, sc, num_steps, unfinished_score, A, W, band, dd, ff);
  }
  return static_cast<int>(cudaGetLastError());
}

// Largest dynamic shared memory a block may opt in to on `device`.
int wfa_smem_optin(int device, int* out) {
  return static_cast<int>(
      cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* wfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
