// K1, K2 and K4: batched gap-affine WFA for Hopper (sm_90a).
//
// K1 (kCigar = false) replaces wfa_tpu/ops/engine_pallas.py::_wfa_kernel
// with compute_cigar=False and ring_hbm=False (exact and adaptive-band
// windows).  K2 (kCigar = true) replaces the same kernel with
// compute_cigar=True: it also records, per computed score and diagonal, the
// 4-bit backtrace choice (_mk_choice), in the Pallas kernel's layout
// choice[d >> 3, b, j] at nibble d & 7 (the choice spill and its trailing
// flush), and in banded mode the window base of each score, lo_trace[b, d]
// (the lo spill).  K4 (kRingGlobal = true, exact only, with or without
// kCigar) replaces the same kernel with ring_hbm=True: windows wider than a
// block's shared memory holds as a whole ring.  Their plain versions are
// wfa_tpu_torch/ops/engine_torch.py::align_batch_device (K1, K4 distance)
// and engine_torch.cigar_tables (K2, K4 CIGAR); the kernels agree with them
// in every lane, including the score reported by lanes that run out of
// steps, and the choice tables agree wherever a backward walk can read them.
//
// Design: one thread block per alignment, diagonals across threads.  The
// [3A, W] M/I/D ring (rows: M of slots 0..A-1, then I, then D) and the
// per-slot window base/extent live in dynamic shared memory; K1 and K2 read
// the packed sequences from global memory (L2).  The control flow comes from
// the host schedule (wfa_tpu_torch.schedule.build_schedule: score, out slot
// and the three parent slots, -1 for a missing parent; cone_radii: the
// step's cone radius and that of the slot's previous score), so the kernel
// has no existence bitmasks and no working-set limit other than shared
// memory.  Each score costs one block barrier (two on re-centre steps); a
// block stops as soon as its alignment is done.
//
// The cone (exact mode, K1, K2 and K4): at score s only |k| <= radius(s)
// can hold an offset that is not NULL or derived from NULL, so a step
// computes only the diagonals W/2 - r .. W/2 + r (r capped at W/2).  A cell
// outside the cone keeps what the block's reset wrote: M and D NULL, I
// NULL + 1.  The plain engine computes every diagonal, so there its I rows
// drift to NULL + c (c >= 1) outside the cone, while M (extend of a negative
// offset) is exactly NULL and D exactly NULL.  The recurrence cannot tell
// these apart: an offset and every choice bit depend on NULL-derived inputs
// only through whether I >= NULL + 1, which holds in both.  So distances,
// flags and every choice nibble in the cone equal the plain version's, and
// a backward walk reads only real cells, which all lie in the cone.  Where a
// score's cone is narrower than that of the slot's previous score (some
// penalties, e.g. 3,1,3), the step resets the difference first.
//
// K4's ring: the C diagonals around W/2 (the centre, C from the wrapper:
// what shared memory holds beside the rest) stay in shared memory; only
// the (W - C) / 2 diagonals on each side go to the block's slab of a
// [B, 3A, W - C] int32 buffer in global memory.  The block resets its slab
// too, indexes it with 64-bit offsets, and reads it with plain loads after
// the score's barrier, never through the non-coherent path: the slab is
// written and read in the same launch.  The cone reaches the edges only
// past score o + e (C / 2 + 1), so most cells never touch global memory
// (wide10k: about a tenth).  K4 also copies the block's two packed rows
// into shared memory once, so the extension's loads are shared loads, and
// runs 1024 threads a block (shared memory allows one block an SM).
//
// K2's choice rows: each thread ORs the nibble of each score it computes
// into the current row word of the diagonal.  The row words live in shared
// memory (W words), not in registers.  The cone's base moves from score to
// score, so the thread that computes a diagonal changes; the score's
// barrier orders the read-modify-writes of two scores.  The words of the
// row's widest cone go to global memory, coalesced across the block, when
// the next scheduled score falls in another row and when the block
// finishes, so every row holding a score up to the alignment's distance is
// stored once, on the cone, and nibbles of scores the schedule skips stay
// 0.  Rows past the distance, rows holding no scheduled score, and words
// outside the cone are not written: no walk reads them.
//
// What bounds them on this card: the LCP extension of the one on-path
// diagonal is serial and divergent (its warp loops while the other 31 lanes
// idle), and every score pays a block-wide barrier; K2 adds one coalesced
// store of the cone's words per 8 scores.  K4 adds the edge traffic, 28
// bytes a cell of the edges, at the rate of L2 or of HBM
// (tools/torch_ring_bw.py measures it for this access pattern).  Later work:
// a warp-cooperative extension, several alignments per block, and for K4
// thread-block clusters when a launch has fewer pairs than SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (wfa_tpu_torch/ops/_build.py).  Plain C entry
// points, bound with ctypes.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wfa_common.cuh"

namespace {

using wfa::kNull;
constexpr int kBig = 1 << 20;         // window bound standing in for a missing parent
constexpr int kMaxThreads = 512;      // K1, K2
constexpr int kMaxThreadsRing = 1024; // K4
constexpr int kScratchInts = 66;      // argmin partials (2 per warp, <= 32 warps) + 2
constexpr int kSchedCols = 7;         // score, out, mx, moe, ide, radius, previous radius
constexpr int kCentreGranule = 32;    // K4's centre is a multiple of this

// Shared-memory bytes for one block; wfa_tpu_torch.ops.engine_cuda.smem_bytes
// holds the same formula.  K2 adds one choice row word per diagonal; K4
// holds only the ring's centre (C diagonals) and the two packed rows.
__host__ __device__ inline size_t smem_bytes(int A, int W, bool cigar,
                                             bool ring_global, int centre,
                                             int nw) {
  const size_t ring = 3 * static_cast<size_t>(A) * (ring_global ? centre : W);
  const size_t seq = ring_global ? 2 * (static_cast<size_t>(nw) + 1) : 0;
  return sizeof(int) * (ring + 2 * A + kScratchInts + (cigar ? W : 0) + seq);
}

// Word idx of a packed row; words past the row read as zero (the plain
// version pads one zero word and clamps to it).  K4's rows are in shared
// memory, each with that zero word at nw; K1/K2's in global memory.
template <bool kShared>
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int nw, int idx) {
  if (kShared) return row[min(idx, nw)];
  return idx < nw ? __ldg(row + idx) : 0u;
}

// The 16 bases starting at base pos (>= 0) as one u32, first base in the
// high bits: the top word of words idx:idx+1 shifted left by the phase.
template <bool kShared>
__device__ __forceinline__ uint32_t load16(const uint32_t* row, int nw, int pos) {
  const int idx = pos >> 4;
  return __funnelshift_l(word_at<kShared>(row, nw, idx + 1),
                         word_at<kShared>(row, nw, idx), 2 * (pos & 15));
}

// LCP extension of offset off on diagonal k (engine_torch._extend).
template <bool kShared>
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
    const uint32_t diff = load16<kShared>(pat, nw, vc) ^ load16<kShared>(txt, nw, hc);
    // Bases past either end count as mismatches (engine_torch._tail_mask),
    // so at most plen - vc and tlen - hc of the 16 match; __clz(0) == 32.
    const int eq = min(__clz(static_cast<int>(diff)) >> 1, min(plen - vc, tlen - hc));
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

// 4-bit backtrace choice from the packed maxima (engine_pallas._mk_choice):
// M's winning op SUB/INS/DEL -> from X/I/D; I and D gap-extend won (op 2).
__device__ __forceinline__ uint32_t choice_of(int m_pb, int i_pb, int d_pb) {
  const int m_op = m_pb & 3;
  const int m_from = m_op == wfa::kOpSub   ? wfa::kMFromX
                     : m_op == wfa::kOpIns ? wfa::kMFromI
                                           : wfa::kMFromD;
  return static_cast<uint32_t>(m_from | ((i_pb & 3) == 2 ? wfa::kIExtBit : 0) |
                               ((d_pb & 3) == 2 ? wfa::kDExtBit : 0));
}

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

template <bool kBanded, bool kCigar, bool kRingGlobal>
__global__ void __launch_bounds__(kRingGlobal ? kMaxThreadsRing : kMaxThreads)
wfa_kernel(const uint32_t* __restrict__ pat, const uint32_t* __restrict__ txt,
           int nw, const int* __restrict__ plen_arr,
           const int* __restrict__ tlen_arr,
           const unsigned char* __restrict__ valid,
           const int* __restrict__ sched, int num_steps, int unfinished_score,
           int A, int W, int band, int* __restrict__ dist_out,
           unsigned char* __restrict__ fin_out,
           int* __restrict__ choice, int num_chunks,
           int* __restrict__ lo_trace, int lo_stride, int* edge, int centre) {
  static_assert(!(kBanded && kRingGlobal), "the global ring is exact only");
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

  const int plen = plen_arr[b];
  const int tlen = tlen_arr[b];
  const int target_k = tlen - plen;
  const int target_off = tlen;
  const int W2 = W / 2;

  // The ring's rows hold diagonals cl .. cl + C - 1 in shared memory (all W
  // for K1/K2); K4's edges, W - C a row, are in this block's global slab.
  const int C = kRingGlobal ? centre : W;
  const int cl = (W - C) / 2;
  const int WE = W - C;
  int* ring_s = smem;
  int* win_lo = ring_s + 3 * A * C;
  int* win_ext = win_lo + A;
  int* scratch = win_ext + A;
  // K2: the current choice row word of each diagonal.
  uint32_t* row_word = reinterpret_cast<uint32_t*>(scratch + kScratchInts);
  // K4: the block's packed pattern and text rows.
  uint32_t* seq_s = row_word + (kCigar ? W : 0);
  int* slab = kRingGlobal && WE > 0 ? edge + static_cast<size_t>(b) * 3 * A * WE
                                    : nullptr;
  const uint32_t* P = kRingGlobal ? seq_s : pat + static_cast<size_t>(b) * nw;
  const uint32_t* T = kRingGlobal ? seq_s + nw + 1 : txt + static_cast<size_t>(b) * nw;

  auto ring_ld = [&](int row, int j) -> int {
    if (kRingGlobal) {
      const int jc = j - cl;
      if (static_cast<unsigned>(jc) >= static_cast<unsigned>(C)) {
        return slab[static_cast<size_t>(row) * WE + (jc < 0 ? j : j - C)];
      }
      return ring_s[row * C + jc];
    }
    return ring_s[row * W + j];
  };
  auto ring_st = [&](int row, int j, int v) {
    if (kRingGlobal) {
      const int jc = j - cl;
      if (static_cast<unsigned>(jc) >= static_cast<unsigned>(C)) {
        slab[static_cast<size_t>(row) * WE + (jc < 0 ? j : j - C)] = v;
        return;
      }
      ring_s[row * C + jc] = v;
      return;
    }
    ring_s[row * W + j] = v;
  };
  // Exact mode resets I to NULL + 1, the lower bound of what the plain
  // engine's I rows hold outside the cone (see the cone, above).
  const int i_reset = kBanded ? kNull : kNull + 1;
  auto reset_cell = [&](int slot, int j) {
    ring_st(slot, j, kNull);
    ring_st(A + slot, j, i_reset);
    ring_st(2 * A + slot, j, kNull);
  };

  for (int i = tid; i < 3 * A * C; i += nthreads) {
    const int row = i / C;
    ring_s[i] = (row >= A && row < 2 * A) ? i_reset : kNull;
  }
  if (kRingGlobal) {
    const size_t n = static_cast<size_t>(3) * A * WE;
    for (size_t i = tid; i < n; i += nthreads) {
      const size_t row = i / WE;
      slab[i] = (row >= static_cast<size_t>(A) && row < 2 * static_cast<size_t>(A))
                    ? i_reset : kNull;
    }
    const uint32_t* gp = pat + static_cast<size_t>(b) * nw;
    const uint32_t* gt = txt + static_cast<size_t>(b) * nw;
    for (int i = tid; i <= nw; i += nthreads) {
      seq_s[i] = i < nw ? __ldg(gp + i) : 0u;
      seq_s[nw + 1 + i] = i < nw ? __ldg(gt + i) : 0u;
    }
  }
  for (int a = tid; a < A; a += nthreads) {
    win_lo[a] = 0;
    win_ext[a] = 0;
  }
  if (kCigar) {
    for (int j = tid; j < W; j += nthreads) row_word[j] = 0u;
  }
  __syncthreads();

  // Stores choice row `row`, lanes lo..hi (64-bit offsets: C*B*W may pass
  // 2^31), and clears those words for the next row.
  auto store_row = [&](int row, int lo, int hi) {
    if (row >= num_chunks) return;
    int* dst = choice + (static_cast<size_t>(row) * gridDim.x + b) * W;
    for (int j = lo + tid; j <= hi; j += nthreads) {
      dst[j] = static_cast<int>(row_word[j]);
      row_word[j] = 0u;
    }
  };

  // Score 0: extension of diagonal 0, at window index 0 (banded) or W/2.
  if (tid == 0) {
    const int init = extend<kRingGlobal>(0, 0, P, T, nw, plen, tlen);
    ring_st(0, kBanded ? 0 : W2, init);
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

  // K2 exact: the widest cone of the current choice row (uniform).
  int row_r = 0;
  for (int s = 0; s < num_steps; ++s) {
    const int* row = sched + kSchedCols * s;
    const int d = row[0];
    const int oslot = row[1];
    const int sx = row[2];
    const int soe = row[3];
    const int se = row[4];
    // K2: this is the last scheduled score of its choice row.
    const bool row_ends =
        s + 1 == num_steps || (sched[kSchedCols * (s + 1)] >> 3) != (d >> 3);

    int lo_n = -W2;
    int ext_n = W - 1;
    int j0 = 0;       // lanes this score computes: j0 .. j1
    int j1 = W - 1;
    bool wide_row = false;  // K2 exact: the row's cone is wider than this one
    if constexpr (kBanded) {
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
        const int* mx = ring_s + sx * W;
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
    } else {
      const int r = min(row[5], W2);
      const int r_prev = min(row[6], W2);
      j0 = W2 - r;
      j1 = min(W - 1, W2 + r);
      // The slot's previous score reached further: reset the difference.
      for (int t = tid; t < 2 * (r_prev - r); t += nthreads) {
        const int j = t < r_prev - r ? W2 - r_prev + t : W2 + r + 1 + t - (r_prev - r);
        if (j < W) reset_cell(oslot, j);
      }
      wide_row = r < row_r;
      row_r = max(row_r, r);
    }

    const int nib = 4 * (d & 7);
    for (int j = j0 + tid; j <= j1; j += nthreads) {
      int i_open, i_ext, d_open, d_ext, x_off, k;
      if constexpr (kBanded) {
        if (j > ext_n) {
          reset_cell(oslot, j);
          continue;
        }
        // Child lane j is diagonal lo_n + j; each parent is read at its
        // own window base.
        const int* M = ring_s;
        const int* I = ring_s + A * W;
        const int* D = I + A * W;
        const int r_oe = soe < 0 ? 0 : lo_n - win_lo[soe] + j;
        const int r_e = se < 0 ? 0 : lo_n - win_lo[se] + j;
        const int r_x = sx < 0 ? 0 : lo_n - win_lo[sx] + j;
        i_open = soe < 0 ? kNull : window_read(M + soe * W, r_oe - 1, win_ext[soe]);
        d_open = soe < 0 ? kNull : window_read(M + soe * W, r_oe + 1, win_ext[soe]);
        i_ext = se < 0 ? kNull : window_read(I + se * W, r_e - 1, win_ext[se]);
        d_ext = se < 0 ? kNull : window_read(D + se * W, r_e + 1, win_ext[se]);
        x_off = sx < 0 ? kNull : window_read(M + sx * W, r_x, win_ext[sx]);
        k = lo_n + j;
      } else if (!kRingGlobal || (j > cl && j + 1 < cl + C)) {
        // The cell and its parents in shared memory (for K4 never at the
        // window's ends).
        const int* c = ring_s + (j - cl);
        const bool first = !kRingGlobal && j == 0;
        const bool last = !kRingGlobal && j == W - 1;
        i_open = (soe < 0 || first) ? kNull : c[soe * C - 1];
        d_open = (soe < 0 || last) ? kNull : c[soe * C + 1];
        i_ext = (se < 0 || first) ? kNull : c[(A + se) * C - 1];
        d_ext = (se < 0 || last) ? kNull : c[(2 * A + se) * C + 1];
        x_off = sx < 0 ? kNull : c[sx * C];
        k = j - W2;
      } else {
        i_open = (soe < 0 || j == 0) ? kNull : ring_ld(soe, j - 1);
        d_open = (soe < 0 || j == W - 1) ? kNull : ring_ld(soe, j + 1);
        i_ext = (se < 0 || j == 0) ? kNull : ring_ld(A + se, j - 1);
        d_ext = (se < 0 || j == W - 1) ? kNull : ring_ld(2 * A + se, j + 1);
        x_off = sx < 0 ? kNull : ring_ld(sx, j);
        k = j - W2;
      }
      // Recurrence with the reference's tie-break: gap-extend (2) beats
      // gap-open (1); for M, DEL (3) beats SUB (2) beats INS (1).  The
      // >> 2 unpack is an arithmetic shift.
      const int i_pb = max(pack(i_open + 1, 1), pack(i_ext + 1, 2));
      const int d_pb = max(pack(d_open, 1), pack(d_ext, 2));
      const int i_new = i_pb >> 2;
      const int d_new = d_pb >> 2;
      const int m_pb = max(max(pack(x_off + 1, 2), pack(d_new, 3)), pack(i_new, 1));
      const int m_new = extend<kRingGlobal>(m_pb >> 2, k, P, T, nw, plen, tlen);
      if (!kRingGlobal || static_cast<unsigned>(j - cl) < static_cast<unsigned>(C)) {
        int* c = ring_s + (j - cl);
        c[oslot * C] = m_new;
        c[(A + oslot) * C] = i_new;
        c[(2 * A + oslot) * C] = d_new;
      } else {
        ring_st(oslot, j, m_new);
        ring_st(A + oslot, j, i_new);
        ring_st(2 * A + oslot, j, d_new);
      }
      if (kCigar) row_word[j] |= choice_of(m_pb, i_pb, d_pb) << nib;
    }
    // The row's lanes: all W (banded) or its widest cone.
    const int st_lo = kBanded ? 0 : W2 - row_r;
    const int st_hi = kBanded ? W - 1 : min(W - 1, W2 + row_r);
    if (kCigar && row_ends) {
      // Each thread stores the words it computed, unless the row reaches
      // past this score's cone: then other threads' words need the barrier.
      if (wide_row) __syncthreads();
      store_row(d >> 3, st_lo, st_hi);
      row_r = 0;
    }
    if (tid == 0) {
      if (kBanded) {
        win_lo[oslot] = lo_n;
        win_ext[oslot] = ext_n;
      }
      if (kCigar && kBanded) lo_trace[static_cast<size_t>(b) * lo_stride + d] = lo_n;
    }
    __syncthreads();

    // Termination: M[tlen - plen] == tlen; banded also stops, unfinished,
    // when the target diagonal overshoots.
    if (abs(target_k) <= d) {
      const int rel = target_k - lo_n;
      const int m_at_t = (rel < 0 || rel > ext_n) ? kNull : ring_ld(oslot, rel);
      const bool hit = m_at_t == target_off;
      if (hit || (kBanded && m_at_t > target_off)) {
        // The trailing partial row.
        if (kCigar && !row_ends) store_row(d >> 3, st_lo, st_hi);
        if (tid == 0) {
          dist_out[b] = d;
          fin_out[b] = hit ? 1 : 0;
        }
        return;
      }
    }
  }
  // Out of steps: unfinished, reported at the last score + 1.  The last
  // step ended its row, so K2 has stored every row.
  if (tid == 0) {
    dist_out[b] = unfinished_score;
    fin_out[b] = 0;
  }
}

// Sets the kernel's shared-memory limit and launches it on B blocks of
// `threads` (0: the kernel's most) threads, at most W.
template <bool kBanded, bool kCigar, bool kRingGlobal>
int launch(const void* pat, const void* txt, int nw, const void* plen,
           const void* tlen, const void* valid, const void* sched,
           int num_steps, int unfinished_score, int A, int W, int band,
           void* dist, void* fin, void* choice, int num_chunks, void* lo_trace,
           int lo_stride, void* edge, int centre, int threads, int B,
           int device, void* stream) {
  if (B == 0) return 0;
  if (W <= 0 || W % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (kRingGlobal && (centre < kCentreGranule || centre > W ||
                      centre % kCentreGranule != 0 ||
                      (centre < W && edge == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int most = kRingGlobal ? kMaxThreadsRing : kMaxThreads;
  if (threads == 0) threads = most;
  if (threads < 32 || threads > most || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads > W) threads = W;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(A, W, kCigar, kRingGlobal, centre, nw);
  err = cudaFuncSetAttribute(wfa_kernel<kBanded, kCigar, kRingGlobal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wfa_kernel<kBanded, kCigar, kRingGlobal>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pat), static_cast<const uint32_t*>(txt), nw,
      static_cast<const int*>(plen), static_cast<const int*>(tlen),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(sched),
      num_steps, unfinished_score, A, W, band, static_cast<int*>(dist),
      static_cast<unsigned char*>(fin), static_cast<int*>(choice), num_chunks,
      static_cast<int*>(lo_trace), lo_stride, static_cast<int*>(edge), centre);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 (centre < 0) or K4 (centre >= 0: the ring's centre in shared memory,
// edge: [B, 3A, W - centre] int32 scratch, null when centre == W; exact
// only) on `stream` over B alignments of `threads` (0: 512 for K1, 1024 for
// K4) threads; returns a cudaError_t (0 = ok).
// pat/txt: [B, nw] packed u32 rows; plen/tlen: [B] int32; valid: [B] bool;
// sched: [num_steps, 7] int32 (score, out, mx, moe, ide slots, cone radius,
// the out slot's previous cone radius); dist: [B] int32 out; fin: [B] bool
// out.  W must be a multiple of 32, centre a multiple of 32 up to W.
int wfa_distance_launch(const void* pat, const void* txt, int nw,
                        const void* plen, const void* tlen, const void* valid,
                        const void* sched, int num_steps, int unfinished_score,
                        int A, int W, int band, void* dist, void* fin,
                        void* edge, int centre, int threads, int B, int device,
                        void* stream) {
  if (centre >= 0) {
    if (band > 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<false, false, true>(pat, txt, nw, plen, tlen, valid, sched,
                                      num_steps, unfinished_score, A, W, band,
                                      dist, fin, nullptr, 0, nullptr, 0, edge,
                                      centre, threads, B, device, stream);
  }
  if (band > 0) {
    return launch<true, false, false>(pat, txt, nw, plen, tlen, valid, sched,
                                      num_steps, unfinished_score, A, W, band,
                                      dist, fin, nullptr, 0, nullptr, 0,
                                      nullptr, -1, threads, B, device, stream);
  }
  return launch<false, false, false>(pat, txt, nw, plen, tlen, valid, sched,
                                     num_steps, unfinished_score, A, W, band,
                                     dist, fin, nullptr, 0, nullptr, 0,
                                     nullptr, -1, threads, B, device, stream);
}

// K2, or K4 in CIGAR mode when centre >= 0 (exact only): K1 plus the
// choice table and, when banded, the window base by score.
// choice: [num_chunks, B, W] int32 out, the 4-bit choice of score d at
// nibble d & 7 of row d >> 3; lo_trace: [B, lo_stride] int32 out (banded
// only; lo_stride > the last scheduled score).
int wfa_cigar_launch(const void* pat, const void* txt, int nw, const void* plen,
                     const void* tlen, const void* valid, const void* sched,
                     int num_steps, int unfinished_score, int A, int W,
                     int band, void* dist, void* fin, void* choice,
                     int num_chunks, void* lo_trace, int lo_stride, void* edge,
                     int centre, int threads, int B, int device, void* stream) {
  if (centre >= 0) {
    if (band > 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<false, true, true>(pat, txt, nw, plen, tlen, valid, sched,
                                     num_steps, unfinished_score, A, W, band,
                                     dist, fin, choice, num_chunks, nullptr, 0,
                                     edge, centre, threads, B, device, stream);
  }
  if (band > 0) {
    return launch<true, true, false>(pat, txt, nw, plen, tlen, valid, sched,
                                     num_steps, unfinished_score, A, W, band,
                                     dist, fin, choice, num_chunks, lo_trace,
                                     lo_stride, nullptr, -1, threads, B, device,
                                     stream);
  }
  return launch<false, true, false>(pat, txt, nw, plen, tlen, valid, sched,
                                    num_steps, unfinished_score, A, W, band,
                                    dist, fin, choice, num_chunks, nullptr, 0,
                                    nullptr, -1, threads, B, device, stream);
}

// Largest dynamic shared memory a block may opt in to on `device`.
int wfa_smem_optin(int device, int* out) {
  return static_cast<int>(
      cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

}  // extern "C"
