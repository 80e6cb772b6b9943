// K1, K2 and K4: batched gap-affine WFA for Hopper (sm_90a).
//
// K1 (kCigar = false) replaces wfa_tpu/ops/engine_pallas.py::_wfa_kernel
// with compute_cigar=False and ring_hbm=False (exact and adaptive-band
// windows).  K2 (kCigar = true) replaces the same kernel with
// compute_cigar=True: it also records, per computed score and diagonal, the
// 4-bit backtrace choice (_mk_choice), in the Pallas kernel's layout
// choice[d >> 3, b, j] at nibble d & 7 (the choice spill and its trailing
// flush), and in banded mode the window base of each score, lo_trace[b, d]
// (the lo spill).  K4 (kRingGlobal = true, with or without kCigar) replaces
// the same kernel with ring_hbm=True: exact windows wider than a block's
// shared memory holds as a whole ring.  K4 with a band (kBanded and
// kRingGlobal) is the card's counterpart of wfa_tpu's XLA route for banded
// windows past the Pallas width cap (wfa_tpu/aligner.py:637-646, which runs
// wfa_tpu/ops/engine_xla.py there).  Their plain versions are
// wfa_tpu_torch/ops/engine_torch.py::align_batch_device (K1, K4 distance)
// and engine_torch.cigar_tables (K2, K4 CIGAR); the kernels agree with them
// in every lane, including the score reported by lanes that run out of
// steps, and the choice tables agree wherever a backward walk can read them.
//
// Design: one thread block per alignment, diagonals across threads.  The
// [3A, W] M/I/D ring (rows: M of slots 0..A-1, then I, then D) and the
// per-slot window base/extent live in dynamic shared memory.  Each block
// copies its two packed rows into shared memory once (kSeqShared), each
// followed by a zero word, when they fit beside the ring; the wrapper
// decides from the shared memory a block may use (engine_cuda.rows_fit), and
// where they do not (exact windows near engine_cuda.max_width) K1 and K2 read
// them from global memory through the read-only path.  The control flow comes from
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
// runs up to 1024 threads a block (prepare).
// C may be 0 (pinned, or where not one granule of 32 diagonals fits beside
// the per-slot window words and the rows): ring_s then has no rows, every
// lane's jc fails the test against C and goes to the slab, and exact mode's
// shared fast path is never taken.
//
// The compact ring (kCompact: every K4 launch with A > 64, exact or banded).
// Only M's far parent, at f = max(x, o+e) = A - 1 scores back, needs A
// slots; the rest of what a score reads lies a few scores back.  Shared
// memory holds, C lanes a row: M's near ring of Mn = min(x, o+e) + 1 slots
// (1 where x = o+e: both M parents are then far), the I and D rings of e + 1
// slots each (a gap parent is e scores back), and two staging rows of M's far
// parent; slot = score mod the ring's slots, so every parent slot is
// (score + 1) mod slots and never this score's own.  Global memory holds M's
// far ring [A, W] a block, written at every computed lane of every score
// (stores only), and the slab of I's and D's edges [2 (e + 1), W - C].  M's
// edges are read from the far ring at the parent's A-slot (the schedule's
// columns 2 and 3), which still holds it.  The far parent's centre lanes are
// copied into a staging row by cp.async one score ahead, the two rows
// alternating by step: the next step's far parent was written at least one
// score before this one unless the gap between the two scores is f itself
// (x = o+e only), and then the copy follows this score's barrier.  Nothing is
// reset: every read is masked by its parent's extent, exact by the parent's
// cone radius (columns 11-13; outside it a read gives what K4's reset would
// hold: M and D NULL, I NULL + 1; a missing parent NULL) and banded by the
// parent's window, as before.  So the compact ring computes the cells the
// whole ring computes, bit for bit.  Its extra columns (compact_columns in
// engine_cuda.py): 7 near out slot, 8 gap out slot, 9 the near M parent's
// slot, 10 the gap parent's slot (0 where none), 11-13 the cone radii of the
// M[d-x], M[d-o-e] and I/D[d-e] parents (-1 where missing).  At (600,6,2)
// that is 9 + 3 + 3 + 2 = 17 rows a diagonal against the whole ring's 1,803:
// W=2176 fits whole (C = W), and M's far ring, 4 A W bytes a pair, is a
// third of the whole ring's global bytes.
//
// Banded K4 keeps window lanes 0 .. C - 1 in shared memory instead (cl = 0):
// a banded window grows from lane 0 until it reaches W, so its early scores
// never touch the edges; once at full width every score computes every lane
// wherever the centre lies.  A banded parent is read at a shifted lane
// (lo_n - win_lo[slot] + j), so each score works out once, for the whole
// block, the highest child lane jlim whose cell reads and writes only lanes
// below C; a warp whose lanes all lie at or below jlim (a warp-uniform test
// a pass) reads and writes ring_s directly with 32-bit indices, the other
// warps go through ring_ld / ring_st, which test each lane against C.  The
// re-centre's argmin reads lanes below C from ring_s the same way.  Neither
// the cone nor exact mode's I reset applies to a band (i_reset is NULL).
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
// The LCP extension.  Banded (K1, K2), it is warp-cooperative
// (extend_warp): each lane compares the first 16 bases of its own diagonal;
// the lanes whose run goes on are then served one at a time by the whole
// warp, 32 words (512 bases) a round, so the on-path diagonal's long run
// costs one or two rounds instead of one round per 16 bases while 31 lanes
// idle.  A banded block computes one cell a thread a score, and the chain of
// dependent steps a score costs sets its time, so the shorter chain pays.
// Exact (K1, K2, K4), each lane extends its own diagonal alone (extend):
// there a thread computes several cells a score, the SM's issue slots set
// the time, and serving the warp's runs one by one costs more instructions
// than it saves (measured on wide10k, ring-wide and at W=3840; PERF.md).
// Banded, every lane of a warp therefore runs each pass of the diagonal
// loop (lanes past the score's last diagonal recompute it and store
// nothing).
//
// What bounds them on this card: banded, the chain of dependent steps a
// score costs one block (parent reads, the recurrence, the extension, a
// block-wide barrier) and the issue slots of the SM it shares with another
// block, since the slowest alignment sets the launch's time; exact, the
// SM's issue slots.  K2 adds one coalesced store of the cone's words per 8
// scores.  K4 adds the edge traffic, 28 bytes a cell of the edges, at the
// rate of L2 or of HBM (tools/torch_ring_bw.py measures it for this access
// pattern); banded K4 has no cone, so once its window is full every score
// reads and writes the whole edge.  The compact ring moves one M store a
// computed cell and one 16-byte copy per 4 centre lanes of the far parent a
// score, off the score's chain.  Later work: the per-score work every
// banded thread repeats (the window's bounds), several alignments per
// block, and for K4 thread-block clusters when a launch has fewer pairs
// than SMs.
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
constexpr int kMaxThreadsBanded = 512;  // K1 and K2 with a band
constexpr int kMaxThreadsWide = 1024;   // K1, K2 exact; K4 exact and banded
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
constexpr int kScratchInts = 66;      // argmin partials (2 per warp, <= 32 warps) + 2
constexpr int kSchedCols = 7;         // score, out, mx, moe, ide, radius, previous radius
constexpr int kCompactCols = 14;      // the compact ring's: 7 more (see above)
constexpr int kCentreGranule = 32;    // K4's centre: 0 or a multiple of this

// Shared-memory bytes for one block; wfa_tpu_torch.ops.engine_cuda.smem_bytes
// holds the same formula.  `rows` ring rows a diagonal (3A; the compact
// ring's Mn + 2 (e + 1) + 2).  K2 adds one choice row word per diagonal; K4
// holds only the ring's centre (C diagonals); the two packed rows, nw words
// and a zero word each, where the block stages them (always for K4).
__host__ __device__ inline size_t smem_bytes(int A, int W, bool cigar,
                                             bool ring_global, int centre,
                                             int nw, bool seq_shared, int rows) {
  const size_t ring = static_cast<size_t>(rows) * (ring_global ? centre : W);
  const size_t seq = seq_shared ? 2 * (static_cast<size_t>(nw) + 1) : 0;
  return sizeof(int) * (ring + 2 * A + kScratchInts + (cigar ? W : 0) + seq);
}

// Word idx of a packed row; words past the row read as zero (the plain
// version pads one zero word and clamps to it).  Rows staged in shared
// memory carry that zero word at nw; rows in global memory are tested.
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

// Matching bases among the 16 at pattern position v and text position h
// (each clamped to [0, its length]).  Bases past either end count as
// mismatches (engine_torch._tail_mask), so at most plen - vc and tlen - hc
// of the 16 match; __clz(0) == 32.
template <bool kShared>
__device__ __forceinline__ int match16(const uint32_t* pat, const uint32_t* txt,
                                       int nw, int plen, int tlen, int v, int h) {
  const int vc = min(max(v, 0), plen);
  const int hc = min(max(h, 0), tlen);
  const uint32_t diff = load16<kShared>(pat, nw, vc) ^ load16<kShared>(txt, nw, hc);
  return min(__clz(static_cast<int>(diff)) >> 1, min(plen - vc, tlen - hc));
}

// LCP extension of offset off on diagonal k (engine_torch._extend), one
// lane alone, 16 bases a round.
template <bool kShared>
__device__ __forceinline__ int extend(int off, int k, const uint32_t* pat,
                                      const uint32_t* txt, int nw, int plen,
                                      int tlen) {
  int v = off - k;
  int h = off;
  if (off < 0 || v > plen || h > tlen) return kNull;
  int acc = 0;
  bool active = v < plen && h < tlen;
  while (active) {
    const int eq = match16<kShared>(pat, txt, nw, plen, tlen, v, h);
    acc += eq;
    v += eq;
    h += eq;
    active = eq == 16 && v < plen && h < tlen;
  }
  return off + acc;
}

// The same extension, called by all 32 lanes of a warp together; a lane
// with go == false takes part in the warp's rounds and its result is
// meaningless.  Each lane compares its
// first 16 bases alone.  Then each lane whose run goes on (16 equal, neither
// end reached) is served in turn by the whole warp: lane i compares the 16
// bases at 16 * i past the run's current end, and the first lane with fewer
// than 16 equal ends the run (all 32 equal: 512 bases further, unless an end
// is reached).  This is the sequential 16-base loop read 32 words at a time,
// as engine_torch._extend reads _CHUNKS words at a time: a word counts only
// if every earlier word matched in full, so the sums are the same.
template <bool kShared>
__device__ __forceinline__ int extend_warp(int off, int k, bool go,
                                           const uint32_t* pat, const uint32_t* txt,
                                           int nw, int plen, int tlen) {
  const int lane = threadIdx.x & 31;
  int v = off - k;
  int h = off;
  const bool invalid = off < 0 || v > plen || h > tlen;
  int acc = 0;
  bool more = false;
  if (go && !invalid && v < plen && h < tlen) {
    acc = match16<kShared>(pat, txt, nw, plen, tlen, v, h);
    v += acc;
    h += acc;
    more = acc == 16 && v < plen && h < tlen;
  }
  for (unsigned pending = __ballot_sync(kFullWarp, more); pending;
       pending &= pending - 1) {
    const int src = __ffs(pending) - 1;
    int sv = __shfl_sync(kFullWarp, v, src);
    int sh = __shfl_sync(kFullWarp, h, src);
    int run = 0;
    for (;;) {
      const int eq = match16<kShared>(pat, txt, nw, plen, tlen, sv + 16 * lane,
                                      sh + 16 * lane);
      const unsigned short_words = __ballot_sync(kFullWarp, eq != 16);
      if (short_words) {
        const int first = __ffs(short_words) - 1;
        run += 16 * first + __shfl_sync(kFullWarp, eq, first);
        break;
      }
      run += 512;
      sv += 512;
      sh += 512;
      if (sv >= plen || sh >= tlen) break;
    }
    if (lane == src) acc += run;
  }
  return invalid ? kNull : off + acc;
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

// The compact ring's prefetch: 16 bytes from global to shared memory,
// through L2 only (the far ring is written in the same launch), waited for
// by copy_wait before the barrier that publishes the staging row.
__device__ __forceinline__ void copy16_async(int* smem, const int* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lexicographic min of (value, index): the first index wins a tie.
__device__ __forceinline__ void argmin_merge(int& v, int& j, int ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

// The most threads a block (the first argument of __launch_bounds__): 512
// for banded K1/K2, 1024 for the rest, banded K4 included: its wide windows
// fill shared memory, so an SM holds one block, and 1024 threads halve a
// score's dependent passes (burst reads at W=4096: 7.14 against 7.83 ms at
// 512, PERF.md; 56 and 62 registers, within the bound's 64).  Blocks of the
// most threads an SM must hold by registers (the second argument).  Exact
// K1/K2 with staged rows: two of 1024 threads, at most 32 registers a
// thread, as their narrow windows want many resident blocks.  K1/K2 with
// the rows in global memory and K4 (but at a centre of 0) fill shared
// memory, so an SM holds one block anyway.  Banded blocks take the registers they need (two 512-thread
// blocks an SM at HiFi): capping them at 40 or 32 spilled or lengthened each
// block's chain more than the third and fourth resident block gained
// (PERF.md).
template <bool kBanded, bool kRingGlobal>
constexpr int max_threads() {
  return kBanded && !kRingGlobal ? kMaxThreadsBanded : kMaxThreadsWide;
}

template <bool kBanded, bool kCigar, bool kRingGlobal, bool kSeqShared, bool kCompact>
__global__ void __launch_bounds__(max_threads<kBanded, kRingGlobal>(),
                                  !kBanded && !kRingGlobal && kSeqShared ? 2 : 1)
wfa_kernel(const uint32_t* __restrict__ pat, const uint32_t* __restrict__ txt,
           int nw, const int* __restrict__ plen_arr,
           const int* __restrict__ tlen_arr,
           const unsigned char* __restrict__ valid,
           const int* __restrict__ sched, int num_steps, int unfinished_score,
           int A, int W, int band, int* __restrict__ dist_out,
           unsigned char* __restrict__ fin_out,
           int* __restrict__ choice, int num_chunks,
           int* __restrict__ lo_trace, int lo_stride, int* edge, int centre,
           int near_slots, int gap_slots, int far_mask) {
  static_assert(kSeqShared || !kRingGlobal, "K4 stages the packed rows");
  static_assert(kRingGlobal || !kCompact, "the compact ring is K4's");
  constexpr int kCols = kCompact ? kCompactCols : kSchedCols;
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

  // The ring's rows hold lanes cl .. cl + C - 1 in shared memory (all W for
  // K1/K2; banded K4 from lane 0); K4's edges, W - C a row, are in this
  // block's global slab.  The compact ring's shared rows: M's near slots
  // (Mn), I's and D's (E1 each), then the two staging rows; its slab holds
  // I's and D's edges only (rows from srow0 on), after the far ring.
  const int C = kRingGlobal ? centre : W;
  const int cl = kBanded ? 0 : (W - C) / 2;
  const int WE = W - C;
  const int Mn = near_slots;
  const int E1 = gap_slots;
  const int stage0 = Mn + 2 * E1;
  const int srow0 = kCompact ? Mn : 0;
  int* ring_s = smem;
  int* win_lo = ring_s + (kCompact ? stage0 + 2 : 3 * A) * C;
  int* win_ext = win_lo + A;
  int* scratch = win_ext + A;
  // K2: the current choice row word of each diagonal.
  uint32_t* row_word = reinterpret_cast<uint32_t*>(scratch + kScratchInts);
  // The block's packed pattern and text rows, where it stages them.
  uint32_t* seq_s = row_word + (kCigar ? W : 0);
  int* far = kCompact ? edge + static_cast<size_t>(b) *
                                   (static_cast<size_t>(A) * W + static_cast<size_t>(2 * E1) * WE)
                      : nullptr;
  int* slab = kCompact ? far + static_cast<size_t>(A) * W
              : kRingGlobal && WE > 0 ? edge + static_cast<size_t>(b) * 3 * A * WE
                                      : nullptr;
  const uint32_t* gp = pat + static_cast<size_t>(b) * nw;
  const uint32_t* gt = txt + static_cast<size_t>(b) * nw;
  const uint32_t* P = kSeqShared ? seq_s : gp;
  const uint32_t* T = kSeqShared ? seq_s + nw + 1 : gt;

  auto ring_ld = [&](int row, int j) -> int {
    if (kRingGlobal) {
      const int jc = j - cl;
      if (static_cast<unsigned>(jc) >= static_cast<unsigned>(C)) {
        return slab[static_cast<size_t>(row - srow0) * WE + (jc < 0 ? j : j - C)];
      }
      return ring_s[row * C + jc];
    }
    return ring_s[row * W + j];
  };
  auto ring_st = [&](int row, int j, int v) {
    if (kRingGlobal) {
      const int jc = j - cl;
      if (static_cast<unsigned>(jc) >= static_cast<unsigned>(C)) {
        slab[static_cast<size_t>(row - srow0) * WE + (jc < 0 ? j : j - C)] = v;
        return;
      }
      ring_s[row * C + jc] = v;
      return;
    }
    ring_s[row * W + j] = v;
  };
  // Compact: M of a score whose shared row is srow (a near slot or a
  // staging row) and whose far-ring slot is aslot, at lane j: the centre
  // from shared memory, the edges from the far ring.  m_st writes this
  // score's M into its near slot (centre lanes) and its far-ring slot.
  auto m_ld = [&](int srow, int aslot, int j) -> int {
    const int jc = j - cl;
    if (static_cast<unsigned>(jc) < static_cast<unsigned>(C)) return ring_s[srow * C + jc];
    return far[static_cast<size_t>(aslot) * W + j];
  };
  auto m_st = [&](int nslot, int aslot, int j, int v) {
    const int jc = j - cl;
    if (static_cast<unsigned>(jc) < static_cast<unsigned>(C)) ring_s[nslot * C + jc] = v;
    far[static_cast<size_t>(aslot) * W + j] = v;
  };
  // Banded: a parent window read at a shifted lane; outside [0, ext] NULL.
  auto win_read = [&](int row, int rel, int ext) -> int {
    return (rel < 0 || rel > ext) ? kNull : ring_ld(row, rel);
  };
  // Exact mode resets I to NULL + 1, the lower bound of what the plain
  // engine's I rows hold outside the cone (see the cone, above).
  const int i_reset = kBanded ? kNull : kNull + 1;
  auto reset_cell = [&](int slot, int j) {
    ring_st(slot, j, kNull);
    ring_st(A + slot, j, i_reset);
    ring_st(2 * A + slot, j, kNull);
  };
  // Compact: copies the centre lanes of step s's far M parent that its
  // cells may read (exact: the parent's cone; banded: its window) from the
  // far ring into staging row `buf`, a 16-byte copy at a time (cl and C are
  // multiples of 16 and 32 lanes).
  auto prefetch = [&](int s, int buf) {
    if (!kCompact || s >= num_steps || C == 0) return;
    const int* row = sched + kCols * s;
    const bool fx = far_mask & 1;
    const int aslot = fx ? row[2] : row[3];
    if (aslot < 0) return;
    int lo = 0;
    int hi = 0;
    if (kBanded) {
      hi = min(win_ext[aslot], C - 1);
    } else {
      const int r = fx ? row[11] : row[12];
      lo = max(W2 - r - cl, 0);
      hi = min(W2 + r - cl, C - 1);
    }
    int* dst = ring_s + (stage0 + buf) * C;
    const int* src = far + static_cast<size_t>(aslot) * W + cl;
    for (int g = (lo >> 2) + tid; g <= (hi >> 2); g += nthreads) {
      copy16_async(dst + 4 * g, src + 4 * g);
    }
  };

  // The compact ring resets nothing (every read is masked, see above).
  if (!kCompact) {
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
    }
  }
  if (kSeqShared) {
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

  // Score 0: extension of diagonal 0, at window index 0 (banded) or W/2,
  // by warp 0 (banded) or thread 0.
  if (tid < 32) {
    int init = 0;
    if constexpr (kBanded) {
      init = extend_warp<kSeqShared>(0, 0, tid == 0, P, T, nw, plen, tlen);
    } else if (tid == 0) {
      init = extend<kSeqShared>(0, 0, P, T, nw, plen, tlen);
    }
    if (tid == 0) {
      if constexpr (kCompact) {
        m_st(0, 0, kBanded ? 0 : W2, init);
      } else {
        ring_st(0, kBanded ? 0 : W2, init);
      }
      scratch[0] = init;
    }
  }
  __syncthreads();
  if (target_k == 0 && scratch[0] == target_off) {
    if (tid == 0) {
      dist_out[b] = 0;
      fin_out[b] = 1;
    }
    return;
  }
  if (kCompact) {
    // The first step's far parent can only be score 0.
    prefetch(0, 0);
    copy_wait();
    __syncthreads();
  }

  // K2 exact: the widest cone of the current choice row (uniform).
  int row_r = 0;
  for (int s = 0; s < num_steps; ++s) {
    const int* row = sched + kCols * s;
    const int d = row[0];
    const int oslot = row[1];
    const int sx = row[2];
    const int soe = row[3];
    const int se = row[4];
    // K2: this is the last scheduled score of its choice row.
    const bool row_ends =
        s + 1 == num_steps || (sched[kCols * (s + 1)] >> 3) != (d >> 3);
    // Compact: this score's near and gap slots; the shared rows of its M
    // parents (the far one's: this step's staging row), its gap parent's
    // slot and, exact, the parents' cone radii (-1: missing); what a read
    // of I outside its parent's cone gives.  Then the next step's far
    // parent is copied now, or after this score's barrier if it is this
    // score (`late`).
    int near_out = 0, gap_out = 0, mx_row = 0, moe_row = 0, gap_in = 0;
    int rad_x = -1, rad_oe = -1, rad_e = -1, i_out = kNull;
    bool late = false;
    if constexpr (kCompact) {
      const int stage = stage0 + (s & 1);
      near_out = row[7];
      gap_out = row[8];
      mx_row = (far_mask & 1) ? stage : row[9];
      moe_row = (far_mask & 2) ? stage : row[9];
      gap_in = row[10];
      rad_x = row[11];
      rad_oe = row[12];
      rad_e = row[13];
      i_out = se < 0 ? kNull : i_reset;
      late = s + 1 < num_steps && sched[kCols * (s + 1)] - (A - 1) == d;
      if (!late) prefetch(s + 1, (s + 1) & 1);
    }

    int lo_n = -W2;
    int ext_n = W - 1;
    // Banded: the parents' shifts and extents (-1 for a missing parent), and
    // for K4 the highest lane of the shared pass (-1: none).
    int sh_x = 0, sh_oe = 0, sh_e = 0, ext_x = -1, ext_oe = -1, ext_e = -1;
    int jlim = W - 1;
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
        int best = INT_MAX;
        int best_j = INT_MAX;
        auto consider = [&](int j, int m) {
          if (m >= 0) {
            argmin_merge(best, best_j, max(plen - (m - (lox + j)), tlen - m), j);
          }
        };
        // Lanes below C from ring_s directly (K4's shared pass), the rest
        // through ring_ld (compact: the far ring); the merge is order-free.
        const int xrow = kCompact ? mx_row : sx;
        const int cs = kRingGlobal ? min(extx, C) : extx;
        for (int j = tid; j < cs; j += nthreads) consider(j, ring_s[xrow * C + j]);
        if (kRingGlobal) {
          for (int j = cs + tid; j < extx; j += nthreads) {
            consider(j, kCompact ? far[static_cast<size_t>(sx) * W + j] : ring_ld(sx, j));
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
      // Each parent's shift: child lane j reads its lane sh_* + j (+-1).
      sh_x = sx < 0 ? 0 : lo_n - win_lo[sx];
      sh_oe = soe < 0 ? 0 : lo_n - win_lo[soe];
      sh_e = se < 0 ? 0 : lo_n - win_lo[se];
      ext_x = sx < 0 ? -1 : win_ext[sx];
      ext_oe = soe < 0 ? -1 : win_ext[soe];
      ext_e = se < 0 ? -1 : win_ext[se];
      // K4: the highest child lane whose reads (parent lanes up to its
      // shift + 1, or the parent's extent) and writes lie below C.
      if (kRingGlobal) {
        jlim = C - 1;
        if (ext_x >= C) jlim = min(jlim, C - 1 - sh_x);
        if (ext_oe >= C) jlim = min(jlim, C - 2 - sh_oe);
        if (ext_e >= C) jlim = min(jlim, C - 2 - sh_e);
      }
    } else {
      const int r = min(row[5], W2);
      const int r_prev = min(row[6], W2);
      j0 = W2 - r;
      j1 = min(W - 1, W2 + r);
      // The slot's previous score reached further: reset the difference
      // (the compact ring masks its reads instead).
      if (!kCompact) {
        for (int t = tid; t < 2 * (r_prev - r); t += nthreads) {
          const int j = t < r_prev - r ? W2 - r_prev + t : W2 + r + 1 + t - (r_prev - r);
          if (j < W) reset_cell(oslot, j);
        }
      }
      wide_row = r < row_r;
      row_r = max(row_r, r);
    }

    const int nib = 4 * (d & 7);
    // Banded, every lane of a warp runs each pass (extend_warp is
    // cooperative): a lane past j1 recomputes lane j1 and stores nothing,
    // and a warp wholly past j1 leaves the loop.  Exact, each thread leaves
    // after its last diagonal.
    for (int jb = j0; jb + (kBanded ? tid & ~31 : tid) <= j1; jb += nthreads) {
      const int j = kBanded ? min(jb + tid, j1) : jb + tid;
      bool live = jb + tid <= j1;
      // Banded K4: this warp's lanes all take the shared pass (uniform).
      const bool shared = !kRingGlobal || (kBanded && min(jb + (tid | 31), j1) <= jlim);
      int i_open, i_ext, d_open, d_ext, x_off, k;
      if constexpr (kBanded) {
        // Child lane j is diagonal lo_n + j; each parent is read at its
        // own window base (rows: M slot, A + I slot, 2A + D slot; compact:
        // the rows above); a missing parent has extent -1, so every read
        // of it is NULL.
        const int r_oe = sh_oe + j;
        const int r_e = sh_e + j;
        const int r_x = sh_x + j;
        if (shared) {
          if (!kCompact && live && j > ext_n) {
            ring_s[oslot * C + j] = kNull;
            ring_s[(A + oslot) * C + j] = i_reset;
            ring_s[(2 * A + oslot) * C + j] = kNull;
          }
          auto rd = [&](int row, int rel, int ext) -> int {
            return (rel < 0 || rel > ext) ? kNull : ring_s[row * C + rel];
          };
          if constexpr (kCompact) {
            i_open = rd(moe_row, r_oe - 1, ext_oe);
            d_open = rd(moe_row, r_oe + 1, ext_oe);
            i_ext = rd(Mn + gap_in, r_e - 1, ext_e);
            d_ext = rd(Mn + E1 + gap_in, r_e + 1, ext_e);
            x_off = rd(mx_row, r_x, ext_x);
          } else {
            i_open = rd(soe, r_oe - 1, ext_oe);
            d_open = rd(soe, r_oe + 1, ext_oe);
            i_ext = rd(A + se, r_e - 1, ext_e);
            d_ext = rd(2 * A + se, r_e + 1, ext_e);
            x_off = rd(sx, r_x, ext_x);
          }
        } else if constexpr (kCompact) {
          auto m_win = [&](int srow, int aslot, int rel, int ext) -> int {
            return (rel < 0 || rel > ext) ? kNull : m_ld(srow, aslot, rel);
          };
          i_open = m_win(moe_row, soe, r_oe - 1, ext_oe);
          d_open = m_win(moe_row, soe, r_oe + 1, ext_oe);
          i_ext = win_read(Mn + gap_in, r_e - 1, ext_e);
          d_ext = win_read(Mn + E1 + gap_in, r_e + 1, ext_e);
          x_off = m_win(mx_row, sx, r_x, ext_x);
        } else {
          if (live && j > ext_n) reset_cell(oslot, j);
          i_open = win_read(soe, r_oe - 1, ext_oe);
          d_open = win_read(soe, r_oe + 1, ext_oe);
          i_ext = win_read(A + se, r_e - 1, ext_e);
          d_ext = win_read(2 * A + se, r_e + 1, ext_e);
          x_off = win_read(sx, r_x, ext_x);
        }
        live = live && j <= ext_n;
        k = lo_n + j;
      } else if constexpr (kCompact) {
        // Each read masked by its parent's cone (a missing parent's radius
        // is -1); the cell and its parents in shared memory away from the
        // centre's ends, else M's edges from the far ring.
        k = j - W2;
        if (j > cl && j + 1 < cl + C) {
          const int* c = ring_s + (j - cl);
          i_open = abs(k - 1) <= rad_oe ? c[moe_row * C - 1] : kNull;
          d_open = abs(k + 1) <= rad_oe ? c[moe_row * C + 1] : kNull;
          i_ext = abs(k - 1) <= rad_e ? c[(Mn + gap_in) * C - 1] : i_out;
          d_ext = abs(k + 1) <= rad_e ? c[(Mn + E1 + gap_in) * C + 1] : kNull;
          x_off = abs(k) <= rad_x ? c[mx_row * C] : kNull;
        } else {
          i_open = (j == 0 || abs(k - 1) > rad_oe) ? kNull : m_ld(moe_row, soe, j - 1);
          d_open = (j == W - 1 || abs(k + 1) > rad_oe) ? kNull : m_ld(moe_row, soe, j + 1);
          i_ext = j == 0 ? kNull
                  : abs(k - 1) <= rad_e ? ring_ld(Mn + gap_in, j - 1) : i_out;
          d_ext = (j == W - 1 || abs(k + 1) > rad_e) ? kNull
                                                      : ring_ld(Mn + E1 + gap_in, j + 1);
          x_off = abs(k) > rad_x ? kNull : m_ld(mx_row, sx, j);
        }
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
      // Banded: the warp-cooperative extension; exact: the serial one (see
      // the note on the extension above).
      int m_new = 0;
      if constexpr (kBanded) {
        m_new = extend_warp<kSeqShared>(m_pb >> 2, k, live, P, T, nw, plen, tlen);
      }
      if (!live) continue;
      if constexpr (!kBanded) m_new = extend<kSeqShared>(m_pb >> 2, k, P, T, nw, plen, tlen);
      if constexpr (kCompact) {
        if (kBanded ? shared : static_cast<unsigned>(j - cl) < static_cast<unsigned>(C)) {
          int* c = ring_s + (j - cl);
          c[near_out * C] = m_new;
          c[(Mn + gap_out) * C] = i_new;
          c[(Mn + E1 + gap_out) * C] = d_new;
          far[static_cast<size_t>(oslot) * W + j] = m_new;
        } else {
          m_st(near_out, oslot, j, m_new);
          ring_st(Mn + gap_out, j, i_new);
          ring_st(Mn + E1 + gap_out, j, d_new);
        }
      } else if (kBanded ? shared
                         : !kRingGlobal ||
                               static_cast<unsigned>(j - cl) < static_cast<unsigned>(C)) {
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
    if (kCompact) copy_wait();
    __syncthreads();

    // Termination: M[tlen - plen] == tlen; banded also stops, unfinished,
    // when the target diagonal overshoots.  (Compact, exact: a lane outside
    // this score's cone holds an older score's M.)
    if (abs(target_k) <= d) {
      const int rel = target_k - lo_n;
      int m_at_t = kNull;
      if (rel >= 0 && rel <= ext_n) {
        if constexpr (kCompact) {
          if (kBanded || abs(target_k) <= row[5]) m_at_t = m_ld(near_out, oslot, rel);
        } else {
          m_at_t = ring_ld(oslot, rel);
        }
      }
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
    if (kCompact && late) {
      prefetch(s + 1, (s + 1) & 1);
      copy_wait();
      __syncthreads();
    }
  }
  // Out of steps: unfinished, reported at the last score + 1.  The last
  // step ended its row, so K2 has stored every row.
  if (tid == 0) {
    dist_out[b] = unfinished_score;
    fin_out[b] = 0;
  }
}

// The compact ring's slots (near_slots 0: not compact) and which M
// parents are far (bit 0: M[d-x], bit 1: M[d-o-e]).
struct Compact {
  int near_slots, gap_slots, far_mask;
  bool on() const { return near_slots > 0; }
  int rows() const { return near_slots + 2 * gap_slots + 2; }
};

// One instantiation of wfa_kernel.
template <bool kBanded, bool kCigar, bool kRingGlobal, bool kSeqShared,
          bool kCompact = false>
struct Variant {
  static auto kernel() {
    return &wfa_kernel<kBanded, kCigar, kRingGlobal, kSeqShared, kCompact>;
  }
  static size_t smem(int A, int W, int centre, int nw, Compact cp) {
    return smem_bytes(A, W, kCigar, kRingGlobal, centre, nw, kSeqShared,
                      kCompact ? cp.rows() : 3 * A);
  }
  static constexpr int kMost = max_threads<kBanded, kRingGlobal>();
  static constexpr bool kRing = kRingGlobal;
};

// Calls fn(Variant<...>{}) with the instantiation for these arguments: K4
// banded or exact when centre >= 0 (rows always staged; the compact ring
// where cp is on), else K1/K2 banded or exact, with the rows staged or not.
template <bool kCigar, class Fn>
int with_variant(int band, int centre, int rows_shared, Compact cp, Fn&& fn) {
  if (centre >= 0) {
    if (!rows_shared) return static_cast<int>(cudaErrorInvalidValue);
    if (cp.on()) {
      return band > 0 ? fn(Variant<true, kCigar, true, true, true>{})
                      : fn(Variant<false, kCigar, true, true, true>{});
    }
    return band > 0 ? fn(Variant<true, kCigar, true, true>{})
                    : fn(Variant<false, kCigar, true, true>{});
  }
  if (cp.on()) return static_cast<int>(cudaErrorInvalidValue);
  if (band > 0) {
    return rows_shared ? fn(Variant<true, kCigar, false, true>{})
                       : fn(Variant<true, kCigar, false, false>{});
  }
  return rows_shared ? fn(Variant<false, kCigar, false, true>{})
                     : fn(Variant<false, kCigar, false, false>{});
}

// Sets the kernel's shared-memory limit and resolves `threads` on the
// current device (0: see below; at most W).  K1/K2 take 512, or 1024 in
// exact mode where a block's shared memory leaves no room for a second one
// on an SM.  K4 takes min(1024, W) unless 512-thread blocks keep more
// threads resident on an SM: a small block (a centre of 0) may fit two of
// 512 but one of 1024.  At a tie it takes the wider block, whose score
// needs fewer dependent passes (A=601, C=0: 1 kbp pairs 1.68 against 2.12
// ms at 512, 273 of them 3.87 against 4.12; with CIGARs at W=640, one
// block of 640 against two of 512, 0.75 against 0.64; PERF.md).
template <class V>
int prepare(int A, int W, int nw, int centre, Compact cp, int& threads,
            size_t& smem) {
  if (W <= 0 || W % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads != 0 && (threads < 32 || threads > V::kMost || threads % 32 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  smem = V::smem(A, W, centre, nw, cp);
  cudaError_t err = cudaFuncSetAttribute(
      V::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads == 0) {
    threads = kMaxThreadsBanded;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, V::kernel(),
                                                        kMaxThreadsBanded, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (V::kRing) {
      const int wide = min(V::kMost, W);
      int wide_blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&wide_blocks, V::kernel(),
                                                          wide, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (wide_blocks * wide >= blocks * kMaxThreadsBanded) threads = V::kMost;
    } else if (V::kMost > kMaxThreadsBanded && blocks <= 1) {
      threads = V::kMost;
    }
  }
  if (threads > W) threads = W;
  return 0;
}

// Launches the instantiation on B blocks (see prepare for `threads`).
template <bool kCigar>
int dispatch(const void* pat, const void* txt, int nw, const void* plen,
             const void* tlen, const void* valid, const void* sched,
             int num_steps, int unfinished_score, int A, int W, int band,
             void* dist, void* fin, void* choice, int num_chunks, void* lo_trace,
             int lo_stride, void* edge, int centre, Compact cp, int rows_shared,
             int threads, int B, int device, void* stream) {
  return with_variant<kCigar>(band, centre, rows_shared, cp, [&](auto v) -> int {
    using V = decltype(v);
    if (B == 0) return 0;
    if (centre >= 0 && (centre > W || centre % kCentreGranule != 0 ||
                        ((centre < W || cp.on()) && edge == nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (cp.on() && (cp.near_slots > A || cp.gap_slots < 2 || cp.gap_slots > A ||
                    cp.far_mask < 1 || cp.far_mask > 3)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    size_t smem = 0;
    if (const int rc = prepare<V>(A, W, nw, centre, cp, threads, smem)) return rc;
    const auto kernel = V::kernel();
    kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pat), static_cast<const uint32_t*>(txt), nw,
        static_cast<const int*>(plen), static_cast<const int*>(tlen),
        static_cast<const unsigned char*>(valid), static_cast<const int*>(sched),
        num_steps, unfinished_score, A, W, band, static_cast<int*>(dist),
        static_cast<unsigned char*>(fin), static_cast<int*>(choice), num_chunks,
        static_cast<int*>(lo_trace), lo_stride, static_cast<int*>(edge), centre,
        cp.near_slots, cp.gap_slots, cp.far_mask);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// K1 (centre < 0) or K4 (centre >= 0: the ring's centre in shared memory,
// 0 for none; edge: [B, 3A, W - centre] int32 scratch, null when
// centre == W) on `stream` over B alignments of `threads` (0: see prepare)
// threads; rows_shared != 0 stages the packed rows in shared memory (K4
// requires it); returns a cudaError_t (0 = ok).  near_slots > 0 launches
// K4's compact ring (near_slots, gap_slots: the M near ring's and each gap
// ring's slots; far_mask: which M parents are far, bit 0 M[d-x], bit 1
// M[d-o-e]); its edge buffer holds, a block, the far ring [A, W] and then
// the I and D edges [2 gap_slots, W - centre], and its sched has 14 columns.
// pat/txt: [B, nw] packed u32 rows; plen/tlen: [B] int32; valid: [B] bool;
// sched: [num_steps, 7] int32 (score, out, mx, moe, ide slots, cone radius,
// the out slot's previous cone radius); dist: [B] int32 out; fin: [B] bool
// out.  W must be a multiple of 32, centre 0 or a multiple of 32 up to W.
int wfa_distance_launch(const void* pat, const void* txt, int nw,
                        const void* plen, const void* tlen, const void* valid,
                        const void* sched, int num_steps, int unfinished_score,
                        int A, int W, int band, void* dist, void* fin,
                        void* edge, int centre, int near_slots, int gap_slots,
                        int far_mask, int rows_shared, int threads, int B,
                        int device, void* stream) {
  return dispatch<false>(pat, txt, nw, plen, tlen, valid, sched, num_steps,
                         unfinished_score, A, W, band, dist, fin, nullptr, 0,
                         nullptr, 0, edge, centre,
                         Compact{near_slots, gap_slots, far_mask}, rows_shared,
                         threads, B, device, stream);
}

// K2, or K4 in CIGAR mode when centre >= 0: K1 plus the
// choice table and, when banded, the window base by score.
// choice: [num_chunks, B, W] int32 out, the 4-bit choice of score d at
// nibble d & 7 of row d >> 3; lo_trace: [B, lo_stride] int32 out (banded
// only; lo_stride > the last scheduled score).
int wfa_cigar_launch(const void* pat, const void* txt, int nw, const void* plen,
                     const void* tlen, const void* valid, const void* sched,
                     int num_steps, int unfinished_score, int A, int W,
                     int band, void* dist, void* fin, void* choice,
                     int num_chunks, void* lo_trace, int lo_stride, void* edge,
                     int centre, int near_slots, int gap_slots, int far_mask,
                     int rows_shared, int threads, int B, int device,
                     void* stream) {
  return dispatch<true>(pat, txt, nw, plen, tlen, valid, sched, num_steps,
                        unfinished_score, A, W, band, dist, fin, choice,
                        num_chunks, band > 0 ? lo_trace : nullptr,
                        band > 0 ? lo_stride : 0, edge, centre,
                        Compact{near_slots, gap_slots, far_mask}, rows_shared,
                        threads, B, device, stream);
}

// The threads a block of the kernel these arguments select would get
// (threads 0: see prepare) and how many such blocks one SM holds at once:
// out[0] blocks, out[1] threads.
int wfa_blocks_per_sm(int cigar, int band, int centre, int near_slots,
                      int gap_slots, int rows_shared, int A, int W, int nw,
                      int threads, int device, int* out) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Compact cp{near_slots, gap_slots, 1};
  auto query = [&](auto v) -> int {
    using V = decltype(v);
    size_t smem = 0;
    if (const int rc = prepare<V>(A, W, nw, centre, cp, threads, smem)) return rc;
    out[1] = threads;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, V::kernel(), threads, smem));
  };
  return cigar ? with_variant<true>(band, centre, rows_shared, cp, query)
               : with_variant<false>(band, centre, rows_shared, cp, query);
}

// Largest dynamic shared memory a block may opt in to on `device`.
int wfa_smem_optin(int device, int* out) {
  return static_cast<int>(
      cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

}  // extern "C"
