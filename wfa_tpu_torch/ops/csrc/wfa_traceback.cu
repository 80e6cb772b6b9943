// K3: the backward walk over K2's choice table, for Hopper (sm_90a).
//
// Replaces wfa_tpu/ops/traceback_pallas.py::_traceback_kernel (:95, launched
// by traceback_batch_device_impl and fused after the alignment kernel by
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
// corrupt walk (a row at or past num_chunks, a diagonal outside [0, W), an
// op stream past opw * 16 ops, or a walk that does not end at d == 0, k == 0
// in M), which sends the pair to the CPU, and 0 where there is no walk
// (unfinished, or distance 0).  Each step checks the row before it reads
// lo_trace and the diagonal before it reads the table; a lo_trace index past
// lo_stride clamps to its last column, as the plain version's does.
//
// What bounds it on this card: neither bytes (a walk reads a few words a
// row) nor operations (a dozen a step), but the chain of steps: each step's
// score and diagonal come from the nibble the step before read, so the
// launch takes as long as its longest walk, and a walk's time is its steps'
// instruction latencies end to end.  The one-thread-a-walk port paid one or
// two dependent device-memory loads a step; here a step is one warp shuffle
// (two in banded mode, lo then the word) and a few dozen dependent integer
// instructions, and each row entry waits for nothing that was prefetched in
// time.  On an H100 the longest wide10k walk (1,402 steps over ~340 rows)
// takes 0.188 ms, 134 ns a step with its share of the row entries, the
// same with L2 flushed (PERF.md section 6).
//
// Design: one warp per walk, all 32 lanes carrying the same walk state
// (d, k, matrix, op count), so no broadcast is needed.  The current row's
// window, the kSpan = 32 table words around the walk's diagonal (clamped to
// [0, W) so it never reads the next alignment's row or past the table), is
// in registers, one word a lane; a step takes its word with one
// __shfl_sync from the lane that holds it.  Within a row of 8 scores k
// moves at most 8 (each I or D op lowers the score by at least e >= 1), so
// a window centred on the diagonal at which the walk enters a row holds
// that row's reads and, in exact mode, those of the row below.  The windows arrive ahead of the walk: kSlots slots of the warp's
// shared memory hold the current row and the next kSlots - 1, each filled
// by one coalesced asynchronous copy (cp.async, one commit group a window);
// entering a row issues the window of the row kSlots - 1 below it into the
// slot just freed, centred on k - lo(top score of that row), then waits for
// its own window's group alone and takes it into registers.  (Prefetching
// into registers instead kept the loads on the chain: the compiler waited
// for each row's prefetch at the next use of the registers it tracked with
// it, one load latency a row.)  A row that the walk jumps to with no window
// in flight (the first, or past several rows at once) is loaded at entry,
// and the rows below it are re-issued.  A banded re-centre can move lo by
// up to ~W/2 in one score; where the diagonal then falls outside the
// current window, the warp reloads it centred on the diagonal (a miss:
// speed only, never the answer).  lo_trace arrives the same way in aligned
// 32-score chunks, two chunks ahead; a step's lo comes from a shuffle of
// the current chunk, one entry a lane.  Completed 16-op words collect one a
// lane; the warp stores each run of 32 at once, then the partial word and
// the zero tail, coalesced.  Blocks hold 1-8 warps (default 2), one walk
// each, so a few hundred walks spread over the SMs.  (Windows of 64 words,
// two a lane, were slower on every workload measured, though they never
// miss in exact mode.)
// tests/test_torch_traceback.py states this walk in numpy, load for load;
// the optional per-walk counters below let the card's walks be held to it.
//
// Build: as wfa_distance.cu (wfa_tpu_torch/ops/_build.py).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wfa_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 4;      // the current row's window and 3 rows ahead
constexpr int kMaxWarps = 8;   // warps a block, one walk each
constexpr int kStats = 4;      // per-walk counters: rows, loads, misses, cold
constexpr int kSpan = 32;      // window words, one a lane
constexpr int kHalf = kSpan / 2;
constexpr int kLoChunks = 4;   // lo_trace chunk ring: chunk q at q % 4

// Asynchronous 4-byte copies into shared memory, in commit groups.  They
// leave no register waiting on a load: a prefetch into registers was
// waited for at the next use of any register the compiler tracked with it,
// which put one whole load latency on every row.
__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// A window copied into a slot: its row (-1: none), first word and commit
// group.
struct Window {
  int row, base, group;
};

// One warp's walk.  Every member is warp-uniform except win, lo_cur and
// buf, which hold one lane's share.
template <bool kBanded>
struct Walker {
  // Inputs.
  const int* table;    // choice + b * W: row r at table + r * row_stride
  size_t row_stride;   // B * W
  const int* lo_row;   // lo_trace + b * lo_stride (banded)
  int lo_stride, num_chunks, W, x, o, e, max_ops, lane;
  int* ops;            // this walk's stream words
  // This warp's shared memory: the slots' windows [kSlots][kSpan] and
  // the lo chunks [4][32].
  uint32_t* srow;
  int* slo;

  // Walk state.
  int d, k, mat = 0, p = 0;
  bool err = false;
  uint32_t acc = 0, buf = 0;   // the open stream word; lane i: word 32n + i
  int flushed = 0;             // stream words stored so far
  int r = 0, R = -1;           // the next read's row; the row being walked
  long long j = 0;             // the next read's diagonal, k - lo(d)
  // The row being walked: its slot, first word and window words; the
  // windows in flight in slots s + 1, s + 2 and s + 3, in that order.
  int s = kSlots - 1, cur_base = 0;
  uint32_t win = 0;
  Window ahead[kSlots - 1];
  // Commit groups: committed, known complete.
  int g = 0, done = 0;
  // lo chunks c0 (in lo_cur, lane l: lo(c0 + l)), c0 - 32 and c0 - 64, and
  // the commit group of each.
  int lo_cur = 0, c0 = INT_MAX, g_cur = 0, g_nxt = 0, g_nx2 = 0;
  bool have_nxt = false;
  // Counters: rows entered, window loads, misses, entries with no load in
  // flight.
  int n_rows = 0, n_loads = 0, n_miss = 0, n_cold = 0;

  __device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++g;
  }

  // Wait until commit group id is complete, leaving up to 3 newer ones in
  // flight.
  __device__ __forceinline__ void wait_for(int id) {
    if (id <= done) return;
    const int n = min(g - id, 3);
    switch (n) {
      case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
      case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
      case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
      default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    }
    done = g - n;
  }

  // lo_trace chunk q (scores 32q .. 32q + 31) into its ring slot; returns
  // its commit group (0: no chunk).  Addresses clamp to [0, lo_stride):
  // entries past it are never read.
  __device__ __forceinline__ int copy_lo(int q) {
    if (q < 0) return 0;
    copy4(slo + (q % kLoChunks) * 32 + lane,
          lo_row + min(32 * q + lane, lo_stride - 1));
    commit();
    return g;
  }

  // The window of row rr centred on diagonal c (-1: no row), clamped to
  // [0, W), into slot sl.  Words past W (W < kSpan) are never read.
  __device__ __forceinline__ void copy_row(Window& w, int sl, int rr,
                                          long long c) {
    w.row = rr;
    if (rr < 0) return;
    const long long top = W > kSpan ? W - kSpan : 0;
    long long at = c - kHalf;
    at = at < 0 ? 0 : (at > top ? top : at);
    const int* src = table + static_cast<size_t>(rr) * row_stride;
    copy4(srow + sl * kSpan + lane, src + min(static_cast<int>(at) + lane, W - 1));
    commit();
    ++n_loads;
    w.base = static_cast<int>(at);
    w.group = g;
  }

  // Walk out of slot sl: wait for its window and take it into registers
  // (each lane reads the word it copied).
  __device__ __forceinline__ void use_row(int sl, const Window& w) {
    wait_for(w.group);
    win = srow[sl * kSpan + lane];
    cur_base = w.base;
    s = sl;
  }

  // The current window's word at diagonal jj (garbage outside it).
  __device__ __forceinline__ uint32_t read_word(long long jj) const {
    return __shfl_sync(kFull, win, static_cast<int>(jj - cur_base) & 31);
  }

  // Where row rr's window is centred: k - lo(top score of row rr) where the
  // chunks held have that score, else the current diagonal.
  __device__ __forceinline__ long long centre(int rr) {
    if constexpr (kBanded) {
      const int sc = min(8 * rr + 7, lo_stride - 1);
      if (sc >= c0) {
        return static_cast<long long>(k) - __shfl_sync(kFull, lo_cur, sc - c0);
      }
      if (have_nxt && sc >= c0 - 32) {
        wait_for(g_nxt);
        __syncwarp();   // the entry read below was copied by another lane
        return static_cast<long long>(k) -
               slo[((c0 >> 5) - 1) % kLoChunks * 32 + (sc - c0 + 32)];
      }
    }
    return j;
  }

  // A new lo_trace chunk for score ld (ld < c0): the next two stay in
  // flight.
  __device__ __forceinline__ void switch_chunk(int ld) {
    const int nc = ld & ~31;
    if (have_nxt && nc == c0 - 32) {   // copied 32 and 64 scores ago
      g_cur = g_nxt;
      g_nxt = g_nx2;
    } else {       // the first chunk, or a jump past the next
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      done = g;    // no copy in flight to a ring slot reused below
      g_cur = copy_lo(nc >> 5);
      g_nxt = copy_lo((nc >> 5) - 1);
    }
    c0 = nc;
    have_nxt = c0 >= 32;
    g_nx2 = copy_lo((c0 >> 5) - 2);
    wait_for(g_cur);
    lo_cur = slo[(c0 >> 5) % kLoChunks * 32 + lane];
  }

  // The diagonal of the read at score d: k - lo(d).
  __device__ __forceinline__ long long diagonal() {
    int lo = -(W / 2);
    if constexpr (kBanded) {
      const int ld = min(d, lo_stride - 1);
      if (ld < c0) switch_chunk(ld);
      lo = __shfl_sync(kFull, lo_cur, ld - c0);
    }
    return static_cast<long long>(k) - lo;
  }

  // Enter row r in slot s + 1 with no window of it in flight: load it at
  // the current diagonal and re-issue the rows below it that the slots
  // after it do not hold in order (slot s, the row just left, never does).
  // Copies still in flight are waited for first, so that none lands in a
  // slot after the one that replaces it.
  __device__ __forceinline__ void enter_cold() {
    static_assert(kSlots == 4, "the re-issue below covers 3 rows ahead");
    ++n_cold;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    done = g;
    const int next = (s + 1) % kSlots;
    copy_row(ahead[0], next, r, j);
    if (ahead[1].row != r - 1) {
      copy_row(ahead[1], (s + 2) % kSlots, r - 1, centre(r - 1));
    }
    if (ahead[2].row != r - 2) {
      copy_row(ahead[2], (s + 3) % kSlots, r - 2, centre(r - 2));
    }
    const Window w = ahead[0];
    ahead[0] = ahead[1];
    ahead[1] = ahead[2];
    copy_row(ahead[2], s, r - 3, centre(r - 3));
    use_row(next, w);
  }

  // What a step rarely does, in the order the plain walk checks it: a run
  // of 32 completed stream words to store, the end of the walk (the stream
  // full, or d <= 0), the diagonal's range, a new row, a window the
  // diagonal left.  False when the walk is over.
  __device__ __forceinline__ bool slow_path() {
    if ((p & 511) == 0) {   // 32 stream words complete: store them
      ops[(p >> 4) - 32 + lane] = static_cast<int>(buf);
      flushed = p >> 4;
    }
    if (p >= max_ops) {
      err = true;
      return false;
    }
    if (d <= 0) return false;
    j = diagonal();   // again: a chunk switch may be due
    if (j < 0 || j >= W) {
      err = true;
      return false;
    }
    r = d >> 3;       // r < num_chunks: r only falls
    if (r != R) {     // a new row: slot s + 1 holds it if it was prefetched
      ++n_rows;
      if (ahead[0].row == r) {
        const Window w = ahead[0];
        ahead[0] = ahead[1];
        ahead[1] = ahead[2];
        copy_row(ahead[2], s, r - (kSlots - 1), centre(r - (kSlots - 1)));
        use_row((s + 1) % kSlots, w);
      } else {
        enter_cold();
      }
      R = r;
    }
    if (j < cur_base || j >= cur_base + kSpan) {   // a miss: reload here
      Window w;
      copy_row(w, s, R, j);
      use_row(s, w);
      ++n_miss;
    }
    return true;
  }

  // The walk.  A step's chain is its word's shuffle, the nibble's decode
  // (selects, no branch), lo's shuffle (banded) and one branch on anything
  // rare (slow_path).
  __device__ __forceinline__ void walk() {
    for (int t = 0; t < kSlots - 1; ++t) ahead[t] = Window{-1, 0, 0};
    if (d <= 0) return;
    r = d >> 3;
    if (r >= num_chunks) {   // before any read
      err = true;
      return;
    }
    j = diagonal();
    if (j < 0 || j >= W) {
      err = true;
      return;
    }
    ++n_rows;
    enter_cold();   // into slot 0
    R = r;
    for (;;) {
      bool rare;
      do {   // the steps that stay in the row and its window
        const uint32_t ch = (read_word(j) >> (4 * (d & 7))) & 0xFu;
        // Decode: M takes its source from bits 0-1; I and D close the gap
        // unless their extend bit (2 for I, 3 for D) is set.
        const int from = ch & 3;
        const bool in_m = mat == 0;
        const bool ext = (ch >> (mat + 1)) & 1;
        const int op = in_m ? wfa::kOpSub : 2 * mat - 1;   // INS 1, DEL 3
        k += in_m ? 0 : 2 * mat - 3;                       // I -1, D +1
        d -= in_m ? (from == wfa::kMFromX ? x : 0) : (ext ? e : o + e);
        mat = in_m ? min(from, 2) : (ext ? mat : 0);
        acc |= static_cast<uint32_t>(op) << (2 * (p & 15));
        ++p;
        // A completed stream word goes to its lane's buf.
        const bool full = (p & 15) == 0;
        if (full && lane == (((p >> 4) - 1) & 31)) buf = acc;
        acc = full ? 0u : acc;
        // The next read, assuming nothing rare happened.
        rare = (d <= 0) | (full & (((p >> 4) & 31) == 0)) | (p >= max_ops);
        int lo = -(W / 2);
        if constexpr (kBanded) {
          const int ld = min(d, lo_stride - 1);
          rare |= ld < c0;
          lo = __shfl_sync(kFull, lo_cur, ld - c0);
        }
        j = static_cast<long long>(k) - lo;
        rare |= ((d >> 3) != R) |
                (static_cast<unsigned long long>(j - cur_base) >= kSpan);
      } while (!rare);
      if (!slow_path()) return;
    }
  }

  // The partial last word, then zeros to the end of the row, coalesced.
  __device__ __forceinline__ void flush() {
    const int words = (p >> 4) + ((p & 15) != 0);
    if ((p & 15) != 0 && lane == ((p >> 4) & 31)) buf = acc;
    for (int i = flushed + lane; i < max_ops / wfa::kOpsPerWord; i += 32) {
      ops[i] = i < words ? static_cast<int>(buf) : 0;
    }
  }
};

template <bool kBanded>
__global__ void __launch_bounds__(32 * kMaxWarps)
wfa_traceback_kernel(const int* __restrict__ choice, int num_chunks,
                     const int* __restrict__ lo_trace, int lo_stride,
                     const int* __restrict__ dist,
                     const unsigned char* __restrict__ fin,
                     const int* __restrict__ target_k, int B, int W, int x,
                     int o, int e, int opw, int* __restrict__ out,
                     int* __restrict__ stats) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  int* row = out + static_cast<size_t>(b) * (4 + opw);
  const int distance = dist[b];
  const bool finished = fin[b] != 0;
  const bool walk = finished && distance > 0;

  __shared__ uint32_t s_rows[kMaxWarps][kSlots * kSpan];
  __shared__ int s_lo[kMaxWarps][kLoChunks * 32];
  const int warp = threadIdx.x >> 5;

  Walker<kBanded> w;
  w.srow = s_rows[warp];
  w.slo = s_lo[warp];
  w.table = choice + static_cast<size_t>(b) * W;
  w.row_stride = static_cast<size_t>(B) * W;
  w.lo_row = kBanded ? lo_trace + static_cast<size_t>(b) * lo_stride : nullptr;
  w.lo_stride = lo_stride;
  w.num_chunks = num_chunks;
  w.W = W;
  w.x = x;
  w.o = o;
  w.e = e;
  w.max_ops = opw * wfa::kOpsPerWord;
  w.lane = lane;
  w.ops = row + 4;
  w.d = walk ? distance : 0;
  w.k = target_k[b];
  w.walk();
  w.flush();

  if (lane == 0) {
    const bool ok = !w.err && w.d == 0 && w.k == 0 && w.mat == 0;
    row[0] = distance;
    row[1] = finished ? 1 : 0;
    row[2] = walk ? (ok ? w.p : -1) : 0;
    row[3] = 0;
    if (stats != nullptr) {
      int* s = stats + static_cast<size_t>(b) * kStats;
      s[0] = w.n_rows;
      s[1] = w.n_loads;
      s[2] = w.n_miss;
      s[3] = w.n_cold;
    }
  }
}

}  // namespace

extern "C" {

// K3 on `stream` over B alignments; returns a cudaError_t (0 = ok).
// choice: [num_chunks, B, W] int32 (K2's table); lo_trace: [B, lo_stride]
// int32 by score, or null in exact mode; dist/target_k: [B] int32;
// fin: [B] bool; out: [B, 4 + opw] int32; stats: null or [B, 4] int32, the
// per-walk counters (rows entered, window loads, misses, cold entries).
// warps: walks a block, 1..8.
int wfa_traceback_launch(const void* choice, int num_chunks,
                         const void* lo_trace, int lo_stride, const void* dist,
                         const void* fin, const void* target_k, int B, int W,
                         int x, int o, int e, int opw, void* out, void* stats,
                         int warps, int device, void* stream) {
  if (warps < 1 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + warps - 1) / warps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int*>(choice);
  const auto* lo = static_cast<const int*>(lo_trace);
  const auto* di = static_cast<const int*>(dist);
  const auto* f = static_cast<const unsigned char*>(fin);
  const auto* tk = static_cast<const int*>(target_k);
  auto* rows = static_cast<int*>(out);
  auto* st = static_cast<int*>(stats);
  if (lo != nullptr) {
    wfa_traceback_kernel<true><<<blocks, 32 * warps, 0, s>>>(
        c, num_chunks, lo, lo_stride, di, f, tk, B, W, x, o, e, opw, rows, st);
  } else {
    wfa_traceback_kernel<false><<<blocks, 32 * warps, 0, s>>>(
        c, num_chunks, lo, lo_stride, di, f, tk, B, W, x, o, e, opw, rows, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
