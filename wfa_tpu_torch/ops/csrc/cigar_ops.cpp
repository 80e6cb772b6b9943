// The chunk loop's CIGAR decode (native.cigar_from_ops_batch): each pair's
// walked op stream, as K3 ships it, replayed into its run-length CIGAR in
// one pass parallel over pairs where OpenMP is built in.
//
// The replay is native/traceback.cpp's emit_cigar and lcp64, copied, so the
// CIGARs are byte for byte that file's wfa_cigar_from_ops_batch (bar a
// stream longer than its row, which that entry reads on past the row and
// this one refuses): the stream holds the walk's edit and gap-close ops
// only, backward, 16 two-bit ops an int32 word; M runs come from the longest
// common prefix, 8 bytes a compare.
//
// What differs is the plumbing.  Each pattern and text is read in place from
// its Python bytes object; the op rows in place, `row_words` words apart, so
// that the caller can pass a strided view of the copy-back rows.  The ops
// are read straight from the words, and run lengths are written by hand
// straight into the output at the pair's own offset (no snprintf, no
// std::string, no heap allocation a pair).  The caller sizes each pair's
// room so that no CIGAR can overflow it: at most 2 n_ops + 1 runs, each at
// most max(p_len, t_len, n_ops) long (the M runs of a pair add up to at most
// t_len), plus one byte.  Then one serial pass moves the CIGARs together,
// each followed by '\n', so that Python decodes the used bytes at once.
// Built with -fopenmp, or serially against csrc/serial_omp/omp.h
// (ops/_build.py).
#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int OP_NOOP = 0, OP_SUB = 2, OP_DEL = 3, OP_M = 4;

// The run open, written out as digits and its op when another op comes.
struct Runs {
  char* out;
  int op = -1;
  int64_t rep = 0;

  explicit Runs(char* o) : out(o) {}

  void push(int o, int64_t count) {
    if (count <= 0) return;
    if (o == op) {
      rep += count;
      return;
    }
    flush();
    op = o;
    rep = count;
  }

  void flush() {
    if (rep > 0 && op >= 0) {
      char digits[20];
      int d = 0;
      for (int64_t r = rep; r; r /= 10) digits[d++] = char('0' + r % 10);
      while (d) *out++ = digits[--d];
      *out++ = "?IXDM"[op];
    }
    rep = 0;
    op = -1;
  }
};

// Longest common prefix of pat[v:] / txt[h:], 8 bytes per XOR compare.
inline int lcp64(const char* pat, int v, int plen, const char* txt, int h,
                 int tlen) {
  int n = std::min(plen - v, tlen - h);
  int acc = 0;
  while (acc + 8 <= n) {
    uint64_t a, b;
    std::memcpy(&a, pat + v + acc, 8);
    std::memcpy(&b, txt + h + acc, 8);
    uint64_t diff = a ^ b;
    if (diff) return acc + (__builtin_ctzll(diff) >> 3);
    acc += 8;
  }
  while (acc < n && pat[v + acc] == txt[h + acc]) ++acc;
  return acc;
}

// Replays the n ops of one backward stream forwards into `out`; returns the
// CIGAR's end.
char* replay(const int32_t* row, int32_t n, const char* pat, int plen,
             const char* txt, int tlen, char* out) {
  Runs cb(out);
  bool extending = false;
  int k2 = 0;
  int off = 0;
  for (int32_t i = n - 1; i >= 0; --i) {
    int op = (row[i >> 4] >> (2 * (i & 15))) & 3;
    if (!extending) {
      int acc = lcp64(pat, off - k2, plen, txt, off, tlen);
      cb.push(OP_M, acc);
      off += acc;
    }
    if (op == OP_DEL) { extending = true; --k2; }
    else if (op == OP_SUB) {
      if (extending) { extending = false; op = OP_NOOP; }
      else ++off;
    } else { extending = true; ++k2; ++off; }
    if (op != OP_NOOP) cb.push(op, 1);
  }
  if (!extending) {
    cb.push(OP_M, lcp64(pat, off - k2, plen, txt, off, tlen));
  }
  cb.flush();
  return cb.out;
}

}  // namespace

extern "C" {

// ops: n rows of opw int32 words, row_words words apart; n_ops [n] (< 0: a
// corrupt walk); finished [n] bytes of 0 or 1; pats, txts: n pointers to the
// sequences and p_len, t_len [n] their lengths; starts [n]: each pair's room
// in `out`, ascending, as described above.  Writes status [n] (1 ok; 0
// unfinished, corrupt, or more ops than the row holds) and lens [n] (the
// CIGAR's bytes, 0 where status is 0), and leaves out[0, sum(lens) + n)
// holding each CIGAR followed by '\n', in pair order.  Returns the number
// of threads it ran on.
int cigar_from_ops(const int32_t* ops, int64_t row_words, int64_t opw,
                   const int32_t* n_ops, const int8_t* finished,
                   const char* const* pats, const int64_t* p_len,
                   const char* const* txts, const int64_t* t_len, int64_t n,
                   const int64_t* starts, char* out, int64_t* lens,
                   int8_t* status) {
  int threads = 1;
#pragma omp parallel
  {
#pragma omp single nowait
    threads = omp_get_num_threads();
#pragma omp for schedule(dynamic, 8)
    for (int64_t b = 0; b < n; ++b) {
      const int32_t k = n_ops[b];
      if (!finished[b] || k < 0 || k > 16 * opw) {
        status[b] = 0;
        lens[b] = 0;
        continue;
      }
      char* dst = out + starts[b];
      lens[b] = replay(ops + b * row_words, k, pats[b], int(p_len[b]),
                       txts[b], int(t_len[b]), dst) - dst;
      status[b] = 1;
    }
  }
  // Each CIGAR moves down or stays: the room before it holds at least the
  // earlier CIGARs and their separators.
  int64_t pos = 0;
  for (int64_t b = 0; b < n; ++b) {
    std::memmove(out + pos, out + starts[b], size_t(lens[b]));
    pos += lens[b];
    out[pos++] = '\n';
  }
  return threads;
}

}  // extern "C"
