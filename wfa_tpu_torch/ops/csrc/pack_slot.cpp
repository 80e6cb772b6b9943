// Packs one chunk of the chunk loop (aligner._HostSlot.fill) straight into
// its slot: each pair's pattern and text, read in place from the Python
// bytes objects, into the slot's page-locked words, lengths and validity, in
// one pass parallel over pairs where OpenMP is built in.
//
// The slot's rows [0, n) are bit for bit what ops/packing.py::pack_batch
// gives (native/packing.cpp and its NumPy path): each base is
// (ascii & 6) >> 1, 16 bases a u32 word, the first base in the highest bits;
// bases past nwords * 16 are dropped unchecked; words past a sequence's end
// are zero, since later chunks refill the slot; valid is true where both
// sequences hold only ACGT or acgt in the words, are shorter than
// max_seq_len and fit nwords * 16.
//
// 16 bytes make a word: two 8-byte loads, each byte checked against ACGT in
// either case by exact zero-byte tests (no branch a byte), and the 2-bit
// codes gathered by shifts.  A sequence's last partial word is read from a
// copy padded with 'A' (code 0, valid), so that nothing is read past its
// end.  Built with -fopenmp, or serially against csrc/serial_omp/omp.h
// (ops/_build.py).
#include <omp.h>

#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the 8-byte loads put the first byte lowest");

namespace {

constexpr uint64_t kOnes = 0x0101010101010101ull;
constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7Full;
constexpr uint64_t kHigh = 0x8080808080808080ull;

inline uint64_t load8(const char* s) {
  uint64_t x;
  std::memcpy(&x, s, 8);
  return x;
}

// 0x80 in each byte of x that is zero, 0 in the others (no carry crosses a
// byte: the low seven bits plus 0x7F stay below 0x100).
inline uint64_t zero_bytes(uint64_t x) {
  return ~(((x & kLow7) + kLow7) | x | kLow7);
}

// 0x80 in each byte of x that is A, C, G or T in either case.  Clearing bit
// 5 maps exactly acgt and ACGT onto ACGT.
inline uint64_t acgt_bytes(uint64_t x) {
  const uint64_t u = x & ~(0x20 * kOnes);
  return zero_bytes(u ^ ('A' * kOnes)) | zero_bytes(u ^ ('C' * kOnes)) |
         zero_bytes(u ^ ('G' * kOnes)) | zero_bytes(u ^ ('T' * kOnes));
}

// The 2-bit codes of the 8 bytes of x, the first (lowest) byte's in bits
// 15-14: the byte swap puts it highest, then each round halves the lanes.
inline uint32_t codes8(uint64_t x) {
  uint64_t y = __builtin_bswap64((x >> 1) & (3 * kOnes));
  y = (y | (y >> 6)) & 0x000F000F000F000Full;
  y = (y | (y >> 12)) & 0x000000FF000000FFull;
  return uint32_t((y | (y >> 24)) & 0xFFFF);
}

// One word from 16 bytes; clears bytes that are not ACGT from `ok`.
inline uint32_t word16(const char* s, uint64_t& ok) {
  const uint64_t a = load8(s), b = load8(s + 8);
  ok &= acgt_bytes(a) & acgt_bytes(b);
  return codes8(a) << 16 | codes8(b);
}

// Packs one sequence into out[nwords]; whether it is valid.
bool pack_one(const char* s, int64_t len, int64_t nwords, int64_t max_seq_len,
              uint32_t* out) {
  const int64_t cap = nwords * 16;
  const int64_t use = len < cap ? len : cap;
  const int64_t full = use / 16;
  uint64_t ok = kHigh;
  for (int64_t w = 0; w < full; ++w) out[w] = word16(s + 16 * w, ok);
  int64_t w = full;
  if (use > 16 * full) {
    char pad[16];
    std::memset(pad, 'A', sizeof pad);
    std::memcpy(pad, s + 16 * full, size_t(use - 16 * full));
    out[w++] = word16(pad, ok);
  }
  if (w < nwords) std::memset(out + w, 0, size_t(nwords - w) * sizeof *out);
  return ok == kHigh && len < max_seq_len && len <= cap;
}

}  // namespace

extern "C" {

// Packs n pairs into the slot's rows [0, n): pat and txt [n, nwords] u32,
// pat_len and txt_len [n] i32, valid [n] bytes of 0 or 1.  Returns the
// number of threads it ran on.
int pack_slot(const char* const* pats, const int64_t* plen,
              const char* const* txts, const int64_t* tlen, int64_t n,
              int64_t nwords, int64_t max_seq_len, uint32_t* pat,
              uint32_t* txt, int32_t* pat_len, int32_t* txt_len,
              uint8_t* valid) {
  int threads = 1;
#pragma omp parallel
  {
#pragma omp single nowait
    threads = omp_get_num_threads();
#pragma omp for schedule(dynamic, 16)
    for (int64_t i = 0; i < n; ++i) {
      const bool p_ok =
          pack_one(pats[i], plen[i], nwords, max_seq_len, pat + i * nwords);
      const bool t_ok =
          pack_one(txts[i], tlen[i], nwords, max_seq_len, txt + i * nwords);
      pat_len[i] = int32_t(plen[i]);
      txt_len[i] = int32_t(tlen[i]);
      valid[i] = p_ok && t_ok;
    }
  }
  return threads;
}

}  // extern "C"
