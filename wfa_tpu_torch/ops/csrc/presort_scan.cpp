// The presort's divergence scan (utils/presort.py::divergence_scores) in one
// native pass over a batch, parallel over pairs where OpenMP is built in.
//
// Same arithmetic as the Python loop, so the scores are bit-identical: for
// each pair, L = min(|p|, |t|); pairs with L < 4k, or whose length in `lens`
// is below `min_len`, score 0.0.  Otherwise the k-mers of the pattern at
// positions 0, step, 2*step, ... < L - k, step = max(1, (L - k) / anchors),
// are looked up in the text's window [max(0, pos - slack),
// min(|t|, pos + k + slack)), slack = min(32 + pos / 8, 192): a hit iff the
// k-mer lies wholly inside the window, as bytes.find(sub, w0, w1) >= 0
// decides.  Bytes are compared as they are (N, lower case), as find does.
// The score is the double 1.0 - hits / max(total, 1).
//
// The sequences are read in place: the caller passes each Python bytes
// object's own buffer and its length.  Built with -fopenmp, or serially
// against csrc/serial_omp/omp.h (ops/_build.py).
#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kK = 12;
constexpr int64_t kAnchors = 32;

double divergence_score(const char* p, int64_t lp, const char* t, int64_t lt) {
  const int64_t L = std::min(lp, lt);
  if (L < 4 * kK) return 0.0;
  const int64_t step = std::max<int64_t>(1, (L - kK) / kAnchors);
  int64_t hits = 0, total = 0;
  for (int64_t pos = 0; pos < L - kK; pos += step) {
    const int64_t slack = std::min<int64_t>(32 + (pos >> 3), 192);
    const int64_t w0 = std::max<int64_t>(0, pos - slack);
    const int64_t w1 = std::min<int64_t>(lt, pos + kK + slack);
    // The window holds at least k + 1 bytes (pos + k < L <= |t|).
    hits += memmem(t + w0, size_t(w1 - w0), p + pos, size_t(kK)) != nullptr;
    ++total;
  }
  return 1.0 - double(hits) / double(std::max<int64_t>(total, 1));
}

}  // namespace

extern "C" {

// Scores n pairs into out[n]; lens may be null (every pair scored).
// Returns the number of threads the scan ran on.
int presort_scan(const char* const* pats, const int64_t* plen,
                 const char* const* txts, const int64_t* tlen,
                 const int64_t* lens, int64_t min_len, int64_t n,
                 double* out) {
  int threads = 1;
#pragma omp parallel
  {
#pragma omp single nowait
    threads = omp_get_num_threads();
#pragma omp for schedule(dynamic, 16)
    for (int64_t i = 0; i < n; ++i) {
      out[i] = lens != nullptr && lens[i] < min_len
                   ? 0.0
                   : divergence_score(pats[i], plen[i], txts[i], tlen[i]);
    }
  }
  return threads;
}

}  // extern "C"
