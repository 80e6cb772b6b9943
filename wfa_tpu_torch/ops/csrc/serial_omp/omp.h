// Stand-in for <omp.h> when wfa_tpu's native host library is built without
// OpenMP (a host compiler with no OpenMP runtime): the library's
// `#pragma omp` loops then run serially, and this is the one OpenMP call it
// makes.  Used only by wfa_tpu_torch/ops/_build.py::ensure_native.
#pragma once

static inline int omp_get_max_threads(void) { return 1; }
