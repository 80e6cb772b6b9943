// Stand-in for <omp.h> when a host library is built without OpenMP (a host
// compiler with no OpenMP runtime): its `#pragma omp` loops then run
// serially, on one thread, as these calls report.  Used by the serial form
// of the port's native host library (wfa_tpu_torch/ops/_build.py,
// build_native): native/*.cpp, the presort's scan (presort_scan.cpp) and
// the slot packer (pack_slot.cpp).
#pragma once

static inline int omp_get_max_threads(void) { return 1; }
static inline int omp_get_num_threads(void) { return 1; }
