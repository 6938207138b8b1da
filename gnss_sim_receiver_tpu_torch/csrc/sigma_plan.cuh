// The launch plan of K10a and K10b (sigma.cu): which lane group G a
// launch takes and which filter each thread of the grid works on.  Plain
// C++ apart from the qualifiers, so that a host compiler builds it too
// (tests/test_torch_nonlinear.py holds the plan with g++).

#pragma once

#ifdef __CUDACC__
#define SIGMA_HD __host__ __device__
#else
#define SIGMA_HD
#endif

namespace sigma_plan {

constexpr int kMaxDim = 32;
constexpr int kThreads = 128;
constexpr int kMaxLaneGroup = 16;

// the next power of two >= n (1 for n <= 1)
SIGMA_HD constexpr int lane_group(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16
                                                                     : 32;
}

// G of a launch whose filters' largest dimension is n and which sums
// n_pts points: a lane holds at most 2 G + 1 points, so G >= n_pts / 2
// too (a time update's ny may be far below the points' state).
SIGMA_HD constexpr int group_for(int n, int n_pts) {
  return lane_group(n > n_pts / 2 ? n : n_pts / 2);
}

SIGMA_HD constexpr bool bad_dim(int n) { return n < 1 || n > kMaxDim; }

SIGMA_HD constexpr bool bad_points(int n_pts) {
  return n_pts < 1 || n_pts > 2 * kMaxDim + 1;
}

// G <= kMaxLaneGroup: kThreads / G filters a CTA, CTAs enough for `batch`
SIGMA_HD constexpr unsigned ctas(int batch, int g) {
  return (unsigned)((batch + kThreads / g - 1) / (kThreads / g));
}

// the filter of thread `thread` of CTA `block` (its lane: thread % g)
SIGMA_HD constexpr long long filter_of(unsigned block, unsigned thread,
                                       int g) {
  return (long long)block * (kThreads / g) + thread / g;
}

}  // namespace sigma_plan
