// K10a sigma_points and K10b sigma_moments: the cubature and unscented
// sigma-point Kalman filters, written for Hopper.
//
// Replace gnss_sim_receiver_tpu/ops/nonlinear.py:64 sigma_predict and :80
// sigma_update (over _chol_points_cubature :29, _chol_points_unscented :39
// and _propagate :54): everything around the user's model function, which
// the port applies to every point of every filter at once (torch.func.vmap).
//
// K10a, per filter: A = pre * P, its lower Cholesky factor A = L L^T, then
// the points
//   centre:   x                          (unscented only)
//   plus i:   x + post * L[:, i]         i < n
//   minus i:  x - post * L[:, i]
// with pre = 1, post = sqrt(n) (cubature) or pre = n + kappa, post = 1
// (unscented).  A factor of 1 is exact, so both rules round as the JAX
// functions do: one multiply, then one add.  A matrix that is not positive
// definite gives NaN points but the centre (JAX's cholesky returns NaN).
//
// K10b, per filter, the weighted moments of the propagated points y_p with
// the weights w_p (the unscented centre weight may be negative: it is
// carried as given):
//   time update:         m = sum_p w_p y_p,   d_p = y_p - m,
//                        P = sum_p (w_p d_p) d_p^T + Q
//   measurement update:  z_m, e_p = z_p - z_m, f_p = pts_p - x,
//                        P_zz = sum_p (w_p e_p) e_p^T + R,
//                        P_xz = sum_p (w_p f_p) e_p^T,
//                        K^T = solve(P_zz^T, P_xz^T) by LU with partial
//                        pivoting (LAPACK's getrf then getrs, as
//                        jnp.linalg.solve: the first row of largest |.|
//                        pivots, the multipliers scale by the pivot's
//                        reciprocal, the back substitution divides),
//                        x + K (z - z_m),  P - (K P_zz) K^T,  0.5 (P + P^T).
//
// What bounds it on the H100: per filter it reads P (or the points) and
// writes the points (or x and P), about 1 KB at n = 4, against about 1,500
// float32 operations.  At B = 4096 filters both bounds are below a
// microsecond; what rules is latency: the loads' round trip, then a chain
// of dependent column steps (the factor's, the LU's, the substitution's).
//
// The design, by the lane group G (sigma_plan.cuh's group_for): the next
// power of two >= the filter's largest dimension (n for K10a, ny for the
// time update, max(nx, nz) for the measurement update) and >= half its
// points (a lane holds at most 2 G + 1 points):
//
// - G <= kMaxLaneGroup (16): a filter is a group of G lanes, 32 / G
//   filters a warp, kThreads / G a CTA (at n = 4 eight filters a warp; at
//   n = 1 a thread is a filter).  Lane c keeps in registers what the
//   column steps read: K10a row c of A (then of L); the time update
//   component c of every point; the measurement update component c of
//   every point's deviations, then column c of P_zz^T (row c of P_zz) and
//   of P_xz^T, which the LU and the substitution factor in place, so that
//   lane c ends with row c of K.  The kernels are instantiated on G: every
//   loop unrolls over G (or 2 G + 1 points) and leaves at the launch's
//   dimension, and a value of another lane comes by
//   __shfl_sync(..., width = G), never through shared memory.  Every load
//   of a filter is issued before the first add (a row of P as 16-byte
//   loads where n is a multiple of 4), and each thread reads the [Pn]
//   weights once, at the start, into registers.  At G = 16 the
//   measurement update is held to 128 registers (sigma_update_lanes).
// - G = 32 (n from 17 to 32, or more than 33 points): the replaced
//   one-warp-a-filter kernels below (sigma_*_warp_kernel) at their own
//   plan, as many filters a CTA as 48 KB of shared memory hold, at most 8
//   (the sigma_*_reference launchers), lane i owning row i of each matrix
//   in shared memory with an odd pitch; at these n at least 17 of a warp's
//   32 lanes work, and the 2 G + 1 points of the measurement update would
//   not fit in registers.  The same launchers are the reference every G is
//   held to (on no other path).
//
// Each element's operations keep the reference kernels' order, so that
// both give the same bits (chip_smoke.py phase 3 holds them so): the
// points added in order p = 0 .. Pn - 1 with one fused multiply-add each;
// (w_p d_pi) d_pj formed for both triangles; the factor's s -= L[i][k]
// L[j][k] in k order, then sqrtf and an IEEE division; the LU's first
// largest |.| pivot (for a column without NaN), the multipliers by the
// pivot's reciprocal, the back substitution by division; the posterior
// symmetrised as __fmul_rn(0.5, __fadd_rn(.)).  What moves is only where
// an operand lives: a multiply-add whose operands trade places (a b + s
// against b a + s) rounds the same.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/nonlinear.py
// (_sigma_points_plain, _sigma_moments_plain).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sigma_plan.cuh"

namespace {

using namespace sigma_plan;

constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---- G = 32 and the reference: one warp a filter --------------------------

// an odd row pitch at least n
__host__ __device__ __forceinline__ int pitch(int n) { return n | 1; }

__global__ void sigma_points_warp_kernel(const float* __restrict__ x,
                                    const float* __restrict__ p,
                                    float* __restrict__ pts, int batch, int n,
                                    float pre, float post, int centre,
                                    int warps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * warps + warp;
  if (b >= batch) return;
  const int ld = pitch(n);
  float* a = smem + (size_t)warp * n * ld;
  const float* pb = p + (size_t)b * n * n;
  for (int e = lane; e < n * n; e += 32)
    a[(e / n) * ld + e % n] = __fmul_rn(pre, pb[e]);
  __syncwarp();
  // column by column: lane i >= j forms a[i][j] - sum_k<j L[i][k] L[j][k]
  bool bad = false;
  for (int j = 0; j < n; ++j) {
    float s = 0.0f;
    if (lane >= j && lane < n) {
      s = a[lane * ld + j];
      for (int k = 0; k < j; ++k) s -= a[lane * ld + k] * a[j * ld + k];
    }
    const float diag = __shfl_sync(kFull, s, j);
    bad = bad || !(diag > 0.0f);
    const float d = sqrtf(diag);
    if (lane == j)
      a[j * ld + j] = d;
    else if (lane > j && lane < n)
      a[lane * ld + j] = s / d;
    __syncwarp();
  }
  if (lane >= n) return;
  const float nan = __int_as_float(0x7fffffff);
  const float xi = x[(size_t)b * n + lane];
  float* out = pts + (size_t)b * (2 * n + centre) * n;
  if (centre) out[lane] = xi;
  for (int i = 0; i < n; ++i) {
    // row `lane` of column i of L (0 above the diagonal)
    const float l = lane >= i ? a[lane * ld + i] : 0.0f;
    const float s = bad ? nan : __fmul_rn(post, l);
    out[(centre + i) * n + lane] = __fadd_rn(xi, s);
    out[(centre + n + i) * n + lane] = __fsub_rn(xi, s);
  }
}

__global__ void sigma_predict_warp_kernel(const float* __restrict__ y,
                                     const float* __restrict__ w,
                                     const float* __restrict__ q,
                                     long long q_stride,
                                     float* __restrict__ mean,
                                     float* __restrict__ cov, int batch,
                                     int n_pts, int ny, int warps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * warps + warp;
  if (b >= batch) return;
  const int ld = pitch(ny);
  float* d = smem + (size_t)warp * n_pts * ld;          // [n_pts][ld]
  const float* yb = y + (size_t)b * n_pts * ny;
  float m = 0.0f;
  if (lane < ny) {
    for (int p = 0; p < n_pts; ++p) m += w[p] * yb[p * ny + lane];
    for (int p = 0; p < n_pts; ++p) d[p * ld + lane] = yb[p * ny + lane] - m;
  }
  __syncwarp();
  if (lane >= ny) return;
  mean[(size_t)b * ny + lane] = m;
  const float* qb = q + (size_t)b * q_stride;
  float* cb = cov + (size_t)b * ny * ny;
  for (int j = 0; j < ny; ++j) {
    float acc = 0.0f;
    for (int p = 0; p < n_pts; ++p)
      acc += (w[p] * d[p * ld + lane]) * d[p * ld + j];
    cb[lane * ny + j] = acc + qb[lane * ny + j];
  }
}

// the update's shared floats per filter
__host__ __device__ __forceinline__ size_t update_floats(int n_pts, int nx,
                                                         int nz) {
  const int lx = pitch(nx), lz = pitch(nz);
  return (size_t)n_pts * (lx + lz) + (size_t)nz * (2 * lz + lx)
         + (size_t)nx * (lz + lx) + kMaxDim;
}

__global__ void sigma_update_warp_kernel(
    const float* __restrict__ z, const float* __restrict__ xp,
    const float* __restrict__ pp, const float* __restrict__ pts,
    const float* __restrict__ zpts, const float* __restrict__ w,
    const float* __restrict__ r, long long r_stride,
    float* __restrict__ x_est, float* __restrict__ p_est, int batch,
    int n_pts, int nx, int nz, int warps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * warps + warp;
  if (b >= batch) return;
  const int lx = pitch(nx), lz = pitch(nz);
  float* fd = smem + (size_t)warp * update_floats(n_pts, nx, nz);
  float* ed = fd + n_pts * lx;     // [n_pts][lz] z deviations
  float* pzz = ed + n_pts * lz;    // [nz][lz]    P_zz
  float* lu = pzz + nz * lz;       // [nz][lz]    P_zz^T, then its LU
  float* kt = lu + nz * lz;        // [nz][lx]    P_xz^T, then K^T
  float* tt = kt + nz * lx;        // [nx][lz]    K P_zz
  float* pe = tt + nx * lz;        // [nx][lx]    P - K P_zz K^T
  float* innov = pe + nx * lx;     // [kMaxDim]   z - z_m
  const float* zb = zpts + (size_t)b * n_pts * nz;
  const float* pb = pts + (size_t)b * n_pts * nx;
  const float* xb = xp + (size_t)b * nx;

  // the deviations (lane k: column k)
  if (lane < nz) {
    float zm = 0.0f;
    for (int p = 0; p < n_pts; ++p) zm += w[p] * zb[p * nz + lane];
    for (int p = 0; p < n_pts; ++p)
      ed[p * lz + lane] = zb[p * nz + lane] - zm;
    innov[lane] = z[(size_t)b * nz + lane] - zm;
  }
  if (lane < nx) {
    const float xi = xb[lane];
    for (int p = 0; p < n_pts; ++p)
      fd[p * lx + lane] = pb[p * nx + lane] - xi;
  }
  __syncwarp();
  // P_zz (row k) and its transpose; P_xz^T (row k: column k of P_xz)
  if (lane < nz) {
    const float* rb = r + (size_t)b * r_stride;
    for (int j = 0; j < nz; ++j) {
      float acc = 0.0f;
      for (int p = 0; p < n_pts; ++p)
        acc += (w[p] * ed[p * lz + lane]) * ed[p * lz + j];
      const float v = acc + rb[lane * nz + j];
      pzz[lane * lz + j] = v;
      lu[j * lz + lane] = v;
    }
  }
  if (lane < nx) {
    for (int k = 0; k < nz; ++k) {
      float acc = 0.0f;
      for (int p = 0; p < n_pts; ++p)
        acc += (w[p] * fd[p * lx + lane]) * ed[p * lz + k];
      kt[k * lx + lane] = acc;
    }
  }
  __syncwarp();
  // LU of P_zz^T with partial pivoting; the right-hand sides follow the
  // row swaps and the elimination (getrs' forward substitution)
  for (int k = 0; k < nz; ++k) {
    float v = (lane >= k && lane < nz) ? fabsf(lu[lane * lz + k]) : -1.0f;
    int idx = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, off);
      const int oi = __shfl_down_sync(kFull, idx, off);
      if (ov > v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    const int piv = __shfl_sync(kFull, idx, 0);
    if (piv != k) {
      for (int c = lane; c < nz; c += 32) {
        const float t = lu[k * lz + c];
        lu[k * lz + c] = lu[piv * lz + c];
        lu[piv * lz + c] = t;
      }
      for (int c = lane; c < nx; c += 32) {
        const float t = kt[k * lx + c];
        kt[k * lx + c] = kt[piv * lx + c];
        kt[piv * lx + c] = t;
      }
    }
    __syncwarp();
    if (lane > k && lane < nz) {
      const float l = lu[lane * lz + k] * (1.0f / lu[k * lz + k]);
      lu[lane * lz + k] = l;
      for (int c = k + 1; c < nz; ++c) lu[lane * lz + c] -= l * lu[k * lz + c];
      for (int c = 0; c < nx; ++c) kt[lane * lx + c] -= l * kt[k * lx + c];
    }
    __syncwarp();
  }
  // back substitution, lane c: column c of K^T
  if (lane < nx) {
    for (int k = nz - 1; k >= 0; --k) {
      const float v = kt[k * lx + lane] / lu[k * lz + k];
      kt[k * lx + lane] = v;
      for (int i = 0; i < k; ++i) kt[i * lx + lane] -= v * lu[i * lz + k];
    }
  }
  __syncwarp();
  // K[i][k] = kt[k][i]; lane i: row i of x, K P_zz and P - (K P_zz) K^T
  if (lane < nx) {
    float acc = 0.0f;
    for (int k = 0; k < nz; ++k) acc += kt[k * lx + lane] * innov[k];
    x_est[(size_t)b * nx + lane] = xb[lane] + acc;
    for (int j = 0; j < nz; ++j) {
      float t = 0.0f;
      for (int k = 0; k < nz; ++k) t += kt[k * lx + lane] * pzz[k * lz + j];
      tt[lane * lz + j] = t;
    }
    const float* ppb = pp + (size_t)b * nx * nx;
    for (int j = 0; j < nx; ++j) {
      float mm = 0.0f;
      for (int k = 0; k < nz; ++k) mm += tt[lane * lz + k] * kt[k * lx + j];
      pe[lane * lx + j] = ppb[lane * nx + j] - mm;
    }
  }
  __syncwarp();
  if (lane < nx) {
    float* out = p_est + (size_t)b * nx * nx;
    for (int j = 0; j < nx; ++j)
      out[lane * nx + j] =
          __fmul_rn(0.5f, __fadd_rn(pe[lane * lx + j], pe[j * lx + lane]));
  }
}


// ---- G <= kMaxLaneGroup: a group of G lanes a filter ----------------------

#ifdef SIGMA_PROBE
// %globaltimer stamps (ns) of the lane-group kernels' filters (the first
// 4096), for tools/probe_sigma.py: entry, the loads in (K10a: its row of
// P; the updates: the mean over the points), the column steps done (K10a:
// the factor; the measurement update: the LU and the substitution), the
// stores issued.  A stamp waits for `dep`, a value of the stage it ends.
constexpr int kProbeFilters = 4096, kStamps = 4;
__device__ unsigned long long sigma_stamps[kProbeFilters * kStamps];
__device__ __forceinline__ void stamp(long long b, int c, int i, float dep) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "f"(dep));
  if (c == 0 && b < kProbeFilters) sigma_stamps[b * kStamps + i] = t;
}
#define SIGMA_STAMP(i, dep) stamp(b, c, i, dep)
#else
#define SIGMA_STAMP(i, dep)
#endif

// lane `src` of this lane's group
template <int G, typename T>
__device__ __forceinline__ T from_lane(T v, int src) {
  if constexpr (G == 1)
    return v;
  else
    return __shfl_sync(kFull, v, src, G);
}

// row[k] = src[k] for k < n where `on`, else 0: 16-byte loads where n is
// a multiple of 4 and `src` 16-byte aligned
template <int G>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int n, bool on, float (&row)[G]) {
  if constexpr (G >= 4) {
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        const float4 v = on && 4 * q < n ? __ldg(s4 + q)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        row[4 * q] = v.x;
        row[4 * q + 1] = v.y;
        row[4 * q + 2] = v.z;
        row[4 * q + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) row[k] = on && k < n ? __ldg(src + k) : 0.0f;
}

// The loops below run to G (or 2 G + 1 points, which group_for makes at
// least n_pts) so that every register index is a constant; a dimension
// below G leaves by `break` (uniform: the dimensions are the launch's), so
// no lane issues the steps of a row or a point its filter does not have.

template <int G>
__global__ void __launch_bounds__(kThreads)
    sigma_points_lanes(const float* __restrict__ x,
                       const float* __restrict__ p, float* __restrict__ pts,
                       int batch, int n, float pre, float post, int centre) {
  const int c = threadIdx.x % G;
  const long long b = filter_of(blockIdx.x, threadIdx.x, G);
  const bool on = b < batch && c < n;
  SIGMA_STAMP(0, 0.0f);
  float a[G];
  load_row<G>(p + (b * n + c) * n, n, on, a);
  const float xi = on ? __ldg(x + b * n + c) : 0.0f;
#pragma unroll
  for (int k = 0; k < G; ++k) a[k] = __fmul_rn(pre, a[k]);
  SIGMA_STAMP(1, a[0] + a[G - 1] + xi);
  // right-looking: at column j lane c >= j finishes L[c][j], then each
  // element (c, m), j < m <= c, takes its k = j term: the reference's
  // s -= L[c][k] L[m][k] in the same k order
  bool bad = false;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= n) break;
    const float diag = from_lane<G>(a[j], j);
    bad = bad || !(diag > 0.0f);
    const float d = sqrtf(diag);
    if (c == j)
      a[j] = d;
    else if (c > j)
      a[j] = a[j] / d;
#pragma unroll
    for (int m = j + 1; m < G; ++m) {
      if (m >= n) break;
      const float lm = from_lane<G>(a[j], m);
      if (c >= m) a[m] -= a[j] * lm;
    }
  }
  SIGMA_STAMP(2, bad ? 0.0f : a[G - 1]);
  if (!on) return;
  const float nan = __int_as_float(0x7fffffff);
  float* out = pts + b * (2 * n + centre) * n + c;
  if (centre) out[0] = xi;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i >= n) break;
    // row c of column i of L (0 above the diagonal)
    const float l = c >= i ? a[i] : 0.0f;
    const float s = bad ? nan : __fmul_rn(post, l);
    out[(centre + i) * n] = __fadd_rn(xi, s);
    out[(centre + n + i) * n] = __fsub_rn(xi, s);
  }
  SIGMA_STAMP(3, xi);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    sigma_predict_lanes(const float* __restrict__ y,
                        const float* __restrict__ w,
                        const float* __restrict__ q, long long q_stride,
                        float* __restrict__ mean, float* __restrict__ cov,
                        int batch, int n_pts, int ny) {
  constexpr int P = 2 * G + 1;
  const int c = threadIdx.x % G;
  const long long b = filter_of(blockIdx.x, threadIdx.x, G);
  const bool on = b < batch && c < ny;
  SIGMA_STAMP(0, 0.0f);
  // component c of every point, the weights, row c of Q
  float wr[P], d[P], qr[G];
  const float* yb = y + b * n_pts * ny + c;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= n_pts) break;
    wr[p] = __ldg(w + p);
    d[p] = on ? __ldg(yb + p * ny) : 0.0f;
  }
  load_row<G>(q + b * q_stride + c * ny, ny, on, qr);
  float m = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= n_pts) break;
    m += wr[p] * d[p];
  }
  SIGMA_STAMP(1, m);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= n_pts) break;
    d[p] = d[p] - m;
    wr[p] = wr[p] * d[p];                         // w_p d_pc
  }
  float cv[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= ny) break;
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p >= n_pts) break;
      acc += wr[p] * from_lane<G>(d[p], j);
    }
    cv[j] = acc + qr[j];
  }
  if (!on) return;
  mean[b * ny + c] = m;
  float* cb = cov + (b * ny + c) * ny;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= ny) break;
    cb[j] = cv[j];
  }
  SIGMA_STAMP(3, m);
}

// At G = 16 the update would take 198 registers: two CTAs an SM, so 4096
// filters (512 CTAs) ran in two waves.  Held to 128 (four CTAs an SM, one
// wave) it spills 608 bytes to L1 and runs nx = 9 in 0.0116 ms against
// 0.0156 (PERF.md).
template <int G>
__global__ void __launch_bounds__(kThreads, G >= 16 ? 4 : 1)
    sigma_update_lanes(
    const float* __restrict__ z, const float* __restrict__ xp,
    const float* __restrict__ pp, const float* __restrict__ pts,
    const float* __restrict__ zpts, const float* __restrict__ w,
    const float* __restrict__ r, long long r_stride,
    float* __restrict__ x_est, float* __restrict__ p_est, int batch,
    int n_pts, int nx, int nz) {
  constexpr int P = 2 * G + 1;
  const int c = threadIdx.x % G;
  const long long b = filter_of(blockIdx.x, threadIdx.x, G);
  const bool live = b < batch;
  const bool cz = live && c < nz, cx = live && c < nx;
  SIGMA_STAMP(0, 0.0f);
  // every load first: component c of every z point and every point, the
  // weights, z and x, row c of R, row c and column c of P
  float wr[P], e[P], f[P];
  const float* zb = zpts + b * n_pts * nz + c;
  const float* pb = pts + b * n_pts * nx + c;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= n_pts) break;
    wr[p] = __ldg(w + p);
    e[p] = cz ? __ldg(zb + p * nz) : 0.0f;
    f[p] = cx ? __ldg(pb + p * nx) : 0.0f;
  }
  const float zc = cz ? __ldg(z + b * nz + c) : 0.0f;
  const float xc = cx ? __ldg(xp + b * nx + c) : 0.0f;
  float rr[G], prow[G], pcol[G];
  load_row<G>(r + b * r_stride + c * nz, nz, cz, rr);
  load_row<G>(pp + (b * nx + c) * nx, nx, cx, prow);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= nx) break;
    pcol[j] = cx ? __ldg(pp + (b * nx + j) * nx + c) : 0.0f;
  }

  // the deviations
  float zm = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= n_pts) break;
    zm += wr[p] * e[p];
  }
  SIGMA_STAMP(1, zm);
  const float innov = zc - zm;
  float we[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= n_pts) break;
    e[p] = e[p] - zm;
    f[p] = f[p] - xc;
    we[p] = wr[p] * e[p];                         // w_p e_pc
    wr[p] = wr[p] * f[p];                         // w_p f_pc
  }
  // lane c: row c of P_zz (the reference's lane c), which is column c of
  // lu = P_zz^T, and column c of kt = P_xz^T
  float pz[G], lu[G], kt[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= nz) break;
    float az = 0.0f, ax = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p >= n_pts) break;
      const float ek = from_lane<G>(e[p], k);
      az += we[p] * ek;
      ax += wr[p] * ek;
    }
    pz[k] = az + rr[k];
    lu[k] = pz[k];
    kt[k] = ax;
  }
  // LU of P_zz^T with partial pivoting, column c in lane c; the right-hand
  // sides (columns of kt) follow the row swaps and the elimination
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= nz) break;
    // lane k's column: the first row r >= k of largest |lu[r][k]|
    float best = fabsf(lu[k]);
    int piv = k;
#pragma unroll
    for (int rw = k + 1; rw < G; ++rw) {
      if (rw >= nz) break;
      const float v = fabsf(lu[rw]);
      if (v > best) {
        best = v;
        piv = rw;
      }
    }
    piv = from_lane<G>(piv, k);
#pragma unroll
    for (int rw = k + 1; rw < G; ++rw) {
      if (rw >= nz) break;
      if (rw == piv) {
        const float t = lu[k];
        lu[k] = lu[rw];
        lu[rw] = t;
        const float u = kt[k];
        kt[k] = kt[rw];
        kt[rw] = u;
      }
    }
    const float inv = 1.0f / lu[k];               // lane k: 1 / lu[k][k]
#pragma unroll
    for (int rw = k + 1; rw < G; ++rw) {
      if (rw >= nz) break;
      const float l = from_lane<G>(lu[rw] * inv, k);
      if (c == k)
        lu[rw] = l;
      else if (c > k)
        lu[rw] -= l * lu[k];
      kt[rw] -= l * kt[k];
    }
  }
  // back substitution, column c of K^T: lane c ends with row c of K
#pragma unroll
  for (int k = G - 1; k >= 0; --k) {
    if (k < nz) {
      const float v = kt[k] / from_lane<G>(lu[k], k);
      kt[k] = v;
#pragma unroll
      for (int i = 0; i < k; ++i) kt[i] -= v * from_lane<G>(lu[i], k);
    }
  }
  SIGMA_STAMP(2, kt[0]);
  // row c of x, of K P_zz and of P - (K P_zz) K^T; column c of the last
  // (row c of its transpose), formed as lane j forms row j
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= nz) break;
    acc += kt[k] * from_lane<G>(innov, k);
  }
  float tt[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= nz) break;
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= nz) break;
      t += kt[k] * from_lane<G>(pz[j], k);
    }
    tt[j] = t;
  }
  float out[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= nx) break;
    float mr = 0.0f, mc = 0.0f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= nz) break;
      mr += tt[k] * from_lane<G>(kt[k], j);
      mc += from_lane<G>(tt[k], j) * kt[k];
    }
    out[j] = __fmul_rn(0.5f, __fadd_rn(prow[j] - mr, pcol[j] - mc));
  }
  if (!cx) return;
  x_est[b * nx + c] = xc + acc;
  float* ob = p_est + (b * nx + c) * nx;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= nx) break;
    ob[j] = out[j];
  }
  SIGMA_STAMP(3, acc);
}

__global__ void sigma_empty_kernel() {}

// filters per CTA of the reference plan: as many as the shared-memory
// budget holds, 1 to 8
int warps_for(size_t bytes_per_filter) {
  size_t w = kSmemBudget / (bytes_per_filter ? bytes_per_filter : 1);
  if (w < 1) w = 1;
  if (w > (size_t)kMaxWarps) w = kMaxWarps;
  return (int)w;
}

// `kernel` instantiated on the lane group g (<= kMaxLaneGroup), launched
// on its grid
#define SIGMA_LANES(kernel, g, batch, s, ...)                          \
  switch (g) {                                                         \
    case 1:                                                            \
      kernel<1><<<ctas(batch, 1), kThreads, 0, s>>>(__VA_ARGS__);      \
      break;                                                           \
    case 2:                                                            \
      kernel<2><<<ctas(batch, 2), kThreads, 0, s>>>(__VA_ARGS__);      \
      break;                                                           \
    case 4:                                                            \
      kernel<4><<<ctas(batch, 4), kThreads, 0, s>>>(__VA_ARGS__);      \
      break;                                                           \
    case 8:                                                            \
      kernel<8><<<ctas(batch, 8), kThreads, 0, s>>>(__VA_ARGS__);      \
      break;                                                           \
    default:                                                           \
      kernel<16><<<ctas(batch, 16), kThreads, 0, s>>>(__VA_ARGS__);    \
      break;                                                           \
  }

static_assert(kMaxLaneGroup == 16, "SIGMA_LANES' largest group");

}  // namespace

extern "C" {

int sigma_points_reference(const float* x, const float* p, float* pts,
                           int batch, int n, float pre, float post,
                           int centre, void* stream);
int sigma_predict_moments_reference(const float* y, const float* w,
                                    const float* q, long long q_stride,
                                    float* mean, float* cov, int batch,
                                    int n_pts, int ny, void* stream);
int sigma_update_moments_reference(const float* z, const float* xp,
                                   const float* pp, const float* pts,
                                   const float* zpts, const float* w,
                                   const float* r, long long r_stride,
                                   float* x_est, float* p_est, int batch,
                                   int n_pts, int nx, int nz, void* stream);

int sigma_points(const float* x, const float* p, float* pts, int batch,
                 int n, float pre, float post, int centre, void* stream) {
  if (batch < 1 || bad_dim(n)) return (int)cudaErrorInvalidValue;
  const int g = group_for(n, 2 * n + centre);
  if (g > kMaxLaneGroup)
    return sigma_points_reference(x, p, pts, batch, n, pre, post, centre,
                                  stream);
  cudaStream_t s = (cudaStream_t)stream;
  SIGMA_LANES(sigma_points_lanes, g, batch, s, x, p, pts, batch, n, pre,
              post, centre)
  return (int)cudaGetLastError();
}

int sigma_predict_moments(const float* y, const float* w, const float* q,
                          long long q_stride, float* mean, float* cov,
                          int batch, int n_pts, int ny, void* stream) {
  if (batch < 1 || bad_dim(ny) || bad_points(n_pts))
    return (int)cudaErrorInvalidValue;
  const int g = group_for(ny, n_pts);
  if (g > kMaxLaneGroup)
    return sigma_predict_moments_reference(y, w, q, q_stride, mean, cov,
                                           batch, n_pts, ny, stream);
  cudaStream_t s = (cudaStream_t)stream;
  SIGMA_LANES(sigma_predict_lanes, g, batch, s, y, w, q, q_stride, mean, cov,
              batch, n_pts, ny)
  return (int)cudaGetLastError();
}

int sigma_update_moments(const float* z, const float* xp, const float* pp,
                         const float* pts, const float* zpts, const float* w,
                         const float* r, long long r_stride, float* x_est,
                         float* p_est, int batch, int n_pts, int nx, int nz,
                         void* stream) {
  if (batch < 1 || bad_dim(nx) || bad_dim(nz) || bad_points(n_pts))
    return (int)cudaErrorInvalidValue;
  const int g = group_for(nx > nz ? nx : nz, n_pts);
  if (g > kMaxLaneGroup)
    return sigma_update_moments_reference(z, xp, pp, pts, zpts, w, r,
                                          r_stride, x_est, p_est, batch,
                                          n_pts, nx, nz, stream);
  cudaStream_t s = (cudaStream_t)stream;
  SIGMA_LANES(sigma_update_lanes, g, batch, s, z, xp, pp, pts, zpts, w, r,
              r_stride, x_est, p_est, batch, n_pts, nx, nz)
  return (int)cudaGetLastError();
}

// An empty kernel on the grid of a lane-group launch at `batch` filters
// whose largest dimension is n and which sum n_pts points (at G = 32,
// kThreads / 32 filters a CTA): the launch floor chip_smoke.py times K10
// against.
int sigma_empty(int batch, int n, int n_pts, void* stream) {
  if (batch < 1 || bad_dim(n) || bad_points(n_pts))
    return (int)cudaErrorInvalidValue;
  sigma_empty_kernel<<<ctas(batch, group_for(n, n_pts)), kThreads, 0,
                       (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

#ifdef SIGMA_PROBE
// The stamps of the last launch, [4096, 4] uint64 ns, into `host` (and
// cleared for the next).
int sigma_stamps_read(void* host) {
  void* dev = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev, sigma_stamps);
  if (err == cudaSuccess)
    err = cudaMemcpy(host, dev, sizeof(sigma_stamps), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(sigma_stamps));
  return (int)err;
}
#endif

// ---- the reference, and G = 32: the one-warp-a-filter kernels at their
// first plan

int sigma_points_reference(const float* x, const float* p, float* pts,
                           int batch, int n, float pre, float post,
                           int centre, void* stream) {
  if (batch < 1 || bad_dim(n)) return (int)cudaErrorInvalidValue;
  const size_t per = (size_t)n * pitch(n) * sizeof(float);
  const int warps = warps_for(per);
  sigma_points_warp_kernel<<<(batch + warps - 1) / warps, warps * 32,
                             warps * per, (cudaStream_t)stream>>>(
      x, p, pts, batch, n, pre, post, centre, warps);
  return (int)cudaGetLastError();
}

int sigma_predict_moments_reference(const float* y, const float* w,
                                    const float* q, long long q_stride,
                                    float* mean, float* cov, int batch,
                                    int n_pts, int ny, void* stream) {
  if (batch < 1 || bad_dim(ny) || bad_points(n_pts))
    return (int)cudaErrorInvalidValue;
  const size_t per = (size_t)n_pts * pitch(ny) * sizeof(float);
  const int warps = warps_for(per);
  sigma_predict_warp_kernel<<<(batch + warps - 1) / warps, warps * 32,
                              warps * per, (cudaStream_t)stream>>>(
      y, w, q, q_stride, mean, cov, batch, n_pts, ny, warps);
  return (int)cudaGetLastError();
}

int sigma_update_moments_reference(const float* z, const float* xp,
                                   const float* pp, const float* pts,
                                   const float* zpts, const float* w,
                                   const float* r, long long r_stride,
                                   float* x_est, float* p_est, int batch,
                                   int n_pts, int nx, int nz, void* stream) {
  if (batch < 1 || bad_dim(nx) || bad_dim(nz) || bad_points(n_pts))
    return (int)cudaErrorInvalidValue;
  const size_t per = update_floats(n_pts, nx, nz) * sizeof(float);
  const int warps = warps_for(per);
  sigma_update_warp_kernel<<<(batch + warps - 1) / warps, warps * 32,
                             warps * per, (cudaStream_t)stream>>>(
      z, xp, pp, pts, zpts, w, r, r_stride, x_est, p_est, batch, n_pts, nx,
      nz, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
