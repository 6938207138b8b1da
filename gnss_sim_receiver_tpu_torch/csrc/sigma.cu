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
// float32 operations (the factor n^3 / 3, the moments 2 Pn n^2, the solve
// 2 nz^3 / 3).  At B = 4096 filters both bounds are microseconds; what
// rules is latency, a chain of dependent column steps.  One warp runs one
// filter: lane i owns row i of each matrix, kept in shared memory with an
// odd pitch (a column is read without bank conflicts), so the column steps
// are warp-synchronous; as many filters share a CTA as 48 KB of shared
// memory hold (at most 8).  n, ny <= 32: one lane per row; the wrapper
// raises above.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/nonlinear.py
// (_sigma_points_plain, _sigma_moments_plain).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxDim = 32;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// an odd row pitch at least n
__host__ __device__ __forceinline__ int pitch(int n) { return n | 1; }

__global__ void sigma_points_kernel(const float* __restrict__ x,
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

__global__ void sigma_predict_kernel(const float* __restrict__ y,
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

__global__ void sigma_update_kernel(
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

// filters per CTA: as many as the shared-memory budget holds, 1 to 8
int warps_for(size_t bytes_per_filter) {
  size_t w = kSmemBudget / (bytes_per_filter ? bytes_per_filter : 1);
  if (w < 1) w = 1;
  if (w > (size_t)kMaxWarps) w = kMaxWarps;
  return (int)w;
}

bool bad_dim(int n) { return n < 1 || n > kMaxDim; }

}  // namespace

extern "C" {

int sigma_points(const float* x, const float* p, float* pts, int batch,
                 int n, float pre, float post, int centre, void* stream) {
  if (batch < 1 || bad_dim(n)) return (int)cudaErrorInvalidValue;
  const size_t per = (size_t)n * pitch(n) * sizeof(float);
  const int warps = warps_for(per);
  sigma_points_kernel<<<(batch + warps - 1) / warps, warps * 32,
                        warps * per, (cudaStream_t)stream>>>(
      x, p, pts, batch, n, pre, post, centre, warps);
  return (int)cudaGetLastError();
}

int sigma_predict_moments(const float* y, const float* w, const float* q,
                          long long q_stride, float* mean, float* cov,
                          int batch, int n_pts, int ny, void* stream) {
  if (batch < 1 || bad_dim(ny) || n_pts < 1 || n_pts > 2 * kMaxDim + 1)
    return (int)cudaErrorInvalidValue;
  const size_t per = (size_t)n_pts * pitch(ny) * sizeof(float);
  const int warps = warps_for(per);
  sigma_predict_kernel<<<(batch + warps - 1) / warps, warps * 32,
                         warps * per, (cudaStream_t)stream>>>(
      y, w, q, q_stride, mean, cov, batch, n_pts, ny, warps);
  return (int)cudaGetLastError();
}

int sigma_update_moments(const float* z, const float* xp, const float* pp,
                         const float* pts, const float* zpts, const float* w,
                         const float* r, long long r_stride, float* x_est,
                         float* p_est, int batch, int n_pts, int nx, int nz,
                         void* stream) {
  if (batch < 1 || bad_dim(nx) || bad_dim(nz) || n_pts < 1
      || n_pts > 2 * kMaxDim + 1)
    return (int)cudaErrorInvalidValue;
  const size_t per = update_floats(n_pts, nx, nz) * sizeof(float);
  const int warps = warps_for(per);
  sigma_update_kernel<<<(batch + warps - 1) / warps, warps * 32,
                        warps * per, (cudaStream_t)stream>>>(
      z, xp, pp, pts, zpts, w, r, r_stride, x_est, p_est, batch, n_pts, nx,
      nz, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
