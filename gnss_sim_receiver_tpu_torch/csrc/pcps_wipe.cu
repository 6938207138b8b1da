// K3 / K3b wipeoff: the Doppler-wiped dwells of the PCPS search (the cuFFT
// input), written for Hopper.
//
// Replaces the carrier wipe of gnss_sim_receiver_tpu/ops/pcps.py:pcps_grid
// (line 33) and of the same wipe in pcps_grid_per_channel (:65),
// pcps_8ms_grid (:213), pcps_cccwsr_grid (:242) and
// pcps_e5a_noncoherent_iq_grid (:269):
//
//   w[row]         = float32(-2 pi) * f[row]              (rounded)
//   phase[row, n]  = w[row] * t[n]                        (rounded)
//   out[m, row, n] = x[m, n] * (cos phase + j sin phase)
//
// for dwells m < M, rows < D (a Doppler grid) or C * D2 (a per-channel
// [C, D2] table, row c * D2 + j) and samples n < N, complex64.
//
// What bounds it on the H100: it writes 8 M D N bytes and reads 8 M N
// (10 float32 operations per output, sincos counted as 2): device memory
// at every shape of 10 MB or more (phase 7's M = 2, D = 41, N = 40000:
// 26 MB, 0.0081 ms); at the receivers' N = 2000 (1.3 MB) the launch's
// latency.
//
// The design (redesigned for the H100 from the Triton wipe_kernel of
// ops/pcps.py, which stays as the reference, on no path):
// - A thread owns one row and kPerThread = 2 consecutive samples.  It forms
//   the two phases and one sincosf each (one range reduction for both the
//   cosine and the sine), then loops over the dwells of its CTA's slice:
//   the carrier is computed once per (row, n), not once per dwell.  The
//   Triton kernel took one program per (tile, row, dwell) and evaluated
//   cos and sin apart for every dwell.
// - Per dwell it reads x[m, n .. n+1] with one 16-byte load (the dwells,
//   0.03 to 1.3 MB a row of the grid, stay in L2) and writes
//   out[m, row, n .. n+1] with one 16-byte store: whole 512-byte runs a
//   warp, where the Triton kernel stored the real and the imaginary parts
//   apart, 4 bytes at an 8-byte stride.
// - The grid is (N / 256 samples, rows, M / kDwells): at N = 2000 and
//   41 rows 328 CTAs of 4 warps (2.5 an SM); a large M (the ROC harness's
//   trials as dwells) is cut into slices of kDwells dwells, each slice
//   forming its own carrier, so the grid fills the card there too.
// - Odd N, or a pointer not 16-byte aligned, takes 8-byte loads and
//   stores (`vec` 0); the last thread of a row may hold one sample.
//
// Numerics: the phase is two rounded products in the Triton kernel's order
// (w first, then w * t); sincosf (no --use_fast_math; the phase reaches
// 2 pi x 10 kHz x 8 ms); the product with the Triton kernel's contraction,
// re = fma(xr, c, -(xi * s)) and im = fma(xr, s, xi * c), so that this
// kernel gives the Triton kernel's bits (chip_smoke.py phase 3 holds it to
// them, and to the plain version within 1e-5 of the scale).
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/pcps.py
// (_wipe_plain, _wipe_per_channel_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per CTA
constexpr int kPerThread = 2;   // consecutive samples a thread
constexpr int kDwells = 8;      // dwells a CTA (grid.z covers the rest)

__device__ __forceinline__ float2 rotate(float xr, float xi, float c,
                                         float s) {
  return make_float2(__fmaf_rn(xr, c, -__fmul_rn(xi, s)),
                     __fmaf_rn(xr, s, __fmul_rn(xi, c)));
}

__global__ void __launch_bounds__(kThreads)
pcps_wipe_kernel(const float2* __restrict__ x, const float* __restrict__ t,
                 const float* __restrict__ dop, float2* __restrict__ out,
                 int n_dwells, int rows, int n, float neg_two_pi, int vec) {
  const int row = blockIdx.y;
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (n0 >= n) return;
  const bool two = n0 + 1 < n;
  const int m_lo = blockIdx.z * kDwells;
  const int m_hi = min(n_dwells, m_lo + kDwells);
  const float w = __fmul_rn(neg_two_pi, __ldg(dop + row));
  float s0, c0, s1 = 0.0f, c1 = 1.0f;
  sincosf(__fmul_rn(w, __ldg(t + n0)), &s0, &c0);
  if (two) sincosf(__fmul_rn(w, __ldg(t + n0 + 1)), &s1, &c1);
  if (vec && two) {
#pragma unroll 4
    for (int m = m_lo; m < m_hi; ++m) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          x + (long long)m * n + n0));
      const float2 a = rotate(v.x, v.y, c0, s0);
      const float2 b = rotate(v.z, v.w, c1, s1);
      *reinterpret_cast<float4*>(out + ((long long)m * rows + row) * n +
                                 n0) = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {
    for (int m = m_lo; m < m_hi; ++m) {
      const float2* src = x + (long long)m * n + n0;
      float2* dst = out + ((long long)m * rows + row) * n + n0;
      const float2 v0 = src[0];
      dst[0] = rotate(v0.x, v0.y, c0, s0);
      if (two) {
        const float2 v1 = src[1];
        dst[1] = rotate(v1.x, v1.y, c1, s1);
      }
    }
  }
}

}  // namespace

// x [M, N] complex64, t [N] float32, dop [rows] float32 -> out [M, rows, N]
// complex64; neg_two_pi = float32(-2 pi)
extern "C" int pcps_wipe(const void* x, const void* t, const void* dop,
                         void* out, int n_dwells, int rows, int n,
                         float neg_two_pi, void* stream) {
  if (n_dwells < 1 || rows < 1 || n < 1 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const long long per_cta = (long long)kThreads * kPerThread;
  const long long gx = (n + per_cta - 1) / per_cta;
  const long long gz = (n_dwells + kDwells - 1) / kDwells;
  if (gz > 65535) return (int)cudaErrorInvalidValue;
  const int vec = n % 2 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  pcps_wipe_kernel<<<dim3((unsigned)gx, (unsigned)rows, (unsigned)gz),
                     kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)t, (const float*)dop, (float2*)out,
      n_dwells, rows, n, neg_two_pi, vec);
  return (int)cudaGetLastError();
}
