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

namespace {

// K4b's fold (quicksync_fold_kernel), the same carrier summed over the
// fold's segments, replaces the wipe and fold of
// gnss_sim_receiver_tpu/ops/pcps.py:pcps_quicksync_grid (line 152):
//
//   out[m, d, j] = sum over f < fold of x[m, f NF + j] (cos + j sin)
//                  (w[d] t[f NF + j]),  NF = N / fold, j < NF
//
// What bounds it: at phase 4d's M = 8, D = 41, N = 2000, fold 4 it reads
// 64 KB and writes 1.3 MB (0.00043 ms), so the launch's latency.  The
// Triton fold_kernel it replaced (ops/pcps.py _fold_reference, on no path)
// took one program per (tile, bin, dwell) and cos and sin apart for every
// (dwell, bin, sample): 656,000 at that shape.  Here a CTA owns one bin,
// kFoldLags = 64 folded lags and a slice of kDwells = 8 dwells: its 128
// threads first form the carrier of its lags, one sincosf per (bin,
// sample) of each fold segment, into shared memory (82,000 sincosf at that
// shape), then each thread (2 consecutive lags, 2 dwells) adds its
// rotated samples of every segment into a register accumulator per
// (lag, dwell).  The samples of the first kFoldAhead segments are loaded
// before the carrier is formed, so the two latencies overlap.  x (128 KB
// there) is read with 16-byte loads and stays in L2; out is written with
// 16-byte stores.  The grid is (NF / 64, D, M / kDwells): 328 CTAs at that
// shape.  A first form with the carrier in each thread's registers and 8
// dwells a thread (82 CTAs there) was slower than the Triton kernel; this
// one takes 0.0038 ms against its 0.0055 and an empty kernel's 0.0015 on
// the same grid (chip_smoke.py phase 3; NVIDIA H100 80GB HBM3, 700.00 W).
// Odd NF or N, or an unaligned pointer, takes 8-byte loads and stores.
//
// Numerics: the Triton kernel's.  The phase as the wipe's; the segments
// summed in order f = 0 .. fold - 1 from zero, each rotated sample with the
// Triton kernel's contraction (chip_smoke.py phase 3 holds the two to the
// same bits, and to the plain version _fold_plain within 1e-5 of the
// scale).

// acc + the rotated sample, in the Triton fold_kernel's rounding: the
// product contracted as the wipe's, then one add (the other contractions
// tried on the card, fma(xr, c, fma(-xi, s, acc)) and its kin, differ in
// the last bit)
__device__ __forceinline__ void fold_add(float2& acc, float xr, float xi,
                                         float c, float s) {
  const float2 r = rotate(xr, xi, c, s);
  acc.x = __fadd_rn(acc.x, r.x);
  acc.y = __fadd_rn(acc.y, r.y);
}

constexpr int kFoldLags = 64;       // folded lags a CTA (32 lag pairs)
constexpr int kFoldGroups = kThreads / (kFoldLags / kPerThread);  // 4
constexpr int kFoldSegs = 32;       // segments of carrier in shared memory
constexpr int kFoldAhead = 4;       // segments of samples loaded ahead

__global__ void __launch_bounds__(kThreads)
quicksync_fold_kernel(const float2* __restrict__ x,
                      const float* __restrict__ t,
                      const float* __restrict__ dop, float2* __restrict__ out,
                      int n_dwells, int n_dop, int n, int nf, int fold,
                      float neg_two_pi, int vec) {
  // the carrier of this CTA's lags, kFoldSegs segments at a time
  __shared__ float2 carrier[kFoldSegs][kFoldLags];
  const int d = blockIdx.y;
  const int lag0 = blockIdx.x * kFoldLags;
  const int pair = threadIdx.x % (kFoldLags / kPerThread);
  const int group = threadIdx.x / (kFoldLags / kPerThread);
  const int j0 = lag0 + pair * kPerThread;
  const bool mine = j0 < nf, two = j0 + 1 < nf;
  // this thread's dwells of the CTA's slice: m_lo + group, + kFoldGroups
  constexpr int kMine = kDwells / kFoldGroups;
  const int m_lo = blockIdx.z * kDwells + group;
  const float w = __fmul_rn(neg_two_pi, __ldg(dop + d));
  float2 a[kMine], b[kMine];
#pragma unroll
  for (int k = 0; k < kMine; ++k) a[k] = b[k] = make_float2(0.0f, 0.0f);
  // this thread's samples of kFoldAhead segments are loaded before the
  // carrier they meet is formed, so the two latencies overlap
  float4 ahead[kFoldAhead][kMine];
  auto load = [&](int f) {
#pragma unroll
    for (int u = 0; u < kFoldAhead; ++u)
#pragma unroll
      for (int k = 0; k < kMine; ++k) {
        const int m = m_lo + k * kFoldGroups;
        ahead[u][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (!mine || m >= n_dwells || f + u >= fold) continue;
        const float2* p = x + (long long)m * n + (long long)(f + u) * nf + j0;
        if (vec && two) {
          ahead[u][k] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          const float2 v0 = __ldg(p);
          const float2 v1 = two ? __ldg(p + 1) : make_float2(0.0f, 0.0f);
          ahead[u][k] = make_float4(v0.x, v0.y, v1.x, v1.y);
        }
      }
  };
  load(0);
  for (int f0 = 0; f0 < fold; f0 += kFoldSegs) {
    const int segs = min(kFoldSegs, fold - f0);
    if (f0) __syncthreads();
    for (int e = threadIdx.x; e < segs * kFoldLags; e += kThreads) {
      const int f = e / kFoldLags, j = lag0 + e % kFoldLags;
      float s = 0.0f, c = 1.0f;
      if (j < nf) sincosf(__fmul_rn(w, __ldg(t + (f0 + f) * nf + j)), &s, &c);
      carrier[f][e % kFoldLags] = make_float2(c, s);
    }
    __syncthreads();
    for (int f = 0; f < segs; f += kFoldAhead) {
      float4 v[kFoldAhead][kMine];
#pragma unroll
      for (int u = 0; u < kFoldAhead; ++u)
#pragma unroll
        for (int k = 0; k < kMine; ++k) v[u][k] = ahead[u][k];
      load(f0 + f + kFoldAhead);
      if (!mine) continue;
#pragma unroll
      for (int u = 0; u < kFoldAhead; ++u) {
        if (f + u >= segs) break;
        const float2 cs0 = carrier[f + u][pair * kPerThread];
        const float2 cs1 = carrier[f + u][pair * kPerThread + 1];
#pragma unroll
        for (int k = 0; k < kMine; ++k) {
          if (m_lo + k * kFoldGroups < n_dwells) {
            fold_add(a[k], v[u][k].x, v[u][k].y, cs0.x, cs0.y);
            fold_add(b[k], v[u][k].z, v[u][k].w, cs1.x, cs1.y);
          }
        }
      }
    }
  }
  if (!mine) return;
#pragma unroll
  for (int k = 0; k < kMine; ++k) {
    const int m = m_lo + k * kFoldGroups;
    if (m < n_dwells) {
      float2* dst = out + ((long long)m * n_dop + d) * nf + j0;
      if (vec && two) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(a[k].x, a[k].y, b[k].x, b[k].y);
      } else {
        dst[0] = a[k];
        if (two) dst[1] = b[k];
      }
    }
  }
}

__global__ void empty_kernel() {}

dim3 fold_grid(int n_dwells, int n_dop, int nf) {
  return dim3((unsigned)((nf + kFoldLags - 1) / kFoldLags), (unsigned)n_dop,
              (unsigned)((n_dwells + kDwells - 1) / kDwells));
}

}  // namespace

// K4b's fold: x [M, N] complex64, t [>= fold (N / fold)] float32, dop [D]
// float32 -> out [M, D, N / fold] complex64; neg_two_pi = float32(-2 pi)
extern "C" int quicksync_fold(const void* x, const void* t, const void* dop,
                              void* out, int n_dwells, int n_dop, int n,
                              int fold, float neg_two_pi, void* stream) {
  if (n_dwells < 1 || n_dop < 1 || n_dop > 65535 || fold < 1 || n / fold < 1 ||
      (n_dwells + kDwells - 1) / kDwells > 65535)
    return (int)cudaErrorInvalidValue;
  const int nf = n / fold;
  const int vec = n % 2 == 0 && nf % 2 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  quicksync_fold_kernel<<<fold_grid(n_dwells, n_dop, nf), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)t, (const float*)dop, (float2*)out,
      n_dwells, n_dop, n, nf, fold, neg_two_pi, vec);
  return (int)cudaGetLastError();
}

// An empty kernel on the fold's grid: the launch floor it is timed against.
extern "C" int quicksync_fold_empty(int n_dwells, int n_dop, int nf,
                                    void* stream) {
  if (n_dwells < 1 || n_dop < 1 || nf < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<fold_grid(n_dwells, n_dop, nf), kThreads, 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
