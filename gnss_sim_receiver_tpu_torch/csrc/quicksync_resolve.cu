// K4b resolve: the QuickSync fold ambiguity, written for Hopper.
//
// Replaces gnss_sim_receiver_tpu/ops/pcps.py:quicksync_resolve (line 183):
// for each channel c, the full-length correlation of one dwell
//
//   mag[c, k] = | sum_i x[i] exp(j w_c t_i) code[c, (i - d_k) mod N] |,
//   w_c = float32(-2 pi) * f_c,   d_k = delay_mod[c] + k * NF,  NF = N / fold
//
// at the `fold` candidates k < fold, then the first largest:
// delay[c] = d_k (not reduced mod N, as the JAX function returns it) and
// its magnitude.
//
// What bounds it on the H100: it reads 12 N + 4 C N bytes (0.04 MB at
// phase 4d's C = 8, N = 2000: 0.00003 ms) and does ~(12 + 4 fold) C N
// operations, so neither: one launch's latency sets its time.  The design:
//
// - One CTA per channel, one launch per call, nothing after it.
// - Each thread forms each of its samples' wiped value once (sincosf of
//   the phase, rounded as the wrapper forms it: w_c first, then w_c t_i),
//   and accumulates it against the code at every candidate of a group of
//   G (the smallest of 4, 8, 16 that holds `fold`; a larger fold loops
//   over groups of 16, forming the wipeoff again for each).
// - A thread takes its samples in batches of U (8192 / (threads G): at
//   N = 2000 and fold 4 one batch of 8 a thread) and issues every load of
//   a batch (t, x and the G code values of each sample; the code indexes
//   need only the delay) before any arithmetic, so that the launch waits
//   on the delay's load and one more round trip, not one per sample.
//
// Measured on an H100 (chip_smoke.py phase 3, tools/probe_resolve.py):
// 0.0042 ms at phase 4d's C = 8, fold 4, N = 2000 against the Triton
// kernel and its tail's 0.0132, about 3 times an empty kernel on the same
// grid (0.0012 to 0.0014).  What remains is a chain of two dependent
// loads (the delay, then the code at the delayed indexes), the sincosf of
// 8 samples a thread and three barriers.  Staging the code row in shared
// memory, so that its copy would not wait on the delay, took 0.0050 to
// 0.0053; 512 threads a CTA ran as fast as 256, 1024 slower.
// - A fixed-order reduction (an XOR tree within each warp, then the warps
//   in order) sums the 2 G partial sums; thread 0 takes the magnitudes,
//   keeps the first largest over the groups (a strict >, so the first k
//   wins a tie) and writes the delay (int32) and the magnitude.
//
// The Triton kernel it replaced (one program per (channel, candidate),
// each forming cos and sin of every sample, then argmax, a cast and a
// gather in torch: about six launches) stays as
// ops/pcps.py:_resolve_reference, on no path.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/pcps.py
// (_resolve_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;

// G candidates a pass over the samples
template <int G>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const float2* __restrict__ x, const float* __restrict__ t,
               const float* __restrict__ code, const float* __restrict__ dop,
               const int* __restrict__ lag, int n, int nf, int fold,
               float neg_two_pi, int* __restrict__ delay_out,
               float* __restrict__ mag_out) {
  // samples a thread a batch, so that a batch covers 8192 / G samples
  constexpr int U = 8192 / (kThreads * G) > 0 ? 8192 / (kThreads * G) : 1;
  __shared__ float part[kWarps][2 * G];
  __shared__ float sums[2 * G];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float w = __fmul_rn(neg_two_pi, dop[c]);
  const float* row = code + (long long)c * n;
  const int lag_c = lag[c];
  float best = -1.0f;                  // thread 0's running first largest
  int best_k = 0;
  for (int k0 = 0; k0 < fold; k0 += G) {
    int d[G];                          // the candidates' delays mod N
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long dd = (long long)lag_c + (long long)(k0 + j) * nf;
      d[j] = (int)(((dd % n) + n) % n);
    }
    float acc_r[G], acc_i[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc_r[j] = acc_i[j] = 0.0f;
    for (int i0 = tid; i0 < n; i0 += kThreads * U) {
      // every load of the batch first (no load waits on another), then
      // the arithmetic
      float tv[U], cv[U][G];
      float2 xv[U];
#pragma unroll
      for (int b = 0; b < U; ++b) {
        const int i = i0 + b * kThreads;
        tv[b] = i < n ? t[i] : 0.0f;
        xv[b] = i < n ? x[i] : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int idx = i - d[j];
          cv[b][j] = (i < n && k0 + j < fold) ? row[idx < 0 ? idx + n : idx]
                                              : 0.0f;
        }
      }
#pragma unroll
      for (int b = 0; b < U; ++b) {
        float s, cs;
        sincosf(__fmul_rn(w, tv[b]), &s, &cs);
        const float re = xv[b].x * cs - xv[b].y * s;
        const float im = xv[b].x * s + xv[b].y * cs;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          acc_r[j] += re * cv[b][j];
          acc_i[j] += im * cv[b][j];
        }
      }
    }
    // fixed-order sums: an XOR tree within the warp, then the warps
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc_r[j] += __shfl_xor_sync(0xffffffffu, acc_r[j], o);
        acc_i[j] += __shfl_xor_sync(0xffffffffu, acc_i[j], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        part[warp][2 * j] = acc_r[j];
        part[warp][2 * j + 1] = acc_i[j];
      }
    }
    __syncthreads();
    if (tid < 2 * G) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) v += part[q][tid];
      sums[tid] = v;
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < G && k0 + j < fold; ++j) {
        const float vr = sums[2 * j], vi = sums[2 * j + 1];
        const float mag = sqrtf(vr * vr + vi * vi);
        if (mag > best) {
          best = mag;
          best_k = k0 + j;
        }
      }
    }
    __syncthreads();                   // part and sums are reused
  }
  if (tid == 0) {
    delay_out[c] = lag_c + best_k * nf;
    mag_out[c] = best;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// x [N] complex64, t [>= N], code [C, N], dop [C] float32, lag [C] int32;
// delay_out [C] int32, mag_out [C] float32.
extern "C" int quicksync_resolve(const void* x, const void* t,
                                 const void* code, const void* dop,
                                 const void* lag, int c, int n, int fold,
                                 float neg_two_pi, void* delay_out,
                                 void* mag_out, void* stream) {
  const int nf = fold > 0 ? n / fold : 0;
  if (c < 1 || n < 1 || fold < 1 || nf < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* xp = (const float2*)x;
  const float* tp = (const float*)t;
  const float* cp = (const float*)code;
  const float* dp = (const float*)dop;
  const int* lp = (const int*)lag;
  int* op = (int*)delay_out;
  float* mp = (float*)mag_out;
  if (fold <= 4)
    resolve_kernel<4><<<c, kThreads, 0, s>>>(xp, tp, cp, dp, lp, n, nf, fold,
                                             neg_two_pi, op, mp);
  else if (fold <= 8)
    resolve_kernel<8><<<c, kThreads, 0, s>>>(xp, tp, cp, dp, lp, n, nf, fold,
                                             neg_two_pi, op, mp);
  else
    resolve_kernel<kMaxGroup><<<c, kThreads, 0, s>>>(
        xp, tp, cp, dp, lp, n, nf, fold, neg_two_pi, op, mp);
  return (int)cudaGetLastError();
}

// An empty kernel on the same grid, the launch floor the resolve is timed
// against.
extern "C" int quicksync_resolve_empty(int c, void* stream) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<c, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
