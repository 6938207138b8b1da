// K5a: LO mix -> real-tap FIR -> decimate, written for Hopper.
//
// Replaces gnss_sim_receiver_tpu/ops/filters.py:fir_filter (line 29) and
// freq_xlating_fir_filter (line 46), the conditioner's input filter:
//
//   lo[m]  = exp(j * (w * float32(m)))            w = -2 pi fc / fs, float32
//   xp[m]  = x[m - pad] * lo[m - pad]             zero outside [0, N)
//   y[k]   = sum_{i < T} taps[T-1-i] * xp[k*dec + i]     k < ceil(N / dec)
//
// with pad = T / 2: true convolution centred on input k*dec, the real and
// the imaginary plane filtered apart by real float32 taps.  Without mixing
// (fir_filter) lo is 1.
//
// What bounds it on the H100: it reads 8 N bytes and writes 8 N / dec; with
// T = 31 taps and dec = 2 that is 4 T / dec = 62 operations per input sample
// against 12 bytes, below the card's 20 float32 operations per byte, so
// device memory bounds it (0.373 ms at N = 104 M).  Each input sample enters
// T / dec outputs, and that reuse has to be served from on-chip memory at
// the rate the FMAs consume it.
//
// The design (redesigned for the H100; the one-output-a-thread kernel it
// replaces stays below as fir_decim_reference_kernel):
// - A CTA of kThreads threads stages the kThreads * R * dec + T - 1 inputs
//   its kThreads * R outputs need in shared memory, read from device memory
//   once with 16-byte loads of two complex samples and mixed by the LO once
//   per sample while staging.  The halo of T - 1 inputs is read again by the
//   next CTA, from L2 (3 % of the tile at dec 2, R 4).
// - The tile is kept as two planes (real, imaginary) of 4-byte words with
//   one pad word after every S = R * dec words: thread t's window starts at
//   word t * (S + 1) of its plane, and S + 1 is odd, so the 32 threads of a
//   warp read 32 different banks for every window word (no conflicts).
// - Each thread forms R consecutive outputs.  The taps are taken in blocks
//   of S: for a block it loads the (R - 1) * dec + S window words of each
//   plane into registers once and runs S taps x R outputs x 2 planes of
//   FMAs on them, the tap a broadcast read.  At T = 31, dec 2, R 4 that is
//   2 x 14 window reads and 8 tap reads per 64 FMAs, against 2 reads of a
//   64-bit word (4 wavefronts each at a 16-byte thread stride) per 2 FMAs in
//   the kernel it replaces, whose shared-memory wavefronts set its pace.
// - Each output is still acc = fmaf(taps[T-1-i], xp[k*dec + i], acc) for
//   i = 0 .. T-1 from 0.0f, plane by plane, and the LO the same rounded
//   operations once per sample, so the kernel gives the reference's bits.
//   (A polyphase split or a reordered tap sum would change the rounding.)
// - R is a compile-time constant per decimation (FIR_R_DEC1, _DEC2, _DEC4),
//   the fastest of tools/probe_fir_decim.py's sweep on an H100 at N = 104 M,
//   T = 31 (PERF.md): R = 4 at dec 2 took 0.434 ms against R = 8's 0.506
//   (87 registers, 20 warps an SM against 40 at R = 4).  Any other
//   decimation runs the one-output-a-thread kernel, which takes any dec.
//
// The LO phase is float32(w * float32(m)) by one rounded multiply, as the
// JAX function computes it (above 2^24 samples float32(m) no longer holds
// every integer; the kernel reproduces that, it does not repair it).  The
// library is built without --use_fast_math: the phase reaches millions of
// radians and needs sincosf's full argument reduction.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/filters.py
// (_fir_plain, _mix_plain).

#include <cuda_runtime.h>
#include <stdint.h>

// outputs a thread of the blocked kernel forms, per decimation
#ifndef FIR_R_DEC1
#define FIR_R_DEC1 8
#endif
#ifndef FIR_R_DEC2
#define FIR_R_DEC2 4
#endif
#ifndef FIR_R_DEC4
#define FIR_R_DEC4 4
#endif

namespace {

constexpr int kThreads = 128;  // threads per CTA of the blocked kernel
constexpr int kBlock = 256;    // outputs (threads) per CTA of the reference

// input sample m, mixed by the LO when `mix` ((v.x + j v.y) * (c + j s))
__device__ __forceinline__ float2 mixed(float2 v, long long m, float w,
                                        int mix) {
  if (!mix) return v;
  const float ph = __fmul_rn(w, __ll2float_rn(m));
  float s, c;
  sincosf(ph, &s, &c);
  return make_float2(__fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s)),
                     __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c)));
}

// S taps (FULL) or the first `lim` of them, from window words wr/wi, into
// the R outputs' sums
template <int DEC, int R, bool FULL, int W>
__device__ __forceinline__ void taps_block(const float* tp, int lim,
                                           const float (&wr)[W],
                                           const float (&wi)[W],
                                           float (&ar)[R], float (&ai)[R]) {
  constexpr int S = R * DEC;
#pragma unroll
  for (int u = 0; u < S; ++u) {
    if (FULL || u < lim) {
      const float tap = tp[u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ar[r] = fmaf(tap, wr[r * DEC + u], ar[r]);
        ai[r] = fmaf(tap, wi[r * DEC + u], ai[r]);
      }
    }
  }
}

// words of one plane of the blocked kernel's tile, for nb tap blocks
__host__ __device__ constexpr int plane_words(int s, int nb) {
  return (kThreads + nb + 1) * (s + 1);
}

// pairs of samples a thread stages in one batch of loads
template <int S>
constexpr int kBatch = S / 2 + 1;

template <int DEC, int R>
__global__ void __launch_bounds__(kThreads)
fir_decim_blocked_kernel(const float2* __restrict__ x, long long n,
                         const float* __restrict__ taps, int n_taps, float w,
                         int mix, int vec, float2* __restrict__ y,
                         long long n_out) {
  constexpr int S = R * DEC;            // a thread's inputs; taps a block
  constexpr int W = (R - 1) * DEC + S;  // a tap block's window words
  constexpr int B = kBatch<S>;
  static_assert(S % 2 == 0, "the skew needs S + 1 odd");
  static_assert(R % 2 == 0, "outputs are stored in pairs");
  extern __shared__ float smem[];
  const int nb = (n_taps + S - 1) / S;
  const int pl = plane_words(S, nb);
  float* sre = smem;
  float* sim = smem + pl;
  float* rev = smem + 2 * pl;                 // taps reversed
  const int pad = n_taps / 2;
  const long long k0 = (long long)blockIdx.x * (kThreads * R);
  const long long m0 = k0 * DEC - pad;       // input index of tile word 0
  const int len = kThreads * S + n_taps - 1;

  for (int i = threadIdx.x; i < n_taps; i += kThreads)
    rev[i] = taps[n_taps - 1 - i];
  // the tile from the even input index a0 <= m0, two samples a load: pair
  // q holds inputs a0 + 2q and a0 + 2q + 1, tile words 2q - e and 2q - e + 1
  const int e = (int)(m0 & 1);
  const long long a0 = m0 - e;
  const int n_pairs = (len + e + 1) / 2;
  for (int q0 = 0; q0 < n_pairs; q0 += B * kThreads) {
    float4 v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int q = q0 + b * kThreads + threadIdx.x;
      const long long m = a0 + 2 * q;
      v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q >= n_pairs) continue;
      if (vec && m >= 0 && m + 1 < n) {
        v[b] = __ldg(reinterpret_cast<const float4*>(x + m));
      } else {
        if (m >= 0 && m < n) {
          const float2 s = x[m];
          v[b].x = s.x;
          v[b].y = s.y;
        }
        if (m + 1 >= 0 && m + 1 < n) {
          const float2 s = x[m + 1];
          v[b].z = s.x;
          v[b].w = s.y;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int q = q0 + b * kThreads + threadIdx.x;
      if (q >= n_pairs) continue;
      const long long m = a0 + 2 * q;
      const int j = 2 * q - e;
      if (j >= 0) {
        float2 s = make_float2(v[b].x, v[b].y);
        if (m >= 0 && m < n) s = mixed(s, m, w, mix);
        sre[j + j / S] = s.x;
        sim[j + j / S] = s.y;
      }
      if (j + 1 < len) {
        float2 s = make_float2(v[b].z, v[b].w);
        if (m + 1 >= 0 && m + 1 < n) s = mixed(s, m + 1, w, mix);
        sre[j + 1 + (j + 1) / S] = s.x;
        sim[j + 1 + (j + 1) / S] = s.y;
      }
    }
  }
  __syncthreads();

  // output k0 + t R + r, tap i = blk S + u reads tile word t S + blk S +
  // r dec + u, at plane index (t + blk)(S + 1) + j + j / S, j = r dec + u
  float ar[R], ai[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0.0f;
  for (int blk = 0; blk < nb; ++blk) {
    const float* pr = sre + (threadIdx.x + blk) * (S + 1);
    const float* pi = sim + (threadIdx.x + blk) * (S + 1);
    float wr[W], wi[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      wr[j] = pr[j + j / S];
      wi[j] = pi[j + j / S];
    }
    const int lim = n_taps - blk * S;
    if (lim >= S)
      taps_block<DEC, R, true>(rev + blk * S, lim, wr, wi, ar, ai);
    else
      taps_block<DEC, R, false>(rev + blk * S, lim, wr, wi, ar, ai);
  }

  const long long k = k0 + (long long)threadIdx.x * R;
  if (k + R <= n_out) {
#pragma unroll
    for (int r = 0; r < R; r += 2)
      *reinterpret_cast<float4*>(y + k + r) =
          make_float4(ar[r], ai[r], ar[r + 1], ai[r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (k + r < n_out) y[k + r] = make_float2(ar[r], ai[r]);
  }
}

// The kernel before its redesign: one thread an output, the tile
// interleaved, every tap's input read from shared memory.  Any decimation.
__global__ void __launch_bounds__(kBlock)
fir_decim_reference_kernel(const float2* __restrict__ x, long long n,
                           const float* __restrict__ taps, int n_taps,
                           int dec, float w, int mix, float2* __restrict__ y,
                           long long n_out) {
  extern __shared__ float2 smem2[];
  const int tile_len = kBlock * dec + n_taps - 1;
  float2* tile = smem2;
  float* rev = reinterpret_cast<float*>(smem2 + tile_len);   // taps reversed
  const int pad = n_taps / 2;
  const long long k0 = (long long)blockIdx.x * kBlock;
  const long long m0 = k0 * dec - pad;       // input index of tile[0]

  for (int i = threadIdx.x; i < n_taps; i += kBlock)
    rev[i] = taps[n_taps - 1 - i];
  for (int j = threadIdx.x; j < tile_len; j += kBlock) {
    const long long m = m0 + j;
    float2 v = make_float2(0.0f, 0.0f);
    if (m >= 0 && m < n) v = mixed(x[m], m, w, mix);
    tile[j] = v;
  }
  __syncthreads();

  const long long k = k0 + threadIdx.x;
  if (k >= n_out) return;
  const float2* win = tile + threadIdx.x * dec;
  float re = 0.0f, im = 0.0f;
  for (int i = 0; i < n_taps; ++i) {
    const float t = rev[i];
    const float2 v = win[i];
    re = fmaf(t, v.x, re);
    im = fmaf(t, v.y, im);
  }
  y[k] = make_float2(re, im);
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DEC, int R>
int launch_blocked(const void* x, long long n, const void* taps, int n_taps,
                   float w, int mix, void* y, long long n_out,
                   cudaStream_t stream) {
  constexpr int S = R * DEC;
  const int nb = (n_taps + S - 1) / S;
  const size_t smem = (size_t)(2 * plane_words(S, nb) + nb * S) *
                      sizeof(float);
  cudaError_t e = set_smem((const void*)fir_decim_blocked_kernel<DEC, R>,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_cta = (n_out + kThreads * R - 1) / (kThreads * R);
  if (n_cta > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  fir_decim_blocked_kernel<DEC, R><<<(unsigned)n_cta, kThreads, smem,
                                     stream>>>(
      (const float2*)x, n, (const float*)taps, n_taps, w, mix, vec,
      (float2*)y, n_out);
  return (int)cudaGetLastError();
}

int launch_reference(const void* x, long long n, const void* taps,
                     int n_taps, int dec, float w, int mix, void* y,
                     long long n_out, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlock * dec + n_taps - 1) * sizeof(float2) +
                      (size_t)n_taps * sizeof(float);
  cudaError_t e = set_smem((const void*)fir_decim_reference_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_cta = (n_out + kBlock - 1) / kBlock;
  if (n_cta > 2147483647LL) return (int)cudaErrorInvalidValue;
  fir_decim_reference_kernel<<<(unsigned)n_cta, kBlock, smem, stream>>>(
      (const float2*)x, n, (const float*)taps, n_taps, dec, w, mix,
      (float2*)y, n_out);
  return (int)cudaGetLastError();
}

bool valid(long long n, int n_taps, int dec, long long n_out, void* y) {
  return n >= 1 && n_taps >= 1 && dec >= 1 &&
         n_out == (n + dec - 1) / dec &&
         (reinterpret_cast<uintptr_t>(y) & 15) == 0;
}

}  // namespace

// K5a: the blocked kernel at decimation 1, 2 and 4, the one-output-a-thread
// kernel at any other
extern "C" int fir_decim(const void* x, long long n, const void* taps,
                         int n_taps, int dec, float w, int mix, void* y,
                         long long n_out, void* stream) {
  if (!valid(n, n_taps, dec, n_out, y)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dec == 1)
    return launch_blocked<1, FIR_R_DEC1>(x, n, taps, n_taps, w, mix, y,
                                         n_out, s);
  if (dec == 2)
    return launch_blocked<2, FIR_R_DEC2>(x, n, taps, n_taps, w, mix, y,
                                         n_out, s);
  if (dec == 4)
    return launch_blocked<4, FIR_R_DEC4>(x, n, taps, n_taps, w, mix, y,
                                         n_out, s);
  return launch_reference(x, n, taps, n_taps, dec, w, mix, y, n_out, s);
}

// the kernel before its redesign at every decimation: the bit-for-bit
// reference of fir_decim (chip_smoke.py phase 3), on no path
extern "C" int fir_decim_reference(const void* x, long long n,
                                   const void* taps, int n_taps, int dec,
                                   float w, int mix, void* y,
                                   long long n_out, void* stream) {
  if (!valid(n, n_taps, dec, n_out, y)) return (int)cudaErrorInvalidValue;
  return launch_reference(x, n, taps, n_taps, dec, w, mix, y, n_out,
                          (cudaStream_t)stream);
}
