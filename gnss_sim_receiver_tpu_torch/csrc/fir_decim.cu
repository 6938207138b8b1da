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
// against 12 bytes, far below the card's 20 float32 operations per byte, so
// memory bounds it.  Each input sample enters T / dec outputs: a CTA stages
// the kBlock*dec + T - 1 inputs its kBlock outputs need in shared memory,
// mixing each by the LO once while staging, so device memory is read once
// and the reuse is served from shared memory.  One thread forms one output.
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

namespace {

constexpr int kBlock = 256;   // outputs (and threads) per CTA

__global__ void __launch_bounds__(kBlock)
fir_decim_kernel(const float2* __restrict__ x, long long n,
                 const float* __restrict__ taps, int n_taps, int dec,
                 float w, int mix, float2* __restrict__ y, long long n_out) {
  extern __shared__ float2 smem[];
  const int tile_len = kBlock * dec + n_taps - 1;
  float2* tile = smem;
  float* rev = reinterpret_cast<float*>(smem + tile_len);   // taps reversed
  const int pad = n_taps / 2;
  const long long k0 = (long long)blockIdx.x * kBlock;
  const long long m0 = k0 * dec - pad;       // input index of tile[0]

  for (int i = threadIdx.x; i < n_taps; i += kBlock)
    rev[i] = taps[n_taps - 1 - i];
  for (int j = threadIdx.x; j < tile_len; j += kBlock) {
    const long long m = m0 + j;
    float2 v = make_float2(0.0f, 0.0f);
    if (m >= 0 && m < n) {
      v = x[m];
      if (mix) {
        const float ph = __fmul_rn(w, __ll2float_rn(m));
        float s, c;
        sincosf(ph, &s, &c);
        // (v.x + j v.y) * (c + j s)
        const float re = __fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s));
        const float im = __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c));
        v = make_float2(re, im);
      }
    }
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

}  // namespace

extern "C" int fir_decim(const void* x, long long n, const void* taps,
                         int n_taps, int dec, float w, int mix, void* y,
                         long long n_out, void* stream) {
  if (n < 1 || n_taps < 1 || dec < 1 || n_out != (n + dec - 1) / dec)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kBlock * dec + n_taps - 1) * sizeof(float2) +
                      (size_t)n_taps * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_decim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_cta = (n_out + kBlock - 1) / kBlock;
  if (n_cta > 2147483647LL) return (int)cudaErrorInvalidValue;
  fir_decim_kernel<<<(unsigned)n_cta, kBlock, smem, (cudaStream_t)stream>>>(
      (const float2*)x, n, (const float*)taps, n_taps, dec, w, mix,
      (float2*)y, n_out);
  return (int)cudaGetLastError();
}
