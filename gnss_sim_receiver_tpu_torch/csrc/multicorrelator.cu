// K2: per-epoch multicorrelator, written for Hopper.
//
// Replaces gnss_sim_receiver_tpu/ops/correlator.py:gather_blocks (line 30)
// and correlate_multitap (line 39), as called once per epoch by
// models/tracking.py:_epoch_step (line 376): for every channel c,
//
//   corr[c,k] = sum_{b < n_samples[c]} code[c, idx(c,k,b)]
//                                      * x[pos[c] + b] * exp(-j phase(c,b))
//   phase(c,b) = rem_carr[c] + 2 pi dop[c] b / fs
//   idx(c,k,b) = floor((rem_code[c] + code_freq[c] b / fs + tap[k]) * ovs)
//                mod table_len
//
// with pos clamped to [0, n_x - block_size] as gather_blocks clamps it.
// On a track_pilot chain (tracking.py:398-408, a second correlate_multitap
// with a zero tap on the data code) the same pass also sums
//
//   corr[c,K] = sum_b data[c, idx_d(c,b)] * x[pos[c] + b] * exp(-j phase(c,b))
//   idx_d(c,b) = floor((rem_code[c] + code_freq[c] b / fs + 0) * data_ovs)
//                mod data_table_len
//
// from the channel's data table: the output is then [C, K+1].  The data
// tap is a template parameter, so a launch without a data table runs no
// code for it.
//
// What bounds it on the H100: one epoch reads C blocks of B samples and
// the table entries they touch (at 20 Msps and C = 10, 1.6 MB for Galileo
// E1's B = 80896 and 16 KB per channel of table span), and does one
// sincosf and K+1 floor-index gathers per sample.  The bytes take ~1 us,
// the operations a few; the launch is latency-bound unless each channel's
// samples spread over the card (C = 10 channels against 132 SMs) and the
// gathers hit shared memory instead of L2.
//
// The design:
// - the grid is (S, C): slab s of channel c covers samples
//   [s B/S, (s+1) B/S) of the channel's block (S from the planner in
//   ops/correlator.py, about two CTAs per SM at the 20 Msps shapes, S = 1
//   for small blocks), so the card fills and each thread walks a few
//   samples;
// - each CTA stages the span of the code table its slab touches (the
//   data table's too) in shared memory, wrapped modulo the table length:
//   the span's ends are the same float index expressions at the slab's
//   first and last sample (the index is monotone in the sample), one
//   entry of margin on each side (a span past the table's length stages
//   the whole table).  A gather outside the staged span (a span larger
//   than the planner's capacity) reads the table in global memory: the
//   same value, counted in a debug counter;
// - per sample the arithmetic is the first design's: the NCOs written
//   with explicit round-to-nearest operations in the JAX program's order
//   (no FMA contraction), so the floor indices agree with the plain
//   version's;
// - one launch, a fixed order: each CTA reduces its K(+1) complex sums
//   (warp shuffles, then shared memory) into partials [C, S, K+1], and the
//   last CTA of a channel to arrive (an atomic counter per channel) sums
//   the S partials in slab order into out[c, :] and resets its counter to
//   0 (with S = 1 the one CTA is the last).  The same inputs give the same
//   bits on every launch; no float atomics.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/correlator.py
// (gather_blocks + correlate_multitap).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;
constexpr float kTwoPi = 6.2831854820251465f;   // float32(2 pi)

__device__ __forceinline__ int raw_index(float chips, float tap, float ovs) {
  return (int)floorf(__fmul_rn(__fadd_rn(chips, tap), ovs));
}

__device__ __forceinline__ int wrap(int i, int len) {
  i %= len;
  return i < 0 ? i + len : i;
}

// A table span [r0, r0 + n) staged in shared memory; `r0` a raw (unwrapped)
// floor index, entry j holding table[(r0 + j) mod len].
struct Span {
  int r0;
  int n;
};

__device__ __forceinline__ Span stage_span(
    float* __restrict__ smem, int cap, const float* __restrict__ table,
    int len, int lo_raw, int hi_raw) {
  Span sp;
  sp.r0 = lo_raw - 1;
  const long long want = (long long)hi_raw + 1 - sp.r0 + 1;
  long long n = want < len ? want : len;
  sp.n = (int)(n < cap ? n : cap);
  const int base = wrap(sp.r0, len);
  for (int j = threadIdx.x; j < sp.n; j += kThreads) {
    const int t = base + j;
    smem[j] = table[t >= len ? t - len : t];
  }
  return sp;
}

__device__ __forceinline__ float lookup(
    const float* __restrict__ smem, Span sp, const float* __restrict__ table,
    int len, int raw, unsigned& misses) {
  const int off = raw - sp.r0;
  if ((unsigned)off < (unsigned)sp.n) return smem[off];
  if (sp.n == len) return smem[wrap(off, len)];   // the whole table staged
  ++misses;
  return __ldg(table + wrap(raw, len));
}

template <bool kData>
__global__ void __launch_bounds__(kThreads)
multicorr_kernel(const float2* __restrict__ x, int n_x,
                 const float* __restrict__ codes,      // [C, L]
                 int table_len,
                 const float* __restrict__ taps,       // [K]
                 int n_taps,
                 const int* __restrict__ pos,          // [C]
                 const float* __restrict__ rem_code,   // [C]
                 const float* __restrict__ code_freq,  // [C]
                 const float* __restrict__ rem_carr,   // [C]
                 const float* __restrict__ dop,        // [C]
                 const int* __restrict__ n_samples,    // [C]
                 float inv_fs, float k_ovs, int block_size,
                 const float* __restrict__ data,       // [C, L'] or null
                 int data_table_len, float data_ovs,
                 int stage_cap, int data_stage_cap,
                 float2* __restrict__ partials,        // [C, S, K(+1)]
                 unsigned* __restrict__ arrivals,      // [C]
                 unsigned long long* __restrict__ misses,  // [1]
                 float2* __restrict__ out) {           // [C, K(+1)]
  extern __shared__ float stage[];                     // [cap + data cap]
  __shared__ float red[kThreads / 32][2 * kMaxTaps + 2];
  __shared__ bool last;
  const int s = blockIdx.x;
  const int n_slabs = gridDim.x;
  const int c = blockIdx.y;
  const float* __restrict__ table = codes + (size_t)c * table_len;
  const float* __restrict__ dtable =
      kData ? data + (size_t)c * data_table_len : nullptr;
  const int n_out = n_taps + (kData ? 1 : 0);
  const int lo = (int)((long long)s * block_size / n_slabs);
  const int hi = (int)((long long)(s + 1) * block_size / n_slabs);

  int p = pos[c];
  const int max_start = n_x - block_size;
  p = p < 0 ? 0 : (p > max_start ? max_start : p);
  const float2* xb = x + p;
  const int n_c = n_samples[c];
  const float rcp = rem_code[c];
  const float cf = code_freq[c];
  const float rca = rem_carr[c];
  const float w = __fmul_rn(kTwoPi, dop[c]);   // (2 pi) * dop
  float tap[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) tap[k] = k < n_taps ? taps[k] : 0.0f;

  // the slab's index span: the chips at its first and last sample
  const float chips_lo =
      __fadd_rn(rcp, __fmul_rn(__fmul_rn(cf, (float)lo), inv_fs));
  const float chips_hi =
      __fadd_rn(rcp, __fmul_rn(__fmul_rn(cf, (float)(hi - 1)), inv_fs));
  int r_lo = raw_index(chips_lo, tap[0], k_ovs);
  int r_hi = r_lo;
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    if (k < n_taps) {
      const int a = raw_index(chips_lo, tap[k], k_ovs);
      const int b = raw_index(chips_hi, tap[k], k_ovs);
      r_lo = min(r_lo, min(a, b));
      r_hi = max(r_hi, max(a, b));
    }
  }
  const Span sp = stage_span(stage, stage_cap, table, table_len, r_lo, r_hi);
  Span dsp = {0, 0};
  float* dstage = stage + stage_cap;
  if (kData) {
    const int a = raw_index(chips_lo, 0.0f, data_ovs);
    const int b = raw_index(chips_hi, 0.0f, data_ovs);
    dsp = stage_span(dstage, data_stage_cap, dtable, data_table_len,
                     min(a, b), max(a, b));
  }
  __syncthreads();

  float acc_re[kMaxTaps], acc_im[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) { acc_re[k] = 0.0f; acc_im[k] = 0.0f; }
  float dacc_re = 0.0f, dacc_im = 0.0f;
  unsigned n_miss = 0;

  for (int b = lo + threadIdx.x; b < hi; b += kThreads) {
    const float n = (float)b;
    if (!(n < (float)n_c)) continue;               // integration mask
    const float phase = __fadd_rn(rca, __fmul_rn(__fmul_rn(w, n), inv_fs));
    float sn, co;
    sincosf(phase, &sn, &co);
    const float2 v = xb[b];
    // x * exp(-j phase)
    const float xr = __fadd_rn(__fmul_rn(v.x, co), __fmul_rn(v.y, sn));
    const float xi = __fsub_rn(__fmul_rn(v.y, co), __fmul_rn(v.x, sn));
    const float chips = __fadd_rn(rcp, __fmul_rn(__fmul_rn(cf, n), inv_fs));
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k < n_taps) {
        const float cv = lookup(stage, sp, table, table_len,
                                raw_index(chips, tap[k], k_ovs), n_miss);
        acc_re[k] += cv * xr;
        acc_im[k] += cv * xi;
      }
    }
    if (kData) {                                    // the data prompt
      const float cv = lookup(dstage, dsp, dtable, data_table_len,
                              raw_index(chips, 0.0f, data_ovs), n_miss);
      dacc_re += cv * xr;
      dacc_im += cv * xi;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    n_miss += __shfl_down_sync(0xffffffffu, n_miss, o);
  if (lane == 0 && n_miss) atomicAdd(misses, (unsigned long long)n_miss);
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    float re = acc_re[k], im = acc_im[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, o);
      im += __shfl_down_sync(0xffffffffu, im, o);
    }
    if (lane == 0) { red[warp][2 * k] = re; red[warp][2 * k + 1] = im; }
  }
  if (kData) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dacc_re += __shfl_down_sync(0xffffffffu, dacc_re, o);
      dacc_im += __shfl_down_sync(0xffffffffu, dacc_im, o);
    }
    if (lane == 0) {
      red[warp][2 * n_taps] = dacc_re;
      red[warp][2 * n_taps + 1] = dacc_im;
    }
  }
  __syncthreads();
  // this CTA's sums: float j of the [K(+1)] complex row
  float* row = reinterpret_cast<float*>(out + (size_t)c * n_out);
  const int j = threadIdx.x;
  float sum = 0.0f;
  if (j < 2 * n_out) {
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) sum += red[i][j];
  }
  float* part = reinterpret_cast<float*>(partials + (size_t)c * n_slabs
                                         * n_out);
  if (j < 2 * n_out) part[(size_t)s * 2 * n_out + j] = sum;
  // the CTA's partial is written; one thread publishes it (the barrier
  // orders the other threads' stores before its fence) and counts it
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(arrivals + c, 1u) == (unsigned)(n_slabs - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (j < 2 * n_out) {
    // slab order; this CTA's own partial from its register
    float t = 0.0f;
    for (int i = 0; i < n_slabs; ++i)
      t += i == s ? sum : __ldcg(part + (size_t)i * 2 * n_out + j);
    row[j] = t;
  }
  if (threadIdx.x == 0) arrivals[c] = 0u;
}

}  // namespace

extern "C" int multicorrelate(const void* x, int n_x, const void* codes,
                              int table_len, const void* taps, int n_taps,
                              const void* pos, const void* rem_code,
                              const void* code_freq, const void* rem_carr,
                              const void* dop, const void* n_samples,
                              float inv_fs, float k_ovs, int block_size,
                              const void* data, int data_table_len,
                              float data_ovs, void* out, int n_ch,
                              int n_slabs, int stage_cap, int data_stage_cap,
                              void* partials, void* arrivals, void* misses,
                              void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_ch < 1 || n_ch > 65535 ||
      table_len < 1 || block_size < 1 || n_x < block_size ||
      (data && data_table_len < 1) || n_slabs < 1 || n_slabs > block_size ||
      stage_cap < 1 || data_stage_cap < (data ? 1 : 0) || !partials ||
      !arrivals || !misses)
    return (int)cudaErrorInvalidValue;
  // a stage past the shared memory a launch may take fails the launch
  auto kernel = data ? multicorr_kernel<true> : multicorr_kernel<false>;
  const size_t smem = sizeof(float) * (size_t)(stage_cap + data_stage_cap);
  kernel<<<dim3(n_slabs, n_ch), kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)x, n_x, (const float*)codes, table_len,
      (const float*)taps, n_taps, (const int*)pos, (const float*)rem_code,
      (const float*)code_freq, (const float*)rem_carr, (const float*)dop,
      (const int*)n_samples, inv_fs, k_ovs, block_size, (const float*)data,
      data_table_len, data_ovs, stage_cap, data_stage_cap,
      (float2*)partials, (unsigned*)arrivals, (unsigned long long*)misses,
      (float2*)out);
  return (int)cudaGetLastError();
}
