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
// The slab body is the device function k2_slab (multicorrelator.cuh), which
// the per-epoch chunk kernel (csrc/epoch_chunk.cu) runs too; this file's
// kernel is the standalone K2, a thin wrapper over it with the in-launch
// ordered sum.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/correlator.py
// (gather_blocks + correlate_multitap).

#include "multicorrelator.cuh"

namespace {

constexpr int kMaxTaps = kK2MaxTaps;
constexpr int kThreads = kK2Threads;
constexpr float kTwoPi = 6.2831854820251465f;   // float32(2 pi)

// the slab body's per-warp sums
__shared__ float k2_red[kThreads / 32][2 * kMaxTaps + 2];

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
__device__ __forceinline__ float slab_sums(const K2Args& a, int c, int s,
                                           int p, float rcp, float cf,
                                           float rca, float dop, int n_c) {
  const int n_slabs = a.n_slabs;
  const int n_taps = a.n_taps;
  const int table_len = a.table_len;
  const int data_table_len = a.data_table_len;
  const int block_size = a.block_size;
  const float inv_fs = a.inv_fs;
  const float k_ovs = a.k_ovs;
  const float data_ovs = a.data_ovs;
  const float* __restrict__ table = a.codes + (size_t)c * table_len;
  const float* __restrict__ dtable =
      kData ? a.data + (size_t)c * data_table_len : nullptr;
  const int n_out = n_taps + (kData ? 1 : 0);
  const int lo = (int)((long long)s * block_size / n_slabs);
  const int hi = (int)((long long)(s + 1) * block_size / n_slabs);

  const int max_start = a.n_x - block_size;
  p = p < 0 ? 0 : (p > max_start ? max_start : p);
  const float2* __restrict__ xb = a.x + p;
  const float w = __fmul_rn(kTwoPi, dop);     // (2 pi) * dop
  float tap[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) tap[k] = k < n_taps ? a.taps[k] : 0.0f;

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
      const int ra = raw_index(chips_lo, tap[k], k_ovs);
      const int rb = raw_index(chips_hi, tap[k], k_ovs);
      r_lo = min(r_lo, min(ra, rb));
      r_hi = max(r_hi, max(ra, rb));
    }
  }
  float* stage = k2_stage;
  const Span sp = stage_span(stage, a.stage_cap, table, table_len, r_lo,
                             r_hi);
  Span dsp = {0, 0};
  float* dstage = stage + a.stage_cap;
  if (kData) {
    const int ra = raw_index(chips_lo, 0.0f, data_ovs);
    const int rb = raw_index(chips_hi, 0.0f, data_ovs);
    dsp = stage_span(dstage, a.data_stage_cap, dtable, data_table_len,
                     min(ra, rb), max(ra, rb));
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
  if (lane == 0 && n_miss)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.misses),
              (unsigned long long)n_miss);
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    float re = acc_re[k], im = acc_im[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, o);
      im += __shfl_down_sync(0xffffffffu, im, o);
    }
    if (lane == 0) { k2_red[warp][2 * k] = re; k2_red[warp][2 * k + 1] = im; }
  }
  if (kData) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dacc_re += __shfl_down_sync(0xffffffffu, dacc_re, o);
      dacc_im += __shfl_down_sync(0xffffffffu, dacc_im, o);
    }
    if (lane == 0) {
      k2_red[warp][2 * n_taps] = dacc_re;
      k2_red[warp][2 * n_taps + 1] = dacc_im;
    }
  }
  __syncthreads();
  // this CTA's sums: float j of the [K(+1)] complex row
  const int j = threadIdx.x;
  float sum = 0.0f;
  if (j < 2 * n_out) {
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) sum += k2_red[i][j];
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
multicorr_kernel(const __grid_constant__ K2Args a,
                 const int* __restrict__ pos,          // [C]
                 const float* __restrict__ rem_code,   // [C]
                 const float* __restrict__ code_freq,  // [C]
                 const float* __restrict__ rem_carr,   // [C]
                 const float* __restrict__ dop,        // [C]
                 const int* __restrict__ n_samples,    // [C]
                 float2* __restrict__ partials,        // [C, S, K(+1)]
                 unsigned* __restrict__ arrivals,      // [C]
                 float2* __restrict__ out) {           // [C, K(+1)]
  __shared__ bool last;
  const int s = blockIdx.x;
  const int n_slabs = gridDim.x;
  const int c = blockIdx.y;
  const int n_out = a.n_taps + (a.data ? 1 : 0);
  const float sum = k2_slab(a, c, s, pos[c], rem_code[c], code_freq[c],
                            rem_carr[c], dop[c], n_samples[c]);
  float* row = reinterpret_cast<float*>(out + (size_t)c * n_out);
  const int j = threadIdx.x;
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

__device__ float k2_slab(const K2Args& a, int c, int s, int pos,
                         float rem_code, float code_freq, float rem_carr,
                         float dop, int n_samples) {
  return a.data ? slab_sums<true>(a, c, s, pos, rem_code, code_freq,
                                  rem_carr, dop, n_samples)
                : slab_sums<false>(a, c, s, pos, rem_code, code_freq,
                                   rem_carr, dop, n_samples);
}

bool k2_args_invalid(const K2Args& a, int n_ch) {
  return a.n_taps < 1 || a.n_taps > kMaxTaps || n_ch < 1 || n_ch > 65535 ||
         a.table_len < 1 || a.block_size < 1 || a.n_x < a.block_size ||
         (a.data && a.data_table_len < 1) || a.n_slabs < 1 ||
         a.n_slabs > a.block_size || a.stage_cap < 1 ||
         a.data_stage_cap < (a.data ? 1 : 0) || !a.misses;
}

extern "C" int multicorrelate(K2Args a, const void* pos, const void* rem_code,
                              const void* code_freq, const void* rem_carr,
                              const void* dop, const void* n_samples,
                              void* out, int n_ch, void* partials,
                              void* arrivals, void* stream) {
  if (k2_args_invalid(a, n_ch) || !partials || !arrivals)
    return (int)cudaErrorInvalidValue;
  // a stage past the shared memory a launch may take fails the launch
  const size_t smem = sizeof(float) * (size_t)(a.stage_cap + a.data_stage_cap);
  multicorr_kernel<<<dim3(a.n_slabs, n_ch), kThreads, smem,
                     (cudaStream_t)stream>>>(
      a, (const int*)pos, (const float*)rem_code, (const float*)code_freq,
      (const float*)rem_carr, (const float*)dop, (const int*)n_samples,
      (float2*)partials, (unsigned*)arrivals, (float2*)out);
  return (int)cudaGetLastError();
}
