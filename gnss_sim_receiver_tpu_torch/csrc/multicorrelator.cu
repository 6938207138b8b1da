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
// tap is a template parameter, so a launch without a data table runs the
// same code as before it existed.
//
// What bounds it on the H100: one epoch of C = 8 channels reads C blocks of
// B = 2048 samples (128 KB) and the channels' code tables (8 x 32 KB), and
// does ~K+1 table/NCO evaluations per sample: a few microseconds of memory
// traffic at most, so a launch is bound by its own latency.  The design
// keeps everything in one launch: one CTA per channel, threads stride over
// the samples computing the carrier NCO with sincosf, the wipeoff and the
// K floor-index gathers from the channel's band-limited table row, and a
// block reduction folds the K complex sums.  The [C, B] gathered block and
// the [C, K, B] code values of the JAX program never reach device memory.
//
// The table row is read through the read-only data cache (__ldg), not
// staged in shared memory: the Galileo E1 table (8184 sub-chips x 8 =
// 261,888 bytes) is larger than the 227 KB of shared memory a CTA may
// have, and a CTA's samples span one code period, i.e. nearly the whole
// row.  Every row (32 KB for GPS L1 C/A, 256 KB for E1) stays resident in
// the 50 MB L2, and the taps of neighbouring samples hit the same lines.
//
// The NCO arithmetic is written with explicit round-to-nearest operations in
// the JAX program's order (no FMA contraction), so the floor indices agree
// with the plain version's.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/correlator.py
// (gather_blocks + correlate_multitap).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;
constexpr float kTwoPi = 6.2831854820251465f;   // float32(2 pi)

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
                 float2* __restrict__ out) {           // [C, K(+1)]
  const int c = blockIdx.x;
  const float* __restrict__ table = codes + (size_t)c * table_len;
  const float* __restrict__ dtable =
      kData ? data + (size_t)c * data_table_len : nullptr;
  const int n_out = n_taps + (kData ? 1 : 0);

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
  float acc_re[kMaxTaps], acc_im[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) { acc_re[k] = 0.0f; acc_im[k] = 0.0f; }
  float dacc_re = 0.0f, dacc_im = 0.0f;

  for (int b = threadIdx.x; b < block_size; b += kThreads) {
    const float n = (float)b;
    if (!(n < (float)n_c)) continue;               // integration mask
    const float phase = __fadd_rn(rca, __fmul_rn(__fmul_rn(w, n), inv_fs));
    float s, co;
    sincosf(phase, &s, &co);
    const float2 v = xb[b];
    // x * exp(-j phase)
    const float xr = __fadd_rn(__fmul_rn(v.x, co), __fmul_rn(v.y, s));
    const float xi = __fsub_rn(__fmul_rn(v.y, co), __fmul_rn(v.x, s));
    const float chips = __fadd_rn(rcp, __fmul_rn(__fmul_rn(cf, n), inv_fs));
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k < n_taps) {
        int idx = (int)floorf(__fmul_rn(__fadd_rn(chips, tap[k]), k_ovs));
        idx %= table_len;
        if (idx < 0) idx += table_len;
        const float cv = __ldg(table + idx);
        acc_re[k] += cv * xr;
        acc_im[k] += cv * xi;
      }
    }
    if (kData) {                                    // the data prompt
      int idx = (int)floorf(__fmul_rn(__fadd_rn(chips, 0.0f), data_ovs));
      idx %= data_table_len;
      if (idx < 0) idx += data_table_len;
      const float cv = __ldg(dtable + idx);
      dacc_re += cv * xr;
      dacc_im += cv * xi;
    }
  }

  __shared__ float red[kThreads / 32][2 * kMaxTaps + 2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
      red[warp][2 * kMaxTaps] = dacc_re;
      red[warp][2 * kMaxTaps + 1] = dacc_im;
    }
  }
  __syncthreads();
  float* row = reinterpret_cast<float*>(out + (size_t)c * n_out);
  if (threadIdx.x < 2 * n_taps) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += red[i][threadIdx.x];
    row[threadIdx.x] = s;
  } else if (kData && threadIdx.x < 2 * n_taps + 2) {
    const int j = 2 * kMaxTaps + threadIdx.x - 2 * n_taps;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += red[i][j];
    row[threadIdx.x] = s;
  }
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
                              void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_ch < 1 || table_len < 1 ||
      block_size < 1 || n_x < block_size || (data && data_table_len < 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = data ? multicorr_kernel<true> : multicorr_kernel<false>;
  kernel<<<n_ch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, n_x, (const float*)codes, table_len,
      (const float*)taps, n_taps, (const int*)pos, (const float*)rem_code,
      (const float*)code_freq, (const float*)rem_carr, (const float*)dop,
      (const int*)n_samples, inv_fs, k_ovs, block_size, (const float*)data,
      data_table_len, data_ovs, (float2*)out);
  return (int)cudaGetLastError();
}
