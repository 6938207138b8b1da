// K5b: second-order IIR notch as a blocked linear-recurrence scan, written
// for Hopper.
//
// Replaces gnss_sim_receiver_tpu/ops/filters.py:notch_filter (line 58), a
// sequential lax.scan over the N samples:
//
//   v[n] = x[n] + b1 x[n-1] + x[n-2]
//   y[n] = v[n] + a1 y[n-1] + a2 y[n-2]          zero initial state
//   out[n] = y[n] / g
//
// on complex samples with real float32 coefficients.
//
// What bounds it on the H100: 16 N bytes (x read, out written) and ~12
// operations per sample, so memory bounds it; but the recurrence is
// sequential in n.  The design cuts the stream into chunks of kChunk samples,
// one thread per chunk, and makes three launches:
//
//   1. notch_chunk_state: every chunk runs the recurrence from a ZERO output
//      state (the input history x[n-1], x[n-2] is real data) and keeps only
//      its end state s_c = (y[last], y[last-1]);
//   2. notch_carry_scan: the true state entering chunk c obeys
//      carry[c+1] = A carry[c] + s_c with A = M^kChunk, M = [[a1, a2], [1, 0]].
//      One warp scans 32 chunks per step (Hillis-Steele over the constant-
//      coefficient recurrence, with the powers A^1..A^32 from the host);
//   3. notch_apply: every chunk runs the recurrence again from its true
//      carry and writes out = y / g.
//
// So x is read twice and out written once (24 N bytes against the 16 N of
// the bound).  A thread walks its chunk sequentially, so a warp's threads
// read addresses kChunk samples apart; the CTA therefore stages sub-tiles of
// kSub samples per chunk through shared memory with 128-byte row segments
// (rows padded by one sample against bank conflicts).
//
// The carries round differently from the sequential scan; with pole radius
// r = 1 - pi bw < 1 the state forgets in ~1/(1-r) samples, so the difference
// does not grow with N.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/filters.py
// (_notch_plain), the sequential recurrence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;     // samples per thread
constexpr int kThreads = 128;   // chunks per CTA
constexpr int kSub = 16;        // samples per chunk staged at a time
constexpr int kRow = kSub + 1;  // padded shared-memory row

struct Coef { float b1, a1, a2, g; };

__device__ __forceinline__ float2 step(const Coef& k, float2 xn, float2 x1,
                                       float2 x2, float2 y1, float2 y2) {
  // ((((xn + b1 x1) + x2) + a1 y1) + a2 y2), the scan body's order
  float2 y;
  y.x = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(xn.x, __fmul_rn(k.b1, x1.x)),
                                      x2.x), __fmul_rn(k.a1, y1.x)),
                  __fmul_rn(k.a2, y2.x));
  y.y = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(xn.y, __fmul_rn(k.b1, x1.y)),
                                      x2.y), __fmul_rn(k.a1, y1.y)),
                  __fmul_rn(k.a2, y2.y));
  return y;
}

// APPLY = false: zero output state, store the chunk's end state.
// APPLY = true:  start from carry[chunk], store out = y / g.
template <bool APPLY>
__global__ void __launch_bounds__(kThreads)
notch_chunk_kernel(const float2* __restrict__ x, long long n, Coef k,
                   const float4* __restrict__ carry,   // [n_chunks] (APPLY)
                   float4* __restrict__ state,         // [n_chunks] (!APPLY)
                   float2* __restrict__ out) {
  __shared__ float2 tile[kThreads * kRow];
  const long long base = (long long)blockIdx.x * kThreads * kChunk;
  const long long chunk = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n0 = chunk * kChunk;
  const float2 zero = make_float2(0.0f, 0.0f);
  float2 x1 = (n0 >= 1 && n0 - 1 < n) ? x[n0 - 1] : zero;
  float2 x2 = (n0 >= 2 && n0 - 2 < n) ? x[n0 - 2] : zero;
  float2 y1 = zero, y2 = zero;
  if (APPLY && n0 < n) {
    const float4 c = carry[chunk];
    y1 = make_float2(c.x, c.y);
    y2 = make_float2(c.z, c.w);
  }
  for (int st = 0; st < kChunk / kSub; ++st) {
    __syncthreads();
    for (int e = threadIdx.x; e < kThreads * kSub; e += kThreads) {
      const int r = e / kSub, j = e % kSub;
      const long long m = base + (long long)r * kChunk + st * kSub + j;
      tile[r * kRow + j] = m < n ? x[m] : zero;
    }
    __syncthreads();
    float2* row = tile + threadIdx.x * kRow;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const float2 xn = row[j];
      const float2 yn = step(k, xn, x1, x2, y1, y2);
      x2 = x1; x1 = xn; y2 = y1; y1 = yn;
      if (APPLY)
        row[j] = make_float2(__fdiv_rn(yn.x, k.g), __fdiv_rn(yn.y, k.g));
    }
    if (APPLY) {
      __syncthreads();
      for (int e = threadIdx.x; e < kThreads * kSub; e += kThreads) {
        const int r = e / kSub, j = e % kSub;
        const long long m = base + (long long)r * kChunk + st * kSub + j;
        if (m < n) out[m] = tile[r * kRow + j];
      }
    }
  }
  if (!APPLY && n0 < n) state[chunk] = make_float4(y1.x, y1.y, y2.x, y2.y);
}

// 2x2 real matrix (row major in a float4) times a complex 2-vector
// (y1.re, y1.im, y2.re, y2.im).
__device__ __forceinline__ float4 matvec(float4 a, float4 v) {
  return make_float4(a.x * v.x + a.y * v.z, a.x * v.y + a.y * v.w,
                     a.z * v.x + a.w * v.z, a.z * v.y + a.w * v.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int d) {
  return make_float4(__shfl_up_sync(0xffffffffu, v.x, d),
                     __shfl_up_sync(0xffffffffu, v.y, d),
                     __shfl_up_sync(0xffffffffu, v.z, d),
                     __shfl_up_sync(0xffffffffu, v.w, d));
}

// One warp.  powers[j] = A^(j+1), j < 32.  carry[0] = 0,
// carry[c+1] = A carry[c] + state[c].
__global__ void __launch_bounds__(32)
notch_carry_scan(const float4* __restrict__ state,
                 const float4* __restrict__ powers, long long n_chunks,
                 float4* __restrict__ carry) {
  const int lane = threadIdx.x;
  const float4 my_pow = powers[lane];                 // A^(lane+1)
  float4 pw[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) pw[b] = powers[(1 << b) - 1];   // A^(2^b)
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 c_in = zero;                                 // carry entering tile
  float4 next = lane < n_chunks ? state[lane] : zero;
  for (long long t0 = 0; t0 < n_chunks; t0 += 32) {
    const long long c = t0 + lane;
    float4 v = next;
    next = c + 32 < n_chunks ? state[c + 32] : zero;  // in flight meanwhile
    // inclusive scan: v_j = sum_{i <= j} A^(j-i) s_i
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const float4 up = shfl_up4(v, 1 << b);
      if (lane >= (1 << b)) v = add4(v, matvec(pw[b], up));
    }
    // carry entering chunk c+1 = A^(lane+1) c_in + v_lane
    const float4 after = add4(matvec(my_pow, c_in), v);
    // carry entering chunk c is the previous lane's `after` (c_in for lane 0)
    float4 before = shfl_up4(after, 1);
    if (lane == 0) before = c_in;
    if (c < n_chunks) carry[c] = before;
    c_in = make_float4(__shfl_sync(0xffffffffu, after.x, 31),
                       __shfl_sync(0xffffffffu, after.y, 31),
                       __shfl_sync(0xffffffffu, after.z, 31),
                       __shfl_sync(0xffffffffu, after.w, 31));
  }
}

}  // namespace

extern "C" int notch_chunk_len() { return kChunk; }

// scratch: 2 * n_chunks float4 (end states, then carries); powers: 32
// float4 on the device, A^(j+1) row major with A = M^kChunk.
extern "C" int notch_filter(const void* x, long long n, float b1, float a1,
                            float a2, float g, const void* powers,
                            void* scratch, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const long long n_cta = (n_chunks + kThreads - 1) / kThreads;
  if (n_cta > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Coef k = {b1, a1, a2, g};
  float4* state = (float4*)scratch;
  float4* carry = state + n_chunks;
  cudaStream_t s = (cudaStream_t)stream;
  notch_chunk_kernel<false><<<(unsigned)n_cta, kThreads, 0, s>>>(
      (const float2*)x, n, k, nullptr, state, nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  notch_carry_scan<<<1, 32, 0, s>>>(state, (const float4*)powers, n_chunks,
                                    carry);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  notch_chunk_kernel<true><<<(unsigned)n_cta, kThreads, 0, s>>>(
      (const float2*)x, n, k, carry, nullptr, (float2*)out);
  return (int)cudaGetLastError();
}
