// K6: device baseband synthesizer, written for Hopper.
//
// Replaces gnss_sim_receiver_tpu/sim/device_generator.py:_expand_chunk
// (line 32, driven by generate_baseband_device at :131 and
// generate_baseband_device_resident at :172): for every output sample i of
// a chunk that starts at anchor block blk0,
//
//   g = blk0 + i / 8192,  nloc = float(i mod 8192)
//   for each satellite s, with the anchors (base, frac, crate, ph0, phr)
//   of (s, g):
//     k    = base + floor(frac + crate * nloc)          (int32)
//     chip = code[s, k mod Lc[s]],  sym = bits[s, (k div sps[s]) mod Nb[s]]
//     ph   = ph0 + phr * nloc
//     y   += amp[s] * chip * sym * (cos ph, sin ph)
//   y += sqrt(1/2) * (n0, n1)           (optional complex AWGN)
//
// written once as interleaved complex64.
//
// What bounds it on the H100: each sample is written once (8 bytes) and
// costs, per satellite, two gathers from int8 tables of a few KB to 92 KB
// and one accurate sincosf; with 9 to 12 satellites instruction issue, not
// the 8-byte store, sets the pace (the bound counts about 20 operations
// per satellite and sample, sincos as 2).  The [S, n] per-satellite planes
// of the JAX program never reach device memory.
//
// The design (redesigned for the H100 from the one-sample-a-thread kernel,
// which stays below as device_generator_reference, the bit-for-bit
// reference, on no path):
// - A CTA makes a tile of kThreads * kPerThread samples inside one anchor
//   block; thread t makes the samples t, t + kThreads, ... of the tile
//   (warp-strided runs: every store is coalesced).  The loop runs over
//   the satellites outside and the thread's samples inside, the sums in
//   registers, so a sample still sums its satellites in order 0..S-1.
// - The anchors and the satellite's constants (table lengths, sub-chips
//   per symbol, amplitude) are loaded once per (thread, satellite), not
//   once per sample: a tile lies in one block, so they are the same for
//   all of a thread's samples.
// - The chip index k mod Lc and the symbol index (k div sps) mod Nb take
//   the floor divisions once per (thread, satellite), at the thread's
//   first sample.  crate > 0, so k never decreases along a block: from one
//   of the thread's samples to the next, k grows by dk = kThreads * crate
//   or about that, and the residues follow by compare-and-subtract (one
//   wrap of the code, at most one symbol edge).  A residue still outside
//   its range after that (a step of about a period or more, or a negative
//   one) falls back to the floor division, so the indices are those of
//   the reference for any anchors, k < 0 included.  tools/k6_sass.py
//   counts the SASS: 182 instructions a (sample, satellite) in the
//   reference, 92 here.
// - The code and bit tables are int8 (the hybrid case's 4 x 1023 + 5 x
//   8184 sub-chips are 74 KB) read through the read-only data cache:
//   neighbouring samples read the same or the next chip, and the tables
//   stay resident in L1 and L2.
//
// Numerics, so that the kernel agrees with its plain version:
// - JAX's jnp.mod and // are floor operations; C's % and / truncate towards
//   zero.  base is negative in the first blocks of a scenario (the signal
//   delay of ~70 ms exceeds t), so the indices use floor-mod and floor-div.
// - floor(frac + crate * nloc) decides the chip edges: the product and the
//   sum are rounded separately (__fmul_rn, __fadd_rn: no FMA contraction),
//   as the plain version's two tensor operations round them.
// - sincosf, not __sincosf (no -use_fast_math): the phase reaches ~130 rad
//   within a block.
// - Both kernels round every operation alike (sincosf, the explicit
//   __fmul_rn / __fadd_rn, the per-sample sum over the satellites in
//   order), so the tiled kernel gives the reference's bits.
// - The noise is counter-based: Philox4x32-10 (Salmon et al., SC'11, the
//   constants of cuRAND's curand_Philox4x32_10) keyed by a 64-bit seed and
//   counted by the absolute sample index, then Box-Muller; the capture does
//   not depend on the tiling or on the chunking.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/sim/device_generator.py
// (_expand_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockLog2 = 13;                    // 8192-sample anchor block
constexpr float kNoiseScale = 0.70710677f;        // float32(sqrt(0.5))

__device__ __forceinline__ int floor_mod(int k, int m) {
  int r = k % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int floor_div(int k, int m) {
  int q = k / m;
  return (k - q * m) < 0 ? q - 1 : q;
}

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
  const uint32_t lo0 = 0xD2511F53u * c.x;
  const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
  const uint32_t lo1 = 0xCD9E8D57u * c.z;
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    c = philox_round(c, k);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return philox_round(c, k);
}

// Box-Muller on the 24-bit uniforms of Philox4x32-10 at the absolute
// sample index `idx`: u1 in (0, 1], u2 in [0, 1)
__device__ __forceinline__ void add_noise(float& re, float& im,
                                          unsigned long long idx,
                                          unsigned long long key) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)idx, (uint32_t)(idx >> 32), 0u, 0u),
      make_uint2((uint32_t)key, (uint32_t)(key >> 32)));
  const float u1 = (float)((r.x >> 8) + 1u) * 5.9604645e-08f;
  const float u2 = (float)(r.y >> 8) * 5.9604645e-08f;
  const float rad = sqrtf(-2.0f * logf(u1));
  float sn, cs;
  sincospif(2.0f * u2, &sn, &cs);
  re = __fadd_rn(re, __fmul_rn(kNoiseScale, __fmul_rn(rad, cs)));
  im = __fadd_rn(im, __fmul_rn(kNoiseScale, __fmul_rn(rad, sn)));
}

// the samples one thread makes, kThreads apart; a tile of kTile samples
// lies in one anchor block.  On the H100, 4 and 16 ran slower than 8, and
// so did 8 capped at 40 registers for six CTAs an SM
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
static_assert((1 << kBlockLog2) % kTile == 0, "a tile crosses a block");

__global__ void __launch_bounds__(kThreads)
device_generator_kernel(const int8_t* __restrict__ codes,    // [S, lc_max]
                        const int* __restrict__ code_len,    // [S]
                        int lc_max,
                        const int8_t* __restrict__ bits,     // [S, nb_max]
                        const int* __restrict__ bits_len,    // [S]
                        int nb_max,
                        const int* __restrict__ sps,         // [S]
                        const int* __restrict__ base,        // [S, n_blocks]
                        const float* __restrict__ frac,
                        const float* __restrict__ crate,
                        const float* __restrict__ ph0,
                        const float* __restrict__ phr,
                        const float* __restrict__ amp,       // [S]
                        int n_sat, long long n_blocks, long long blk0,
                        long long n, int with_noise,
                        unsigned long long key, long long sample0,
                        float2* __restrict__ out) {          // [n]
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long g = blk0 + (t0 >> kBlockLog2);
  // the thread's first sample within its anchor block
  const int j0 = (int)(t0 & ((1 << kBlockLog2) - 1)) + (int)threadIdx.x;
  float re[kPerThread], im[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) re[r] = im[r] = 0.0f;
  for (int s = 0; s < n_sat; ++s) {
    const long long a = (long long)s * n_blocks + g;
    const int b = __ldg(base + a);
    const float fr = __ldg(frac + a), cr = __ldg(crate + a);
    const float p0 = __ldg(ph0 + a), pr = __ldg(phr + a);
    const int lc = __ldg(code_len + s), sp = __ldg(sps + s);
    const int nb = __ldg(bits_len + s);
    const float am = __ldg(amp + s);
    const int8_t* code = codes + (long long)s * lc_max;
    const int8_t* sym_of = bits + (long long)s * nb_max;
    // the first sample's indices as the reference takes them: k, then
    // k = q sp + si (0 <= si < sp), chip ci = k mod lc, symbol bi = q mod nb
    int f = (int)floorf(__fadd_rn(fr, __fmul_rn(cr, (float)j0)));
    const int k = b + f;
    int ci = floor_mod(k, lc);
    const int q = floor_div(k, sp);
    int si = k - q * sp;
    int bi = floor_mod(q, nb);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const float nloc = (float)(j0 + r * kThreads);
      if (r > 0) {
        const int fn = (int)floorf(__fadd_rn(fr, __fmul_rn(cr, nloc)));
        const int dk = fn - f;
        f = fn;
        ci += dk;
        if (ci >= lc) ci -= lc;
        if ((unsigned)ci >= (unsigned)lc) ci = floor_mod(ci, lc);
        si += dk;
        if (si >= sp) {
          si -= sp;
          bi = bi + 1 == nb ? 0 : bi + 1;
        }
        if ((unsigned)si >= (unsigned)sp) {        // dk >= 2 sp, or < 0
          const int qs = floor_div(si, sp);
          si -= qs * sp;
          bi = floor_mod(bi + qs, nb);
        }
      }
      const int chip = __ldg(code + ci);
      const int sym = __ldg(sym_of + bi);
      const float ph = __fadd_rn(p0, __fmul_rn(pr, nloc));
      float sn, cs;
      sincosf(ph, &sn, &cs);
      const float v = __fmul_rn((float)(chip * sym), am);
      re[r] = __fadd_rn(re[r], __fmul_rn(v, cs));
      im[r] = __fadd_rn(im[r], __fmul_rn(v, sn));
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long i = t0 + (long long)threadIdx.x + (long long)r * kThreads;
    if (i >= n) break;
    if (with_noise)
      add_noise(re[r], im[r], (unsigned long long)(sample0 + i), key);
    out[i] = make_float2(re[r], im[r]);
  }
}

// The kernel before the redesign: one thread per sample, every index by
// floor division and every anchor loaded per sample.  The bit-for-bit
// reference of device_generator_kernel; on no path.
__global__ void __launch_bounds__(kThreads)
device_generator_reference_kernel(
    const int8_t* __restrict__ codes, const int* __restrict__ code_len,
    int lc_max, const int8_t* __restrict__ bits,
    const int* __restrict__ bits_len, int nb_max,
    const int* __restrict__ sps, const int* __restrict__ base,
    const float* __restrict__ frac, const float* __restrict__ crate,
    const float* __restrict__ ph0, const float* __restrict__ phr,
    const float* __restrict__ amp, int n_sat, long long n_blocks,
    long long blk0, long long n, int with_noise, unsigned long long key,
    long long sample0, float2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long g = blk0 + (i >> kBlockLog2);
  const float nloc = (float)(int)(i & ((1 << kBlockLog2) - 1));
  float re = 0.0f, im = 0.0f;
  for (int s = 0; s < n_sat; ++s) {
    const long long a = (long long)s * n_blocks + g;
    const float off = __fadd_rn(__ldg(frac + a),
                                __fmul_rn(__ldg(crate + a), nloc));
    const int k = __ldg(base + a) + (int)floorf(off);
    const int chip = __ldg(codes + (long long)s * lc_max
                           + floor_mod(k, __ldg(code_len + s)));
    const int sym = __ldg(bits + (long long)s * nb_max
                          + floor_mod(floor_div(k, __ldg(sps + s)),
                                      __ldg(bits_len + s)));
    const float ph = __fadd_rn(__ldg(ph0 + a),
                               __fmul_rn(__ldg(phr + a), nloc));
    float sn, cs;
    sincosf(ph, &sn, &cs);
    const float v = __fmul_rn((float)(chip * sym), __ldg(amp + s));
    re = __fadd_rn(re, __fmul_rn(v, cs));
    im = __fadd_rn(im, __fmul_rn(v, sn));
  }
  if (with_noise) add_noise(re, im, (unsigned long long)(sample0 + i), key);
  out[i] = make_float2(re, im);
}

typedef void (*Kernel)(const int8_t*, const int*, int, const int8_t*,
                       const int*, int, const int*, const int*, const float*,
                       const float*, const float*, const float*,
                       const float*, int, long long, long long, long long,
                       int, unsigned long long, long long, float2*);

int launch(Kernel kernel, int per_cta, const void* codes,
           const void* code_len, int lc_max, const void* bits,
           const void* bits_len, int nb_max, const void* sps,
           const void* base, const void* frac, const void* crate,
           const void* ph0, const void* phr, const void* amp, int n_sat,
           long long n_blocks, long long blk0, long long n, int with_noise,
           unsigned long long key, long long sample0, void* out,
           void* stream) {
  if (n_sat < 1 || lc_max < 1 || nb_max < 1 || n < 1 || blk0 < 0 ||
      blk0 + ((n + (1 << kBlockLog2) - 1) >> kBlockLog2) > n_blocks)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n + per_cta - 1) / per_cta;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int*)code_len, lc_max,
      (const int8_t*)bits, (const int*)bits_len, nb_max, (const int*)sps,
      (const int*)base, (const float*)frac, (const float*)crate,
      (const float*)ph0, (const float*)phr, (const float*)amp, n_sat,
      n_blocks, blk0, n, with_noise, key, sample0, (float2*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define K6_ARGS                                                              \
  const void *codes, const void *code_len, int lc_max, const void *bits,     \
      const void *bits_len, int nb_max, const void *sps, const void *base,   \
      const void *frac, const void *crate, const void *ph0, const void *phr, \
      const void *amp, int n_sat, long long n_blocks, long long blk0,        \
      long long n, int with_noise, unsigned long long key,                   \
      long long sample0, void *out, void *stream
#define K6_PASS                                                             \
  codes, code_len, lc_max, bits, bits_len, nb_max, sps, base, frac, crate,  \
      ph0, phr, amp, n_sat, n_blocks, blk0, n, with_noise, key, sample0, out, \
      stream

extern "C" int device_generator(K6_ARGS) {
  return launch(device_generator_kernel, kTile, K6_PASS);
}

extern "C" int device_generator_reference(K6_ARGS) {
  return launch(device_generator_reference_kernel, kThreads, K6_PASS);
}
