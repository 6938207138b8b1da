// K5b: second-order IIR notch as a single-pass scan with a decoupled
// look-back, written for Hopper.
//
// Replaces gnss_sim_receiver_tpu/ops/filters.py:notch_filter (line 58), a
// sequential lax.scan over the N samples:
//
//   v[n] = x[n] + b1 x[n-1] + x[n-2]
//   y[n] = v[n] + a1 y[n-1] + a2 y[n-2]          zero initial state
//   out[n] = y[n] / g
//
// on complex samples with real float32 coefficients.  With the state
// s[n] = (y[n], y[n-1]) the recurrence is s[n] = M s[n-1] + (v[n], 0),
// M = [[a1, a2], [1, 0]]: linear with a constant transition, so the state
// entering sample m is the state entering sample k carried by M^(m-k) plus
// what the samples k..m-1 add from a zero state.
//
// What bounds it on the H100: 16 N bytes (x read once, out written once)
// and ~25 operations per sample, so device memory (0.4967 ms at the
// capture's 104 M samples).  The design (notch_scan_kernel) makes one pass:
//
// - A CTA takes a tile of `sub` sub-tiles of kSubTile = kScanThreads x
//   kPerThread samples (tiles of 1 at phase 4b's 1 M samples, so that
//   hundreds of CTAs fill the card; of 4 at the capture's length, so
//   that each CTA keeps 64 KB in flight).  Its index comes from an atomic
//   ticket, not from blockIdx, so every tile it waits on belongs to a CTA
//   that is already running.  Its compute warps copy every sub-tile into
//   shared memory with cp.async (16 bytes a copy, an XOR swizzle keeping
//   both the copies and the per-thread reads free of bank conflicts) and
//   scan each as it arrives.
// - Each thread runs the recurrence over its kPerThread consecutive
//   samples from a zero output state (the input history x[n-1], x[n-2]
//   is real data) and keeps its end state.  A warp scan with A^(2^b),
//   A = M^kPerThread, and a scan of the warps' sums with A^(32 2^b) give
//   each thread the zero-entry state entering it and the sub-tile's
//   aggregate; A^kScanThreads = M^kSubTile chains the sub-tiles'
//   aggregates into the tile's, which the compute warps publish (AGG) as
//   soon as it is formed: a tile's aggregate never waits on a look-back.
// - One more warp, from the moment the ticket is drawn, looks back over
//   32 tiles a step (one a lane): it combines the nearest tiles back to
//   the first that holds its inclusive end state (INCL), the tile at
//   distance d carried by (M^T)^d, T the tile's length.  The sum is the
//   true state C entering the tile; once the aggregate is there it
//   publishes the tile's inclusive end state, M^T C + aggregate.
// - The compute warps then form each thread's true entry state,
//   A^j ((M^kSubTile)^s C + the sub-tile's zero-entry state) plus its own,
//   rerun its samples from it and write out = y (1/g) through shared
//   memory with coalesced 16-byte stores.
//
// Measured on an H100 (tools/probe_notch.py): the look-back, not the
// memory, sets the pace.  A tile's inclusive state comes one status round
// trip after its predecessor's at best, so every tile waits for that
// front (2 to 3 steps, ~17 polls at 104 M samples).  Tiles of 4 sub-tiles
// cut the tiles the front must cross by 4 and carry 4 times the bytes a
// CTA; a look-back on warp 0 after the aggregate (1.32 ms at 104 M), one
// behind acquire/release fences, more tiles a step, and persistent CTAs
// that drew their next ticket early (each holding back that tile's
// aggregate behind its own look-back: 1.37 ms) were slower.  Multiplying
// by 1/g (rounded once) instead of an IEEE division took 0.8264 to
// 0.7167 ms at 104 M; the result differs from y / g by at most an ulp.
//
// x is read once and out written once.  The carries are composed exactly
// (no warm-up halo that relies on r^W having decayed): any pole radius.
// Every power of M the kernel uses comes from the host, formed in float64
// and rounded to float32 (ops/filters.py:_notch_tables):
//   tab[j]               = A^j,        j = 0 .. kScanThreads
//   tab[kPowT + d]       = (M^T)^d,    d = 0 .. kLookback
//
// The status of the tiles lives in a scratch the wrapper allocates once,
// zeroed: a header (the ticket counter and the generation, one 64-bit
// word), then per tile a slot of four 64-bit words, each a float of the
// tile's aggregate or inclusive state beside its tag (generation << 2 |
// state), so that a reader needs no fence.  The CTA that takes the last
// ticket resets the counter and advances the generation, so the next
// launch (also a CUDA graph's replay) starts from a clean state without a
// memset: a slot of an older generation reads as not ready.
//
// The carries round apart from the sequential scan (and how far a
// look-back reaches before it finds an inclusive state depends on timing,
// so the last bits may differ from one launch to the next); with pole
// radius r = 1 - pi bw < 1 the state forgets in ~1/(1-r) samples, so the
// difference does not grow with N.
//
// The three-launch kernel it replaced (a chunk pass from zero state, a
// one-warp carry scan, the chunk pass again from the true carries; x read
// twice) stays below as notch_filter_reference, on no path.
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/filters.py
// (_notch_plain), the sequential recurrence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Coef { float b1, a1, a2, g, inv_g; };

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

// the product a b of two 2x2 real matrices, row major in a float4
__device__ __forceinline__ float4 matmul(float4 a, float4 b) {
  return make_float4(a.x * b.x + a.y * b.z, a.x * b.y + a.y * b.w,
                     a.z * b.x + a.w * b.z, a.z * b.y + a.w * b.w);
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int m) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, m),
                     __shfl_xor_sync(0xffffffffu, v.y, m),
                     __shfl_xor_sync(0xffffffffu, v.z, m),
                     __shfl_xor_sync(0xffffffffu, v.w, m));
}

// ---- the single-pass scan --------------------------------------------------

constexpr int kScanThreads = 256;                // compute threads a CTA
constexpr int kPerThread = 8;                    // samples a thread (even)
constexpr int kSubTile = kScanThreads * kPerThread;
constexpr int kSubQuads = kSubTile / 2;          // float4 a sub-tile
constexpr int kMaxSub = 4;                       // sub-tiles a tile
// CTAs an SM each tile length's registers are capped for: one launch
// fills the card at phase 4b's 1 M samples with tiles of one sub-tile;
// tiles of 4 (64 KB of shared memory) fit 3 an SM
constexpr int min_ctas(int sub) { return sub == kMaxSub ? 3 : 4; }
constexpr int kWarps = kScanThreads / 32;
constexpr int kQuads = kPerThread / 2;           // float4 a thread a sub-tile
constexpr int kLookback = 32;                    // tiles a look-back step
constexpr int kPowT = kScanThreads + 1;          // (M^T)^d in the table
constexpr unsigned kAgg = 1u, kIncl = 2u;
constexpr unsigned kMaxPolls = 1u << 24;         // status polls a step
static_assert(kScanThreads % 32 == 0 && kWarps <= 32, "warps");
static_assert(kPerThread % 2 == 0, "kPerThread even");

// float4 q of the tile (samples 2q, 2q+1) in shared memory: the low two
// bits of q XOR (q / 8) % 4, so that eight consecutive q (a phase of a
// 16-byte access) and eight threads' q = kQuads j + c land in distinct
// 16-byte bank groups
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 3); }

// A tile's status is a slot of four 64-bit words: float i of its state in
// the low half of word i, its tag (generation << 2 | kAgg or kIncl) in the
// high half.  A word is stored and loaded whole (a 64-bit access is
// single-copy atomic), so a reader that finds this launch's tag in all
// four words holds the whole state, with no fence on either side; a slot
// caught half rewritten (from its aggregate to its inclusive state) reads
// as not ready and is read again.
__device__ __forceinline__ void publish(unsigned long long* slot, float4 v,
                                        unsigned tag) {
  const unsigned long long hi = (unsigned long long)tag << 32;
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(slot), "l"(hi | __float_as_uint(v.x)),
                  "l"(hi | __float_as_uint(v.y)) : "memory");
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(slot + 2), "l"(hi | __float_as_uint(v.z)),
                  "l"(hi | __float_as_uint(v.w)) : "memory");
}

// kAgg or kIncl with the state in v when the slot holds a whole state of
// generation tag `want` (<< 2), else 0
__device__ __forceinline__ unsigned read_slot(const unsigned long long* slot,
                                              unsigned want, float4& v) {
  unsigned long long a, b, c, d;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b) : "l"(slot) : "memory");
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(c), "=l"(d) : "l"(slot + 2) : "memory");
  const unsigned h = (unsigned)(a >> 32);
  v = make_float4(__uint_as_float((unsigned)a), __uint_as_float((unsigned)b),
                  __uint_as_float((unsigned)c), __uint_as_float((unsigned)d));
  const bool whole = h == (unsigned)(b >> 32) && h == (unsigned)(c >> 32) &&
                     h == (unsigned)(d >> 32);
  return whole && (h & ~3u) == want ? (h & 3u) : 0u;
}

struct Status {
  unsigned long long* header;   // ticket (low word), generation (high)
  unsigned long long* slots;    // [capacity][4]
};

// Probe builds (-DNOTCH_PROBE, tools/probe_notch.py): a CTA stamps its
// sections with clock64 (and its span with %globaltimer) into
// notch_probe_buf, for the first kProbeTiles tiles; the library's
// launches are otherwise unchanged.
#ifdef NOTCH_PROBE
constexpr int kProbeTiles = 1 << 16;
constexpr int kProbeWords = 12;
__device__ unsigned long long notch_probe_buf[kProbeTiles * kProbeWords];
// read as a memory operation, so that no barrier is moved across it
__device__ __forceinline__ unsigned long long stamp() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(v) :: "memory");
  return v;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v) :: "memory");
  return v;
}
#define PROBE_BEGIN()                                  \
  __shared__ unsigned long long probe_sh[kProbeWords]; \
  if (threadIdx.x == 0) {                              \
    probe_sh[0] = stamp();                             \
    probe_sh[8] = global_ns();                         \
    probe_sh[11] = 0;                                  \
  }
#define PROBE(k) \
  if (threadIdx.x == 0) probe_sh[k] = stamp();
#define PROBE_LB(k) \
  if (threadIdx.x == kScanThreads) probe_sh[k] = stamp();
#define PROBE_ADD(k, v) \
  if (threadIdx.x == kScanThreads) probe_sh[k] += (v);
#define PROBE_END(t)                                                     \
  if (threadIdx.x == 0 && (t) < (unsigned)kProbeTiles) {                 \
    unsigned sm;                                                         \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                      \
    probe_sh[7] = stamp();                                               \
    probe_sh[9] = global_ns();                                           \
    probe_sh[10] = sm;                                                   \
    for (int i = 0; i < kProbeWords; ++i)                                \
      notch_probe_buf[(size_t)(t) * kProbeWords + i] = probe_sh[i];      \
  }
#else
#define PROBE_BEGIN()
#define PROBE(k)
#define PROBE_LB(k)
#define PROBE_ADD(k, v)
#define PROBE_END(t)
#endif

// the compute warps' own barrier (the look-back warp does not take part)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kScanThreads) : "memory");
}

// the barrier where the look-back warp hands over the carry and the
// compute warps the aggregate: reached from two places in the code, so
// not __syncthreads (bar.sync is barrier.sync.aligned, which every thread
// must reach at the same instruction) but the unaligned form
__device__ __forceinline__ void handover_sync() {
  asm volatile("barrier.sync 2, %0;" :: "n"(kScanThreads + 32) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` (< kMaxSub) of this thread's copy groups
// are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  static_assert(kMaxSub <= 4, "one case a pending count");
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// kScanThreads compute threads (kWarps warps) and one look-back warp, the
// last.  A tile is `sub` sub-tiles of kSubTile samples, in dynamic shared
// memory (float4 q of sub-tile s at s kSubQuads + swz(q)), then one float4
// of input history.  Thread 0 stamps the probe's sections, the look-back
// warp's lane 0 the end of the look-back (5) and its steps and polls (11).
template <int SUB>
__global__ void __launch_bounds__(kScanThreads + 32, min_ctas(SUB))
notch_scan_kernel(const float2* __restrict__ x, long long n,
                  unsigned n_tiles, Coef k, const float4* __restrict__ tab,
                  Status status, int vec_in, int vec_out,
                  float2* __restrict__ out) {
  constexpr int sub = SUB;
  extern __shared__ float4 tile4[];
  __shared__ float4 warp_excl[SUB][kWarps];
  __shared__ float4 sub_in[SUB];       // zero-entry state into sub-tile s
  __shared__ float4 carry_sh, agg_sh;
  __shared__ unsigned tile_sh, tag_sh;
  float4* hist4 = tile4 + sub * kSubQuads;       // x[base-2], x[base-1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float2 zero = make_float2(0.0f, 0.0f);
  const long long tile_len = (long long)sub * kSubTile;

  PROBE_BEGIN();
  if (tid == kScanThreads) {
    // one atomic takes the ticket (the low word) and reads the generation
    // (the high word); the holder of the last ticket resets the ticket and
    // advances the generation in one more, after every other ticket was
    // taken, so every CTA of this launch reads the same generation
    const unsigned long long old = atomicAdd(status.header, 1ull);
    const unsigned t = (unsigned)old;
    if (t == n_tiles - 1)
      atomicAdd(status.header, (1ull << 32) - n_tiles);
    tile_sh = t;
    tag_sh = (unsigned)(old >> 32) & 0x3fffffffu;
  }
  __syncthreads();
  const unsigned t = tile_sh, want = tag_sh << 2;
  PROBE(1);

  if (warp == kWarps) {
    // the look-back warp: the true state entering tile t, from the tiles
    // before it, while the compute warps load and scan the tile; a step
    // reads kLookback tiles back, lane i the one at distance i from
    // `first`
    float4 carry = zero4;
    if (t > 0) {
      float4 q_pow = make_float4(1.0f, 0.0f, 0.0f, 1.0f);
      long long first = (long long)t - 1;
      while (true) {
        const long long u = first - lane;
        float4 val = zero4;           // before tile 0: an inclusive zero
        unsigned st = u < 0 ? kIncl   // kAgg, kIncl, or 0: not ready
                            : read_slot(status.slots + 4 * u, want, val);
        int nearest;                  // the nearest inclusive state's d
        unsigned polls = 0;
        while (true) {
          nearest = __reduce_min_sync(0xffffffffu,
                                      st == kIncl ? lane : kLookback);
          // every tile nearer than it must be ready
          if (__all_sync(0xffffffffu, lane >= nearest || st != 0)) break;
          // a tile that never publishes (a fault, or a status not left as
          // the kernel expects) ends the launch with an error, not a hang
          if (++polls == kMaxPolls) __trap();
          PROBE_ADD(11, 1ull);
          if (st == 0 && lane < nearest)
            st = read_slot(status.slots + 4 * u, want, val);
        }
        // this step's tiles up to the nearest inclusive state, each
        // carried by (M^T)^d, summed over the warp
        float4 term = lane <= nearest ? matvec(tab[kPowT + lane], val) : zero4;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) term = add4(term, shfl_xor4(term, o));
        carry = add4(carry, matvec(q_pow, term));
        PROBE_ADD(11, 1ull << 32);
        if (nearest < kLookback) break;
        q_pow = matmul(q_pow, tab[kPowT + kLookback]);
        first -= kLookback;
      }
    }
    if (lane == 0) carry_sh = carry;
    PROBE_LB(5);
    handover_sync();          // the aggregate is in agg_sh
    // the tile's inclusive end state (tile 0's went out with its aggregate)
    if (t > 0 && lane == 0)
      publish(status.slots + 4 * (size_t)t,
              add4(matvec(tab[kPowT + 1], carry), agg_sh), want | kIncl);
    return;
  }

  // the compute warps: every sub-tile's copy at once, a commit group each
  // (float4 q of sub-tile s holds samples base + s kSubTile + 2q, + 1),
  // and the input history with the first
  const long long base = (long long)t * tile_len;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  for (int s = 0; s < sub; ++s) {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = tid + i * kScanThreads;
      const long long m = base + s * kSubTile + 2 * q;
      float4* dst = tile4 + s * kSubQuads + swz(q);
      if (vec_in && m + 1 < n) {
        cp_async16(dst, x4 + s * kSubQuads + q);
      } else {
        const float2 a = m < n ? x[m] : zero;
        const float2 b = m + 1 < n ? x[m + 1] : zero;
        *dst = make_float4(a.x, a.y, b.x, b.y);
      }
    }
    if (s == 0 && tid == 0) {
      if (vec_in && base >= 2) {
        cp_async16(hist4, x + base - 2);
      } else {
        const float2 h2 = base >= 2 ? x[base - 2] : zero;
        const float2 h1 = base >= 1 ? x[base - 1] : zero;
        *hist4 = make_float4(h2.x, h2.y, h1.x, h1.y);
      }
    }
    cp_async_commit();
  }

  // the zero-state pass, sub-tile after sub-tile as each arrives; warp 0
  // chains the sub-tiles' aggregates into the tile's
  float4 v_excl[SUB];         // the zero-entry state into this thread
  float4 run = zero4;         // warp 0: the zero-entry state so far
#pragma unroll
  for (int s = 0; s < SUB; ++s) {
    cp_async_wait(SUB - 1 - s);
    compute_sync();
    if (s == 0) PROBE(2);
    const float4* sub4 = tile4 + s * kSubQuads;
    float2 xs[kPerThread];
#pragma unroll
    for (int c = 0; c < kQuads; ++c) {
      const float4 v = sub4[swz(kQuads * tid + c)];
      xs[2 * c] = make_float2(v.x, v.y);
      xs[2 * c + 1] = make_float2(v.z, v.w);
    }
    const float4 hv =
        tid > 0 ? sub4[swz(kQuads * tid - 1)]
                : (s == 0 ? *hist4 : sub4[swz(kSubQuads - 1) - kSubQuads]);
    float4 v;
    {
      float2 p1 = make_float2(hv.z, hv.w), p2 = make_float2(hv.x, hv.y);
      float2 y1 = zero, y2 = zero;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float2 yn = step(k, xs[i], p1, p2, y1, y2);
        p2 = p1; p1 = xs[i]; y2 = y1; y1 = yn;
      }
      v = make_float4(y1.x, y1.y, y2.x, y2.y);
    }
    // inclusive warp scan: v_lane = sum_{i <= lane} A^(lane - i) e_i
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const float4 up = shfl_up4(v, 1 << b);
      if (lane >= (1 << b)) v = add4(v, matvec(tab[1 << b], up));
    }
    v_excl[s] = shfl_up4(v, 1);
    if (lane == 0) v_excl[s] = zero4;
    if (lane == 31) warp_excl[s][warp] = v;
    compute_sync();
    if (warp == 0) {
      // the warps' sums, scanned with B^(2^b), B = A^32
      float4 w = lane < kWarps ? warp_excl[s][lane] : zero4;
#pragma unroll
      for (int b = 0; (1 << b) < kWarps; ++b) {
        const float4 up = shfl_up4(w, 1 << b);
        if (lane >= (1 << b)) w = add4(w, matvec(tab[32 << b], up));
      }
      float4 w_excl = shfl_up4(w, 1);
      if (lane == 0) w_excl = zero4;
      const float4 agg = make_float4(
          __shfl_sync(0xffffffffu, w.x, kWarps - 1),
          __shfl_sync(0xffffffffu, w.y, kWarps - 1),
          __shfl_sync(0xffffffffu, w.z, kWarps - 1),
          __shfl_sync(0xffffffffu, w.w, kWarps - 1));
      if (lane < kWarps) warp_excl[s][lane] = w_excl;
      if (lane == 0) sub_in[s] = run;
      // A^kScanThreads = M^kSubTile carries a sub-tile
      run = add4(matvec(tab[kScanThreads], run), agg);
    }
  }
  PROBE(3);
  if (warp == 0 && lane == 0) {
    // publish the aggregate at once (tile 0: its inclusive state): it
    // never waits on a look-back
    publish(status.slots + 4 * (size_t)t, run,
            want | (t == 0 ? kIncl : kAgg));
    agg_sh = run;
  }
  PROBE(4);
  handover_sync();            // the carry is in carry_sh
  PROBE(6);

  // the true state entering sub-tile s: (M^kSubTile)^s C + sub_in[s]
  float4 carry = carry_sh;
  float4 hist_next = zero4;   // thread 0: the input history of sub-tile s+1
#pragma unroll
  for (int s = 0; s < SUB; ++s) {
    float4* sub4 = tile4 + s * kSubQuads;
    float2 xs[kPerThread];
#pragma unroll
    for (int c = 0; c < kQuads; ++c) {
      const float4 v = sub4[swz(kQuads * tid + c)];
      xs[2 * c] = make_float2(v.x, v.y);
      xs[2 * c + 1] = make_float2(v.z, v.w);
    }
    const float4 hv = tid > 0 ? sub4[swz(kQuads * tid - 1)]
                              : (s == 0 ? *hist4 : hist_next);
    if (tid == 0) hist_next = sub4[swz(kSubQuads - 1)];
    // the true state entering this thread: A^tid S + A^lane W + v_excl
    const float4 into = add4(carry, sub_in[s]);
    const float4 entry = add4(
        matvec(tab[tid], into),
        add4(matvec(tab[lane], warp_excl[s][warp]), v_excl[s]));
    carry = matvec(tab[kScanThreads], carry);
    {
      float2 p1 = make_float2(hv.z, hv.w), p2 = make_float2(hv.x, hv.y);
      float2 y1 = make_float2(entry.x, entry.y);
      float2 y2 = make_float2(entry.z, entry.w);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float2 yn = step(k, xs[i], p1, p2, y1, y2);
        p2 = p1; p1 = xs[i]; y2 = y1; y1 = yn;
#ifdef NOTCH_DIVIDE
        // probe builds only: what an IEEE division would cost
        xs[i] = make_float2(__fdiv_rn(yn.x, k.g), __fdiv_rn(yn.y, k.g));
#else
        xs[i] = make_float2(yn.x * k.inv_g, yn.y * k.inv_g);
#endif
      }
    }
    compute_sync();           // every read of this sub-tile's x is done
#pragma unroll
    for (int c = 0; c < kQuads; ++c)
      sub4[swz(kQuads * tid + c)] = make_float4(xs[2 * c].x, xs[2 * c].y,
                                                xs[2 * c + 1].x,
                                                xs[2 * c + 1].y);
    compute_sync();
    const long long sbase = base + s * kSubTile;
    float4* out4 = reinterpret_cast<float4*>(out + sbase);
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = tid + i * kScanThreads;
      const long long m = sbase + 2 * q;
      const float4 o = sub4[swz(q)];
      if (vec_out && m + 1 < n) {
        out4[q] = o;
      } else {
        if (m < n) out[m] = make_float2(o.x, o.y);
        if (m + 1 < n) out[m + 1] = make_float2(o.z, o.w);
      }
    }
  }
  PROBE_END(t);
}

// ---- the three-launch form it replaced (the reference) ---------------------

constexpr int kChunk = 512;          // samples per thread
constexpr int kChunkThreads = 128;   // chunks per CTA
constexpr int kSub = 16;             // samples per chunk staged at a time
constexpr int kRow = kSub + 1;       // padded shared-memory row

// APPLY = false: zero output state, store the chunk's end state.
// APPLY = true:  start from carry[chunk], store out = y / g.
template <bool APPLY>
__global__ void __launch_bounds__(kChunkThreads)
notch_chunk_kernel(const float2* __restrict__ x, long long n, Coef k,
                   const float4* __restrict__ carry,   // [n_chunks] (APPLY)
                   float4* __restrict__ state,         // [n_chunks] (!APPLY)
                   float2* __restrict__ out) {
  __shared__ float2 tile[kChunkThreads * kRow];
  const long long base = (long long)blockIdx.x * kChunkThreads * kChunk;
  const long long chunk = (long long)blockIdx.x * kChunkThreads + threadIdx.x;
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
    for (int e = threadIdx.x; e < kChunkThreads * kSub; e += kChunkThreads) {
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
      for (int e = threadIdx.x; e < kChunkThreads * kSub; e += kChunkThreads) {
        const int r = e / kSub, j = e % kSub;
        const long long m = base + (long long)r * kChunk + st * kSub + j;
        if (m < n) out[m] = tile[r * kRow + j];
      }
    }
  }
  if (!APPLY && n0 < n) state[chunk] = make_float4(y1.x, y1.y, y2.x, y2.y);
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

extern "C" int notch_tile_threads() { return kScanThreads; }
extern "C" int notch_per_thread() { return kPerThread; }
extern "C" int notch_lookback() { return kLookback; }

// The tile status of `capacity` tiles: a 32-byte header (its first word
// the ticket and the generation), then a 32-byte slot per tile.
extern "C" long long notch_status_bytes(long long capacity) {
  return 32 + 32 * capacity;
}

// Tiles of `sub` (1 or kMaxSub) sub-tiles; tables: kPowT +
// kLookback + 1 float4 on the device (above), for this tile length; status:
// notch_status_bytes(capacity) bytes, zeroed before the first launch and
// left by every launch as it found it (the generation aside).
extern "C" int notch_filter(const void* x, long long n, float b1, float a1,
                            float a2, float g, const void* tables, int sub,
                            void* status, long long capacity, void* out,
                            void* stream) {
  if (n < 1 || (sub != 1 && sub != kMaxSub))
    return (int)cudaErrorInvalidValue;
  const long long tile = (long long)sub * kSubTile;
  const long long n_tiles = (n + tile - 1) / tile;
  if (n_tiles > capacity || n_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // a tile above 48 KB of shared memory needs the kernel's leave, once
  static bool allowed[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    e = cudaFuncSetAttribute(notch_scan_kernel<kMaxSub>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSub * kSubQuads * 16 + 16);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = true;
  }
  Status st;
  st.header = (unsigned long long*)status;
  st.slots = st.header + 4;
  const Coef k = {b1, a1, a2, g, 1.0f / g};
  const int vec_in = ((uintptr_t)x & 15) == 0;
  const int vec_out = ((uintptr_t)out & 15) == 0;
  const unsigned grid = (unsigned)n_tiles, block = kScanThreads + 32;
  const size_t smem = (size_t)sub * kSubQuads * 16 + 16;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* xp = (const float2*)x;
  const float4* tp = (const float4*)tables;
  float2* op = (float2*)out;
  if (sub == 1)
    notch_scan_kernel<1><<<grid, block, smem, s>>>(xp, n, grid, k, tp, st,
                                                    vec_in, vec_out, op);
  else
    notch_scan_kernel<kMaxSub><<<grid, block, smem, s>>>(
        xp, n, grid, k, tp, st, vec_in, vec_out, op);
  return (int)cudaGetLastError();
}

#ifdef NOTCH_PROBE
// The probe build's stamps, kProbeWords a tile: clock64 at the CTA's
// start, after the ticket, once the tile is in shared memory, after the
// warp scans, after the aggregate's publication, at the end of the
// look-back, once the carry is shared and at the end; then %globaltimer at
// the start and the end, the SM, and the look-back's steps << 32 | polls.
extern "C" long long notch_probe_words() {
  return (long long)kProbeTiles * kProbeWords;
}
extern "C" int notch_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, notch_probe_buf,
                                   sizeof(notch_probe_buf));
}
#endif

extern "C" int notch_chunk_len() { return kChunk; }

// The three-launch form (the reference).  scratch: 2 * n_chunks float4
// (end states, then carries); powers: 32 float4 on the device, A^(j+1)
// row major with A = M^kChunk.
extern "C" int notch_filter_reference(const void* x, long long n, float b1,
                                      float a1, float a2, float g,
                                      const void* powers, void* scratch,
                                      void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const long long n_cta = (n_chunks + kChunkThreads - 1) / kChunkThreads;
  if (n_cta > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Coef k = {b1, a1, a2, g};
  float4* state = (float4*)scratch;
  float4* carry = state + n_chunks;
  cudaStream_t s = (cudaStream_t)stream;
  notch_chunk_kernel<false><<<(unsigned)n_cta, kChunkThreads, 0, s>>>(
      (const float2*)x, n, k, nullptr, state, nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  notch_carry_scan<<<1, 32, 0, s>>>(state, (const float4*)powers, n_chunks,
                                    carry);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  notch_chunk_kernel<true><<<(unsigned)n_cta, kChunkThreads, 0, s>>>(
      (const float2*)x, n, k, carry, nullptr, (float2*)out);
  return (int)cudaGetLastError();
}
