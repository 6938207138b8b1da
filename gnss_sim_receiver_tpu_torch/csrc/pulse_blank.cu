// K5c: pulse blanking, written for Hopper.
//
// Replaces gnss_sim_receiver_tpu/ops/filters.py:pulse_blanking (line 82):
//
//   pw[w] = the mean of |x|^2 over whole window w of W samples
//   thr   = float32(th^2) * median(pw), the two middle values of an even
//           count averaged as s[(n-1)/2] * 0.5 + s[n/2] * 0.5
//   out   = x with every window of pw > thr zeroed; the ragged tail kept
//
// What bounds it on the H100: x read once and out written once, 16 N bytes
// (and pw, 8 N / W), so device memory: 0.0193 ms at phase 4b's 4 M
// samples, 0.5006 at the capture's 104 M.  The form it replaced
// (ops/filters.py _blank_reference, on no path) read x twice, in two Triton
// kernels, and sorted every window power with torch.sort between them: 20
// device operations a call.  This one makes three launches, with no host
// synchronisation and no library call between them:
//
// 1. blank_power_kernel reads x once with 16-byte streaming loads (two
//    samples a lane; at W = 64 one warp load is one window), copies it into
//    out whole with 16-byte streaming stores (the ragged tail too) and
//    writes pw.  A window's power is summed by shuffles over the lanes that
//    hold it (and over rows where it is wider than one warp load).  Each
//    CTA counts the top 11 bits of the powers' bit patterns in a shared
//    histogram and adds the bins it hit to a global one.  pw >= 0, so its
//    uint32 bit patterns sort as the floats do, NaN (0x7fffffff from the
//    arithmetic) above +inf, where torch.sort puts it.  As many CTAs as
//    the card holds at once.
// 2. blank_select_kernel, one thread-block cluster, finds the exact order
//    statistics of ranks (n_win - 1) / 2 and n_win / 2 by radix select.
//    Every CTA finds each rank's bin in the global histogram itself (rank
//    0 then zeroes it, so that the next call, a CUDA graph's replay too,
//    starts clean without a memset); two passes over pw (from L2: 256 KB
//    at 4 M samples, 6.5 MB at 104 M) count the next 11 bits and the last
//    10 among the windows of each rank's prefix, in shared histograms each
//    CTA sums over the cluster through distributed shared memory.  The two
//    ranks share one histogram until their prefixes part.  thr is formed on
//    the card in _median's and _blank_threshold's float32 order.  The
//    cluster has a CTA per kSelWindows windows, up to 16: every CTA reads
//    every other's histograms, which costs more than the passes save below
//    that (tools/probe_blanking.py; 4 CTAs at 4 M samples, 16 at 104 M).
// 3. blank_zero_kernel reads pw and thr and writes zeros over the windows
//    with !(pw <= thr) only: a NaN power is blanked, as the plain version's
//    `keep = pw <= thr` blanks it.
//
// Launches 2 and 3 are programmatic dependent launches: each is resident
// before the one it follows ends and waits (griddepcontrol.wait) before it
// reads what that one wrote, which hides ~2 us of launch latency at each
// step.  A warp whose lanes all count into one bin (equal powers: all-zero
// windows) adds them with one shared atomic.
//
// Measured (chip_smoke.py phase 3, tools/probe_blanking.py; NVIDIA H100
// 80GB HBM3, 700.00 W): 0.0395 ms at 4 M samples (the replaced form
// 0.0866; 2.05 x the bound), 0.6589 ms at 104 M (0.9771; 1.32 x).  At
// 104 M the power pass takes ~600 us, near the bound; at 4 M the
// selection's chain of barriers and cluster-wide sums (~14 us) is a third
// of the call.
//
// The window powers are summed in a tree order of their own (the plain
// version and the Triton kernel each have theirs), so a power may differ
// from theirs in the last bit; thr is exactly _blank_threshold of this
// kernel's powers (chip_smoke.py phase 3 holds it to that, and the output
// to the plain version's and the replaced form's sample for sample).
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/ops/filters.py
// (_blank_plain).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 2048;          // 11-bit digits; the last pass's 10
constexpr int kTopShift = 21;        // the first digit: bits 31..21
constexpr int kPowThreads = 256;
constexpr int kPowWarps = kPowThreads / 32;
constexpr int kRowsInFlight = 4;     // warp loads of 512 bytes in flight
constexpr int kSelCtas = 16;         // the selection's cluster at most,
constexpr int kSelPortable = 8;      // or this where 16 does not fit
constexpr long long kSelWindows = 16384;  // windows a selection CTA
constexpr int kSelThreads = 1024;
constexpr int kSelLoads = 4;         // 16-byte loads in flight a thread
constexpr int kSumBatch = 8;         // CTAs a cluster sum reads at once
constexpr int kZeroThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

#ifdef BLANK_PROBE
// %globaltimer stamps (ns) of one call, for tools/probe_blanking.py: each
// kernel's first CTA start (atomicMin) and last CTA end (atomicMax), then
// the selection's stages on its CTA 0
constexpr int kProbeWords = 16;
__device__ unsigned long long blank_probe_buf[kProbeWords];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_start(int i) {
  if (threadIdx.x == 0) atomicMin(blank_probe_buf + i, now_ns());
}
__device__ __forceinline__ void probe_end(int i) {
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(blank_probe_buf + i, now_ns());
}
__device__ __forceinline__ void probe_stage(unsigned me, int i) {
  if (me == 0 && threadIdx.x == 0) blank_probe_buf[i] = now_ns();
}
#else
__device__ __forceinline__ void probe_start(int) {}
__device__ __forceinline__ void probe_end(int) {}
__device__ __forceinline__ void probe_stage(unsigned, int) {}
#endif

struct PowerArgs {
  const float2* x;
  float2* out;
  float* pw;
  unsigned* hist;            // the global histogram of the top digit
  long long n;               // samples
  long long n_win;           // whole windows
  long long units;           // sample pairs in the whole windows
  long long super_rows;      // a warp's steps of `super` rows of 32 pairs
  int window;                // W, a power of two
  int lanes;                 // lanes a window holds within a row (W <= 64)
  int pair_shift;            // log2 of the pairs a window (W >= 2)
  int rows_per_window;       // rows a window spans (W > 64), else 1
  int row_shift;             // its log2
  int super;                 // rows a super-row: a multiple of both
  int step_shift;            // log2(super / kRowsInFlight)
  float inv_w;               // 1 / W, exact
  int vec;                   // x 16-byte aligned
};

__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// One count in bin `key` of `hist` for every lane whose key is not kNone.
// Where every such lane of the warp has the same key (a run of equal
// powers, all-zero windows) one atomic adds them all, so that such a
// stream does not serialise 32 atomics on one bin; else one a lane.  All
// 32 lanes call it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned key) {
  const unsigned lanes = __ballot_sync(kFull, key != kNone);
  if (lanes == 0) return;
  const int first = __ffs(lanes) - 1;
  const unsigned key0 = __shfl_sync(kFull, key, first);
  if (__all_sync(kFull, key == kNone || key == key0)) {
    if ((int)(threadIdx.x & 31) == first)
      atomicAdd(hist + key0, (unsigned)__popc(lanes));
  } else if (key != kNone) {
    atomicAdd(hist + key, 1u);
  }
}

// Programmatic dependent launch: a kernel launched after another on the
// stream with the serialization attribute may start (and be resident)
// before that one ends; it waits here before it reads what that one wrote.
// The one before lets it start at once.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ float4 load_pair(const float2* x, long long u,
                                            int vec) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(x) + u);
  const float2 a = __ldcs(x + 2 * u), b = __ldcs(x + 2 * u + 1);
  return make_float4(a.x, a.y, b.x, b.y);
}

// the kRowsInFlight rows from row0 on into v (zeros past the pairs)
__device__ __forceinline__ void load_rows(const PowerArgs& a, long long row0,
                                          int lane, float4* v) {
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
    const long long u = (row0 + k) * 32 + lane;
    v[k] = u < a.units ? load_pair(a.x, u, a.vec)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ void store_rows(const PowerArgs& a,
                                           long long row0, int lane,
                                           const float4* v) {
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
    const long long u = (row0 + k) * 32 + lane;
    if (u < a.units) __stcs(reinterpret_cast<float4*>(a.out) + u, v[k]);
  }
}

// window w's power from its sum s: written and counted by its owner lane
__device__ __forceinline__ void emit(const PowerArgs& a, unsigned* hist,
                                     bool own, long long w, float s) {
  const float p = __fmul_rn(s, a.inv_w);
  unsigned key = kNone;
  if (own) {
    a.pw[w] = p;
    key = __float_as_uint(p) >> kTopShift;
  }
  hist_add(hist, key);
}

// the window powers of the kRowsInFlight rows from row0 on; `acc` carries a
// window's sum over the rows it spans
__device__ __forceinline__ void row_powers(const PowerArgs& a,
                                          unsigned* hist, long long row0,
                                          int lane, const float4* v,
                                          float& acc) {
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
    const long long row = row0 + k;
    const long long u = row * 32 + lane;
    const bool in = u < a.units;
    const float p0 = power(v[k].x, v[k].y);
    const float p1 = power(v[k].z, v[k].w);
    if (a.window == 1) {                     // two windows a lane
      if (in)
        *reinterpret_cast<float2*>(a.pw + 2 * u) = make_float2(p0, p1);
      hist_add(hist, in ? __float_as_uint(p0) >> kTopShift : kNone);
      hist_add(hist, in ? __float_as_uint(p1) >> kTopShift : kNone);
      continue;
    }
    float s = __fadd_rn(p0, p1);
    if (a.rows_per_window == 1) {            // 32 / lanes windows a row
      for (int o = 1; o < a.lanes; o <<= 1)
        s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
      emit(a, hist, in && (lane & (a.lanes - 1)) == 0, u >> a.pair_shift,
           s);
    } else {                                 // a window over several rows
      acc = __fadd_rn(acc, s);
      if (((row + 1) & (a.rows_per_window - 1)) == 0) {
        for (int o = 1; o < 32; o <<= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
        const long long w = row >> a.row_shift;
        emit(a, hist, lane == 0 && w < a.n_win, w, acc);
        acc = 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(kPowThreads)
blank_power_kernel(const __grid_constant__ PowerArgs a) {
  probe_start(0);
  let_next_start();
  __shared__ unsigned hist[kBins];
  for (int b = threadIdx.x; b < kBins; b += kPowThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // the samples past the whole pairs: the ragged tail, and at W = 1 an odd
  // last sample, a window of its own
  if (blockIdx.x == 0) {
    for (long long i = 2 * a.units + threadIdx.x; i < a.n;
         i += kPowThreads) {
      const float2 v = a.x[i];
      a.out[i] = v;
      if (i < a.n_win * a.window) {
        const float p = power(v.x, v.y);
        a.pw[i] = p;
        atomicAdd(hist + (__float_as_uint(p) >> kTopShift), 1u);
      }
    }
  }
  // this warp's steps of kRowsInFlight rows: super-rows warp0, warp0 +
  // n_warps, ..., each `super` rows
  const long long warp0 = (long long)blockIdx.x * kPowWarps +
                          (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kPowWarps;
  const int per_sr = 1 << a.step_shift;
  const long long n_steps =
      warp0 < a.super_rows
          ? ((a.super_rows - warp0 + n_warps - 1) / n_warps) * per_sr
          : 0;
  float acc = 0.0f;
  for (long long q = 0; q < n_steps; ++q) {
    const long long row0 = (warp0 + (q >> a.step_shift) * n_warps) *
                               a.super +
                           (q & (per_sr - 1)) * kRowsInFlight;
    float4 v[kRowsInFlight];
    load_rows(a, row0, lane, v);
    store_rows(a, row0, lane, v);
    row_powers(a, hist, row0, lane, v, acc);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kPowThreads)
    if (hist[b]) atomicAdd(a.hist + b, hist[b]);
  probe_end(1);
}

// each rank's value so far (its high bits) and its rank among the windows
// that share them
struct Select {
  unsigned prefix[2];
  unsigned rank[2];
};

// the exclusive prefix sums of two values a thread over the CTA
__device__ uint2 block_exclusive_scan(uint2 v, uint2* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y0 = __shfl_up_sync(kFull, incl.x, o);
    const unsigned y1 = __shfl_up_sync(kFull, incl.y, o);
    if (lane >= o) {
      incl.x += y0;
      incl.y += y1;
    }
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint2 t = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y0 = __shfl_up_sync(kFull, t.x, o);
      const unsigned y1 = __shfl_up_sync(kFull, t.y, o);
      if (lane >= o) {
        t.x += y0;
        t.y += y1;
      }
    }
    warp_sums[lane] = t;
  }
  __syncthreads();
  const uint2 before = warp ? warp_sums[warp - 1] : make_uint2(0u, 0u);
  __syncthreads();
  return make_uint2(before.x + incl.x - v.x, before.y + incl.y - v.y);
}

// rank k of `hist` (bins of kSelThreads * per): the thread whose bins hold
// it writes (high << bits | bin) and k's rank within the bin to slot r of
// `out`
__device__ __forceinline__ void place(const unsigned* hist, int per,
                                      unsigned before, unsigned c,
                                      unsigned k, unsigned high, int bits,
                                      Select* out, int r) {
  if (k < before || k - before >= c) return;
  for (int i = 0; i < per; ++i) {
    const int b = threadIdx.x * per + i;
    if (k - before < hist[b]) {
      out->prefix[r] = (high << bits) | (unsigned)b;
      out->rank[r] = k - before;
      return;
    }
    before += hist[b];
  }
}

// Each rank's bin: rank s.rank[r] of histogram h[r] (`bins` of them:
// kBins or kBins / 2; h[0] == h[1] while the ranks share a prefix), into
// `out`.  Every thread of the CTA calls it.
__device__ void find_ranks(const unsigned* h0, const unsigned* h1, int bins,
                           const Select& s, int bits, Select* out,
                           uint2* warp_sums) {
  const int per = bins / kSelThreads;
  uint2 c = make_uint2(0u, 0u);
  for (int i = 0; i < per; ++i) {
    c.x += h0[threadIdx.x * per + i];
    c.y += h1[threadIdx.x * per + i];
  }
  const uint2 before = block_exclusive_scan(c, warp_sums);
  place(h0, per, before.x, c.x, s.rank[0], s.prefix[0], bits, out, 0);
  place(h1, per, before.y, c.y, s.rank[1], s.prefix[1], bits, out, 1);
}

// One pass of the select: count digit (v >> shift) & (bins - 1) of every
// window power v whose bits above the digit equal a rank's prefix, into
// that rank's histogram (the first for both while they share it).  Each
// thread has kSelLoads 16-byte loads in flight.
__device__ void count_digits(const float* __restrict__ pw, long long n_win,
                             unsigned me, unsigned n_cta, int shift,
                             int bins, const Select& s, bool split,
                             unsigned* h0, unsigned* h1) {
  const int lane = threadIdx.x & 31;
  const int key_shift = shift + (bins == kBins ? 11 : 10);
  const unsigned mask = (unsigned)bins - 1;
  const long long n4 = (n_win + 3) / 4;
  const long long stride = (long long)n_cta * kSelThreads * kSelLoads;
  for (long long g0 = ((long long)me * kSelThreads + threadIdx.x - lane) *
                      kSelLoads;
       g0 < n4; g0 += stride) {
    uint4 q[kSelLoads];
#pragma unroll
    for (int k = 0; k < kSelLoads; ++k) {
      const long long g = g0 + k * 32 + lane;
      if (4 * g + 3 < n_win) {
        q[k] = __ldcg(reinterpret_cast<const uint4*>(pw) + g);
      } else {
        const unsigned* p = reinterpret_cast<const unsigned*>(pw) + 4 * g;
        q[k].x = 4 * g < n_win ? __ldcg(p) : kNone;
        q[k].y = 4 * g + 1 < n_win ? __ldcg(p + 1) : kNone;
        q[k].z = 4 * g + 2 < n_win ? __ldcg(p + 2) : kNone;
        q[k].w = kNone;
      }
    }
#pragma unroll
    for (int k = 0; k < kSelLoads; ++k) {
      const unsigned v[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // kNone, past the powers, is a negative NaN's bits: no power's,
        // so its key matches no prefix
        const unsigned key = v[e] >> key_shift, d = (v[e] >> shift) & mask;
        hist_add(h0, key == s.prefix[0] ? d : kNone);
        if (split) hist_add(h1, key == s.prefix[1] ? d : kNone);
      }
    }
  }
}

// the cluster's sums of every CTA's histogram `h` (the first `bins` bins)
// into this CTA's `total`: 16-byte loads through distributed shared
// memory, kSumBatch CTAs' in flight at once
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            unsigned* h, unsigned* total,
                                            int bins) {
  const int n_cta = (int)cluster.num_blocks();
  for (int b = threadIdx.x; b < bins / 4; b += kSelThreads) {
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    for (int q0 = 0; q0 < n_cta; q0 += kSumBatch) {
      uint4 v[kSumBatch];
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q)
        v[q] = q0 + q < n_cta
                   ? reinterpret_cast<const uint4*>(
                         cluster.map_shared_rank(h, q0 + q))[b]
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q) {
        c.x += v[q].x;
        c.y += v[q].y;
        c.z += v[q].z;
        c.w += v[q].w;
      }
    }
    reinterpret_cast<uint4*>(total)[b] = c;
  }
}

__global__ void __launch_bounds__(kSelThreads, 1)
blank_select_kernel(const float* __restrict__ pw, long long n_win,
                    unsigned* __restrict__ top_hist, float th2,
                    float* __restrict__ thr) {
  // each pass counts into its own histograms (the second digit, the
  // last), so that no CTA clears a count another may still be reading;
  // `total` holds the cluster's sums
  __shared__ __align__(16) unsigned second[2][kBins];
  __shared__ __align__(16) unsigned last[2][kBins / 2];
  __shared__ __align__(16) unsigned total[2][kBins];
  __shared__ Select sel;
  __shared__ uint2 warp_sums[32];
  probe_start(2);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  const unsigned n_cta = cluster.num_blocks();
  for (int b = threadIdx.x; b < kBins; b += kSelThreads) {
    second[0][b] = second[1][b] = 0;
    if (b < kBins / 2) last[0][b] = last[1][b] = 0;
  }
  wait_for_previous();
  let_next_start();
  // every CTA finds each rank's top bin itself
  for (int b = threadIdx.x; b < kBins; b += kSelThreads)
    total[0][b] = top_hist[b];
  __syncthreads();
  Select s;
  s.prefix[0] = s.prefix[1] = 0;
  s.rank[0] = (unsigned)((n_win - 1) / 2);
  s.rank[1] = (unsigned)(n_win / 2);
  find_ranks(total[0], total[0], kBins, s, 0, &sel, warp_sums);
  __syncthreads();
  probe_stage(me, 6);
  s = sel;
  bool split = s.prefix[0] != s.prefix[1];
  count_digits(pw, n_win, me, n_cta, 10, kBins, s, split, second[0],
               second[1]);
  probe_stage(me, 7);
  cluster.sync();       // every count is in, and every CTA has read top_hist
  probe_stage(me, 8);
  if (me == 0)          // clean for the next call
    for (int b = threadIdx.x; b < kBins; b += kSelThreads) top_hist[b] = 0;
  for (int h = 0; h < (split ? 2 : 1); ++h)
    cluster_sum(cluster, second[h], total[h], kBins);
  __syncthreads();
  find_ranks(total[0], total[split ? 1 : 0], kBins, s, 11, &sel, warp_sums);
  __syncthreads();
  probe_stage(me, 9);
  s = sel;
  split = s.prefix[0] != s.prefix[1];
  count_digits(pw, n_win, me, n_cta, 0, kBins / 2, s, split, last[0],
               last[1]);
  probe_stage(me, 10);
  cluster.sync();
  probe_stage(me, 11);
  if (me == 0) {
    for (int h = 0; h < (split ? 2 : 1); ++h)
      cluster_sum(cluster, last[h], total[h], kBins / 2);
    __syncthreads();
    find_ranks(total[0], total[split ? 1 : 0], kBins / 2, s, 10, &sel,
               warp_sums);
    __syncthreads();
    if (threadIdx.x == 0) {
      const float median =
          __fadd_rn(__fmul_rn(__uint_as_float(sel.prefix[0]), 0.5f),
                    __fmul_rn(__uint_as_float(sel.prefix[1]), 0.5f));
      *thr = __fmul_rn(th2, median);
    }
  }
  probe_stage(me, 12);
  cluster.sync();       // rank 0 has read every CTA's last counts
  probe_end(3);
}

__global__ void __launch_bounds__(kZeroThreads)
blank_zero_kernel(const float* __restrict__ pw, const float* __restrict__ thr,
                  float2* __restrict__ out, long long n_win, int window) {
  probe_start(4);
  const int lane = threadIdx.x & 31;
  const long long w0 = (long long)blockIdx.x * kZeroThreads +
                       (threadIdx.x - lane);
  const long long w = w0 + lane;
  wait_for_previous();
  const float t = __ldg(thr);
  unsigned todo = __ballot_sync(kFull, w < n_win && !(__ldg(pw + w) <= t));
  while (todo) {
    const long long b = w0 + __ffs(todo) - 1;
    todo &= todo - 1;
    if (window == 1) {
      if (lane == 0) out[b] = make_float2(0.0f, 0.0f);
    } else {
      float4* dst = reinterpret_cast<float4*>(out + b * window);
      for (int u = lane; u < window / 2; u += 32)
        dst[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  probe_end(5);
}

// How the launches are sized on one device, decided on its first call (so
// that a launch captured in a CUDA graph sets and asks nothing): the power
// pass as many CTAs as the card holds at once, the selection's cluster
// kSelCtas CTAs where the card holds such a cluster (the leave to exceed
// the portable size taken once), else kSelPortable.
struct Plan {
  int power_ctas;
  int select_ctas;
};

cudaError_t plan_for(int dev, Plan* plan) {
  static Plan plans[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (plans[dev].power_ctas) {
    *plan = plans[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0, clusters = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, blank_power_kernel, kPowThreads, 0);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blank_select_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSelCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSelCtas);
  cfg.blockDim = dim3(kSelThreads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&clusters, blank_select_kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    clusters = 0;
  }
  plans[dev].select_ctas = clusters > 0 ? kSelCtas : kSelPortable;
  plans[dev].power_ctas = sms * (per_sm > 0 ? per_sm : 1);
  *plan = plans[dev];
  return cudaSuccess;
}

}  // namespace

// The global histogram's bins (uint32): zeroed before the first call and
// left zeroed by every call.
extern "C" int pulse_blank_bins() { return kBins; }

// x [n] complex64; window W a power of two with n >= W; th2 = float32(th)^2;
// out [n] complex64 and pw [n / W] float32, both 16-byte aligned; thr [1]
// float32; hist: pulse_blank_bins() uint32, zeroed.  Three launches on
// `stream`.
extern "C" int pulse_blank(const void* x, long long n, int window, float th2,
                           void* out, void* pw, void* thr, void* hist,
                           void* stream) {
  if (n < 1 || window < 1 || (window & (window - 1)) || n < window ||
      n > 2147483647LL ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(pw) & 15))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  Plan plan;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = plan_for(dev, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  PowerArgs a;
  a.x = (const float2*)x;
  a.out = (float2*)out;
  a.pw = (float*)pw;
  a.hist = (unsigned*)hist;
  a.n = n;
  a.n_win = n / window;
  a.window = window;
  a.units = a.n_win * window / 2;
  const int pairs = window / 2;              // pairs a window (0 at W = 1)
  a.lanes = pairs > 32 ? 32 : (pairs > 1 ? pairs : 1);
  a.rows_per_window = pairs > 32 ? pairs / 32 : 1;
  a.pair_shift = pairs > 1 ? __builtin_ctz(pairs) : 0;
  a.row_shift = __builtin_ctz(a.rows_per_window);
  a.super = a.rows_per_window > kRowsInFlight ? a.rows_per_window
                                              : kRowsInFlight;
  a.step_shift = __builtin_ctz(a.super / kRowsInFlight);
  const long long rows = (a.units + 31) / 32;
  a.super_rows = (rows + a.super - 1) / a.super;
  a.inv_w = 1.0f / (float)window;
  a.vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  long long power_ctas = (a.super_rows + kPowWarps - 1) / kPowWarps;
  if (power_ctas > plan.power_ctas) power_ctas = plan.power_ctas;
  if (power_ctas < 1) power_ctas = 1;
  blank_power_kernel<<<(unsigned)power_ctas, kPowThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a CTA per kSelWindows windows, a power of two: more CTAs read the
  // powers faster, but every CTA reads every other's histograms through
  // distributed shared memory (1 CTA was best at 1 M samples, 4 at 4 M, 16
  // from 26 M on: tools/probe_blanking.py; -DBLANK_SELECT_CTAS forces it)
  int select_ctas = 1;
  while (select_ctas < plan.select_ctas &&
         (long long)select_ctas * kSelWindows < a.n_win)
    select_ctas *= 2;
#ifdef BLANK_SELECT_CTAS
  select_ctas = BLANK_SELECT_CTAS;
#endif
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = select_ctas;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(select_ctas);
  cfg.blockDim = dim3(kSelThreads);
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, blank_select_kernel, (const float*)pw,
                           a.n_win, (unsigned*)hist, th2, (float*)thr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim =
      dim3((unsigned)((a.n_win + kZeroThreads - 1) / kZeroThreads));
  cfg.blockDim = dim3(kZeroThreads);
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, blank_zero_kernel, (const float*)pw,
                                 (const float*)thr, (float2*)out, a.n_win,
                                 window);
}

#ifdef BLANK_PROBE
// Clear the stamps before a call; read them after it (kProbeWords words:
// power start, end, selection start, end, zeroing start, end, then the
// selection's stages).
extern "C" int pulse_blank_probe_words() { return kProbeWords; }
extern "C" int pulse_blank_probe_reset() {
  unsigned long long init[kProbeWords] = {};
  for (int i = 0; i < 6; i += 2) init[i] = ~0ull;
  return (int)cudaMemcpyToSymbol(blank_probe_buf, init, sizeof(init));
}
extern "C" int pulse_blank_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, blank_probe_buf,
                                   sizeof(blank_probe_buf));
}
#endif
