// K3c's plain form and K7's fold: two reductions of |corr|^2 over PCPS
// grids, written for Hopper.
//
// Both form grid cells as the Triton kernels they replaced form them,
// `acc += re * re + im * im` from acc = 0, the terms in order (K3c: the
// dwells m = 0 .. M - 1; K7: the windows w = 0 .. W - 1), and that
// kernel's contraction (add_power below), so that each gives the replaced
// kernel's bits (chip_smoke.py phase 3 holds both to them).
//
// ---- K3c, the first-vs-second-peak statistic (plain form) ----------------
//
// Replaces gnss_sim_receiver_tpu/ops/pcps.py:first_vs_second_peak_stat
// (line 123) on the grid g[c, d, k] = sum_m |corr[m, c, d, k]|^2 of the
// [M, C, D, N] correlations: per channel c the peak of g, the first row d*
// that holds it, the first delay k* of that row at the peak, the max of
// row d* over the delays whose circular distance from k* exceeds spc (the
// cells inside the zone count as 0), and stat = peak / max(second, 1e-30).
//
// What bounds it on the H100: it reads the correlations once, 8 M C D N
// bytes (10.5 MB at phase 4's M = 2, C = 8, D = 41, N = 2000: 0.0031 ms),
// under one float32 operation per byte; at the receivers' shapes the
// launch's latency and its chain of block reductions.  The three-launch
// Triton form it replaces (the row kernel, the peak row's tiles, the
// ratio; ops/pcps.py:_second_peak_reference, on no path) paid two
// dependent launches for 0.256 MB.  The design:
//
// - One CTA per (channel, Doppler row), C D CTAs in one launch.  It reads
//   its row's M planes once, two cells a thread with one 16-byte load
//   per dwell (an odd N, or an unaligned pointer, two 8-byte loads), four
//   pairs a thread a round with their loads issued before any add; 256
//   threads, at most 40 registers: six CTAs resident a SM (the ROC
//   harness's 15,744 CTAs ran faster at six than at four; PERF.md).
// - Per thread the running max with a strict > (so each thread keeps its
//   first index), then a block reduction: the row's max and the least
//   index at it, the Triton row kernel's rule.
// - A row of one round (N <= 2048: four pairs a thread) keeps its cells
//   in registers.  After the row's argmax k is known, a thread whose own
//   first max lies outside the zone around k has its part of the second
//   already (that max); the few holding a zone cell take the max of their
//   cells outside it.  A block reduction gives the row's own second.  (The
//   tile path below gives the same bits at these N, 7 to 8 % slower at
//   phase 4's shape and the ROC harness's; PERF.md.)
// - In a longer row each warp's 64 cells of a round are one tile; its max
//   (redux.sync on the cells' bits: the cells are >= 0, so their bits
//   order as their values) goes to shared memory, N / 16 bytes.  The
//   row's own second around k is then the max of: the tile
//   maxima of the tiles wholly outside the zone; 0 for the tiles wholly
//   inside it; and the cells, formed again from the planes (L2-resident),
//   of the at most two tiles that hold the zone's two ends.  A tile
//   holding neither end is wholly inside or wholly outside, so its first
//   cell decides.  For the row d* this is the reference's second, so every
//   row computing its own costs no traffic.  Rows of more than
//   kMaxTiles tiles (N > 786432) read their planes again in full instead.
// - Each CTA writes (max, argmax, second) of its row to a per-row scratch
//   and takes a per-channel ticket with an acquire-release atomic.  The
//   CTA that draws the channel's last ticket takes the first row at the
//   channel's max (the same reduction; the thread that read that row's
//   record writes), writes stat, d* and k*, and sets the ticket
//   back to 0, so the next launch (and a CUDA graph replay) needs no
//   memset.  The tickets are allocated zeroed once per device
//   (ops/pcps.py:_second_tickets).
//
// Its times beside the replaced form's, on an NVIDIA H100 80GB HBM3 at
// 700 W, are PERF.md's K3c row (chip_smoke.py phase 3).  What holds it
// back (%globaltimer stamps of each CTA's stages, -DK3C_PROBE,
// tools/probe_pcps_rows.py): not bytes, but a chain of two block
// reductions and the L2 round trips of the row's record and the ticket
// after its loads land.
//
// ---- K7, the overlap-save fold ---------------------------------------------
//
// Replaces the fold of gnss_sim_receiver_tpu/parallel/shard_steps.py:
// overlap_save_acq_grid (lines 224-227): grid[d, k] = sum over w < W of
// |corr[d, w N + k]|^2, corr [D, (W + 1) N] complex64 (the last N lags are
// the halo's and are not read), grid [D, N] float32.
//
// What bounds it: D W N 8 bytes read once, D N 4 written (84 MB at phase
// 9's D = 41, W = 127, N = 2000: 0.0250 ms), under one operation per byte.
// The Triton kernel it replaces (ops/pcps.py:_window_fold_reference) ran
// 82 programs there, each lane a chain of 127 dependent 4-byte window
// loads, too few bytes in flight: 3.2 times the bound.  Here a thread owns
// two lags and reads them with one 16-byte load a window (odd N, or an
// unaligned pointer: two 8-byte loads), kFoldUnroll windows loaded before
// any add, evict-first (ld.global.cs: each is read once); a CTA of
// kFoldThreads threads covers 2 kFoldThreads lags, so the grid is
// (N / (2 kFoldThreads), D): 328 CTAs of 4 warps at phase 9's shape, each
// keeping 16 KB in flight.  The windows are added in window order, each
// lag on its own, from 0.  Its times beside the Triton kernel's are
// PERF.md's K7 row (chip_smoke.py phase 3, same card).
//
// Plain PyTorch versions: gnss_sim_receiver_tpu_torch/ops/pcps.py
// (_second_peak_plain, _window_fold_plain).

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;        // K3c: one CTA per (channel, row)
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;            // cell pairs a thread a round
constexpr int kMinCtas = 6;          // resident a SM: <= 40 registers
constexpr int kTileCells = 64;       // a warp's 32 pairs: one tile maximum
constexpr int kMaxTiles = 12288;     // 48 KB of tile maxima
constexpr int kFoldThreads = 128;    // K7: 2 kFoldThreads lags a CTA
constexpr int kFoldUnroll = 8;       // K7: windows loaded before any add

#ifdef K3C_PROBE
// %globaltimer stamps (ns) of each K3c CTA (the first 4096), for
// tools/probe_pcps_rows.py: entry, its loads in, the row's max, the row's
// second, the ticket drawn, the channel finished (last CTAs only)
constexpr int kProbeCtas = 4096, kStamps = 6;
__device__ unsigned long long k3c_stamps[kProbeCtas * kStamps];
__device__ __forceinline__ void stamp(int cta, int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (cta < kProbeCtas) k3c_stamps[cta * kStamps + i] = t;
}
#define K3C_STAMP(who, i) \
  if (who) stamp(cta, i)
#else
#define K3C_STAMP(who, i)
#endif

// acc + |c|^2 as the Triton kernels round `acc += re * re + im * im`
// (their PTX: re * re fused into an FMA with im * im, then one add)
__device__ __forceinline__ float add_power(float acc, float re, float im) {
  return __fadd_rn(acc, __fmaf_rn(re, re, __fmul_rn(im, im)));
}

// the ratio as Triton divides float32 (div.full.f32, not IEEE-rounded)
__device__ __forceinline__ float ratio(float a, float b) {
  float r;
  asm("div.full.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the circular distance of delay k from the peak delay, the Triton
// kernel's |(k - peak + half + n) % n - half| with half = n / 2.  The + n
// keeps the operand >= 0, where C's % truncates toward zero; for k and
// peak in [0, n) it lies in [half + 1, 2 n + half), so its % n is at most
// two subtractions of n (no integer division per cell)
__device__ __forceinline__ int zone_dist(int k, int peak, int n, int half) {
  int x = k - peak + half + n;
  x -= x >= n ? n : 0;
  x -= x >= n ? n : 0;
  return abs(x - half);
}

// cells 2p and 2p + 1 of one plane (zeros past n)
template <bool kVec>
__device__ __forceinline__ float4 load_pair(const float2* __restrict__ src,
                                            int p, int n) {
  const int k = 2 * p;
  if (kVec) {
    return k < n ? __ldg(reinterpret_cast<const float4*>(src + k))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float2 a = k < n ? __ldg(src + k) : make_float2(0.0f, 0.0f);
  const float2 b = k + 1 < n ? __ldg(src + k + 1) : make_float2(0.0f, 0.0f);
  return make_float4(a.x, a.y, b.x, b.y);
}

// one cell of a row, its dwells in order (the boundary tiles' cells again)
__device__ __forceinline__ float row_cell(const float2* __restrict__ row,
                                          long long plane, int m_dw, int k) {
  float acc = 0.0f;
  for (int m = 0; m < m_dw; ++m) {
    const float2 v = __ldg(row + m * plane + k);
    acc = add_power(acc, v.x, v.y);
  }
  return acc;
}

// the block's largest key and the least index holding it, in every
// thread: one barrier (each call takes scratch of its own)
__device__ __forceinline__ void block_argmax(unsigned& key, int& idx,
                                             unsigned* red_key,
                                             int* red_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned wk = __reduce_max_sync(kFull, key);
  const int wi = __reduce_min_sync(kFull, key == wk ? idx : INT_MAX);
  if (lane == 0) {
    red_key[warp] = wk;
    red_idx[warp] = wi;
  }
  __syncthreads();
  unsigned bk = 0;
  int bi = INT_MAX;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const unsigned k2 = red_key[q];
    const int i2 = red_idx[q];
    if (k2 > bk || (k2 == bk && i2 < bi)) {
      bk = k2;
      bi = i2;
    }
  }
  key = bk;
  idx = bi;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinCtas)
second_peak_kernel(const float2* __restrict__ corr, int m_dw, int n_ch,
                   int n_dop, int n, int spc, int4* __restrict__ rows,
                   unsigned* __restrict__ tickets, float* __restrict__ stat,
                   int* __restrict__ dop_out, int* __restrict__ del_out) {
  extern __shared__ unsigned tile_max[];   // n_tiles keys, or none
  __shared__ unsigned max_key[kWarps], sec_key[kWarps];
  __shared__ int max_idx[kWarps];
  const int cta = blockIdx.x;
  const int c = cta / n_dop, d = cta % n_dop;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long plane = (long long)n_ch * n_dop * n;
  const float2* row = corr + ((long long)c * n_dop + d) * n;
  const int n_pairs = (n + 1) / 2, half = n / 2;
  const int n_tiles = (n + kTileCells - 1) / kTileCells;
  const bool tiles = n_tiles <= kMaxTiles;
  K3C_STAMP(tid == 0, 0);

  // pass 1: the row's cells, the thread's first max, the tile maxima; a
  // row of one round (N <= 2 kThreads kSlots) keeps its cells in a0, a1
  const bool one_round = n_pairs <= kThreads * kSlots;
  float best = -1.0f;                  // the cells are >= 0
  int best_i = INT_MAX;
  float a0[kSlots], a1[kSlots];
  for (int p0 = 0; p0 < n_pairs; p0 += kThreads * kSlots) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) a0[u] = a1[u] = 0.0f;
#pragma unroll 2
    for (int m = 0; m < m_dw; ++m) {
      const float2* src = row + m * plane;
      float4 v[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        v[u] = load_pair<kVec>(src, p0 + u * kThreads + tid, n);
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        a0[u] = add_power(a0[u], v[u].x, v[u].y);
        a1[u] = add_power(a1[u], v[u].z, v[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int k = 2 * (p0 + u * kThreads + tid);
      const bool in0 = k < n, in1 = k + 1 < n;
      if (in0 && a0[u] > best) {
        best = a0[u];
        best_i = k;
      }
      if (in1 && a1[u] > best) {
        best = a1[u];
        best_i = k + 1;
      }
      if (tiles && !one_round) {
        const unsigned top = __reduce_max_sync(
            kFull, max(in0 ? __float_as_uint(a0[u]) : 0u,
                       in1 ? __float_as_uint(a1[u]) : 0u));
        const int j = (p0 + u * kThreads) / 32 + warp;
        if (lane == 0 && j < n_tiles) tile_max[j] = top;
      }
    }
  }
  K3C_STAMP(tid == 0, 1);
  unsigned peak = best >= 0.0f ? __float_as_uint(best) : 0u;
  int arg = best >= 0.0f ? best_i : INT_MAX;
  block_argmax(peak, arg, max_key, max_idx);   // its barrier publishes
  K3C_STAMP(tid == 0, 2);
  if (arg == INT_MAX) arg = 0;                 // tile_max too (NaN rows)

  // pass 2: the row's own second around its own argmax
  unsigned sec = 0;
  if (one_round) {
    // a thread whose own first max lies outside the zone has its second
    // already: that max; the few holding a zone cell scan their cells
    if (best >= 0.0f && zone_dist(best_i, arg, n, half) > spc) {
      sec = __float_as_uint(best);
    } else {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int k = 2 * (u * kThreads + tid);
        if (k < n && zone_dist(k, arg, n, half) > spc)
          sec = max(sec, __float_as_uint(a0[u]));
        if (k + 1 < n && zone_dist(k + 1, arg, n, half) > spc)
          sec = max(sec, __float_as_uint(a1[u]));
      }
    }
  } else if (tiles) {
    const int s = (int)((((long long)arg - spc) % n + n) % n);
    const int e = (int)(((long long)arg + spc) % n);
    const int ts = s / kTileCells, te = e / kTileCells;
    for (int j = tid; j < n_tiles; j += kThreads) {
      if (j != ts && j != te &&
          zone_dist(j * kTileCells, arg, n, half) > spc)
        sec = max(sec, tile_max[j]);
    }
    if (tid < 2 * kTileCells && (tid < kTileCells || te != ts)) {
      const int k = (tid < kTileCells ? ts : te) * kTileCells
                    + tid % kTileCells;
      if (k < n && zone_dist(k, arg, n, half) > spc)
        sec = max(sec, __float_as_uint(row_cell(row, plane, m_dw, k)));
    }
  } else {
    for (int k = tid; k < n; k += kThreads)
      if (zone_dist(k, arg, n, half) > spc)
        sec = max(sec, __float_as_uint(row_cell(row, plane, m_dw, k)));
  }
  sec = __reduce_max_sync(kFull, sec);
  if (lane == 0) sec_key[warp] = sec;
  __syncthreads();
  if (warp != 0) return;               // warp 0 finishes the CTA
#pragma unroll
  for (int q = 0; q < kWarps; ++q) sec = max(sec, sec_key[q]);
  K3C_STAMP(lane == 0, 3);

  // the row's record, then the channel's ticket: an acquire-release
  // atomic, so the CTA that draws the last one sees every row's record
  int last = 0;
  if (lane == 0) {
    rows[cta] = make_int4((int)peak, arg, (int)sec, 0);
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(tickets[c]);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel)
           == (unsigned)(n_dop - 1);
  }
  K3C_STAMP(lane == 0, 4);
  if (!__shfl_sync(kFull, last, 0)) return;
  __syncwarp();   // orders lane 0's acquire before every lane's reads
  // the channel's last CTA: the first row at the channel's max, found by
  // warp 0; the lane that read that row's record writes the outputs
  const int4* mine = rows + (long long)c * n_dop;
  int4 rec = make_int4(0, 0, 0, 0);
  int d_best = INT_MAX;
  for (int j = lane; j < n_dop; j += 32) {
    const int4 r = __ldcg(mine + j);
    if (d_best == INT_MAX || (unsigned)r.x > (unsigned)rec.x) {
      rec = r;                         // j rises: the first at its max
      d_best = j;
    }
  }
  const unsigned top = __reduce_max_sync(kFull, (unsigned)rec.x);
  const int d_star = __reduce_min_sync(
      kFull, d_best != INT_MAX && (unsigned)rec.x == top ? d_best : INT_MAX);
  if (d_best == d_star) {
    stat[c] = ratio(__uint_as_float(top),
                    fmaxf(__uint_as_float((unsigned)rec.z), 1e-30f));
    dop_out[c] = d_star;
    del_out[c] = rec.y;
    tickets[c] = 0u;
    K3C_STAMP(true, 5);
  }
}

__global__ void empty_kernel() {}

// K7: two lags a thread, kFoldUnroll windows loaded before any add
template <bool kVec>
__global__ void __launch_bounds__(kFoldThreads)
window_fold_kernel(const float2* __restrict__ corr, float* __restrict__ out,
                   int n, int n_win) {
  const int d = blockIdx.y;
  const int k = 2 * (blockIdx.x * kFoldThreads + threadIdx.x);
  if (k >= n) return;
  const bool two = k + 1 < n;
  const long long row_len = (long long)(n_win + 1) * n;
  const float2* src = corr + d * row_len + k;
  float a0 = 0.0f, a1 = 0.0f;
  int w = 0;
  for (; w + kFoldUnroll <= n_win; w += kFoldUnroll) {
    float4 v[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) {
      const float2* p = src + (long long)(w + u) * n;
      if (kVec) {
        v[u] = __ldcs(reinterpret_cast<const float4*>(p));
      } else {
        const float2 x0 = __ldcs(p);
        const float2 x1 = two ? __ldcs(p + 1) : make_float2(0.0f, 0.0f);
        v[u] = make_float4(x0.x, x0.y, x1.x, x1.y);
      }
    }
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) {
      a0 = add_power(a0, v[u].x, v[u].y);
      a1 = add_power(a1, v[u].z, v[u].w);
    }
  }
  for (; w < n_win; ++w) {
    const float2* p = src + (long long)w * n;
    const float2 x0 = __ldcs(p);
    a0 = add_power(a0, x0.x, x0.y);
    if (two) {
      const float2 x1 = __ldcs(p + 1);
      a1 = add_power(a1, x1.x, x1.y);
    }
  }
  float* dst = out + (long long)d * n + k;
  if (kVec) {
    *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
  } else {
    dst[0] = a0;
    if (two) dst[1] = a1;
  }
}

}  // namespace

// K3c, plain form: corr [M, C, D, N] complex64 -> stat [C] float32,
// dop_out [C] int32 (d*), del_out [C] int32 (k*); rows [C D] int4 scratch
// (no initial value), tickets [>= C] uint32, all 0 at launch and left 0.
extern "C" int pcps_second_peak(const void* corr, int m_dw, int n_ch,
                                int n_dop, int n, int spc, void* rows,
                                void* tickets, void* stat, void* dop_out,
                                void* del_out, void* stream) {
  if (m_dw < 1 || n_ch < 1 || n_dop < 1 || n < 1 || spc < 0 ||
      (long long)n_ch * n_dop > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // tile maxima only for rows of several rounds, and up to kMaxTiles
  const int n_tiles = (n + kTileCells - 1) / kTileCells;
  const bool one_round = (n + 1) / 2 <= kThreads * kSlots;
  const size_t smem = !one_round && n_tiles <= kMaxTiles
                          ? n_tiles * sizeof(unsigned) : 0;
  const bool vec = n % 2 == 0 && (reinterpret_cast<uintptr_t>(corr) & 15) == 0;
  auto kernel = vec ? &second_peak_kernel<true> : &second_peak_kernel<false>;
  kernel<<<n_ch * n_dop, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)corr, m_dw, n_ch, n_dop, n, spc, (int4*)rows,
      (unsigned*)tickets, (float*)stat, (int*)dop_out, (int*)del_out);
  return (int)cudaGetLastError();
}

// An empty kernel on K3c's grid, the launch floor it is timed against.
extern "C" int pcps_second_peak_empty(int n_ch, int n_dop, void* stream) {
  if (n_ch < 1 || n_dop < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<n_ch * n_dop, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

#ifdef K3C_PROBE
// The stamps of the last launch, [4096, 6] uint64 ns, into `host` (and
// cleared for the next).
extern "C" int pcps_second_peak_stamps(void* host) {
  void* dev = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&dev, k3c_stamps);
  if (err == cudaSuccess)
    err = cudaMemcpy(host, dev, sizeof(k3c_stamps), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(k3c_stamps));
  return (int)err;
}
#endif

// K7: corr [D, (n_win + 1) N] complex64 -> out [D, N] float32.
extern "C" int pcps_window_fold(const void* corr, void* out, int n_dop, int n,
                                int n_win, void* stream) {
  if (n_dop < 1 || n_dop > 65535 || n < 1 || n_win < 1)
    return (int)cudaErrorInvalidValue;
  const int per_cta = 2 * kFoldThreads;
  const dim3 grid((unsigned)((n + per_cta - 1) / per_cta), (unsigned)n_dop);
  const bool vec = n % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(corr) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  auto kernel = vec ? &window_fold_kernel<true> : &window_fold_kernel<false>;
  kernel<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)corr, (float*)out, n, n_win);
  return (int)cudaGetLastError();
}
