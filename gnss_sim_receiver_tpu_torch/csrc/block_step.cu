// K8a and K8b: the body of the block-tracking scan, written for Hopper.
//
// Replace the body of gnss_sim_receiver_tpu/models/tracking_block.py:
// track_chunk_blocks (lines 180-575, run by jax.lax.scan at :576) around
// the correlation K1 (csrc/block_correlator.cu).  This file is not a
// translation unit of its own: block_correlator.cu includes it, so that
// K1, the closure and the prologue are one whole program (no relocatable
// device code, no cross-unit call).  A chunk of n blocks takes 1 + n
// launches and n replica cuFFTs on the card: this file's K8a for the first
// block, then per block the cuFFT and K1 with K8b's closure in its
// epilogue, which also writes the next block's prologue (the fold).  The
// standalone K8a and K8b kernels here are what the fused form is held
// against.
//
// K8a, the block prologue (tracking_block.py:204-257): per channel c the
// closed-form epoch boundaries of the block (n_cum, n_next, n_len,
// rem_end [C, E]; n_total, rem_new [C]), K1's inputs (w0, lag_int,
// lag_frac, ph_sc, tap_samps, omega) and the Doppler-ramped replica
//   rep_t[c, m] = codes_rep[c, m] * (cos, sin)(omega_c * float(m)).
// Standalone grid (ceil(F / 256), C): every CTA recomputes its channel's
// omega and writes its tile of the replica; the CTA of blockIdx.x == 0
// also writes the channel's [E] and [K] vectors.  Bound by writing the
// C x F complex64 replica (13 MB at the E1 shape, C = 10, F = 162000).
//
// K8b, the block closure (tracking_block.py:359-575): three warps per
// channel, lane e holding epoch e (E <= 32).  Warp 0 runs the chain the
// next block waits on: the Costas and E - L discriminators and their block
// means, the third-order PLL and second-order DLL, the FLL pull-in on the
// exact median of the E pair errors, lock and C/N0, the Kahan carrier
// phase and the commit under the active mask; beside it warp 1 runs the
// 20-bin bit-sync histogram with a first-index argmax and its commit, and
// warp 2 writes the block's E rows of the chunk's twelve [T, C] output
// planes.  It reads the state from one buffer and writes the next state
// into another (the caller ping-pongs two), so nothing is aliased.
// Latency-bound: it moves a few kB.
//
// The pilot form (a track_pilot chain, the JAX body's sec_code and
// data_codes_rep, tracking_block.py:301-357) is a second instantiation of
// each kernel: K8a ramps the data code's table beside the pilot's, into a
// [2, C, F] replica that one cuFFT transforms; K8b reads the data prompt
// (K1's last column) for the prompt plane and, before the discriminators,
// runs the block's secondary-code sync on every warp (lane i holds slot i
// of the 32-slot sign history; lane o < n_sec the hard match at offset o)
// and wipes the prompt, early and late taps where synced; warp 1 commits
// the sync.
//
// The arithmetic is the plain PyTorch version's, operation by operation
// (gnss_sim_receiver_tpu_torch/models/tracking_block.py:
// _block_prologue_plain, _block_closure_plain), as torch runs it on the
// card, where every op rounds on its own.  So every float product, sum,
// difference and quotient here is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which the compiler never
// contracts into an FMA: the file rounds the same under --fmad=true and
// --fmad=false, and K1 around it keeps nvcc's default contraction, which
// its accumulation was measured with.  That is why the block library
// needs no -rdc=true: until the rounding was written out, this file had
// to be built with --fmad=false in a unit of its own.  A division by a CPU
// scalar is a multiplication by its float reciprocal (what ATen's CUDA
// division does with a CPU-scalar divisor; the wrapper passes the
// reciprocals); rintf is torch.round (half to even); float remainders are
// floor-mods and the int32 window index a floor-division.  The means over
// E are sums in the order of ATen's CUDA reduction (row_sum).  No
// --use_fast_math: the ramp angle reaches ~250 rad at F = 162000, where
// __sinf loses it.

#include <math.h>

#include "block_step.cuh"

namespace {

constexpr int kPrologueThreads = 256;
constexpr int kMaxEpochs = 32;
constexpr int kMaxTaps = 8;
constexpr int kBits = 20;               // bit-sync histogram bins
constexpr int kSecMax = 32;             // the sign history's slots
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_div(int a, int b) {   // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// torch.remainder on floats (ATen's form)
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

// The sum of v over the lanes, in the order of ATen's CUDA reduction of a
// contiguous row of n <= 32 floats held by lanes < n, the other lanes
// holding 0 (torch.sum and torch.mean over the last dim; ATen's
// Reduce.cuh): lane x's value x + W added to lane x's (W the largest power
// of two <= n), then a shuffle-down tree at offsets W/2, ..., 2, 1, which
// is lane 0's sum in this butterfly (measured bit for bit against
// torch.sum on the H100 at n = 5 and 20); each value first added to the
// identity 0, as ATen adds it (a -0 becomes +0).  Returned to every lane.
__device__ __forceinline__ float row_sum(float v) {
  v = __fadd_rn(0.0f, v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// torch.mean over the row: the sum times float(1 / n), as ATen's mean
__device__ __forceinline__ float row_mean(float v, float inv_n) {
  return __fmul_rn(row_sum(v), inv_n);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the value of rank r among the n values held by lanes < n (ties broken by
// lane, as a stable sort places them)
__device__ __forceinline__ float warp_rank_value(float v, int rank, int r,
                                                 int n) {
  const int lane = threadIdx.x & 31;
  const unsigned hit = __ballot_sync(kFull, lane < n && rank == r);
  return __shfl_sync(kFull, v, __ffs(hit) - 1);
}

// ---- K8a -----------------------------------------------------------------

// the state fields of channel c that the prologue reads
struct ProState {
  float rate, dop, rem_code, rem_carr;
  int pos;
};

__device__ __forceinline__ ProState prologue_state(const PrologueArgs& a,
                                                   int c) {
  return {a.st.code_freq[c], a.st.carrier_doppler[c], a.st.rem_code_phase[c],
          a.st.rem_carr_phase[c], a.st.pos[c]};
}

// the Doppler ramp, rad/sample, of a channel at Doppler `dop`
__device__ __forceinline__ float prologue_ramp(const PrologueArgs& a,
                                               float dop) {
  return __fmul_rn(__fmul_rn(a.two_pi, dop), a.inv_fs);
}

// channel c's Doppler ramp
__device__ __forceinline__ float prologue_omega(const PrologueArgs& a,
                                                int c) {
  return prologue_ramp(a, a.st.carrier_doppler[c]);
}

// the replica of channel c over samples [lo, hi), one per thread of
// `n_threads` in turn: angle = omega * float(m), never accumulated
// (float(m) is exact below 2^24); kBatch samples of a thread at a time,
// their table loads issued together (the fold's CTAs write many samples
// each).  kFam families (2 in the pilot form: the pilot's and the data
// code's, C F apart) share each sample's phasor
template <int kBatch, int kFam>
__device__ __forceinline__ void prologue_replica(const PrologueArgs& a, int c,
                                                 float omega, int lo, int hi,
                                                 int tid, int n_threads) {
  const size_t stride = (size_t)a.n_ch * a.nfft;
  const float* codes = a.codes_rep + (size_t)c * a.nfft;
  float2* rep = a.out.rep_t + (size_t)c * a.nfft;
  for (int m0 = lo + tid; m0 < hi; m0 += kBatch * n_threads) {
    float code[kBatch][kFam];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u * n_threads;
#pragma unroll
      for (int f = 0; f < kFam; ++f)
        code[u][f] = m < hi ? codes[f * stride + m] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u * n_threads;
      if (m < hi) {
        float sn, co;
        sincosf(__fmul_rn(omega, (float)m), &sn, &co);
#pragma unroll
        for (int f = 0; f < kFam; ++f)
          rep[f * stride + m] = make_float2(__fmul_rn(code[u][f], co),
                                            __fmul_rn(code[u][f], sn));
      }
    }
  }
}

// channel c's epoch boundaries and K1's inputs from its state fields `s`:
// thread tid < E writes epoch tid's, tid < K tap tid's, tid 0 the scalars
__device__ __forceinline__ void prologue_vectors(const PrologueArgs& a, int c,
                                                 int tid, const ProState& s) {
  const int n_e = a.n_epochs;
  if (tid >= n_e && tid >= a.n_taps) return;
  const float rate = s.rate;
  const float dop = s.dop;
  const float omega = prologue_ramp(a, dop);
  const float s_per = __fmul_rn(__fdiv_rn(a.l_chips, rate), a.fs);
  const float u0 = __fmul_rn(__fdiv_rn(s.rem_code, rate), a.fs);
  const int pos = s.pos;
  int w0 = floor_div(pos, a.s0);
  w0 = w0 < 0 ? 0 : (w0 > a.w_max ? a.w_max : w0);
  // the FDMA bias rides in the Doppler but not in the code
  const float stretch = __fmul_rn(
      __fmul_rn(a.l_chips, __fsub_rn(dop, a.dop_bias)), a.inv_fc);
  const float half_stretch =                                  // samples
      __fmul_rn(__fdiv_rn(__fmul_rn(0.5f, stretch), rate), a.fs);
  if (tid < n_e) {
    const int ce = c * n_e + tid;
    const float e = (float)tid;
    const float ecs = __fsub_rn(__fmul_rn(e, s_per), u0);
    const float n_cum = rintf(ecs);
    const float ecs_next = __fsub_rn(__fmul_rn(__fadd_rn(e, 1.0f), s_per), u0);
    const float n_next = rintf(ecs_next);
    a.out.n_cum[ce] = n_cum;
    a.out.n_next[ce] = n_next;
    a.out.n_len[ce] = __fsub_rn(n_next, n_cum);
    a.out.rem_end[ce] =
        __fmul_rn(__fmul_rn(__fsub_rn(n_next, ecs_next), rate), a.inv_fs);
    const float d_int = (float)(pos - w0 * a.s0);
    float lag = __fadd_rn(
        __fadd_rn(d_int, __fsub_rn(ecs, __fmul_rn(e, (float)a.s0))), a.lead);
    lag = __fsub_rn(lag, half_stretch);
    a.out.ph_sc[ce] = __fadd_rn(
        s.rem_carr, __fmul_rn(omega, __fsub_rn(ecs, half_stretch)));
    const float lag_int = rintf(lag);
    a.out.lag_int[ce] = (int32_t)lag_int;
    a.out.lag_frac[ce] = __fsub_rn(lag, lag_int);
  }
  if (tid < a.n_taps)
    a.out.tap_samps[c * a.n_taps + tid] =
        __fmul_rn(__fdiv_rn(-a.taps[tid], rate), a.fs);
  if (tid == 0) {
    const float ecs_tot = __fsub_rn(__fmul_rn((float)n_e, s_per), u0);
    const float n_total = rintf(ecs_tot);
    a.out.n_total[c] = n_total;
    a.out.rem_new[c] =
        __fmul_rn(__fmul_rn(__fsub_rn(n_total, ecs_tot), rate), a.inv_fs);
    a.out.w0[c] = w0;
    a.out.omega[c] = omega;
  }
}

// one sample of the replica per thread (of each of the kFam families);
// the CTA that writes the vectors loads the state before the replica's
// stores, which the compiler cannot prove do not alias it, so that its
// loads overlap the table's (loaded after them, they would wait on the
// table load, the sincos and the stores); the other CTAs load only the
// Doppler
template <int kFam>
__global__ void __launch_bounds__(kPrologueThreads)
block_prologue_kernel(const __grid_constant__ PrologueArgs a) {
  const int c = blockIdx.y;
  const ProState s = blockIdx.x == 0
      ? prologue_state(a, c)
      : ProState{0.0f, a.st.carrier_doppler[c], 0.0f, 0.0f, 0};
  const int m = blockIdx.x * kPrologueThreads + threadIdx.x;
  if (m < a.nfft) {
    const size_t stride = (size_t)a.n_ch * a.nfft;
    const size_t i = (size_t)c * a.nfft + m;
    float code[kFam];
#pragma unroll
    for (int f = 0; f < kFam; ++f) code[f] = a.codes_rep[f * stride + i];
    float sn, co;
    sincosf(__fmul_rn(prologue_ramp(a, s.dop), (float)m), &sn, &co);
#pragma unroll
    for (int f = 0; f < kFam; ++f)
      a.out.rep_t[f * stride + i] =
          make_float2(__fmul_rn(code[f], co), __fmul_rn(code[f], sn));
  }
  if (blockIdx.x == 0) prologue_vectors(a, c, threadIdx.x, s);
}

bool prologue_args_invalid(const PrologueArgs& a, int n_ch) {
  return n_ch < 1 || a.n_epochs < 1 || a.n_epochs > kPrologueThreads ||
         a.n_taps < 1 || a.n_taps > kPrologueThreads || a.nfft < 1 ||
         a.s0 < 1 || a.n_ch != n_ch || a.families < 1 || a.families > 2;
}

// ---- K8b -----------------------------------------------------------------

constexpr int kCloseWarps = 3;          // the closure's warps per channel

// a secondary-code channel's sync state after the block (the pilot form)
struct SecSync {
  float buf;                            // lane i: slot i of the history
  bool synced;
  int32_t off;
  float polarity;
};

// one lane's view of the block: lane e holds epoch e (idle lanes mirror
// epoch 0); in the pilot form the prompt and its neighbours are wiped of
// the secondary code where synced, the data prompt beside them
struct CloseLane {
  int lane, n_e, e, ce;
  bool on, act;
  float rate, dop, t_blk;
  int32_t epoch;
  float2 prompt, early, late, data;
  SecSync sec;
};

__device__ __forceinline__ int floor_mod_i(int a, int b) {   // b > 0
  const int m = a % b;
  return m < 0 ? m + b : m;
}

// z times the real w as torch multiplies a complex tensor by a real one
// (w promoted to w + 0j): (x w - y 0, x 0 + y w)
__device__ __forceinline__ float2 cmul_real(float2 z, float w) {
  return make_float2(__fsub_rn(__fmul_rn(z.x, w), __fmul_rn(z.y, 0.0f)),
                     __fadd_rn(__fmul_rn(z.x, 0.0f), __fmul_rn(z.y, w)));
}

// The block's secondary-code sync of channel c, each lane of a warp
// holding one slot of the sign history: the E prompt signs (lane e's,
// before the wipe) roll into the 32-slot history, then lane o < n_sec
// holds the hard match of the last n_sec slots against the code at
// offset o, m_o = sum_j last_j sec[(e_last - (n_sec - 1 - j) + o) mod
// n_sec] (integers: exact in any order); the first largest |m_o| is a
// hit when it reaches n_sec, and a newly synced active channel takes o
// and the sign of m_o.  Returns the sync state and the lane's wipe.
__device__ __forceinline__ float close_sec(const ClosureArgs& a, int c,
                                           const CloseLane& l, SecSync& out) {
  const int n = a.n_sec;
  const int e_n = l.n_e;
  const float sgn = l.prompt.x >= 0.0f ? 1.0f : -1.0f;
  const float from_sign = __shfl_sync(kFull, sgn, (l.lane + e_n) & 31);
  out.buf = l.lane + e_n < kSecMax
      ? a.src.sec_buf[c * kSecMax + l.lane + e_n] : from_sign;
  const int e_last = l.epoch + e_n - 1;
  const int o = l.lane < n ? l.lane : 0;
  float m = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float last = __shfl_sync(kFull, out.buf, kSecMax - n + j);
    m = __fadd_rn(m, __fmul_rn(
        last, a.sec_code[floor_mod_i(e_last - (n - 1 - j) + o, n)]));
  }
  const float mag = l.lane < n ? fabsf(m) : -1.0f;
  const float top = warp_max(mag);
  const int best = __ffs(__ballot_sync(kFull, l.lane < n && mag == top)) - 1;
  const float best_val = __shfl_sync(kFull, m, best);
  const bool hit = fabsf(best_val) >= (float)n;
  const bool synced0 = a.src.sec_synced[c] != 0;
  const bool newly = hit && !synced0 && l.act;
  out.synced = synced0 || newly;
  out.off = newly ? best : a.src.sec_off[c];
  out.polarity = newly ? (best_val > 0.0f ? 1.0f : -1.0f)
                       : a.src.sec_polarity[c];
  const float chip = __fmul_rn(
      a.sec_code[floor_mod_i(l.epoch + l.e + out.off, n)], out.polarity);
  return out.synced ? chip : 1.0f;
}

template <bool kPilot>
__device__ __forceinline__ CloseLane close_lane(const ClosureArgs& a, int c) {
  CloseLane l;
  l.lane = threadIdx.x & 31;
  l.n_e = a.n_epochs;
  l.on = l.lane < l.n_e;
  l.e = l.on ? l.lane : 0;
  l.ce = c * l.n_e + l.e;
  l.act = a.src.active[c] != 0;
  l.rate = a.src.code_freq[c];
  l.dop = a.src.carrier_doppler[c];
  l.epoch = a.src.epoch[c];
  const float2* cr = a.corr + (size_t)l.ce * (a.n_taps + kPilot);
  const int pi = a.n_taps / 2;
  l.prompt = cr[pi];
  l.early = cr[pi - 1];
  l.late = cr[pi + 1];
  l.t_blk = __fmul_rn(a.pro.n_total[c], a.inv_fs);
  if (kPilot) {
    l.data = cr[a.n_taps];
    const float wipe = close_sec(a, c, l, l.sec);
    l.prompt = cmul_real(l.prompt, wipe);
    l.early = cmul_real(l.early, wipe);
    l.late = cmul_real(l.late, wipe);
  }
  return l;
}

// lock and C/N0 over the block: (carrier lock, C/N0 in dB-Hz)
__device__ __forceinline__ float2 close_lock(const ClosureArgs& a,
                                             const CloseLane& l) {
  const float pi_ = l.prompt.x;
  const float pq_ = l.prompt.y;
  const float ii = __fmul_rn(pi_, pi_);
  const float qq = __fmul_rn(pq_, pq_);
  const float p2 = __fadd_rn(ii, qq);
  const float lock_e = __fdiv_rn(__fsub_rn(ii, qq), fmaxf(p2, 1e-12f));
  const float carrier_lock =
      row_mean(l.on ? lock_e : 0.0f, a.inv_e);
  const float mean_abs_i =
      row_mean(l.on ? fabsf(pi_) : 0.0f, a.inv_e);
  const float total = row_mean(l.on ? p2 : 0.0f, a.inv_e);
  const float sig = __fmul_rn(mean_abs_i, mean_abs_i);
  const float noise = fmaxf(__fsub_rn(total, sig), 1e-12f);
  const float t_sym = __fmul_rn(l.t_blk, a.inv_e);
  const float cn0_lin = __fdiv_rn(fmaxf(__fdiv_rn(sig, noise), 1e-6f), t_sym);
  return make_float2(carrier_lock, __fmul_rn(10.0f, log10f(cn0_lin)));
}

// the median of the E lanes' values f: every lane ranks its value, then
// the midpoint rule (the mean of the two middle values for an even E)
__device__ __forceinline__ float lane_median(float f, const CloseLane& l) {
  int rank = 0;
  for (int j = 0; j < l.n_e; ++j) {
    const float v = __shfl_sync(kFull, f, j);
    rank += (v < f || (v == f && j < l.lane)) ? 1 : 0;
  }
  const float lo = warp_rank_value(f, rank, (l.n_e - 1) / 2, l.n_e);
  const float hi = warp_rank_value(f, rank, l.n_e / 2, l.n_e);
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// warp 1: the bit-sync histogram (lane p < 20 holds bin p) and its commit,
// and in the pilot form the secondary-code sync's
template <bool kPilot>
__device__ __forceinline__ void close_bit_sync(const ClosureArgs& a, int c,
                                               const CloseLane& l) {
  const StatePtrs& s = a.src;
  const StatePtrs& d = a.dst;
  const float sign_e = l.prompt.x >= 0.0f ? 1.0f : -1.0f;
  float prev_sign = __shfl_up_sync(kFull, sign_e, 1);
  if (l.lane == 0) prev_sign = s.prev_sign[c];
  const bool tr = l.on && prev_sign != 0.0f && sign_e != prev_sign;
  int phase_mod = (l.epoch + l.e) % kBits;
  if (phase_mod < 0) phase_mod += kBits;
  const int tr_bin = tr ? phase_mod : -1;
  float inc = 0.0f;
  for (int j = 0; j < l.n_e; ++j)
    inc = __fadd_rn(inc,
                    __shfl_sync(kFull, tr_bin, j) == l.lane ? 1.0f : 0.0f);
  const bool bin = l.lane < kBits;
  const float hist_in = bin ? s.bit_hist[c * kBits + l.lane] : 0.0f;
  const float hist = bin ? __fadd_rn(hist_in, inc) : 0.0f;
  const float hist_total = row_sum(hist);               // integer counts
  const float peak = warp_max(bin ? hist : -INFINITY);
  const int top = __ffs(__ballot_sync(kFull, bin && hist == peak)) - 1;
  const bool sync_ok = (hist_total >= a.bit_sync_min) &&
                       (peak >= __fmul_rn(0.8f, hist_total));
  const bool was_synced = s.bit_synced[c] != 0;
  const bool newly_bit = sync_ok && !was_synced && l.act;
  const float last_sign = __shfl_sync(kFull, sign_e, l.n_e - 1);
  if (bin) d.bit_hist[c * kBits + l.lane] = l.act ? hist : hist_in;
  if (kPilot) {                         // the secondary-code sync's commit
    const int slot = c * kSecMax + l.lane;
    d.sec_buf[slot] = l.act ? l.sec.buf : s.sec_buf[slot];
    if (l.lane == 0) {
      d.sec_synced[c] = l.act ? (l.sec.synced ? 1 : 0) : s.sec_synced[c];
      d.sec_off[c] = l.act ? l.sec.off : s.sec_off[c];
      d.sec_polarity[c] = l.act ? l.sec.polarity : s.sec_polarity[c];
    }
  }
  if (l.lane != 0) return;
  d.prev_sign[c] = l.act ? last_sign : s.prev_sign[c];
  d.bit_synced[c] =
      l.act ? ((was_synced || newly_bit) ? 1 : 0) : s.bit_synced[c];
  d.bit_phase[c] = newly_bit ? top : s.bit_phase[c];
}

// warp 2: the block's E rows of the output planes (the prompt plane the
// data prompt in the pilot form)
template <bool kPilot>
__device__ __forceinline__ void close_planes(const ClosureArgs& a, int c,
                                             int block, const CloseLane& l) {
  const StatePtrs& s = a.src;
  const float cn0_db = close_lock(a, l).y;
  if (!l.on) return;
  const size_t o = ((size_t)block * l.n_e + l.lane) * a.n_ch + c;
  const float rem_end = a.pro.rem_end[l.ce];
  a.planes.prompt[o] = kPilot ? l.data : l.prompt;
  a.planes.early_mag[o] = hypotf(l.early.x, l.early.y);
  a.planes.late_mag[o] = hypotf(l.late.x, l.late.y);
  a.planes.carrier_doppler_hz[o] = l.dop;
  a.planes.code_freq_cps[o] = l.rate;
  a.planes.rem_code_phase_chips[o] = rem_end;
  a.planes.acc_phase_cycles[o] = __fadd_rn(
      __fsub_rn(s.acc_phase_cycles[c], s.acc_phase_comp[c]),
      __fmul_rn(l.dop, __fmul_rn(a.pro.n_next[l.ce], a.inv_fs)));
  a.planes.code_phase_samples[o] =
      __fmul_rn(__fdiv_rn(rem_end, l.rate), a.fs);
  a.planes.pos_start[o] = s.pos[c] + (int32_t)a.pro.n_cum[l.ce];
  a.planes.n_samples[o] = (int32_t)a.pro.n_len[l.ce];
  a.planes.cn0_db_hz[o] = cn0_db;
  a.planes.valid[o] = l.act ? 1 : 0;
}

// The block's loop closure of channel c, run by kCloseWarps whole warps:
// reads a.corr, a.pro and a.src, commits a.dst and writes the block's rows
// block*E.. of the planes.  Warp 0 runs the loops (discriminators and
// means, PLL, DLL, FLL median), lock and C/N0, the carrier phase and the
// commit of everything but the bit sync; warp 1 the bit-sync histogram
// and its commit; warp 2 the plane rows.  Where `next` is given (the fold,
// with the channel's flag `flag` read as `gen` before the launch's
// arrivals), warp 0 writes the next block's omega from the committed
// Doppler as soon as it has it and publishes gen + 1 with release order,
// so that the channel's other CTAs start on the next replica while the
// closure goes on.  kPilot: the pilot form (a.sec_code, the data prompt as
// the correlations' last column), whose every warp runs the
// secondary-code sync on its lanes and wipes the taps (close_lane).
template <bool kPilot>
__device__ __forceinline__ void block_close(const ClosureArgs& a, int c,
                                            int block,
                                            const PrologueArgs* next = nullptr,
                                            unsigned* flag = nullptr,
                                            unsigned gen = 0u) {
  const CloseLane l = close_lane<kPilot>(a, c);
  const int warp = threadIdx.x >> 5;
  if (warp == 1) {
    close_bit_sync<kPilot>(a, c, l);
    return;
  }
  if (warp == 2) {
    close_planes<kPilot>(a, c, block, l);
    return;
  }
  const StatePtrs& s = a.src;
  const StatePtrs& d = a.dst;
  const float2 prompt = l.prompt;
  const float t_blk = l.t_blk;

  // ---- per-epoch discriminators, block means ---------------------------
  const float sgn_i = (float)((0.0f < prompt.x) - (prompt.x < 0.0f));
  const float carr_err = __fmul_rn(
      atan2f(__fmul_rn(prompt.y, sgn_i), fabsf(prompt.x)), a.inv_two_pi);
  const float early_mag = hypotf(l.early.x, l.early.y);
  const float late_mag = hypotf(l.late.x, l.late.y);
  const float denom = __fadd_rn(early_mag, late_mag);
  const float raw = denom > 0.0f
      ? __fdiv_rn(__fsub_rn(early_mag, late_mag), fmaxf(denom, 1e-20f))
      : 0.0f;
  const float code_err = __fmul_rn(a.el_gain, raw);
  const float carr_err_m =
      row_mean(l.on ? carr_err : 0.0f, a.inv_e);
  const float code_err_m =
      row_mean(l.on ? code_err : 0.0f, a.inv_e);

  // ---- loop filters: third-order PLL (narrow), second-order DLL ---------
  float pll_acc = __fadd_rn(
      s.pll_acc[c], __fmul_rn(__fmul_rn(a.pll_k3, t_blk), carr_err_m));
  float pll_vel = __fadd_rn(
      s.pll_vel[c],
      __fmul_rn(t_blk, __fadd_rn(pll_acc, __fmul_rn(a.pll_k11, carr_err_m))));
  float doppler_new = __fadd_rn(pll_vel, __fmul_rn(a.pll_k24, carr_err_m));
  const float bw = s.ext_n[c] < 50 ? a.dll_bw_wide : a.dll_bw_narrow;
  const float wn = __fmul_rn(bw, a.inv_053);
  const float dll_vel = __fadd_rn(
      s.dll_vel[c],
      __fmul_rn(__fmul_rn(__fmul_rn(wn, wn), t_blk), code_err_m));
  const float dll_out = __fadd_rn(
      dll_vel, __fmul_rn(__fmul_rn(1.414213562f, wn), code_err_m));

  // ---- FLL pull-in on the median pair error ------------------------------
  const bool pullin_epochs = l.epoch < a.fll_pullin_epochs;
  if (a.enable_fll) {
    float2 prev;
    prev.x = __shfl_up_sync(kFull, prompt.x, 1);
    prev.y = __shfl_up_sync(kFull, prompt.y, 1);
    if (l.lane == 0) prev = s.prompt_prev[c];
    const float t_pair = __fmul_rn(a.pro.n_len[l.ce], a.inv_fs);
    const float cross = __fsub_rn(__fmul_rn(prev.x, prompt.y),
                                  __fmul_rn(prompt.x, prev.y));
    const float dot = __fadd_rn(__fmul_rn(prev.x, prompt.x),
                                __fmul_rn(prev.y, prompt.y));
    const float sgn = dot >= 0.0f ? 1.0f : -1.0f;
    const float two_quadrant = __fdiv_rn(
        atan2f(__fmul_rn(cross, sgn), fabsf(dot)),
        __fmul_rn(a.two_pi, t_pair));
    float f_err_m;
    if (a.fll_decision) {
      f_err_m = lane_median(two_quadrant, l);
    } else {
      f_err_m = lane_median(
          __fdiv_rn(atan2f(cross, dot), __fmul_rn(a.two_pi, t_pair)), l);
      // a secondary-code chain before its sync: the two-quadrant form
      if (kPilot && !l.sec.synced) f_err_m = lane_median(two_quadrant, l);
    }
    const bool in_pullin =
        pullin_epochs || (s.carrier_lock[c] < a.lock_threshold);
    float g_fll = __fmul_rn(a.fll_k4, t_blk);
    g_fll = isnan(g_fll) ? g_fll : fminf(g_fll, 0.5f);
    const float g_eff = pullin_epochs ? g_fll : __fmul_rn(0.3f, g_fll);
    const float nudge = in_pullin ? __fmul_rn(g_eff, f_err_m) : 0.0f;
    doppler_new = __fadd_rn(doppler_new, nudge);
    pll_vel = __fadd_rn(pll_vel, nudge);
  }
  const float dop_next = l.act ? doppler_new : l.dop;
  if (next && l.lane == 0) {
    // the next block's ramp, as prologue_omega computes it from the state
    next->out.omega[c] =
        __fmul_rn(__fmul_rn(next->two_pi, dop_next), next->inv_fs);
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(flag),
                 "r"(gen + 1u) : "memory");
  }
  const float code_freq_new = __fadd_rn(
      __fmul_rn(a.code_rate,
                __fadd_rn(1.0f, __fmul_rn(__fsub_rn(doppler_new, a.dop_bias),
                                          a.inv_fc))),
      dll_out);

  // ---- lock / C/N0 over the block ----------------------------------------
  const float2 lock = close_lock(a, l);
  const float carrier_lock = lock.x;
  const float cn0_db = lock.y;
  const bool bad = ((carrier_lock < a.lock_threshold) || (cn0_db < a.cn0_min))
                   && !pullin_epochs;
  const float lock_fail = s.lock_fail[c];
  const float fail = bad ? __fadd_rn(lock_fail, 1.0f)
                         : fmaxf(__fsub_rn(lock_fail, 1.0f), 0.0f);
  const bool lost = fail > a.max_lock_fail;

  // ---- carrier phase (Kahan over blocks, not re-associated) --------------
  const float acc_cyc = s.acc_phase_cycles[c];
  const float acc_comp = s.acc_phase_comp[c];
  const float y_k = __fsub_rn(__fmul_rn(l.dop, t_blk), acc_comp);
  const float t_sum = __fadd_rn(acc_cyc, y_k);
  const float comp = __fsub_rn(__fsub_rn(t_sum, acc_cyc), y_k);
  const float rem_carr_new = floor_mod(
      __fadd_rn(s.rem_carr_phase[c],
                __fmul_rn(__fmul_rn(a.two_pi, l.dop), t_blk)),
      a.two_pi);

  // ---- masked commit (inactive channels advance nominally) ---------------
  const float2 last_prompt =
      make_float2(__shfl_sync(kFull, prompt.x, l.n_e - 1),
                  __shfl_sync(kFull, prompt.y, l.n_e - 1));
  if (l.lane != 0) return;
  const bool act = l.act;
  const int32_t pos = s.pos[c];
  d.active[c] = (act && !lost) ? 1 : 0;
  d.pos[c] = act ? pos + (int32_t)a.pro.n_total[c] : pos + l.n_e * a.s0;
  d.rem_code_phase[c] = act ? a.pro.rem_new[c] : s.rem_code_phase[c];
  d.code_freq[c] = act ? code_freq_new : l.rate;
  d.carrier_doppler[c] = dop_next;
  d.rem_carr_phase[c] = act ? rem_carr_new : s.rem_carr_phase[c];
  d.acc_phase_cycles[c] = act ? t_sum : acc_cyc;
  d.acc_phase_comp[c] = act ? comp : acc_comp;
  d.dll_vel[c] = act ? dll_vel : s.dll_vel[c];
  d.dll_acc[c] = s.dll_acc[c];
  d.pll_vel[c] = act ? pll_vel : s.pll_vel[c];
  d.pll_acc[c] = act ? pll_acc : s.pll_acc[c];
  d.prompt_prev[c] = act ? last_prompt : s.prompt_prev[c];
  d.epoch[c] = act ? l.epoch + l.n_e : l.epoch;
  d.cn0_db_hz[c] = act ? cn0_db : s.cn0_db_hz[c];
  d.carrier_lock[c] = act ? carrier_lock : s.carrier_lock[c];
  d.lock_fail[c] = act ? fail : lock_fail;
  d.lock_lost[c] = act ? (lost ? 1 : 0) : s.lock_lost[c];
  const int32_t ext_n = s.ext_n[c];
  d.ext_n[c] = act ? (ext_n + 1 < 10000 ? ext_n + 1 : 10000) : ext_n;
}

template <bool kPilot>
__global__ void __launch_bounds__(32 * kCloseWarps)
block_closure_kernel(const __grid_constant__ ClosureArgs a, int block) {
  block_close<kPilot>(a, blockIdx.x, block);
}

// true where the closure's arguments are past what it takes (the pilot
// form: a secondary code of 1 to 32 chips)
bool closure_args_invalid(const ClosureArgs& a, int block) {
  return a.n_ch < 1 || a.n_epochs < 1 || a.n_epochs > kMaxEpochs ||
         a.n_taps < 3 || a.n_taps > kMaxTaps || a.n_taps % 2 == 0 ||
         block < 0 || (block + 1) * a.n_epochs > a.n_rows ||
         (a.sec_code != nullptr) != (a.n_sec > 0) || a.n_sec < 0 ||
         a.n_sec > kSecMax;
}

}  // namespace

extern "C" int block_prologue(PrologueArgs a, int n_ch, void* stream) {
  if (prologue_args_invalid(a, n_ch)) return (int)cudaErrorInvalidValue;
  dim3 grid((a.nfft + kPrologueThreads - 1) / kPrologueThreads, n_ch);
  auto kernel = a.families == 2 ? block_prologue_kernel<2>
                                : block_prologue_kernel<1>;
  kernel<<<grid, kPrologueThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int block_closure(ClosureArgs a, int block, void* stream) {
  if (closure_args_invalid(a, block)) return (int)cudaErrorInvalidValue;
  auto kernel = a.n_sec > 0 ? block_closure_kernel<true>
                            : block_closure_kernel<false>;
  kernel<<<a.n_ch, 32 * kCloseWarps, 0, (cudaStream_t)stream>>>(a, block);
  return (int)cudaGetLastError();
}
