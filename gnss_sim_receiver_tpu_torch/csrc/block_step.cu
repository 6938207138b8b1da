// K8a and K8b: the body of the block-tracking scan, written for Hopper.
//
// Replace the body of gnss_sim_receiver_tpu/models/tracking_block.py:
// track_chunk_blocks (lines 180-575, run by jax.lax.scan at :576) around
// the correlation K1 (csrc/block_correlator.cu).  One block of E epochs
// takes three launches on the card: K8a, the replica cuFFT, and K1 with
// K8b's closure (the device function block_close) in its epilogue.  The
// standalone K8b kernel here, a thin wrapper over block_close, is what
// that fused form is held against.
//
// K8a, block_prologue (tracking_block.py:204-257): per channel c the
// closed-form epoch boundaries of the block (n_cum, n_next, n_len,
// rem_end [C, E]; n_total, rem_new [C]), K1's inputs (w0, lag_int,
// lag_frac, ph_sc, tap_samps, omega) and the Doppler-ramped replica
//   rep_t[c, m] = codes_rep[c, m] * (cos, sin)(omega_c * float(m)).
// Grid (ceil(F / 256), C): every CTA recomputes its channel's omega and
// writes its tile of the replica; the CTA of blockIdx.x == 0 also writes
// the channel's [E] and [K] vectors.  Bound by writing the C x F complex64
// replica (13 MB at the E1 shape, C = 10, F = 162000).
//
// K8b, block_close (tracking_block.py:359-575): one warp per channel,
// lane e holding epoch e (E <= 32): the Costas and E - L discriminators and
// their block means (warp shuffles), the third-order PLL and second-order
// DLL, the FLL pull-in on the exact median of the E pair errors, lock and
// C/N0, the 20-bin bit-sync histogram with a first-index argmax, the Kahan
// carrier phase, the commit under the active mask, and the block's E rows
// of the chunk's twelve [T, C] output planes.  It reads the state from one
// buffer and writes the next state into another (the caller ping-pongs
// two), so nothing is aliased.  Launch-latency bound: it moves a few kB.
//
// The arithmetic is the plain PyTorch version's, operation by operation
// (gnss_sim_receiver_tpu_torch/models/tracking_block.py:
// _block_prologue_plain, _block_closure_plain), as torch runs it on the
// card: this file is built with --fmad=false so no a*b+c is contracted
// (each torch op rounds on its own); a division by a CPU scalar is a
// multiplication by its float reciprocal (what ATen's CUDA division does
// with a CPU-scalar divisor; the wrapper passes the reciprocals); rintf is
// torch.round (half to even); float remainders are floor-mods and the
// int32 window index a floor-division.  The means over E run in another
// order than torch's reduction (a few ulps).  No --use_fast_math: the ramp
// angle reaches ~250 rad at F = 162000, where __sinf loses it.

#include <math.h>

#include "block_step.cuh"

namespace {

constexpr int kPrologueThreads = 256;
constexpr int kMaxEpochs = 32;
constexpr int kMaxTaps = 8;
constexpr int kBits = 20;               // bit-sync histogram bins
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_div(int a, int b) {   // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// torch.remainder on floats (ATen's form)
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

__global__ void __launch_bounds__(kPrologueThreads)
block_prologue_kernel(PrologueArgs a) {
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float rate = a.st.code_freq[c];
  const float dop = a.st.carrier_doppler[c];
  const float omega = a.two_pi * dop * a.inv_fs;

  // the Doppler-ramped replica tile: angle = omega * float(m), never
  // accumulated (float(m) is exact below 2^24)
  const int m = blockIdx.x * kPrologueThreads + tid;
  if (m < a.nfft) {
    const size_t idx = (size_t)c * a.nfft + m;
    float s, co;
    sincosf(omega * (float)m, &s, &co);
    const float code = a.codes_rep[idx];
    a.out.rep_t[idx] = make_float2(code * co, code * s);
  }
  if (blockIdx.x != 0) return;

  const int n_e = a.n_epochs;
  const float s_per = a.l_chips / rate * a.fs;
  const float u0 = a.st.rem_code_phase[c] / rate * a.fs;
  const int pos = a.st.pos[c];
  int w0 = floor_div(pos, a.s0);
  w0 = w0 < 0 ? 0 : (w0 > a.w_max ? a.w_max : w0);
  const float stretch = a.l_chips * dop * a.inv_fc;
  const float half_stretch = 0.5f * stretch / rate * a.fs;   // samples
  if (tid < n_e) {
    const int ce = c * n_e + tid;
    const float e = (float)tid;
    const float ecs = e * s_per - u0;
    const float n_cum = rintf(ecs);
    const float ecs_next = (e + 1.0f) * s_per - u0;
    const float n_next = rintf(ecs_next);
    a.out.n_cum[ce] = n_cum;
    a.out.n_next[ce] = n_next;
    a.out.n_len[ce] = n_next - n_cum;
    a.out.rem_end[ce] = (n_next - ecs_next) * rate * a.inv_fs;
    const float d_int = (float)(pos - w0 * a.s0);
    float lag = d_int + (ecs - e * (float)a.s0) + a.lead;
    lag = lag - half_stretch;
    a.out.ph_sc[ce] = a.st.rem_carr_phase[c] + omega * (ecs - half_stretch);
    const float lag_int = rintf(lag);
    a.out.lag_int[ce] = (int32_t)lag_int;
    a.out.lag_frac[ce] = lag - lag_int;
  }
  if (tid < a.n_taps)
    a.out.tap_samps[c * a.n_taps + tid] = -a.taps[tid] / rate * a.fs;
  if (tid == 0) {
    const float ecs_tot = (float)n_e * s_per - u0;
    const float n_total = rintf(ecs_tot);
    a.out.n_total[c] = n_total;
    a.out.rem_new[c] = (n_total - ecs_tot) * rate * a.inv_fs;
    a.out.w0[c] = w0;
    a.out.omega[c] = omega;
  }
}

}  // namespace

__device__ void block_close(const ClosureArgs& a, int c, int block) {
  const int lane = threadIdx.x & 31;
  const int n_e = a.n_epochs;
  const bool on = lane < n_e;
  const int e = on ? lane : 0;          // idle lanes mirror epoch 0
  const int ce = c * n_e + e;
  const StatePtrs& s = a.src;
  const StatePtrs& d = a.dst;

  const bool act = s.active[c] != 0;
  const float rate = s.code_freq[c];
  const float dop = s.carrier_doppler[c];
  const int32_t epoch = s.epoch[c];
  const float2* cr = a.corr + (size_t)ce * a.n_taps;
  const int pi = a.n_taps / 2;
  const float2 prompt = cr[pi];
  const float2 early = cr[pi - 1];
  const float2 late = cr[pi + 1];
  const float n_total = a.pro.n_total[c];
  const float t_blk = n_total * a.inv_fs;

  // ---- per-epoch discriminators, block means ---------------------------
  const float sgn_i = (float)((0.0f < prompt.x) - (prompt.x < 0.0f));
  const float carr_err =
      atan2f(prompt.y * sgn_i, fabsf(prompt.x)) * a.inv_two_pi;
  const float early_mag = hypotf(early.x, early.y);
  const float late_mag = hypotf(late.x, late.y);
  const float denom = early_mag + late_mag;
  const float raw =
      denom > 0.0f ? (early_mag - late_mag) / fmaxf(denom, 1e-20f) : 0.0f;
  const float code_err = a.el_gain * raw;
  const float carr_err_m = warp_sum(on ? carr_err : 0.0f) * a.inv_e;
  const float code_err_m = warp_sum(on ? code_err : 0.0f) * a.inv_e;

  // ---- loop filters: third-order PLL (narrow), second-order DLL ---------
  float pll_acc = s.pll_acc[c] + a.pll_k3 * t_blk * carr_err_m;
  float pll_vel = s.pll_vel[c] + t_blk * (pll_acc + a.pll_k11 * carr_err_m);
  float doppler_new = pll_vel + a.pll_k24 * carr_err_m;
  const float bw = s.ext_n[c] < 50 ? a.dll_bw_wide : a.dll_bw_narrow;
  const float wn = bw * a.inv_053;
  const float dll_vel = s.dll_vel[c] + wn * wn * t_blk * code_err_m;
  const float dll_out = dll_vel + 1.414213562f * wn * code_err_m;

  // ---- FLL pull-in on the median pair error ------------------------------
  const bool pullin_epochs = epoch < a.fll_pullin_epochs;
  if (a.enable_fll) {
    float2 prev;
    prev.x = __shfl_up_sync(kFull, prompt.x, 1);
    prev.y = __shfl_up_sync(kFull, prompt.y, 1);
    if (lane == 0) prev = s.prompt_prev[c];
    const float t_pair = a.pro.n_len[ce] * a.inv_fs;
    const float cross = prev.x * prompt.y - prompt.x * prev.y;
    const float dot = prev.x * prompt.x + prev.y * prompt.y;
    float f_err;
    if (a.fll_decision) {
      const float sgn = dot >= 0.0f ? 1.0f : -1.0f;
      f_err = atan2f(cross * sgn, fabsf(dot)) / (a.two_pi * t_pair);
    } else {
      f_err = atan2f(cross, dot) / (a.two_pi * t_pair);
    }
    // exact median: every lane ranks its value, then the midpoint rule
    int rank = 0;
    for (int j = 0; j < n_e; ++j) {
      const float v = __shfl_sync(kFull, f_err, j);
      rank += (v < f_err || (v == f_err && j < lane)) ? 1 : 0;
    }
    const float lo = warp_rank_value(f_err, rank, (n_e - 1) / 2, n_e);
    const float hi = warp_rank_value(f_err, rank, n_e / 2, n_e);
    const float f_err_m = (lo + hi) * 0.5f;
    const bool in_pullin =
        pullin_epochs || (s.carrier_lock[c] < a.lock_threshold);
    float g_fll = a.fll_k4 * t_blk;
    g_fll = isnan(g_fll) ? g_fll : fminf(g_fll, 0.5f);
    const float g_eff = pullin_epochs ? g_fll : 0.3f * g_fll;
    const float nudge = in_pullin ? g_eff * f_err_m : 0.0f;
    doppler_new = doppler_new + nudge;
    pll_vel = pll_vel + nudge;
  }
  const float code_freq_new =
      a.code_rate * (1.0f + doppler_new * a.inv_fc) + dll_out;

  // ---- lock / C/N0 over the block ----------------------------------------
  const float pi_ = prompt.x;
  const float pq_ = prompt.y;
  const float p2 = pi_ * pi_ + pq_ * pq_;
  const float lock_e = (pi_ * pi_ - pq_ * pq_) / fmaxf(p2, 1e-12f);
  const float carrier_lock = warp_sum(on ? lock_e : 0.0f) * a.inv_e;
  const float mean_abs_i = warp_sum(on ? fabsf(pi_) : 0.0f) * a.inv_e;
  const float total = warp_sum(on ? p2 : 0.0f) * a.inv_e;
  const float sig = mean_abs_i * mean_abs_i;
  const float noise = fmaxf(total - sig, 1e-12f);
  const float t_sym = t_blk * a.inv_e;
  const float cn0_lin = fmaxf(sig / noise, 1e-6f) / t_sym;
  const float cn0_db = 10.0f * log10f(cn0_lin);
  const bool bad = ((carrier_lock < a.lock_threshold) || (cn0_db < a.cn0_min))
                   && !pullin_epochs;
  const float lock_fail = s.lock_fail[c];
  const float fail = bad ? lock_fail + 1.0f : fmaxf(lock_fail - 1.0f, 0.0f);
  const bool lost = fail > a.max_lock_fail;

  // ---- bit-sync histogram: lane p < 20 holds bin p -----------------------
  const float sign_e = pi_ >= 0.0f ? 1.0f : -1.0f;
  float prev_sign = __shfl_up_sync(kFull, sign_e, 1);
  if (lane == 0) prev_sign = s.prev_sign[c];
  const bool tr = on && prev_sign != 0.0f && sign_e != prev_sign;
  int phase_mod = (epoch + e) % kBits;
  if (phase_mod < 0) phase_mod += kBits;
  const int tr_bin = tr ? phase_mod : -1;
  float inc = 0.0f;
  for (int j = 0; j < n_e; ++j)
    inc += __shfl_sync(kFull, tr_bin, j) == lane ? 1.0f : 0.0f;
  const bool bin = lane < kBits;
  const float hist = bin ? s.bit_hist[c * kBits + lane] + inc : 0.0f;
  const float hist_total = warp_sum(hist);
  const float peak = warp_max(bin ? hist : -INFINITY);
  const int top = __ffs(__ballot_sync(kFull, bin && hist == peak)) - 1;
  const bool sync_ok =
      (hist_total >= a.bit_sync_min) && (peak >= 0.8f * hist_total);
  const bool was_synced = s.bit_synced[c] != 0;
  const bool newly_bit = sync_ok && !was_synced && act;

  // ---- carrier phase (Kahan over blocks, not re-associated) --------------
  const float acc_cyc = s.acc_phase_cycles[c];
  const float acc_comp = s.acc_phase_comp[c];
  const float y_k = dop * t_blk - acc_comp;
  const float t_sum = acc_cyc + y_k;
  const float comp = (t_sum - acc_cyc) - y_k;
  const float rem_carr_new =
      floor_mod(s.rem_carr_phase[c] + a.two_pi * dop * t_blk, a.two_pi);

  // ---- the block's rows of the output planes -----------------------------
  const int32_t pos = s.pos[c];
  if (on) {
    const size_t o = ((size_t)block * n_e + lane) * a.n_ch + c;
    const float rem_end = a.pro.rem_end[ce];
    a.planes.prompt[o] = prompt;
    a.planes.early_mag[o] = early_mag;
    a.planes.late_mag[o] = late_mag;
    a.planes.carrier_doppler_hz[o] = dop;
    a.planes.code_freq_cps[o] = rate;
    a.planes.rem_code_phase_chips[o] = rem_end;
    a.planes.acc_phase_cycles[o] =
        (acc_cyc - acc_comp) + dop * (a.pro.n_next[ce] * a.inv_fs);
    a.planes.code_phase_samples[o] = rem_end / rate * a.fs;
    a.planes.pos_start[o] = pos + (int32_t)a.pro.n_cum[ce];
    a.planes.n_samples[o] = (int32_t)a.pro.n_len[ce];
    a.planes.cn0_db_hz[o] = cn0_db;
    a.planes.valid[o] = act ? 1 : 0;
  }

  // ---- masked commit (inactive channels advance nominally) ---------------
  if (bin) d.bit_hist[c * kBits + lane] = act ? hist : s.bit_hist[c * kBits + lane];
  const float2 last_prompt = make_float2(
      __shfl_sync(kFull, prompt.x, n_e - 1), __shfl_sync(kFull, prompt.y, n_e - 1));
  const float last_sign = __shfl_sync(kFull, sign_e, n_e - 1);
  if (lane != 0) return;
  d.active[c] = (act && !lost) ? 1 : 0;
  d.pos[c] = act ? pos + (int32_t)n_total : pos + n_e * a.s0;
  d.rem_code_phase[c] = act ? a.pro.rem_new[c] : s.rem_code_phase[c];
  d.code_freq[c] = act ? code_freq_new : rate;
  d.carrier_doppler[c] = act ? doppler_new : dop;
  d.rem_carr_phase[c] = act ? rem_carr_new : s.rem_carr_phase[c];
  d.acc_phase_cycles[c] = act ? t_sum : acc_cyc;
  d.acc_phase_comp[c] = act ? comp : acc_comp;
  d.dll_vel[c] = act ? dll_vel : s.dll_vel[c];
  d.dll_acc[c] = s.dll_acc[c];
  d.pll_vel[c] = act ? pll_vel : s.pll_vel[c];
  d.pll_acc[c] = act ? pll_acc : s.pll_acc[c];
  d.prompt_prev[c] = act ? last_prompt : s.prompt_prev[c];
  d.epoch[c] = act ? epoch + n_e : epoch;
  d.cn0_db_hz[c] = act ? cn0_db : s.cn0_db_hz[c];
  d.carrier_lock[c] = act ? carrier_lock : s.carrier_lock[c];
  d.lock_fail[c] = act ? fail : lock_fail;
  d.lock_lost[c] = act ? (lost ? 1 : 0) : s.lock_lost[c];
  d.prev_sign[c] = act ? last_sign : s.prev_sign[c];
  d.bit_synced[c] = act ? ((was_synced || newly_bit) ? 1 : 0) : s.bit_synced[c];
  d.bit_phase[c] = newly_bit ? top : s.bit_phase[c];
  const int32_t ext_n = s.ext_n[c];
  d.ext_n[c] = act ? (ext_n + 1 < 10000 ? ext_n + 1 : 10000) : ext_n;
}

namespace {

__global__ void __launch_bounds__(32)
block_closure_kernel(const __grid_constant__ ClosureArgs a, int block) {
  block_close(a, blockIdx.x, block);
}

}  // namespace

extern "C" int block_prologue(PrologueArgs a, int n_ch, void* stream) {
  if (n_ch < 1 || a.n_epochs < 1 || a.n_epochs > kPrologueThreads ||
      a.n_taps < 1 || a.n_taps > kPrologueThreads || a.nfft < 1 || a.s0 < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.nfft + kPrologueThreads - 1) / kPrologueThreads, n_ch);
  block_prologue_kernel<<<grid, kPrologueThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

bool closure_args_invalid(const ClosureArgs& a, int block) {
  return a.n_ch < 1 || a.n_epochs < 1 || a.n_epochs > kMaxEpochs ||
         a.n_taps < 3 || a.n_taps > kMaxTaps || a.n_taps % 2 == 0 ||
         block < 0 || (block + 1) * a.n_epochs > a.n_rows;
}

extern "C" int block_closure(ClosureArgs a, int block, void* stream) {
  if (closure_args_invalid(a, block)) return (int)cudaErrorInvalidValue;
  block_closure_kernel<<<a.n_ch, 32, 0, (cudaStream_t)stream>>>(a, block);
  return (int)cudaGetLastError();
}
