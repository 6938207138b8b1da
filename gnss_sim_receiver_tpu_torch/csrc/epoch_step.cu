// K9: the loop closure of the per-epoch tracking scan, written for Hopper.
//
// Replaces the body of gnss_sim_receiver_tpu/models/tracking.py:_epoch_step
// (lines 376-703, run by jax.lax.scan in track_chunk at :712) after the
// correlation K2 (csrc/multicorrelator.cu).  The closure is the device
// function epoch_close; on the tracking paths the chunk kernel
// (csrc/epoch_chunk.cu) runs it, after K2's slab body, for every epoch of
// a chunk in one launch.  This file's kernel, epoch_closure, is the
// standalone K9, a thin wrapper over it: one epoch of C channels as two
// launches, K2 then K9, the form the chunk kernel is held against.
//
// The closure runs on one warp per channel.  The lanes hold what the JAX
// body keeps in [C, 32] and [C, 20] arrays: lane i the secondary-code sign
// buffer's slot i and the correlation of that buffer with the code shifted
// by i (n_sec <= 32), lane p the bit-sync histogram's bin p; the argmax of
// either is a warp max and a ballot (its first index, as jnp.argmax picks).
// Every lane computes the channel's scalar closure, lane 0 commits it:
//
// - secondary-code sync (tracking.py:417-456): the sign of prompt-I into
//   slot epoch % n_sec, the hard match over every cyclic shift, sec_off
//   and sec_polarity on the first full match, the wipeoff of P, E and L;
// - the wide closure (:464-506): Costas PLL, E - L or VEMLP DLL, the
//   third- or second-order PLL and second-order DLL with the FLL pull-in,
//   or in the kf and gaussian modes the joint code/carrier Kalman tracker
//   (_kf_update, :305-373; R from the NIW posterior in gaussian mode,
//   :476-500) in place of the loop filters;
// - extended integration (:508-593): the bit-sync histogram and its
//   dominance test (GPS) or secondary-aligned groups (pilot), the coherent
//   sums, the narrow closure on them, the per-channel wide / closed / hold
//   choice and the reset when a group closes;
// - the NCO carry, C/N0 and lock on the wiped prompt (:595-630), the
//   commit under the active mask, the epoch's row of the chunk's [T, C]
//   output planes, and the NEXT epoch's length, which K2 reads from n_c.
//
// The forms (the PLL's order, the Kalman modes) are compile-time
// instantiations of one template, so the DLL/PLL form's instructions are
// those it had before the others came.  The Kalman form holds the 4x4
// covariance in lanes 0-15, lane 4i+j P[i][j]: the prediction F P F^T + Q
// and the update (I - K H) P' are products of rows and columns gathered by
// shuffles, lane 0 forms the 2x2 innovation inverse and broadcasts it,
// each lane forms its row of the gain K.
//
// It reads the state from one set of arrays and writes the next state into
// another: the standalone kernel's caller ping-pongs two buffers, the
// chunk kernel commits in place to its copy in shared memory (every lane
// has read the state before lane 0 commits); n_c is read and then
// rewritten by the channel's own warp.  Launch-latency bound as a kernel
// of its own: it moves about 1 kB per channel.
//
// The arithmetic is the plain PyTorch version's, operation by operation
// (gnss_sim_receiver_tpu_torch/models/tracking.py:_epoch_closure_plain), as
// torch runs it on the card: this file is built with --fmad=false so no
// a*b+c is contracted (each torch op rounds on its own); a division by a
// CPU scalar is a multiplication by its float reciprocal (the wrapper
// passes the reciprocals); rintf is torch.round (half to even); float
// remainders are floor-mods; a complex times a real promotes the real to
// a complex (x + 0j).  The shift correlations and the histogram are sums
// of small integers, exact in any order.

#include <math.h>

#include "epoch_step.cuh"

namespace {

constexpr int kBits = 20;               // bit-sync histogram bins
constexpr int kSecMax = 32;             // N_SEC_MAX
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_mod_i(int a, int b) {   // b > 0
  const int r = a % b;
  return (r != 0 && r < 0) ? r + b : r;
}

// torch.remainder on floats (ATen's form)
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float sign_f(float x) {           // torch.sign
  return (float)((0.0f < x) - (x < 0.0f));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float cmag(float2 z) { return hypotf(z.x, z.y); }

// z * w for a real w, promoted to the complex w + 0j as ATen multiplies
__device__ __forceinline__ float2 cmul_real(float2 z, float w) {
  return make_float2(z.x * w - z.y * 0.0f, z.x * 0.0f + z.y * w);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// discriminators.pll_costas(z) / (2 pi)
__device__ __forceinline__ float costas_cyc(float2 z, float inv_two_pi) {
  return atan2f(z.y * sign_f(z.x), fabsf(z.x)) * inv_two_pi;
}

// the where(denom > 0, (a - b) / clamp(denom, 1e-20), 0) of the DLL forms
__device__ __forceinline__ float dll_raw(float a, float b) {
  const float denom = a + b;
  return denom > 0.0f ? (a - b) / clamp_min(denom, 1e-20f) : 0.0f;
}

// the loop filters of one _dll_pll_update: the PLL's integrators and the
// second-order DLL (its velocity and output)
struct Loop {
  float pll_vel, pll_acc, dll_vel, dll_out;
};

// the third-order PLL (k3 = wn^3, k11 = 1.1 wn^2)
__device__ __forceinline__ Loop loop_filters(float k3, float k11, float dk2,
                                             float dk14, float pll_vel0,
                                             float pll_acc0, float dll_vel0,
                                             float carr_err, float code_err,
                                             float t) {
  Loop r;
  r.pll_acc = pll_acc0 + k3 * t * carr_err;
  r.pll_vel = pll_vel0 + t * (r.pll_acc + k11 * carr_err);
  r.dll_vel = dll_vel0 + dk2 * t * code_err;
  r.dll_out = r.dll_vel + dk14 * code_err;
  return r;
}

// the second-order PLL (k2 = wn^2; its acceleration held)
__device__ __forceinline__ Loop loop_filters2(float k2, float dk2, float dk14,
                                              float pll_vel0, float pll_acc0,
                                              float dll_vel0, float carr_err,
                                              float code_err, float t) {
  Loop r;
  r.pll_acc = pll_acc0;
  r.pll_vel = pll_vel0 + k2 * t * carr_err;
  r.dll_vel = dll_vel0 + dk2 * t * code_err;
  r.dll_out = r.dll_vel + dk14 * code_err;
  return r;
}

// the loops of form kForm (kFormLoop3 or kFormLoop2), wide or narrow
template <int kForm>
__device__ __forceinline__ Loop loops(const EpochArgs& a, bool narrow,
                                      float pll_vel0, float pll_acc0,
                                      float dll_vel0, float carr_err,
                                      float code_err, float t) {
  const float dk2 = narrow ? a.ndll_k2 : a.dll_k2;
  const float dk14 = narrow ? a.ndll_k14 : a.dll_k14;
  if constexpr (kForm == kFormLoop3)
    return loop_filters(narrow ? a.npll_k3 : a.pll_k3,
                        narrow ? a.npll_k11 : a.pll_k11, dk2, dk14, pll_vel0,
                        pll_acc0, dll_vel0, carr_err, code_err, t);
  else
    return loop_filters2(narrow ? a.npll2_k2 : a.pll2_k2, dk2, dk14,
                         pll_vel0, pll_acc0, dll_vel0, carr_err, code_err, t);
}

// the PLL's output gain of form kForm: 2.4 wn or 1.414213562 wn
template <int kForm>
__device__ __forceinline__ float pll_gain(const EpochArgs& a, bool narrow) {
  if constexpr (kForm == kFormLoop3)
    return narrow ? a.npll_k24 : a.pll_k24;
  else
    return narrow ? a.npll2_k14 : a.pll2_k14;
}

// the FLL discriminator (discriminators.fll_cross_dot, or its
// decision-directed form) between the previous prompt and this one
__device__ __forceinline__ float fll_err(const EpochArgs& a, float2 prev,
                                         float2 p, float t_int) {
  const float cross = prev.x * p.y - p.x * prev.y;
  const float dot = prev.x * p.x + prev.y * p.y;
  if (a.fll_decision) {
    const float sgn = dot >= 0.0f ? 1.0f : -1.0f;
    return atan2f(cross * sgn, fabsf(dot)) / (a.two_pi * t_int);
  }
  return atan2f(cross, dot) / (a.two_pi * t_int);
}

// F[i][j] of the KF's state transition (models/tracking.py:_kf_transition)
__device__ __forceinline__ float kf_f(int i, int j, float dt, float f02,
                                      float f03, float f13) {
  if (i == j) return 1.0f;
  if (i == 0) return j == 2 ? f02 : (j == 3 ? f03 : 0.0f);
  if (i == 1) return j == 2 ? dt : (j == 3 ? f13 : 0.0f);
  return (i == 2 && j == 3) ? dt : 0.0f;
}

// the Kalman tracker's step on one warp (models/tracking.py:_kf_update):
// lane L < 16 holds P[L / 4][L % 4] in p (lanes 16-31 repeat lanes 0-15);
// returns the updated covariance entry of the lane and, in dx[0..3], the
// state step every lane
__device__ __forceinline__ float kf_step(const EpochArgs& a, int lane,
                                         float p, float dt, float r0,
                                         float r1, float code_err,
                                         float carr_err, float dx[4]) {
  const int i = (lane >> 2) & 3, k = lane & 3;
  const float f02 = a.kf_beta * dt;
  const float f03 = f02 * dt * 0.5f;
  const float f13 = dt * dt * 0.5f;
  // A = F P, then P' = A F^T + Q, each sum in index order
  float fp = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t = kf_f(i, j, dt, f02, f03, f13) *
                    __shfl_sync(kFull, p, 4 * j + k);
    fp = j == 0 ? t : fp + t;
  }
  float pp = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t = __shfl_sync(kFull, fp, 4 * i + j) *
                    kf_f(k, j, dt, f02, f03, f13);
    pp = j == 0 ? t : pp + t;
  }
  const float q = i != k ? 0.0f
                         : (i == 0 ? a.kf_q_code
                                   : (i == 1 ? a.kf_q_phase
                                             : (i == 2 ? a.kf_q_dop
                                                       : a.kf_q_doprate)));
  pp = pp + q;
  // S = P'[:2, :2] + R and its inverse, formed on lane 0
  const float p00 = __shfl_sync(kFull, pp, 0);
  const float p01 = __shfl_sync(kFull, pp, 1);
  const float p11 = __shfl_sync(kFull, pp, 5);
  float si00 = 0.0f, si01 = 0.0f, si11 = 0.0f;
  if (lane == 0) {
    const float s00 = p00 + r0;
    const float s11 = p11 + r1;
    const float det = clamp_min(s00 * s11 - p01 * p01, 1e-20f);
    si00 = s11 / det;
    si01 = -p01 / det;
    si11 = s00 / det;
  }
  si00 = __shfl_sync(kFull, si00, 0);
  si01 = __shfl_sync(kFull, si01, 0);
  si11 = __shfl_sync(kFull, si11, 0);
  // row i of the gain K, and of the state step
  const float ph0 = __shfl_sync(kFull, pp, 4 * i);
  const float ph1 = __shfl_sync(kFull, pp, 4 * i + 1);
  const float k0 = ph0 * si00 + ph1 * si01;
  const float k1 = ph0 * si01 + ph1 * si11;
  const float dxi = k0 * code_err + k1 * carr_err;
#pragma unroll
  for (int j = 0; j < 4; ++j) dx[j] = __shfl_sync(kFull, dxi, 4 * j);
  // P = (I - K H) P'
  float pn = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float e = i == j ? 1.0f : 0.0f;
    const float kh = j == 0 ? k0 : (j == 1 ? k1 : 0.0f);
    const float t = (e - kh) * __shfl_sync(kFull, pp, 4 * j + k);
    pn = j == 0 ? t : pn + t;
  }
  return pn;
}

// code_rate_from_doppler: the carrier-aided code rate, the FDMA bias off
// the Doppler first
__device__ __forceinline__ float aided_rate(const EpochArgs& a, float dop) {
  return a.code_rate * (1.0f + __fsub_rn(dop, a.dop_bias) * a.inv_fc);
}

}  // namespace

template <int kForm>
__device__ void epoch_close(const EpochArgs& a, const EpochStatePtrs& s,
                            const EpochStatePtrs& d, int sc, int c,
                            const float2* cr, int32_t* n_c_io, int row) {
  constexpr bool kKalman = kForm == kFormKf || kForm == kFormGauss;
  const int lane = threadIdx.x & 31;
  const bool act = s.active[sc] != 0;
  const int32_t epoch = s.epoch[sc];
  const int32_t n_c = *n_c_io;
  const float t_int = (float)n_c * a.inv_fs;
  const int pi = a.veml ? 2 : 1;
  const float2 prompt = cr[pi];
  const float2 early = cr[pi - 1];
  const float2 late = cr[pi + 1];
  const float early_mag = cmag(early);
  const float late_mag = cmag(late);

  // ---- secondary-code sync + wipeoff ------------------------------------
  const bool sec_synced0 = s.sec_synced[sc] != 0;
  float buf = s.sec_buf[sc * kSecMax + lane];
  bool sec_synced = sec_synced0;
  int32_t sec_off = s.sec_off[sc];
  float sec_polarity = s.sec_polarity[sc];
  float wipe = 1.0f;
  if (a.n_sec > 0) {
    const int n = a.n_sec;
    const float sign_now = prompt.x >= 0.0f ? 1.0f : -1.0f;
    if (lane == floor_mod_i(epoch, n)) buf = sign_now;
    // lane `off` < n: sum_i buf[i] * sec[(i + off) % n]
    float corr_sec = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float b = __shfl_sync(kFull, buf, i);
      if (lane < n) corr_sec += b * a.sec[(i + lane) % n];
    }
    const float mag = lane < n ? fabsf(corr_sec) : -INFINITY;
    const float top = warp_max(mag);
    const int best_off = __ffs(__ballot_sync(kFull, lane < n && mag == top)) - 1;
    const float best = __shfl_sync(kFull, corr_sec, best_off);
    const bool hit = !sec_synced0 && epoch >= n && fabsf(best) >= a.sec_thresh;
    sec_synced = sec_synced0 || hit;
    if (hit) {
      sec_off = best_off;
      sec_polarity = sign_f(best);
    }
    const float chip = a.sec[floor_mod_i(epoch + sec_off, n)] * sec_polarity;
    wipe = sec_synced ? chip : 1.0f;
  }
  const float2 prompt_w = cmul_real(prompt, wipe);
  const float2 early_w = cmul_real(early, wipe);
  const float2 late_w = cmul_real(late, wipe);

  // ---- the wide closure (run_dll_pll) -------------------------------------
  const float carr_err = costas_cyc(prompt_w, a.inv_two_pi);
  float code_err;
  if (a.veml) {
    const float ve = cmag(cr[0]);
    const float vl = cmag(cr[4]);
    const float p_early = sqrtf(ve * ve + early_mag * early_mag);
    const float p_late = sqrtf(vl * vl + late_mag * late_mag);
    code_err = a.veml_gain * dll_raw(p_early, p_late);
  } else {
    code_err = a.el_gain * dll_raw(early_mag, late_mag);
  }
  const float pll_vel0 = s.pll_vel[sc];
  const float pll_acc0 = s.pll_acc[sc];
  const float dll_vel0 = s.dll_vel[sc];
  const float dll_acc0 = s.dll_acc[sc];
  const float dop0 = s.carrier_doppler[sc];
  const float rate0 = s.code_freq[sc];
  float doppler, code_freq, pll_vel, pll_acc, dll_vel;
  // the Kalman forms' phase steps, covariance entry (lanes 0-15), Doppler
  // rate and posterior
  float dtau = 0.0f, dphi = 0.0f, kf_p = 0.0f, kf_fdot = 0.0f;
  float nu = 0.0f, psi_code = 0.0f, psi_carr = 0.0f;
  if constexpr (kKalman) {
    const float kf_p0 = s.kf_p[sc * 16 + (lane & 15)];
    const float fdot0 = s.kf_fdot[sc];
    float r0 = a.kf_r_code, r1 = a.kf_r_phase;
    nu = s.bayes_nu[sc];
    psi_code = s.bayes_psi_code[sc];
    psi_carr = s.bayes_psi_carr[sc];
    if constexpr (kForm == kFormGauss) {
      const float denom = clamp_min(nu - 2.0f, 1.0f);
      r0 = clamp_min(psi_code / denom, 1e-5f);
      r1 = clamp_min(psi_carr / denom, 1e-6f);
    }
    float dx[4];
    kf_p = kf_step(a, lane, kf_p0, t_int, r0, r1, code_err, carr_err, dx);
    dtau = dx[0];
    dphi = dx[1];
    doppler = dop0 + fdot0 * t_int + dx[2];
    kf_fdot = fdot0 + dx[3];
    if (a.fll_on && epoch > 0 && epoch < a.fll_pullin_epochs)
      doppler = doppler + a.fll_k4 * t_int *
                              fll_err(a, s.prompt_prev[sc], prompt_w, t_int);
    code_freq = aided_rate(a, doppler);
    if constexpr (kForm == kFormGauss) {
      nu = a.bayes_lam * nu + 1.0f;
      psi_code = a.bayes_lam * psi_code + code_err * code_err;
      psi_carr = a.bayes_lam * psi_carr + carr_err * carr_err;
    }
    pll_vel = doppler;
    pll_acc = pll_acc0;
    dll_vel = dll_vel0;
  } else {
    Loop w = loops<kForm>(a, false, pll_vel0, pll_acc0, dll_vel0, carr_err,
                          code_err, t_int);
    if (a.fll_on) {
      const float f_err = fll_err(a, s.prompt_prev[sc], prompt_w, t_int);
      if (epoch > 0 && epoch < a.fll_pullin_epochs)
        w.pll_vel = w.pll_vel + a.fll_k4 * t_int * f_err;
    }
    doppler = w.pll_vel + pll_gain<kForm>(a, false) * carr_err;
    code_freq = aided_rate(a, doppler) + w.dll_out;
    pll_vel = w.pll_vel;
    pll_acc = w.pll_acc;
    dll_vel = w.dll_vel;
  }

  // ---- extended coherent integration (not in the Kalman forms) -----------
  const bool bin = lane < kBits;
  float hist = bin ? s.bit_hist[sc * kBits + lane] : 0.0f;
  float prev_sign = s.prev_sign[sc];
  bool bit_synced = s.bit_synced[sc] != 0;
  int32_t bit_phase = s.bit_phase[sc];
  float2 ext_p = s.ext_p[sc], ext_e = s.ext_e[sc], ext_l = s.ext_l[sc];
  int32_t ext_n = s.ext_n[sc];
  if (!kKalman && a.k_ext > 1) {
    bool at_bit_start;
    if (a.n_sec > 0) {
      bit_synced = sec_synced;
      prev_sign = prompt_w.x >= 0.0f ? 1.0f : -1.0f;
      at_bit_start = floor_mod_i(epoch + sec_off, a.n_sec) == 0;
    } else {
      const float sign = prompt.x >= 0.0f ? 1.0f : -1.0f;
      const float prev0 = s.prev_sign[sc];
      const bool flip = prev0 != 0.0f && sign != prev0;
      const int idx20 = floor_mod_i(epoch, kBits);
      const bool synced0 = bit_synced;
      hist = hist + ((!synced0 && flip && lane == idx20) ? 1.0f : 0.0f);
      const float peak = warp_max(bin ? hist : -INFINITY);
      const int arg = __ffs(__ballot_sync(kFull, bin && hist == peak)) - 1;
      const float second =
          warp_max(bin ? (lane == arg ? 0.0f : hist) : -INFINITY);
      const bool newly = !synced0 && peak >= a.bit_sync_min &&
                         peak >= 4.0f * clamp_min(second, 1.0f);
      bit_synced = synced0 || newly;
      if (newly) bit_phase = arg;
      prev_sign = sign;
      at_bit_start = idx20 == bit_phase;
    }
    const bool ext_on = bit_synced && epoch >= a.fll_pullin_epochs;
    const bool restart = at_bit_start || s.ext_n[sc] <= 0;
    const float2 zero = make_float2(0.0f, 0.0f);
    ext_p = ext_on ? (restart ? prompt_w : cadd(ext_p, prompt_w)) : zero;
    ext_e = ext_on ? (restart ? early_w : cadd(ext_e, early_w)) : zero;
    ext_l = ext_on ? (restart ? late_w : cadd(ext_l, late_w)) : zero;
    ext_n = ext_on ? (restart ? 1 : ext_n + 1) : 0;
    const bool close_now = ext_on && ext_n == a.k_ext;
    // the narrow closure on the coherent sums (no FLL)
    const float carr_x = costas_cyc(ext_p, a.inv_two_pi);
    const float code_x = a.el_gain * dll_raw(cmag(ext_e), cmag(ext_l));
    const Loop x = loops<kKalman ? kFormLoop3 : kForm>(
        a, true, pll_vel0, pll_acc0, dll_vel0, carr_x, code_x,
        t_int * a.k_ext_f);
    const float dop_x =
        x.pll_vel + pll_gain<kKalman ? kFormLoop3 : kForm>(a, true) * carr_x;
    if (ext_on) {                      // closed, else hold
      doppler = close_now ? dop_x : dop0;
      code_freq = close_now ? aided_rate(a, dop_x) + x.dll_out : rate0;
      pll_vel = close_now ? x.pll_vel : pll_vel0;
      pll_acc = close_now ? x.pll_acc : pll_acc0;
      dll_vel = close_now ? x.dll_vel : dll_vel0;
    }
    if (close_now) {
      ext_p = ext_e = ext_l = zero;
      ext_n = 0;
    }
  }

  // ---- NCO phase carry with the frequencies used this epoch ---------------
  // (the Kalman forms feed their phase steps into the remnants)
  const float rem_code0 = s.rem_code_phase[sc];
  float rem_code = rem_code0 + rate0 * t_int - a.code_len;
  float carr_adv = dop0 * t_int;
  if constexpr (kKalman) {
    rem_code = rem_code + dtau;
    carr_adv = carr_adv + dphi;
  }
  const float rem_carr =
      floor_mod(s.rem_carr_phase[sc] + a.two_pi * carr_adv, a.two_pi);
  const float acc_cyc = s.acc_phase_cycles[sc];
  const float acc_comp = s.acc_phase_comp[sc];
  const float y = carr_adv - acc_comp;
  const float t_sum = acc_cyc + y;
  const float comp = (t_sum - acc_cyc) - y;
  const int32_t pos = s.pos[sc];

  // ---- C/N0 + lock on the wiped prompt ------------------------------------
  const float ip = prompt_w.x, qp = prompt_w.y;
  const float p2 = ip * ip + qp * qp;
  const float sum_abs_i = s.acc_abs_i[sc] + fabsf(ip);
  const float sum_abs_q = s.acc_abs_q[sc] + fabsf(qp);
  const float sum_m2 = s.acc_m2[sc] + p2;
  const float sum_m4 = s.acc_m4[sc] + p2 * p2;
  const float sum_i = s.acc_i[sc] + ip;
  const float sum_q = s.acc_q[sc] + qp;
  const float count = s.acc_count[sc] + 1.0f;
  const bool window_done = floor_mod_i(epoch + 1, a.cn0_window) == 0;
  const float nn = clamp_min(count, 1.0f);
  const float m2 = sum_m2 / nn;
  const float m4 = sum_m4 / nn;
  const float p_d = sqrtf(clamp_min(2.0f * m2 * m2 - m4, 0.0f));
  const float p_n = clamp_min(m2 - p_d, 1e-20f);
  const float cn0_new = 10.0f * log10f(clamp_min(p_d / p_n / t_int, 1e-10f));
  // the coherent test on the signed sums, or the rectified one on the
  // |I| and |Q| sums (data zero-mean over every window: BeiDou D2)
  const float li = a.lock_rectify ? sum_abs_i : sum_i;
  const float lq = a.lock_rectify ? sum_abs_q : sum_q;
  const float i2 = li * li;
  const float q2 = lq * lq;
  const float lock_val = (i2 - q2) / clamp_min(i2 + q2, 1e-20f);
  const float lock0 = s.carrier_lock[sc];
  const float lock_new = 0.75f * lock0 + 0.25f * lock_val;
  const float cn0_0 = s.cn0_db_hz[sc];
  const float cn0_db = window_done ? cn0_new : cn0_0;
  const float carrier_lock = window_done ? lock_new : lock0;
  const bool locked = (carrier_lock > a.lock_threshold && cn0_db > a.cn0_min) ||
                      epoch < a.fll_pullin_epochs;
  const float fail0 = s.lock_fail[sc];
  const float fail_c = locked ? clamp_min(fail0 - 1.0f, 0.0f) : fail0 + 1.0f;
  const bool lost0 = s.lock_lost[sc] != 0;
  const float fail = window_done ? fail_c : fail0;
  const bool lost = window_done ? ((fail_c > a.max_lock_fail) || lost0) : lost0;

  // ---- the epoch's row of the output planes -------------------------------
  if (lane == 0) {
    const size_t o = (size_t)row * a.n_ch + c;
    a.planes.prompt[o] = a.has_data ? cr[a.n_taps] : prompt;
    a.planes.pilot_prompt[o] = prompt;
    a.planes.early_mag[o] = early_mag;
    a.planes.late_mag[o] = late_mag;
    a.planes.carrier_doppler_hz[o] = dop0;
    a.planes.code_freq_cps[o] = rate0;
    a.planes.rem_code_phase_chips[o] = rem_code0;
    a.planes.acc_phase_cycles[o] = t_sum - comp;
    a.planes.code_phase_samples[o] = rem_code * a.fs / rate0;
    a.planes.pos_start[o] = pos;
    a.planes.n_samples[o] = n_c;
    a.planes.cn0_db_hz[o] = cn0_db;
    a.planes.valid[o] = act ? 1 : 0;
  }

  // ---- masked commit (inactive channels advance nominally) ----------------
  // every lane has read the state before lane 0 rewrites it in place
  __syncwarp();
  if (bin) d.bit_hist[sc * kBits + lane] = act ? hist : s.bit_hist[sc * kBits + lane];
  d.sec_buf[sc * kSecMax + lane] = act ? buf : s.sec_buf[sc * kSecMax + lane];
  if constexpr (kKalman) {
    if (lane < 16)
      d.kf_p[sc * 16 + lane] = act ? kf_p : s.kf_p[sc * 16 + lane];
  }
  if (lane != 0) return;
  if constexpr (kKalman) {
    d.kf_fdot[sc] = act ? kf_fdot : s.kf_fdot[sc];
    d.bayes_nu[sc] = act ? nu : s.bayes_nu[sc];
    d.bayes_psi_code[sc] = act ? psi_code : s.bayes_psi_code[sc];
    d.bayes_psi_carr[sc] = act ? psi_carr : s.bayes_psi_carr[sc];
  }
  const float rem_code_new = act ? rem_code : rem_code0;
  const float code_freq_new = act ? code_freq : rate0;
  d.active[sc] = (act && !lost) ? 1 : 0;
  d.pos[sc] = act ? pos + n_c : pos + a.nominal;
  d.rem_code_phase[sc] = rem_code_new;
  d.code_freq[sc] = code_freq_new;
  d.carrier_doppler[sc] = act ? doppler : dop0;
  d.rem_carr_phase[sc] = act ? rem_carr : s.rem_carr_phase[sc];
  d.acc_phase_cycles[sc] = act ? t_sum : acc_cyc;
  d.acc_phase_comp[sc] = act ? comp : acc_comp;
  d.dll_vel[sc] = act ? dll_vel : dll_vel0;
  d.dll_acc[sc] = dll_acc0;
  d.pll_vel[sc] = act ? pll_vel : pll_vel0;
  d.pll_acc[sc] = act ? pll_acc : pll_acc0;
  d.prompt_prev[sc] = act ? prompt_w : s.prompt_prev[sc];
  d.epoch[sc] = act ? epoch + 1 : epoch;
  d.acc_abs_i[sc] = act ? (window_done ? 0.0f : sum_abs_i) : s.acc_abs_i[sc];
  d.acc_abs_q[sc] = act ? (window_done ? 0.0f : sum_abs_q) : s.acc_abs_q[sc];
  d.acc_m2[sc] = act ? (window_done ? 0.0f : sum_m2) : s.acc_m2[sc];
  d.acc_m4[sc] = act ? (window_done ? 0.0f : sum_m4) : s.acc_m4[sc];
  d.acc_i[sc] = act ? (window_done ? 0.0f : sum_i) : s.acc_i[sc];
  d.acc_q[sc] = act ? (window_done ? 0.0f : sum_q) : s.acc_q[sc];
  d.acc_count[sc] = act ? (window_done ? 0.0f : count) : s.acc_count[sc];
  d.cn0_db_hz[sc] = act ? cn0_db : cn0_0;
  d.carrier_lock[sc] = act ? carrier_lock : lock0;
  d.lock_fail[sc] = act ? fail : fail0;
  d.lock_lost[sc] = act ? (lost ? 1 : 0) : s.lock_lost[sc];
  d.prev_sign[sc] = act ? prev_sign : s.prev_sign[sc];
  d.bit_synced[sc] = act ? (bit_synced ? 1 : 0) : s.bit_synced[sc];
  d.bit_phase[sc] = act ? bit_phase : s.bit_phase[sc];
  d.ext_p[sc] = act ? ext_p : s.ext_p[sc];
  d.ext_e[sc] = act ? ext_e : s.ext_e[sc];
  d.ext_l[sc] = act ? ext_l : s.ext_l[sc];
  d.ext_n[sc] = act ? ext_n : s.ext_n[sc];
  d.sec_synced[sc] = act ? (sec_synced ? 1 : 0) : s.sec_synced[sc];
  d.sec_off[sc] = act ? sec_off : s.sec_off[sc];
  d.sec_polarity[sc] = act ? sec_polarity : s.sec_polarity[sc];
  // the next epoch's length from the committed code NCO (update_tracking_
  // vars), read by the next K2
  int n_next = (int)rintf((a.code_len - rem_code_new) / code_freq_new * a.fs);
  n_next = n_next < 1 ? 1 : (n_next > a.block_size ? a.block_size : n_next);
  *n_c_io = n_next;
}

// the forms the chunk kernel (csrc/epoch_chunk.cu) calls
template __device__ void epoch_close<kFormLoop3>(
    const EpochArgs&, const EpochStatePtrs&, const EpochStatePtrs&, int, int,
    const float2*, int32_t*, int);
template __device__ void epoch_close<kFormLoop2>(
    const EpochArgs&, const EpochStatePtrs&, const EpochStatePtrs&, int, int,
    const float2*, int32_t*, int);
template __device__ void epoch_close<kFormKf>(
    const EpochArgs&, const EpochStatePtrs&, const EpochStatePtrs&, int, int,
    const float2*, int32_t*, int);
template __device__ void epoch_close<kFormGauss>(
    const EpochArgs&, const EpochStatePtrs&, const EpochStatePtrs&, int, int,
    const float2*, int32_t*, int);

namespace {

template <int kForm>
__global__ void __launch_bounds__(32)
epoch_closure_kernel(const __grid_constant__ EpochArgs a, int row) {
  const int c = blockIdx.x;
  epoch_close<kForm>(a, a.src, a.dst, c, c,
                     a.corr + (size_t)c * (a.n_taps + a.has_data), a.n_c + c,
                     row);
}

}  // namespace

bool epoch_args_invalid(const EpochArgs& a) {
  return a.n_ch < 1 || (a.n_taps != 3 && a.n_taps != 5) ||
         a.veml != (a.n_taps == 5) || a.has_data < 0 || a.has_data > 1 ||
         a.n_sec < 0 || a.n_sec > kSecMax || a.cn0_window < 1 ||
         a.block_size < 1 || a.mode < 0 || a.mode > 2 ||
         (a.pll_order != 2 && a.pll_order != 3) ||
         (a.mode != 0 && a.k_ext != 1) || a.lock_rectify < 0 ||
         a.lock_rectify > 1;
}

extern "C" int epoch_closure(EpochArgs a, int row, void* stream) {
  if (epoch_args_invalid(a) || row < 0 || row >= a.n_rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (epoch_form(a)) {
    case kFormLoop3:
      epoch_closure_kernel<kFormLoop3><<<a.n_ch, 32, 0, st>>>(a, row);
      break;
    case kFormLoop2:
      epoch_closure_kernel<kFormLoop2><<<a.n_ch, 32, 0, st>>>(a, row);
      break;
    case kFormKf:
      epoch_closure_kernel<kFormKf><<<a.n_ch, 32, 0, st>>>(a, row);
      break;
    default:
      epoch_closure_kernel<kFormGauss><<<a.n_ch, 32, 0, st>>>(a, row);
  }
  return (int)cudaGetLastError();
}
