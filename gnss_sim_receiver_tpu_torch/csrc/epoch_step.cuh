// K9's launch arguments and its closure as a device function, shared by the
// standalone K9 kernel (csrc/epoch_step.cu) and the per-epoch chunk kernel
// (csrc/epoch_chunk.cu).  Both live in one library built with relocatable
// device code (ops/cuda_build.py), so that the closure keeps epoch_step.cu's
// --fmad=false rounding wherever it runs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the launch arguments (by value, laid out as the wrapper's ctypes
// Structures)

// the TrackState fields the closure reads or writes (dll, pll and the
// seven C/N0 accumulators split); bool fields are one byte.  The last five
// are the Kalman trackers': only their forms read or write them
struct EpochStatePtrs {
  uint8_t* active;
  int32_t* pos;
  float* rem_code_phase;
  float* code_freq;
  float* carrier_doppler;
  float* rem_carr_phase;
  float* acc_phase_cycles;
  float* acc_phase_comp;
  float* dll_vel;
  float* dll_acc;
  float* pll_vel;
  float* pll_acc;
  float2* prompt_prev;
  int32_t* epoch;
  float* acc_abs_i;
  float* acc_abs_q;
  float* acc_m2;
  float* acc_m4;
  float* acc_i;
  float* acc_q;
  float* acc_count;
  float* cn0_db_hz;
  float* carrier_lock;
  float* lock_fail;
  uint8_t* lock_lost;
  float* bit_hist;                      // [C, 20]
  float* prev_sign;
  uint8_t* bit_synced;
  int32_t* bit_phase;
  float2* ext_p;
  float2* ext_e;
  float2* ext_l;
  int32_t* ext_n;
  float* sec_buf;                       // [C, 32]
  uint8_t* sec_synced;
  int32_t* sec_off;
  float* sec_polarity;
  float* kf_p;                          // [C, 4, 4]
  float* kf_fdot;
  float* bayes_nu;
  float* bayes_psi_code;
  float* bayes_psi_carr;
};

// the chunk's [T, C] output planes
struct EpochPlanePtrs {
  float2* prompt;
  float* early_mag;
  float* late_mag;
  float* carrier_doppler_hz;
  float* code_freq_cps;
  float* rem_code_phase_chips;
  float* acc_phase_cycles;
  float* code_phase_samples;
  int32_t* pos_start;
  int32_t* n_samples;
  float* cn0_db_hz;
  uint8_t* valid;
  float2* pilot_prompt;
};

struct EpochArgs {
  EpochStatePtrs src;
  EpochStatePtrs dst;
  EpochPlanePtrs planes;
  const float2* corr;                   // [C, K] or [C, K + 1] (data prompt)
  int32_t* n_c;                         // [C] this epoch's lengths; next's
  const float* sec;                     // [n_sec] +-1
  float fs;
  float inv_fs;                         // float(1 / float(fs))
  float code_len;                       // code period, chips
  float two_pi;                         // float32(2 pi)
  float inv_two_pi;                     // float(1 / two_pi)
  float el_gain;                        // 0.5 * (2 - early_late_space)
  float veml_gain;                      // 0.5 * early_late_space
  float pll_k3;                         // wn^3, 1.1 wn^2, 2.4 wn (wide PLL)
  float pll_k11;
  float pll_k24;
  float npll_k3;                        // the same, narrow PLL
  float npll_k11;
  float npll_k24;
  float dll_k2;                         // wn^2, 1.414213562 wn (wide DLL)
  float dll_k14;
  float ndll_k2;                        // the same, narrow DLL
  float ndll_k14;
  float fll_k4;                         // 4.0 * fll_bw_hz
  float k_ext_f;                        // float(extend_correlation_symbols)
  float lock_threshold;
  float cn0_min;
  float max_lock_fail;
  float code_rate;
  float inv_fc;                         // float(1 / float(carrier_freq_hz))
  float dop_bias;                       // FDMA bias, Hz, off the code rate
                                        // (0 but on GLONASS: dop - 0 exact)
  float bit_sync_min;
  float sec_thresh;                     // float32(n_sec) - 0.5
  float pll2_k2;                        // wn^2, 1.414213562 wn (wide PLL,
  float pll2_k14;                       // second order)
  float npll2_k2;                       // the same, narrow PLL
  float npll2_k14;
  float kf_beta;                        // code rate / carrier frequency
  float kf_q_code;                      // the KF's Q diagonal and R
  float kf_q_phase;
  float kf_q_dop;
  float kf_q_doprate;
  float kf_r_code;
  float kf_r_phase;
  float bayes_lam;                      // the gaussian mode's forgetting
  int32_t n_taps;                       // 3, or 5 (VEML)
  int32_t veml;
  int32_t has_data;                     // corr has the data prompt column
  int32_t n_ch;
  int32_t n_rows;                       // T, the planes' rows
  int32_t n_sec;                        // 0: no secondary code
  int32_t k_ext;                        // extend_correlation_symbols
  int32_t fll_on;                       // FLL pull-in on the wide closure
                                        // (on the KF's, in its modes)
  int32_t fll_decision;
  int32_t fll_pullin_epochs;
  int32_t cn0_window;
  int32_t block_size;
  int32_t nominal;                      // nominal epoch samples
  int32_t mode;                         // 0 dll_pll, 1 kf, 2 gaussian
  int32_t pll_order;                    // 3, or 2 (dll_pll)
  int32_t lock_rectify;                 // 1: the carrier-lock test on the
                                        // |I| and |Q| sums (any form)
};

// the closure's forms, each a compile-time instantiation: the DLL/PLL
// loops with the third- or second-order PLL, the Kalman tracker with a
// fixed or an estimated measurement noise
enum EpochForm { kFormLoop3 = 0, kFormLoop2 = 1, kFormKf = 2, kFormGauss = 3 };
constexpr int kEpochForms = 4;

// the form of the closure that a's mode and order select
inline int epoch_form(const EpochArgs& a) {
  if (a.mode == 1) return kFormKf;
  if (a.mode == 2) return kFormGauss;
  return a.pll_order == 3 ? kFormLoop3 : kFormLoop2;
}

// One epoch's loop closure of channel c, run by one whole warp: reads the
// channel's state at index sc of `s` and commits the next state at index
// sc of `d` (`s` and `d` may be the same arrays), from its correlations
// `cr` [K] or [K + 1] over *n_c samples; writes row `row` of the planes
// and, from lane 0, the next epoch's length into *n_c.  kForm must be
// epoch_form(a).
template <int kForm>
__device__ void epoch_close(const EpochArgs& a, const EpochStatePtrs& s,
                            const EpochStatePtrs& d, int sc, int c,
                            const float2* cr, int32_t* n_c, int row);

// true where the closure's arguments are past what it takes
bool epoch_args_invalid(const EpochArgs& a);
