// K8a's and K8b's launch arguments, shared by their standalone kernels
// (csrc/block_step.cu) and K1's fused form (csrc/block_correlator.cu,
// kClose), which runs the closure in its epilogue and, with a fold, the
// next block's prologue after it.  The structs are laid out as the
// wrapper's ctypes Structures (models/tracking_block.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the launch arguments (by value, laid out as the wrapper's ctypes
// Structures)

// the TrackState fields the block step reads or writes (dll and pll split
// into their two integrators); bool fields are one byte
struct StatePtrs {
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
  float* cn0_db_hz;
  float* carrier_lock;
  float* lock_fail;
  uint8_t* lock_lost;
  float* bit_hist;                      // [C, 20]
  float* prev_sign;
  uint8_t* bit_synced;
  int32_t* bit_phase;
  int32_t* ext_n;
  // the secondary-code sync's fields: read and written by the pilot form
  // only (the other form's source and destination share them)
  float* sec_buf;                       // [C, 32] recent prompt signs
  uint8_t* sec_synced;
  int32_t* sec_off;
  float* sec_polarity;
};

// K8a's outputs; K8b reads the epoch boundaries back
struct ProloguePtrs {
  float2* rep_t;                        // [C, F]; [2, C, F] in the pilot
                                        // form (pilot, data)
  float* n_cum;                         // [C, E]
  float* n_next;                        // [C, E]
  float* n_len;                         // [C, E]
  float* rem_end;                       // [C, E]
  float* n_total;                       // [C]
  float* rem_new;                       // [C]
  int32_t* w0;                          // [C]
  int32_t* lag_int;                     // [C, E]
  float* lag_frac;                      // [C, E]
  float* ph_sc;                         // [C, E]
  float* tap_samps;                     // [C, K]
  float* omega;                         // [C]
};

struct PrologueArgs {
  StatePtrs st;
  ProloguePtrs out;
  const float* codes_rep;               // [families, C, F]
  const float* taps;                    // [K] chips
  float fs;
  float l_chips;
  float inv_fs;                         // float(1 / float(fs))
  float two_pi;                         // float32(2 pi)
  float inv_fc;                         // float(1 / float(carrier_freq_hz))
  float dop_bias;                       // FDMA bias, Hz, off the stretch
                                        // (0 but on GLONASS: dop - 0 exact)
  float lead;                           // window lead, samples
  int32_t s0;                           // nominal epoch samples
  int32_t n_epochs;
  int32_t nfft;
  int32_t n_taps;
  int32_t w_max;                        // max(n_wins - E, 0)
  int32_t families;                     // 1, or 2 in the pilot form
  int32_t n_ch;                         // C: the families' stride is C F
};

// the chunk's [T, C] output planes
struct PlanePtrs {
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
};

struct ClosureArgs {
  StatePtrs src;
  StatePtrs dst;
  ProloguePtrs pro;
  PlanePtrs planes;
  const float2* corr;                   // [C, E, K]; [C, E, K + 1] in the
                                        // pilot form (the data prompt last)
  float fs;
  float inv_fs;
  float two_pi;
  float inv_two_pi;                     // float(1 / two_pi)
  float inv_e;                          // float(1 / float(E)): means, t_sym
  float el_gain;                        // 0.5 * (2 - early_late_space)
  float dll_bw_wide;
  float dll_bw_narrow;
  float inv_053;                        // float(1 / 0.53), 0.53 a double
  float pll_k3;                         // wn * wn * wn (PLL, narrow)
  float pll_k11;                        // 1.1 * wn * wn
  float pll_k24;                        // 2.4 * wn
  float fll_k4;                         // 4.0 * fll_bw_hz
  float lock_threshold;
  float cn0_min;
  float max_lock_fail;
  float code_rate;
  float inv_fc;
  float dop_bias;                       // FDMA bias, Hz, off the code rate
  float bit_sync_min;
  int32_t s0;
  int32_t n_epochs;
  int32_t n_taps;
  int32_t n_ch;
  int32_t n_rows;                       // T, the planes' rows
  int32_t fll_pullin_epochs;
  int32_t enable_fll;
  int32_t fll_decision;
  const float* sec_code;                // [n_sec] +-1, the pilot form
  int32_t n_sec;
};
