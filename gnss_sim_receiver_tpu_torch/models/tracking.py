"""Batched DLL/PLL and Kalman tracking engine, PyTorch port of
``gnss_sim_receiver_tpu.models.tracking``: GPS L1 C/A with 3 taps, Galileo
E1-B data with 5 VEML taps, the E1-C pilot with a data-prompt correlator on
E1-B, secondary-code sync and extended coherent integration; the third- or
second-order PLL, or the joint code/carrier Kalman tracker (``kf``, and
``gaussian`` with its measurement noise estimated on line).

All channels advance one code epoch per step over a shared sample chunk;
the per-channel sample pointer and the fractional code/carrier remnants are
the carried :class:`TrackState`.  One epoch is the correlation, kernel K2
(:func:`ops.correlator.multicorrelate`, with the data prompt of a pilot
chain in the same pass), then the loop closure, kernel K9
(:func:`epoch_closure`, ``csrc/epoch_step.cu``): secondary-code sync and
wipeoff, bit sync and extended integration, DLL/PLL/FLL or the Kalman
tracker, C/N0 and lock,
the masked commit and the epoch's row of the chunk's [T, C] output planes.
Its plain version, :func:`_epoch_closure_plain`, is the JAX body's
operations in its order; the CPU runs it.

On the card a whole chunk is one launch of the chunk kernel
(:func:`epoch_chunk`, ``csrc/epoch_chunk.cu``), the counterpart of the JAX
program's ``lax.scan``: one thread-block cluster per channel runs K2's
slab body and K9's closure for every epoch, the state held on the card
between them (:func:`plan_epoch_chunk` sizes the clusters).  The
standalone K2 and K9 stay as the two-launch loop it is held against
(:func:`_chunk_two_launch`), on no tracking path.

The host-side :class:`TrackingEngine` keeps absolute sample bookkeeping
(int64) and the acquisition -> tracking handoff, and pulls every chunk in
one of the JAX engine's two packed transfer layouts (every epoch's planes,
:func:`pack_full`, or the rate-split one, :func:`pack_decim`), so the host
unpacking is identical.

Arithmetic follows the JAX code operation by operation in float32 (scalar
constants are float32 where the JAX code makes them float32), so the two
agree to rounding; the Kalman covariance's 4x4 products sum in an order
stated here (:func:`_kf_predict`), where JAX's einsum picks its own.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import (check_kernel_device,
                                                require, resolve_device,
                                                sm_count, upload)
from gnss_sim_receiver_tpu_torch.ops import cn0 as cn0_ops
from gnss_sim_receiver_tpu_torch.ops import correlator, cuda_build
from gnss_sim_receiver_tpu_torch.ops import discriminators
from gnss_sim_receiver_tpu_torch.ops import loop_filters as lf
from gnss_sim_receiver_tpu_torch.ops import prn_codes

N_SEC_MAX = 32   # longest supported secondary code (NH20, CS25 fit)

F32 = torch.float32
I32 = torch.int32
TRACKING_MODES = ("dll_pll", "kf", "gaussian")


def f32(v) -> torch.Tensor:
    """A 0-d float32 CPU tensor: the port's form of the JAX code's
    ``jnp.float32(v)`` scalars, so arithmetic with it rounds in float32."""
    return torch.tensor(v, dtype=F32)


@dataclasses.dataclass(frozen=True)
class TrackingConf:
    """Reference Dll_Pll_Conf subset (tracking/libs/dll_pll_conf.h:42-80)
    with the Kalman trackers' fields.  Rates and lengths are in sub-chips
    for BOC signals (E1: 2.046e6 and 8184)."""
    fs: float = 2_000_000.0
    code_rate_cps: float = constants.GPS_L1_CA_CODE_RATE_CPS
    code_length_chips: int = constants.GPS_L1_CA_CODE_LENGTH_CHIPS
    carrier_freq_hz: float = constants.GPS_L1_FREQ_HZ
    pll_bw_hz: float = 35.0
    # 3: third-order PLL; any other value the second-order one (the
    # per-epoch closures; the block kernel's closure is third-order always)
    pll_filter_order: int = 3
    dll_bw_hz: float = 2.0          # second-order DLL
    enable_fll_pullin: bool = True
    fll_bw_hz: float = 15.0
    fll_pullin_epochs: int = 250
    # the two-quadrant decision-directed FLL discriminator
    # (discriminators.fll_cross_dot_decision) in place of the four-quadrant
    # one: insensitive to a symbol flip between the two prompts (E1-B
    # carries one symbol per epoch)
    fll_decision_directed: bool = False
    early_late_space_chips: float = 0.5
    # > 0 adds very-early/very-late taps (5-tap VEML, the BOC sideband
    # disambiguator of dll_pll_VEML_tracking) closed by the
    # dll_nc_vemlp_normalized discriminator on the per-epoch path
    very_early_late_space_chips: float = 0.0
    cn0_window_epochs: int = 20
    # rectified (|I|,|Q|) carrier-lock test for signals whose data is
    # zero-mean over every window (BeiDou D2) — the coherent NBD/NBP test
    # reads -1 there even in perfect lock
    lock_rectify: bool = False
    cn0_min_db_hz: float = 25.0
    carrier_lock_threshold: float = 0.75
    max_lock_fail: int = 50
    # extended coherent integration (reference tracking states 2->3->4,
    # dll_pll_veml_tracking.cc:1789-2027): after bit sync (or, on a pilot,
    # secondary-code sync) the prompts are summed coherently over
    # extend_correlation_symbols epochs and the loops close at that cadence
    # with the narrow bandwidths (the block kernel closes at block cadence
    # with them too)
    extend_correlation_symbols: int = 1
    pll_bw_narrow_hz: float = 15.0
    dll_bw_narrow_hz: float = 0.5
    bit_sync_min_transitions: int = 16
    # secondary code (pilot channels: E1-C CS25, L5Q NH20): hard sign-match
    # sync of the prompt signs against the sequence, then per-epoch wipeoff
    # (reference acquire_secondary(), dll_pll_veml_tracking.cc:925-969)
    secondary_code: tuple = ()
    # non-physical baseband carrier offset excluded from code-Doppler
    # aiding (a GLONASS FDMA slot k rides at +k*DFRQ in the tracked
    # Doppler but does not Doppler the code; the reference biases
    # acquisition by d_doppler_bias for the same reason,
    # pcps_acquisition.cc:211-230)
    doppler_bias_hz: float = 0.0
    # track_pilot: the loops close on the pilot code (this conf's code and
    # secondary describe the pilot) while a data-prompt correlator taps the
    # data code for telemetry (dll_pll_veml_tracking.cc:1050-1061); the
    # engine is then built with data_code_provider
    track_pilot: bool = False
    # tracking_mode "kf": the joint code/carrier Kalman tracker in place of
    # the DLL/PLL loop filters (reference kf_tracking, state [code phase,
    # carrier phase, Doppler, Doppler rate], kf_tracking.h:128-129), with
    # the process noise Q and measurement noise R below; "gaussian": the
    # same filter with R estimated from the innovations by a
    # normal-inverse-Wishart posterior with exponential forgetting
    # (reference gps_l1_ca_gaussian_tracking_cc, bayesian_estimation.cc
    # update_sequential).  Both close every epoch: no extended integration
    tracking_mode: str = "dll_pll"      # "dll_pll" | "kf" | "gaussian"
    bayes_forgetting: float = 0.995
    kf_q_code_chips2: float = 1e-4
    kf_q_phase_cyc2: float = 1e-6
    kf_q_dop_hz2: float = 1.0
    kf_q_doprate_hz2s2: float = 10.0
    kf_r_code_chips2: float = 2e-3
    kf_r_phase_cyc2: float = 5e-4

    def __post_init__(self):
        if self.tracking_mode not in TRACKING_MODES:
            raise ValueError(f"tracking_mode {self.tracking_mode!r} is not "
                             f"one of {TRACKING_MODES}")

    @property
    def kalman(self) -> bool:
        """Whether the loops close through the Kalman tracker."""
        return self.tracking_mode != "dll_pll"

    @property
    def t_epoch_nominal_s(self) -> float:
        return self.code_length_chips / self.code_rate_cps

    @property
    def nominal_epoch_samples(self) -> int:
        return int(round(self.fs * self.t_epoch_nominal_s))

    @property
    def block_size(self) -> int:
        # fixed correlation block: one code period + slack, 128-aligned
        b = int(np.ceil(self.fs * self.t_epoch_nominal_s * 1.01)) + 16
        return ((b + 127) // 128) * 128


class TrackState(NamedTuple):
    """Per-channel carried state; every field is [C]-shaped (the fields of
    the JAX TrackState; the kf_* and bayes_* fields move only in the kf and
    gaussian modes)."""
    active: torch.Tensor            # bool
    pos: torch.Tensor               # int32 next epoch start (chunk-relative)
    rem_code_phase: torch.Tensor    # float32 chips into the code period
    code_freq: torch.Tensor         # float32 chips/s
    carrier_doppler: torch.Tensor   # float32 Hz
    rem_carr_phase: torch.Tensor    # float32 rad (NCO phase mod 2pi)
    acc_phase_cycles: torch.Tensor  # float32 Kahan sum of carrier cycles
    acc_phase_comp: torch.Tensor    # float32 Kahan compensation
    dll: lf.LoopFilterState
    pll: lf.LoopFilterState
    prompt_prev: torch.Tensor       # complex64 (FLL memory)
    epoch: torch.Tensor             # int32 epochs since start_tracking
    cn0_acc: cn0_ops.Cn0AccumState
    cn0_db_hz: torch.Tensor         # float32
    carrier_lock: torch.Tensor      # float32
    lock_fail: torch.Tensor         # float32
    lock_lost: torch.Tensor         # bool
    kf_p: torch.Tensor              # [C, 4, 4] KF covariance (kf mode)
    kf_fdot: torch.Tensor           # [C] Doppler rate estimate (kf mode)
    bit_hist: torch.Tensor          # [C, 20] sign-transition histogram
    prev_sign: torch.Tensor         # [C] last prompt-I sign
    bit_synced: torch.Tensor        # [C] bool
    bit_phase: torch.Tensor         # [C] int32 epoch%20 of bit starts
    ext_p: torch.Tensor             # [C] complex64 coherent P accumulator
    ext_e: torch.Tensor             # [C] complex64 coherent E accumulator
    ext_l: torch.Tensor             # [C] complex64 coherent L accumulator
    ext_n: torch.Tensor             # [C] int32 symbols accumulated (block
    #                                 kernel: blocks run)
    sec_buf: torch.Tensor           # [C, N_SEC_MAX] recent prompt-I signs
    sec_synced: torch.Tensor        # [C] bool
    sec_off: torch.Tensor           # [C] int32: sec chip = sec[(e+off)%N]
    sec_polarity: torch.Tensor      # [C] +-1 (180-deg phase lock flag)
    # the gaussian mode's normal-inverse-Wishart posterior per channel:
    # pseudo-count and scale sums
    bayes_nu: torch.Tensor          # [C] float32
    bayes_psi_code: torch.Tensor    # [C] float32 (chips^2)
    bayes_psi_carr: torch.Tensor    # [C] float32 (cycles^2)


_KF_P0 = (0.1, 0.1, 100.0, 10.0)


def _init_state(n_channels: int, device) -> TrackState:
    def z(dt=F32):
        return torch.zeros(n_channels, dtype=dt, device=device)

    def full(v):
        return torch.full((n_channels,), v, dtype=F32, device=device)

    return TrackState(
        active=z(torch.bool), pos=z(I32), rem_code_phase=z(),
        code_freq=full(constants.GPS_L1_CA_CODE_RATE_CPS),
        carrier_doppler=z(), rem_carr_phase=z(),
        acc_phase_cycles=z(), acc_phase_comp=z(),
        dll=lf.init_state(n_channels, device),
        pll=lf.init_state(n_channels, device),
        prompt_prev=z(torch.complex64), epoch=z(I32),
        cn0_acc=cn0_ops.init_accum(n_channels, device),
        cn0_db_hz=z(), carrier_lock=z(), lock_fail=z(),
        lock_lost=z(torch.bool),
        kf_p=torch.diag(torch.tensor(_KF_P0, dtype=F32, device=device)
                        )[None].repeat(n_channels, 1, 1),
        kf_fdot=z(),
        bit_hist=torch.zeros((n_channels, 20), dtype=F32, device=device),
        prev_sign=z(), bit_synced=z(torch.bool), bit_phase=z(I32),
        ext_p=z(torch.complex64), ext_e=z(torch.complex64),
        ext_l=z(torch.complex64), ext_n=z(I32),
        sec_buf=torch.zeros((n_channels, N_SEC_MAX), dtype=F32,
                            device=device),
        sec_synced=z(torch.bool), sec_off=z(I32), sec_polarity=full(1.0),
        bayes_nu=full(30.0), bayes_psi_code=full(30.0 * 2e-3),
        bayes_psi_carr=full(30.0 * 5e-4),
    )


def _set(t: torch.Tensor, ch: int, v) -> torch.Tensor:
    t = t.clone()
    t[ch] = v
    return t


def _arm_channel(s: TrackState, ch: int, doppler_hz: float,
                 code_freq0: float) -> TrackState:
    """Channel-arming state update (a new state; `s` is left as it was)."""
    dop = float(np.float32(doppler_hz))
    return s._replace(
        active=_set(s.active, ch, True), pos=_set(s.pos, ch, 0),
        rem_code_phase=_set(s.rem_code_phase, ch, 0.0),
        code_freq=_set(s.code_freq, ch, float(np.float32(code_freq0))),
        carrier_doppler=_set(s.carrier_doppler, ch, dop),
        rem_carr_phase=_set(s.rem_carr_phase, ch, 0.0),
        acc_phase_cycles=_set(s.acc_phase_cycles, ch, 0.0),
        acc_phase_comp=_set(s.acc_phase_comp, ch, 0.0),
        dll=lf.LoopFilterState(vel=_set(s.dll.vel, ch, 0.0),
                               acc=_set(s.dll.acc, ch, 0.0)),
        pll=lf.LoopFilterState(vel=_set(s.pll.vel, ch, dop),
                               acc=_set(s.pll.acc, ch, 0.0)),
        prompt_prev=_set(s.prompt_prev, ch, 0.0),
        epoch=_set(s.epoch, ch, 0),
        cn0_db_hz=_set(s.cn0_db_hz, ch, 0.0),
        carrier_lock=_set(s.carrier_lock, ch, 1.0),
        lock_fail=_set(s.lock_fail, ch, 0.0),
        lock_lost=_set(s.lock_lost, ch, False),
        kf_p=_set(s.kf_p, ch, torch.diag(torch.tensor(_KF_P0, dtype=F32))),
        kf_fdot=_set(s.kf_fdot, ch, 0.0),
        bit_hist=_set(s.bit_hist, ch, 0.0),
        prev_sign=_set(s.prev_sign, ch, 0.0),
        bit_synced=_set(s.bit_synced, ch, False),
        bit_phase=_set(s.bit_phase, ch, 0),
        ext_p=_set(s.ext_p, ch, 0.0), ext_e=_set(s.ext_e, ch, 0.0),
        ext_l=_set(s.ext_l, ch, 0.0), ext_n=_set(s.ext_n, ch, 0),
        sec_buf=_set(s.sec_buf, ch, 0.0),
        sec_synced=_set(s.sec_synced, ch, False),
        sec_off=_set(s.sec_off, ch, 0),
        sec_polarity=_set(s.sec_polarity, ch, 1.0),
        bayes_nu=_set(s.bayes_nu, ch, 30.0),
        bayes_psi_code=_set(s.bayes_psi_code, ch, 30.0 * 2e-3),
        bayes_psi_carr=_set(s.bayes_psi_carr, ch, 30.0 * 5e-4),
    )


def _fll_on(conf: TrackingConf) -> bool:
    return conf.enable_fll_pullin and (conf.fll_decision_directed
                                       or not conf.secondary_code)


def code_rate_from_doppler(conf: TrackingConf, doppler) -> torch.Tensor:
    """Carrier-aided code rate (float32): rate * (1 + (dop - bias)/fc),
    the FDMA bias subtracted first (exact at bias 0)."""
    return (f32(conf.code_rate_cps)
            * (1.0 + (doppler - f32(conf.doppler_bias_hz))
               / f32(conf.carrier_freq_hz)))


def _fll_pullin(conf: TrackingConf, state: TrackState, prompt, t_int,
                freq):
    """`freq` nudged by the FLL during the pull-in epochs (reference
    FLL-assisted-PLL pull-in, run_dll_pll :1080-1099)."""
    fll_fn = (discriminators.fll_cross_dot_decision
              if conf.fll_decision_directed
              else discriminators.fll_cross_dot)
    freq_err = fll_fn(state.prompt_prev, prompt, t_int)
    in_pullin = (state.epoch > 0) & (state.epoch < conf.fll_pullin_epochs)
    return torch.where(
        in_pullin, freq + 4.0 * f32(conf.fll_bw_hz) * t_int * freq_err, freq)


def _dll_pll_update(conf: TrackingConf, state: TrackState, prompt,
                    carr_err_cyc, code_err_chips, t_int,
                    pll_bw_hz=None, dll_bw_hz=None, apply_fll=True):
    """Classic loop closure (run_dll_pll :1065-1152): FLL-assisted PLL +
    carrier-aided DLL.  Bandwidth overrides serve the narrow (extended
    coherent integration) closure."""
    pll_bw = conf.pll_bw_hz if pll_bw_hz is None else pll_bw_hz
    dll_bw = conf.dll_bw_hz if dll_bw_hz is None else dll_bw_hz
    if conf.pll_filter_order == 3:
        wn = f32(pll_bw / 0.7845)
        pll_acc = state.pll.acc + wn * wn * wn * t_int * carr_err_cyc
        pll_vel = state.pll.vel + t_int * (pll_acc
                                           + 1.1 * wn * wn * carr_err_cyc)
        out_gain = 2.4 * wn
    else:                                        # second-order PLL
        wn = f32(pll_bw / 0.53)
        pll_acc = state.pll.acc
        pll_vel = state.pll.vel + wn * wn * t_int * carr_err_cyc
        out_gain = 1.414213562 * wn
    # a channel with a secondary code takes the FLL only in decision-directed
    # form (the every-epoch chip flips corrupt the four-quadrant pairs
    # before sync)
    if _fll_on(conf) and apply_fll:
        pll_vel = _fll_pullin(conf, state, prompt, t_int, pll_vel)
    pll_new = lf.LoopFilterState(vel=pll_vel, acc=pll_acc)
    carrier_doppler = pll_vel + out_gain * carr_err_cyc
    # DLL with carrier aiding (:1126-1129)
    dll_new, dll_out = lf.second_order_step(
        state.dll, code_err_chips, f32(dll_bw), t_int)
    code_freq = code_rate_from_doppler(conf, carrier_doppler) + dll_out
    return carrier_doppler, code_freq, pll_new, dll_new


def _kf_transition(conf: TrackingConf, dt: torch.Tensor) -> torch.Tensor:
    """The KF's state transition F [C, 4, 4] over epochs of `dt` seconds:
    code phase advances by beta (Doppler dt + rate dt^2 / 2), carrier phase
    by Doppler dt + rate dt^2 / 2, Doppler by rate dt."""
    beta = f32(conf.code_rate_cps / conf.carrier_freq_hz)
    one, zero = torch.ones_like(dt), torch.zeros_like(dt)
    f02 = beta * dt
    f03 = beta * dt * dt / 2.0
    f13 = dt * dt / 2.0
    return torch.stack([one, zero, f02, f03,
                        zero, one, dt, f13,
                        zero, zero, one, dt,
                        zero, zero, zero, one], -1).reshape(-1, 4, 4)


def _mat4(a: torch.Tensor, b: torch.Tensor, b_transposed: bool = False):
    """a @ b (or a @ b^T) over [C, 4, 4] as elementwise products summed in
    index order 0, 1, 2, 3: the order K9 sums them in (each product and
    each sum rounded on its own)."""
    out = None
    for j in range(4):
        bj = b[:, None, :, j] if b_transposed else b[:, None, j, :]
        term = a[:, :, j, None] * bj
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def _kf_q(conf: TrackingConf, dev: torch.device) -> torch.Tensor:
    """The KF's process noise Q [4, 4] (float32) on `dev`, one upload per
    conf and device."""
    return torch.diag(torch.tensor(
        [conf.kf_q_code_chips2, conf.kf_q_phase_cyc2, conf.kf_q_dop_hz2,
         conf.kf_q_doprate_hz2s2], dtype=F32)).to(dev)


def _kf_predict(conf: TrackingConf, kf_p: torch.Tensor,
                dt: torch.Tensor) -> torch.Tensor:
    """The predicted covariance F P F^T + Q: F P first, then (F P) F^T,
    then + Q (JAX forms F P F^T in one einsum, in an order of its own)."""
    f = _kf_transition(conf, dt)
    return (_mat4(_mat4(f, kf_p), f, b_transposed=True)
            + _kf_q(conf, dt.device))


def _kf_update(conf: TrackingConf, state: TrackState, prompt,
               carr_err_cyc, code_err_chips, t_int, r_code=None,
               r_carr=None):
    """Joint code/carrier error-state Kalman tracker (reference kf_tracking,
    state [code phase err (chips), carrier phase err (cycles), Doppler
    (Hz), Doppler rate (Hz/s)], kf_tracking.h:128-176), vectorized over
    channels, the covariance carried in the state.  The phase errors are
    fed back into the NCO remnants every epoch and re-zeroed, so the
    filter state reduces to (Doppler, Doppler rate) and the 4x4 covariance.
    Returns (Doppler, code rate, code phase step, carrier phase step,
    covariance, Doppler rate)."""
    dt = t_int
    p_pred = _kf_predict(conf, state.kf_p, dt)
    # H = [[1, 0, 0, 0], [0, 1, 0, 0]]: S = P[:2, :2] + R, inverted
    # explicitly with its determinant floored
    r0 = f32(conf.kf_r_code_chips2) if r_code is None else r_code
    r1 = f32(conf.kf_r_phase_cyc2) if r_carr is None else r_carr
    s00 = p_pred[:, 0, 0] + r0
    s01 = p_pred[:, 0, 1]
    s11 = p_pred[:, 1, 1] + r1
    det = torch.clamp(s00 * s11 - s01 * s01, min=1e-20)
    si00 = s11 / det
    si01 = -s01 / det
    si11 = s00 / det
    ph0, ph1 = p_pred[:, :, 0], p_pred[:, :, 1]               # [C, 4]
    k0 = ph0 * si00[:, None] + ph1 * si01[:, None]
    k1 = ph0 * si01[:, None] + ph1 * si11[:, None]
    # the innovations are the measurements (the predicted phase errors are
    # zero after the feedback)
    dx = k0 * code_err_chips[:, None] + k1 * carr_err_cyc[:, None]
    # P = (I - K H) P'
    zero = torch.zeros_like(k0)
    kh = torch.stack([k0, k1, zero, zero], -1)
    eye = torch.eye(4, dtype=F32, device=dt.device)
    p_new = _mat4(eye[None] - kh, p_pred)
    doppler = state.carrier_doppler + state.kf_fdot * dt + dx[:, 2]
    fdot = state.kf_fdot + dx[:, 3]
    # FLL assist during pull-in as the loops take it, whatever the
    # secondary code
    if conf.enable_fll_pullin:
        doppler = _fll_pullin(conf, state, prompt, t_int, doppler)
    code_freq = code_rate_from_doppler(conf, doppler)
    return doppler, code_freq, dx[:, 0], dx[:, 1], p_new, fdot


def _bayes_r(state: TrackState):
    """The gaussian mode's measurement noise (code, carrier) from the NIW
    posterior, floored against transients."""
    denom = torch.clamp(state.bayes_nu - 2.0, min=1.0)
    return (torch.clamp(state.bayes_psi_code / denom, min=1e-5),
            torch.clamp(state.bayes_psi_carr / denom, min=1e-6))


# ---- the per-epoch step: the plain versions --------------------------------

def secondary_pm1(conf: TrackingConf) -> np.ndarray:
    """The conf's secondary code as +-1 float32 (a {0, 1} code maps 0 to
    -1, as the JAX body reads it)."""
    code = conf.secondary_code
    if set(code) <= {0, 1}:
        return np.array(code, np.float32) * 2.0 - 1.0
    return np.array(code, np.float32)


def _check_epoch_conf(conf: TrackingConf) -> None:
    """The JAX body's asserts on the secondary code and the extension."""
    n_sec = len(conf.secondary_code)
    k_ext = 1 if conf.kalman else conf.extend_correlation_symbols
    if n_sec > N_SEC_MAX:
        raise ValueError(f"secondary code longer than N_SEC_MAX={N_SEC_MAX}")
    if k_ext > 1 and n_sec and n_sec % k_ext:
        raise ValueError("extend_correlation_symbols must divide the "
                         "secondary length")
    if k_ext > 1 and not n_sec and 20 % k_ext:
        raise ValueError("extend_correlation_symbols must divide 20")


def _epoch_length(conf: TrackingConf, state: TrackState) -> torch.Tensor:
    """Samples of each channel's next epoch from its code NCO
    (update_tracking_vars :1189), int32 in [1, block_size]."""
    n_c = torch.round((f32(conf.code_length_chips) - state.rem_code_phase)
                      / state.code_freq * conf.fs).to(I32)
    return torch.clamp(n_c, 1, conf.block_size)


def _epoch_closure_plain(conf: TrackingConf, state: TrackState,
                         corr: torch.Tensor, data_prompt, n_c: torch.Tensor):
    """Plain version of K9: one epoch's loop closure from the correlations
    `corr` [C, K] (and the data prompt [C] of a pilot chain, or None) over
    `n_c` samples -> (the next TrackState, the epoch's output row)."""
    _check_epoch_conf(conf)
    fs = conf.fs
    dev = corr.device
    code_len = f32(conf.code_length_chips)
    t_int = n_c.to(F32) / f32(fs)
    veml = conf.very_early_late_space_chips > 0.0
    if veml:   # taps = [VE, E, P, L, VL]
        v_early, early, prompt, late, v_late = corr.unbind(1)
    else:
        early, prompt, late = corr.unbind(1)

    # --- secondary-code sync + wipeoff (acquire_secondary :925-969) -------
    n_sec = len(conf.secondary_code)
    if n_sec:
        sec = _sec_device(conf, dev)
        sign_now = torch.where(prompt.real >= 0.0, 1.0, -1.0)
        slot = torch.remainder(state.epoch, n_sec)
        slot_hot = (torch.arange(N_SEC_MAX, device=dev)[None, :]
                    == slot[:, None])
        sec_buf = torch.where(slot_hot, sign_now[:, None], state.sec_buf)
        # hard sign-match over all cyclic shifts: buf[i] must equal
        # polarity * sec[(i+off) % n] for one off with |corr| == n
        shift = torch.zeros((n_sec, N_SEC_MAX), dtype=F32, device=dev)
        i = torch.arange(n_sec, device=dev)
        shift[:, :n_sec] = sec[(i[None, :] + i[:, None]) % n_sec]
        corr_sec = sec_buf @ shift.T                           # [C, n_sec]
        best_off = torch.argmax(torch.abs(corr_sec), dim=-1)
        best = torch.gather(corr_sec, 1, best_off[:, None])[:, 0]
        hit = (~state.sec_synced & (state.epoch >= n_sec)
               & (torch.abs(best) >= float(np.float32(n_sec) - 0.5)))
        sec_synced = state.sec_synced | hit
        sec_off = torch.where(hit, best_off.to(I32), state.sec_off)
        sec_polarity = torch.where(hit, torch.sign(best), state.sec_polarity)
        chip_idx = torch.remainder(state.epoch + sec_off, n_sec)
        wipe = torch.where(sec_synced, sec[chip_idx.long()] * sec_polarity,
                           1.0)
        prompt_w, early_w, late_w = prompt * wipe, early * wipe, late * wipe
    else:
        prompt_w, early_w, late_w = prompt, early, late
        sec_buf, sec_synced = state.sec_buf, state.sec_synced
        sec_off, sec_polarity = state.sec_off, state.sec_polarity

    # --- loop closure (run_dll_pll :1065) ---------------------------------
    carr_err_cyc = discriminators.pll_costas(prompt_w) / (2.0 * math.pi)
    if veml:
        code_err_chips = discriminators.dll_nc_vemlp_normalized(
            torch.abs(v_early), torch.abs(early), torch.abs(late),
            torch.abs(v_late), f32(conf.early_late_space_chips))
    else:
        code_err_chips = discriminators.dll_nc_e_minus_l_normalized(
            torch.abs(early), torch.abs(late),
            f32(conf.early_late_space_chips))
    kf_p, kf_fdot = state.kf_p, state.kf_fdot
    bayes = (state.bayes_nu, state.bayes_psi_code, state.bayes_psi_carr)
    if conf.kalman:
        r_code = r_carr = None
        if conf.tracking_mode == "gaussian":
            r_code, r_carr = _bayes_r(state)
        (carrier_doppler, code_freq, dtau_chips, dphi_cyc, kf_p,
         kf_fdot) = _kf_update(conf, state, prompt_w, carr_err_cyc,
                               code_err_chips, t_int, r_code, r_carr)
        if conf.tracking_mode == "gaussian":
            lam = f32(conf.bayes_forgetting)
            bayes = (lam * state.bayes_nu + 1.0,
                     lam * state.bayes_psi_code
                     + code_err_chips * code_err_chips,
                     lam * state.bayes_psi_carr
                     + carr_err_cyc * carr_err_cyc)
        pll_new = lf.LoopFilterState(vel=carrier_doppler, acc=state.pll.acc)
        dll_new = state.dll
    else:
        carrier_doppler, code_freq, pll_new, dll_new = _dll_pll_update(
            conf, state, prompt_w, carr_err_cyc, code_err_chips, t_int)

    # --- extended coherent integration (states 2->3->4; not in the Kalman
    # modes, which close every epoch) --------------------------------------
    bit_hist, prev_sign = state.bit_hist, state.prev_sign
    bit_synced, bit_phase = state.bit_synced, state.bit_phase
    ext_p, ext_e, ext_l = state.ext_p, state.ext_e, state.ext_l
    ext_n = state.ext_n
    k_ext = conf.extend_correlation_symbols
    if k_ext > 1 and not conf.kalman:
        if n_sec:
            # pilot: the secondary code is the symbol structure; groups
            # align to its boundaries after wipeoff
            bit_synced = sec_synced
            prev_sign = torch.where(prompt_w.real >= 0, 1.0, -1.0)
            at_bit_start = torch.remainder(state.epoch + sec_off, n_sec) == 0
        else:
            # on-device bit sync: histogram of prompt-I sign transitions
            # over epoch % 20 (the reference's 20-symbol pattern sync,
            # dll_pll_veml_tracking.cc:1852-1867)
            prev_sign = torch.where(prompt.real >= 0, 1.0, -1.0)
            flip = (state.prev_sign != 0.0) & (prev_sign != state.prev_sign)
            idx20 = torch.remainder(state.epoch, 20)
            bins = torch.arange(20, device=dev)[None, :]
            onehot = (bins == idx20[:, None]).to(F32)
            bit_hist = state.bit_hist + torch.where(
                ((~state.bit_synced) & flip)[:, None], onehot, 0.0)
            peak = torch.amax(bit_hist, dim=-1)
            arg = torch.argmax(bit_hist, dim=-1)
            second = torch.amax(torch.where(bins == arg[:, None], 0.0,
                                            bit_hist), dim=-1)
            # dominance test: sign errors scatter spurious transitions over
            # all bins, so the top bin must clearly dominate
            newly = (~state.bit_synced
                     & (peak >= conf.bit_sync_min_transitions)
                     & (peak >= 4.0 * torch.clamp(second, min=1.0)))
            bit_synced = state.bit_synced | newly
            bit_phase = torch.where(newly, arg.to(I32), state.bit_phase)
            at_bit_start = idx20 == bit_phase
        ext_on = bit_synced & (state.epoch >= conf.fll_pullin_epochs)
        restart = at_bit_start | (state.ext_n <= 0)

        def group(new, acc):
            return torch.where(ext_on, torch.where(restart, new, acc + new),
                               0.0)
        ext_p = group(prompt_w, state.ext_p)
        ext_e = group(early_w, state.ext_e)
        ext_l = group(late_w, state.ext_l)
        ext_n = torch.where(ext_on, torch.where(restart, 1, state.ext_n + 1),
                            0)
        close_now = ext_on & (ext_n == k_ext)
        # narrow-bandwidth closure on the coherent sums
        carr_err_ext = discriminators.pll_costas(ext_p) / (2.0 * math.pi)
        code_err_ext = discriminators.dll_nc_e_minus_l_normalized(
            torch.abs(ext_e), torch.abs(ext_l),
            f32(conf.early_late_space_chips))
        dop_ext, cf_ext, pll_ext, dll_ext = _dll_pll_update(
            conf, state, prompt_w, carr_err_ext, code_err_ext,
            t_int * k_ext, pll_bw_hz=conf.pll_bw_narrow_hz,
            dll_bw_hz=conf.dll_bw_narrow_hz, apply_fll=False)

        def sel3(wide, ext, hold):   # wide (pre-sync) | closed | hold
            return torch.where(~ext_on, wide,
                               torch.where(close_now, ext, hold))
        carrier_doppler = sel3(carrier_doppler, dop_ext,
                               state.carrier_doppler)
        code_freq = sel3(code_freq, cf_ext, state.code_freq)
        pll_new = lf.LoopFilterState(*map(sel3, pll_new, pll_ext, state.pll))
        dll_new = lf.LoopFilterState(*map(sel3, dll_new, dll_ext, state.dll))
        ext_p = torch.where(close_now, 0.0, ext_p)
        ext_e = torch.where(close_now, 0.0, ext_e)
        ext_l = torch.where(close_now, 0.0, ext_l)
        ext_n = torch.where(close_now, 0, ext_n)

    # --- NCO phase carry with the frequencies USED this epoch; the Kalman
    # tracker also feeds its phase-error estimates into the remnants (the
    # error-state feedback form of kf_tracking) -------------------------------
    rem_code = state.rem_code_phase + state.code_freq * t_int - code_len
    carr_adv_cycles = state.carrier_doppler * t_int
    if conf.kalman:
        rem_code = rem_code + dtau_chips
        carr_adv_cycles = carr_adv_cycles + dphi_cyc
    rem_carr = torch.remainder(
        state.rem_carr_phase + 2.0 * math.pi * carr_adv_cycles,
        2.0 * math.pi)
    # Kahan accumulation of total carrier cycles (not re-associated)
    y = carr_adv_cycles - state.acc_phase_comp
    t_sum = state.acc_phase_cycles + y
    comp = (t_sum - state.acc_phase_cycles) - y
    pos_next = state.pos + n_c

    # --- C/N0 + lock detection every cn0_window epochs (:972-1035), on the
    # secondary-wiped prompt ----------------------------------------------
    acc = cn0_ops.accumulate(state.cn0_acc, prompt_w)
    window_done = torch.remainder(state.epoch + 1,
                                  conf.cn0_window_epochs) == 0
    cn0_new = cn0_ops.cn0_m2m4_estimate(acc, t_int)
    lock_new = (0.75 * state.carrier_lock
                + 0.25 * cn0_ops.carrier_lock_value(
                    acc, rectify=conf.lock_rectify))
    cn0_db = torch.where(window_done, cn0_new, state.cn0_db_hz)
    carrier_lock = torch.where(window_done, lock_new, state.carrier_lock)
    in_transitory = state.epoch < conf.fll_pullin_epochs
    locked = (((carrier_lock > conf.carrier_lock_threshold)
               & (cn0_db > conf.cn0_min_db_hz)) | in_transitory)
    fail, lost = cn0_ops.update_lock_counters(
        state.lock_fail, locked, f32(conf.max_lock_fail))
    fail = torch.where(window_done, fail, state.lock_fail)
    lost = torch.where(window_done, lost | state.lock_lost, state.lock_lost)
    acc = cn0_ops.Cn0AccumState(*(torch.where(window_done,
                                              torch.zeros_like(a), a)
                                  for a in acc))

    # --- masked commit (inactive channels advance nominally) --------------
    act = state.active

    def sel(new, old):
        return torch.where(act, new, old)

    def sel_rows(new, old):
        return torch.where(act[:, None], new, old)

    new_state = state._replace(
        active=act & ~lost,
        pos=torch.where(act, pos_next,
                        state.pos + conf.nominal_epoch_samples),
        rem_code_phase=sel(rem_code, state.rem_code_phase),
        code_freq=sel(code_freq, state.code_freq),
        carrier_doppler=sel(carrier_doppler, state.carrier_doppler),
        rem_carr_phase=sel(rem_carr, state.rem_carr_phase),
        acc_phase_cycles=sel(t_sum, state.acc_phase_cycles),
        acc_phase_comp=sel(comp, state.acc_phase_comp),
        dll=lf.LoopFilterState(*map(sel, dll_new, state.dll)),
        pll=lf.LoopFilterState(*map(sel, pll_new, state.pll)),
        prompt_prev=sel(prompt_w, state.prompt_prev),
        epoch=torch.where(act, state.epoch + 1, state.epoch),
        cn0_acc=cn0_ops.Cn0AccumState(*map(sel, acc, state.cn0_acc)),
        cn0_db_hz=sel(cn0_db, state.cn0_db_hz),
        carrier_lock=sel(carrier_lock, state.carrier_lock),
        lock_fail=sel(fail, state.lock_fail),
        lock_lost=sel(lost, state.lock_lost),
        bit_hist=sel_rows(bit_hist, state.bit_hist),
        prev_sign=sel(prev_sign, state.prev_sign),
        bit_synced=sel(bit_synced, state.bit_synced),
        bit_phase=sel(bit_phase, state.bit_phase),
        ext_p=sel(ext_p, state.ext_p), ext_e=sel(ext_e, state.ext_e),
        ext_l=sel(ext_l, state.ext_l), ext_n=sel(ext_n, state.ext_n),
        sec_buf=sel_rows(sec_buf, state.sec_buf),
        sec_synced=sel(sec_synced, state.sec_synced),
        sec_off=sel(sec_off, state.sec_off),
        sec_polarity=sel(sec_polarity, state.sec_polarity),
        kf_p=torch.where(act[:, None, None], kf_p, state.kf_p),
        kf_fdot=sel(kf_fdot, state.kf_fdot),
        bayes_nu=sel(bayes[0], state.bayes_nu),
        bayes_psi_code=sel(bayes[1], state.bayes_psi_code),
        bayes_psi_carr=sel(bayes[2], state.bayes_psi_carr),
    )
    outputs = {
        # telemetry reads "prompt": on a track_pilot chain the DATA
        # component's prompt; the pilot prompt stays beside it
        "prompt": prompt if data_prompt is None else data_prompt,
        "early_mag": torch.abs(early),
        "late_mag": torch.abs(late),
        "carrier_doppler_hz": state.carrier_doppler,
        "code_freq_cps": state.code_freq,
        "rem_code_phase_chips": state.rem_code_phase,
        # accumulated carrier phase at epoch END (cycles; Kahan: true sum
        # = t - c)
        "acc_phase_cycles": t_sum - comp,
        # replica chips past the code boundary at epoch end, in samples
        "code_phase_samples": rem_code * f32(fs) / state.code_freq,
        "pos_start": state.pos,
        "n_samples": n_c,
        "cn0_db_hz": cn0_db,
        "valid": act,
        "pilot_prompt": prompt,
    }
    return new_state, outputs


def _correlate(conf: TrackingConf, codes, taps, x_chunk, state: TrackState,
               n_c, data_codes=None):
    """K2 over one epoch -> (corr [C, K], data prompt [C] or None): the
    data prompt of a track_pilot chain is one more zero-offset tap on the
    data table, in the same pass."""
    k_ovs = codes.shape[1] // conf.code_length_chips
    data = conf.track_pilot and data_codes is not None
    corr = correlator.multicorrelate(
        x_chunk, state.pos, conf.block_size, codes, taps,
        state.rem_code_phase, state.code_freq, state.rem_carr_phase,
        state.carrier_doppler, n_c, conf.fs, table_oversample=k_ovs,
        data_codes=data_codes if data else None,
        data_oversample=(data_codes.shape[1] // conf.code_length_chips
                         if data else 1))
    if data:
        return corr[:, :-1], corr[:, -1]
    return corr, None


def _epoch_step(conf: TrackingConf, codes: torch.Tensor, taps: torch.Tensor,
                x_chunk: torch.Tensor, state: TrackState,
                data_codes: torch.Tensor | None = None):
    """Advance every channel by one code epoch: K2, then the closure's
    plain version.  Returns (state', outputs)."""
    n_c = _epoch_length(conf, state)
    corr, data_prompt = _correlate(conf, codes, taps, x_chunk, state, n_c,
                                   data_codes)
    return _epoch_closure_plain(conf, state, corr, data_prompt, n_c)


# the chunk's [T, C] output planes (the block scan writes the first twelve;
# the per-epoch scan all of them)
PLANES = (("prompt", torch.complex64), ("early_mag", F32),
          ("late_mag", F32), ("carrier_doppler_hz", F32),
          ("code_freq_cps", F32), ("rem_code_phase_chips", F32),
          ("acc_phase_cycles", F32), ("code_phase_samples", F32),
          ("pos_start", I32), ("n_samples", I32), ("cn0_db_hz", F32),
          ("valid", torch.bool))
EPOCH_PLANES = PLANES + (("pilot_prompt", torch.complex64),)


def _empty_planes(n_epochs: int, n_ch: int, device,
                  planes=PLANES) -> dict:
    return {k: torch.empty((n_epochs, n_ch), dtype=dt, device=device)
            for k, dt in planes}


# ---- kernel K9 ---------------------------------------------------------------

# the TrackState fields that the epoch closure reads or writes, in the order
# of csrc/epoch_step.cu's EpochStatePtrs ("dll_vel" is st.dll.vel, "acc_m2"
# st.cn0_acc.sum_m2); the last five, the Kalman trackers', move only in the
# kf and gaussian modes (the DLL/PLL forms pass them through)
_CN0_FIELDS = dict(zip(("acc_abs_i", "acc_abs_q", "acc_m2", "acc_m4",
                        "acc_i", "acc_q", "acc_count"),
                       cn0_ops.Cn0AccumState._fields))
_EPOCH_STATE_FIELDS = (
    ("active", torch.bool), ("pos", I32), ("rem_code_phase", F32),
    ("code_freq", F32), ("carrier_doppler", F32), ("rem_carr_phase", F32),
    ("acc_phase_cycles", F32), ("acc_phase_comp", F32), ("dll_vel", F32),
    ("dll_acc", F32), ("pll_vel", F32), ("pll_acc", F32),
    ("prompt_prev", torch.complex64), ("epoch", I32),
    *((name, F32) for name in _CN0_FIELDS),
    ("cn0_db_hz", F32), ("carrier_lock", F32), ("lock_fail", F32),
    ("lock_lost", torch.bool), ("bit_hist", F32), ("prev_sign", F32),
    ("bit_synced", torch.bool), ("bit_phase", I32),
    ("ext_p", torch.complex64), ("ext_e", torch.complex64),
    ("ext_l", torch.complex64), ("ext_n", I32), ("sec_buf", F32),
    ("sec_synced", torch.bool), ("sec_off", I32), ("sec_polarity", F32),
    ("kf_p", F32), ("kf_fdot", F32), ("bayes_nu", F32),
    ("bayes_psi_code", F32), ("bayes_psi_carr", F32))
_KALMAN_FIELDS = frozenset(("kf_p", "kf_fdot", "bayes_nu", "bayes_psi_code",
                            "bayes_psi_carr"))
# the per-channel shape of the fields that are not one value a channel
_SHAPES = {"bit_hist": (20,), "sec_buf": (N_SEC_MAX,), "kf_p": (4, 4)}
_WIDE = {name: math.prod(shape) for name, shape in _SHAPES.items()}
_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _epoch_field(st: TrackState, name: str) -> torch.Tensor:
    if name[:4] in ("dll_", "pll_"):
        return getattr(getattr(st, name[:3]), name[4:])
    if name in _CN0_FIELDS:
        return getattr(st.cn0_acc, _CN0_FIELDS[name])
    return getattr(st, name)


class _EpochStatePtrs(ctypes.Structure):
    _fields_ = [(name, _P) for name, _ in _EPOCH_STATE_FIELDS]


class _EpochPlanePtrs(ctypes.Structure):
    _fields_ = [(name, _P) for name, _ in EPOCH_PLANES]


class _EpochArgs(ctypes.Structure):
    _fields_ = [("src", _EpochStatePtrs), ("dst", _EpochStatePtrs),
                ("planes", _EpochPlanePtrs), ("corr", _P), ("n_c", _P),
                ("sec", _P),
                *((n, _F) for n in (
                    "fs", "inv_fs", "code_len", "two_pi", "inv_two_pi",
                    "el_gain", "veml_gain", "pll_k3", "pll_k11", "pll_k24",
                    "npll_k3", "npll_k11", "npll_k24", "dll_k2", "dll_k14",
                    "ndll_k2", "ndll_k14", "fll_k4", "k_ext_f",
                    "lock_threshold", "cn0_min", "max_lock_fail",
                    "code_rate", "inv_fc", "dop_bias", "bit_sync_min",
                    "sec_thresh", "pll2_k2", "pll2_k14", "npll2_k2",
                    "npll2_k14", "kf_beta", "kf_q_code", "kf_q_phase",
                    "kf_q_dop", "kf_q_doprate", "kf_r_code", "kf_r_phase",
                    "bayes_lam")),
                *((n, _I) for n in (
                    "n_taps", "veml", "has_data", "n_ch", "n_rows", "n_sec",
                    "k_ext", "fll_on", "fll_decision", "fll_pullin_epochs",
                    "cn0_window", "block_size", "nominal", "mode",
                    "pll_order", "lock_rectify"))]


def _recip(v) -> float:
    """1 / float32(v) in float32: how ATen's CUDA division by a CPU scalar
    divides (it multiplies by this reciprocal)."""
    return float(np.float32(1.0) / np.float32(v))


def _fl(v) -> float:
    return float(np.float32(v))


@functools.lru_cache(maxsize=None)
def _epoch_constants(conf: TrackingConf) -> dict:
    """The scalars of one conf's epoch closure, each rounded as the plain
    version rounds it: the loop-filter gains are products of 0-d float32
    CPU tensors there, computed here by the same torch expressions."""
    def pll(bw):
        wn = f32(bw / 0.7845)
        return (float(wn * wn * wn), float(1.1 * wn * wn), float(2.4 * wn))

    def pll2(bw):
        wn = f32(bw / 0.53)
        return float(wn * wn), float(1.414213562 * wn)

    def dll(bw):
        wn = f32(bw) / 0.53
        return float(wn * wn), float(1.414213562 * wn)
    sp = f32(conf.early_late_space_chips)
    n_sec = len(conf.secondary_code)
    k_ext = 1 if conf.kalman else conf.extend_correlation_symbols
    c = dict(zip(("pll_k3", "pll_k11", "pll_k24"), pll(conf.pll_bw_hz)))
    c.update(zip(("npll_k3", "npll_k11", "npll_k24"),
                 pll(conf.pll_bw_narrow_hz)))
    c.update(zip(("pll2_k2", "pll2_k14"), pll2(conf.pll_bw_hz)))
    c.update(zip(("npll2_k2", "npll2_k14"), pll2(conf.pll_bw_narrow_hz)))
    c.update(zip(("dll_k2", "dll_k14"), dll(conf.dll_bw_hz)))
    c.update(zip(("ndll_k2", "ndll_k14"), dll(conf.dll_bw_narrow_hz)))
    c.update(
        kf_beta=float(f32(conf.code_rate_cps / conf.carrier_freq_hz)),
        kf_q_code=_fl(conf.kf_q_code_chips2),
        kf_q_phase=_fl(conf.kf_q_phase_cyc2), kf_q_dop=_fl(conf.kf_q_dop_hz2),
        kf_q_doprate=_fl(conf.kf_q_doprate_hz2s2),
        kf_r_code=_fl(conf.kf_r_code_chips2),
        kf_r_phase=_fl(conf.kf_r_phase_cyc2),
        bayes_lam=_fl(conf.bayes_forgetting),
        mode=TRACKING_MODES.index(conf.tracking_mode),
        pll_order=3 if conf.pll_filter_order == 3 else 2,
        lock_rectify=int(conf.lock_rectify),
        dop_bias=_fl(conf.doppler_bias_hz))
    c.update(
        fs=_fl(conf.fs), inv_fs=_recip(conf.fs),
        code_len=_fl(conf.code_length_chips), two_pi=_fl(2.0 * math.pi),
        inv_two_pi=_recip(2.0 * math.pi),
        el_gain=float(0.5 * (2.0 - sp)), veml_gain=float(0.5 * sp),
        fll_k4=float(4.0 * f32(conf.fll_bw_hz)),
        k_ext_f=_fl(k_ext),
        lock_threshold=_fl(conf.carrier_lock_threshold),
        cn0_min=_fl(conf.cn0_min_db_hz), max_lock_fail=_fl(conf.max_lock_fail),
        code_rate=_fl(conf.code_rate_cps), inv_fc=_recip(conf.carrier_freq_hz),
        bit_sync_min=_fl(conf.bit_sync_min_transitions),
        sec_thresh=float(np.float32(n_sec) - 0.5),
        veml=int(conf.very_early_late_space_chips > 0.0), n_sec=n_sec,
        # the FLL pull-in: on the KF whenever enable_fll_pullin is set; on
        # the loops, with a secondary code, in its decision-directed form only
        k_ext=k_ext, fll_on=int(conf.enable_fll_pullin if conf.kalman
                                else _fll_on(conf)),
        fll_decision=int(conf.fll_decision_directed),
        fll_pullin_epochs=conf.fll_pullin_epochs,
        cn0_window=conf.cn0_window_epochs, block_size=conf.block_size,
        nominal=conf.nominal_epoch_samples)
    return c


def _epoch_state_ptrs(st: TrackState, dev, what: str) -> _EpochStatePtrs:
    c = st.active.shape[0]
    ptrs = _EpochStatePtrs()
    for name, dt in _EPOCH_STATE_FIELDS:
        t = _epoch_field(st, name)
        require(t, dt, dev, f"{what}: state field {name}")
        shape = (c, *_SHAPES.get(name, ()))
        if t.shape != shape:
            raise ValueError(f"{what}: state field {name} has shape "
                             f"{tuple(t.shape)}, not {shape}")
        setattr(ptrs, name, t.data_ptr())
    return ptrs


def _empty_epoch_state(st: TrackState, kalman: bool) -> TrackState:
    """A TrackState with fresh tensors for the fields the epoch closure
    writes (the Kalman trackers' with `kalman` only) and `st`'s own tensors
    for the rest."""
    def fresh(t):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)
    new = {name: fresh(getattr(st, name)) for name, _ in _EPOCH_STATE_FIELDS
           if name[:4] not in ("dll_", "pll_") and name not in _CN0_FIELDS
           and (kalman or name not in _KALMAN_FIELDS)}
    new["dll"] = lf.LoopFilterState(*map(fresh, st.dll))
    new["pll"] = lf.LoopFilterState(*map(fresh, st.pll))
    new["cn0_acc"] = cn0_ops.Cn0AccumState(*map(fresh, st.cn0_acc))
    return st._replace(**new)


@functools.lru_cache(maxsize=None)
def _sec_device(conf: TrackingConf, dev: torch.device) -> torch.Tensor:
    """The secondary code (+-1 float32) on `dev`, one upload per conf and
    device; one zero for none."""
    sec = secondary_pm1(conf) if conf.secondary_code else np.zeros(1)
    return torch.from_numpy(sec.astype(np.float32)).to(dev)


def _epoch_args(conf, corr, n_c, sec, src, dst, planes) -> _EpochArgs:
    dev = corr.device
    _check_epoch_conf(conf)
    c = src.active.shape[0]
    k = 5 if conf.very_early_late_space_chips > 0.0 else 3
    has_data = corr.shape[1] - k
    require(corr, torch.complex64, dev, "epoch_closure: corr")
    require(n_c, I32, dev, "epoch_closure: n_c")
    require(sec, F32, dev, "epoch_closure: sec")
    if corr.shape[0] != c or has_data not in (0, 1) or n_c.shape != (c,) \
            or sec.numel() < len(conf.secondary_code):
        raise ValueError("epoch_closure: shape mismatch")
    n_rows = planes["prompt"].shape[0]
    pp = _EpochPlanePtrs()
    for name, dt in EPOCH_PLANES:
        require(planes[name], dt, dev, f"epoch_closure: plane {name}")
        if planes[name].shape != (n_rows, c):
            raise ValueError(f"epoch_closure: plane {name} shape")
        setattr(pp, name, planes[name].data_ptr())
    consts = _epoch_constants(conf)
    return _EpochArgs(
        src=_epoch_state_ptrs(src, dev, "epoch_closure"),
        dst=_epoch_state_ptrs(dst, dev, "epoch_closure"),
        planes=pp, corr=corr.data_ptr(), n_c=n_c.data_ptr(),
        sec=sec.data_ptr(),
        **{n: consts[n] for n, _ in _EpochArgs._fields_ if n in consts},
        n_taps=k, has_data=has_data, n_ch=c, n_rows=n_rows)


class _EpochChunkArgs(ctypes.Structure):
    _fields_ = [("k2", correlator._K2Args), ("ep", _EpochArgs),
                ("n_epochs", _I)]


def _epoch_lib():
    lib = cuda_build.load("epoch_kernels")
    if lib.epoch_closure.argtypes is None:
        lib.epoch_closure.argtypes = [_EpochArgs, _I, _P]
        lib.epoch_closure.restype = _I
        lib.epoch_chunk.argtypes = [_EpochChunkArgs, _I, _I, _P]
        lib.epoch_chunk.restype = _I
        lib.epoch_chunk_max_clusters.argtypes = [_I, _I, _I, _I,
                                                 ctypes.POINTER(_I)]
        lib.epoch_chunk_max_clusters.restype = _I
    return lib


def _launch_closure(args: _EpochArgs, row: int, stream: int) -> None:
    cuda_build.check(_epoch_lib().epoch_closure(args, row, stream),
                     "epoch_closure")
    epoch_closure.launches += 1


def _write_row(planes: dict, outs: dict, row: int) -> None:
    for k, _ in EPOCH_PLANES:
        planes[k][row] = outs[k]


def epoch_closure(conf: TrackingConf, corr: torch.Tensor,
                  n_c: torch.Tensor, st: TrackState, planes: dict,
                  row: int) -> TrackState:
    """K9 wrapper: one epoch's loop closure from its correlations `corr`
    [C, K] or [C, K+1] (the last column the data prompt of a track_pilot
    chain) over `n_c` samples; returns the next TrackState, writes the
    epoch's row `row` of the chunk's [T, C] `planes` (EPOCH_PLANES) and,
    on the card, the next epoch's lengths into `n_c`.  Launches
    ``csrc/epoch_step.cu``'s epoch_closure for CUDA tensors, runs
    :func:`_epoch_closure_plain` for CPU tensors."""
    k = 5 if conf.very_early_late_space_chips > 0.0 else 3
    if not check_kernel_device(corr, "epoch_closure"):
        data = corr[:, k] if corr.shape[1] > k else None
        new, outs = _epoch_closure_plain(conf, st, corr[:, :k], data, n_c)
        _write_row(planes, outs, row)
        n_c.copy_(_epoch_length(conf, new))
        return new
    out = _empty_epoch_state(st, conf.kalman)
    _launch_closure(_epoch_args(conf, corr, n_c,
                                _sec_device(conf, corr.device), st, out,
                                planes),
                    row, torch.cuda.current_stream(corr.device).cuda_stream)
    return out


epoch_closure.launches = 0


# ---- the chunk: kernel K9 redesigned ------------------------------------------

# the chunk kernel's clusters (csrc/epoch_chunk.cu): at most 16 CTAs, the
# non-portable size its library allows (8 and under are portable)
EPOCH_CHUNK_MAX_CLUSTER = 16
# the shared memory a CTA may take on an H100 (227 KB); beside its dynamic
# part the kernel holds ~1.4 KB of static shared memory (K2's per-warp
# sums, the channel's state and its pointers), bounded here
SMEM_PER_CTA = 232448
EPOCH_CHUNK_STATIC_SMEM = 2048


class EpochChunkPlan(NamedTuple):
    """The chunk kernel's launch shape: K2's own plan (S slabs and the
    staged spans, unchanged), clusters of `cluster` CTAs (S') per channel,
    `rounds` = ceil(S / S') slabs per CTA (slab s on CTA s mod S'), `smem`
    bytes of dynamic shared memory per CTA, and `waves`, the number of
    times the card fills with resident clusters to run the C channels (1
    where every channel's cluster is resident at once)."""
    k2: correlator.K2Plan
    cluster: int
    rounds: int
    smem: int
    waves: int = 1


def epoch_chunk_smem(k2: correlator.K2Plan, n_out: int, cluster: int) -> int:
    """Dynamic shared memory of a chunk-kernel CTA: K2's staged spans, then
    its slabs' [K(+1)] complex partials (csrc/epoch_chunk.cu chunk_smem)."""
    rounds = -(-k2.slabs // cluster)
    return 4 * (k2.stage + k2.data_stage + rounds * 2 * n_out)


def plan_epoch_chunk(n_ch: int, k2: correlator.K2Plan, n_out: int,
                     max_clusters) -> EpochChunkPlan:
    """The chunk kernel's plan for C channels of K(+1) = `n_out` outputs on
    K2's plan `k2`, over the cluster sizes S' (1 where S = 1; at most
    EPOCH_CHUNK_MAX_CLUSTER) whose shared memory fits a CTA's 227 KB and
    of which the card keeps at least one resident (`max_clusters(S',
    smem)`, the card's cudaOccupancyMaxActiveClusters):

    - where some size keeps every channel's cluster resident at once
      (`max_clusters >= C`), the one that runs the S slabs in the fewest
      rounds, the smallest such;
    - else the one that takes the fewest waves times rounds,
      ceil(C / max_clusters) * ceil(S / S'), the smallest on ties: the
      clusters are independent (their only barriers are cluster
      barriers), so the card runs them wave after wave.

    Raises if no size fits."""
    if not (1 <= n_ch <= 65535 and 1 <= n_out <= 9 and k2.slabs >= 1):
        raise ValueError(f"plan_epoch_chunk: no plan for C={n_ch}, "
                         f"{n_out} outputs, {k2}")
    fits = []                         # (waves, rounds, S', smem)
    for cl in range(1, min(EPOCH_CHUNK_MAX_CLUSTER, k2.slabs) + 1):
        smem = epoch_chunk_smem(k2, n_out, cl)
        if smem + EPOCH_CHUNK_STATIC_SMEM > SMEM_PER_CTA:
            continue
        resident = max_clusters(cl, smem)
        if resident > 0:
            fits.append((-(-n_ch // resident), -(-k2.slabs // cl), cl,
                         smem))
    if not fits:
        raise ValueError(f"plan_epoch_chunk: no cluster of C={n_ch} "
                         f"channels on {k2} fits the card")
    at_once = [f for f in fits if f[0] == 1]
    if at_once:
        waves, rounds, cl, smem = min(at_once, key=lambda f: (f[1], f[2]))
    else:
        waves, rounds, cl, smem = min(fits,
                                      key=lambda f: (f[0] * f[1], f[2]))
    return EpochChunkPlan(k2, cl, rounds, smem, waves)


# the closure's forms (csrc/epoch_step.cuh EpochForm), each an instantiation
# of the kernels of its own, and the chunk kernel's launch counter of each
# but the first (the third-order DLL/PLL form, counted in `launches` alone)
FORM_LOOP3, FORM_LOOP2, FORM_KF, FORM_GAUSS = range(4)
_FORM_COUNTERS = {FORM_LOOP2: "launches_pll2", FORM_KF: "launches_kf",
                  FORM_GAUSS: "launches_gaussian"}


def epoch_form(conf: TrackingConf) -> int:
    """The closure form that `conf` runs."""
    if conf.kalman:
        return FORM_KF if conf.tracking_mode == "kf" else FORM_GAUSS
    return FORM_LOOP3 if conf.pll_filter_order == 3 else FORM_LOOP2


def _card_max_clusters(n_ch: int, cluster: int, smem: int,
                       form: int = FORM_LOOP3) -> int:
    n = _I(0)
    cuda_build.check(_epoch_lib().epoch_chunk_max_clusters(
        cluster, n_ch, smem, form, ctypes.byref(n)),
        "epoch_chunk_max_clusters")
    return n.value


@functools.lru_cache(maxsize=None)
def _chunk_plan(n_ch: int, k2: correlator.K2Plan, n_out: int,
                form: int = FORM_LOOP3) -> EpochChunkPlan:
    """plan_epoch_chunk with the current card's occupancy for the closure
    form `form`."""
    return plan_epoch_chunk(n_ch, k2, n_out, functools.partial(
        _card_max_clusters, n_ch, form=form))


def _chunk_plain(conf: TrackingConf, n_epochs: int, codes, taps, x_chunk,
                 state: TrackState, data_codes=None):
    """The epoch loop through the plain closure (K2 through its wrapper):
    the form the CPU runs and the chunk kernel is held against."""
    planes = _empty_planes(n_epochs, codes.shape[0], x_chunk.device,
                           EPOCH_PLANES)
    for e in range(n_epochs):
        state, outs = _epoch_step(conf, codes, taps, x_chunk, state,
                                  data_codes)
        _write_row(planes, outs, e)
    return state, planes


def _chunk_inputs(conf: TrackingConf, codes, taps, data_codes):
    """(data tables or None, table oversampling, data-table oversampling,
    K2's plan) of one chunk on the card."""
    data = data_codes if conf.track_pilot and data_codes is not None \
        else None
    k_ovs = codes.shape[1] // conf.code_length_chips
    d_ovs = 1 if data is None else data.shape[1] // conf.code_length_chips
    plan = correlator.plan_k2(
        codes.shape[0], conf.block_size, codes.shape[1], k_ovs,
        0 if data is None else data.shape[1], d_ovs, sm_count(codes.device))
    return data, k_ovs, d_ovs, plan


class ChunkLaunch(NamedTuple):
    """One launch of the chunk kernel, its arguments built: the plan, the
    ctypes arguments and the tensors they point to (the next state, the
    planes, the lengths buffer), and the closure's form."""
    plan: EpochChunkPlan
    args: object                    # _EpochChunkArgs
    state: TrackState
    planes: dict
    n_c: torch.Tensor
    hold: tuple                     # the placeholder corr, the misses
    form: int = FORM_LOOP3


def chunk_launch(conf: TrackingConf, n_epochs: int, codes, taps, x_chunk,
                 state: TrackState, data_codes=None,
                 misses: torch.Tensor | None = None,
                 plan: EpochChunkPlan | None = None) -> ChunkLaunch:
    """The checked arguments of one chunk-kernel launch on CUDA tensors,
    into fresh output buffers; launch with :func:`launch_chunk`.  `plan`
    (K2's plan within it too) replaces the card's :func:`_chunk_plan`
    where given, as a check of the planner's choice does."""
    dev = x_chunk.device
    c, k = codes.shape[0], taps.shape[0]
    data, k_ovs, d_ovs, k2 = _chunk_inputs(conf, codes, taps, data_codes)
    n_out = k + int(data is not None)
    form = epoch_form(conf)
    if plan is None:
        plan = _chunk_plan(c, k2, n_out, form)
    k2 = plan.k2
    planes = _empty_planes(n_epochs, c, dev, EPOCH_PLANES)
    out = _empty_epoch_state(state, conf.kalman)
    n_c = _epoch_length(conf, state)
    if misses is None:
        misses = torch.zeros(1, dtype=torch.int64, device=dev)
    # the closure's correlations stay in shared memory: the argument's
    # `corr` is a placeholder of the right shape, never read
    corr = torch.empty((c, n_out), dtype=torch.complex64, device=dev)
    args = _EpochChunkArgs(
        k2=correlator.k2_args(x_chunk, conf.block_size, codes, taps, conf.fs,
                              k_ovs, k2, misses, data, d_ovs),
        ep=_epoch_args(conf, corr, n_c, _sec_device(conf, dev), state, out,
                       planes),
        n_epochs=n_epochs)
    return ChunkLaunch(plan, args, out, planes, n_c, (corr, misses), form)


def launch_chunk(launch: ChunkLaunch) -> None:
    """Launch the chunk kernel; counts the launch and its epochs, and the
    launch under its form's counter (the second-order PLL's, the KF's and
    the gaussian mode's), with the rectified lock test under
    ``launches_rectify`` and with an FDMA bias under ``launches_bias``;
    ``shapes`` counts the launches by (channels,
    nominal samples an epoch)."""
    cuda_build.check(_epoch_lib().epoch_chunk(
        launch.args, launch.plan.cluster, launch.plan.smem,
        torch.cuda.current_stream(launch.n_c.device).cuda_stream),
        "epoch_chunk")
    epoch_chunk.launches += 1
    epoch_chunk.epochs += launch.args.n_epochs
    epoch_chunk.shapes[(launch.args.ep.n_ch, launch.args.ep.nominal)] += 1
    if launch.form in _FORM_COUNTERS:
        name = _FORM_COUNTERS[launch.form]
        setattr(epoch_chunk, name, getattr(epoch_chunk, name) + 1)
    if launch.args.ep.lock_rectify:
        epoch_chunk.launches_rectify += 1
    if launch.args.ep.dop_bias != 0.0:
        epoch_chunk.launches_bias += 1


def epoch_chunk(conf: TrackingConf, n_epochs: int, codes: torch.Tensor,
                taps: torch.Tensor, x_chunk: torch.Tensor, state: TrackState,
                data_codes: torch.Tensor | None = None,
                misses: torch.Tensor | None = None):
    """The chunk kernel's wrapper: `n_epochs` epochs of every channel, K2's
    correlation then K9's closure each, in one launch of
    ``csrc/epoch_chunk.cu`` for CUDA tensors (one cluster of CTAs per
    channel, :func:`plan_epoch_chunk`); :func:`_chunk_plain` for CPU
    tensors.  Returns (new_state, [T, C] planes of EPOCH_PLANES).  Counts
    its launches in ``epoch_chunk.launches`` and the epochs they ran in
    ``epoch_chunk.epochs``; K2's staged-table misses go into `misses`
    (int64 [1] on the card) when given."""
    if not check_kernel_device(x_chunk, "epoch_chunk"):
        return _chunk_plain(conf, n_epochs, codes, taps, x_chunk, state,
                            data_codes)
    launch = chunk_launch(conf, n_epochs, codes, taps, x_chunk, state,
                          data_codes, misses)
    launch_chunk(launch)
    return launch.state, launch.planes


epoch_chunk.launches = 0
epoch_chunk.epochs = 0
epoch_chunk.launches_pll2 = 0
epoch_chunk.launches_kf = 0
epoch_chunk.launches_gaussian = 0
epoch_chunk.launches_rectify = 0
epoch_chunk.launches_bias = 0
epoch_chunk.shapes = collections.Counter()


def _chunk_two_launch(conf: TrackingConf, n_epochs: int, codes, taps,
                      x_chunk, state: TrackState, data_codes=None):
    """The epoch loop of standalone kernels on the card, per epoch K2 then
    K9, into buffers allocated once (K2's scratch among them), with no
    host sync and no torch op between them: the form the chunk kernel is
    held against bit for bit.  K9 writes the next epoch's lengths into the
    `n_c` buffer K2 reads; the state ping-pongs between two buffers; the
    launch arguments of the three (source, destination) pairs are built
    once.  On no tracking path."""
    dev = x_chunk.device
    c = codes.shape[0]
    k = taps.shape[0]
    data, k_ovs, d_ovs, _ = _chunk_inputs(conf, codes, taps, data_codes)
    planes = _empty_planes(n_epochs, c, dev, EPOCH_PLANES)
    bufs = (_empty_epoch_state(state, conf.kalman),
            _empty_epoch_state(state, conf.kalman))
    n_c = _epoch_length(conf, state)
    corr = torch.empty((c, k + int(data is not None)), dtype=torch.complex64,
                       device=dev)
    sec = _sec_device(conf, dev)
    pairs = ((state, bufs[0]), (bufs[0], bufs[1]), (bufs[1], bufs[0]))
    k2_scratch = correlator.k2_scratch(codes, k, conf.block_size, k_ovs,
                                       data, d_ovs)
    k2_args = [correlator.launch_args(
        x_chunk, src.pos, conf.block_size, codes, taps, src.rem_code_phase,
        src.code_freq, src.rem_carr_phase, src.carrier_doppler, n_c,
        conf.fs, k_ovs, corr, data, d_ovs, k2_scratch) for src, _ in pairs]
    k9_args = [_epoch_args(conf, corr, n_c, sec, src, dst, planes)
               for src, dst in pairs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for e in range(n_epochs):
        i = 0 if e == 0 else 1 + (e - 1) % 2
        correlator.launch(k2_args[i])
        _launch_closure(k9_args[i], e, stream)
    return bufs[(n_epochs - 1) % 2], planes


def track_chunk(conf: TrackingConf, n_epochs: int, codes: torch.Tensor,
                taps: torch.Tensor, x_chunk: torch.Tensor,
                state: TrackState, data_codes: torch.Tensor | None = None):
    """Run `n_epochs` code epochs of every channel over one sample chunk.
    Returns (new_state, outputs) with [T, C] output planes (EPOCH_PLANES).
    On the card one launch of the chunk kernel (:func:`epoch_chunk`); on
    the CPU K2's and K9's plain versions, epoch by epoch.  `data_codes` are
    the data tables of a track_pilot chain."""
    if n_epochs < 1:
        raise ValueError("track_chunk: n_epochs must be >= 1")
    return epoch_chunk(conf, n_epochs, codes, taps, x_chunk, state,
                       data_codes)


# keys of the float32 part of the full packed transfer, fixed order (the
# prompt split into its real and imaginary rows).  The lean set is what the
# host pipeline (telemetry, observables, FSM) consumes; the full set adds
# the diagnostic planes for the dumps and collect_track_outputs
_PACK_F32_LEAN = ("prompt_re", "carrier_doppler_hz", "acc_phase_cycles",
                  "code_phase_samples", "cn0_db_hz", "valid")
_PACK_F32_FULL = _PACK_F32_LEAN + ("prompt_im", "early_mag", "late_mag",
                                   "code_freq_cps", "rem_code_phase_chips")


def pack_full(outs: dict, new_state: TrackState,
              full_outputs: bool = True) -> torch.Tensor:
    """Every epoch's planes of one chunk in one int32 buffer: the 11 (or,
    without `full_outputs`, the 6 lean) float32 planes bitcast ([nf, T, C]),
    then pos_start and n_samples ([T, C] each) and the new state's pos,
    active and lock_lost ([C] each).  Byte for byte the JAX engine's
    layout (tracking.py:track_chunk_packed, 739-765)."""
    planes = dict(
        prompt_re=outs["prompt"].real, prompt_im=outs["prompt"].imag,
        early_mag=outs["early_mag"], late_mag=outs["late_mag"],
        carrier_doppler_hz=outs["carrier_doppler_hz"],
        code_freq_cps=outs["code_freq_cps"],
        rem_code_phase_chips=outs["rem_code_phase_chips"],
        acc_phase_cycles=outs["acc_phase_cycles"],
        code_phase_samples=outs["code_phase_samples"],
        cn0_db_hz=outs["cn0_db_hz"], valid=outs["valid"].to(F32))
    keys = _PACK_F32_FULL if full_outputs else _PACK_F32_LEAN
    f32p = torch.stack([planes[k] for k in keys])
    return torch.cat([
        f32p.view(I32).reshape(-1),
        outs["pos_start"].to(I32).reshape(-1),
        outs["n_samples"].to(I32).reshape(-1),
        new_state.pos.to(I32),
        new_state.active.to(I32),
        new_state.lock_lost.to(I32)])


def track_chunk_packed(conf: TrackingConf, n_epochs: int,
                       codes: torch.Tensor, taps: torch.Tensor,
                       x_chunk: torch.Tensor, state: TrackState,
                       full_outputs: bool = True,
                       data_codes: torch.Tensor | None = None):
    """track_chunk with every epoch's planes in one buffer for the host:
    (new_state, buf int32), see :func:`pack_full`."""
    new_state, outs = track_chunk(conf, n_epochs, codes, taps, x_chunk,
                                  state, data_codes)
    return new_state, pack_full(outs, new_state, full_outputs)


# float planes pulled at the decimated (observable-tick) stride, fixed order
_DECIM_F32 = ("carrier_doppler_hz", "acc_phase_cycles",
              "code_phase_samples", "cn0_db_hz")


def pack_decim(outs: dict, new_state: TrackState, n_epochs: int,
               decim: int) -> torch.Tensor:
    """The rate-split single-buffer transfer of one chunk (int32):
    [int8 prompt symbols packed 4 per word | the 4 float planes at rows
    decim-1, 2*decim-1, ... bitcast | sample counter at those rows |
    new pos C | active C | lock_lost C | symbol scale C (float bitcast)].
    Byte for byte the JAX engine's layout (tracking.py:807-840)."""
    pre = outs["prompt"].real                            # [T, C]
    valid = outs["valid"]
    scale = torch.clamp(torch.amax(torch.abs(pre), dim=0) / 126.0,
                        min=1e-20)                       # [C]
    q = torch.clamp(torch.round(pre / scale), -126.0, 126.0).to(torch.int8)
    sym = torch.where(valid, q, torch.full_like(q, -128))
    rows = torch.arange(decim - 1, max(n_epochs, decim - 1), decim,
                        device=pre.device)       # empty for a short tail
    f32p = torch.stack([outs[k][rows] for k in _DECIM_F32])  # [4, Td, C]
    sc = (outs["pos_start"][rows] + outs["n_samples"][rows]).to(I32)
    flat = sym.reshape(-1)
    pad = (-flat.shape[0]) % 4
    if pad:
        flat = torch.cat([flat, torch.zeros(pad, dtype=torch.int8,
                                            device=flat.device)])
    return torch.cat([
        flat.view(I32),
        f32p.contiguous().view(I32).reshape(-1),
        sc.reshape(-1),
        new_state.pos.to(I32),
        new_state.active.to(I32),
        new_state.lock_lost.to(I32),
        scale.contiguous().view(I32)])


def track_chunk_packed_decim(conf: TrackingConf, n_epochs: int, decim: int,
                             codes: torch.Tensor, taps: torch.Tensor,
                             x_chunk: torch.Tensor, state: TrackState,
                             data_codes: torch.Tensor | None = None):
    """track_chunk with the device -> host transfer cut to what the host
    pipeline consumes: (new_state, buf int32), see :func:`pack_decim`."""
    new_state, outs = track_chunk(conf, n_epochs, codes, taps, x_chunk,
                                  state, data_codes)
    return new_state, pack_decim(outs, new_state, n_epochs, decim)


class _Pull(NamedTuple):
    """A chunk's packed buffer on its way to the host.  On a card it is
    copied into pinned memory when the chunk is dispatched, behind an
    event, so that the pull waits for this chunk's work alone and not for
    the chunks dispatched after it (a pageable copy waits for the whole
    stream, and one launch per chunk leaves the host nothing else to
    overlap with)."""
    host: torch.Tensor
    done: object                    # torch.cuda.Event, None on the CPU


def _start_pull(buf: torch.Tensor) -> _Pull:
    if not buf.is_cuda:
        return _Pull(buf, None)
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(buf.device))
    return _Pull(host, done)


def _finish_pull(pull: _Pull) -> np.ndarray:
    if pull.done is not None:
        pull.done.synchronize()
    return pull.host.numpy()


class TrackingEngine:
    """Host-side wrapper: absolute sample bookkeeping + acquisition handoff.

    The caller feeds the capture (a device tensor, or a NumPy array that is
    uploaded per chunk); the engine cuts per-chunk windows, runs the block
    kernel or the per-epoch scan, and returns [T, C] epoch outputs with
    absolute sample counters (the Tracking_sample_counter of
    gnss_synchro.h).  `device=None` means the CUDA card and raises without
    one; pass device="cpu" for the plain versions of the kernels.
    """

    def __init__(self, conf: TrackingConf, prns, code_provider=None,
                 device=None, data_code_provider=None):
        """code_provider(prn) -> +-1 sub-chip table of length
        conf.code_length_chips (default: GPS L1 C/A); for BOC signals the
        sub-chip expansion (signals.subchip_table), conf rates in
        sub-chip units.  With conf.track_pilot, data_code_provider gives
        the DATA component's table for the data-prompt correlator."""
        self.conf = conf
        self.device = resolve_device(device)
        self.code_provider = code_provider or prn_codes.gps_l1_ca_code
        self.data_code_provider = data_code_provider
        self.prns = [int(p) for p in prns]
        self.n_channels = len(self.prns)
        # band-limited sub-chip replica tables: both kernels (per-epoch
        # gather and block FFT) correlate against the SAME filtered
        # waveform, so amplitudes and lock points agree across handoffs
        self.table_oversample = 8
        self._codes_host = np.stack([
            self._replica_table(self.code_provider, p) for p in self.prns])
        self.codes = torch.from_numpy(self._codes_host).to(self.device)
        self._data_host = self.data_codes = None
        if conf.track_pilot and data_code_provider is not None:
            self._data_host = np.stack([
                self._replica_table(data_code_provider, p)
                for p in self.prns])
            self.data_codes = torch.from_numpy(self._data_host).to(
                self.device)
        d = conf.early_late_space_chips
        dv = conf.very_early_late_space_chips
        if dv > 0.0:   # 5-tap VEML (reference very-early spacing, e.g. E1)
            tap_list = [+dv, +d / 2, 0.0, -d / 2, -dv]
        else:
            tap_list = [+d / 2, 0.0, -d / 2]
        self.taps = torch.from_numpy(np.array(tap_list, np.float32)).to(
            self.device)
        self.state = _init_state(self.n_channels, self.device)
        # every epoch's full planes (prompt Q, early/late, code rate) in
        # the pull, as the JAX engine defaults to; the receiver turns this
        # off but for collect_track_outputs (decimated pulls then)
        self.full_outputs = True
        self.abs_start = np.zeros(self.n_channels, np.int64)
        # --- chunk chaining / pipelining state (see process_begin) --------
        self._chain_base = None
        self._armed_since: set = set()
        self._armed_seq = np.full(self.n_channels, -1, np.int64)
        self._abs_f = np.zeros(self.n_channels, np.float64)
        self._code_freq_host = np.full(self.n_channels,
                                       conf.code_rate_cps, np.float64)
        self._dispatch_seq = 0
        self.epochs_dispatched = 0      # every epoch of every chunk
        # host mirrors of the state flags, refreshed from the packed pull
        self.active_host = np.zeros(self.n_channels, bool)
        self.lock_lost_host = np.zeros(self.n_channels, bool)
        self._codes_rep = None          # block-kernel replica, built lazily
        self._data_rep = self._sec_code = None

    def _replica_table(self, provider, prn: int) -> np.ndarray:
        if prn <= 0:
            return np.zeros(
                self.conf.code_length_chips * self.table_oversample,
                np.float32)
        return prn_codes.bandlimited_table_normalized(
            np.asarray(provider(prn), np.float32), self.conf.fs,
            self.conf.code_rate_cps, self.conf.nominal_epoch_samples,
            self.table_oversample)

    def set_channel_prn(self, ch: int, prn: int) -> None:
        """Re-point a channel at a different satellite (swaps its code-table
        rows; the tensors are replaced, never written in place, so a chunk
        still in flight keeps the tables it was dispatched with)."""
        self.prns[ch] = int(prn)
        self._codes_host = self._codes_host.copy()
        self._codes_host[ch] = self._replica_table(self.code_provider,
                                                   int(prn))
        self.codes = torch.from_numpy(self._codes_host).to(self.device)
        if self._data_host is not None:
            self._data_host = self._data_host.copy()
            self._data_host[ch] = self._replica_table(
                self.data_code_provider, int(prn))
            self.data_codes = torch.from_numpy(self._data_host).to(
                self.device)
        self._codes_rep = None

    def stop_channel(self, ch: int) -> None:
        self.state = self.state._replace(
            active=_set(self.state.active, ch, False))
        self.active_host[ch] = False

    def start_tracking(self, ch: int, doppler_hz: float,
                       abs_code_start_sample: int) -> None:
        """Arm channel `ch` from an acquisition result: the first epoch
        starts at the absolute sample where a code period begins, Doppler
        seeds the PLL integrator (dll_pll_veml_tracking.cc:643-884)."""
        code_freq0 = (self.conf.code_rate_cps
                      * (1.0 + (doppler_hz - self.conf.doppler_bias_hz)
                         / self.conf.carrier_freq_hz))
        self.state = _arm_channel(self.state, ch, float(doppler_hz),
                                  float(code_freq0))
        self.abs_start[ch] = int(abs_code_start_sample)
        self._abs_f[ch] = float(abs_code_start_sample)
        self._code_freq_host[ch] = code_freq0
        self._armed_since.add(ch)
        self._armed_seq[ch] = self._dispatch_seq
        self.active_host[ch] = True
        self.lock_lost_host[ch] = False

    def _read_margin(self) -> int:
        """Samples a chunk may read past its last epoch: the per-epoch
        block, or on a dll_pll chain with extend_correlation_symbols == 1
        (one the block kernel may run) the larger of it and the block
        kernel's window (+ guards), so chunk sizing never depends on the
        kernel choice."""
        from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
        m = self.conf.block_size + 64
        if (self.conf.tracking_mode == "dll_pll"
                and self.conf.extend_correlation_symbols == 1):
            m = max(m, tb.block_fft_size(self.conf) + 256 + 64)
        return m

    def max_position(self) -> int:
        active = self.active_host
        if not active.any():
            return 0
        return int(self.abs_start[active].max())

    def epochs_that_fit(self, stream_len: int) -> int:
        """How many epochs every active channel can run without reading
        past `stream_len` samples (worst-case epoch length nominal+2)."""
        return max(0, int((stream_len - self._read_margin()
                           - self.max_position())
                          // (self.conf.nominal_epoch_samples + 2)))

    @property
    def block_epochs(self) -> int:
        """Epochs per block for the block kernel: ~20 ms of signal."""
        return max(2, int(round(0.02 / self.conf.t_epoch_nominal_s)))

    def block_mode_ok(self, n_epochs: int) -> bool:
        """Whether this chunk can run on the block kernel: DLL/PLL loops
        without extended integration, decimated pulls, whole blocks."""
        return (self.conf.tracking_mode == "dll_pll"
                and self.conf.extend_correlation_symbols == 1
                and not self.full_outputs
                and n_epochs % self.block_epochs == 0
                and n_epochs >= 2 * self.block_epochs)

    def _ensure_block_tables(self):
        """The block kernel's replica tables from the same band-limited
        tables the per-epoch kernel gathers from: the code's, on a
        track_pilot chain the data code's, and the secondary code (+-1)."""
        from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
        if self._codes_rep is None:
            self._codes_rep = tb.code_spectra(self.conf, self._codes_host,
                                              device=self.device)
            self._data_rep = None
            if self._data_host is not None:
                self._data_rep = tb.code_spectra(self.conf, self._data_host,
                                                 device=self.device)
        if self._sec_code is None and self.conf.secondary_code:
            self._sec_code = _sec_device(self.conf, self.device)

    def process(self, x, x_abs_start: int, n_epochs: int):
        """Track `n_epochs` epochs of the samples `x` (absolute start index
        `x_abs_start`) on the per-epoch kernels: process_begin +
        process_end, every epoch's planes (the full set with full_outputs,
        else the lean one)."""
        return self.process_end(self.process_begin(x, x_abs_start,
                                                   n_epochs))

    def process_begin(self, x, x_abs_start: int, n_epochs: int,
                      decim: int | None = None, use_blocks: bool = False):
        """Dispatch the chunk's device work and start its copy to the host;
        returns an opaque handle for process_end.

        Two transfer formats, as the JAX engine's: with `decim` > 1 and
        full_outputs off, the rate-split one (int8 prompt symbols per epoch
        + the observable planes every decim-th epoch; the block kernel may
        run the chunk, `use_blocks`); else every epoch's planes
        (:func:`pack_full`).

        `x` is the capture (a device tensor, sliced in place, or a NumPy
        array, uploaded per chunk) with absolute start index x_abs_start."""
        decimated = (decim is not None and decim > 1
                     and not self.full_outputs)
        active = self.active_host
        if not active.any():
            raise RuntimeError("no active channels")
        rel = self.abs_start - x_abs_start
        if (rel[active] < 0).any():
            raise ValueError("sample array starts after a channel position")
        if int(rel.max()) + n_epochs * (self.conf.nominal_epoch_samples + 2) \
                >= 2 ** 31:
            raise ValueError(
                "chunk-relative position would overflow int32; feed the "
                "engine a windowed sample array with a larger x_abs_start")
        from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
        use_blk = use_blocks and decimated and self.block_mode_ok(n_epochs)
        blk_extra = tb.block_fft_size(self.conf) + 256 if use_blk else 0
        need0 = int(rel[active].max()) + n_epochs * (
            self.conf.nominal_epoch_samples + 2) + self.conf.block_size
        if use_blk and len(x) < need0 + blk_extra:
            # a tight tail runs on the per-epoch kernel instead of feeding
            # the block kernel clamped (= shifted) samples
            use_blk = False
            blk_extra = 0
        need = need0 + blk_extra
        if len(x) < need:
            raise ValueError(f"need >= {need} samples, got {len(x)}")
        # cut the capture down to what this chunk reads: the window FFT of
        # the block kernel covers exactly this slice (a view, no copy).
        # Inactive channels are parked on their own positions, so ALL rel
        # rebase onto the window start and inactive ones mask to 0.
        rmin = int(rel[active].min())
        span = need - rmin + 384
        win_len = max(1 << (span - 1).bit_length(), 1 << 18)
        if len(x) > 2 * win_len:
            start0 = max(0, min(rmin - 256, len(x) - win_len))
            x = x[start0:start0 + win_len]
            x_abs_start = x_abs_start + start0
            rel = np.where(active, rel - start0, 0)
        rel_dev = upload(rel.astype(np.int32), self.device)
        if self._chain_base is None:
            state = self.state._replace(pos=rel_dev)
        else:
            # exact device-side rebase from the previous window base; only
            # channels (re)armed since the last dispatch take the host value
            pos_dev = self.state.pos + int(self._chain_base - x_abs_start)
            if self._armed_since:
                mask = np.zeros(self.n_channels, bool)
                mask[list(self._armed_since)] = True
                pos_dev = torch.where(upload(mask, self.device), rel_dev,
                                      pos_dev)
            state = self.state._replace(pos=pos_dev)
        self._armed_since.clear()
        if isinstance(x, np.ndarray):
            x = upload(x.astype(np.complex64, copy=False), self.device)
        x_dev = x.to(self.device)
        if use_blk:
            self._ensure_block_tables()
            e_blk = self.block_epochs
            new_state, buf = tb.track_chunk_blocks_packed_decim(
                self.conf, n_epochs // e_blk, e_blk, int(decim),
                self._codes_rep, self.taps, x_dev, state,
                sec_code=self._sec_code, data_codes_rep=self._data_rep)
        elif decimated:
            new_state, buf = track_chunk_packed_decim(
                self.conf, int(n_epochs), int(decim), self.codes,
                self.taps, x_dev, state, self.data_codes)
        else:
            new_state, buf = track_chunk_packed(
                self.conf, int(n_epochs), self.codes, self.taps, x_dev,
                state, self.full_outputs, self.data_codes)
        meta = self._chain_dispatch(new_state, x_abs_start, n_epochs)
        if decimated:
            return ("decim", _start_pull(buf), int(x_abs_start),
                    int(n_epochs), int(decim), meta)
        return ("full", _start_pull(buf), int(x_abs_start), int(n_epochs),
                bool(self.full_outputs), meta)

    def _chain_dispatch(self, new_state, x_abs_start: int,
                        n_epochs: int) -> dict:
        """Advance the engine to the just-dispatched chunk: state becomes
        the post-chunk device state; abs_start advances by a code-frequency
        prediction (made exact later by the pull)."""
        self.state = new_state            # pos stays window-relative
        self._chain_base = int(x_abs_start)
        self._dispatch_seq += 1
        self.epochs_dispatched += n_epochs
        act = self.active_host
        s_per = (self.conf.fs * self.conf.code_length_chips
                 / self._code_freq_host)
        self._abs_f = np.where(act, self._abs_f + n_epochs * s_per,
                               self._abs_f)
        self.abs_start = np.round(self._abs_f).astype(np.int64)
        return {"seq": self._dispatch_seq, "pred_end": self._abs_f.copy()}

    def process_end(self, handle):
        """Materialize a process_begin handle: ONE device -> host pull,
        then host-side unpacking (identical to the JAX engine's)."""
        if handle[0] == "decim":
            return self._process_end_decim(handle)
        _, pull, x_abs_start, n_epochs, full, meta = handle
        t, c = int(n_epochs), self.n_channels
        raw = _finish_pull(pull)                           # flat int32
        keys = _PACK_F32_FULL if full else _PACK_F32_LEAN
        nf = len(keys)
        fbuf = raw[: nf * t * c].view(np.float32).reshape(nf, t, c)
        ibuf = raw[nf * t * c:]
        outs = {k: fbuf[i] for i, k in enumerate(keys)}
        im = outs.pop("prompt_im") if full else 0.0
        outs["prompt"] = (outs.pop("prompt_re") + 1j * im
                          ).astype(np.complex64)
        outs["valid"] = outs["valid"] > 0.5
        pos_start = ibuf[: t * c].reshape(t, c).astype(np.int64)
        n_samples = ibuf[t * c: 2 * t * c].reshape(t, c).astype(np.int64)
        new_pos = ibuf[2 * t * c: 2 * t * c + c].astype(np.int64)
        # channels (re)armed AFTER this chunk's dispatch: the pulled flags
        # describe the channel's previous life — keep the host's values
        _stale = self._armed_seq >= meta["seq"]
        self.active_host = np.where(
            _stale, self.active_host,
            ibuf[2 * t * c + c: 2 * t * c + 2 * c] > 0)
        self.lock_lost_host = np.where(
            _stale, self.lock_lost_host, ibuf[2 * t * c + 2 * c:] > 0)
        outs["pos_start"] = pos_start
        outs["n_samples"] = n_samples
        outs["sample_counter"] = pos_start + x_abs_start + n_samples
        outs["stale_channels"] = _stale
        self._apply_pull(meta, new_pos + x_abs_start,
                         outs["carrier_doppler_hz"][-1])
        return outs

    def _process_end_decim(self, handle):
        """Materialize a decimated handle: ONE pull, then host-side
        unpacking."""
        _, pull, x_abs_start, n_epochs, decim, meta = handle
        t, c = int(n_epochs), self.n_channels
        rows = np.arange(decim - 1, t, decim)
        td = len(rows)
        raw = _finish_pull(pull)                           # flat int32
        n_sym_words = (t * c + 3) // 4
        sym = raw[:n_sym_words].view(np.int8)[: t * c].reshape(t, c)
        raw = raw[n_sym_words:]
        nf = len(_DECIM_F32)
        fbuf = raw[: nf * td * c].view(np.float32).reshape(nf, td, c)
        ibuf = raw[nf * td * c:]
        sc = ibuf[: td * c].reshape(td, c).astype(np.int64)
        new_pos = ibuf[td * c: td * c + c].astype(np.int64)
        # channels (re)armed AFTER this chunk's dispatch: the pulled flags
        # describe the channel's previous life — keep the host's values
        _stale = self._armed_seq >= meta["seq"]
        self.active_host = np.where(
            _stale, self.active_host, ibuf[td * c + c: td * c + 2 * c] > 0)
        self.lock_lost_host = np.where(
            _stale, self.lock_lost_host,
            ibuf[td * c + 2 * c: td * c + 3 * c] > 0)
        scale = ibuf[td * c + 3 * c:].view(np.float32)
        outs = {k: fbuf[i] for i, k in enumerate(_DECIM_F32)}
        valid_full = sym != np.int8(-128)
        outs["prompt"] = np.where(valid_full, sym, 0).astype(
            np.float32) * scale[None, :]
        outs["symbols_i8"] = sym
        outs["sym_scale"] = scale
        outs["valid_full"] = valid_full                    # [T, C]
        outs["valid"] = valid_full[rows]                   # [Td, C]
        outs["rows"] = rows
        outs["sample_counter"] = sc + x_abs_start
        outs["stale_channels"] = _stale
        self._apply_pull(meta, new_pos + x_abs_start,
                         outs["carrier_doppler_hz"][-1] if td else None)
        return outs

    def _apply_pull(self, meta: dict, exact_end: np.ndarray,
                    last_doppler) -> None:
        """Fold one chunk's pulled exact end positions back into the
        prediction chain and refresh the code-frequency mirror."""
        ok = self.active_host & (self._armed_seq < meta["seq"])
        err = np.where(ok, exact_end.astype(np.float64)
                       - meta["pred_end"], 0.0)
        self._abs_f = self._abs_f + err
        self.abs_start = np.round(self._abs_f).astype(np.int64)
        if last_doppler is not None:
            dop = np.asarray(last_doppler, np.float64)
            fresh = ok & np.isfinite(dop)
            self._code_freq_host = np.where(
                fresh,
                self.conf.code_rate_cps
                * (1.0 + (dop - self.conf.doppler_bias_hz)
                   / self.conf.carrier_freq_hz),
                self._code_freq_host)
