"""Batched DLL/PLL tracking engine, PyTorch port of
``gnss_sim_receiver_tpu.models.tracking`` (``dll_pll`` mode: GPS L1 C/A with
3 taps, Galileo E1-B data with 5 VEML taps).

All channels advance one code epoch per step over a shared sample chunk;
the per-channel sample pointer and the fractional code/carrier remnants are
the carried :class:`TrackState`.  The per-epoch correlation is kernel K2
(:func:`ops.correlator.multicorrelate`); the loop closure runs as torch ops
on [C] tensors, in a Python loop over the epochs of a chunk.

The host-side :class:`TrackingEngine` keeps absolute sample bookkeeping
(int64) and the acquisition -> tracking handoff, and hands every chunk to
the device in the same packed transfer layout as the JAX engine, so the
host unpacking is identical.

Arithmetic follows the JAX code operation by operation in float32 (scalar
constants are float32 where the JAX code makes them float32), so the two
agree to rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import resolve_device, upload
from gnss_sim_receiver_tpu_torch.ops import cn0 as cn0_ops
from gnss_sim_receiver_tpu_torch.ops import discriminators
from gnss_sim_receiver_tpu_torch.ops import loop_filters as lf
from gnss_sim_receiver_tpu_torch.ops import prn_codes
from gnss_sim_receiver_tpu_torch.ops.correlator import multicorrelate

N_SEC_MAX = 32   # longest supported secondary code (TrackState layout)

F32 = torch.float32
I32 = torch.int32


def f32(v) -> torch.Tensor:
    """A 0-d float32 CPU tensor: the port's form of the JAX code's
    ``jnp.float32(v)`` scalars, so arithmetic with it rounds in float32."""
    return torch.tensor(v, dtype=F32)


@dataclasses.dataclass(frozen=True)
class TrackingConf:
    """Reference Dll_Pll_Conf subset (tracking/libs/dll_pll_conf.h:42-80),
    the fields of the dll_pll GPS L1 C/A and Galileo E1-B data chains.
    Rates and lengths are in sub-chips for BOC signals (E1: 2.046e6 and
    8184)."""
    fs: float = 2_000_000.0
    code_rate_cps: float = constants.GPS_L1_CA_CODE_RATE_CPS
    code_length_chips: int = constants.GPS_L1_CA_CODE_LENGTH_CHIPS
    carrier_freq_hz: float = constants.GPS_L1_FREQ_HZ
    pll_bw_hz: float = 35.0         # third-order PLL
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
    cn0_min_db_hz: float = 25.0
    carrier_lock_threshold: float = 0.75
    max_lock_fail: int = 50
    # the block kernel closes its loops at block cadence with these
    pll_bw_narrow_hz: float = 15.0
    dll_bw_narrow_hz: float = 0.5
    bit_sync_min_transitions: int = 16

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
    the JAX TrackState; the kf_*, ext_*, sec_* and bayes_* fields are
    carried for layout parity and unused by dll_pll tracking)."""
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
    ext_n: torch.Tensor             # [C] int32 (block kernel: blocks run)
    sec_buf: torch.Tensor           # [C, N_SEC_MAX] recent prompt-I signs
    sec_synced: torch.Tensor        # [C] bool
    sec_off: torch.Tensor           # [C] int32
    sec_polarity: torch.Tensor      # [C] +-1
    bayes_nu: torch.Tensor          # [C] float32
    bayes_psi_code: torch.Tensor    # [C] float32
    bayes_psi_carr: torch.Tensor    # [C] float32


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


def code_rate_from_doppler(conf: TrackingConf, doppler) -> torch.Tensor:
    """Carrier-aided code rate (float32): rate * (1 + dop/fc)."""
    return (f32(conf.code_rate_cps)
            * (1.0 + doppler / f32(conf.carrier_freq_hz)))


def _dll_pll_update(conf: TrackingConf, state: TrackState, prompt,
                    carr_err_cyc, code_err_chips, t_int):
    """Classic loop closure (run_dll_pll :1065-1152): FLL-assisted PLL +
    carrier-aided DLL."""
    wn = f32(conf.pll_bw_hz / 0.7845)            # third-order PLL
    pll_acc = state.pll.acc + wn * wn * wn * t_int * carr_err_cyc
    pll_vel = state.pll.vel + t_int * (pll_acc
                                       + 1.1 * wn * wn * carr_err_cyc)
    out_gain = 2.4 * wn
    # FLL assist during pull-in (run_dll_pll :1080-1099)
    if conf.enable_fll_pullin:
        fll_fn = (discriminators.fll_cross_dot_decision
                  if conf.fll_decision_directed
                  else discriminators.fll_cross_dot)
        freq_err = fll_fn(state.prompt_prev, prompt, t_int)
        in_pullin = (state.epoch > 0) & (state.epoch < conf.fll_pullin_epochs)
        pll_vel = torch.where(
            in_pullin,
            pll_vel + 4.0 * f32(conf.fll_bw_hz) * t_int * freq_err,
            pll_vel)
    pll_new = lf.LoopFilterState(vel=pll_vel, acc=pll_acc)
    carrier_doppler = pll_vel + out_gain * carr_err_cyc
    # DLL with carrier aiding (:1126-1129)
    dll_new, dll_out = lf.second_order_step(
        state.dll, code_err_chips, f32(conf.dll_bw_hz), t_int)
    code_freq = code_rate_from_doppler(conf, carrier_doppler) + dll_out
    return carrier_doppler, code_freq, pll_new, dll_new


def _epoch_step(conf: TrackingConf, codes: torch.Tensor, taps: torch.Tensor,
                x_chunk: torch.Tensor, state: TrackState):
    """Advance every channel by one code epoch. Returns (state', outputs)."""
    fs = conf.fs
    code_len = f32(conf.code_length_chips)

    # --- epoch length from the current code NCO (update_tracking_vars) ----
    n_c = torch.round((code_len - state.rem_code_phase)
                      / state.code_freq * fs).to(I32)
    n_c = torch.clamp(n_c, 1, conf.block_size)
    t_int = n_c.to(F32) / f32(fs)

    # --- correlate (do_correlation_step :1037): kernel K2 ----------------
    k_ovs = codes.shape[1] // conf.code_length_chips
    corr = multicorrelate(x_chunk, state.pos, conf.block_size, codes, taps,
                          state.rem_code_phase, state.code_freq,
                          state.rem_carr_phase, state.carrier_doppler, n_c,
                          fs, table_oversample=k_ovs)
    veml = conf.very_early_late_space_chips > 0.0
    if veml:   # taps = [VE, E, P, L, VL]
        v_early, early, prompt, late, v_late = corr.unbind(1)
    else:
        early, prompt, late = corr.unbind(1)

    # --- loop closure (run_dll_pll :1065) ---------------------------------
    carr_err_cyc = discriminators.pll_costas(prompt) / (2.0 * math.pi)
    if veml:
        code_err_chips = discriminators.dll_nc_vemlp_normalized(
            torch.abs(v_early), torch.abs(early), torch.abs(late),
            torch.abs(v_late), f32(conf.early_late_space_chips))
    else:
        code_err_chips = discriminators.dll_nc_e_minus_l_normalized(
            torch.abs(early), torch.abs(late),
            f32(conf.early_late_space_chips))
    carrier_doppler, code_freq, pll_new, dll_new = _dll_pll_update(
        conf, state, prompt, carr_err_cyc, code_err_chips, t_int)

    # --- NCO phase carry with the frequencies USED this epoch -------------
    rem_code = state.rem_code_phase + state.code_freq * t_int - code_len
    carr_adv_cycles = state.carrier_doppler * t_int
    rem_carr = torch.remainder(
        state.rem_carr_phase + 2.0 * math.pi * carr_adv_cycles,
        2.0 * math.pi)
    # Kahan accumulation of total carrier cycles (not re-associated)
    y = carr_adv_cycles - state.acc_phase_comp
    t_sum = state.acc_phase_cycles + y
    comp = (t_sum - state.acc_phase_cycles) - y
    pos_next = state.pos + n_c

    # --- C/N0 + lock detection every cn0_window epochs (:972-1035) --------
    acc = cn0_ops.accumulate(state.cn0_acc, prompt)
    window_done = torch.remainder(state.epoch + 1,
                                  conf.cn0_window_epochs) == 0
    cn0_new = cn0_ops.cn0_m2m4_estimate(acc, t_int)
    lock_new = (0.75 * state.carrier_lock
                + 0.25 * cn0_ops.carrier_lock_value(acc))
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
        prompt_prev=sel(prompt, state.prompt_prev),
        epoch=torch.where(act, state.epoch + 1, state.epoch),
        cn0_acc=cn0_ops.Cn0AccumState(*map(sel, acc, state.cn0_acc)),
        cn0_db_hz=sel(cn0_db, state.cn0_db_hz),
        carrier_lock=sel(carrier_lock, state.carrier_lock),
        lock_fail=sel(fail, state.lock_fail),
        lock_lost=sel(lost, state.lock_lost),
    )
    outputs = {
        "prompt": prompt,
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
    }
    return new_state, outputs


def track_chunk(conf: TrackingConf, n_epochs: int, codes: torch.Tensor,
                taps: torch.Tensor, x_chunk: torch.Tensor,
                state: TrackState):
    """Run `n_epochs` code epochs of every channel over one sample chunk.
    Returns (new_state, outputs) with [T, C] output planes."""
    outs = []
    for _ in range(n_epochs):
        state, o = _epoch_step(conf, codes, taps, x_chunk, state)
        outs.append(o)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


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
                             x_chunk: torch.Tensor, state: TrackState):
    """track_chunk with the device -> host transfer cut to what the host
    pipeline consumes: (new_state, buf int32), see :func:`pack_decim`."""
    new_state, outs = track_chunk(conf, n_epochs, codes, taps, x_chunk,
                                  state)
    return new_state, pack_decim(outs, new_state, n_epochs, decim)


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
                 device=None):
        """code_provider(prn) -> +-1 sub-chip table of length
        conf.code_length_chips (default: GPS L1 C/A); for BOC signals the
        sub-chip expansion (signals.subchip_table), conf rates in
        sub-chip units."""
        self.conf = conf
        self.device = resolve_device(device)
        self.code_provider = code_provider or prn_codes.gps_l1_ca_code
        self.prns = [int(p) for p in prns]
        self.n_channels = len(self.prns)
        # band-limited sub-chip replica tables: both kernels (per-epoch
        # gather and block FFT) correlate against the SAME filtered
        # waveform, so amplitudes and lock points agree across handoffs
        self.table_oversample = 8
        self._codes_host = np.stack([self._replica_table(p)
                                     for p in self.prns])
        self.codes = torch.from_numpy(self._codes_host).to(self.device)
        d = conf.early_late_space_chips
        dv = conf.very_early_late_space_chips
        if dv > 0.0:   # 5-tap VEML (reference very-early spacing, e.g. E1)
            tap_list = [+dv, +d / 2, 0.0, -d / 2, -dv]
        else:
            tap_list = [+d / 2, 0.0, -d / 2]
        self.taps = torch.from_numpy(np.array(tap_list, np.float32)).to(
            self.device)
        self.state = _init_state(self.n_channels, self.device)
        self.abs_start = np.zeros(self.n_channels, np.int64)
        # --- chunk chaining / pipelining state (see process_begin) --------
        self._chain_base = None
        self._armed_since: set = set()
        self._armed_seq = np.full(self.n_channels, -1, np.int64)
        self._abs_f = np.zeros(self.n_channels, np.float64)
        self._code_freq_host = np.full(self.n_channels,
                                       conf.code_rate_cps, np.float64)
        self._dispatch_seq = 0
        # host mirrors of the state flags, refreshed from the packed pull
        self.active_host = np.zeros(self.n_channels, bool)
        self.lock_lost_host = np.zeros(self.n_channels, bool)
        self._codes_rep = None          # block-kernel replica, built lazily

    def _replica_table(self, prn: int) -> np.ndarray:
        if prn <= 0:
            return np.zeros(
                self.conf.code_length_chips * self.table_oversample,
                np.float32)
        return prn_codes.bandlimited_table_normalized(
            np.asarray(self.code_provider(prn), np.float32), self.conf.fs,
            self.conf.code_rate_cps, self.conf.nominal_epoch_samples,
            self.table_oversample)

    def set_channel_prn(self, ch: int, prn: int) -> None:
        """Re-point a channel at a different satellite (swaps its code-table
        row; the tensor is replaced, never written in place, so a chunk
        still in flight keeps the table it was dispatched with)."""
        self.prns[ch] = int(prn)
        self._codes_host = self._codes_host.copy()
        self._codes_host[ch] = self._replica_table(int(prn))
        self.codes = torch.from_numpy(self._codes_host).to(self.device)
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
                      * (1.0 + doppler_hz / self.conf.carrier_freq_hz))
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
        """Samples a chunk may read past its last epoch: the larger of the
        per-epoch block and the block kernel's window (+ guards)."""
        from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
        return max(self.conf.block_size + 64,
                   tb.block_fft_size(self.conf) + 256 + 64)

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
        """Whether this chunk can run on the block kernel."""
        return (n_epochs % self.block_epochs == 0
                and n_epochs >= 2 * self.block_epochs)

    def _ensure_block_tables(self):
        from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
        if self._codes_rep is None:
            self._codes_rep = tb.code_spectra(self.conf, self._codes_host,
                                              device=self.device)

    def process_begin(self, x, x_abs_start: int, n_epochs: int,
                      decim: int, use_blocks: bool = False):
        """Dispatch the chunk's device work; returns an opaque handle for
        process_end.  The transfer is the rate-split format: int8 prompt
        symbols per epoch + the observable planes every decim-th epoch.

        `x` is the capture (a device tensor, sliced in place, or a NumPy
        array, uploaded per chunk) with absolute start index x_abs_start."""
        if decim is None or decim <= 1:
            raise NotImplementedError(
                "the port carries the decimated transfer only (decim > 1)")
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
        use_blk = use_blocks and self.block_mode_ok(n_epochs)
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
                self._codes_rep, self.taps, x_dev, state)
        else:
            new_state, buf = track_chunk_packed_decim(
                self.conf, int(n_epochs), int(decim), self.codes,
                self.taps, x_dev, state)
        meta = self._chain_dispatch(new_state, x_abs_start, n_epochs)
        return (new_state, buf, int(x_abs_start), int(n_epochs), int(decim),
                meta)

    def _chain_dispatch(self, new_state, x_abs_start: int,
                        n_epochs: int) -> dict:
        """Advance the engine to the just-dispatched chunk: state becomes
        the post-chunk device state; abs_start advances by a code-frequency
        prediction (made exact later by the pull)."""
        self.state = new_state            # pos stays window-relative
        self._chain_base = int(x_abs_start)
        self._dispatch_seq += 1
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
        _, buf, x_abs_start, n_epochs, decim, meta = handle
        t, c = int(n_epochs), self.n_channels
        rows = np.arange(decim - 1, t, decim)
        td = len(rows)
        raw = buf.cpu().numpy()                            # flat int32
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
                * (1.0 + dop / self.conf.carrier_freq_hz),
                self._code_freq_host)
