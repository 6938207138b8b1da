"""Observables formation: common receiver clock, interpolation,
pseudoranges, optional carrier smoothing.

Host-side (float64) equivalent of the reference hybrid_observables_gs
(src/algorithms/observables/gnuradio_blocks/hybrid_observables_gs.cc):
  - receiver clock ticks every `interval_ms` of sample time (the role of
    gnss_sdr_sample_counter, wired in gnss_flowgraph.cc:836-863);
  - per channel, linear interpolation of TOW / carrier phase / Doppler to
    the tick (interp_trk_obs, :387-482), using the exact fractional
    code-boundary timestamps (compute_T_rx_s, :380);
  - common receiver TOW: first set to max decoded TOW rounded UP to the
    interval, then advanced by the interval each tick (update_TOW,
    :496-534, incl. week rollover);
  - rho = (T_rx - TOW_tx) * c with the 302400 ms travel-time guard
    (compute_pranges, :537-570);
  - optional Hatch carrier-smoothing filter (smooth_pseudoranges,
    :573-601).

Pseudorange formation is float64 bookkeeping at 50 Hz — host work; the
device produces the per-epoch timestamps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants

_C_MS = constants.SPEED_OF_LIGHT_M_S / 1000.0


@dataclasses.dataclass
class ObsConf:
    fs: float = 2_000_000.0
    interval_ms: int = 20
    smoothing_factor: int = 0      # Hatch filter length M; 0 disables
    carrier_wavelength_m: float = (constants.SPEED_OF_LIGHT_M_S
                                   / constants.GPS_L1_FREQ_HZ)
    # must cover at least one receiver chunk of epochs, or ticks older than
    # the retained window silently fail to interpolate
    history_len: int = 1200
    # hybrid pseudolite channel (GNSS-SDR.pseudo_sat_ch_id): its transmit
    # clock is not GNSS-synchronized, so the week-rollover travel-time fix
    # must NOT be applied to it (hybrid_observables_gs.cc:550-556)
    ps_channel: int = -1


@dataclasses.dataclass
class ObservationEpoch:
    """One synchronized observable set (the vector handed to PVT)."""
    rx_time_s: float                  # common receiver TOW [s]
    tick_sample: int                  # receiver sample counter of the tick
    valid: np.ndarray                 # [C] bool
    pseudorange_m: np.ndarray         # [C] float64
    interp_tow_ms: np.ndarray         # [C] float64
    carrier_doppler_hz: np.ndarray    # [C] float64
    carrier_phase_cycles: np.ndarray  # [C] float64
    cn0_db_hz: np.ndarray             # [C] float64


_HIST_KEYS = ("t", "tow", "dop", "ph", "cn0")


class ObservablesEngine:
    def __init__(self, conf: ObsConf, n_channels: int,
                 carrier_freq_hz=None, fs_per_channel=None):
        self.conf = conf
        self.n = n_channels
        # per-channel sampling rate: multi-band front ends run each
        # chain's tracker at its own fs (Channels_<sig>.RF_channel_ID);
        # sample counters convert to TIME with the channel's own rate
        # (the reference's Gnss_Synchro carries fs per channel)
        self._fs = (np.asarray(fs_per_channel, np.float64)
                    if fs_per_channel is not None
                    else np.full(n_channels, conf.fs))
        # per-channel carrier wavelength for Hatch smoothing: the reference
        # smooths with each signal's own wavelength; a single global L1
        # lambda mis-aids L5/E5/E6/B3 channels
        if carrier_freq_hz is not None:
            self._lam = (constants.SPEED_OF_LIGHT_M_S
                         / np.asarray(carrier_freq_hz, np.float64))
        else:
            self._lam = np.full(n_channels, conf.carrier_wavelength_m)
        self.tick_step = int(round(conf.fs * conf.interval_ms / 1000.0))
        self.next_tick = self.tick_step
        self.t_rx_tow_ms: float | None = None
        # GnssTime stream tags (File_Timestamp_Signal_Source role,
        # gnss_sdr_timestamp.cc -> dll_pll_veml_tracking.cc:2031-2059 /
        # hybrid_observables_gs.cc:672-695): when set, the common rx
        # clock anchors to the capture's ABSOLUTE time instead of the
        # decoded-TOW heuristic
        self._tag_samples = None
        self._tag_tow_ms = None
        self.week: int | None = None
        # per-channel epoch history: numpy arrays, bulk-appended per chunk
        self.hist = [{k: np.empty(0) for k in _HIST_KEYS}
                     for _ in range(n_channels)]
        # Hatch filter state
        self._sm_last_pr = np.zeros(n_channels)
        self._sm_last_ph = np.zeros(n_channels)
        self._sm_lock = np.zeros(n_channels, bool)

    def set_time_tags(self, samplecounts, tow_ms, week=None) -> None:
        """Attach GnssTime tags: absolute (week, tow) at given capture
        sample counters."""
        self._tag_samples = np.asarray(samplecounts, np.float64)
        self._tag_tow_ms = np.asarray(tow_ms, np.float64)
        if week is not None:
            self.week = int(week)

    def reset_channel(self, c: int) -> None:
        """Clear a channel's history (satellite reassignment)."""
        self.hist[c] = {k: np.empty(0) for k in _HIST_KEYS}
        self._sm_lock[c] = False

    def push_epochs(self, track_outs: dict, tlm_outs,
                    channel_offset: int = 0) -> None:
        """Append a batch of per-epoch records ([T, C] arrays from tracking
        + telemetry).  `channel_offset` maps a signal chain's local channel
        axis into this engine's global channel space (the reference wires
        every per-signal channel group into the one hybrid_observables
        block the same way).  Batched NumPy throughout — no per-epoch
        Python work."""
        sc = np.asarray(track_outs["sample_counter"], np.float64)
        cps = np.asarray(track_outs["code_phase_samples"], np.float64)
        n_cols = sc.shape[1]
        fs_cols = self._fs[channel_offset:channel_offset + n_cols]
        t_all = (sc - cps) / fs_cols[None, :]
        ph = np.asarray(track_outs["acc_phase_cycles"], np.float64)
        # half-cycle correction when the PLL is known to be locked 180 deg
        # off (telemetry frame sync matched an inverted preamble) — the
        # reference's Flag_PLL_180_deg_phase_locked + GPS_PI correction
        half = getattr(tlm_outs, "phase_half_cycles", None)
        if half is not None:
            ph = ph + np.asarray(half, np.float64)[None, :]
        cols = dict(
            t=t_all,
            tow=np.asarray(tlm_outs.tow_at_epoch_ms, np.float64),
            dop=np.asarray(track_outs["carrier_doppler_hz"], np.float64),
            ph=ph,
            cn0=np.asarray(track_outs["cn0_db_hz"], np.float64))
        valid = np.asarray(track_outs["valid"], bool) & tlm_outs.tow_valid
        keep = self.conf.history_len
        for c in range(valid.shape[1]):
            m = valid[:, c]
            if not m.any():
                continue
            h = self.hist[channel_offset + c]
            for k in _HIST_KEYS:
                arr = np.concatenate([h[k], cols[k][m, c]])
                h[k] = arr[-keep:] if len(arr) > keep else arr

    def pull_ticks(self, up_to_sample: int) -> list[ObservationEpoch]:
        """Emit every complete observable epoch with tick sample <=
        up_to_sample (call after push_epochs).  The common receiver clock
        advances by the interval on EVERY tick once set — whether or not an
        epoch forms — exactly like the reference's sample-counter-driven
        update_TOW (hybrid_observables_gs.cc:496-534).

        Interpolation of every (tick, channel) pair is vectorized
        (searchsorted over the whole tick batch per channel); only the
        sequential receiver-clock bookkeeping runs per tick."""
        n_ticks = max(int((up_to_sample - 2 * self.tick_step
                           - self.next_tick) // self.tick_step) + 1, 0)
        if n_ticks == 0:
            return []
        ticks = self.next_tick + self.tick_step * np.arange(n_ticks)
        self.next_tick = int(ticks[-1]) + self.tick_step
        itow, idop, iph, icn0, ivalid = self._interp_all(
            ticks / self.conf.fs)
        out = []
        for k in range(n_ticks):
            if self.t_rx_tow_ms is not None:
                self.t_rx_tow_ms += float(self.conf.interval_ms)
                if self.t_rx_tow_ms >= constants.GPS_TOW_MAX_MS:
                    self.t_rx_tow_ms %= constants.GPS_TOW_MAX_MS
            epoch = self._form_epoch(int(ticks[k]), ivalid[:, k],
                                     itow[:, k], idop[:, k], iph[:, k],
                                     icn0[:, k])
            if epoch is not None:
                out.append(epoch)
        return out

    # -- internals ----------------------------------------------------------
    def _interp_all(self, t_rx_s: np.ndarray):
        """Linear interpolation of every channel's history to every tick
        time (interp_trk_obs, hybrid_observables_gs.cc:387-482), batched
        over ticks: returns [C, K] arrays (tow, dop, ph, cn0, valid)."""
        k = len(t_rx_s)
        tow = np.full((self.n, k), np.nan)
        dop = np.zeros((self.n, k))
        ph = np.zeros((self.n, k))
        cn0 = np.zeros((self.n, k))
        valid = np.zeros((self.n, k), bool)
        for c in range(self.n):
            h = self.hist[c]
            t = h["t"]
            if len(t) < 2:
                continue
            i = np.searchsorted(t, t_rx_s)
            ok = (i > 0) & (i < len(t))
            ii = np.clip(i, 1, len(t) - 1)
            t1, t2 = t[ii - 1], t[ii]
            ok &= (t1 <= t_rx_s) & (t_rx_s <= t2) & ((t2 - t1) <= 0.1)
            f = (t_rx_s - t1) / np.maximum(t2 - t1, 1e-12)
            dtow = h["tow"][ii] - h["tow"][ii - 1]
            # week rollover (hybrid_observables_gs.cc:453-461)
            dtow = np.where(dtow <= 0, dtow + constants.GPS_TOW_MAX_MS,
                            dtow)
            tow[c] = h["tow"][ii - 1] + dtow * f
            dop[c] = h["dop"][ii - 1] + (h["dop"][ii] - h["dop"][ii - 1]) * f
            ph[c] = h["ph"][ii - 1] + (h["ph"][ii] - h["ph"][ii - 1]) * f
            cn0[c] = h["cn0"][ii]
            valid[c] = ok
        return tow, dop, ph, cn0, valid

    def _form_epoch(self, tick_sample: int, valid, tow, dop, ph, cn0):
        valid = valid.copy()
        tow = np.where(valid, tow, np.nan)
        dop = np.where(valid, dop, 0.0)
        ph = np.where(valid, ph, 0.0)
        cn0 = np.where(valid, cn0, 0.0)
        if not valid.any():
            return None
        if not valid.any():
            return None
        # first-fix receiver TOW initialization (update_TOW); afterwards the
        # clock is advanced per tick in pull_ticks.  The pseudolite channel's
        # transmit clock is NOT GNSS-synchronized, so it must never seed the
        # common receiver time (hybrid_observables_gs.cc:496-556 excludes the
        # ps channel from receiver-time logic).
        step = float(self.conf.interval_ms)
        gnss_valid = valid.copy()
        if 0 <= self.conf.ps_channel < self.n:
            gnss_valid[self.conf.ps_channel] = False
        if self.t_rx_tow_ms is None and self._tag_samples is not None:
            # absolute-time anchor from the capture's GnssTime tags:
            # nearest preceding tag + sample-clock extrapolation (ticks
            # routinely fall beyond the last tag)
            ts, tw = self._tag_samples, self._tag_tow_ms
            i = int(np.clip(np.searchsorted(ts, float(tick_sample)) - 1,
                            0, len(ts) - 1))
            self.t_rx_tow_ms = float(
                tw[i] + (float(tick_sample) - ts[i])
                / self.conf.fs * 1000.0)
        if self.t_rx_tow_ms is None:
            if not gnss_valid.any():
                return None   # cannot anchor rx time to a ps-only epoch
            ref = float(np.nanmax(tow[gnss_valid]))
            self.t_rx_tow_ms = np.ceil(ref / step) * step
        # pseudoranges (compute_pranges)
        travel_ms = self.t_rx_tow_ms - tow
        wrap = np.abs(travel_ms) > 302_400
        if 0 <= self.conf.ps_channel < self.n:
            wrap[self.conf.ps_channel] = False
        travel_ms = np.where(wrap, travel_ms + constants.GPS_TOW_MAX_MS,
                             travel_ms)
        pr = travel_ms * _C_MS
        # optional Hatch smoothing (smooth_pseudoranges)
        m = self.conf.smoothing_factor
        if m > 1:
            for c in range(self.n):
                if not valid[c]:
                    self._sm_lock[c] = False
                    continue
                if self._sm_lock[c]:
                    f = (m - 1.0) / m
                    lam = self._lam[c]
                    pr[c] = (f * self._sm_last_pr[c] + pr[c] / m
                             + lam * f * (ph[c] - self._sm_last_ph[c]))
                self._sm_last_pr[c] = pr[c]
                self._sm_last_ph[c] = ph[c]
                self._sm_lock[c] = True
        return ObservationEpoch(
            rx_time_s=self.t_rx_tow_ms / 1000.0, tick_sample=tick_sample,
            valid=valid, pseudorange_m=np.where(valid, pr, 0.0),
            interp_tow_ms=tow, carrier_doppler_hz=dop,
            carrier_phase_cycles=ph, cn0_db_hz=cn0)
