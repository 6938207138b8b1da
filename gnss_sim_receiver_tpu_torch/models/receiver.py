"""Receiver orchestration, PyTorch port of
``gnss_sim_receiver_tpu.models.receiver`` for the GPS L1 C/A ("1C"),
Galileo E1-B ("1B"), GPS L2C CM ("2S"), GPS L5I ("L5"), Galileo E5a-I
("5X"), Galileo E5b-I ("7X"), Galileo E6-B ("E6"), GLONASS L1 and L2 C/A
("1G", "2G", one chain per FDMA slot), BeiDou B1I ("B1"), BeiDou B3I
("B3") and SBAS L1 ("S1") signal chains, the batch entry point and the
live session.

The receiver runs one *signal chain* per configured signal — the
reference's per-signal channel groups (Channels_1C.count /
Channels_1B.count, gnss_flowgraph.cc set_signals_list) — each with its own
acquisition grid, tracking engine and telemetry decoder, each on the
stream of its RF channel at that channel's rate (the multi-band front end,
Channels_<sig>.RF_channel_ID), all feeding one observables engine and one
PVT solver.  A chain on a secondary band of its system acquires around the
primary band's Doppler (Doppler-assisted acquisition); a chain with
acq_decim > 1 acquires on a mean-pooled stream (the acquisition-only
resampler).

Host-side orchestration of every chain — acquisition scheduling with
re-acquisition and satellite rotation, acquisition -> tracking handoff,
chunked tracking over the capture, telemetry, observables ticks and
least-squares PVT (the broadcast iono feed, SBAS corrections and MT9's
GEO ephemeris, RAIM, the PVT Kalman filter), the PVT modes beyond it (RTK
against a base stream, models/rtk.py; PPP, models/ppp.py; the fork's
orbital EKF, models/pvt_ekf_orbital.py), and the fork's pseudolite
hybrid navigation (a
designated channel feeds AOWR time transfer instead of the fix, the rx
clock held after enough fixes, models/hybrid.py) — driven by the
AcquisitionManager event model
(models.control).  In batch mode each capture is uploaded to the device
once; each iteration dispatches one tracking chunk per chain and then pulls
and host-processes the PREVIOUS iteration's chunks, so the host work of
chunk k overlaps the device work of chunk k+1 (the pipelined batch mode of
the JAX receiver).  A live session feeds samples as they come and runs
synchronously, under the control plane's commands (monitor.tcp_cmd).

Usage: ``Receiver(ReceiverConf(...)).process_array(x)``, or a session from
``Receiver.start_session()``; `device=None` means the CUDA card and raises
without one, device="cpu" runs the plain versions of the kernels.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants, signals
from gnss_sim_receiver_tpu_torch.device import (device_context,
                                                resolve_device, upload)
from gnss_sim_receiver_tpu_torch.models.acquisition import (
    AcqConf, PcpsAcquisitionEngine)
from gnss_sim_receiver_tpu_torch.models.control import (AcquisitionManager,
                                                        ChannelState)
from gnss_sim_receiver_tpu_torch.models.hybrid import (AowrConf,
                                                       AowrTimeTransfer)
from gnss_sim_receiver_tpu_torch.models.observables import (
    ObsConf, ObservablesEngine)
from gnss_sim_receiver_tpu_torch.models.pvt import (PvtConf, solve_pvt,
                                                    solve_pvt_raim)
from gnss_sim_receiver_tpu_torch.models.ppp import PppConf, PppEngine
from gnss_sim_receiver_tpu_torch.models.pvt_ekf_orbital import (
    PvtEkfConf, PvtEkfOrbital)
from gnss_sim_receiver_tpu_torch.models.pvt_kf import PvtKf
from gnss_sim_receiver_tpu_torch.models.rtk import RtkConf, RtkEngine
from gnss_sim_receiver_tpu_torch.models.telemetry import (
    BeidouB1iTelemetryDecoder, GalileoE1bTelemetryDecoder,
    GalileoE5aTelemetryDecoder, GalileoE5bTelemetryDecoder,
    GalileoE6bTelemetryDecoder, GalileoTowMap, GlonassTelemetryDecoder,
    GpsCnavTelemetryDecoder, SbasL1TelemetryDecoder, TelemetryDecoder)
from gnss_sim_receiver_tpu_torch.models.tracking import (TrackingConf,
                                                         TrackingEngine)
from gnss_sim_receiver_tpu_torch.nav.ephemeris import (adj_gps_week,
                                                       almanac_to_ephemeris)
from gnss_sim_receiver_tpu_torch.nav.sbas import (SbasCorrections,
                                                  SbasGeoEphemeris)
from gnss_sim_receiver_tpu_torch.utils import geodesy


@dataclasses.dataclass
class SignalChainConf:
    """One per-signal channel group (the reference's Channels_<sig> block +
    its Acquisition_<sig>/Tracking_<sig> engine parameters)."""
    # "1C" | "1B" | "2S" | "L5" | "5X" | "7X" | "E6" | "1G" | "2G" | "B1"
    # | "B3" | "S1"
    signal: str = "1C"
    system: str = "GPS"
    prns: tuple = tuple(range(1, 33))
    n_channels: int = 8
    max_acq_channels: int = 8
    acq: AcqConf | None = None
    trk: TrackingConf | None = None
    code_provider: object = None       # prn -> +-1 sub-chip table
    sc_rate: float | None = None       # sub-chip rate for acquisition
    # the second replica family of the cccwsr acquisition (the E1-C pilot
    # on a data-only E1 chain) and of the iq_caf one (E5a-Q),
    # models/factory.py; on a track_pilot chain the DATA component's table
    # for the tracking engine's data-prompt correlator
    data_code_provider: object = None
    # chain-local channel index -> PRN pinning (Channel<i>.satellite)
    pinned: dict = dataclasses.field(default_factory=dict)
    # multi-band front end: which RF channel's stream this chain consumes
    # (Channels_<sig>.RF_channel_ID, gnss_flowgraph.cc:1018-1019); each RF
    # channel runs at ReceiverConf.rf_fs[rf_channel_id] (default fs)
    rf_channel_id: int = 0
    # acquisition-only resampler: integer decimation of this chain's
    # stream for the acquisition path only (a mean over acq_decim
    # samples; tracking stays at the full rate, delays rescale,
    # pcps_acquisition.cc:683-696).  1 = off.
    acq_decim: int = 1
    freq_slot: int = 0                 # GLONASS FDMA slot k ("1G", "2G")
    day_base_s: float = 0.0            # GLONASS day base for tk anchoring
    # secondary-band behavior: when another chain of the same system on
    # another carrier exists, each PRN's acquisition waits until that band
    # has locked it and then searches a Doppler-projected narrow grid in
    # one dwell (gnss_flowgraph.cc:2615-2750, project_doppler).  Without
    # such a chain the gate is inactive and the chain cold-starts.
    assist_wait: bool = False

    def telemetry_decoder(self, prns):
        if self.signal == "1B":
            return GalileoE1bTelemetryDecoder(prns)
        if self.signal == "1C":
            return TelemetryDecoder(prns)
        if self.signal in ("2S", "L5"):
            return GpsCnavTelemetryDecoder(prns, signal=self.signal)
        if self.signal == "5X":
            return GalileoE5aTelemetryDecoder(prns)
        if self.signal == "7X":
            return GalileoE5bTelemetryDecoder(prns)
        if self.signal in ("B1", "B3"):
            # B3I carries the same D1 NAV / NH20 structure as B1I
            return BeidouB1iTelemetryDecoder(prns)
        if self.signal in ("1G", "2G"):
            return GlonassTelemetryDecoder(
                prns, freq_slots={p: self.freq_slot for p in self.prns},
                day_base_s=self.day_base_s)
        if self.signal == "E6":
            return GalileoE6bTelemetryDecoder(prns)
        if self.signal == "S1":
            return SbasL1TelemetryDecoder(prns)
        raise NotImplementedError(f"signal chain {self.signal} is not ported")


def galileo_e1b_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      track_pilot: bool = False,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E1 chain: BOC(1,1) sub-chip engines, 4 ms coherent
    acquisition, decision-directed FLL pull-in.

    track_pilot=True is the reference's default E1 configuration
    (Tracking_1B.track_pilot=true): the loops track the E1-C PILOT (CS25
    secondary sync + wipeoff), which acquisition searches too, while a
    data-prompt correlator taps E1-B for I/NAV telemetry
    (dll_pll_veml_tracking.cc:1050-1061).  At extend_correlation_symbols
    == 1 the chain closes on the block kernels' pilot form (the data
    replica beside the pilot's, the block's CS25 sync), above it on the
    per-epoch chunk kernel."""
    sig = signals.GALILEO_E1B
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.sc_rate, code_length_chips=sig.sc_length,
        carrier_freq_hz=sig.carrier_freq_hz, early_late_space_chips=0.5,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    code_provider = signals.CodeProvider("1B")
    data_provider = None
    if track_pilot:
        trk_kw.update(
            track_pilot=True,
            secondary_code=tuple(
                int(v) for v in (signals.e1c_secondary_code() > 0)))
        code_provider = signals.CodeProvider("1B", "C")
        data_provider = signals.CodeProvider("1B")
    trk_kw.update(trk_overrides)
    trk = TrackingConf(**trk_kw)
    return SignalChainConf(
        signal="1B", system="Galileo", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=4, doppler_step=125.0,
                    max_dwells=2, make_two_steps=True, doppler_step2=31.25),
        trk=trk, code_provider=code_provider,
        data_code_provider=data_provider, sc_rate=sig.sc_rate)


def gps_l2c_chain(fs: float, prns=tuple(range(1, 33)), n_channels=4,
                  **trk_overrides) -> SignalChainConf:
    """GPS L2C CM chain: 20 ms code epochs carrying one 50-sps CNAV
    symbol each (the GPS_L2_M_* blocks of the reference): an 8 Hz PLL and
    0.75 Hz DLL with a 25-epoch decision-directed FLL pull-in, one 20 ms
    dwell with the doubled FFT on a 60 Hz grid refined on 15 Hz
    (receiver.py:161-184)."""
    sig = signals.GPS_L2C_CM
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=8.0, dll_bw_hz=0.75,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=25, cn0_window_epochs=20)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="2S", system="GPS", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=20, doppler_max=5000.0,
                    doppler_step=60.0, max_dwells=1,
                    make_two_steps=True, doppler_step2=15.0,
                    bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=signals.CodeProvider("2S"),
        sc_rate=sig.chip_rate_cps)


def _wideband_chain(sig, fs: float, prns, n_channels: int,
                    trk_overrides) -> SignalChainConf:
    """The GPS L5I, Galileo E5a-I and Galileo E5b-I chains: 10.23 Mcps,
    1 ms epochs, a 50 Hz PLL with a 100-epoch decision-directed FLL
    pull-in, 2-dwell 1 ms acquisition refined on a 62.5 Hz step
    (receiver.py:188-237, :267-290)."""
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=50.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal=sig.signal, system=sig.system, prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=signals.CodeProvider(sig.signal),
        sc_rate=sig.chip_rate_cps)


def gps_l5_chain(fs: float, prns=tuple(range(1, 33)), n_channels=4,
                 **trk_overrides) -> SignalChainConf:
    """GPS L5I chain: 10.23 Mcps, 1 ms epochs, NH10-spread 100-sps CNAV
    symbols (GPS_L5_* blocks)."""
    return _wideband_chain(signals.GPS_L5I, fs, prns, n_channels,
                           trk_overrides)


def galileo_e5a_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E5a-I chain: 10.23 Mcps, 1 ms epochs, CS20-spread 50-sps
    F/NAV symbols (the GALILEO_E5A_* blocks)."""
    return _wideband_chain(signals.GALILEO_E5A_I, fs, prns, n_channels,
                           trk_overrides)


def galileo_e5b_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E5b-I chain: 10.23 Mcps, 1 ms epochs, CS4-spread 250-sps
    I/NAV symbols (the GALILEO_E5B_* blocks of the reference factory,
    gnss_block_factory.cc signal '7X')."""
    return _wideband_chain(signals.GALILEO_E5B_I, fs, prns, n_channels,
                           trk_overrides)


def _beidou_chain(sig, fs: float, prns, n_channels: int, assist_wait: bool,
                  trk_overrides) -> SignalChainConf:
    """The BeiDou B1I and B3I (MEO/IGSO, D1) chains: 1 ms epochs of
    NH20-spread 50-bps D1 bits, a 40 Hz PLL with a 100-epoch
    decision-directed FLL pull-in, 2-dwell 1 ms acquisition with the
    doubled FFT refined on a 62.5 Hz step (receiver.py:240-263,
    :1789-1811)."""
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=40.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=assist_wait,
        signal=sig.signal, system=sig.system, prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5,
                    bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=signals.CodeProvider(sig.signal),
        sc_rate=sig.chip_rate_cps)


def beidou_b1i_chain(fs: float, prns=tuple(range(6, 31)), n_channels=4,
                     **trk_overrides) -> SignalChainConf:
    """BeiDou B1I (MEO/IGSO, D1) chain: 2.046 Mcps, 1 ms epochs,
    NH20-spread 50-bps D1 bits (the BEIDOU_B1I_* blocks).  A GEO PRN given
    in `prns` decodes D2 (its decoder switches per PRN)."""
    return _beidou_chain(signals.BEIDOU_B1I, fs, prns, n_channels, False,
                         trk_overrides)


def beidou_b3i_chain(fs: float, prns=tuple(range(6, 31)), n_channels=4,
                     **trk_overrides) -> SignalChainConf:
    """BeiDou B3I (MEO/IGSO, D1) chain: 10.23 Mcps, 1 ms epochs,
    NH20-spread 50-bps D1 bits (the BEIDOU_B3I_* blocks of the reference
    factory); beside a B1I chain it acquires each PRN around the B1I
    Doppler (assist_wait)."""
    return _beidou_chain(signals.BEIDOU_B3I, fs, prns, n_channels, True,
                         trk_overrides)


def galileo_e6b_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E6-B (HAS) chain: 5.115 Mcps memory codes, 1 ms epochs, one
    1000-sps C/NAV symbol per epoch (the reference's
    Galileo_E6_PCPS_Acquisition / Galileo_E6_DLL_PLL_Tracking /
    Galileo_E6 telemetry blocks, gnss_block_factory.cc:1012,1150;
    receiver.py:294-323).  Beside another Galileo band it acquires each
    PRN around that band's Doppler (assist_wait) and stamps TOW from the
    TOW that band publishes."""
    sig = signals.GALILEO_E6B
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=50.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        # E6-B is a data component with one symbol per epoch: the coherent
        # NBD/NBP lock test zero-means over any window; the rectified
        # detector takes its place (the reference tracks the E6-C pilot)
        lock_rectify=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="E6", system="Galileo", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=signals.CodeProvider("E6"),
        sc_rate=sig.chip_rate_cps)


def _glonass_chain(sig, dfreq: float, fs: float, prns, freq_slot: int,
                   n_channels: int | None, day_base_s: float,
                   assist_wait: bool, trk_overrides) -> SignalChainConf:
    """A GLONASS C/A chain for ONE frequency slot (FDMA: satellites on
    slot k acquire around doppler_center = k * dfreq and track on the
    offset carrier, the offset taken off the code rate as the FDMA
    bias; one chain per occupied slot, the reference's per-PRN
    d_doppler_bias, pcps_acquisition.cc:211-230; receiver.py:354-427).
    FLL pull-in stays on (10 ms symbols corrupt only 1 in 10 FLL pairs)
    and the rectified lock test handles the zero-mean meander data."""
    prns = tuple(prns)
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz + freq_slot * dfreq,
        doppler_bias_hz=freq_slot * dfreq,
        early_late_space_chips=0.5, lock_rectify=True,
        # a 400-epoch FLL blend: the meander's 100 Hz data lines sit inside
        # the Costas capture range, and a short FLL hand-over can leave a
        # ~100 Hz residual that false-locks onto a line
        enable_fll_pullin=True, fll_pullin_epochs=400)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=assist_wait,
        signal=sig.signal, system="GLONASS", prns=prns,
        n_channels=n_channels or len(prns),
        max_acq_channels=n_channels or len(prns),
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, doppler_center=freq_slot * dfreq,
                    max_dwells=2, make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=signals.CodeProvider(sig.signal),
        sc_rate=sig.chip_rate_cps,
        freq_slot=freq_slot, day_base_s=day_base_s)


def glonass_l1_chain(fs: float, prns, freq_slot: int = 0,
                     n_channels: int | None = None, day_base_s: float = 0.0,
                     **trk_overrides) -> SignalChainConf:
    """GLONASS L1 C/A chain of one frequency slot (the carrier at
    1602 MHz + k * 562.5 kHz)."""
    return _glonass_chain(signals.GLONASS_L1_CA,
                          constants.GLONASS_L1_DFREQ_HZ, fs, prns, freq_slot,
                          n_channels, day_base_s, False, trk_overrides)


def glonass_l2_chain(fs: float, prns, freq_slot: int = 0,
                     n_channels: int | None = None, day_base_s: float = 0.0,
                     **trk_overrides) -> SignalChainConf:
    """GLONASS L2 C/A chain ("2G") of one frequency slot: the same 511-chip
    code and GNAV stream on 1246 MHz + k * 437.5 kHz (the reference's
    GLONASS_L2_CA blocks); assist_wait lets an L1 lock project the
    Doppler by the 7/9 carrier ratio."""
    return _glonass_chain(signals.GLONASS_L2_CA,
                          constants.GLONASS_L2_DFREQ_HZ, fs, prns, freq_slot,
                          n_channels, day_base_s, True, trk_overrides)


def sbas_l1_chain(fs: float, prns=tuple(range(120, 139)), n_channels=2,
                  **trk_overrides) -> SignalChainConf:
    """SBAS L1 chain: GPS C/A chip plan on PRN 120-138, 500-sps conv-coded
    symbols (2 epochs each) — the reference's SBAS_L1_* blocks
    (sbas_l1_telemetry_decoder.cc adapter).  The symbols flip every 2
    epochs at worst: the FLL pull-in runs decision-directed (JAX's chain
    sets it so, whatever its docstring says) and the rectified lock test
    handles the zero-mean symbol stream."""
    sig = signals.SBAS_L1
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=40.0,
        lock_rectify=True, enable_fll_pullin=True,
        fll_decision_directed=True)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        signal="S1", system="SBAS", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2, make_two_steps=True,
                    doppler_step2=62.5, bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=signals.CodeProvider("S1"),
        sc_rate=sig.chip_rate_cps)


@dataclasses.dataclass
class ReceiverConf:
    fs: float = 2_000_000.0
    prns: tuple = tuple(range(1, 33))
    max_channels: int = 12
    max_acq_channels: int = 8         # Channels.in_acquisition
    acq: AcqConf | None = None
    trk: TrackingConf | None = None
    obs: ObsConf | None = None
    pvt: PvtConf | None = None
    chunk_epochs: int = 1000          # 1 ms epochs per chunk (chunk ~ 1 s)
    output_rate_ms: int = 20          # observable (and PVT) epoch interval
    # PVT solve cadence (reference PVT.output_rate_ms vs
    # Observables.observable_interval_ms split): observable epochs form
    # every output_rate_ms; the solver runs only on epochs aligned to
    # pvt_rate_ms.  0 = solve on every observable epoch.
    pvt_rate_ms: int = 0
    enable_pvt_kf: bool = False        # PVT.enable_pvt_kf (Pvt_Kf analogue)
    # fork orbital-dynamics EKF (models.pvt_ekf_orbital.PvtEkfOrbital,
    # rtklib_pvt.cc:491-515 hook); pvt_ekf holds an optional PvtEkfConf
    enable_pvt_ekf: bool = False
    pvt_ekf: object = None
    chains: tuple = ()                # SignalChainConfs beyond GPS L1;
    # set gps_chain=False to drop the implicit GPS L1 chain entirely
    gps_chain: bool = True
    # GPS-chain channel index -> PRN pinning (Channel<i>.satellite)
    pinned_channels: dict = dataclasses.field(default_factory=dict)
    # multi-band front end: rf_channel_id -> sampling rate of that RF
    # channel's stream (attach_arrays); unlisted RF channels run at `fs`
    rf_fs: dict = dataclasses.field(default_factory=dict)
    # telemetry fail-safe: drop a TRACKING channel that produced no valid
    # TOW for this long (gps_l1_ca_telemetry_decoder_gs.cc:448-460); 0 off
    tlm_timeout_s: float = 30.0
    # hybrid GNSS + pseudolite navigation (GNSS-SDR.hybrid_mode /
    # GNSS-SDR.pseudo_sat_ch_id): the designated global channel is a
    # pseudolite tracker whose observable feeds AOWR time transfer instead
    # of the position solution
    hybrid_mode: bool = False
    # GNSS-SDR.pre_2009_file (control_thread.cc:161): resolve the LNAV
    # 10-bit week into the 1999-2019 rollover era instead of aligning to
    # the current receiver date
    pre_2009_file: bool = False
    ps_channel: int = -1
    ps_range_m: float = 0.4           # known rx<->pseudolite range
    # rx clock handling (fork: rtklib_pvt.cc:910-917)
    enable_rx_clock_propagation: bool = False
    clk_prop_after_n_fixes: int = 10
    share_rx_clock_bias: bool = False
    # RTK relative positioning (PVT.positioning_mode = RTK_*): engine conf
    # (models.rtk.RtkConf) and the known base position; the base
    # observables stream is passed to process_array (rtklib_rtkpos.cc
    # relpos roles)
    rtk: object = None
    rtk_base_ecef_m: tuple = None

    def __post_init__(self):
        if self.acq is None:
            self.acq = AcqConf(fs_in=self.fs, max_dwells=2)
        if self.trk is None:
            self.trk = TrackingConf(fs=self.fs)
        if self.obs is None:
            self.obs = ObsConf(fs=self.fs, interval_ms=self.output_rate_ms)
        if self.hybrid_mode and self.obs.ps_channel != self.ps_channel:
            self.obs = dataclasses.replace(self.obs,
                                           ps_channel=self.ps_channel)
        if self.pvt is None:
            self.pvt = PvtConf()
        # observables history must out-span a tracking chunk
        if self.obs.history_len < self.chunk_epochs + 128:
            self.obs = dataclasses.replace(
                self.obs, history_len=self.chunk_epochs + 128)

    def all_chains(self) -> list[SignalChainConf]:
        out = []
        if self.gps_chain:
            out.append(SignalChainConf(
                signal="1C", system="GPS", prns=tuple(self.prns),
                n_channels=self.max_channels,
                max_acq_channels=self.max_acq_channels,
                acq=self.acq, trk=self.trk,
                pinned=dict(self.pinned_channels)))
        out.extend(self.chains)
        if not out:
            raise ValueError("receiver configured with no signal chains")
        return out


@dataclasses.dataclass
class ReceiverRun:
    solutions: list            # [PvtSolution]
    observation_epochs: list   # [ObservationEpoch]
    channel_prns: list[int]    # final PRN per (global) channel (0 = idle)
    channel_states: list       # final ChannelState per channel
    ephemerides: dict          # prn (GPS) | (system, prn) -> GpsEphemeris
    events: list               # [(channel, ChannelEvent)]
    # every epoch's tracking planes ([T, C] per key) with
    # collect_track_outputs: one dict per signal, or the dict itself when
    # there is one signal
    track_outputs: dict | None = None
    channel_systems: list = ()  # constellation per channel
    # decoded Galileo HAS messages (nav.has.HasData), E6-B chains only
    has_messages: list = dataclasses.field(default_factory=list)
    # hybrid-mode AOWR products: [(clock_diff_s, est_tx_tow_s)] per fix
    clock_differences: list = dataclasses.field(default_factory=list)
    # rx clock sharing records: [(rx_time_s, tag_tow_s, bias_s, prn)]
    rx_clock_bias_log: list = dataclasses.field(default_factory=list)
    # RTK products: [(rx_time_s, models.rtk.RtkSolution)] when
    # PVT.positioning_mode = RTK_* and a base stream was given
    rtk_solutions: list = dataclasses.field(default_factory=list)
    # orbital EKF products: [(rx_time_s, pos_ecef, vel_ecef, clock_bias_s,
    # clock_drift_ss)] with enable_pvt_ekf
    ekf_solutions: list = dataclasses.field(default_factory=list)
    # PPP float-filter products: [(rx_time_s, models.ppp.PppSolution)]
    # when PVT.positioning_mode = PPP_*
    ppp_solutions: list = dataclasses.field(default_factory=list)
    # broadcast assistance decoded from LNAV subframes 4/5
    almanac: dict = dataclasses.field(default_factory=dict)
    iono_utc: object = None


def check_positioning_mode(mode: str) -> None:
    """Raise for a PVT.positioning_mode the receiver does not implement
    (DGPS, as in the JAX package): it fails at the session's construction
    and never falls back to single-point LS; a conf naming it still
    parses."""
    if mode == "DGPS":
        raise NotImplementedError(
            f"PVT.positioning_mode {mode} is not implemented")


class _ChainRt:
    """Runtime state of one signal chain."""

    def __init__(self, spec: SignalChainConf, obs_offset: int, device):
        self.spec = spec
        self.offset = obs_offset      # global channel index of channel 0
        n = spec.n_channels
        self.mgr = AcquisitionManager(spec.prns, n,
                                      max_acq_channels=spec.max_acq_channels,
                                      pinned=spec.pinned)
        self.trk = TrackingEngine(
            spec.trk, prns=[0] * n, code_provider=spec.code_provider,
            device=device,
            data_code_provider=(spec.data_code_provider
                                if spec.trk.track_pilot else None))
        self.tlm = spec.telemetry_decoder([0] * n)
        self.nominal = spec.trk.nominal_epoch_samples
        self.margin = self.trk._read_margin()
        self.epoch_base = [0] * n
        self.acq_engines = {}
        self.done = 0
        self.total = 0
        self.decim = 1                # set by the session (tick stride)
        self.sbas_consumed = 0        # messages already fed to corrections
        self.pending_resets = []      # (channel, prn) TLM/obs resets to
        #                               apply after the in-flight chunk
        # per-channel epochs since start_tracking
        self.epochs_run = np.zeros(n, np.int64)

    def eph_key(self, prn: int):
        return prn if self.spec.system == "GPS" else (self.spec.system, prn)


def _expand_sc(sc_dec: np.ndarray, rows: np.ndarray, n_epochs: int,
               nominal: int) -> np.ndarray:
    """Reconstruct the per-epoch sample counter [T, C] from the decimated
    one [Td, C]: linear interpolation over the epoch index (the counter
    drifts from linear only by the Doppler rate, ~1e-7 samples over a
    tick)."""
    t = np.arange(n_epochs, dtype=np.float64)
    out = np.empty((n_epochs, sc_dec.shape[1]), np.float64)
    for c in range(sc_dec.shape[1]):
        out[:, c] = np.interp(t, rows.astype(np.float64),
                              sc_dec[:, c].astype(np.float64))
    # extrapolate the ends with the nominal epoch length
    first, last = rows[0], rows[-1]
    if first > 0:
        out[:first] = out[first] - (first - t[:first, None]) * nominal
    if last < n_epochs - 1:
        out[last + 1:] = out[last] + (t[last + 1:, None] - last) * nominal
    return out


def _channel_maps(chains, n_total):
    prn_map = [0] * n_total
    sys_map = ["GPS"] * n_total
    for rt in chains:
        for c in range(rt.spec.n_channels):
            prn_map[rt.offset + c] = rt.mgr.channels[c].prn
            sys_map[rt.offset + c] = rt.spec.system
    return prn_map, sys_map


class ReceiverSession:
    """A receiver instance, the ControlThread + flowgraph event loop of the
    reference made incremental.  Two input modes:

    - `attach_arrays({rf: x})` (or `attach_array(x)` for RF channel 0) +
      `run_to_end()`: whole captures, one per RF channel at
      `conf.rf_fs[rf]` (default `conf.fs`), each uploaded once; the
      iterations pipeline: each dispatches one tracking chunk per chain
      and then pulls and host-processes the PREVIOUS iteration's chunks;
    - `feed(samples)` repeatedly (+ `run_to_end()` at the end of the
      stream): a live front end on RF channel 0.  Samples gather in a host
      buffer, every feed runs the full chunks the buffered data allows,
      synchronously, and the samples no chain can still need are dropped.

    The acquisition cursor and the observables' tick bound run in the
    PRIMARY (`conf.fs`) sample domain and convert per chain.  `result()`
    snapshots a ReceiverRun at any time.

    `collect_track_outputs=True` pulls every epoch's full planes from every
    chain (the per-epoch chunk kernel runs them all, never the block
    kernels) and keeps them for `result().track_outputs`, the input of
    the .mat dumps (models/dumps.py).

    Control plane (tcp_cmd_interface.cc:46-176): `standby()` parks every
    channel and drops inflow; `coldstart()` also drops the ephemerides and
    the last fix; `warmstart()` keeps the ephemerides; `hotstart()` keeps
    them and the last fix and searches the predicted-visible satellites
    first; `status_text()` is one line; `on_command(name)` takes the wire
    protocol's names.

    Fail-safe: a channel TRACKING longer than `conf.tlm_timeout_s` without
    ever producing a valid TOW is dropped back to acquisition."""

    def __init__(self, conf: ReceiverConf, device=None,
                 collect_track_outputs: bool = False, ephemerides=None,
                 base_observations=None):
        mode = conf.pvt.positioning_mode
        check_positioning_mode(mode)
        self.conf = conf
        self.device = resolve_device(device)
        self.collect = bool(collect_track_outputs)
        # collecting pulls every epoch's full planes and pushes every epoch
        # into the observables history, so chunks grow less; decimated
        # transfers push one observables row per tick
        self.max_mult = 8 if self.collect else 128
        chains = []
        n_total = 0
        for spec in conf.all_chains():
            chains.append(_ChainRt(spec, n_total, self.device))
            n_total += spec.n_channels
            chains[-1].trk.full_outputs = self.collect
        self.chains = chains
        self.n_total = n_total
        # cross-band Galileo TOW sharing: E6-B C/NAV is timeless, its
        # channels stamp the TOW the other Galileo bands publish
        # (galileo_tow_map.cc role); the map runs on the primary rate
        self.tow_map = None
        if any(rt.spec.signal == "E6" for rt in chains):
            self.tow_map = GalileoTowMap(conf.fs)
            for rt in chains:
                if rt.spec.signal == "E6":
                    rt.tlm.tow_map = self.tow_map
        # each channel's carrier: a GLONASS slot chain's is its own
        self.freq_map = np.concatenate(
            [np.full(rt.spec.n_channels, rt.spec.trk.carrier_freq_hz)
             for rt in chains])
        for rt in chains:
            # one kept epoch per observable tick (capped at 90 ms spacing so
            # the observables history interpolation stays bracketed); the
            # history must hold what one chunk pushes at the largest chunk
            epoch_ms = rt.nominal / self._chain_fs(rt) * 1000.0
            rt.decim = (1 if self.collect else
                        max(1, int(min(conf.obs.interval_ms, 90.0)
                                   // epoch_ms)))
            rows = int(conf.chunk_epochs * self.max_mult // rt.decim) + 256
            if conf.obs.history_len < rows:
                conf.obs.history_len = rows
        fs_map = np.concatenate(
            [np.full(rt.spec.n_channels, self._chain_fs(rt))
             for rt in chains])
        self.obs_eng = ObservablesEngine(
            conf.obs, n_channels=n_total, carrier_freq_hz=self.freq_map,
            fs_per_channel=fs_map)
        self.ephemerides = dict(ephemerides or {})
        self.solutions = []
        self.obs_epochs = []
        self.last_fix = None
        self.last_fix_time = None
        self.n_fixes = 0
        self.pvt_kf = PvtKf() if conf.enable_pvt_kf else None
        # SBAS corrections state, fed from S1-chain messages and applied
        # in PVT (rtklib_sbas.cc sbssatcorr/sbsioncorr roles); MT9 GEO
        # navigation becomes an ("SBAS", prn) ephemeris so the GEO itself
        # ranges like any satellite
        self.sbas_corr = (SbasCorrections()
                          if any(rt.spec.signal == "S1" for rt in chains)
                          else None)
        self.aowr = None
        if conf.hybrid_mode and conf.ps_channel >= 0:
            # carrier-phase aiding scales by the ps channel's own signal
            # frequency (the reference's SIGNAL_FREQ_MAP lookup), taken from
            # the chain that holds the channel
            ps_freq = constants.GPS_L1_FREQ_HZ
            for rt in chains:
                if 0 <= conf.ps_channel - rt.offset < rt.spec.n_channels:
                    ps_freq = rt.spec.trk.carrier_freq_hz
                    break
            self.aowr = AowrTimeTransfer(AowrConf(
                r_ps_true_m=conf.ps_range_m, carrier_freq_hz=ps_freq))
        self.clock_differences = []
        self.rx_clock_bias_log = []
        # RTK relative positioning (PVT.positioning_mode = RTK_*): the base
        # stream's epochs paired with the rover's by time
        self.base_observations = base_observations
        self.rtk_eng = None
        self.rtk_solutions = []
        if mode.startswith("RTK"):
            if base_observations is None:
                raise ValueError(
                    "PVT.positioning_mode is RTK_* but no "
                    "base_observations stream was provided")
            base_ecef = np.asarray(
                conf.rtk_base_ecef_m if conf.rtk_base_ecef_m is not None
                else base_observations.base_ecef_m, np.float64)
            rtk_conf = conf.rtk if conf.rtk is not None else RtkConf(
                mode="kinematic" if mode == "RTK_Kinematic" else "static")
            self.rtk_eng = RtkEngine(rtk_conf, base_ecef_m=base_ecef)
        # PPP float filter (PVT.positioning_mode = PPP_*): undifferenced
        # code + carrier EKF (rtklib_ppp.cc pppos role), seeded from the
        # first LS fix
        self.ppp_eng = None
        self.ppp_solutions = []
        if mode.startswith("PPP"):
            self.ppp_eng = PppEngine(PppConf(
                mode="kinematic" if mode == "PPP_Kinematic" else "static"))
        # fork orbital-dynamics EKF (rtklib_pvt.cc:491-515 hook), built
        # with its frame epoch at t = 0 as the JAX receiver builds it
        self.pvt_ekf = None
        if conf.enable_pvt_ekf:
            self.pvt_ekf = PvtEkfOrbital(conf.pvt_ekf if conf.pvt_ekf
                                         is not None else PvtEkfConf())
        self.ekf_solutions = []
        self.collected = [] if self.collect else None  # (signal, outputs)
        # input state: absolute sample indexes in the PRIMARY (conf.fs)
        # domain, shared by both modes
        self._array_mode = False
        self._x_rf = {}               # array mode: rf id -> capture tensor
        self._len_rf = {}             # rf id -> length (samples at rf fs)
        self._buf = np.zeros(0, np.complex64)   # streaming host buffer
        self._base = 0                # absolute index of _buf[0]
        self._end_abs = 0             # capture length so far (primary)
        self.cursor = 0               # acquisition head (absolute sample)
        self.chunk_mult = 1
        self.chunk_s = conf.chunk_epochs * 1e-3
        self._standby = False
        self._pipeline = False        # array mode pipelines, streaming not
        self._inflight = []           # (rt, tracking, n, handle)
        self._trk_start_abs = np.full(n_total, -1, np.int64)
        self._tow_seen = np.zeros(n_total, bool)
        # cross-band Doppler assistance: (system, prn) -> (doppler_hz,
        # carrier_freq_hz) of the last valid epoch of a tracking channel
        # (project_doppler's source, gnss_flowgraph.cc:1774-1795)
        self.doppler_map: dict = {}
        self.assist_log: list = []    # (signal, prn, center_hz, detected)
        # channel searches by (signal, "cold" | "assisted" | "resampled")
        self.searches = collections.Counter()
        # a command thread's calls (monitor.tcp_cmd) wait for the feed in
        # progress, as the reference's control queue runs between the
        # flowgraph's work
        self._lock = threading.RLock()

    # -- input ----------------------------------------------------------------

    def attach_array(self, x) -> None:
        """The whole capture (NumPy array or tensor) on RF channel 0."""
        self.attach_arrays({0: x})

    def attach_arrays(self, streams: dict) -> None:
        """Multi-band captures: rf_channel_id -> capture (NumPy array,
        uploaded once, or tensor), each at conf.rf_fs[rf] (default
        conf.fs), all starting at the same instant (a coherent front end,
        gnss_flowgraph.cc:1008-1136)."""
        for rf, x in streams.items():
            if isinstance(x, np.ndarray):
                x = upload(np.ascontiguousarray(x, dtype=np.complex64),
                           self.device)
            self._x_rf[int(rf)] = x.to(device=self.device,
                                       dtype=torch.complex64)
            self._len_rf[int(rf)] = len(x)
        missing = {rt.spec.rf_channel_id for rt in self.chains} \
            - set(self._x_rf)
        if missing:
            raise ValueError(f"no stream for RF channel(s) {missing}")
        self._array_mode = True
        self._pipeline = True
        # the primary-domain end: the shortest stream in time
        self._end_abs = int(min(
            self._len_rf[rf] / self._rf_fs(rf) for rf in self._x_rf)
            * self.conf.fs)
        self._recompute_totals()

    def _rf_fs(self, rf: int) -> float:
        return float(self.conf.rf_fs.get(rf, self.conf.fs))

    def _chain_fs(self, rt) -> float:
        return self._rf_fs(rt.spec.rf_channel_id)

    def _to_chain(self, rt, primary_sample: int) -> int:
        """A primary-domain absolute sample in the chain's sample domain."""
        f = self._chain_fs(rt)
        if f == self.conf.fs:
            return int(primary_sample)
        return int(primary_sample * (f / self.conf.fs))

    def _to_primary(self, rt, chain_sample: float) -> int:
        f = self._chain_fs(rt)
        if f == self.conf.fs:
            return int(chain_sample)
        return int(chain_sample * (self.conf.fs / f))

    def feed(self, samples) -> None:
        """Streaming mode: append samples of RF channel 0 and run the full
        chunks the buffered data now allows.  Every chain must read RF
        channel 0: the stream is one."""
        with self._lock:
            self._feed(samples)

    def _feed(self, samples) -> None:
        if self._array_mode:
            raise RuntimeError("session is in array mode")
        for rt in self.chains:
            if rt.spec.rf_channel_id != 0:
                raise NotImplementedError(
                    f"feed: the {rt.spec.signal} chain reads RF channel "
                    f"{rt.spec.rf_channel_id}; a streaming session reads one "
                    "stream, so a chain on another RF channel is not "
                    "ported")
        samples = np.asarray(samples, np.complex64)
        if self._standby:
            # standby consumes and drops inflow (gnss_flowgraph.cc:1991)
            self._base += len(self._buf) + len(samples)
            self._buf = np.zeros(0, np.complex64)
            self._end_abs = self._base
            self.cursor = max(self.cursor, self._base)
            return
        self._buf = np.concatenate([self._buf, samples])
        self._end_abs = self._base + len(self._buf)
        self._recompute_totals()
        self._pump(final=False)
        self._trim()

    def run_to_end(self) -> None:
        """Process everything remaining (the end of the stream)."""
        with self._lock:
            self._recompute_totals()
            self._pump(final=True)

    # -- control plane (TcpCmdInterface command set) ---------------------------

    def _reset_channels(self) -> None:
        for rt in self.chains:
            for c in range(rt.spec.n_channels):
                st = rt.mgr.channels[c]
                if st.state == ChannelState.TRACKING:
                    rt.trk.stop_channel(c)
                st.state = ChannelState.IDLE
                st.prn = 0
                rt.tlm.reset_channel(c, None, epoch_base=rt.epoch_base[c])
                self.obs_eng.reset_channel(rt.offset + c)
            # rebuild the PRN rotation pool
            rt.mgr.__init__(rt.spec.prns, rt.spec.n_channels,
                            max_acq_channels=rt.spec.max_acq_channels,
                            pinned=rt.spec.pinned)
        self._trk_start_abs[:] = -1
        self._tow_seen[:] = False
        self.chunk_mult = 1
        self._inflight = []   # device results of parked channels are moot

    def standby(self) -> None:
        """Park every channel; inflow is dropped until a *start."""
        self._reset_channels()
        self._standby = True

    def coldstart(self) -> None:
        """Drop the ephemerides and the fixes, restart acquisition."""
        self.ephemerides.clear()
        self.last_fix = None
        self.last_fix_time = None
        self.n_fixes = 0
        self._reset_channels()
        self._standby = False

    def warmstart(self) -> None:
        """Restart the channels, keep the ephemerides."""
        self._reset_channels()
        self._standby = False

    def hotstart(self) -> None:
        """Restart the channels, keep the ephemerides and the last fix;
        the predicted-visible satellites search first."""
        self._reset_channels()
        self.prioritize_visible()
        self._standby = False

    def status_text(self) -> str:
        """One line (the command protocol is line-based): the mode, every
        channel's system, PRN and state, and the last fix."""
        with self._lock:
            prn_map, sys_map = _channel_maps(self.chains, self.n_total)
            states = [rt.mgr.channels[c].state.name for rt in self.chains
                      for c in range(rt.spec.n_channels)]
            standby, fix = self._standby, self.last_fix
        parts = ["standby" if standby else "running"]
        parts += [f"ch{i}={s}:{p}:{st}" for i, (p, s, st)
                  in enumerate(zip(prn_map, sys_map, states))]
        if fix is not None:
            ecef = fix.rx_ecef_m
            parts.append("fix=%.3f,%.3f,%.3f nsats=%d"
                         % (ecef[0], ecef[1], ecef[2], fix.n_sats))
        else:
            parts.append("fix=none")
        return " ".join(parts)

    def broadcast_almanac(self) -> dict:
        alm = {}
        for rt in self.chains:
            alm.update(getattr(rt.tlm, "almanac", {}) or {})
        return alm

    def broadcast_iono_utc(self):
        for rt in self.chains:
            iono = getattr(rt.tlm, "iono_utc", None)
            if iono:
                return iono
        return None

    def prioritize_visible(self, rx_ecef=None, t_gps_s=None) -> list:
        """Reorder every GPS chain's acquisition pool so that satellites
        predicted visible (held ephemerides, else the broadcast almanac, at
        the last fix) search first (control_thread.cc:1011
        get_visible_sats, gnss_flowgraph.cc:2012 priorize_satellites).
        Returns the visible PRNs, highest first."""
        if rx_ecef is None and self.last_fix is not None:
            rx_ecef = self.last_fix.rx_ecef_m
        if rx_ecef is None:
            return []
        if t_gps_s is None:
            t_gps_s = (self.last_fix_time
                       if self.last_fix_time is not None else 0.0)
        alm = self.broadcast_almanac()
        visible = []
        elevs = {}
        for rt in self.chains:
            if rt.spec.system != "GPS":
                continue
            for prn in rt.spec.prns:
                eph = self.ephemerides.get(prn)
                if eph is None and prn in alm:
                    eph = almanac_to_ephemeris(prn, alm[prn])
                if eph is None:
                    continue
                try:
                    pos, _ = eph.sat_pos_clock(t_gps_s)
                except Exception:
                    continue
                el, _ = geodesy.elevation_azimuth(np.asarray(rx_ecef), pos)
                elevs[prn] = float(np.degrees(el))
                if elevs[prn] >= 5.0:
                    visible.append(prn)
        for rt in self.chains:
            if rt.spec.system != "GPS":
                continue
            pool = list(rt.mgr.pool)
            pool.sort(key=lambda p: -elevs.get(p, -90.0))
            rt.mgr.pool = collections.deque(pool)
        return sorted(visible, key=lambda p: -elevs[p])

    def on_command(self, name: str) -> str:
        """Wire-protocol dispatch (tcp_cmd_interface.cc handler names).  A
        command may arrive on another thread (monitor.tcp_cmd): it waits
        for a feed in progress, and its device calls go to the session's
        device on the default stream."""
        name = name.strip().lower()
        with self._lock, device_context(self.device):
            if name == "status":
                return self.status_text()
            if name == "standby":
                self.standby()
                return "OK standby"
            if name in ("reset", "coldstart"):
                self.coldstart()
                return f"OK {name}"
            if name == "warmstart":
                self.warmstart()
                return "OK warmstart"
            if name == "hotstart":
                self.hotstart()
                return "OK hotstart"
        return f"ERROR unknown command {name}"

    # -- core loop -------------------------------------------------------------

    def _recompute_totals(self) -> None:
        for rt in self.chains:
            end_rt = self._end_rt(rt)
            rt.total = max((end_rt - rt.margin) // rt.nominal - 2, 0)

    def _end_rt(self, rt) -> int:
        """The end of the chain's stream in its own sample domain."""
        if self._array_mode:
            return self._len_rf[rt.spec.rf_channel_id]
        return self._to_chain(rt, self._end_abs)

    def _chunk_n(self, rt) -> int:
        return int(round(self.chunk_s * self.chunk_mult
                         / (rt.nominal / self._chain_fs(rt))))

    def _ready(self, final: bool) -> bool:
        live = [rt for rt in self.chains if rt.done < rt.total]
        if not live:
            return False
        if final:
            return True
        # without the end of the stream, run only when every live chain
        # can take a FULL chunk (tails wait for more data)
        return all(rt.total - rt.done >= self._chunk_n(rt) for rt in live)

    def _pump(self, final: bool) -> None:
        if self._standby:
            return
        while self._ready(final) or self._inflight:
            if not self._iterate(final):
                if self._inflight:
                    continue   # drain in-flight chunks before stopping
                break   # data-starved

    def _window(self, rt):
        """(samples, absolute index of their first) of the chain's stream
        in its own sample domain: the capture, or the streaming buffer."""
        if self._array_mode:
            return self._x_rf[rt.spec.rf_channel_id], 0
        return self._buf, self._base

    def _trim(self) -> None:
        """Drop streamed samples no chain can still need."""
        if self._array_mode or not len(self._buf):
            return
        keep_from = self.cursor
        margin = max(rt.margin for rt in self.chains)
        for rt in self.chains:
            act = rt.trk.active_host
            if act.any():
                keep_from = min(keep_from, int(rt.trk.abs_start[act].min()))
        keep_from = max(self._base, keep_from - 4 * margin)
        drop = keep_from - self._base
        if drop > 0:
            self._buf = self._buf[drop:]
            self._base = keep_from

    def _acquire(self, rt) -> bool:
        """Search the chain's channels awaiting acquisition and arm the
        detected ones.  Channels whose satellite another band of the system
        tracks search a narrow grid around its Doppler scaled by the carrier
        ratio (assisted); the others search the full grid (cold), unless the
        assist gate holds them: an assist_wait chain beside another band of
        its system waits for that band's lock.  Returns False when a new
        lock happened (an FSM event)."""
        mgr, spec = rt.mgr, rt.spec
        acquiring = mgr.acquiring_channels()
        if not acquiring:
            return True
        f_this = spec.trk.carrier_freq_hz
        gate = spec.assist_wait and any(
            r.spec.system == spec.system
            and r.spec.trk.carrier_freq_hz != f_this for r in self.chains)
        cold, assisted, centers = [], [], []
        for c in acquiring:
            hit = self.doppler_map.get((spec.system, mgr.channels[c].prn))
            if hit is not None and hit[1] != f_this:
                assisted.append(c)
                centers.append(hit[0] * f_this / hit[1])
            elif not gate:
                cold.append(c)
            # gated channels stay ACQUIRING until their primary band locks
        quiet = True
        for group, is_assist in ((cold, False), (assisted, True)):
            if group:
                quiet = self._search(rt, group, is_assist, centers) and quiet
        return quiet

    def _search(self, rt, group, is_assist: bool, centers) -> bool:
        """One acquisition of `group` (the chain's channels) at the cursor
        and the arming of its detections; False on a new lock."""
        quiet = True
        mgr, spec = rt.mgr, rt.spec
        prns = tuple(mgr.channels[c].prn for c in group)
        eng = rt.acq_engines.get(prns)
        if eng is None:
            eng = PcpsAcquisitionEngine(
                spec.acq, prns=prns, code_provider=spec.code_provider,
                sc_rate=spec.sc_rate, code_provider2=spec.data_code_provider,
                device=self.device)
            rt.acq_engines[prns] = eng
        need = eng.n_samples_needed
        acq_x, acq_base = self._window(rt)
        dec = max(1, int(spec.acq_decim))
        cur_rt = self._to_chain(rt, self.cursor)
        if cur_rt + need * dec > self._end_rt(rt):
            return quiet
        if dec > 1:
            # acquisition-only resampler: the mean over `dec` samples of
            # just the needed slice (one PyTorch call); tracking stays at
            # the chain's rate and the delays rescale by `dec`
            sl = acq_x[cur_rt - acq_base:cur_rt - acq_base + need * dec]
            if isinstance(sl, np.ndarray):
                sl = upload(np.ascontiguousarray(sl), self.device)
            res = eng.acquire(sl.reshape(-1, dec).mean(dim=1), samplestamp=0)
            self.searches[(spec.signal, "resampled")] += len(group)
        elif is_assist:
            res = eng.acquire_assisted(acq_x, cur_rt - acq_base,
                                       np.asarray(centers))
            for k, c in enumerate(group):
                self.assist_log.append((spec.signal, mgr.channels[c].prn,
                                        centers[k], bool(res.detected[k])))
            self.searches[(spec.signal, "assisted")] += len(group)
        else:
            res = eng.acquire_from(acq_x, cur_rt - acq_base)
            self.searches[(spec.signal, "cold")] += len(group)
        for k, c in enumerate(group):
            mgr.on_acq_result(c, bool(res.detected[k]),
                              float(res.doppler_hz[k]))
            if mgr.channels[c].state != ChannelState.TRACKING:
                continue
            quiet = False
            prn = mgr.channels[c].prn
            rt.trk.set_channel_prn(c, prn)
            if dec > 1:
                # the decimated grid's delay in chain samples (+ the mean's
                # group delay)
                start_abs = int(round(cur_rt + res.delay_samples[k] * dec
                                      + 0.5 * (dec - 1)))
            else:
                start_abs = int(acq_base + res.samplestamp
                                + res.delay_samples[k])
            # arm at the CHAIN FRONT: advance by an integer number of
            # Doppler-corrected code periods to where the next chunk
            # starts, so a channel armed behind the front does not trail
            # every other channel
            act_now = rt.trk.active_host
            if act_now.any():
                front = int(rt.trk.abs_start[act_now].max())
                if front > start_abs:
                    trk = spec.trk
                    cf0 = (trk.code_rate_cps
                           * (1.0 + (float(res.doppler_hz[k])
                                     - trk.doppler_bias_hz)
                              / trk.carrier_freq_hz))
                    s_per = self._chain_fs(rt) * trk.code_length_chips / cf0
                    kper = int(np.ceil((front - start_abs) / s_per))
                    start_abs = int(round(start_abs + kper * s_per))
            rt.trk.start_tracking(c, float(res.doppler_hz[k]), start_abs)
            # a chunk of this chain dispatched BEFORE this arm is still in
            # flight: reset the decoders after its rows so bit edges stay
            # aligned
            if any(frt is rt for frt, *_ in self._inflight):
                rt.pending_resets.append((c, prn))
            else:
                rt.tlm.reset_channel(c, prn, epoch_base=rt.epoch_base[c])
                self.obs_eng.reset_channel(rt.offset + c)
            rt.epochs_run[c] = 0
            g = rt.offset + c
            self._trk_start_abs[g] = start_abs
            self._tow_seen[g] = False
        return quiet

    def _dispatch(self, rt, final: bool):
        """Phase 1 for one chain: FSM, acquisition and the dispatch of its
        next tracking chunk.  Returns (quiet, progressed, advanced, staged
        entry or None)."""
        rt.mgr.schedule()
        quiet = self._acquire(rt)
        tracking = rt.mgr.tracking_channels()
        chunk_n = self._chunk_n(rt)
        if not tracking:
            rt.done += min(chunk_n, rt.total - rt.done)
            return quiet, False, True, None
        # late-acquired channels shift the chain's window: only as many
        # epochs as fit before the stream end
        n = min(chunk_n, rt.total - rt.done,
                rt.trk.epochs_that_fit(self._end_rt(rt)))
        if 0 < n < chunk_n:
            if not final:
                return quiet, False, False, None   # wait for more data
            # eat the tail in ONE block-aligned chunk (+ one sub-block
            # remainder of < 2 blocks next iteration)
            q = rt.trk.block_epochs
            if n >= 2 * q:
                n = (n // q) * q
        if n <= 0:
            if not final:
                return quiet, False, False, None
            rt.done = rt.total   # stream exhausted for this chain
            return quiet, False, True, None
        rt.done += n
        # FLL pull-in on: the block kernel runs from the first chunk (its
        # FLL + wide-DLL staging absorb the acquisition handoff errors)
        need = (0 if rt.spec.trk.enable_fll_pullin
                else rt.spec.trk.fll_pullin_epochs + 1000)
        use_blocks = all(rt.epochs_run[c] >= need for c in tracking)
        win, win_base = self._window(rt)
        handle = rt.trk.process_begin(win, win_base, n, decim=rt.decim,
                                      use_blocks=use_blocks)
        return quiet, True, True, (rt, tracking, n, handle)

    def _consume(self, rt, tracking, n, handle):
        """Phase 2 for one pulled chunk: telemetry, observables, the
        Doppler map, lock-loss events and the TLM-timeout fail-safe.
        Returns (quiet, tick bound in the primary domain or None)."""
        spec = rt.spec
        outs = rt.trk.process_end(handle)
        # channels (re)armed after this chunk was dispatched: its rows
        # predate the arm; hide them from telemetry and observables
        stale = outs.pop("stale_channels")
        if stale.any():
            outs["valid"] = outs["valid"] & ~stale[None, :]
            if "valid_full" in outs:
                outs["valid_full"] = outs["valid_full"] & ~stale[None, :]
        for c in range(spec.n_channels):
            rt.epoch_base[c] += n
        inc = [c for c in tracking if not stale[c]]
        rt.epochs_run[inc] += n
        if self.collected is not None:
            self.collected.append((spec.signal, outs))
        # a channel feeds OBSERVABLES only once its loops have settled after
        # (re)acquisition; telemetry sees every epoch.  Gating is
        # epoch-index exact, whatever the chunk sizes.
        settle = spec.trk.fll_pullin_epochs + 2500
        eb_settle = rt.epochs_run - n
        rows = outs.get("rows")
        if rows is None:
            # every epoch's planes (the full transfer): telemetry and
            # observables read the same rows
            tlm_res = rt.tlm.process(outs)
            tlm_obs = tlm_res
            rows = np.arange(outs["valid"].shape[0])
        else:
            # decimated transfer: telemetry sees the full-rate symbol
            # planes, observables the tick-rate planes
            tlm_in = {"prompt": outs["prompt"], "valid": outs["valid_full"]}
            if len(rows) and getattr(rt.tlm, "tow_map", None) is not None:
                # E6 stamps TOW per symbol epoch: the per-epoch sample
                # counter rebuilt from the decimated one
                tlm_in["sample_counter"] = _expand_sc(
                    outs["sample_counter"], rows, n, rt.nominal)
            tlm_res = rt.tlm.process(tlm_in)
            if len(rows) == 0:
                # tail chunk shorter than one tick stride: telemetry only
                for _, eph in tlm_res.new_ephemerides:
                    self._store_eph(rt, eph)
                return self._handle_lock_loss(rt, tracking), None
            tlm_obs = dataclasses.replace(
                tlm_res, tow_at_epoch_ms=tlm_res.tow_at_epoch_ms[rows],
                tow_valid=tlm_res.tow_valid[rows])
        gate = (rows[:, None] + eb_settle[None, :]) < settle
        if (gate & outs["valid"]).any():
            # gate a COPY for the observables push only: the cursor, tick
            # bound and Doppler map below keep the device's real validity
            outs = dict(outs, valid=outs["valid"] & ~gate,
                        valid_ungated=outs["valid"])
        for _, eph in tlm_res.new_ephemerides:
            self._store_eph(rt, eph)
        if (self.tow_map is not None and spec.system == "Galileo"
                and spec.signal != "E6"):
            # publish per-PRN TOW for the E6 channels (decimated rows
            # suffice: TOW is linear in the epoch index)
            tv = tlm_obs.tow_valid
            for c in np.flatnonzero(tv.any(axis=0)):
                e = int(np.flatnonzero(tv[:, c])[-1])
                self.tow_map.update(rt.tlm.prns[c],
                                    tlm_obs.tow_at_epoch_ms[e, c],
                                    outs["sample_counter"][e, c])
        self.obs_eng.push_epochs(outs, tlm_obs, channel_offset=rt.offset)
        self._tow_seen[rt.offset:rt.offset + spec.n_channels] |= \
            tlm_obs.tow_valid.any(axis=0)
        self._feed_iono(rt)
        # publish each tracked satellite's Doppler for the other bands'
        # assisted acquisitions
        valid_last = outs.get("valid_ungated", outs["valid"])[-1]
        dop_last = outs["carrier_doppler_hz"][-1]
        for c in tracking:
            if valid_last[c]:
                self.doppler_map[(spec.system, rt.mgr.channels[c].prn)] = (
                    float(dop_last[c]), spec.trk.carrier_freq_hz)
        if spec.signal == "S1" and self.sbas_corr is not None:
            self._feed_sbas(rt)
        if rt.pending_resets:
            for c, prn in rt.pending_resets:
                rt.tlm.reset_channel(c, prn, epoch_base=rt.epoch_base[c])
                self.obs_eng.reset_channel(rt.offset + c)
            rt.pending_resets = []
        # --- loss-of-lock events + TLM-timeout fail-safe -------------------
        quiet = self._handle_lock_loss(rt, tracking)
        if self.conf.tlm_timeout_s > 0:
            sc_last = outs["sample_counter"][-1]
            for c in tracking:
                g = rt.offset + c
                if (rt.mgr.channels[c].state == ChannelState.TRACKING
                        and not self._tow_seen[g]
                        and self._trk_start_abs[g] >= 0
                        and (sc_last[c] - self._trk_start_abs[g])
                        / self._chain_fs(rt) > self.conf.tlm_timeout_s):
                    quiet = False
                    rt.mgr.on_tracking_lost(c)
                    rt.trk.stop_channel(c)
        valid_cols = np.asarray(valid_last)
        if not valid_cols.any():
            return quiet, None
        up_to = int(outs["sample_counter"][-1][valid_cols].min())
        self.cursor = max(self.cursor,
                          self._to_primary(rt, up_to - rt.margin))
        return quiet, self._to_primary(rt, up_to)

    def _iterate(self, final: bool = True) -> bool:
        """One FSM + chunk iteration over every chain.  Returns False when
        nothing could advance (the caller waits for more data)."""
        tick_bounds = []
        progressed = False
        advanced = False
        quiet = True
        staged = []
        # ---- phase 1: per-chain FSM + device dispatch ----------------------
        # every chain's chunk is dispatched before any chunk is pulled
        for rt in self.chains:
            if rt.done >= rt.total:
                continue
            q, prog, adv, entry = self._dispatch(rt, final)
            quiet = q and quiet
            progressed = progressed or prog
            advanced = advanced or adv
            if entry is not None:
                staged.append(entry)

        # ---- phase 2: pull + host-process the chunks -----------------------
        # (pipelined: this iteration's go in flight and the PREVIOUS
        # iteration's are consumed)
        if self._pipeline or self._inflight:
            staged, self._inflight = self._inflight, staged
        for entry in staged:
            q, bound = self._consume(*entry)
            quiet = q and quiet
            if bound is not None:
                tick_bounds.append(bound)

        # --- observables + PVT ----------------------------------------------
        if tick_bounds:
            self._solve(min(tick_bounds))
        if not progressed and final:
            self.cursor += int(self.chunk_s * self.conf.fs)
            advanced = True
        self.chunk_mult = (min(self.chunk_mult * 2, self.max_mult)
                           if quiet else 1)
        return advanced

    def _feed_iono(self, rt) -> None:
        """The chain's decoded broadcast iono feeds the Klobuchar model, in
        place (gps_navigation_message iono -> rtklib ionocorr path): a
        PvtConf shared by several receivers carries it over, as in JAX."""
        iono = getattr(rt.tlm, "iono_utc", None)
        if iono and self.conf.pvt.iono_model == "Broadcast":
            self.conf.pvt.iono_alpha = tuple(
                iono.get(f"alpha{i}", 0.0) for i in range(4))
            self.conf.pvt.iono_beta = tuple(
                iono.get(f"beta{i}", 0.0) for i in range(4))

    def _feed_sbas(self, rt) -> None:
        """An S1 chain's new messages (CRC passed) into the correction
        state; MT9 GEO navigation published as the ("SBAS", prn)
        ephemeris, so the GEO ranges once its channel has TOW."""
        msgs = rt.tlm.messages
        for c, prn, ev in msgs[rt.sbas_consumed:]:
            if not ev.crc_ok:
                continue
            self.sbas_corr.push(ev)
            if ev.msg_type == 9:
                nav = rt.tlm.geo_nav(c)
                if nav is not None:
                    self.ephemerides[("SBAS", prn)] = SbasGeoEphemeris(
                        prn, nav)
        rt.sbas_consumed = len(msgs)

    def _store_eph(self, rt, eph) -> None:
        """Adopt a decoded ephemeris under the chain's key, resolving the
        10-bit GPS week (adjgpsweek + GNSS-SDR.pre_2009_file)."""
        if rt.spec.system == "GPS" and 0 <= eph.week <= 1023:
            eph = dataclasses.replace(eph, week=adj_gps_week(
                eph.week, self.conf.pre_2009_file))
        self.ephemerides[rt.eph_key(eph.prn)] = eph

    def _handle_lock_loss(self, rt, tracking) -> bool:
        quiet = True
        lost = rt.trk.lock_lost_host
        for c in tracking:
            if lost[c]:
                quiet = False
                rt.mgr.on_tracking_lost(c)
                rt.trk.stop_channel(c)
        return quiet

    def _solve(self, tick_bound: int) -> None:
        conf = self.conf
        prn_map, sys_map = _channel_maps(self.chains, self.n_total)
        for epoch in self.obs_eng.pull_ticks(tick_bound):
            self.obs_epochs.append(epoch)
            # pseudolite channel: feed AOWR, exclude from PVT
            excl = ()
            if self.aowr is not None:
                ps = conf.ps_channel
                excl = (ps,)
                if 0 <= ps < self.n_total and epoch.valid[ps]:
                    self.aowr.update(float(epoch.pseudorange_m[ps]),
                                     float(epoch.carrier_phase_cycles[ps]))
            # PVT solve cadence (PVT.output_rate_ms decimation)
            if conf.pvt_rate_ms and int(round(
                    epoch.rx_time_s * 1000.0)) % conf.pvt_rate_ms:
                continue
            # rx clock propagation after enough fixes: hold the clock at
            # the last bias + drift extrapolation
            fixed_clk = None
            if (conf.enable_rx_clock_propagation
                    and self.last_fix is not None
                    and self.n_fixes >= conf.clk_prop_after_n_fixes):
                dt = epoch.rx_time_s - self.last_fix_time
                fixed_clk = (self.last_fix.rx_clock_bias_s
                             + self.last_fix.rx_clock_drift_ss * dt)
            solver = solve_pvt_raim if conf.pvt.raim_fde else solve_pvt
            sol = solver(epoch, prn_map, self.ephemerides, conf.pvt,
                         x0=None if self.last_fix is None
                         else self.last_fix.rx_ecef_m,
                         systems=sys_map, carrier_freq_hz=self.freq_map,
                         exclude_channels=excl,
                         fixed_clock_bias_s=fixed_clk,
                         sbas_corrections=self.sbas_corr)
            if sol.valid:
                if self.pvt_kf is not None:
                    self.pvt_kf.update(sol)
                self.last_fix = sol
                self.last_fix_time = epoch.rx_time_s
                self.n_fixes += 1
                self.solutions.append(sol)
                if conf.share_rx_clock_bias:
                    # tag a GNSS channel's TOW and PRN, never the
                    # pseudolite's (the reference erases the ps channel
                    # from the observables map before write_rx_clock_bias,
                    # rtklib_pvt_gs.cc:2346)
                    cand = np.flatnonzero(epoch.valid)
                    cand = cand[~np.isin(cand, list(excl))]
                    ch0 = int(cand[0]) if cand.size else int(
                        np.flatnonzero(epoch.valid)[0])
                    self.rx_clock_bias_log.append(
                        (epoch.rx_time_s, epoch.interp_tow_ms[ch0] / 1000.0,
                         sol.rx_clock_bias_s, prn_map[ch0]))
                if self.aowr is not None and self.aowr.observed:
                    self.clock_differences.append(self.aowr.clock_products(
                        sol.rx_clock_bias_s, epoch.rx_time_s))
                # orbital EKF: seeded by the first fix, then a measurement
                # update at each fixed epoch
                if self.pvt_ekf is not None:
                    t_gps = epoch.rx_time_s - sol.rx_clock_bias_s
                    if not self.pvt_ekf.initialized:
                        self.pvt_ekf.init_from_fix(sol, t_gps)
                    elif self.pvt_ekf.update(epoch, prn_map, self.ephemerides,
                                             t_gps, systems=sys_map,
                                             carrier_freq_hz=self.freq_map):
                        pos, vel, bias, drift = self.pvt_ekf.state_ecef()
                        self.ekf_solutions.append(
                            (epoch.rx_time_s, pos, vel, bias, drift))
            # PPP: an undifferenced update every epoch once the first LS
            # fix has seeded it, on epochs whose LS fails too
            if self.ppp_eng is not None and (sol.valid
                                             or self.ppp_eng.x is not None):
                psol = self.ppp_eng.update(
                    epoch, prn_map, self.ephemerides, systems=sys_map,
                    carrier_freq_hz=self.freq_map,
                    x0=sol.rx_ecef_m if sol.valid else None)
                if psol.valid:
                    self.ppp_solutions.append((epoch.rx_time_s, psol))
            # RTK: pair with the base epoch and run the DD engine
            if self.rtk_eng is not None:
                base_ep = self.base_observations.aligned_to(
                    epoch.rx_time_s, prn_map, sys_map)
                if base_ep is not None:
                    rsol = self.rtk_eng.update(
                        epoch, base_ep, prn_map, self.ephemerides,
                        systems=sys_map, carrier_freq_hz=self.freq_map)
                    if rsol.valid:
                        self.rtk_solutions.append((epoch.rx_time_s, rsol))

    # -- output ----------------------------------------------------------------

    def result(self) -> ReceiverRun:
        track_outputs = None
        if self.collected:
            track_outputs = {}
            for sig in {s for s, _ in self.collected}:
                parts = [o for s, o in self.collected if s == sig]
                track_outputs[sig] = {k: np.concatenate([p[k] for p in parts])
                                      for k in parts[0]}
            if len(track_outputs) == 1:   # the single-chain shape
                track_outputs = next(iter(track_outputs.values()))
        prn_map, sys_map = _channel_maps(self.chains, self.n_total)
        states, events = [], []
        for rt in self.chains:
            states.extend(rt.mgr.channels[c].state
                          for c in range(rt.spec.n_channels))
            events.extend((rt.offset + c, ev) for c, ev in rt.mgr.events)
        return ReceiverRun(
            solutions=self.solutions,
            observation_epochs=self.obs_epochs,
            channel_prns=prn_map, channel_states=states,
            ephemerides=self.ephemerides, events=events,
            track_outputs=track_outputs, channel_systems=sys_map,
            has_messages=[m for rt in self.chains if rt.spec.signal == "E6"
                          for m in rt.tlm.has.messages],
            clock_differences=self.clock_differences,
            rx_clock_bias_log=self.rx_clock_bias_log,
            rtk_solutions=self.rtk_solutions,
            ekf_solutions=self.ekf_solutions,
            ppp_solutions=self.ppp_solutions,
            almanac=self.broadcast_almanac(),
            iono_utc=self.broadcast_iono_utc())


class Receiver:
    """The port's entry point.  `device=None` means the CUDA card and raises
    without one; pass device="cpu" for the plain versions of the kernels."""

    def __init__(self, conf: ReceiverConf, device=None):
        self.conf = conf
        self.device = resolve_device(device)

    def start_session(self, collect_track_outputs: bool = False,
                      ephemerides: dict | None = None,
                      base_observations=None) -> ReceiverSession:
        """A live session (see ReceiverSession); `ephemerides` preloads
        assistance for a warm start."""
        return ReceiverSession(self.conf, device=self.device,
                               collect_track_outputs=collect_track_outputs,
                               ephemerides=ephemerides,
                               base_observations=base_observations)

    def process_array(self, x, collect_track_outputs: bool = False,
                      ephemerides: dict | None = None,
                      base_observations=None) -> ReceiverRun:
        """Run the whole receiver over an in-memory capture on RF channel 0
        (NumPy complex64 array or tensor).  `ephemerides` preloads
        assistance (the reference's assisted start): PVT fixes as soon as
        TOW is decoded.  Ephemeris keys: PRN int for GPS, (system, prn)
        otherwise."""
        s = self.start_session(collect_track_outputs=collect_track_outputs,
                               ephemerides=ephemerides,
                               base_observations=base_observations)
        s.attach_array(x)
        s.run_to_end()
        return s.result()
