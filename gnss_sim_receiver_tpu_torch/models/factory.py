"""Block factory: reference configuration strings -> engine configuration.

PyTorch port of ``gnss_sim_receiver_tpu.models.factory`` for the GPS L1 C/A
("1C"), Galileo E1-B ("1B"), GPS L2C CM ("2S"), GPS L5I ("L5"), Galileo
E5a-I ("5X"), Galileo E5b-I ("7X"), Galileo E6-B ("E6"), GLONASS L1 and L2
C/A ("1G", "2G"), BeiDou B1I ("B1"), BeiDou B3I ("B3") and SBAS L1 ("S1")
chains (reference GNSSBlockFactory, src/core/receiver/gnss_block_factory.cc:
639-1335): maps the `Role.implementation` strings and per-role keys of a
GNSS-SDR conf file onto the port's engine confs.

The port carries every chain of the JAX factory, each on its own RF
channel and rate if the conf says so (a GLONASS signal as one chain per
FDMA slot, on the primary stream, as the JAX factory builds it), and a
subset of their options.  A conf key that selects something the port
lacks is never read and dropped: it raises NotImplementedError naming the
key, with the words "not ported".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants, signals
from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf
from gnss_sim_receiver_tpu_torch.models.observables import ObsConf
from gnss_sim_receiver_tpu_torch.models.pvt import PvtConf
from gnss_sim_receiver_tpu_torch.models.receiver import (
    Receiver, ReceiverConf, beidou_b1i_chain, beidou_b3i_chain,
    galileo_e1b_chain, galileo_e5a_chain, galileo_e5b_chain,
    galileo_e6b_chain, glonass_l1_chain, glonass_l2_chain, gps_l2c_chain,
    gps_l5_chain, sbas_l1_chain)
from gnss_sim_receiver_tpu_torch.models.rtk import RtkConf
from gnss_sim_receiver_tpu_torch.models.tracking import TrackingConf
from gnss_sim_receiver_tpu_torch.utils.config import Configuration

# accepted Role.implementation strings per ported signal, and the engine
# variant each acquisition string selects (gnss_block_factory.cc:652-1335)
_ACQ_IMPLS = {
    "1C": {"GPS_L1_CA_PCPS_Acquisition": "pcps",
           "GPS_L1_CA_PCPS_QuickSync_Acquisition": "quicksync",
           "GPS_L1_CA_PCPS_Tong_Acquisition": "tong",
           "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler": "fine_doppler"},
    "1B": {"Galileo_E1_PCPS_Ambiguous_Acquisition": "pcps",
           "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition": "cccwsr",
           "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition": "8ms"},
    "2S": {"GPS_L2_M_PCPS_Acquisition": "pcps"},
    "L5": {"GPS_L5i_PCPS_Acquisition": "pcps"},
    "5X": {"Galileo_E5a_Pcps_Acquisition": "pcps",
           "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF": "iq_caf"},
    "7X": {"Galileo_E5b_PCPS_Acquisition": "pcps"},
    "E6": {"Galileo_E6_PCPS_Acquisition": "pcps"},
    "1G": {"GLONASS_L1_CA_PCPS_Acquisition": "pcps"},
    "2G": {"GLONASS_L2_CA_PCPS_Acquisition": "pcps"},
    "B1": {"BEIDOU_B1I_PCPS_Acquisition": "pcps"},
    "B3": {"BEIDOU_B3I_PCPS_Acquisition": "pcps"},
    "S1": {"SBAS_L1_PCPS_Acquisition": "pcps",
           "GPS_L1_CA_PCPS_Acquisition": "pcps"},
}
_TRK_IMPLS = {
    "1C": ("GPS_L1_CA_DLL_PLL_Tracking", "GPS_L1_CA_KF_Tracking"),
    "1B": ("Galileo_E1_DLL_PLL_VEML_Tracking",),
    "2S": ("GPS_L2_M_DLL_PLL_Tracking",),
    "L5": ("GPS_L5_DLL_PLL_Tracking", "GPS_L5i_DLL_PLL_Tracking"),
    "5X": ("Galileo_E5a_DLL_PLL_Tracking",),
    "7X": ("Galileo_E5b_DLL_PLL_Tracking",),
    "E6": ("Galileo_E6_DLL_PLL_Tracking",),
    "1G": ("GLONASS_L1_CA_DLL_PLL_Tracking",),
    "2G": ("GLONASS_L2_CA_DLL_PLL_Tracking",),
    "B1": ("BEIDOU_B1I_DLL_PLL_Tracking",),
    "B3": ("BEIDOU_B3I_DLL_PLL_Tracking",),
    "S1": ("SBAS_L1_DLL_PLL_Tracking", "GPS_L1_CA_DLL_PLL_Tracking"),
}
_DEFAULT_ACQ = {"1C": "GPS_L1_CA_PCPS_Acquisition",
                "1B": "Galileo_E1_PCPS_Ambiguous_Acquisition",
                "2S": "GPS_L2_M_PCPS_Acquisition",
                "L5": "GPS_L5i_PCPS_Acquisition",
                "5X": "Galileo_E5a_Pcps_Acquisition",
                "7X": "Galileo_E5b_PCPS_Acquisition",
                "E6": "Galileo_E6_PCPS_Acquisition",
                "1G": "GLONASS_L1_CA_PCPS_Acquisition",
                "2G": "GLONASS_L2_CA_PCPS_Acquisition",
                "B1": "BEIDOU_B1I_PCPS_Acquisition",
                "B3": "BEIDOU_B3I_PCPS_Acquisition",
                "S1": "SBAS_L1_PCPS_Acquisition"}
# the chains beyond GPS L1 C/A, in the JAX factory's order (ALL_SIGNALS,
# factory.py:126), and their builders; Channel<i>.satellite
# pinning counts channels in this order; a GLONASS builder makes one chain
# of the slot it is given
_CHAIN_BUILDERS = {"1B": galileo_e1b_chain, "2S": gps_l2c_chain,
                   "L5": gps_l5_chain, "5X": galileo_e5a_chain,
                   "7X": galileo_e5b_chain, "E6": galileo_e6b_chain,
                   "1G": glonass_l1_chain, "2G": glonass_l2_chain,
                   "B1": beidou_b1i_chain, "B3": beidou_b3i_chain,
                   "S1": sbas_l1_chain}
# the FDMA slot spacing of each GLONASS signal
_GLONASS_DFREQ = {"1G": constants.GLONASS_L1_DFREQ_HZ,
                  "2G": constants.GLONASS_L2_DFREQ_HZ}
# the JAX factory's modes (factory.py:363-367); DGPS parses and the receiver
# refuses it, as JAX's does
_PVT_MODES = ("Single", "Static", "Kinematic", "DGPS", "PPP_Static",
              "PPP_Kinematic", "RTK_Static", "RTK_Kinematic")


def _not_ported(key: str, value):
    return NotImplementedError(f"{key}={value}: not ported")


@dataclasses.dataclass
class SourceSpec:
    implementation: str
    filename: str
    item_type: str
    sampling_frequency: float
    samples: int


def source_from_config(config: Configuration) -> SourceSpec:
    return SourceSpec(
        implementation=config.property("SignalSource.implementation",
                                       "File_Signal_Source"),
        filename=config.property("SignalSource.filename", ""),
        item_type=config.property("SignalSource.item_type", "gr_complex"),
        sampling_frequency=float(
            config.property("SignalSource.sampling_frequency", 0)),
        samples=config.property("SignalSource.samples", 0),
    )


def _variant(config: Configuration, sig: str) -> str:
    """The acquisition variant of the chain's implementation string; any
    other string is refused."""
    key = f"Acquisition_{sig}.implementation"
    impl = config.property(key, _DEFAULT_ACQ[sig])
    if impl not in _ACQ_IMPLS[sig]:
        raise _not_ported(key, impl)
    return _ACQ_IMPLS[sig][impl]


def _acq_from_config(config: Configuration, sig: str,
                     base: AcqConf) -> AcqConf:
    """Acquisition_<sig>.* keys -> AcqConf (the reference adapters'
    Acq_Conf fill, e.g. gps_l1_ca_pcps_acquisition.cc)."""
    variant = _variant(config, sig)
    p = f"Acquisition_{sig}."
    # E5a CAF Doppler smoothing window (total Hz -> boxcar half-width in
    # bins; galileo_e5a_noncoherent_iq_acquisition_caf_cc CAF_window_hz,
    # the JAX factory's factory.py:183-187)
    caf_hz = float(config.property(p + "CAF_window_hz", 0.0))
    dstep = float(config.property(p + "doppler_step", base.doppler_step))
    caf_bins = int(caf_hz / (2.0 * dstep)) if caf_hz > 0 else 0
    return dataclasses.replace(
        base,
        doppler_max=float(config.property(p + "doppler_max",
                                          base.doppler_max)),
        doppler_step=float(config.property(p + "doppler_step",
                                           base.doppler_step)),
        sampled_ms=config.property(p + "coherent_integration_time_ms",
                                   base.sampled_ms),
        max_dwells=max(config.property(p + "max_dwells", base.max_dwells),
                       1),
        pfa=config.property(p + "pfa", base.pfa),
        threshold=config.property(p + "threshold", base.threshold),
        use_cfar_algorithm=config.property(p + "use_CFAR_algorithm",
                                           base.use_cfar_algorithm),
        make_two_steps=config.property(p + "make_two_steps",
                                       base.make_two_steps),
        doppler_step2=float(config.property(p + "second_doppler_step",
                                            base.doppler_step2)),
        num_doppler_bins_step2=config.property(
            p + "second_nbins", base.num_doppler_bins_step2),
        variant=variant,
        caf_bins=caf_bins,
        bit_transition_flag=config.property(p + "bit_transition_flag",
                                            base.bit_transition_flag),
        # the variants' own keys, read with the JAX factory's defaults
        # (factory.py:212-215)
        tong_init=config.property(p + "tong_init_val", 1),
        tong_max=config.property(p + "tong_max_val", 2),
        tong_max_dwells=config.property(p + "tong_max_dwells", 10),
        quicksync_fold=config.property(p + "folding_factor", 4),
    )


def _trk_from_config(config: Configuration, sig: str,
                     base: TrackingConf) -> TrackingConf:
    """Tracking_<sig>.* keys -> TrackingConf (the reference adapters'
    Dll_Pll_Conf fill, dll_pll_conf.h:42-80)."""
    p = f"Tracking_{sig}."
    impl = config.property(p + "implementation", _TRK_IMPLS[sig][0])
    if impl not in _TRK_IMPLS[sig]:
        raise _not_ported(p + "implementation", impl)
    # spacing keys are in chips; the sub-chip engines of E1 (BOC) scale x2
    sc = 2.0 if sig == "1B" else 1.0
    return dataclasses.replace(
        base,
        # the KF tracking block selects the Kalman tracker (JAX
        # factory.py:231-232)
        tracking_mode=("kf" if impl.endswith("KF_Tracking")
                       else base.tracking_mode),
        pll_bw_hz=config.property(p + "pll_bw_hz", base.pll_bw_hz),
        dll_bw_hz=config.property(p + "dll_bw_hz", base.dll_bw_hz),
        pll_filter_order=config.property(p + "order",
                                         base.pll_filter_order),
        enable_fll_pullin=config.property(p + "enable_fll_pullin",
                                          base.enable_fll_pullin),
        fll_bw_hz=config.property(p + "fll_bw_hz", base.fll_bw_hz),
        early_late_space_chips=sc * config.property(
            p + "early_late_space_chips", base.early_late_space_chips / sc),
        very_early_late_space_chips=sc * config.property(
            p + "very_early_late_space_chips",
            base.very_early_late_space_chips / sc),
        cn0_min_db_hz=config.property(p + "cn0_min", base.cn0_min_db_hz),
        max_lock_fail=config.property(p + "max_lock_fail",
                                      base.max_lock_fail),
        extend_correlation_symbols=config.property(
            p + "extend_correlation_symbols",
            base.extend_correlation_symbols),
        pll_bw_narrow_hz=config.property(p + "pll_bw_narrow_hz",
                                         base.pll_bw_narrow_hz),
        dll_bw_narrow_hz=config.property(p + "dll_bw_narrow_hz",
                                         base.dll_bw_narrow_hz),
    )


def _pinned_channels(config: Configuration, offset: int, count: int) -> dict:
    """Channel<i>.satellite pinning for the chain occupying global channel
    indexes [offset, offset+count) (assign_channels,
    gnss_flowgraph.cc:1391-1415)."""
    pinned = {}
    for i in range(count):
        sat = config.property(f"Channel{offset + i}.satellite", 0)
        if sat:
            pinned[i] = sat
    return pinned


def pvt_conf_from_config(config: Configuration) -> PvtConf:
    """PVT solver keys (the rtklib_pvt adapter's conf fill,
    rtklib_pvt.cc:78-917, the solver-behavior subset)."""
    mode = config.property("PVT.positioning_mode", "Single")
    if mode not in _PVT_MODES:
        raise _not_ported("PVT.positioning_mode", mode)
    return PvtConf(
        positioning_mode=mode,
        elevation_mask_deg=config.property("PVT.elevation_mask", 5.0),
        max_gdop=config.property("PVT.threshold_reject_GDOP", 30.0),
        iono_model=config.property("PVT.iono_model", "OFF"),
        trop_model=config.property("PVT.trop_model", "OFF"),
        raim_fde=config.property("PVT.raim_fde", False),
        raim_threshold_m=config.property("PVT.raim_threshold_m", 30.0),
        # fork receiver-antenna attitude (rtklib_pvt.cc:92-94)
        antenna_attitude_fix=config.property(
            "ReceiverAntennaAttitude.fix", True),
        antenna_az_rad=np.radians(config.property(
            "ReceiverAntennaAttitude.az_deg", 0.0)),
        antenna_el_rad=np.radians(config.property(
            "ReceiverAntennaAttitude.el_deg", 90.0)),
    )


def rtk_conf_from_config(config: Configuration) -> RtkConf:
    """RTK relative-positioning keys (rtklib_pvt.cc prcopt fill: AR ratio,
    measurement sigmas) for PVT.positioning_mode = RTK_Static or
    RTK_Kinematic; the base station's observables come apart (a RINEX obs
    file or an RTCM stream)."""
    mode = config.property("PVT.positioning_mode", "Single")
    return RtkConf(
        mode="kinematic" if mode == "RTK_Kinematic" else "static",
        elevation_mask_deg=config.property("PVT.elevation_mask", 10.0),
        code_sigma_m=config.property("PVT.code_sigma_m", 0.5),
        carrier_sigma_m=config.property("PVT.carrier_sigma_m", 0.003),
        ratio_threshold=config.property("PVT.AR_ratio_threshold", 3.0),
    )


def _glonass_chains(config: Configuration, sig: str, fs: float, n: int,
                    offset: int) -> list:
    """The GLONASS chains of `sig` ("1G" or "2G"): one per occupied FDMA
    slot in sorted slot order (the PRN -> slot table,
    GLONASS_L1_L2_CA.h:134), until `n` channels are used, each on the
    primary stream at `fs` with its acquisition centred on the slot's
    offset (pcps_acquisition.cc:211-230 d_doppler_bias; the JAX factory,
    factory.py:293-321).  `offset` is the global index of the first
    channel, for Channel<i>.satellite pinning."""
    by_slot: dict[int, list[int]] = {}
    for prn in range(1, 25):
        k = constants.GLONASS_PRN_SLOT.get(prn)
        if k is not None:
            by_slot.setdefault(k, []).append(prn)
    chains = []
    for k in sorted(by_slot):
        if n <= 0:
            break
        nc = min(len(by_slot[k]), n)
        chain = _CHAIN_BUILDERS[sig](fs, prns=by_slot[k], freq_slot=k,
                                     n_channels=nc)
        chain.acq = dataclasses.replace(
            _acq_from_config(config, sig, chain.acq),
            doppler_center=k * _GLONASS_DFREQ[sig])
        chain.trk = _trk_from_config(config, sig, chain.trk)
        chain.pinned = _pinned_channels(config, offset, nc)
        offset += nc
        n -= nc
        chains.append(chain)
    return chains


def chains_from_config(config: Configuration) -> list:
    """The chains beyond GPS L1 C/A that Channels_<sig>.count configures,
    in the JAX factory's order: the Galileo E1-B data chain ("1B"), GPS L2C
    CM ("2S"), GPS L5I ("L5"), Galileo E5a-I ("5X"), Galileo E5b-I ("7X"),
    Galileo E6-B ("E6"), GLONASS L1 and L2 C/A ("1G", "2G", one chain per
    FDMA slot, :func:`_glonass_chains`), BeiDou B1I ("B1"), BeiDou B3I
    ("B3") and SBAS L1 ("S1").

    Multi-band keys: ``Channels_<sig>.RF_channel_ID`` selects the RF
    channel whose stream the chain reads (gnss_flowgraph.cc:1018-1019),
    ``SignalSource.sample_rate_rf<id>`` that RF channel's rate (default
    internal_fs_sps), at which the chain is built.
    ``GNSS-SDR.use_acquisition_resampler`` is read as the JAX factory reads
    it: its decimation applies to a "1C" entry of the loop over the chains
    beyond GPS L1 C/A, which never comes, so it changes nothing
    (factory.py:346-352)."""
    fs = float(config.property("GNSS-SDR.internal_fs_sps", 2_000_000))
    in_acq = config.property("Channels.in_acquisition", 0)
    chains = []
    offset = config.property("Channels_1C.count", 0)
    for sig, builder in _CHAIN_BUILDERS.items():
        n = config.property(f"Channels_{sig}.count", 0)
        if n <= 0:
            continue
        if sig in _GLONASS_DFREQ:
            slot_chains = _glonass_chains(config, sig, fs, n, offset)
            offset += sum(c.n_channels for c in slot_chains)
            chains.extend(slot_chains)
            continue
        rf_id = int(config.property(f"Channels_{sig}.RF_channel_ID", 0))
        rf_fs = float(config.property(f"SignalSource.sample_rate_rf{rf_id}",
                                      fs))
        chain = builder(rf_fs, n_channels=n)
        chain.rf_channel_id = rf_id
        if in_acq:
            chain.max_acq_channels = min(in_acq, n)
        chain.acq = _acq_from_config(config, sig, chain.acq)
        chain.trk = _trk_from_config(config, sig, chain.trk)
        if chain.acq.variant in ("cccwsr", "iq_caf"):
            # the second replica family: the E1-C pilot for CCCWSR on the
            # data-only E1 chain (the combining grid is symmetric in
            # data/pilot, so the slot order is free), E5a-Q for the I/Q
            # search (the JAX factory, factory.py:331-345)
            chain.data_code_provider = signals.CodeProvider(
                sig, signals.PILOT_COMPONENT[sig])
        chain.pinned = _pinned_channels(config, offset, n)
        offset += n
        chains.append(chain)
    return chains


def receiver_conf_from_config(config: Configuration) -> ReceiverConf:
    """Build the receiver configuration from reference-style keys for the
    GPS L1 C/A chain and the Galileo E1-B, GPS L2C CM, GPS L5I, Galileo
    E5a-I, Galileo E5b-I, Galileo E6-B, GLONASS L1/L2 C/A, BeiDou B1I,
    BeiDou B3I and SBAS L1 chains."""
    fs = float(config.property("GNSS-SDR.internal_fs_sps", 2_000_000))
    chains = chains_from_config(config)

    # GPS L1 C/A is the reference's default chain: 8 channels when nothing
    # else is configured, else exactly what Channels_1C.count says
    n_1c = config.property("Channels_1C.count", 0 if chains else 8)
    if n_1c < 1 and not chains:
        raise ValueError("receiver configured with no signal chains")
    acq = _acq_from_config(
        config, "1C", AcqConf(fs_in=fs, doppler_max=5000, doppler_step=250,
                              sampled_ms=1, max_dwells=2, pfa=0.01))
    trk = _trk_from_config(config, "1C", TrackingConf(fs=fs))
    interval_ms = config.property("Observables.observable_interval_ms", 20)
    obs = ObsConf(fs=fs, interval_ms=interval_ms,
                  smoothing_factor=config.property(
                      "Observables.smoothing_factor", 0))
    pvt = pvt_conf_from_config(config)
    rtk = rtk_base = None
    if pvt.positioning_mode.startswith("RTK"):
        rtk = rtk_conf_from_config(config)
        base_str = config.property("PVT.rtk_base_position_ecef", "")
        if base_str:
            rtk_base = tuple(float(v) for v in base_str.split(","))
    in_acq = config.property("Channels.in_acquisition", 0)
    # multi-band: the per-RF-channel rates gathered from the chains
    rf_fs = {c.rf_channel_id: float(c.trk.fs) for c in chains
             if c.rf_channel_id != 0}
    return ReceiverConf(
        rf_fs=rf_fs,
        rtk=rtk, rtk_base_ecef_m=rtk_base,
        pinned_channels=_pinned_channels(config, 0, n_1c),
        fs=fs, prns=tuple(range(1, 33)), max_channels=max(n_1c, 1),
        max_acq_channels=(min(in_acq, n_1c) if in_acq and n_1c
                          else max(n_1c, 1)),
        acq=acq, trk=trk, obs=obs, pvt=pvt,
        output_rate_ms=interval_ms,
        pvt_rate_ms=config.property("PVT.output_rate_ms", 0),
        enable_pvt_kf=config.property("PVT.enable_pvt_kf", False),
        chains=tuple(chains), gps_chain=n_1c > 0,
        # fork hybrid/pseudolite + rx clock keys (rtklib_pvt.cc:910-917,
        # conf/gnss-sdr_GPS_L1_bladeRF2_micro_hybrid_nav.conf); the ps
        # channel's Channel<i>.satellite pinning rides in pinned_channels
        hybrid_mode=config.property("GNSS-SDR.hybrid_mode", False),
        pre_2009_file=config.property("GNSS-SDR.pre_2009_file", False),
        ps_channel=config.property("GNSS-SDR.pseudo_sat_ch_id", -1),
        enable_rx_clock_propagation=config.property(
            "PVT.enable_rx_clock_propagation", False),
        share_rx_clock_bias=config.property("PVT.share_rx_clock_bias",
                                            False),
    )


def make_receiver(config: Configuration, device=None) -> Receiver:
    """The receiver a conf file describes.  `device=None` means the CUDA
    card and raises without one."""
    return Receiver(receiver_conf_from_config(config), device=device)
