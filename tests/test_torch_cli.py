"""The port's factory and CLI against the JAX package's: one conf text
builds both receiver configurations, which must agree field by field; conf
keys for what the port lacks are refused by name; and
``python -m gnss_sim_receiver_tpu_torch --config_file=... --device=cpu``
runs a 4 Msps ishort capture through the conditioner and the receiver as
``python -m gnss_sim_receiver_tpu`` does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.__main__ import main as jax_main
from gnss_sim_receiver_tpu.models import factory as jfactory
from gnss_sim_receiver_tpu.utils.config import \
    FileConfiguration as JaxFileConfiguration
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.__main__ import main, run_cli, unported_key
from gnss_sim_receiver_tpu_torch.models import factory
from gnss_sim_receiver_tpu_torch.utils.config import (FileConfiguration,
                                                      InMemoryConfiguration)
from gnss_sim_receiver_tpu_torch.utils.sample_io import (quantize_interleaved,
                                                         read_samples,
                                                         write_samples)
from tests.fixtures import static_scenario_capture
from tests.test_hybrid_position import hybrid_capture  # noqa: F401

# the canonical operating point: a 4 Msps ishort file decimated x2 inside
# the receiver, 8 channels, two-step acquisition
CONF = """\
GNSS-SDR.internal_fs_sps=2000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={filename}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=4000000
SignalConditioner.implementation=Signal_Conditioner
DataTypeAdapter.implementation=Ishort_To_Complex
InputFilter.implementation=Freq_Xlating_Fir_Filter
InputFilter.number_of_taps=31
InputFilter.cutoff=0.45
InputFilter.decimation_factor=2
InputFilter.IF=0
Resampler.implementation=Pass_Through
Channels_1C.count=8
Channels.in_acquisition=8
Channel.signal=1C
Channel3.satellite=9
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.coherent_integration_time_ms=1
Acquisition_1C.pfa=0.01
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Acquisition_1C.max_dwells=2
Acquisition_1C.make_two_steps=true
Acquisition_1C.second_nbins=4
Acquisition_1C.second_doppler_step=125
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Tracking_1C.pll_bw_hz=35.0
Tracking_1C.dll_bw_hz=2.0
TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


# the hybrid operating point (the reference's gnss-sdr_Hybrid_byte.conf as
# tests/test_cli.py:78-95 records it: 10 + 10 channels, E1 Doppler step
# 125 Hz, PLL 15 Hz, very-early-late 0.6 chips) at 4 Msps, with CCCWSR
# acquisition on the Galileo E1-B chain, every PRN unpinned
HYBRID_CONF = """\
GNSS-SDR.internal_fs_sps=4000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={filename}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=4000000
Channels_1C.count=10
Channels_1B.count=10
Channels.in_acquisition=20
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Acquisition_1B.implementation=Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition
Acquisition_1B.doppler_step=125
Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking
Tracking_1B.very_early_late_space_chips=0.6
Tracking_1B.pll_bw_hz=15
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
"""


def _write_conf(tmp_path, text, name="rx.conf"):
    path = tmp_path / name
    path.write_text(text)
    return path


def test_factory_matches_jax_field_by_field(tmp_path):
    path = _write_conf(tmp_path, CONF.format(filename="cap.ishort"))
    ref = jfactory.receiver_conf_from_config(JaxFileConfiguration(path))
    got = factory.receiver_conf_from_config(FileConfiguration(path))
    # the JAX conf as a plain dict of its dataclass fields, turned into the
    # port's: every field the port has must agree, and every field it lacks
    # must hold the value under which both compute the same thing
    want = interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got == want
    for name in ("acq", "trk", "obs", "pvt"):
        for f in dataclasses.fields(getattr(got, name)):
            assert getattr(getattr(got, name), f.name) == \
                getattr(getattr(ref, name), f.name), (name, f.name)
    assert got.acq.make_two_steps and got.acq.doppler_step2 == 125.0
    assert got.acq.num_doppler_bins_step2 == 4
    assert got.max_channels == 8 and got.max_acq_channels == 8
    assert got.pinned_channels == {3: 9} == ref.pinned_channels
    assert got.pvt_rate_ms == 20 == ref.pvt_rate_ms
    assert got.prns == tuple(range(1, 33))
    src = factory.source_from_config(FileConfiguration(path))
    ref_src = jfactory.source_from_config(JaxFileConfiguration(path))
    for f in dataclasses.fields(src):
        assert getattr(src, f.name) == getattr(ref_src, f.name)
    assert src.item_type == "ishort" and src.sampling_frequency == 4e6


@pytest.mark.parametrize("impl,variant", [
    ("Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition", "cccwsr"),
    ("Galileo_E1_PCPS_8ms_Ambiguous_Acquisition", "8ms"),
    ("Galileo_E1_PCPS_Ambiguous_Acquisition", "pcps")])
def test_factory_matches_jax_on_the_hybrid_conf(tmp_path, impl, variant):
    """Both chains from one hybrid conf text, field by field: the E1
    chain's acquisition variant, its second replica family, the spacings
    scaled to sub-chips (0.6 chips very-early-late -> 1.2)."""
    text = HYBRID_CONF.format(filename="cap.ishort").replace(
        "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition", impl)
    path = _write_conf(tmp_path, text)
    ref = jfactory.receiver_conf_from_config(JaxFileConfiguration(path))
    got = factory.receiver_conf_from_config(FileConfiguration(path))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got.gps_chain and ref.gps_chain and got.max_channels == 10
    (chain,), (ref_chain,) = got.chains, ref.chains
    assert (chain.signal, chain.system, chain.n_channels, chain.prns) == (
        ref_chain.signal, ref_chain.system, ref_chain.n_channels,
        ref_chain.prns) == ("1B", "Galileo", 10, tuple(range(1, 37)))
    for name in ("acq", "trk"):
        for f in dataclasses.fields(getattr(chain, name)):
            assert getattr(getattr(chain, name), f.name) == \
                getattr(getattr(ref_chain, name), f.name), (name, f.name)
    assert chain.acq.variant == variant and chain.acq.doppler_step == 125.0
    assert chain.trk.very_early_late_space_chips == pytest.approx(1.2)
    assert chain.trk.early_late_space_chips == 0.5
    assert chain.trk.pll_bw_hz == 15.0 and chain.trk.fll_decision_directed
    assert (chain.data_code_provider is None) == \
        (ref_chain.data_code_provider is None) == (variant != "cccwsr")
    assert chain.sc_rate == ref_chain.sc_rate == 2.046e6
    assert got.pvt_rate_ms == 20 == ref.pvt_rate_ms
    # 10 + 10 global channels, the E1 chain's pinning offset past 1C's
    assert sum(c.n_channels for c in got.all_chains()) == 20


@pytest.mark.parametrize("line", [
    "Acquisition_1B.implementation=Galileo_E1_PCPS_QuickSync_Acquisition",
    "Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking_Fpga",
    "Acquisition_1B.use_CFAR_algorithm=false",
    "Channels_1B.RF_channel_ID=1",
])
def test_factory_refuses_unported_e1_keys(tmp_path, line):
    """The E1 chain's keys for what the port lacks, by name; a key the port
    has since taken up (PORTED_KEYS) builds the JAX factory's
    configuration instead."""
    path = _write_conf(tmp_path, "Channels_1B.count=2\n" + line + "\n",
                       "bad.conf")
    if line in PORTED_KEYS:
        _check_ported_key(path, line)
        return
    with pytest.raises(NotImplementedError, match="not ported") as err:
        factory.receiver_conf_from_config(FileConfiguration(path))
    assert line.split("=")[0] in str(err.value)


# keys these refusal tests once listed, now ported (the first-vs-second-
# peak statistic and the fixed threshold; the fork's hybrid pseudolite
# navigation, its rx clock keys and the pre-2009 week; the L2C, E5b, B1I,
# B3I, E6-B and GLONASS chains; the broadcast iono model, RAIM and the PVT
# Kalman filter; the RTK and PPP modes), and the field each sets: its chain's AcqConf's or
# TrackingConf's, the PvtConf's, or the ReceiverConf's
PORTED_KEYS = {"Acquisition_1B.use_CFAR_algorithm=false":
               ("use_cfar_algorithm", False),
               "Acquisition_1C.use_CFAR_algorithm=false":
               ("use_cfar_algorithm", False),
               "Acquisition_1C.pfa=0": ("pfa", 0),
               "GNSS-SDR.hybrid_mode=true": ("hybrid_mode", True),
               "GNSS-SDR.pseudo_sat_ch_id=3": ("ps_channel", 3),
               "GNSS-SDR.pre_2009_file=true": ("pre_2009_file", True),
               "PVT.enable_rx_clock_propagation=true":
               ("enable_rx_clock_propagation", True),
               "PVT.share_rx_clock_bias=true": ("share_rx_clock_bias", True),
               # the multi-band front end: a chain's RF channel, and the
               # acquisition resampler key, which sets no field in either
               # package (the JAX factory applies it to no chain)
               "Channels_1B.RF_channel_ID=1": ("rf_channel_id", 1),
               "GNSS-SDR.use_acquisition_resampler=true": None,
               # the Kalman tracker and the second-order PLL: their chain's
               # TrackingConf's field
               "Tracking_1C.implementation=GPS_L1_CA_KF_Tracking":
               ("tracking_mode", "kf"),
               "Tracking_1C.order=2": ("pll_filter_order", 2),
               # the GPS L2C CM, Galileo E5b-I, BeiDou B1I and B3I chains:
               # the chain's channel count
               "Channels_7X.count=4": ("n_channels", 4),
               "Channels_2S.count=2": ("n_channels", 2),
               "Channels_B1.count=3": ("n_channels", 3),
               "Channels_B3.count=2": ("n_channels", 2),
               # the Galileo E6-B chain; the GLONASS groups' first slot
               # chain (slot -7, PRNs 10 and 14, filled first)
               "Channels_E6.count=3": ("n_channels", 3),
               "Channels_1G.count=2": ("n_channels", 2),
               "Channels_2G.count=1": ("n_channels", 1),
               # the PVT modes: the PvtConf's fields, and the
               # ReceiverConf's for the filter
               "PVT.iono_model=Broadcast": ("iono_model", "Broadcast"),
               "PVT.raim_fde=true": ("raim_fde", True),
               "PVT.enable_pvt_kf=true": ("enable_pvt_kf", True),
               # the PVT modes beyond the single-point fix: the PvtConf's
               # mode (RTK's engine conf rides in the ReceiverConf)
               "PVT.positioning_mode=RTK_Static":
               ("positioning_mode", "RTK_Static"),
               "PVT.positioning_mode=PPP_Static":
               ("positioning_mode", "PPP_Static")}


def _check_ported_key(path, line):
    """The conf at `path` builds, in both packages, the same configuration,
    the key's value in its field: a Tracking_ key's in its chain's
    TrackingConf, a PVT. key's in the PvtConf, else the ReceiverConf's,
    else its chain's, else its chain's AcqConf's.  A key that sets no field
    (None) is checked by the equality alone."""
    ref = jfactory.receiver_conf_from_config(JaxFileConfiguration(path))
    got = factory.receiver_conf_from_config(FileConfiguration(path))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    if PORTED_KEYS[line] is None:
        return
    field, value = PORTED_KEYS[line]
    if line.startswith("Tracking_"):
        trk = got.trk if "_1C." in line else got.chains[0].trk
        assert getattr(trk, field) == value
        return
    if line.startswith("PVT.") and hasattr(got.pvt, field):
        assert getattr(got.pvt, field) == value
        return
    if hasattr(got, field):
        assert getattr(got, field) == value
        return
    if "_1C." not in line and hasattr(got.chains[0], field):
        assert getattr(got.chains[0], field) == value
        return
    acq = got.acq if "_1C." in line else got.chains[0].acq
    assert getattr(acq, field) == value


@pytest.mark.parametrize("line", [
    "Tracking_1B.extend_correlation_symbols=4",
    "Tracking_1C.extend_correlation_symbols=20",
])
def test_factory_maps_extend_correlation_symbols_like_jax(tmp_path, line):
    """Tracking_<sig>.extend_correlation_symbols reaches the chain's
    TrackingConf as the JAX factory puts it there (factory.py:246-252); the
    whole configuration agrees field by field."""
    path = _write_conf(tmp_path, "Channels_1B.count=2\n" + line + "\n",
                       "ext.conf")
    ref = jfactory.receiver_conf_from_config(JaxFileConfiguration(path))
    got = factory.receiver_conf_from_config(FileConfiguration(path))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    value = int(line.split("=")[1])
    sig = line.split("_")[1].split(".")[0]
    (chain,), (ref_chain,) = got.chains, ref.chains
    trk, ref_trk = ((got.trk, ref.trk) if sig == "1C"
                    else (chain.trk, ref_chain.trk))
    assert trk.extend_correlation_symbols == \
        ref_trk.extend_correlation_symbols == value


@pytest.mark.parametrize("ext", [1, 5])
def test_e1_pilot_chain_like_jax_or_not_ported(ext):
    """galileo_e1b_chain(track_pilot=True) builds the JAX chain's
    configuration (pilot code, CS25, the data code beside) at
    extend_correlation_symbols 5 and at 1, which both packages close on
    the block kernels' pilot form; nothing of it is refused any more."""
    from gnss_sim_receiver_tpu import signals as jsig
    from gnss_sim_receiver_tpu.models import receiver as jrx
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import receiver as prx
    kw = dict(n_channels=3, track_pilot=True, extend_correlation_symbols=ext)
    ref = jrx.ReceiverConf(fs=4e6, gps_chain=False,
                           chains=(jrx.galileo_e1b_chain(4e6, **kw),))
    got = prx.ReceiverConf(fs=4e6, gps_chain=False,
                           chains=(prx.galileo_e1b_chain(4e6, **kw),))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    (chain,), (ref_chain,) = got.chains, ref.chains
    assert chain.trk.track_pilot and chain.trk.secondary_code == \
        ref_chain.trk.secondary_code and len(chain.trk.secondary_code) == 25
    for mine, theirs in ((chain.code_provider, ref_chain.code_provider),
                         (chain.data_code_provider,
                          ref_chain.data_code_provider)):
        assert np.array_equal(mine(12), theirs(12))
    assert chain.code_provider == signals.CodeProvider("1B", "C")
    assert np.array_equal(chain.data_code_provider(12),
                          jsig.subchip_table(jsig.GALILEO_E1B, 12))


def test_factory_defaults_match_jax():
    from gnss_sim_receiver_tpu.utils.config import \
        InMemoryConfiguration as JaxInMemory
    ref = jfactory.receiver_conf_from_config(JaxInMemory())
    got = factory.receiver_conf_from_config(InMemoryConfiguration())
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got.max_channels == 8 and not got.acq.make_two_steps


@pytest.mark.parametrize("line", [
    "Acquisition_1C.implementation=Exotic_Acq",
    "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition_Fpga",
    "Acquisition_1C.use_CFAR_algorithm=false",
    "PVT.share_rx_clock_bias=true",
    "Acquisition_1C.pfa=0",
    "Tracking_1C.implementation=GPS_L1_CA_KF_Tracking",
    "Tracking_1C.order=2",
    "Channels_7X.count=4",
    "Channels_2S.count=2",
    "Channels_B1.count=3",
    "Channels_B3.count=2",
    "Channels_E6.count=3",
    "Channels_1G.count=2",
    "Channels_2G.count=1",
    "PVT.positioning_mode=RTK_Static",
    "PVT.positioning_mode=PPP_Static",
    "PVT.iono_model=Broadcast",
    "PVT.raim_fde=true",
    "PVT.enable_pvt_kf=true",
    "GNSS-SDR.hybrid_mode=true",
    "GNSS-SDR.pseudo_sat_ch_id=3",
    "GNSS-SDR.pre_2009_file=true",
    "PVT.enable_rx_clock_propagation=true",
    "GNSS-SDR.use_acquisition_resampler=true",
])
def test_factory_refuses_unported_keys(tmp_path, line):
    """A key that selects what the port lacks raises NotImplementedError
    naming the key, with the words "not ported"; the key is never read and
    dropped.  A key the port has since taken up (PORTED_KEYS) builds the
    JAX factory's configuration instead."""
    path = _write_conf(tmp_path, line + "\n", "bad.conf")
    if line in PORTED_KEYS:
        _check_ported_key(path, line)
        return
    key = line.split("=")[0]
    with pytest.raises(NotImplementedError, match="not ported") as err:
        factory.receiver_conf_from_config(FileConfiguration(path))
    assert key in str(err.value)


def test_interop_refuses_fields_the_port_lacks():
    from gnss_sim_receiver_tpu.models.acquisition import AcqConf
    from gnss_sim_receiver_tpu.models.receiver import ReceiverConf
    ref = ReceiverConf(acq=AcqConf(variant="assisted"))
    with pytest.raises(NotImplementedError, match="acq.variant"):
        interop.receiver_conf_from_fields(dataclasses.asdict(ref))


@pytest.mark.parametrize("line,key", [
    ("PVT.flag_kml=true", "PVT.flag_kml"),
    ("PVT.rinex_output_enabled=true", "PVT.rinex_output_enabled"),
    ("PVT.nmea_dump_filename=out.nmea", "PVT.nmea_dump_filename"),
    ("Monitor.enable_monitor=true", "Monitor.enable_monitor"),
    ("GNSS-SDR.SUPL_gps_enabled=true", "GNSS-SDR.SUPL_gps_enabled"),
    ("SignalSource.implementation=File_Timestamp_Signal_Source",
     "SignalSource.implementation"),
    ("SignalSource.implementation=Labsat_Signal_Source",
     "SignalSource.implementation"),
    ("PVT.gpx_output_enabled=true", "PVT.gpx_output_enabled"),
])
def test_cli_stops_on_unported_features(tmp_path, capsys, line, key):
    """Exit code 2 and a message naming the key, before any file is read."""
    path = _write_conf(tmp_path, CONF.format(filename="absent.ishort")
                       + line + "\n")
    assert main([f"--config_file={path}", "--device=cpu"]) == 2
    err = capsys.readouterr().err
    assert key in err and "not ported" in err


def test_cli_refuses_the_log_flags(tmp_path):
    path = _write_conf(tmp_path, CONF.format(filename="absent.ishort"))
    with pytest.raises(SystemExit) as err:
        main([f"--config_file={path}", "--device=cpu", "--log_dir=/tmp"])
    assert err.value.code == 2
    assert unported_key(FileConfiguration(path)) is None


def test_cli_needs_a_card_or_cpu_by_name(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is the "
                    "CPU machines'")
    path = _write_conf(tmp_path, CONF.format(filename="absent.ishort"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"--config_file={path}"])


def test_sample_io_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(1001) + 1j * rng.standard_normal(1001)
         ).astype(np.complex64)
    from gnss_sim_receiver_tpu.utils import sample_io as jio
    for item_type, scale in (("ishort", 200.0), ("ibyte", 20.0),
                             ("gr_complex", 1.0), ("short", 100.0)):
        ours, theirs = tmp_path / "a.bin", tmp_path / "b.bin"
        write_samples(ours, x, item_type, scale=scale)
        jio.write_samples(theirs, x, item_type, scale=scale)
        assert ours.read_bytes() == theirs.read_bytes()
        got = read_samples(ours, item_type, count=500, offset_items=3)
        want = jio.read_samples(theirs, item_type, count=500, offset_items=3)
        assert got.dtype == np.complex64 and np.array_equal(got, want)
    # a tensor is quantized by torch (on its device): the same bytes as the
    # host writers, at halves (rint rounds half to even) and past the
    # type's range, and chunk by chunk
    edges = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.5, -128.5, 1e6,
                      -1e6, 32767.5, -32768.5], np.float32)
    for item_type, scale in (("ishort", 200.0), ("ibyte", 20.0)):
        e = edges / np.float32(scale)
        xe = np.concatenate([x, e + 1j * e[::-1]]).astype(np.complex64)
        ours, theirs = tmp_path / "a.bin", tmp_path / "b.bin"
        write_samples(ours, torch.from_numpy(xe), item_type, scale=scale)
        jio.write_samples(theirs, xe, item_type, scale=scale)
        assert ours.read_bytes() == theirs.read_bytes()
        q = quantize_interleaved(torch.from_numpy(xe), item_type, scale,
                                 chunk=100)
        assert q.numpy().tobytes() == theirs.read_bytes()


def _tracked(out: str) -> list:
    line = [ln for ln in out.splitlines() if ln.startswith("Channels")][0]
    return [int(p) for p in line.split("[")[1].rstrip("]").split(",")
            if p.strip()]


def test_cli_runs_receiver_from_conf(tmp_path, capsys):
    """tests/test_cli.py::test_cli_runs_receiver_from_conf on the port, at
    the canonical operating point: the 2 Msps fixture upsampled to 4 Msps
    by sample repetition, cut to 8 s and written as ishort, goes through
    the conf above (x2 decimating FIR, two-step acquisition) on both CLIs.
    8 s: channels acquire and track, no ephemeris yet, so exit code 1."""
    x, _ = static_scenario_capture()
    cap = tmp_path / "cap.ishort"
    write_samples(cap, np.repeat(x[: int(2e6 * 8)], 2), "ishort",
                  scale=200.0)
    conf = _write_conf(tmp_path, CONF.format(filename=cap))
    res = run_cli([f"--config_file={conf}", "--device=cpu"])
    out = capsys.readouterr().out
    assert res.exit_code == 1
    assert "Reading" in out and "32000000 samples at 4.000 Msps" in out
    assert "conditioned -> 16000000 samples at 2.000 Msps" in out
    assert "Ephemerides decoded: []" in out and "No position fix." in out
    assert set(res.seconds) == {"read", "condition", "receiver"}
    prns = _tracked(out)
    assert len(set(prns) & {1, 3, 4, 5, 9, 10}) >= 5
    # channel 3 is pinned to PRN 9
    assert res.run.channel_prns[3] == 9
    rc = jax_main([f"--config_file={conf}"])
    ref_out = capsys.readouterr().out
    assert rc == 1
    assert sorted(_tracked(ref_out)) == sorted(prns)


def test_cli_hybrid_conf_runs_both_chains(tmp_path, capsys, hybrid_capture):
    """Both CLIs on the hybrid conf and the first 8 s of the hybrid capture
    (tests/test_hybrid_position.py) written as ishort: the same tracked
    PRNs, GPS and Galileo both among them, and the same exit code (8 s is
    too short for a fix)."""
    x, _ = hybrid_capture
    cap = tmp_path / "hyb.ishort"
    write_samples(cap, x[: int(4e6 * 8)], "ishort", scale=200.0)
    conf = _write_conf(tmp_path, HYBRID_CONF.format(filename=cap))
    # two intra-op threads: the suite runs this file beside five other
    # workers, and more threads only oversubscribe the cores
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = run_cli([f"--config_file={conf}", "--device=cpu"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "32000000 samples at 4.000 Msps" in out
    prns = _tracked(out)
    systems = res.run.channel_systems
    assert systems == ["GPS"] * 10 + ["Galileo"] * 10
    assert {1, 3, 4, 5} <= set(prns) and {11, 12, 13, 14, 15} & set(prns)
    rc = jax_main([f"--config_file={conf}"])
    ref_out = capsys.readouterr().out
    assert rc == res.exit_code
    assert _tracked(ref_out) == prns


# ---------------------------------------------------------------------------
# the PVT modes beyond the single-point fix
# ---------------------------------------------------------------------------

PVT_MODES = ("Single", "Static", "Kinematic", "DGPS", "PPP_Static",
             "PPP_Kinematic", "RTK_Static", "RTK_Kinematic")
RTK_KEYS = ("PVT.rtk_base_rinex_obs={obs}\n"
            "PVT.rtk_base_position_ecef=1112189.9031,-4842955.0319,"
            "3985352.2376\n")


@pytest.mark.parametrize("mode", PVT_MODES)
def test_every_pvt_mode_parses_like_jax(tmp_path, mode):
    """The eight modes of the JAX factory (factory.py:363-367) build, in
    both packages, the same configuration; the RTK modes with the engine
    conf and the base position."""
    text = f"PVT.positioning_mode={mode}\nPVT.AR_ratio_threshold=2.5\n"
    if mode.startswith("RTK"):
        text += RTK_KEYS.format(obs="base.obs")
    path = _write_conf(tmp_path, text, "mode.conf")
    ref = jfactory.receiver_conf_from_config(JaxFileConfiguration(path))
    got = factory.receiver_conf_from_config(FileConfiguration(path))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got.pvt.positioning_mode == mode
    assert (got.rtk is None) == (not mode.startswith("RTK"))


def test_cli_accepts_the_rtk_keys(tmp_path):
    path = _write_conf(tmp_path, CONF.format(filename="absent.ishort")
                       + "PVT.positioning_mode=RTK_Static\n"
                       + RTK_KEYS.format(obs="base.obs"))
    assert unported_key(FileConfiguration(path)) is None


@pytest.mark.parametrize("missing", ["PVT.rtk_base_rinex_obs",
                                     "PVT.rtk_base_position_ecef"])
def test_cli_rtk_needs_its_base(tmp_path, capsys, missing):
    """An RTK conf without the base file or the base position exits 2 with
    the JAX CLI's message, before any file is read."""
    keys = [ln for ln in RTK_KEYS.format(obs="base.obs").splitlines()
            if not ln.startswith(missing)]
    path = _write_conf(tmp_path, CONF.format(filename="absent.ishort")
                       + "PVT.positioning_mode=RTK_Static\n"
                       + "\n".join(keys) + "\n")
    assert main([f"--config_file={path}", "--device=cpu"]) == 2
    msg = f"RTK mode needs {missing}"
    assert msg in capsys.readouterr().err
    import inspect
    from gnss_sim_receiver_tpu import __main__ as jax_cli
    assert msg in inspect.getsource(jax_cli)


def test_cli_refuses_dgps(tmp_path, capsys):
    """DGPS parses in both factories, and neither receiver implements it:
    the port's CLI exits 2 with the receiver's message."""
    path = _write_conf(tmp_path, CONF.format(filename="absent.ishort")
                       + "PVT.positioning_mode=DGPS\n")
    assert main([f"--config_file={path}", "--device=cpu"]) == 2
    assert "DGPS is not implemented" in capsys.readouterr().err


def test_cli_rtk_reads_the_base_file(tmp_path, capsys):
    """An RTK conf through the CLI: the base RINEX file (the JAX package's
    writer) becomes the session's base stream; 0.5 s of noise forms no
    observable epoch, so no RTK epoch and no fix (exit 1)."""
    from gnss_sim_receiver_tpu.models import outputs as jout
    from gnss_sim_receiver_tpu.models.observables import ObservationEpoch
    n = 3
    epochs = [ObservationEpoch(
        rx_time_s=345600.0 + 0.02 * k, tick_sample=0,
        valid=np.ones(n, bool), pseudorange_m=2.1e7 + np.arange(n),
        interp_tow_ms=np.full(n, 345599930.0), carrier_doppler_hz=np.ones(n),
        carrier_phase_cycles=-1e8 * np.ones(n), cn0_db_hz=np.full(n, 45.0))
        for k in range(5)]
    obs = tmp_path / "base.obs"
    jout.write_rinex_obs(obs, epochs, [3, 9, 17], 2200)
    cap = tmp_path / "noise.ishort"
    rng = np.random.default_rng(0)
    write_samples(cap, (rng.standard_normal(2_000_000)
                        + 1j * rng.standard_normal(2_000_000)).astype(
                            np.complex64), "ishort", scale=200.0)
    path = _write_conf(tmp_path, CONF.format(filename=cap)
                       + "PVT.positioning_mode=RTK_Static\n"
                       + RTK_KEYS.format(obs=obs))
    res = run_cli([f"--config_file={path}", "--device=cpu"])
    assert res.exit_code == 1 and res.run.rtk_solutions == []
    assert "No position fix." in capsys.readouterr().out
