"""Guards of the PyTorch port: it stands alone, it never runs quietly on the
CPU, and its state carries across intact.

- no file of gnss_sim_receiver_tpu_torch/ nor chip_smoke.py imports jax or
  gnss_sim_receiver_tpu (an AST scan), models/hybrid.py, models/dumps.py
  and monitor/tcp_cmd.py, the port's copies of JAX modules free of jax,
  among them;
- the port acquires and tracks (GPS L1 C/A, on the loops and on the
  Kalman tracker whose planes it dumps to a .mat file, and Galileo E1-B with the
  sign-recovery acquisition and 5 taps), builds the wideband chains and
  acquires E5a with the I/Q search, runs a streaming session and drives
  it over the TCP server, builds the L2C and E5b chains and simulates
  their signals, builds the BeiDou B1I and B3I chains, simulates their
  signals and decodes D1 and D2 prompts, builds the Galileo E6-B and the
  GLONASS slot chains, simulates their signals and decodes a HAS message
  and GNAV strings, builds the SBAS chain with the PVT mode keys, decodes
  SBAS messages into the corrections state and solves a fix with them,
  and runs the PVT modes' host modules (RTK and PPP from the factory,
  LAMBDA, the RINEX base file, RTCM over loopback, the precise products,
  the orbital EKF), in a process where both names cannot be imported, and
  opens no file of the JAX package: its Galileo code tables are its own
  package data, shipped by pyproject.toml;
- the entry points raise without a card unless device="cpu" is passed;
- chip_smoke.py fails, printing no result line, without a card and in a
  directory that holds nothing else of the repo;
- interop round-trips a TrackState (its secondary-code, extended-
  integration and bit-sync fields too) and the acquisition tables exactly.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models.acquisition import (
    AcqConf, PcpsAcquisitionEngine)
from gnss_sim_receiver_tpu_torch.models.receiver import Receiver, ReceiverConf
from gnss_sim_receiver_tpu_torch.models.tracking import (TrackingConf,
                                                         TrackingEngine,
                                                         _arm_channel,
                                                         _init_state)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "gnss_sim_receiver_tpu")


def _port_files():
    files = sorted((ROOT / "gnss_sim_receiver_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_hybrid_module_is_the_ports_own():
    """models/hybrid.py, the port's copy of the JAX package's NumPy-only
    hybrid module, is scanned with the rest and imports neither jax nor
    the JAX package; the receiver takes it from the port."""
    path = ROOT / "gnss_sim_receiver_tpu_torch" / "models" / "hybrid.py"
    assert path in _port_files()
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots
    from gnss_sim_receiver_tpu_torch.models import hybrid, receiver
    assert receiver.AowrTimeTransfer is hybrid.AowrTimeTransfer


_BLOCKED_RUN = r"""
import os, sys
for name in ("jax", "jaxlib", "gnss_sim_receiver_tpu"):
    sys.modules[name] = None          # any import of them now raises
import numpy as np, torch
from gnss_sim_receiver_tpu_torch.models.acquisition import (
    AcqConf, PcpsAcquisitionEngine)
from gnss_sim_receiver_tpu_torch.models import tracking as trk
from gnss_sim_receiver_tpu_torch.sim.signal_generator import (
    SatelliteSignalParams, generate_baseband)
fs = 2e6
sat = SatelliteSignalParams(prn=7, cn0_db_hz=50.0, doppler_hz=1500.0,
                            delay_chips=300.0, nav_bits=np.ones(4, np.int8))
x = generate_baseband([sat], fs, 60000, noise=True, seed=3)
eng = PcpsAcquisitionEngine(AcqConf(fs_in=fs, max_dwells=2), [7, 8],
                            device="cpu")
res = eng.acquire_from(x, 0)
assert list(res.detected) == [True, False], res
te = trk.TrackingEngine(trk.TrackingConf(fs=fs), [7], device="cpu")
te.start_tracking(0, float(res.doppler_hz[0]), int(res.delay_samples[0]))
te.full_outputs = False               # the receiver's decimated pulls
outs = te.process_end(te.process_begin(x, 0, 20, decim=10))
assert outs["valid_full"].all() and outs["sample_counter"].shape == (2, 1)
# the Kalman tracker's every-epoch planes, written and read back as the
# reference's tracking dump (models/dumps.py, SciPy's .mat files)
import tempfile
from gnss_sim_receiver_tpu_torch.models import dumps
te = trk.TrackingEngine(trk.TrackingConf(fs=fs, tracking_mode="kf"), [7],
                        device="cpu")
te.start_tracking(0, float(res.doppler_hz[0]), int(res.delay_samples[0]))
outs = te.process(x, 0, 20)
assert outs["valid"].all() and outs["early_mag"].shape == (20, 1)
with tempfile.TemporaryDirectory() as tmp:
    dumps.dump_tracking_mat(os.path.join(tmp, "trk.mat"), outs, channel=0)
    mat = dumps.load_mat(os.path.join(tmp, "trk.mat"))
assert np.array_equal(mat["Prompt_I"].ravel(), outs["prompt"][:, 0].real)
# the device generator (K6's plain version) and the QuickSync, Tong and
# Fine Doppler engines on its capture
from gnss_sim_receiver_tpu_torch.sim.device_generator import (
    generate_baseband_device_resident)
sat = SatelliteSignalParams(prn=7, cn0_db_hz=50.0, doppler_hz=1500.0,
                            delay_chips=300.0, nav_bits=np.ones(4, np.int8))
xd = generate_baseband_device_resident([sat], fs, 24576, seed=3,
                                       device="cpu")
for variant in ("quicksync", "tong", "fine_doppler"):
    eng = PcpsAcquisitionEngine(AcqConf(fs_in=fs, max_dwells=4,
                                        tong_max_dwells=8, variant=variant),
                                [7, 8], device="cpu")
    res = eng.acquire_from(xd, 0)
    assert list(res.detected) == [True, False], (variant, res)
# the conf-driven path: CLI module, factory, conditioner and its kernels'
# plain versions
from gnss_sim_receiver_tpu_torch import __main__ as cli
from gnss_sim_receiver_tpu_torch.models.conditioner import SignalConditioner
from gnss_sim_receiver_tpu_torch.models.factory import (
    receiver_conf_from_config)
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
conf = InMemoryConfiguration({
    "InputFilter.implementation": "Freq_Xlating_Fir_Filter",
    "InputFilter.decimation_factor": "2", "InputFilter.IF": "250000",
    "Resampler.implementation": "Mmse_Resampler",
    "Resampler.sample_freq_out": "750000",
    "Acquisition_1C.make_two_steps": "true"})
y = SignalConditioner(conf, fs_in=fs, device="cpu").process(x)
assert y.shape == (22500,) and bool(torch.isfinite(y.abs()).all())
assert receiver_conf_from_config(conf).acq.make_two_steps
assert cli.unported_key(conf) is None
# the live session: a streaming session fed in pieces, then driven over the
# TCP telecommand server
import socket
from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                         ReceiverConf)
from gnss_sim_receiver_tpu_torch.monitor.tcp_cmd import TcpCmdServer
xs = generate_baseband([sat], 2e6, 400000, noise=True, seed=3)
ss = Receiver(ReceiverConf(fs=2e6, prns=(7, 8), max_channels=2,
                           chunk_epochs=50), device="cpu").start_session()
for k in range(0, len(xs), 100000):
    ss.feed(xs[k:k + 100000])
ss.run_to_end()
run = ss.result()
assert run.channel_prns[0] == 7 and run.channel_states[0].name == "TRACKING"
srv = TcpCmdServer(ss)
with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as sk:
    fh = sk.makefile("rw", newline="\n")
    fh.write("status\nstandby\nexit\n")
    fh.flush()
    assert fh.readline().startswith("running ch0=GPS:7:TRACKING")
    assert fh.readline().strip() == "OK standby"
srv.close()
assert ss._standby
# the hybrid slice: the E1 chain from a conf, its code tables (the port's
# own package data), the sign-recovery acquisition, 5-tap tracking and
# the I/NAV decoder, with every file open watched
import builtins
opened = []
_open = builtins.open
def _watch(file, *a, **k):
    opened.append(str(file))
    return _open(file, *a, **k)
builtins.open = _watch
from gnss_sim_receiver_tpu_torch import signals
from gnss_sim_receiver_tpu_torch.models.telemetry import (
    GalileoE1bTelemetryDecoder)
from gnss_sim_receiver_tpu_torch.nav import inav
chain, = receiver_conf_from_config(InMemoryConfiguration({
    "GNSS-SDR.internal_fs_sps": "4000000", "Channels_1B.count": "2",
    "Acquisition_1B.implementation":
        "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition",
    "Tracking_1B.very_early_late_space_chips": "0.6"})).chains
fs = 4e6
sats = [SatelliteSignalParams(prn=12, system="Galileo", signal="1B",
                              cn0_db_hz=50.0, doppler_hz=-750.0,
                              delay_chips=1000.0,
                              nav_bits=np.ones(8, np.int8))]
x = generate_baseband(sats, fs, 12 * 16000, noise=True, seed=4)
eng = PcpsAcquisitionEngine(chain.acq, [12, 13],
                            code_provider=chain.code_provider,
                            sc_rate=chain.sc_rate,
                            code_provider2=chain.data_code_provider,
                            device="cpu")
res = eng.acquire_from(torch.from_numpy(x), 0)
assert list(res.detected) == [True, False], res
te = trk.TrackingEngine(chain.trk, [12], code_provider=chain.code_provider,
                        device="cpu")
assert te.taps.numel() == 5
te.start_tracking(0, float(res.doppler_hz[0]), int(res.delay_samples[0]))
te.full_outputs = False               # the receiver's decimated pulls
outs = te.process_end(te.process_begin(x, 0, 10, decim=5))
assert outs["valid_full"].all() and outs["sample_counter"].shape == (2, 1)
GalileoE1bTelemetryDecoder([12]).process({"prompt": outs["prompt"],
                                          "valid": outs["valid_full"]})
# the pilot slice: the E1-C pilot chain (CS25, extended integration) with
# its data-prompt correlator through the per-epoch closure's plain version
from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e1b_chain
pilot = galileo_e1b_chain(fs, prns=(12,), n_channels=1, track_pilot=True,
                          extend_correlation_symbols=5)
te = trk.TrackingEngine(pilot.trk, [12], code_provider=pilot.code_provider,
                        data_code_provider=pilot.data_code_provider,
                        device="cpu")
assert te.data_codes is not None and te.codes.shape == te.data_codes.shape
te.start_tracking(0, float(res.doppler_hz[0]), int(res.delay_samples[0]))
outs = te.process(x, 0, 10)
assert outs["valid"].all() and int(te.state.epoch[0]) == 10
assert len(inav.pages_for_ephemeris(
    __import__("gnss_sim_receiver_tpu_torch.nav.ephemeris",
               fromlist=["x"]).make_sky_constellation(40.0, -75.0,
                                                      346200.0)[0],
    345600.0, n_repeats=1)) == 2500
# the wideband slice: the L5 and E5a chains from a conf, the E5a code
# tables (package data), the iq_caf search with the doubled FFT, and the
# F/NAV and CNAV decoders
from gnss_sim_receiver_tpu_torch.models.telemetry import (
    GalileoE5aTelemetryDecoder, GpsCnavTelemetryDecoder)
from gnss_sim_receiver_tpu_torch.nav import cnav, fec, fnav
l5, e5a = receiver_conf_from_config(InMemoryConfiguration({
    "GNSS-SDR.internal_fs_sps": "12000000", "Channels_L5.count": "1",
    "Channels_5X.count": "2",
    "Acquisition_5X.implementation":
        "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF",
    "Acquisition_5X.CAF_window_hz": "500",
    "Acquisition_5X.bit_transition_flag": "true"})).chains
assert (l5.signal, e5a.signal, e5a.acq.variant) == ("L5", "5X", "iq_caf")
fs = 12e6
sats = [SatelliteSignalParams(prn=4, system="Galileo", signal="5X",
                              cn0_db_hz=50.0, doppler_hz=2250.0,
                              delay_chips=5000.0,
                              nav_bits=np.ones(8, np.int8))]
x = generate_baseband(sats, fs, 5 * 12000, noise=True, seed=23)
eng = PcpsAcquisitionEngine(e5a.acq, [4, 27],
                            code_provider=e5a.code_provider,
                            sc_rate=e5a.sc_rate,
                            code_provider2=e5a.data_code_provider,
                            device="cpu")
res = eng.acquire_from(x, 0)
assert list(res.detected) == [True, False], res
eph = __import__("gnss_sim_receiver_tpu_torch.nav.ephemeris",
                 fromlist=["x"]).make_sky_constellation(40.0, -75.0,
                                                        345600.0)[0]
assert len(fnav.pages_for_ephemeris(eph, 345600.0, n_repeats=1)) == 2000
assert len(cnav.symbols_for_ephemeris(eph, 345600.0, n_repeats=1,
                                      bps=50.0)) == 1800
assert len(fec.viterbi27_decode(np.ones(16, np.float32))) == 8
for dec in (GalileoE5aTelemetryDecoder([4]),
            GpsCnavTelemetryDecoder([4], signal="L5")):
    dec.process({"prompt": np.ones((40, 1), np.complex64),
                 "valid": np.ones((40, 1), bool)})
# the hybrid slice: the AOWR estimator and the clock-sharing records
from gnss_sim_receiver_tpu_torch.models import hybrid
aowr = hybrid.AowrTimeTransfer(hybrid.AowrConf(r_ps_true_m=0.4))
for k in range(5):
    aowr.update(299792458.0 * 0.25 + 0.1 * k, 12345.678)
assert aowr.observed and abs(aowr.dt_s - 0.25) < 1e-8
assert hybrid.format_rx_clock_bias_line(1.0, 2.0, 3e-4, 7).endswith(",07\n")
# the L2C and E5b slice: both chains from a conf, their code tables (the
# E5b rows are package data), the simulator's two signals
from gnss_sim_receiver_tpu_torch.models.telemetry import \
    GalileoE5bTelemetryDecoder
l2c, e5b = receiver_conf_from_config(InMemoryConfiguration({
    "GNSS-SDR.internal_fs_sps": "4000000", "Channels_2S.count": "2",
    "Channels_7X.count": "2"})).chains
assert (l2c.signal, e5b.signal) == ("2S", "7X")
assert l2c.code_provider(7).shape == e5b.code_provider(11).shape == (10230,)
assert isinstance(e5b.telemetry_decoder([11]), GalileoE5bTelemetryDecoder)
x = generate_baseband(
    [SatelliteSignalParams(prn=7, signal="2S", nav_bits=np.ones(4, np.int8)),
     SatelliteSignalParams(prn=11, system="Galileo", signal="7X",
                           nav_bits=np.ones(8, np.int8))],
    4e6, 8192, noise=False)
assert x.shape == (8192,) and np.isfinite(x).all()
# the BeiDou slice: both chains from a conf, their codes, the simulator's
# two signals, the D1 and D2 decoders on prompts of an encoded ephemeris
from gnss_sim_receiver_tpu_torch.models.telemetry import \
    BeidouB1iTelemetryDecoder
from gnss_sim_receiver_tpu_torch.nav import dnav
from gnss_sim_receiver_tpu_torch.nav.ephemeris import make_sky_constellation
b1, b3 = receiver_conf_from_config(InMemoryConfiguration({
    "GNSS-SDR.internal_fs_sps": "12000000", "Channels_B1.count": "2",
    "Channels_B3.count": "2"})).chains
assert (b1.signal, b3.signal) == ("B1", "B3") and b3.assist_wait
assert b1.code_provider(14).shape == (2046,)
assert b3.code_provider(14).shape == (10230,)
x = generate_baseband(
    [SatelliteSignalParams(prn=14, system="BeiDou", signal=s,
                           nav_bits=np.ones(8, np.int8)) for s in ("B1", "B3")],
    12e6, 8192, noise=False)
assert x.shape == (8192,) and np.isfinite(x).all()
eph = make_sky_constellation(30.0, 110.0, toe=345600.0)[0]
eph.system = "BeiDou"
d1 = dnav.b1i_epoch_signs(dnav.bits_for_ephemeris(eph, 345600.0, 2))
d2 = dnav.d2_epoch_signs(dnav.d2_bits_for_ephemeris(eph, 300.0, 11))
for prn, signs in ((14, d1), (2, d2)):
    tlm = b1.telemetry_decoder([prn])
    assert isinstance(tlm, BeidouB1iTelemetryDecoder)
    out = tlm.process({"prompt": signs.astype(np.complex64)[:, None],
                       "valid": np.ones((len(signs), 1), bool)})
    assert len(out.new_ephemerides) == 1, prn
# the E6-B and GLONASS slice: the E6 chain and the slot chains from a conf
# (the E6 rows are package data), the simulator's three signals, a HAS
# message through the E6 decoder and an ephemeris through the GNAV one
from gnss_sim_receiver_tpu_torch.models.telemetry import (
    GalileoE6bTelemetryDecoder, GlonassTelemetryDecoder)
from gnss_sim_receiver_tpu_torch.nav import cnav_e6, gnav, has
chains = receiver_conf_from_config(InMemoryConfiguration({
    "GNSS-SDR.internal_fs_sps": "10000000", "Channels_E6.count": "2",
    "Channels_1G.count": "3", "Channels_2G.count": "1"})).chains
assert [(c.signal, c.freq_slot) for c in chains] == [
    ("E6", 0), ("1G", -7), ("1G", -5), ("2G", -7)]
assert chains[1].trk.doppler_bias_hz == -7 * 562500.0
assert chains[0].code_provider(11).shape == (5115,)
assert chains[3].code_provider(10).shape == (511,)
x = generate_baseband(
    [SatelliteSignalParams(prn=11, system="Galileo", signal="E6",
                           nav_bits=np.ones(8, np.int8)),
     *(SatelliteSignalParams(prn=10, system="GLONASS", signal=s,
                             doppler_hz=-7 * df, nav_bits=np.ones(8, np.int8))
       for s, df in (("1G", 562500.0), ("2G", 437500.0)))], 10e6, 8192,
    noise=False)
assert x.shape == (8192,) and np.isfinite(x).all()
msg = has.HasData(header=has.HasHeader(toh=9, mask_flag=True), nsys=1,
                  gnss_id_mask=[2], satellite_mask=[1 << 35],
                  signal_mask=[1 << 15], cell_mask_flag=[False],
                  cell_mask=[np.ones((1, 1), bool)], nav_message=[0])
pages = has.mt1_to_pages(msg, message_id=3)
signs = cnav_e6.e6b_epoch_signs(np.concatenate(pages * 3))
tlm = chains[0].telemetry_decoder([11])
assert isinstance(tlm, GalileoE6bTelemetryDecoder)
tlm.process({"prompt": signs.astype(np.complex64)[:, None],
             "valid": np.ones((len(signs), 1), bool),
             "sample_counter": 1e4 * np.arange(1, len(signs) + 1)[:, None]})
assert tlm.has.messages and tlm.has.messages[0].prns(0) == [5]
geph = gnav.GlonassEphemeris(prn=10, freq_slot=-7, tb_s=900.0,
                             pos_m=(1.5e7, 1.6e7, 1.2e7),
                             vel_ms=(-1.9e3, 4e2, 1.9e3))
sym = gnav.strings_for_ephemeris(geph, 0.0, 2)
tlm = chains[1].telemetry_decoder([10])
assert isinstance(tlm, GlonassTelemetryDecoder)
out = tlm.process({"prompt": np.repeat(2.0 * sym - 1.0, 10).astype(
    np.complex64)[:, None], "valid": np.ones((10 * len(sym), 1), bool)})
assert len(out.new_ephemerides) == 1
assert out.new_ephemerides[0][1].freq_slot == -7
# the SBAS slice: the S1 chain and the PVT mode keys from a conf, the
# simulator's S1 signal, messages through the SBAS decoder (its encoder and
# Viterbi decoder the port's nav/fec.py) into the corrections state, and a
# fix with the atmosphere models, RAIM and the PVT Kalman filter
from gnss_sim_receiver_tpu_torch.models.pvt import solve_pvt_raim
from gnss_sim_receiver_tpu_torch.models.pvt_kf import PvtKf
from gnss_sim_receiver_tpu_torch.models.telemetry import \
    SbasL1TelemetryDecoder
from gnss_sim_receiver_tpu_torch.nav import sbas
conf = receiver_conf_from_config(InMemoryConfiguration({
    "Channels_S1.count": "2", "PVT.iono_model": "Broadcast",
    "PVT.trop_model": "Saastamoinen", "PVT.raim_fde": "true",
    "Observables.smoothing_factor": "100", "PVT.enable_pvt_kf": "true"}))
assert [c.signal for c in conf.chains] == ["S1"] and conf.enable_pvt_kf
rng = np.random.default_rng(0)
msgs = [(1, sbas.pack_mt1([1, 3, 4, 5])),
        (2, sbas.pack_mt2([1.5, -2.0, 0.5, 3.0]))] + [
    (63, rng.integers(0, 2, 212)) for _ in range(3)]
signs = sbas.sbas_epoch_signs(sbas.symbols_for_messages(msgs))
x = generate_baseband([SatelliteSignalParams(
    prn=133, system="SBAS", signal="S1", nav_bits=signs)], 2e6, 8192,
    noise=False)
assert x.shape == (8192,) and np.isfinite(x).all()
tlm = conf.chains[0].telemetry_decoder([133])
assert isinstance(tlm, SbasL1TelemetryDecoder)
tlm.process({"prompt": signs.astype(np.complex64)[:, None],
             "valid": np.ones((len(signs), 1), bool)})
corr = sbas.SbasCorrections()
for _, _, ev in tlm.messages:
    corr.push(ev)
assert corr.fast_prc == {1: 1.5, 3: -2.0, 4: 0.5, 5: 3.0}, corr.fast_prc
from gnss_sim_receiver_tpu_torch.models.observables import ObservationEpoch
from gnss_sim_receiver_tpu_torch.nav.ephemeris import make_sky_constellation
ephs = {e.prn: e for e in make_sky_constellation(40.0, -75.0, 346200.0)}
prns = sorted(ephs)
n = len(prns)
ep = ObservationEpoch(345660.0, 0, np.ones(n, bool), np.full(n, 2.2e7),
                      np.full(n, 345659930.0), np.zeros(n), np.zeros(n),
                      np.full(n, 45.0))
sol = solve_pvt_raim(ep, prns, ephs, conf.pvt, sbas_corrections=corr)
if sol.valid:
    PvtKf().update(sol)
# the PVT modes beyond the single-point fix: the RTK and PPP confs from the
# factory, LAMBDA, the RINEX base file, the RTCM codec over loopback, the
# precise products, a PPP and an RTK update and the orbital EKF's coast
from gnss_sim_receiver_tpu_torch.models import outputs, ppp, rtcm, rtk
from gnss_sim_receiver_tpu_torch.models.pvt_ekf_orbital import PvtEkfOrbital
from gnss_sim_receiver_tpu_torch.nav import precise
from gnss_sim_receiver_tpu_torch.utils import environment
conf = receiver_conf_from_config(InMemoryConfiguration({
    "PVT.positioning_mode": "RTK_Kinematic",
    "PVT.rtk_base_position_ecef": "1,2,3"}))
assert conf.rtk.mode == "kinematic" and conf.rtk_base_ecef_m == (1, 2, 3)
cands, _ = rtk.lambda_ils(np.array([1.1, -2.2, 3.05]), np.eye(3) * 0.01)
assert list(cands[0]) == [1, -2, 3]
eps = [ObservationEpoch(345660.0 + 0.02 * k, 0, np.ones(n, bool),
                        np.full(n, 2.2e7), np.full(n, 345659930.0),
                        np.zeros(n), np.full(n, -1e8), np.full(n, 45.0))
       for k in range(3)]
with tempfile.TemporaryDirectory() as tmp:
    outputs.write_rinex_obs(os.path.join(tmp, "b.obs"), eps, prns, 2200)
    back, bprns, bsys = outputs.read_rinex_obs(os.path.join(tmp, "b.obs"))
    base = rtk.BaseObservations(back, bprns, bsys, np.zeros(3))
    sp3 = os.path.join(tmp, "o.sp3")
    precise.write_sp3(sp3, 2200, 345600.0 + 900.0 * np.arange(13), {
        1: (np.ones((13, 3)) * 2e7, np.zeros(13))})
    assert 1 in precise.Sp3Ephemeris(open(sp3).read()).satellites()
assert len(back) == 3 and base.aligned_to(345660.02, prns, None) is not None
rx_ecef = np.array([1112189.9, -4842955.0, 3985352.2])
rtk.RtkEngine(conf.rtk, rx_ecef).update(eps[0], eps[0], prns, ephs)
ppp.PppEngine(ppp.PppConf()).update(eps[0], prns, ephs, x0=rx_ecef)
assert precise.solid_earth_tide(2200, 345600.0, rx_ecef).shape == (3,)
data = rtcm.frame(rtcm.encode_station(rx_ecef)) + b"".join(
    rtcm.frame(rtcm.encode_ephemeris(e)) for e in list(ephs.values())[:2])
port, srv = rtcm.serve_frames(data)
try:
    got = rtcm.read_frames("127.0.0.1", port)
finally:
    srv.close()
dec = rtcm.RtcmBaseDecoder()
dec.feed(got)
assert got == data and len(dec.ephemerides) == 2
ekf = PvtEkfOrbital()
ekf.init_ecef(np.concatenate([rx_ecef, np.zeros(3)]), 0.0, 0.0, 345600.0)
ekf.propagate_to(345630.0)
assert np.isfinite(ekf.state_ecef()[0]).all()
assert environment.moon().name == "Moon"
builtins.open = _open
assert any(p.endswith("galileo_e1_codes.npz") for p in opened), opened
assert any(p.endswith("galileo_e5a_codes.npz") for p in opened), opened
assert any(p.endswith("galileo_e5b_codes.npz") for p in opened), opened
assert any(p.endswith("galileo_e6_codes.npz") for p in opened), opened
bad = [p for p in opened if "gnss_sim_receiver_tpu" + os.sep in p
       or p.endswith("galileo_codes.npz")]
assert not bad, bad
assert not any(m.split(".")[0] in ("jax", "jaxlib")
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_dumps_module_is_the_ports_own():
    """models/dumps.py, the port's copy of the JAX package's NumPy and
    SciPy .mat dump writers, is scanned with the rest and imports neither
    jax nor the JAX package (the blocked run writes and reads a dump)."""
    path = ROOT / "gnss_sim_receiver_tpu_torch" / "models" / "dumps.py"
    assert path in _port_files()
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots
    assert roots <= {"__future__", "numpy", "scipy"}, roots


def test_pvt_mode_modules_are_the_ports_own():
    """The PVT modes' host modules, the port's copies of the JAX
    package's NumPy modules, are scanned with the rest and import neither
    jax nor the JAX package: only the standard library, NumPy and the port
    (models/rtcm.py's loopback transport takes socket and threading); the
    blocked run drives each of them."""
    pkg = ROOT / "gnss_sim_receiver_tpu_torch"
    std = {"__future__", "dataclasses", "datetime", "pathlib", "numpy"}
    for rel, extra in (("utils/environment.py", set()),
                       ("models/pvt_ekf_orbital.py", set()),
                       ("models/rtk.py", set()),
                       ("models/outputs.py", set()),
                       ("models/rtcm.py", {"socket", "threading"}),
                       ("nav/precise.py", set()),
                       ("models/ppp.py", set())):
        path = pkg / rel
        assert path in _port_files()
        roots = set(_imported_roots(path))
        assert not roots & set(FORBIDDEN), (rel, roots)
        assert roots <= std | extra | {"gnss_sim_receiver_tpu_torch"}, (
            rel, roots)
    from gnss_sim_receiver_tpu_torch.models import receiver, rtk
    assert receiver.RtkEngine is rtk.RtkEngine


def test_monitor_is_the_ports_own():
    """monitor/tcp_cmd.py, the port's copy of the JAX package's NumPy-free
    TCP server, is scanned with the rest and imports neither jax nor the
    JAX package; so is the receiver module that serves its commands."""
    pkg = ROOT / "gnss_sim_receiver_tpu_torch"
    for path in (pkg / "monitor" / "tcp_cmd.py",
                 pkg / "monitor" / "__init__.py",
                 pkg / "models" / "receiver.py"):
        assert path in _port_files()
        roots = set(_imported_roots(path))
        assert not roots & set(FORBIDDEN), (path, roots)


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("entry", ["receiver", "acquisition", "tracking"])
def test_entry_points_need_a_card_or_cpu_by_name(entry):
    """device=None means the card: without one the entry point raises
    instead of running the plain versions quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is the "
                    "CPU machines'")
    make = {"receiver": lambda d: Receiver(ReceiverConf(fs=2e6), device=d),
            "acquisition": lambda d: PcpsAcquisitionEngine(
                AcqConf(fs_in=2e6), [1], device=d),
            "tracking": lambda d: TrackingEngine(TrackingConf(), [1],
                                                 device=d)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(None)
    assert make("cpu").device.type == "cpu"


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_interop_round_trip():
    st = _init_state(3, "cpu")
    st = _arm_channel(st, 1, -1234.5, 1.023e6 - 0.8)
    st = st._replace(pos=torch.tensor([5, -7, 123456], dtype=torch.int32),
                     prompt_prev=torch.tensor([1 + 2j, -3j, 0.5],
                                              dtype=torch.complex64))
    # the secondary-code, extended-integration and bit-sync fields
    st = st._replace(
        sec_buf=torch.where(torch.rand(3, 32) < 0.5, 1.0, -1.0),
        sec_synced=torch.tensor([True, False, True]),
        sec_off=torch.tensor([3, 0, 24], dtype=torch.int32),
        sec_polarity=torch.tensor([-1.0, 1.0, 1.0]),
        ext_p=torch.tensor([1 - 2j, 0, 3.5j], dtype=torch.complex64),
        ext_e=torch.tensor([2 + 1j, 0, -1], dtype=torch.complex64),
        ext_l=torch.tensor([-2j, 0, 4], dtype=torch.complex64),
        ext_n=torch.tensor([4, 0, 19], dtype=torch.int32),
        bit_hist=torch.randint(0, 17, (3, 20)).float(),
        prev_sign=torch.tensor([1.0, 0.0, -1.0]),
        bit_synced=torch.tensor([False, True, True]),
        bit_phase=torch.tensor([0, 7, 19], dtype=torch.int32))
    arrays = interop.track_state_to_numpy(st)
    assert "dll.vel" in arrays and "cn0_acc.sum_m4" in arrays
    back = interop.track_state_from_numpy(arrays, "cpu")
    for a, b in zip(interop.track_state_to_numpy(back).values(),
                    arrays.values()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back.pos.dtype == torch.int32
    assert back.prompt_prev.dtype == torch.complex64
    for name, dt in (("sec_buf", torch.float32), ("sec_synced", torch.bool),
                     ("sec_off", torch.int32), ("sec_polarity", torch.float32),
                     ("ext_p", torch.complex64), ("ext_e", torch.complex64),
                     ("ext_l", torch.complex64), ("ext_n", torch.int32),
                     ("bit_hist", torch.float32), ("prev_sign", torch.float32),
                     ("bit_synced", torch.bool), ("bit_phase", torch.int32)):
        assert getattr(back, name).dtype == dt, name
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    tables = {"code_fft_conj": np.array([[1 + 1j, 2 - 1j]], np.complex64),
              "dopplers": np.array([-250.0, 0.0, 250.0], np.float32)}
    t = interop.acq_tables_from_numpy(tables, "cpu")
    back = interop.acq_tables_to_numpy(t)
    for k in tables:
        assert back[k].dtype == tables[k].dtype
        assert np.array_equal(back[k], tables[k])


def test_package_data_ships_the_e5a_codes():
    """The E5a table holds the E5a-I and E5a-Q rows of every satellite and
    the CS20 and per-PRN CS100 secondary codes."""
    with np.load(ROOT / "gnss_sim_receiver_tpu_torch" / "data"
                 / "galileo_e5a_codes.npz") as z:
        assert sorted(z.files) == ["e5ai", "e5ai_sec", "e5aq", "e5aq_sec"]
        assert z["e5ai"].shape == z["e5aq"].shape == (50, 1279)
        assert z["e5ai_sec"].shape == (20,)
        assert z["e5aq_sec"].shape == (47, 13)


def test_package_data_ships_the_e5b_codes():
    """The E5b table holds the E5b-I rows of every satellite and the CS4
    secondary code's bits, the JAX package's rows (E5b-Q stays out)."""
    with np.load(ROOT / "gnss_sim_receiver_tpu_torch" / "data"
                 / "galileo_e5b_codes.npz") as z, \
            np.load(ROOT / "gnss_sim_receiver_tpu" / "data"
                    / "galileo_codes.npz") as ref:
        assert sorted(z.files) == ["e5bi", "e5bi_sec"]
        assert z["e5bi"].shape == (50, 1279)
        assert z["e5bi_sec"].tolist() == [1, 1, 1, 0]
        for k in z.files:
            assert z[k].dtype == ref[k].dtype
            assert np.array_equal(z[k], ref[k])


def test_package_data_ships_the_e6_codes():
    """The E6 table holds the E6-B rows of every satellite, the JAX
    package's rows (E6-C and its secondary codes stay out)."""
    with np.load(ROOT / "gnss_sim_receiver_tpu_torch" / "data"
                 / "galileo_e6_codes.npz") as z, \
            np.load(ROOT / "gnss_sim_receiver_tpu" / "data"
                    / "galileo_codes.npz") as ref:
        assert sorted(z.files) == ["e6b"]
        assert z["e6b"].shape == (50, 640)
        assert z["e6b"].dtype == ref["e6b"].dtype
        assert np.array_equal(z["e6b"], ref["e6b"])


def test_package_data_ships_the_e1_codes():
    """pyproject.toml ships the port's data files, and the E1 table holds
    the E1-B and E1-C rows of every satellite."""
    text = (ROOT / "pyproject.toml").read_text()
    assert '"gnss_sim_receiver_tpu_torch" = ["data/*.npz"]' in text
    with np.load(ROOT / "gnss_sim_receiver_tpu_torch" / "data"
                 / "galileo_e1_codes.npz") as z:
        assert sorted(z.files) == ["e1b", "e1c", "e1c_sec"]
        assert z["e1b"].shape == z["e1c"].shape == (50, 512)
