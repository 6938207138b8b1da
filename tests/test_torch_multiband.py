"""The multi-band front end of the PyTorch port on the CPU against the JAX
package: per-RF-channel streams and rates, the Doppler-assisted
secondary-band acquisition and the acquisition-only resampler.

- Session bookkeeping: both packages' sessions on two streams of different
  rates and lengths (GPS L1 C/A at 2 Msps on RF 0, GPS L5I at 12.5 Msps on
  RF 1): the primary-domain end, every chain's epoch total and the sample
  conversions _to_chain / _to_primary are exactly equal.  No receiver runs.
- ``acquire_assisted`` on one seeded L5 window off the 128-sample grid:
  detections, delays, Dopplers and the threshold equal JAX's, the
  statistic within rtol 1e-4 (float32 FFTs of two libraries).
- The resampler: a cut of tests/test_multiband.py's resampler scenario
  (8 Msps, acquisition at 2 Msps): the first acquisition's detections,
  delays and Dopplers, and every armed channel's start sample, equal
  JAX's.  The sessions' first iteration only (the tracking dispatch
  stubbed out).
- Both receivers on short dual-band captures, 0.4 s chunks: GPS L1 C/A at
  2 Msps + L5I at 12.5 Msps (the JAX test's rates), and Galileo E1-B at
  4 Msps + E5a-I at 12.5 Msps.  The assist logs agree in (signal, PRN,
  detected), the centers within 0.5 Hz; no secondary-band channel
  searched cold.  At each chain's last epoch both report valid, per
  channel: sample counters within one sample, carrier Dopplers within
  0.5 Hz, code boundaries within 0.25 chip (tests/test_torch_wideband.py's
  tolerances); and over the second half of the epochs both report valid
  the prompts' signs agree up to one polarity per channel (a Costas loop
  may lock either way: measured, one L5 channel locks inverted in one
  package from its 120th epoch on).
- The conf path: RF_channel_ID, sample_rate_rf<id> and
  use_acquisition_resampler build the JAX factory's configuration.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models.factory import \
    receiver_conf_from_config as jconf_from
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JConfig
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models.factory import \
    receiver_conf_from_config
from gnss_sim_receiver_tpu_torch.nav import fnav
from gnss_sim_receiver_tpu_torch.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu_torch.sim import scenario
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from gnss_sim_receiver_tpu_torch.utils import geodesy
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration

T0 = 345600.0
RX_LLH = (40.0, -75.0, 100.0)
FS_L1, FS_L5, FS_E1 = 2_000_000.0, 12_500_000.0, 4_000_000.0
F_L5 = 1176.45e6
DUR = 1.2
CHUNK_EPOCHS = 400


def _rx_true():
    return geodesy.llh_to_ecef(np.radians(RX_LLH[0]), np.radians(RX_LLH[1]),
                               RX_LLH[2])


def _gps_conf(mod, l5_prns, chunk_epochs=CHUNK_EPOCHS):
    """tests/test_multiband.py's dual-band conf: six L1 channels on RF 0 at
    2 Msps, the assist-gated L5 chain on RF 1 at 12.5 Msps."""
    l5 = dataclasses.replace(
        mod.gps_l5_chain(FS_L5, prns=tuple(l5_prns), n_channels=2),
        rf_channel_id=1)
    return mod.ReceiverConf(fs=FS_L1, prns=(1, 2, 3, 4, 5, 6),
                            max_channels=6, max_acq_channels=6,
                            rf_fs={1: FS_L5}, chains=(l5,), pvt_rate_ms=200,
                            chunk_epochs=chunk_epochs)


def _gal_conf(mod, prns):
    """Galileo E1-B at 4 Msps on RF 0 and the assist-gated E5a-I chain at
    12.5 Msps on RF 1."""
    e1 = mod.galileo_e1b_chain(FS_E1, prns=tuple(prns), n_channels=2)
    e5a = dataclasses.replace(
        mod.galileo_e5a_chain(FS_L5, prns=tuple(prns), n_channels=2),
        rf_channel_id=1)
    return mod.ReceiverConf(fs=FS_E1, gps_chain=False, rf_fs={1: FS_L5},
                            chains=(e1, e5a), chunk_epochs=CHUNK_EPOCHS)


def _e5a_sats(ephs, rx, dur):
    """E5a-I signals of Galileo ephemerides (the scenario builder has no
    E5a band): its L5 branch's light-time fit, F/NAV spread by CS20."""
    ts = np.array([0.0, dur / 2.0, dur])
    out = []
    for eph in ephs:
        d = np.array([scenario._light_time_delay(eph, rx, T0 + t)
                      for t in ts])
        d2 = (d[2] - 2.0 * d[1] + d[0]) / (dur / 2.0) ** 2
        d1 = (d[2] - d[0]) / dur - d2 * dur / 2.0
        pages = fnav.pages_for_ephemeris(eph, T0, n_repeats=1)
        out.append(PSat(
            prn=eph.prn, system="Galileo", signal="5X", cn0_db_hz=48.0,
            doppler_hz=-F_L5 * d1, doppler_rate_hz_s=-F_L5 * d2,
            delay_sec=d[0], carrier_phase_rad=float(
                np.mod(-2.0 * np.pi * F_L5 * d[0], 2.0 * np.pi)),
            code_doppler_hz=-F_L5 * d1, carrier_ref_hz=F_L5,
            nav_bits=fnav.e5a_epoch_signs(pages, eph.prn)))
    return out


def _gps_capture():
    """The dual-band GPS capture: six L1 satellites, two with L5."""
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)[:6]
    rx = _rx_true()
    l1 = scenario.build_static_scenario(ephs, rx, T0, DUR, cn0_db_hz=47.0,
                                        subframe_cycle=(1, 2, 3))
    l5 = scenario.build_static_scenario(ephs[:2], rx, T0, DUR,
                                        cn0_db_hz=48.0, band="L5")
    streams = {0: pgen(l1, FS_L1, int(FS_L1 * DUR), noise=True, seed=21),
               1: pgen(l5, FS_L5, int(FS_L5 * DUR), noise=True, seed=22)}
    return [e.prn for e in ephs[:2]], streams


def _gal_capture():
    """Two Galileo satellites on E1-B (I/NAV) and E5a-I (F/NAV)."""
    base = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    toe60 = round((T0 + 600) / 60.0) * 60.0
    gal = [dataclasses.replace(e, system="Galileo", prn=prn, toe=toe60,
                               toc=toe60, iod_nav=137, bgd_e1e5b=0.0)
           for prn, e in zip((11, 12), base[:2])]
    rx = _rx_true()
    e1 = scenario.build_static_scenario(gal, rx, T0, DUR, cn0_db_hz=48.0,
                                        subframe_cycle=(1, 2, 3))
    streams = {0: pgen(e1, FS_E1, int(FS_E1 * DUR), noise=True, seed=31),
               1: pgen(_e5a_sats(gal, rx, DUR), FS_L5, int(FS_L5 * DUR),
                       noise=True, seed=32)}
    return [11, 12], streams


def _run(name, conf, streams):
    """One package's session over the streams at one-size chunks (no chunk
    growth): its result, assist log, search counts and each chain's
    decimated rows (sample counter, Doppler, code phase, validity, and the
    prompt signs of every epoch), chunk by chunk."""
    acq_mod, trk_mod, rx_mod = ((pacq, ptrk, prx) if name == "port"
                                else (jacq, jtrk, jrx))
    rows = {}
    trk = trk_mod.TrackingEngine

    def process_end(self, handle, _f=trk.process_end):
        o = _f(self, handle)
        rows.setdefault(id(self), []).append(
            {k: np.asarray(o[k]).copy() for k in (
                "sample_counter", "carrier_doppler_hz",
                "code_phase_samples", "valid", "prompt", "valid_full")})
        return o
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trk, "process_end", process_end)
        kw = {"device": "cpu"} if name == "port" else {}
        s = rx_mod.Receiver(conf, **kw).start_session()
        s.max_mult = 1
        s.attach_arrays(streams)
        s.run_to_end()
    chains = {rt.spec.signal: rows.get(id(rt.trk), []) for rt in s.chains}
    return dict(session=s, run=s.result(), rows=chains)


def _both(conf_of, capture):
    prns, streams = capture()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {name: _run(name, conf_of(mod, prns), streams)
                for name, mod in (("port", prx), ("jax", jrx))}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gps_runs():
    return _both(_gps_conf, _gps_capture)


@pytest.fixture(scope="module")
def gal_runs():
    return _both(_gal_conf, _gal_capture)


def _check_runs(runs, secondary, fs_of):
    port, ref = runs["port"], runs["jax"]
    got, want = port["session"].assist_log, ref["session"].assist_log
    assert got and [g[:2] + g[3:] for g in got] == \
        [w[:2] + w[3:] for w in want]
    assert all(g[3] for g in got), got
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) < 0.5, (g, w)
    # every secondary-band search went through the assisted path
    searches = port["session"].searches
    assert searches[(secondary, "cold")] == 0, searches
    assert searches[(secondary, "assisted")] == len(got)
    assert port["run"].channel_prns == ref["run"].channel_prns
    for sig, fs in fs_of.items():
        rp, rj = (_stack(r["rows"][sig]) for r in (port, ref))
        chips = 10.23e6 if sig in ("L5", "5X") else 1.023e6
        n = min(len(rp["valid"]), len(rj["valid"]))
        for c in range(rp["valid"].shape[1]):
            both = np.flatnonzero(rp["valid"][:n, c] & rj["valid"][:n, c])
            assert len(both) > 5, (sig, c)
            e = both[-1]
            assert abs(int(rp["sample_counter"][e, c])
                       - int(rj["sample_counter"][e, c])) <= 1, (sig, c)
            assert abs(float(rp["carrier_doppler_hz"][e, c])
                       - float(rj["carrier_doppler_hz"][e, c])) < 0.5, \
                (sig, c)
            bp, bj = (float(r["sample_counter"][e, c])
                      - float(r["code_phase_samples"][e, c])
                      for r in (rp, rj))
            assert abs(bp - bj) * chips / fs < 0.25, (sig, c, bp, bj)
        m = min(len(rp["valid_full"]), len(rj["valid_full"]))
        for c in range(rp["valid_full"].shape[1]):
            vf = np.flatnonzero(rp["valid_full"][:m, c]
                                & rj["valid_full"][:m, c])
            vf = vf[len(vf) // 2:]
            assert len(vf) > 100, (sig, c)
            agree = (np.sign(rp["prompt"][vf, c])
                     == np.sign(rj["prompt"][vf, c]))
            assert agree.all() or not agree.any(), (sig, c)


def _stack(chunks):
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def test_gps_l1_l5_receivers_agree(gps_runs):
    _check_runs(gps_runs, "L5", {"1C": FS_L1, "L5": FS_L5})
    for name in ("port", "jax"):
        run = gps_runs[name]["run"]
        assert run.channel_prns[6:] == [1, 2]


def test_galileo_e1_e5a_receivers_agree(gal_runs):
    _check_runs(gal_runs, "5X", {"1B": FS_E1, "5X": FS_L5})


def test_session_bookkeeping_matches_jax():
    """The primary-domain end, the totals and the conversions of two
    streams of different rates and lengths, with the L5 stream the
    shorter in time and then the longer."""
    for l1_s, l5_s in ((0.31, 0.2503), (0.2, 0.29)):
        streams = {0: np.zeros(int(FS_L1 * l1_s) + 13, np.complex64),
                   1: np.zeros(int(FS_L5 * l5_s) + 7, np.complex64)}
        ps = prx.ReceiverSession(_gps_conf(prx, (1, 2)), device="cpu")
        js = jrx.ReceiverSession(_gps_conf(jrx, (1, 2)))
        for s in (ps, js):
            s.attach_arrays(streams)
        assert ps._end_abs == js._end_abs
        assert [rt.total for rt in ps.chains] == \
            [rt.total for rt in js.chains]
        samples = [0, 1, 7, 1999, 2_000_001, 123_456_789, 987_654_321]
        for prt, jrt in zip(ps.chains, js.chains):
            for v in samples:
                assert ps._to_chain(prt, v) == js._to_chain(jrt, v)
                assert ps._to_primary(prt, v) == js._to_primary(jrt, v)
                assert ps._to_primary(prt, v + 0.5) == \
                    js._to_primary(jrt, v + 0.5)
            assert ps._chunk_n(prt) == js._chunk_n(jrt)
            assert ps._end_rt(prt) == len(streams[prt.spec.rf_channel_id])


def test_attach_arrays_missing_stream_raises():
    s = prx.ReceiverSession(_gps_conf(prx, (1, 2)), device="cpu")
    with pytest.raises(ValueError, match="no stream for RF channel"):
        s.attach_arrays({0: np.zeros(1000, np.complex64)})


def test_acquire_assisted_matches_jax():
    """One L5 window of 2 ms from sample 301: PRN 4 at 1234 Hz searched
    around 1200 Hz, PRN 9 (absent) around -500 Hz."""
    sats = [JSat(prn=4, system="GPS", signal="L5", cn0_db_hz=48.0,
                 doppler_hz=1234.0, code_doppler_hz=1234.0,
                 carrier_ref_hz=F_L5, delay_chips=3000.5,
                 nav_bits=np.ones(40, np.int8))]
    x = jgen(sats, FS_L5, 301 + 25_000, noise=True, seed=5)
    pchain, jchain = prx.gps_l5_chain(FS_L5), jrx.gps_l5_chain(FS_L5)
    pe = pacq.PcpsAcquisitionEngine(
        pchain.acq, (4, 9), code_provider=pchain.code_provider,
        sc_rate=pchain.sc_rate, device="cpu")
    je = jacq.PcpsAcquisitionEngine(
        jchain.acq, (4, 9), code_provider=jchain.code_provider,
        sc_rate=jchain.sc_rate)
    centers = np.array([1200.0, -500.0])
    want = je.acquire_assisted(x, 301, centers)
    for xin in (x, torch.from_numpy(x)):
        got = pe.acquire_assisted(xin, 301, centers)
        assert got.samplestamp == want.samplestamp == 301
        assert list(got.detected) == list(want.detected) == [True, False]
        assert np.array_equal(got.doppler_hz, want.doppler_hz)
        assert np.array_equal(got.delay_samples, want.delay_samples)
        assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
        assert got.threshold == want.threshold
    assert abs(got.doppler_hz[0] - 1234.0) <= 62.5


def test_resampler_first_acquisition_matches_jax():
    """tests/test_multiband.py's resampler scenario cut to 0.1 s: an 8 Msps
    GPS L1 C/A chain acquiring on the x4 mean-pooled stream.  The first
    iteration's acquisition and the armed start samples (the delay
    rescaled by 4 plus the mean's group delay) equal JAX's."""
    fs, dec, dur = 8_000_000.0, 4, 0.1
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)[:4]
    sats = scenario.build_static_scenario(ephs, _rx_true(), T0, dur,
                                          cn0_db_hz=47.0,
                                          subframe_cycle=(1, 2, 3))
    x = pgen(sats, fs, int(fs * dur), noise=True, seed=23)
    prns = tuple(e.prn for e in ephs)
    out = {}
    for name, acq_mod, trk_mod, rx_mod in (("port", pacq, ptrk, prx),
                                           ("jax", jacq, jtrk, jrx)):
        chain = rx_mod.SignalChainConf(
            signal="1C", system="GPS", prns=prns, n_channels=4,
            max_acq_channels=4,
            acq=acq_mod.AcqConf(fs_in=fs / dec, max_dwells=2),
            trk=trk_mod.TrackingConf(fs=fs), acq_decim=dec)
        conf = rx_mod.ReceiverConf(fs=fs, prns=prns, gps_chain=False,
                                   chains=(chain,))
        log = []
        eng = acq_mod.PcpsAcquisitionEngine
        with pytest.MonkeyPatch.context() as mp:
            def acquire(self, xx, samplestamp=0, _f=eng.acquire):
                res = _f(self, xx, samplestamp)
                log.append(res)
                return res
            mp.setattr(eng, "acquire", acquire)
            mp.setattr(trk_mod.TrackingEngine, "process_begin",
                       lambda self, *a, **k: None)
            kw = {"device": "cpu"} if name == "port" else {}
            s = rx_mod.Receiver(conf, **kw).start_session()
            s.attach_array(x)
            assert s._iterate(True)
        rt = s.chains[0]
        out[name] = dict(log=log, start=s._trk_start_abs.copy(),
                         abs_start=rt.trk.abs_start.copy(),
                         states=[c.state.name for c in rt.mgr.channels],
                         prns=[c.prn for c in rt.mgr.channels])
    got, want = out["port"], out["jax"]
    assert len(got["log"]) == len(want["log"]) == 1
    g, w = got["log"][0], want["log"][0]
    assert list(g.detected) == list(w.detected)
    assert sum(g.detected) >= 3
    assert np.array_equal(g.delay_samples, w.delay_samples)
    assert np.array_equal(g.doppler_hz, w.doppler_hz)
    assert np.allclose(g.test_stat, w.test_stat, rtol=1e-4)
    assert np.array_equal(got["start"], want["start"])
    assert np.array_equal(got["abs_start"], want["abs_start"])
    assert got["states"] == want["states"] and got["prns"] == want["prns"]


@pytest.mark.parametrize("props", [
    {"Channels_1C.count": "4", "Channels_L5.count": "4",
     "Channels_L5.RF_channel_ID": "1",
     "SignalSource.sample_rate_rf1": "12500000"},
    {"GNSS-SDR.internal_fs_sps": "4000000", "Channels_1B.count": "4",
     "Channels_5X.count": "4", "Channels_5X.RF_channel_ID": "1",
     "SignalSource.sample_rate_rf1": "12500000"},
    {"GNSS-SDR.internal_fs_sps": "8000000", "Channels_1C.count": "4",
     "Channels_L5.count": "2",
     "GNSS-SDR.use_acquisition_resampler": "true"},
])
def test_multiband_conf_like_jax(props):
    got = receiver_conf_from_config(InMemoryConfiguration(props))
    ref = jconf_from(JConfig(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    rf = int(props.get("Channels_L5.RF_channel_ID",
                       props.get("Channels_5X.RF_channel_ID", 0)))
    assert got.chains[-1].rf_channel_id == rf
    if rf:
        assert got.rf_fs == {1: 12_500_000.0}
        assert got.chains[-1].trk.fs == got.chains[-1].acq.fs_in == 12.5e6
    # the resampler key changes nothing, in both packages
    assert all(c.acq_decim == 1 for c in got.all_chains())
