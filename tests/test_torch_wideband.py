"""The wideband slice as a whole on the CPU: a GPS L5 + Galileo E5a conf at
20 Msps through the PyTorch port and through the JAX package.

- One GPS L5I satellite (PRN 4) and one Galileo E5a-I satellite (PRN 19),
  each pinned to the one channel of its chain, 48 dB-Hz, 1.5 s at 20 Msps,
  synthesized once by the JAX package's ``generate_baseband``.  The capture
  goes through each package's conf path (``make_receiver(conf)``'s receiver
  over the array; E5a with Galileo_E5a_Noncoherent_IQ_Acquisition_CAF and a
  500 Hz CAF window, i.e. the iq_caf search with a one-bin boxcar; L5 with
  the two-step PCPS search; both with the doubled FFT of
  bit_transition_flag, as chip_smoke.py's phase 7).  Both acquire each
  satellite at the same window with the same Doppler and delay; at the
  last epoch both report, the sample counters agree within one sample,
  the carrier Dopplers within 0.5 Hz and the code boundaries within
  0.25 chip (the float32 rounding of the jitted JAX program; ROADMAP.md
  queue 3).
- The port's host simulator (``generate_baseband``) equals the JAX
  package's for the L5 and E5a signals on a short cut, sample for sample;
  its device generator's plain version (kernel K6 on the CPU) meets
  tests/test_device_generator.py's criteria against the JAX package's,
  and its anchors are the JAX package's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models.factory import make_receiver as jmake
from gnss_sim_receiver_tpu.nav import cnav as jcnav
from gnss_sim_receiver_tpu.nav import fnav as jfnav
from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JConfig
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models.factory import make_receiver
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
from tests.test_torch_device_generator import _assert_agrees

FS = 20_000_000.0
F_L5 = 1176.45e6
DUR = 1.5
T0 = 345600.0

CONF = {
    "GNSS-SDR.internal_fs_sps": "20000000",
    "Channels_L5.count": "1", "Channels_5X.count": "1",
    "Channels.in_acquisition": "2",
    "Channel0.satellite": "4", "Channel1.satellite": "19",
    "Acquisition_L5.implementation": "GPS_L5i_PCPS_Acquisition",
    "Acquisition_L5.bit_transition_flag": "true",
    "Acquisition_5X.implementation":
        "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF",
    "Acquisition_5X.CAF_window_hz": "500",
    "Acquisition_5X.bit_transition_flag": "true",
    "Tracking_L5.implementation": "GPS_L5_DLL_PLL_Tracking",
    "Tracking_5X.implementation": "Galileo_E5a_DLL_PLL_Tracking",
    "PVT.positioning_mode": "Single", "PVT.output_rate_ms": "20",
}


def _sats(cls, n_epochs: int = 2000):
    """GPS L5 PRN 4 (CNAV at 50 bps, NH10) and Galileo E5a PRN 19 (F/NAV,
    CS20) with their per-epoch signs cut to `n_epochs` (the capture's
    length), Doppler and code Doppler on the 1176.45 MHz carrier."""
    eph = make_sky_constellation(40.0, -75.0, toe=T0 + 600)[3]
    l5 = jcnav.l5i_epoch_signs(jcnav.symbols_for_ephemeris(
        eph, T0, n_repeats=1, bps=50.0))[:n_epochs]
    e5a = jfnav.e5a_epoch_signs(jfnav.pages_for_ephemeris(
        dataclasses.replace(eph, system="Galileo", prn=19, iod_nav=137),
        T0, n_repeats=1), 19)[:n_epochs]
    return [cls(prn=4, system="GPS", signal="L5", cn0_db_hz=48.0,
                doppler_hz=1234.0, code_doppler_hz=1234.0,
                doppler_rate_hz_s=-0.6, carrier_ref_hz=F_L5,
                delay_chips=3000.5, nav_bits=l5),
            cls(prn=19, system="Galileo", signal="5X", cn0_db_hz=48.0,
                doppler_hz=-2100.0, code_doppler_hz=-2100.0,
                carrier_ref_hz=F_L5, delay_chips=7000.25,
                carrier_phase_rad=0.7, nav_bits=e5a)]


@pytest.fixture(scope="module")
def runs():
    """Both receivers once over the capture; per package its acquisitions
    (engine calls in order), the decimated tracking rows of each chain
    (sample counter, carrier Doppler, code phase, validity; chunk by
    chunk) and the run's result."""
    x = jgen(_sats(JSat), FS, int(FS * DUR), noise=True, seed=7)
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, acq_mod, trk_mod in (("port", pacq, ptrk),
                                           ("jax", jacq, jtrk)):
                acqs, rows = [], {}
                eng = acq_mod.PcpsAcquisitionEngine
                trk = trk_mod.TrackingEngine

                def acquire_from(self, xx, start, _f=eng.acquire_from,
                                 _log=acqs):
                    res = _f(self, xx, start)
                    _log.append((tuple(self.prns), res))
                    return res

                def process_end(self, handle, _f=trk.process_end,
                                _log=rows):
                    o = _f(self, handle)
                    _log.setdefault(id(self), []).append(
                        {k: np.asarray(o[k]).copy() for k in (
                            "sample_counter", "carrier_doppler_hz",
                            "code_phase_samples", "valid")})
                    return o
                mp.setattr(eng, "acquire_from", acquire_from)
                mp.setattr(trk, "process_end", process_end)
                if name == "port":
                    rx = make_receiver(InMemoryConfiguration(CONF),
                                       device="cpu")
                else:
                    rx = jmake(JConfig(CONF))
                run = rx.process_array(x)
                # the chains' engines in the order they first pulled (the
                # L5 chain dispatches first, then E5a)
                out[name] = dict(run=run, acqs=acqs,
                                 rows=[_stack(r) for r in rows.values()])
    finally:
        torch.set_num_threads(threads)
    return out


def _stack(chunks):
    """One chain's decimated rows over the run (channel 0)."""
    return {k: np.concatenate([c[k][:, 0] for c in chunks])
            for k in chunks[0]}


def test_conf_path_builds_the_jax_receiver():
    port = make_receiver(InMemoryConfiguration(CONF), device="cpu").conf
    ref = jmake(JConfig(CONF)).conf
    assert port == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert [c.signal for c in port.chains] == ["L5", "5X"]
    assert not port.gps_chain
    assert port.chains[1].acq.variant == "iq_caf"
    assert port.chains[1].acq.caf_bins == 1


def test_acquisitions_match_jax(runs):
    """The same searches at the same windows: detections, Doppler and
    delay equal, the statistic to 1e-4."""
    got, want = runs["port"]["acqs"], runs["jax"]["acqs"]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert {p for p, _ in got} == {(4,), (19,)}
    for (prns, g), (_, w) in zip(got, want):
        assert g.samplestamp == w.samplestamp, prns
        assert list(g.detected) == list(w.detected), prns
        assert np.array_equal(g.doppler_hz, w.doppler_hz), prns
        assert np.array_equal(g.delay_samples, w.delay_samples), prns
        assert np.allclose(g.test_stat, w.test_stat, rtol=1e-4), prns
        assert g.threshold == w.threshold
    first = {p: r for p, r in reversed(got)}
    assert first[(4,)].detected[0] and first[(19,)].detected[0]
    assert abs(first[(4,)].doppler_hz[0] - 1234.0) <= 62.5
    assert abs(first[(19,)].doppler_hz[0] + 2100.0) <= 250.0


def test_tracking_matches_jax_at_the_last_common_epoch(runs):
    """Each chain's channel at the last decimated epoch that both
    receivers report valid: the same epoch (sample counter within one
    sample: an epoch length rounded the other way), the carrier Doppler
    within 0.5 Hz of the JAX receiver's and 2 Hz of the truth, and the code
    boundary (the sample counter at the epoch's end less the code phase
    there) within 0.25 chip of the JAX receiver's.  Measured: L5 0.038 Hz
    and 0 chip apart; E5a 0.025 Hz and 0.17 chip apart, the sample counters
    one sample apart.  (After that epoch each chain runs a tail chunk of
    fewer epochs than a decimated row; near the capture's end the two
    receivers' last states part further, in both packages alike.)"""
    truth = {"L5": 1234.0 - 0.6 * DUR, "5X": -2100.0}
    for sig, rp, rj in zip(("L5", "5X"), runs["port"]["rows"],
                           runs["jax"]["rows"]):
        n = min(len(rp["valid"]), len(rj["valid"]))
        both = np.flatnonzero(rp["valid"][:n] & rj["valid"][:n])
        assert len(both) > 50, sig
        e = both[-1]
        assert abs(int(rp["sample_counter"][e])
                   - int(rj["sample_counter"][e])) <= 1, sig
        dop = float(rp["carrier_doppler_hz"][e])
        assert abs(dop - float(rj["carrier_doppler_hz"][e])) < 0.5, sig
        assert abs(dop - truth[sig]) < 2.0, sig
        bp, bj = (float(r["sample_counter"][e])
                  - float(r["code_phase_samples"][e]) for r in (rp, rj))
        assert abs(bp - bj) * 10.23e6 / FS < 0.25, (sig, bp, bj)
    for name in ("port", "jax"):
        run = runs[name]["run"]
        assert sorted(run.channel_systems) == ["GPS", "Galileo"]
        assert run.channel_prns == [4, 19]


@pytest.mark.parametrize("sig", ["L5", "5X"])
def test_bit_transition_searches_match_jax(sig):
    """The chains' searches with the doubled FFT of bit_transition_flag
    (L5: two-step PCPS; E5a: iq_caf, b=1) on 6 ms of the capture from a
    window off the 128-sample grid, against the JAX engines: the same
    detections, Doppler, delay (mod one code period) and threshold, the
    statistic to 1e-4."""
    pchain = {c.signal: c for c in make_receiver(
        InMemoryConfiguration(CONF), device="cpu").conf.chains}[sig]
    jchain = {c.signal: c for c in jmake(JConfig(CONF)).conf.chains}[sig]
    assert pchain.acq.bit_transition_flag and jchain.acq.bit_transition_flag
    prns = (4, 9) if sig == "L5" else (19, 27)
    pe = pacq.PcpsAcquisitionEngine(
        pchain.acq, prns, code_provider=pchain.code_provider,
        sc_rate=pchain.sc_rate, code_provider2=pchain.data_code_provider,
        device="cpu")
    je = jacq.PcpsAcquisitionEngine(
        jchain.acq, prns, code_provider=jchain.code_provider,
        sc_rate=jchain.sc_rate, code_provider2=jchain.data_code_provider)
    assert pe.fft_size == je.fft_size == 40_000
    assert pe.n_samples_needed == je.n_samples_needed
    x = jgen(_sats(JSat, 40), FS, 120_000, noise=True, seed=3)
    start = 1_001
    want = je.acquire_from(x, start)
    got = pe.acquire_from(x, start)
    assert list(got.detected) == list(want.detected) == [True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert got.delay_samples[0] < 20_000
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    assert got.threshold == want.threshold


def test_host_generator_equals_jax():
    """The port's generate_baseband on the L5 and E5a signals, noiseless,
    over 4 anchor blocks from a start past the 70 ms signal delay."""
    n = 4 * 8192
    want = jgen(_sats(JSat, 40), FS, n, start_sample=123_457, noise=False)
    got = pgen(_sats(PSat, 40), FS, n, start_sample=123_457, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    n = 30 * 8192
    want = jdg.generate_baseband_device(_sats(JSat, 40), FS, n,
                                        noise=False)
    got = pdg.generate_baseband_device_resident(
        _sats(PSat, 40), FS, n, noise=False, device="cpu").numpy()
    _assert_agrees(got, want)
    for w, g in zip(jdg._anchors(_sats(JSat, 40), FS, 0, 30, None),
                    pdg._anchors(_sats(PSat, 40), FS, 0, 30, None)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
