"""The Galileo E5b-I chain of the PyTorch port against the JAX package on
the CPU, at small sizes (inputs from a seed with NumPy; tolerances stated
per test):

- the E5b-I primary codes of PRN 1-50 (the port's own
  data/galileo_e5b_codes.npz), the CS4 secondary code and the simulator's
  per-epoch CS4 spreading of I/NAV symbols, bit for bit;
- the host simulator and K6's plain version on a 7X satellite;
- tests/test_e5b.py's acquisition (12.5 Msps, two 1 ms dwells, 250 Hz then
  62.5 Hz);
- 300 epochs of per-epoch tracking at 12.5 Msps under galileo_e5b_chain's
  loops;
- the E5b I/NAV decoder (CS4 sync, word 5's anchor at 4 epochs a symbol,
  tgd = BGD(E1,E5b) (f_E1/f_E5b)^2);
- the chain's configuration.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.nav import inav as jinav
from gnss_sim_receiver_tpu.nav.ephemeris import GpsEphemeris as JEph
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu_torch import constants, interop, signals
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.nav import inav as pinav
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris as PEph
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from tests.test_torch_device_generator import _assert_agrees
from tests.test_torch_fnav_cnav import T0, _run_decoders, _same_eph
from tests.test_torch_tracking import _armed, _compare_outputs

FS = 12_500_000.0                 # tests/test_e5b.py's rate
F_E5B = 1207.14e6
S0 = 12_500                       # one 1 ms epoch at FS
PRNS = [11, 30]
DOPS = [1800.0, -2450.0]
DELAYS = [3126, 9001]             # samples

# tests/test_e5b.py:_test_eph
E5B_EPH = dict(
    prn=11, system="Galileo", week=1045, iod_nav=87, toe=345600.0,
    toc=345600.0, af0=-1.1e-4, af1=2.3e-12, af2=0.0, bgd_e1e5a=3.49e-9,
    bgd_e1e5b=4.19e-9, sqrt_a=5440.588, ecc=0.000431, m0_sc=0.17,
    delta_n_sc=1.1e-9, omega0_sc=-0.41, i0_sc=0.311, omega_sc=0.53,
    omega_dot_sc=-2.61e-9, idot_sc=-7.3e-11, cuc=3.2e-7, cus=-7.7e-6,
    crc=98.5, crs=12.4, cic=1.9e-8, cis=-4.4e-8)


def _sats(cls, n_epochs: int = 400, seed: int = 12, cn0: float = 48.0):
    """Two E5b-I satellites with random I/NAV symbols spread by CS4 as
    per-epoch signs, Doppler and code Doppler on the E5b carrier."""
    rng = np.random.default_rng(seed)
    out = []
    for p, d, n in zip(PRNS, DOPS, DELAYS):
        signs = jinav.e5b_epoch_signs(rng.integers(0, 2, n_epochs // 4))
        out.append(cls(prn=p, system="Galileo", signal="7X",
                       cn0_db_hz=cn0, doppler_hz=d, code_doppler_hz=d,
                       carrier_ref_hz=F_E5B, delay_chips=n * 10.23e6 / FS,
                       nav_bits=signs))
    return out


def test_e5b_codes_and_tables_equal_jax():
    """PRN 1-50 bit for bit from the port's own table; the SignalDef, the
    sub-chip table and the CS4 code are the JAX package's."""
    assert dataclasses.astuple(signals.GALILEO_E5B_I) == \
        dataclasses.astuple(jsig.GALILEO_E5B_I)
    assert signals.SIGNALS["7X"] is signals.GALILEO_E5B_I
    for prn in range(1, 51):
        got = signals.galileo_e5b_code(prn)
        assert got.dtype == np.float32 and got.shape == (10230,)
        assert np.array_equal(got, jsig.galileo_e5b_code(prn, "I")), prn
        assert np.array_equal(
            signals.subchip_table(signals.GALILEO_E5B_I, prn),
            jsig.subchip_table(jsig.GALILEO_E5B_I, prn)), prn
        assert np.array_equal(signals.CodeProvider("7X")(prn), got)
    cs = signals.e5b_secondary_code()
    assert cs.dtype == np.float32
    assert np.array_equal(cs, jsig.e5b_secondary_code())
    assert cs.tolist() == [-1.0, -1.0, -1.0, 1.0]
    assert constants.GALILEO_E5B_I_SECONDARY_CODE == \
        jconst.GALILEO_E5B_I_SECONDARY_CODE
    assert (constants.GALILEO_E5B_FREQ_HZ, constants.GALILEO_E5B_CODE_RATE_CPS,
            constants.GALILEO_E5B_CODE_LENGTH_CHIPS) == (
        jconst.GALILEO_E5B_FREQ_HZ, jconst.GALILEO_E5B_CODE_RATE_CPS,
        jconst.GALILEO_E5B_CODE_LENGTH_CHIPS)


def test_e5b_epoch_signs_equal_jax():
    sym = np.random.default_rng(2).integers(0, 2, 257)
    got, want = pinav.e5b_epoch_signs(sym), jinav.e5b_epoch_signs(sym)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == (4 * 257,) and np.array_equal(got, want)


def test_host_generator_equals_jax():
    """0.2 s of the two satellites, noiseless, sample for sample."""
    n = int(0.2 * FS)
    want = jgen(_sats(JSat), FS, n, start_sample=4_321, noise=False)
    got = pgen(_sats(PSat), FS, n, start_sample=4_321, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    """K6's plain version against the JAX device generator over 0.2 s
    (tests/test_device_generator.py's criteria), its anchors bit for
    bit."""
    nblk = int(0.2 * FS) // 8192
    want = jdg.generate_baseband_device(_sats(JSat), FS, nblk * 8192,
                                        noise=False)
    got = pdg.generate_baseband_device_resident(
        _sats(PSat), FS, nblk * 8192, noise=False, device="cpu").numpy()
    _assert_agrees(got, want)
    for w, g in zip(jdg._anchors(_sats(JSat), FS, 0, nblk, None),
                    pdg._anchors(_sats(PSat), FS, 0, nblk, None)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_acquisition_matches_jax():
    """tests/test_e5b.py's search on 4 ms of the two satellites in noise
    (PRN 9 absent): the same detections, Doppler (62.5 Hz step two) and
    delay, the statistic to 1e-4; PRN 11 within 3 samples of its delay."""
    acq_kw = dict(fs_in=FS, sampled_ms=1, doppler_max=5000.0,
                  doppler_step=250.0, max_dwells=2, make_two_steps=True,
                  doppler_step2=62.5)
    x = jgen(_sats(JSat), FS, int(0.004 * FS), noise=True, seed=12)
    je = jacq.PcpsAcquisitionEngine(
        jacq.AcqConf(**acq_kw), prns=[11, 30, 9],
        code_provider=lambda p: jsig.subchip_table(jsig.GALILEO_E5B_I, p),
        sc_rate=jsig.GALILEO_E5B_I.chip_rate_cps)
    pe = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(**acq_kw), prns=[11, 30, 9],
        code_provider=signals.CodeProvider("7X"),
        sc_rate=signals.GALILEO_E5B_I.chip_rate_cps, device="cpu")
    assert pe.fft_size == je.fft_size == S0
    want, got = je.acquire(x), pe.acquire(x)
    assert list(got.detected) == list(want.detected) == [True, True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    assert got.threshold == want.threshold
    err = abs(got.delay_samples[0] - DELAYS[0])
    assert min(err, S0 - err) <= 3.0


def test_per_epoch_tracking_matches_jax():
    """300 epochs of 1 ms at 12.5 Msps from the armed state, noise-free at
    48 dB-Hz with the CS4-spread symbols, under galileo_e5b_chain's loops
    (50 Hz PLL, 100-epoch FLL pull-in), with tests/test_torch_tracking.py's
    per-epoch tolerances: prompt max 2 %, median 0.2 % of the mean prompt;
    epoch ends within one sample; Doppler within 0.2 Hz; code boundary
    within 0.05 sample."""
    n_ep = 300
    x = jgen(_sats(JSat), FS, max(DELAYS) + (n_ep + 4) * S0 + 4096,
             noise=False)
    jconf = jrx.galileo_e5b_chain(FS).trk
    pconf = prx.galileo_e5b_chain(FS).trk
    for f in dataclasses.fields(pconf):
        assert getattr(pconf, f.name) == getattr(jconf, f.name), f.name
    st = _armed(jconf, PRNS, DOPS, DELAYS)
    pst = interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                         "cpu")
    tables = np.stack([jpc.bandlimited_table_normalized(
        jsig.galileo_e5b_code(p, "I"), FS, jconf.code_rate_cps, S0)
        for p in PRNS])
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    sj, oj = jtrk.track_chunk(jconf, n_ep, jnp.asarray(tables),
                              jnp.asarray(taps), jnp.asarray(x), st)
    sp, op = ptrk.track_chunk(pconf, n_ep, torch.from_numpy(tables),
                              torch.from_numpy(taps), torch.from_numpy(x),
                              pst)
    _compare_outputs(oj, op, prompt_max=0.02, prompt_med=0.002, pos_tol=1,
                     dop_tol=0.2, boundary_tol=0.05)
    assert op["valid"].all()
    dop = op["carrier_doppler_hz"].numpy()[-50:].mean(axis=0)
    assert np.abs(dop - np.asarray(DOPS)).max() < 5.0
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[k], dp[k]), k


def test_e5b_telemetry_like_jax():
    """GalileoE5bTelemetryDecoder in both packages on 1 ms prompts of a
    CS4-spread I/NAV stream (cut mid-symbol, noise, random chunks): equal
    TOW stamps, each the epoch's end in GST to 1e-9 ms, and equal
    ephemerides, tgd = BGD(E1,E5b) (1575.42 / 1207.14)^2 to 1e-15 s."""
    sym = pinav.pages_for_ephemeris(PEph(**E5B_EPH), t0_gst_s=T0,
                                    n_repeats=2)
    assert np.array_equal(sym, jinav.pages_for_ephemeris(
        JEph(**E5B_EPH), t0_gst_s=T0, n_repeats=2))
    off = 7
    epochs = pinav.e5b_epoch_signs(sym).astype(np.float64)[off:]
    rng = np.random.default_rng(31)
    soft = 3.0 * epochs + rng.standard_normal(len(epochs))
    chunks = rng.integers(500, 2500, len(soft) // 500 + 1)
    decs = (ptlm.GalileoE5bTelemetryDecoder([11]),
            jtlm.GalileoE5bTelemetryDecoder([11]))
    (tow_p, new_p), (tow_j, new_j) = _run_decoders(decs, soft, chunks)
    assert len(new_p) == len(new_j) == 1
    _same_eph(new_j[0][1], new_p[0][1])
    eph = new_p[0][1]
    assert eph.prn == 11 and eph.iod_nav == 87
    assert abs(eph.tgd - eph.bgd_e1e5b * (1575.42 / 1207.14) ** 2) < 1e-15
    assert abs(eph.bgd_e1e5b - E5B_EPH["bgd_e1e5b"]) < 2.0 ** -32
    assert np.array_equal(np.isnan(tow_p), np.isnan(tow_j))
    m = ~np.isnan(tow_p)
    assert m.sum() > 5_000 and np.array_equal(tow_p[m], tow_j[m])
    idx = np.flatnonzero(m)
    np.testing.assert_allclose(tow_p[m], T0 * 1000.0 + (off + idx + 1),
                               atol=1e-9)


def test_e5b_chain_conf_like_jax():
    """galileo_e5b_chain builds the JAX chain (compared through interop);
    its decoder is the E5b one."""
    ref = jrx.galileo_e5b_chain(FS, prns=(11,), n_channels=1)
    got = prx.galileo_e5b_chain(FS, prns=(11,), n_channels=1)
    assert got == interop._chain_from_fields(dataclasses.asdict(ref), "7X")
    assert (got.signal, got.system, got.assist_wait) == ("7X", "Galileo",
                                                         True)
    assert got.trk.nominal_epoch_samples == S0
    assert isinstance(got.telemetry_decoder([0]),
                      ptlm.GalileoE5bTelemetryDecoder)
