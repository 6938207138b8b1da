"""The port's RTK against the JAX package's (both host float64 NumPy).

- LAMBDA (models/rtk.py): the L^T D L factorization, the decorrelation
  and the integer search on tests/test_rtk.py's seeded SPD matrices: the
  same two candidates, residuals within 1e-9 relative;
- RtkEngine static and kinematic on tests/test_rtk.py's seeded
  double-difference epochs, each package with its own ephemerides of the
  same sky: the same fixed flags, ratio within 1e-9 relative, fixed and
  float baselines within 1e-9 m;
- the RINEX observation file (models/outputs.py): both packages write the
  same bytes, and each reads what the other wrote to the same epochs;
- rtk_conf_from_config field for field;
- one receiver-level run on tests/fixtures.py's cached RTK captures: the
  port's base run (device="cpu", its first 20.5 s: the rover's 20 s span
  the pairing) through write_rinex_obs / read_rinex_obs, then the port's
  rover through the factory's RTK_Static conf with the sky's ephemerides.
  Every call of the rover's RtkEngine is recorded and replayed through
  JAX's engine (the base stream carried across by interop's types): the
  solutions agree within 1e-9, and the port meets tests/test_rtk_e2e.py's
  0.05 m fixed and 0.8 m float bounds.  No JAX receiver runs;
- K6's capture as the card makes it, on the CPU (card_capture: the
  Philox4x32-10 noise of csrc/device_generator.cu): Random123's known
  answers, the noise's moments and its count by absolute sample.  The
  witness at the end (python -m tests.test_torch_rtk) runs chip_smoke.py
  phase 19's captures through both packages' receivers with it.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import factory as jfactory
from gnss_sim_receiver_tpu.models import outputs as jout
from gnss_sim_receiver_tpu.models import rtk as jrtk
from gnss_sim_receiver_tpu.models.observables import \
    ObservationEpoch as JaxEpoch
from gnss_sim_receiver_tpu.nav import ephemeris as jeph
from gnss_sim_receiver_tpu.utils import geodesy
from gnss_sim_receiver_tpu.utils.config import \
    Configuration as JaxConfiguration
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import factory as pfactory
from gnss_sim_receiver_tpu_torch.models import outputs as pout
from gnss_sim_receiver_tpu_torch.models import rtk as prtk
from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
from tests.fixtures import (FS, rover_scenario_capture,
                            rtk_base_scenario_capture, scenario_ephemerides)
from tests.test_rtk import _epoch, _random_pd

RTOL = 1e-9


def _port_ephs(ephs: dict) -> dict:
    return {k: peph.GpsEphemeris(**dataclasses.asdict(e))
            for k, e in ephs.items()}


def _jax_epoch(ep) -> JaxEpoch:
    return JaxEpoch(**{f.name: getattr(ep, f.name)
                       for f in dataclasses.fields(JaxEpoch)})


def _same_epochs(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        for f in dataclasses.fields(JaxEpoch):
            np.testing.assert_array_equal(getattr(ea, f.name),
                                          getattr(eb, f.name), f.name)


def _same_solution(p, j, what):
    assert (p.valid, p.fixed, p.n_dd) == (j.valid, j.fixed, j.n_dd), what
    assert p.ratio == pytest.approx(j.ratio, rel=RTOL, abs=0), what
    for name in ("baseline_m", "float_baseline_m", "rover_ecef_m"):
        np.testing.assert_allclose(getattr(p, name), getattr(j, name),
                                   rtol=0, atol=1e-9,
                                   err_msg=f"{name} {what}")
    assert p.ambiguities == j.ambiguities, what


# ---------------------------------------------------------------------------
# LAMBDA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_decomposition_and_reduction_match_jax(seed):
    Q = _random_pd(np.random.default_rng(seed), 6)
    Lp, dp = prtk._ld_decomp(Q)
    Lj, dj = jrtk._ld_decomp(Q)
    np.testing.assert_allclose(Lp, Lj, rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(dp, dj, rtol=RTOL, atol=0)
    Zp = prtk._reduction(Lp, dp)
    Zj = jrtk._reduction(Lj, dj)
    np.testing.assert_array_equal(Zp, Zj)
    np.testing.assert_allclose(Lp, Lj, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(dp, dj, rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [2, 3, 4, 5, 6, 7])
def test_lambda_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 5 + seed % 3
    Q = _random_pd(rng, n, cond=200.0)
    truth = rng.integers(-20, 20, n).astype(np.float64)
    a = truth + np.linalg.cholesky(Q) @ rng.standard_normal(n) * 0.4
    cp, sp = prtk.lambda_ils(a, Q, m=2)
    cj, sj = jrtk.lambda_ils(a, Q, m=2)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_allclose(sp, sj, rtol=RTOL, atol=0)
    # the port's best candidate is the integer least-squares one (JAX's
    # brute force over a window, tests/test_rtk.py)
    Qi = np.linalg.inv(Q)
    base = np.round(a).astype(int)
    best = min((base + np.array(dz) for dz in
                itertools.product(range(-2, 3), repeat=n)),
               key=lambda z: (a - z) @ Qi @ (a - z))
    np.testing.assert_array_equal(cp[0], best)


def test_lambda_identity_easy_case():
    a = np.array([1.1, -2.2, 3.05])
    cp, sp = prtk.lambda_ils(a, np.eye(3) * 0.01, m=2)
    cj, sj = jrtk.lambda_ils(a, np.eye(3) * 0.01, m=2)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(cp[0], [1, -2, 3])
    np.testing.assert_allclose(sp, sj, rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# the engine on synthetic double differences
# ---------------------------------------------------------------------------

def _sky():
    ephs = jeph.make_sky_constellation(37.0, -122.0, toe=7200.0)[:7]
    base = np.asarray(geodesy.llh_to_ecef(np.radians(37.0),
                                          np.radians(-122.0), 30.0))
    up = base / np.linalg.norm(base)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    return ephs, base, up, east


@pytest.mark.parametrize("mode", ["static", "kinematic"])
def test_engine_matches_jax(mode):
    """tests/test_rtk.py's static (8.4 m baseline, 25 epochs, ambiguities
    of +-5e6 cycles) and kinematic (2 cm an epoch east, 30 epochs)
    scenarios, every epoch through both engines."""
    ephs, base, up, east = _sky()
    prns = [e.prn for e in ephs]
    j_ephs = {e.prn: e for e in ephs}
    p_ephs = _port_ephs(j_ephs)
    if mode == "static":
        rng = np.random.default_rng(11)
        amb_r = rng.integers(-5_000_000, 5_000_000, len(ephs)).astype(float)
        amb_b = rng.integers(-5_000_000, 5_000_000, len(ephs)).astype(float)
        kw = dict(mode="static", ratio_threshold=3.0, code_sigma_m=0.4,
                  carrier_sigma_m=0.003)
        n_ep, sig = 25, (0.4, 0.003)
    else:
        rng = np.random.default_rng(12)
        amb_r = rng.integers(-100000, 100000, len(ephs)).astype(float)
        amb_b = rng.integers(-100000, 100000, len(ephs)).astype(float)
        kw = dict(mode="kinematic", pos_process_noise_ms=1.0,
                  code_sigma_m=0.3, carrier_sigma_m=0.002)
        n_ep, sig = 30, (0.3, 0.002)
    je = jrtk.RtkEngine(jrtk.RtkConf(**kw), base_ecef_m=base)
    pe = prtk.RtkEngine(prtk.RtkConf(**kw), base_ecef_m=base)
    truth = 8.0 * east + 2.0 * np.cross(up, east) + 1.0 * up
    n_fixed = 0
    for i in range(n_ep):
        t = 7200.0 + i * 1.0
        if mode == "static":
            rover = base + truth
            er = _epoch(rover, base, ephs, t, 2.5e-4 + i * 1e-9, amb_r, rng,
                        *sig)
            eb = _epoch(base, base, ephs, t, -1.1e-4, amb_b, rng, *sig)
        else:
            rover = base + 5.0 * east + 0.02 * i * east
            er = _epoch(rover, base, ephs, t, 1e-4, amb_r, rng, *sig)
            eb = _epoch(base, base, ephs, t, -2e-4, amb_b, rng, *sig)
        js = je.update(er, eb, prns, j_ephs)
        ps = pe.update(interop.observation_epoch_from(er),
                       interop.observation_epoch_from(eb), prns, p_ephs)
        _same_solution(ps, js, f"{mode} epoch {i}")
        n_fixed += ps.fixed
    assert n_fixed > 0
    assert pe.refsat == je.refsat and pe.amb_keys == je.amb_keys


# ---------------------------------------------------------------------------
# the RINEX observation file
# ---------------------------------------------------------------------------

def _rinex_epochs():
    """Six channels (GPS L1 and L5 of PRN 3, GPS 7, Galileo 11 and 12 on
    E1, GLONASS 4), some invalid at some epochs, 20 ms apart."""
    rng = np.random.default_rng(4)
    n = 6
    out = []
    for k in range(12):
        t = 345600.0 + 0.02 * k
        valid = rng.uniform(size=n) > 0.2
        pr = 2.0e7 + rng.uniform(0, 5e6, n)
        out.append(JaxEpoch(
            rx_time_s=t, tick_sample=0, valid=valid, pseudorange_m=pr,
            interp_tow_ms=t * 1e3 - pr / 299792.458,
            carrier_doppler_hz=rng.uniform(-4000, 4000, n),
            carrier_phase_cycles=rng.uniform(-1e8, 1e8, n),
            cn0_db_hz=rng.uniform(35, 50, n)))
    prns = [3, 3, 7, 11, 12, 4]
    systems = ["GPS", "GPS", "GPS", "Galileo", "Galileo", "GLONASS"]
    freqs = [1575.42e6, 1176.45e6, 1575.42e6, 1575.42e6, 1575.42e6,
             1602.0e6]
    return out, prns, systems, freqs


@pytest.mark.parametrize("multi", [False, True])
def test_rinex_obs_files_byte_equal_and_cross_read(tmp_path, multi):
    epochs, prns, systems, freqs = _rinex_epochs()
    kw = dict(systems=systems, carrier_freq_hz=freqs) if multi else {}
    if not multi:
        prns = [1, 2, 3, 5, 6, 8]
    p_epochs = [interop.observation_epoch_from(e) for e in epochs]
    jpath, ppath = tmp_path / "jax.obs", tmp_path / "port.obs"
    jout.write_rinex_obs(jpath, epochs, prns, 2200, **kw)
    pout.write_rinex_obs(ppath, p_epochs, prns, 2200, **kw)
    assert ppath.read_bytes() == jpath.read_bytes()
    # each package reads the other's file to the same epochs and maps
    pe, pp, ps = pout.read_rinex_obs(jpath)
    je, jp, js = jout.read_rinex_obs(ppath)
    assert (pp, ps) == (jp, js)
    _same_epochs(pe, je)
    assert len(pe) == sum(e.valid.any() for e in epochs)


def test_base_observations_pairing_like_jax(tmp_path):
    """BaseObservations from a RINEX file: epoch_at on the millisecond
    grid and aligned_to into a rover channel space, as JAX's."""
    epochs, prns, _, _ = _rinex_epochs()
    prns = [1, 2, 3, 5, 6, 8]
    path = tmp_path / "base.obs"
    jout.write_rinex_obs(path, epochs, prns, 2200)
    je, jp, js = jout.read_rinex_obs(path)
    pe, pp, ps = pout.read_rinex_obs(path)
    jb = jrtk.BaseObservations(je, jp, js, np.array([1.0, 2.0, 3.0]))
    pb = prtk.BaseObservations(pe, pp, ps, np.array([1.0, 2.0, 3.0]))
    rover_prns = [8, 0, 3, 1, 9, 6]
    for t in (345600.0, 345600.0404, 345600.1, 345600.2200001, 345601.0):
        a = pb.aligned_to(t, rover_prns, ["GPS"] * 6)
        b = jb.aligned_to(t, rover_prns, ["GPS"] * 6)
        assert (a is None) == (b is None), t
        if a is not None:
            _same_epochs([a], [b])
    cross = interop.base_observations_from(jb)
    _same_epochs(cross.epochs, pb.epochs)
    assert (cross.prns, cross.systems) == (pb.prns, pb.systems)


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [
    {"PVT.positioning_mode": "RTK_Kinematic",
     "PVT.AR_ratio_threshold": "2.5", "PVT.carrier_sigma_m": "0.002"},
    {"PVT.positioning_mode": "RTK_Static", "PVT.elevation_mask": "15",
     "PVT.code_sigma_m": "0.8",
     "PVT.rtk_base_position_ecef": "1112189.9031,-4842955.0319,3985352.2"},
    {"PVT.positioning_mode": "Single"},
])
def test_rtk_conf_from_config_like_jax(keys):
    jc = jfactory.rtk_conf_from_config(JaxConfiguration(keys))
    pc = pfactory.rtk_conf_from_config(InMemoryConfiguration(keys))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    jr = jfactory.receiver_conf_from_config(JaxConfiguration(keys))
    pr = pfactory.receiver_conf_from_config(InMemoryConfiguration(keys))
    assert pr.rtk_base_ecef_m == jr.rtk_base_ecef_m
    assert (pr.rtk is None) == (jr.rtk is None)
    if pr.rtk is not None:
        assert dataclasses.asdict(pr.rtk) == dataclasses.asdict(jr.rtk)
    assert pr == interop.receiver_conf_from_fields(dataclasses.asdict(jr))


# ---------------------------------------------------------------------------
# the receiver: two port runs, JAX's engine replayed over the rover's calls
# ---------------------------------------------------------------------------

BASE_S = 20.5


def _recorded(engine, calls: list):
    """Wrap engine.update to record each call's arguments and result."""
    update = engine.update

    def rec(rover, base, prns, ephemerides, systems=None,
            carrier_freq_hz=None):
        sol = update(rover, base, prns, ephemerides, systems=systems,
                     carrier_freq_hz=carrier_freq_hz)
        calls.append((rover, base, list(prns), dict(ephemerides),
                      list(systems), np.array(carrier_freq_hz), sol))
        return sol
    engine.update = rec


@pytest.fixture(scope="module")
def rtk_runs(tmp_path_factory):
    torch.set_num_threads(2)
    x, base_true = rtk_base_scenario_capture()
    conf = pfactory.receiver_conf_from_config(InMemoryConfiguration({
        "GNSS-SDR.internal_fs_sps": str(int(FS)), "Channels_1C.count": "8"}))
    conf = dataclasses.replace(conf, prns=tuple(range(1, 11)))
    base_run = Receiver(conf, device="cpu").process_array(
        x[:int(FS * BASE_S)])
    path = tmp_path_factory.mktemp("rtk") / "base.obs"
    pout.write_rinex_obs(path, base_run.observation_epochs,
                         base_run.channel_prns, 2200)
    epochs, prns_b, sys_b = pout.read_rinex_obs(path)
    base_obs = prtk.BaseObservations(epochs=epochs, prns=prns_b,
                                     systems=sys_b,
                                     base_ecef_m=np.asarray(base_true))
    x_rover, rover_true = rover_scenario_capture()
    keys = {"GNSS-SDR.internal_fs_sps": str(int(FS)),
            "Channels_1C.count": "8", "PVT.positioning_mode": "RTK_Static",
            "PVT.AR_ratio_threshold": "2.5",
            "PVT.rtk_base_position_ecef": ",".join(
                f"{v:.4f}" for v in np.asarray(base_true))}
    rconf = pfactory.receiver_conf_from_config(InMemoryConfiguration(keys))
    rconf = dataclasses.replace(rconf, prns=tuple(range(1, 11)))
    session = Receiver(rconf, device="cpu").start_session(
        ephemerides=_port_ephs(scenario_ephemerides()),
        base_observations=base_obs)
    calls = []
    _recorded(session.rtk_eng, calls)
    session.attach_array(x_rover)
    session.run_to_end()
    run = session.result()
    truth = np.asarray(rover_true) - np.asarray(base_true)
    return dict(base_run=base_run, base_obs=base_obs, path=path, run=run,
                calls=calls, truth=truth, conf=rconf, keys=keys)


def test_rtk_receiver_meets_the_e2e_bounds(rtk_runs):
    run, truth = rtk_runs["run"], rtk_runs["truth"]
    assert rtk_runs["base_run"].observation_epochs
    assert run.rtk_solutions, "no RTK epochs formed"
    fixed = [s for _, s in run.rtk_solutions if s.fixed]
    assert fixed, f"never fixed; last ratio {run.rtk_solutions[-1][1].ratio}"
    assert np.linalg.norm(fixed[-1].baseline_m - truth) < 0.05
    assert np.linalg.norm(fixed[-1].float_baseline_m - truth) < 0.8


def test_rtk_receiver_matches_jax_engine_replayed(rtk_runs):
    """JAX's RtkEngine, built from the JAX factory's conf of the same keys,
    fed every call the port's session made: the rover epoch and the paired
    base epoch (as JAX's ObservationEpoch), the channel maps, the carrier
    map and the ephemerides (as JAX's GpsEphemeris)."""
    calls, conf = rtk_runs["calls"], rtk_runs["conf"]
    jconf = jfactory.receiver_conf_from_config(
        JaxConfiguration(rtk_runs["keys"]))
    je = jrtk.RtkEngine(jconf.rtk, base_ecef_m=np.asarray(
        jconf.rtk_base_ecef_m))
    assert dataclasses.asdict(jconf.rtk) == dataclasses.asdict(conf.rtk)
    assert len(calls) >= len(rtk_runs["run"].rtk_solutions) > 0
    j_ephs = {}
    for k, (rover, base, prns, ephs, systems, freqs, psol) in \
            enumerate(calls):
        for key, e in ephs.items():
            if key not in j_ephs or j_ephs[key][0] is not e:
                j_ephs[key] = (e, jeph.GpsEphemeris(**dataclasses.asdict(e)))
        jsol = je.update(_jax_epoch(rover), _jax_epoch(base), prns,
                         {key: j_ephs[key][1] for key in ephs},
                         systems=systems, carrier_freq_hz=freqs)
        _same_solution(psol, jsol, f"call {k}")
    # the paired base epochs are JAX's pairing of the same file
    je_, jp, js = jout.read_rinex_obs(rtk_runs["path"])
    jb = jrtk.BaseObservations(je_, jp, js, rtk_runs["base_obs"].base_ecef_m)
    rover, base, prns, _, systems, _, _ = calls[-1]
    _same_epochs([base], [jb.aligned_to(rover.rx_time_s, prns, systems)])


# ---------------------------------------------------------------------------
# K6's card capture reproduced on the CPU
# ---------------------------------------------------------------------------

_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_LO32 = np.uint64(0xFFFFFFFF)


def philox4x32_10(c0, c1, c2, c3, key0: int, key1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on uint32 counter arrays, as
    csrc/device_generator.cu's philox4x32_10 computes it."""
    c = [np.asarray(v, np.uint32) for v in (c0, c1, c2, c3)]
    k = [int(key0) & 0xFFFFFFFF, int(key1) & 0xFFFFFFFF]
    for r in range(10):
        p0 = _PHILOX_M[0] * c[0].astype(np.uint64)
        p1 = _PHILOX_M[1] * c[2].astype(np.uint64)
        c = [(p1 >> np.uint64(32)).astype(np.uint32) ^ c[1] ^ np.uint32(k[0]),
             (p1 & _LO32).astype(np.uint32),
             (p0 >> np.uint64(32)).astype(np.uint32) ^ c[3] ^ np.uint32(k[1]),
             (p0 & _LO32).astype(np.uint32)]
        k = [(k[0] + _PHILOX_W[0]) & 0xFFFFFFFF,
             (k[1] + _PHILOX_W[1]) & 0xFFFFFFFF]
    return c


def card_noise(key: int, sample0: int, n: int):
    """K6's noise on the card at absolute samples sample0 .. sample0 + n - 1
    (Box-Muller on the 24-bit uniforms of Philox4x32-10 keyed by `key`),
    scaled to unit complex variance: float32 (re, im), each within an ulp
    or so of the card's (logf and sincospif are not correctly rounded)."""
    idx = np.arange(sample0, sample0 + n, dtype=np.uint64)
    zero = np.zeros(n, np.uint32)
    r = philox4x32_10((idx & _LO32).astype(np.uint32),
                      (idx >> np.uint64(32)).astype(np.uint32), zero, zero,
                      key, key >> 32)
    u1 = (((r[0] >> np.uint32(8)) + np.uint32(1)).astype(np.float32)
          * np.float32(5.9604645e-08))
    u2 = (r[1] >> np.uint32(8)).astype(np.float32) * np.float32(5.9604645e-08)
    rad = np.sqrt(np.float32(-2.0) * np.log(u1.astype(np.float64)).astype(
        np.float32))
    a = np.pi * (np.float32(2.0) * u2).astype(np.float64)
    scale = np.float32(np.sqrt(0.5))
    return (scale * (rad * np.cos(a).astype(np.float32)),
            scale * (rad * np.sin(a).astype(np.float32)))


def card_capture(sats, fs: float, n: int, seed: int,
                 chunk: int = 1 << 22) -> np.ndarray:
    """generate_baseband_device_resident(sats, fs, n, seed=seed) as the card
    makes it, on the CPU: K6's plain noiseless samples plus the card's
    Philox noise under the key the card draws from `seed`."""
    from gnss_sim_receiver_tpu_torch.sim import device_generator as dg
    x = dg.generate_baseband_device_resident(
        sats, fs, n, noise=False, seed=seed, device="cpu").numpy()
    key, _ = dg._noise_key(True, seed, None)
    for pos in range(0, n, chunk):
        m = min(chunk, n - pos)
        re, im = card_noise(key, pos, m)
        x[pos:pos + m].real += re
        x[pos:pos + m].imag += im
    return x


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        got = philox4x32_10(*([np.uint32(v)] for v in ctr), *key)
        assert [int(v[0]) for v in got] == list(want)


def test_card_noise_is_unit_complex_gaussian():
    """2^18 samples of the card's noise: mean within 0.01, each component's
    variance within 0.01 of 0.5, and counted by the absolute sample (a
    slice drawn alone equals the same slice of a longer draw)."""
    re, im = card_noise(0x123456789ABCDEF, 3 << 32, 1 << 18)
    for v in (re, im):
        assert abs(float(v.mean())) < 0.01
        assert abs(float(v.var()) - 0.5) < 0.01
    re2, im2 = card_noise(0x123456789ABCDEF, (3 << 32) + 1000, 24)
    np.testing.assert_array_equal(re2, re[1000:1024])
    np.testing.assert_array_equal(im2, im[1000:1024])


# ---------------------------------------------------------------------------
# witness (not a test): chip_smoke.py phase 19's captures, as the card
# makes them, in both packages on the CPU
# ---------------------------------------------------------------------------

def _obs_diff(card: dict, tag: str, run) -> None:
    """The port's CPU observables on the card's capture against the card's
    (`card`: chip_smoke-style arrays of the same run on the card)."""
    eps = run.observation_epochs
    t = np.array([e.tick_sample for e in eps])
    ct = card[f"{tag}_tick"]
    common, i_cpu, i_card = np.intersect1d(t, ct, return_indices=True)
    print(f"  {tag}: {len(eps)} epochs on the CPU, {ct.size} on the card, "
          f"{common.size} at the same ticks; channel PRNs "
          f"{list(run.channel_prns)} / {list(card[f'{tag}_prns'])}")
    valid = np.array([e.valid for e in eps])[i_cpu]
    cv = card[f"{tag}_valid"][i_card]
    print(f"  {tag}: valid flags differ at {int((valid != cv).sum())} of "
          f"{valid.size}")
    both = valid & cv
    for name, key in (("pseudorange_m", "pr"), ("carrier_phase_cycles",
                                                "ph")):
        a = np.array([getattr(e, name) for e in eps])[i_cpu]
        d = np.where(both, card[f"{tag}_{key}"][i_card] - a, np.nan)
        for c in range(d.shape[1]):
            col = d[:, c][np.isfinite(d[:, c])]
            if col.size:
                print(f"    ch {c} {name}: card - CPU over {col.size} epochs"
                      f": first {col[0]:+.6f}, last {col[-1]:+.6f}, "
                      f"std {col.std():.6f}, largest |.| "
                      f"{np.abs(col).max():.6f}")
        if key == "ph":
            # between-channel differences of card - CPU phase (the part a
            # double difference keeps), relative to its first epoch
            ok = np.isfinite(d).all(axis=0)
            if ok.sum() > 1:
                sd = d[:, ok] - d[:, ok][:, :1]
                sd = sd - sd[:1]
                print(f"    single differences of the card - CPU phase "
                      f"drift by at most {np.abs(sd).max():.6f} cycles")


def witness_phase19(card_npz: str | None = None) -> None:
    """chip_smoke.py's phase 19 captures as the card makes them
    (card_capture: K6's plain noiseless samples plus the card's Philox
    noise, each capture with its seed), on the CPU: (a) each package's
    receiver runs the base (PVT_MODE_CONF) into its RINEX file and the
    rover (quantized through an ishort file) with the RTK_Static keys, and
    prints the float and fixed errors over the fixed epochs and the port's
    float less JAX's; (d) each package's LS fixes and orbital EKF on the
    16 s capture at 50 dB-Hz with the sky's ephemerides (witness_ekf).
    With `card_npz` (the same captures' samples and runs dumped on the
    card), the samples and the port's observables and RTK solutions are
    compared with the card's.  About 4 minutes and 5 GB."""
    import os
    import tempfile
    import time

    import chip_smoke as cs
    from gnss_sim_receiver_tpu.models import receiver as jrx
    from gnss_sim_receiver_tpu.utils.config import Configuration
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.utils.sample_io import (read_samples,
                                                             write_samples)
    card = dict(np.load(card_npz)) if card_npz else None
    base_true, rover_true = cs.rx_true_ecef(), cs.rover_true_ecef()
    truth = np.asarray(rover_true) - np.asarray(base_true)
    ephs = [e for e in make_sky_constellation(cs.RX_LLH[0], cs.RX_LLH[1],
                                              toe=cs.T0 + 600)
            if e.prn in cs.SCENARIO_PRNS]

    def capture(rx, dur, cn0, seed, tag):
        sats = build_static_scenario(ephs, rx, cs.T0, dur, cn0_db_hz=cn0,
                                     subframe_cycle=(1, 2, 3))
        x = card_capture(sats, cs.FS, int(cs.FS * dur), seed)
        if card is not None:
            for part in ("strided", "head"):
                got = (x[card[f"{tag}_idx"]] if part == "strided"
                       else x[:card[f"{tag}_head"].size])
                d = np.abs(got - card[f"{tag}_{part}"])
                print(f"  capture {seed}, {part} samples ({d.size}): "
                      f"largest |CPU - card| {d.max():.3e}, mean "
                      f"{d.mean():.3e}")
        return x

    keys = cs.conf_properties(cs.PVT_MODE_CONF.format(capture="-"))
    rkeys = {**keys, "PVT.positioning_mode": "RTK_Static",
             "PVT.AR_ratio_threshold": "2.5",
             "PVT.rtk_base_position_ecef": ",".join(
                 f"{v:.4f}" for v in base_true)}
    packages = {
        "jax": (lambda k: jrx.Receiver(jfactory.receiver_conf_from_config(
                    Configuration(k))), jout, jrtk),
        "port": (lambda k: Receiver(pfactory.receiver_conf_from_config(
                    InMemoryConfiguration(k)), device="cpu"), pout, prtk)}
    with tempfile.TemporaryDirectory() as tmp:
        x_base = capture(base_true, cs.RTK_BASE_DUR, cs.RTK_CN0, 191, "xb")
        cap = os.path.join(tmp, "rover.ishort")
        write_samples(cap, capture(rover_true, cs.RTK_ROVER_DUR, cs.RTK_CN0,
                                   192, "xr"), "ishort", scale=200.0)
        x_rover = read_samples(cap, "ishort")
        runs = {}
        for name, (make, out, rtk) in packages.items():
            t0 = time.perf_counter()
            base = make(keys).process_array(x_base)
            path = os.path.join(tmp, f"{name}.obs")
            out.write_rinex_obs(path, base.observation_epochs,
                                base.channel_prns,
                                next(iter(base.ephemerides.values())).week)
            epochs, prns, systems = out.read_rinex_obs(path)
            run = make(rkeys).process_array(
                x_rover, base_observations=rtk.BaseObservations(
                    epochs, prns, systems, np.asarray(base_true)))
            runs[name] = (base, run)
            fixed = [(t, np.linalg.norm(s.float_baseline_m - truth),
                      np.linalg.norm(s.baseline_m - truth), s.ratio)
                     for t, s in run.rtk_solutions if s.fixed]
            print(f"(a) {name}: {time.perf_counter() - t0:.1f} s; "
                  f"{len(run.rtk_solutions)} RTK epochs, {len(fixed)} fixed")
            for t, f, b, r in fixed[::100] + fixed[-1:]:
                print(f"  {name} t {t:.2f}: float {f:.4f} m, fixed "
                      f"{b:.4f} m, ratio {r:.2f}")
            window = [f for t, f, _, _ in fixed
                      if t > fixed[-1][0] - cs.RTK_FLOAT_WINDOW_S]
            print(f"  {name}: the last fixed epoch's float {fixed[-1][1]:.4f}"
                  f" m, its fixed {fixed[-1][2]:.4f} m; the float over the "
                  f"last {cs.RTK_FLOAT_WINDOW_S:g} s of fixed epochs: median "
                  f"{np.median(window):.4f} m, {min(window):.4f} to "
                  f"{max(window):.4f} m")
            wrong = [(t, b, r) for t, _, b, r in fixed
                     if b >= cs.RTK_FIXED_TOL_M]
            if wrong:
                t, b, r = max(wrong, key=lambda w: w[1])
                print(f"  {name}: {len(wrong)} fixed epochs "
                      f"{cs.RTK_FIXED_TOL_M} m or more off, the last at t "
                      f"{wrong[-1][0]:.2f}; the worst {b:.4f} m at ratio "
                      f"{r:.2f} (t {t:.2f})")
        fl = {}
        for name, (_, run) in runs.items():
            fl[name] = {round(t * 1e3): np.linalg.norm(
                s.float_baseline_m - truth) for t, s in run.rtk_solutions
                if s.fixed}
        last = max(fl["port"])
        both = sorted(k for k in fl["port"].keys() & fl["jax"].keys()
                      if k > last - 1e3 * cs.RTK_FLOAT_WINDOW_S)
        d = np.array([fl["port"][k] - fl["jax"][k] for k in both])
        print(f"(a) the float error, port - JAX, over the {len(both)} epochs "
              f"both fixed in the last {cs.RTK_FLOAT_WINDOW_S:g} s: mean "
              f"{d.mean():+.4f} m, {d.min():+.4f} to {d.max():+.4f} m")
        if card is not None:
            base, run = runs["port"]
            _obs_diff(card, "base", base)
            _obs_diff(card, "rover", run)
            ct = card["rover_rtk_t"]
            pt = np.array([t for t, _ in run.rtk_solutions])
            common, i_p, i_c = np.intersect1d(np.round(pt * 1e3),
                                              np.round(ct * 1e3),
                                              return_indices=True)
            pf = np.array([s.float_baseline_m
                           for _, s in run.rtk_solutions])[i_p]
            d = np.linalg.norm(pf - card["rover_rtk_float"][i_c], axis=1)
            fx = np.array([s.fixed for _, s in run.rtk_solutions])[i_p]
            n_fx = int((fx != card["rover_rtk_fixed"][i_c]).sum())
            print(f"  rover RTK: {common.size} common epochs; float card - "
                  f"CPU: last {d[-1]:.4f} m, largest {d.max():.4f} m; fixed "
                  f"flags differ at {n_fx}")
            cfix = card["rover_rtk_fixed"]
            cf = np.linalg.norm(card["rover_rtk_float"][cfix] - truth, axis=1)
            print(f"  the card's float at its last fixed epoch "
                  f"{cf[-1]:.4f} m (rx time {ct[cfix][-1]:.2f} s)")
    del x_base, x_rover
    witness_ekf(capture, cs, card)


def witness_ekf(capture, cs, card) -> None:
    """Phase 19(d): each package's LS fixes and orbital EKF on the card's
    16 s capture at 50 dB-Hz at the base position, the sky's ephemerides:
    the EKF's 3D error over all its solutions and, after its first
    EKF_SETTLE_S, beside the LS fixes' at the same epochs."""
    import time

    from gnss_sim_receiver_tpu.models import receiver as jrx
    from gnss_sim_receiver_tpu.utils.config import Configuration
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    truth = np.asarray(cs.rx_true_ecef())
    x = capture(truth, cs.PPP_DUR, cs.PPP_CN0, 193, "xp")
    ephs = {e.prn: e for e in make_sky_constellation(
        cs.RX_LLH[0], cs.RX_LLH[1], toe=cs.T0 + 600)
        if e.prn in cs.SCENARIO_PRNS}
    keys = cs.conf_properties(cs.PVT_MODE_CONF.format(capture="-"))
    for name in ("jax", "port"):
        t0 = time.perf_counter()
        if name == "jax":
            conf = jfactory.receiver_conf_from_config(Configuration(keys))
            conf = dataclasses.replace(conf, enable_pvt_ekf=True)
            run = jrx.Receiver(conf).process_array(x, ephemerides={
                p: jeph.GpsEphemeris(**dataclasses.asdict(e))
                for p, e in ephs.items()})
        else:
            conf = pfactory.receiver_conf_from_config(
                InMemoryConfiguration(keys))
            conf = dataclasses.replace(conf, enable_pvt_ekf=True)
            run = Receiver(conf, device="cpu").process_array(
                x, ephemerides=dict(ephs))
        stats = cs.ekf_stats(run, truth)
        print(f"(d) {name}: {time.perf_counter() - t0:.1f} s; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in stats.items()))
    if card is not None:
        t, p = card["ekf_ekf_t"], card["ekf_ekf_pos"]
        e = np.linalg.norm(p - truth, axis=1)
        print(f"(d) card: {t.size} EKF solutions, mean {e.mean():.4f} m, "
              f"largest {e.max():.4f} m")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_rtk [card19.npz]
    import sys
    witness_phase19(sys.argv[1] if len(sys.argv) > 1 else None)
