"""The port's precise products and PPP engine against the JAX package's
(both host float64 NumPy), and the PPP and orbital-EKF hooks of the port's
receiver.

- nav/precise.py on tests/test_precise.py's inline inputs: the SP3 file
  write_sp3 writes (the same bytes), its parse and interpolation, the
  clock RINEX override and parser, the IONEX grid's VTEC and slant delay,
  the Sun and Moon positions and the solid-earth tide, relative 1e-9;
- models/ppp.py on tests/test_ppp.py's and tests/test_precise.py's seeded
  synthetic epochs (static single frequency, the iono-free dual-frequency
  combination with the tropo state, SP3 orbits with the tide, an IONEX
  grid): every epoch's position within 1e-6 m of JAX's;
- the receiver: the port's PPP_Static with enable_pvt_ekf on the first
  16 s of tests/fixtures.py's control capture (device="cpu", the sky's
  ephemerides).  Every call of its PPP engine and of its orbital EKF is
  replayed through JAX's, within 1e-9; PPP ends within
  tests/test_ppp.py's 10 m.  No JAX receiver runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.models import ppp as jppp
from gnss_sim_receiver_tpu.models import pvt_ekf_orbital as jekf
from gnss_sim_receiver_tpu.models.observables import \
    ObservationEpoch as JaxEpoch
from gnss_sim_receiver_tpu.nav import ephemeris as jeph
from gnss_sim_receiver_tpu.nav import precise as jprecise
from gnss_sim_receiver_tpu.utils import geodesy
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import ppp as pppp
from gnss_sim_receiver_tpu_torch.models.pvt import PvtConf
from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                         ReceiverConf)
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from gnss_sim_receiver_tpu_torch.nav import precise as pprecise
from tests.fixtures import FS, control_scenario_capture, scenario_ephemerides
from tests.test_ppp import _epoch
from tests.test_precise import T0, WEEK, _ionex_text

C = constants.SPEED_OF_LIGHT_M_S
RTOL = 1e-9


def _port_eph(e):
    return peph.GpsEphemeris(**dataclasses.asdict(e))


def _jax_eph(e):
    return jeph.GpsEphemeris(**dataclasses.asdict(e))


def _jax_epoch(ep) -> JaxEpoch:
    return JaxEpoch(**{f.name: getattr(ep, f.name)
                       for f in dataclasses.fields(JaxEpoch)})


def _sky(prns=(1, 3, 4, 5, 9, 10), toe=T0 + 600):
    return [e for e in jeph.make_sky_constellation(40.0, -75.0, toe=toe)
            if e.prn in prns]


def _sp3_table(ephs, nt=13, step=900.0):
    tow = T0 + np.arange(nt) * step
    return tow, {e.prn: (np.stack([e.sat_pos_clock(t)[0] for t in tow]),
                         np.array([e.sat_pos_clock(t)[1] for t in tow]))
                 for e in ephs}


# ---------------------------------------------------------------------------
# precise products
# ---------------------------------------------------------------------------

def test_sp3_file_and_interpolation_like_jax(tmp_path):
    ephs = jeph.make_sky_constellation(40.0, -75.0, toe=T0 + 3600)[:4]
    tow, tab = _sp3_table(ephs)
    jp, pp = tmp_path / "jax.sp3", tmp_path / "port.sp3"
    jprecise.write_sp3(jp, WEEK, tow, tab)
    pprecise.write_sp3(pp, WEEK, tow, tab)
    assert pp.read_bytes() == jp.read_bytes()
    text = jp.read_text()
    clk = {ephs[0].prn: (np.array([T0, T0 + 7200.0]),
                         np.array([2e-6, 2.2e-6]))}
    for kw in ({}, {"clock_rinex": clk}):
        js = jprecise.Sp3Ephemeris(text).satellites(**kw)
        ps = pprecise.Sp3Ephemeris(text).satellites(**kw)
        assert set(ps) == set(js) == {e.prn for e in ephs}
        for prn in js:
            for t in (T0 + 1234.5, T0 + 4321.0, T0 + 8000.25):
                for a, b in zip(ps[prn].sat_pos_clock(t),
                                js[prn].sat_pos_clock(t)):
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


def test_clock_rinex_parser_like_jax():
    text = ("AS G05  2024  1  7  0  0  0.000000  2"
            "    1.234567890000E-04 0.0\n"
            "AS E11  2024  1  7  0  0 30.000000  2"
            "   -5.000000000000E-05 0.0\n"
            "AS G05  2024  1  7  0  5  0.000000  2"
            "    1.234600000000E-04 0.0\n")
    got, ref = pprecise.read_clock_rinex(text), jprecise.read_clock_rinex(text)
    assert got.keys() == ref.keys()
    for k in ref:
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a, b)


def test_ionex_like_jax():
    jg = jprecise.IonexTecGrid(_ionex_text())
    pg = pprecise.IonexTecGrid(_ionex_text())
    np.testing.assert_array_equal(pg.epoch_tow, jg.epoch_tow)
    rng = np.random.default_rng(2)
    for _ in range(20):
        t = rng.uniform(jg.epoch_tow[0], jg.epoch_tow[-1])
        lat, lon = rng.uniform(0, 60), rng.uniform(-120, 120)
        el = rng.uniform(0.1, np.pi / 2)
        assert pg.vtec(t, lat, lon) == pytest.approx(
            jg.vtec(t, lat, lon), rel=RTOL, abs=0)
        assert pg.slant_delay_m(t, lat, lon, el, 1575.42e6) == \
            pytest.approx(jg.slant_delay_m(t, lat, lon, el, 1575.42e6),
                          rel=RTOL, abs=0)


@pytest.mark.parametrize("dt_h", [0.0, 6.0, 17.5])
def test_sun_moon_and_tide_like_jax(dt_h):
    t = T0 + dt_h * 3600.0
    for a, b in zip(pprecise.sun_moon_ecef(WEEK, t),
                    jprecise.sun_moon_ecef(WEEK, t)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    rx = geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
    np.testing.assert_allclose(pprecise.solid_earth_tide(WEEK, t, rx),
                               jprecise.solid_earth_tide(WEEK, t, rx),
                               rtol=RTOL, atol=1e-15)


# ---------------------------------------------------------------------------
# the PPP engine on synthetic epochs
# ---------------------------------------------------------------------------

def _same_ppp(p, j, what, atol=1e-6):
    assert (p.valid, p.n_sats) == (j.valid, j.n_sats), what
    np.testing.assert_allclose(p.rx_ecef_m, j.rx_ecef_m, rtol=0, atol=atol,
                               err_msg=what)
    assert p.rx_clock_bias_s == pytest.approx(j.rx_clock_bias_s, rel=0,
                                              abs=atol / C)
    assert p.sigma_pos_m == pytest.approx(j.sigma_pos_m, rel=RTOL, abs=0)


def test_ppp_static_like_jax():
    """tests/test_ppp.py's static single-frequency scenario (seed 11, 120
    epochs, 1 m code, 3 mm carrier), the LS fix of JAX as x0 for both."""
    from gnss_sim_receiver_tpu.models.pvt import solve_pvt
    rng = np.random.default_rng(11)
    rx = geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
    ephs = _sky()
    prns = [e.prn for e in ephs]
    j_ephs = {e.prn: e for e in ephs}
    p_ephs = {e.prn: _port_eph(e) for e in ephs}
    amb = rng.integers(-50, 50, len(ephs)).astype(float)
    je = jppp.PppEngine(jppp.PppConf(mode="static", code_sigma_m=1.0))
    pe = pppp.PppEngine(pppp.PppConf(mode="static", code_sigma_m=1.0))
    for i in range(120):
        ep = _epoch(ephs, T0 + 10.0 + i, rx, 1e-4 + 1e-9 * i, amb, rng)
        x0 = solve_pvt(ep, prns, j_ephs).rx_ecef_m
        js = je.update(ep, prns, j_ephs, x0=x0)
        ps = pe.update(interop.observation_epoch_from(ep), prns, p_ephs,
                       x0=x0)
        _same_ppp(ps, js, f"epoch {i}")
    assert np.linalg.norm(ps.rx_ecef_m - rx) < 0.5


def test_ppp_iono_free_like_jax():
    """tests/test_ppp.py's dual-frequency scenario (seed 8): seven
    satellites on L1 and L5, 1.5 to 4 m of iono, 0.15 m of residual ZTD,
    240 epochs at 0.5 s, through the iono-free combination."""
    f1, f5 = 1575.42e6, 1176.45e6
    lam1, lam5 = C / f1, C / f5
    t0 = 345600.0
    rx = geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
    ephs = {e.prn: e for e in jeph.make_sky_constellation(
        40.0, -75.0, toe=t0 + 600)[:7]}
    p_ephs = {k: _port_eph(e) for k, e in ephs.items()}
    prn_list = sorted(ephs)
    n_sat = len(prn_list)
    prns = prn_list + prn_list
    systems = ["GPS"] * (2 * n_sat)
    freqs = np.array([f1] * n_sat + [f5] * n_sat)
    rng = np.random.default_rng(8)
    iono_l1 = rng.uniform(1.5, 4.0, n_sat)
    amb = rng.integers(-50, 50, 2 * n_sat).astype(float)
    kw = dict(mode="static", code_sigma_m=0.7, carrier_sigma_m=0.004)
    je, pe = jppp.PppEngine(jppp.PppConf(**kw)), pppp.PppEngine(
        pppp.PppConf(**kw))
    for k in range(240):
        t = t0 + 0.5 * k
        pr, ph, tow = (np.zeros(2 * n_sat) for _ in range(3))
        for i, prn in enumerate(prn_list):
            tau = 0.07
            for _ in range(3):
                pos, clk = ephs[prn].sat_pos_clock(np.array([t - tau]))
                ang = 7.2921151467e-5 * tau
                rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                                [-np.sin(ang), np.cos(ang), 0.0],
                                [0.0, 0.0, 1.0]])
                p_rot = rot @ pos[0]
                tau = np.linalg.norm(p_rot - rx) / C
            el, _ = geodesy.elevation_azimuth(rx, p_rot)
            mf = 1.0 / max(np.sin(el), 0.05)
            for j, (f, lam) in ((i, (f1, lam1)), (n_sat + i, (f5, lam5))):
                iono = iono_l1[i] * (f1 / f) ** 2 * mf
                pr[j] = (tau * C + iono + 0.15 * mf - C * clk[0]
                         + rng.normal(0.0, 0.5))
                ph[j] = -(tau * C - iono + 0.15 * mf - C * clk[0]
                          + lam * amb[j] + rng.normal(0.0, 0.003)) / lam
                tow[j] = (t - tau) * 1000.0
        ep = JaxEpoch(rx_time_s=t, tick_sample=0,
                      valid=np.ones(2 * n_sat, bool), pseudorange_m=pr,
                      interp_tow_ms=tow,
                      carrier_doppler_hz=np.zeros(2 * n_sat),
                      carrier_phase_cycles=ph,
                      cn0_db_hz=np.full(2 * n_sat, 45.0))
        x0 = rx + 20.0
        js = je.update(ep, prns, ephs, systems=systems,
                       carrier_freq_hz=freqs, x0=x0)
        ps = pe.update(interop.observation_epoch_from(ep), prns, p_ephs,
                       systems=systems, carrier_freq_hz=freqs, x0=x0)
        _same_ppp(ps, js, f"epoch {k}")
    np.testing.assert_allclose(pe.x, je.x, rtol=0, atol=1e-6)
    assert np.linalg.norm(ps.rx_ecef_m - rx) < 0.5


@pytest.mark.parametrize("products", ["sp3_tide", "ionex"])
def test_ppp_precise_products_like_jax(tmp_path, products):
    """tests/test_precise.py's scenarios: SP3 orbits written from the sky
    with the solid-earth tide (week given, seed 17), and a uniform-VTEC
    ionosphere removed with the IONEX grid (seed 23)."""
    rx = geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
    if products == "sp3_tide":
        rng = np.random.default_rng(17)
        truth = _sky()
        prns = [e.prn for e in truth]
        tow, tab = _sp3_table(truth)
        pprecise.write_sp3(tmp_path / "o.sp3", WEEK, tow, tab)
        text = (tmp_path / "o.sp3").read_text()
        j_sats = jprecise.Sp3Ephemeris(text).satellites()
        p_sats = pprecise.Sp3Ephemeris(text).satellites()
        amb = rng.integers(-50, 50, len(truth)).astype(float)
        epochs = [_epoch(truth, T0 + 10.0 + i, rx, 1e-4, amb, rng)
                  for i in range(60)]
        jkw, pkw = dict(week=WEEK), dict(week=WEEK)
    else:
        jg = jprecise.IonexTecGrid(_ionex_text())
        pg = pprecise.IonexTecGrid(_ionex_text())
        tow0 = float(jg.epoch_tow[0])
        truth = _sky(toe=tow0 + 600)
        prns = [e.prn for e in truth]
        j_sats = {e.prn: e for e in truth}
        p_sats = {e.prn: _port_eph(e) for e in truth}
        rng = np.random.default_rng(23)
        amb = rng.integers(-50, 50, len(truth)).astype(float)
        epochs = []
        for i in range(60):
            ep = _epoch(truth, tow0 + 10.0 + i, rx, 0.0, amb, rng,
                        code_sig=0.5)
            # a uniform 10 TECU at the zenith, mapped by elevation
            for k, e in enumerate(truth):
                el, _ = geodesy.elevation_azimuth(
                    rx, e.sat_pos_clock(ep.interp_tow_ms[k] / 1e3)[0])
                d = jg.slant_delay_m(ep.rx_time_s, 40.0, -75.0, el,
                                     constants.GPS_L1_FREQ_HZ)
                ep.pseudorange_m[k] += d
                ep.carrier_phase_cycles[k] += d / (
                    C / constants.GPS_L1_FREQ_HZ)
            epochs.append(ep)
        jkw, pkw = dict(ionex=jg), dict(ionex=pg)
    je = jppp.PppEngine(jppp.PppConf(mode="static"))
    pe = pppp.PppEngine(pppp.PppConf(mode="static"))
    for i, ep in enumerate(epochs):
        js = je.update(ep, prns, j_sats, x0=rx + 30.0, **jkw)
        ps = pe.update(interop.observation_epoch_from(ep), prns, p_sats,
                       x0=rx + 30.0, **pkw)
        _same_ppp(ps, js, f"{products} epoch {i}")
    assert np.linalg.norm(ps.rx_ecef_m - rx) < 2.0


# ---------------------------------------------------------------------------
# the receiver: the PPP and EKF hooks, JAX's engines replayed over the calls
# ---------------------------------------------------------------------------

def _record(obj, name, calls, tag):
    fn = getattr(obj, name)

    def rec(*args, **kw):
        out = fn(*args, **kw)
        state = (None if tag == "ppp" else
                 (obj.x.copy(), obj.P.copy(), obj.t))
        calls.append((tag, args, dict(kw), out, state))
        return out
    setattr(obj, name, rec)


@pytest.fixture(scope="module")
def ppp_run():
    torch.set_num_threads(2)
    x, truth = control_scenario_capture()
    conf = ReceiverConf(fs=FS, prns=tuple(range(1, 11)), max_channels=8,
                        pvt=PvtConf(positioning_mode="PPP_Static"),
                        enable_pvt_ekf=True)
    session = Receiver(conf, device="cpu").start_session(
        ephemerides={p: _port_eph(e)
                     for p, e in scenario_ephemerides().items()})
    calls = []
    _record(session.ppp_eng, "update", calls, "ppp")
    _record(session.pvt_ekf, "init_from_fix", calls, "ekf_init")
    _record(session.pvt_ekf, "update", calls, "ekf")
    session.attach_array(x[:int(FS * 16)])
    session.run_to_end()
    return session.result(), calls, np.asarray(truth), conf


def test_receiver_ppp_and_ekf_run(ppp_run):
    run, calls, truth, _ = ppp_run
    assert run.ppp_solutions, "PPP produced no solutions"
    _, last = run.ppp_solutions[-1]
    assert np.linalg.norm(last.rx_ecef_m - truth) < 10.0
    assert run.ekf_solutions and run.solutions
    assert {c[0] for c in calls} == {"ppp", "ekf_init", "ekf"}
    for t, pos, vel, bias, drift in run.ekf_solutions:
        assert np.isfinite(pos).all() and np.isfinite(vel).all()


def test_receiver_engines_match_jax_replayed(ppp_run):
    """JAX's PppEngine and PvtEkfOrbital (its frame epoch at 0, as JAX's
    receiver builds it) fed every call the port's session made, the epochs
    as JAX's ObservationEpoch and the ephemerides as JAX's GpsEphemeris."""
    _, calls, _, conf = ppp_run
    je = jppp.PppEngine(jppp.PppConf(mode="static"))
    jf = jekf.PvtEkfOrbital(jekf.PvtEkfConf())
    assert dataclasses.asdict(conf.pvt_ekf or jekf.PvtEkfConf()) == \
        dataclasses.asdict(jekf.PvtEkfConf())
    j_ephs = {}

    def jax_ephs(ephs):
        for key, e in ephs.items():
            if key not in j_ephs or j_ephs[key][0] is not e:
                j_ephs[key] = (e, _jax_eph(e))
        return {key: j_ephs[key][1] for key in ephs}

    n = {"ppp": 0, "ekf": 0}
    for k, (tag, args, kw, out, state) in enumerate(calls):
        if tag == "ekf_init":
            jf.init_from_fix(*args, **kw)
        elif tag == "ppp":
            epoch, prns, ephs = args
            js = je.update(_jax_epoch(epoch), prns, jax_ephs(ephs), **kw)
            _same_ppp(out, js, f"call {k}", atol=1e-9)
        else:
            epoch, prns, ephs, t = args
            assert jf.update(_jax_epoch(epoch), prns, jax_ephs(ephs), t,
                             **kw) == out
        if tag != "ppp":
            x, P, t = state
            np.testing.assert_allclose(x, jf.x, rtol=RTOL, atol=1e-9)
            np.testing.assert_allclose(P, jf.P, rtol=RTOL, atol=1e-9)
            assert t == jf.t
        n[tag if tag != "ekf_init" else "ekf"] += 1
    assert n["ppp"] > 100 and n["ekf"] > 100, n

