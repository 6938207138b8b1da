"""The single-point PVT modes of the PyTorch port against the JAX package
on the CPU (inputs from a seed with NumPy; tolerances stated per test):

- models/atmosphere.py: the Klobuchar and Saastamoinen delays over a grid
  of elevation, azimuth, position and time, within 1e-9 m;
- models/pvt.py: solve_pvt with SBAS fast, long-term and iono-grid
  corrections, with the broadcast and Saastamoinen models, and
  solve_pvt_raim with one planted fault: the same channels used, the
  position within 1e-6 m;
- models/pvt_kf.py: the filter's state over 20 fixes within 1e-9;
- models/observables.py: Hatch-smoothed pseudoranges within 1e-6 m;
- the factory's PVT.iono_model, trop_model, raim_fde, raim_threshold_m,
  Observables.smoothing_factor and PVT.enable_pvt_kf keys;
- the receiver session's fix with all of them on, epoch by epoch.
"""

import dataclasses

import numpy as np
import pytest

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu.models import atmosphere as jatm
from gnss_sim_receiver_tpu.models import factory as jfac
from gnss_sim_receiver_tpu.models import observables as jobs
from gnss_sim_receiver_tpu.models import pvt as jpvt
from gnss_sim_receiver_tpu.models import pvt_kf as jkf
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models.telemetry import \
    TelemetryOutputs as JTlmOut
from gnss_sim_receiver_tpu.nav import ephemeris as jeph
from gnss_sim_receiver_tpu.nav import sbas as jsbas
from gnss_sim_receiver_tpu.utils import geodesy as jgeo
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JConfig
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import atmosphere as patm
from gnss_sim_receiver_tpu_torch.models import factory as pfac
from gnss_sim_receiver_tpu_torch.models import observables as pobs
from gnss_sim_receiver_tpu_torch.models import pvt as ppvt
from gnss_sim_receiver_tpu_torch.models import pvt_kf as pkf
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models.telemetry import \
    TelemetryOutputs as PTlmOut
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from gnss_sim_receiver_tpu_torch.nav import sbas as psbas
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration

C = jconst.SPEED_OF_LIGHT_M_S
T0 = 345600.0
ALPHA = (1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8)
BETA = (90112.0, 0.0, -196608.0, -65536.0)
RX = jgeo.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
PRNS = (1, 2, 3, 4, 5, 6, 9, 10)


def test_klobuchar_like_jax():
    """The broadcast model over elevation, azimuth, latitude, longitude
    and time of week (both branches of the cosine window, the clipped
    pierce latitude, a negative amplitude floored at 0), within 1e-9 m."""
    n = 0
    for alpha in (ALPHA, (-3e-8, 0.0, 0.0, 0.0)):
        for lat in (-80.0, 0.0, 40.0, 75.0):
            for lon in (-170.0, -75.0, 120.0):
                for el in (0.05, 0.3, 0.9, 1.5):
                    for az in (0.0, 1.9, 4.4):
                        for tow in (3600.0, 50400.0, 64000.0, 600000.0):
                            a = (alpha, BETA, np.radians(lat),
                                 np.radians(lon), el, az, tow)
                            want = jatm.klobuchar_delay(*a)
                            got = patm.klobuchar_delay(*a)
                            assert isinstance(got, float)
                            assert abs(got - want) <= 1e-9
                            n += want > 5.0
    assert n > 0


def test_saastamoinen_like_jax():
    """The tropospheric model over latitude, height (the 0 and 11 km
    clamps), elevation and humidity, within 1e-9 m."""
    for lat in (-1.2, 0.0, 0.7):
        for h in (-50.0, 0.0, 1500.0, 12000.0):
            for el in (0.05, 0.4, 1.57):
                for hum in (0.0, 0.7, 1.0):
                    want = jatm.saastamoinen_delay(lat, h, el, hum)
                    got = patm.saastamoinen_delay(lat, h, el, hum)
                    assert abs(got - want) <= 1e-9


def _ephs(mod):
    return [e for e in mod.make_sky_constellation(40.0, -75.0,
                                                   toe=T0 + 600)
            if e.prn in PRNS]


def _epoch(obs_mod, rng, t, dtr_s=1e-4, bias=None, fault=None):
    """An observation epoch of the sky at receive time t: geometric
    ranges, the satellite clocks, a receiver clock, code noise of 0.3 m,
    the range rates as Dopplers, and planted delays: per-satellite biases,
    the Klobuchar delay of ALPHA/BETA, the Saastamoinen delay, a fault
    (channel, metres)."""
    ephs = _ephs(jeph)
    n = len(ephs)
    pr, tow, dop = np.zeros(n), np.zeros(n), np.zeros(n)
    lat, lon, h = jgeo.ecef_to_llh(RX)
    om = jconst.GPS_OMEGA_EARTH_DOT

    def geometry(e, t):
        tau = 0.07
        for _ in range(4):
            pos, clk = e.sat_pos_clock(t - tau)
            ang = om * tau
            rot = np.array([[np.cos(ang), np.sin(ang), 0],
                            [-np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
            r = np.linalg.norm(rot @ pos - RX)
            tau = r / C
        return r, tau, pos, clk
    for k, e in enumerate(ephs):
        r, tau, pos, clk = geometry(e, t)
        rate = geometry(e, t + 0.5)[0] - geometry(e, t - 0.5)[0]
        dop[k] = -rate * jconst.GPS_L1_FREQ_HZ / C
        el, az = jgeo.elevation_azimuth(RX, pos)
        pr[k] = (r + C * (dtr_s - clk) + rng.standard_normal() * 0.3
                 + jatm.klobuchar_delay(ALPHA, BETA, lat, lon, el, az,
                                        t - tau)
                 + jatm.saastamoinen_delay(lat, h, el))
        if bias is not None:
            pr[k] += bias[k]
        tow[k] = (t - tau + clk) * 1000.0
    if fault is not None:
        pr[fault[0]] += fault[1]
    return obs_mod.ObservationEpoch(
        rx_time_s=t + dtr_s, tick_sample=0, valid=np.ones(n, bool),
        pseudorange_m=pr, interp_tow_ms=tow,
        carrier_doppler_hz=dop,
        carrier_phase_cycles=np.zeros(n), cn0_db_hz=np.full(n, 45.0))


def _sbas_state(mod, bias, grid: bool = True, vary: bool = False):
    """The SBAS broadcast correcting `bias` (fast PRC = -bias), a long-term
    clock delta on one satellite and, with `grid`, a vertical iono grid
    over the receiver's bands: 3 m flat, or with `vary` 2 to 3.875 m from
    IGP to IGP, so that each pierce point reads its own cells."""
    def ev(mt, payload):
        return mod.SbasMessageEvent(msg_type=mt, payload=payload,
                                    start_symbol=0, preamble_idx=0,
                                    crc_ok=True)
    corr = mod.SbasCorrections()
    corr.push(ev(1, mod.pack_mt1(list(PRNS))))
    corr.push(ev(2, mod.pack_mt2([-b for b in bias] + [0.0] * 5)))
    corr.push(ev(25, mod.pack_mt25([mod.SbasLongTerm(
        slot=2, dpos_m=(0.5, -1.0, 0.25), daf0_s=4e-9)])))
    n_igp = mod.IGP_LONS_PER_BAND * len(mod.IGP_LATS)
    for band in (2, 3) if grid else ():
        corr.push(ev(18, mod.pack_mt18(band, list(range(n_igp)))))
        for blk in range((n_igp + 14) // 15):
            corr.push(ev(26, mod.pack_mt26(
                band, blk, [2.0 + 0.125 * ((15 * blk + k) % 16) if vary
                            else 3.0 for k in range(15)])))
    return corr


def _same_fix(got, want, tol=1e-6):
    assert got.valid == want.valid
    assert np.array_equal(got.used_channels, want.used_channels)
    assert got.n_sats == want.n_sats
    assert np.abs(got.rx_ecef_m - want.rx_ecef_m).max() <= tol
    assert abs(got.rx_clock_bias_s - want.rx_clock_bias_s) * C <= tol
    assert np.abs(got.residuals_m - want.residuals_m).max() <= tol
    assert np.abs(got.rx_vel_ecef_ms - want.rx_vel_ecef_ms).max() <= tol


BIAS = [3.0, -4.5, 2.25, -1.75, 5.0, -2.5, 1.0, -3.25]


@pytest.mark.parametrize("mode", ["sbas", "models", "sbas_and_models"])
def test_solve_pvt_corrections_like_jax(mode):
    """solve_pvt on the same epoch (planted biases and atmosphere) with
    the SBAS corrections (a grid that varies from IGP to IGP, in place of
    Klobuchar), with the broadcast and Saastamoinen models, and with both:
    the same channels, position, clock and velocity within 1e-6 m (m/s),
    residuals too; the corrected fix beats the plain one."""
    use_sbas = mode != "models"
    models = mode != "sbas"
    fixes = []
    for obs_mod, eph_mod, sbas_mod, pvt_mod in (
            (jobs, jeph, jsbas, jpvt), (pobs, peph, psbas, ppvt)):
        ep = _epoch(obs_mod, np.random.default_rng(3), T0 + 60.0, bias=BIAS)
        conf = pvt_mod.PvtConf(
            iono_model="Broadcast" if models else "OFF",
            trop_model="Saastamoinen" if models else "OFF",
            iono_alpha=ALPHA, iono_beta=BETA)
        kw = dict(sbas_corrections=_sbas_state(sbas_mod, BIAS, vary=True)
                  if use_sbas else None)
        table = {e.prn: e for e in _ephs(eph_mod)}
        fixes.append((pvt_mod.solve_pvt(ep, PRNS, table, conf, **kw),
                      pvt_mod.solve_pvt(ep, PRNS, table)))
    (want, plain), (got, _) = fixes
    assert want.valid and want.n_sats == len(PRNS)
    _same_fix(got, want)
    err = np.linalg.norm(want.rx_ecef_m - RX)
    assert err < np.linalg.norm(plain.rx_ecef_m - RX)


@pytest.mark.parametrize("threshold", ["10 m", "under the worst residual",
                                       "over the worst residual"])
def test_solve_pvt_raim_like_jax(threshold):
    """solve_pvt_raim with a 60 m fault on one channel of eight (the
    broadcast and Saastamoinen models on, their delays planted), at a
    threshold of 10 m and at 0.9 and 1.1 times the plain fix's worst
    residual: the same exclusion as JAX's (the faulty channel under the
    worst residual, none over it), the position within 1e-6 m; with
    raim_fde off both return the plain solve."""
    out = []
    for obs_mod, eph_mod, pvt_mod in ((jobs, jeph, jpvt),
                                      (pobs, peph, ppvt)):
        ep = _epoch(obs_mod, np.random.default_rng(4), T0 + 90.0,
                    fault=(5, 60.0))
        table = {e.prn: e for e in _ephs(eph_mod)}
        conf = pvt_mod.PvtConf(
            iono_model="Broadcast", trop_model="Saastamoinen",
            iono_alpha=ALPHA, iono_beta=BETA, raim_threshold_m=10.0)
        plain = pvt_mod.solve_pvt_raim(ep, PRNS, table, conf,
                                       exclude_channels=(7,))
        worst = float(np.abs(plain.residuals_m).max())
        thr = {"10 m": 10.0, "under the worst residual": 0.9 * worst,
               "over the worst residual": 1.1 * worst}[threshold]
        conf = dataclasses.replace(conf, raim_fde=True,
                                   raim_threshold_m=thr)
        out.append((pvt_mod.solve_pvt_raim(ep, PRNS, table, conf,
                                           exclude_channels=(7,)), plain))
    (wr, wp), (gr, gp) = out
    _same_fix(gr, wr)
    _same_fix(gp, wp)
    assert 5 in wp.used_channels and 7 not in wp.used_channels
    if threshold == "over the worst residual":
        _same_fix(wr, wp, tol=0.0)
        return
    assert 5 not in wr.used_channels
    assert 7 not in wr.used_channels and wr.n_sats == len(PRNS) - 2
    assert np.linalg.norm(wr.rx_ecef_m - RX) < \
        0.5 * np.linalg.norm(wp.rx_ecef_m - RX)


def test_pvt_kf_like_jax():
    """PvtKf over 20 fixes of a noisy, moving receiver with an uneven
    cadence: the state, covariance and the filtered solutions within
    1e-9; reset clears it."""
    rng = np.random.default_rng(5)
    filters = (jkf.PvtKf(), pkf.PvtKf(pkf.PvtKfConf()))
    truth = np.array([1.2e6, -4.7e6, 4.0e6])
    t = 1000.0
    for i in range(20):
        t += 0.02 * (1 + i % 3)
        pos = truth + np.array([0.5, -0.2, 0.1]) * t + rng.normal(0, 1, 3)
        vel = np.array([0.5, -0.2, 0.1]) + rng.normal(0, 0.1, 3)
        sols = [mod.PvtSolution(True, pos.copy(), 0.0, vel.copy(), 0.0, t,
                                2, 2, 1, 1, 6, np.zeros(6))
                for mod in (jpvt, ppvt)]
        for kf, s in zip(filters, sols):
            kf.update(s)
        assert np.abs(sols[1].rx_ecef_m - sols[0].rx_ecef_m).max() <= 1e-9
        assert np.abs(sols[1].rx_vel_ecef_ms
                      - sols[0].rx_vel_ecef_ms).max() <= 1e-9
    jf, pf = filters
    assert np.abs(pf.x - jf.x).max() <= 1e-9
    assert np.abs(pf.p - jf.p).max() <= 1e-9 and pf.t_last == jf.t_last
    pf.reset()
    assert pf.x is None and pf.p is None and pf.t_last is None


def _track_planes(rng, t_len, first, fs=2e6, c_n=3):
    """Per-epoch tracking and telemetry planes of three channels from
    epoch `first` on: ranges drifting at their own rates, code noise of
    0.5 m on the TOW, the carrier phase following the range; channel 1
    invalid over a stretch (the smoothing filter restarts)."""
    e = first + np.arange(t_len)[:, None]
    rate = np.array([120.0, -310.0, 45.0])           # m/s
    r0 = np.array([2.1e7, 2.3e7, 2.05e7])
    t = e * 1e-3
    rng_m = r0 + rate * t
    lam = C / jconst.GPS_L1_FREQ_HZ
    tow = (T0 * 1e3 + (e + 1) * 1.0 - rng_m / C * 1e3
           + rng.normal(0.0, 0.5, (t_len, c_n)) / C * 1e3)
    outs = {"sample_counter": (e * 2000 + np.array([11, 907, 1503])
                               ).astype(np.int64),
            "code_phase_samples": rng.uniform(0.0, 1.0, (t_len, c_n)),
            "acc_phase_cycles": -rng_m / lam + 0.003 * rng.standard_normal(
                (t_len, c_n)),
            "carrier_doppler_hz": np.broadcast_to(-rate / lam,
                                                  (t_len, c_n)).copy(),
            "cn0_db_hz": np.full((t_len, c_n), 45.0),
            "valid": np.ones((t_len, c_n), bool)}
    bad = (e[:, 0] >= 700) & (e[:, 0] < 900)
    outs["valid"][bad, 1] = False
    return outs, tow


def test_hatch_smoothing_like_jax():
    """ObservablesEngine with Observables.smoothing_factor = 100 fed the
    same planes in two chunks: every epoch's validity equal and the
    smoothed pseudoranges within 1e-6 m of JAX's; the filter restarts on
    channel 1's gap.  The planes' phase follows the receiver's convention
    (it falls as the range grows), and the filter adds lambda times its
    change to the last smoothed range: the smoothed range runs away from
    the code range, by over 50 m on channel 0 (120 m/s) within 1.4 s, in
    both packages (kept as the reference does; ROADMAP.md queue 3)."""
    rng = np.random.default_rng(6)
    chunks = [_track_planes(rng, 600, 0), _track_planes(rng, 800, 600)]
    epochs = []
    for obs_mod, tlm_cls, m in ((jobs, JTlmOut, 100), (pobs, PTlmOut, 100),
                                (pobs, PTlmOut, 0)):
        eng = obs_mod.ObservablesEngine(
            obs_mod.ObsConf(fs=2e6, interval_ms=20, smoothing_factor=m,
                            history_len=2000), n_channels=3)
        out = []
        for outs, tow in chunks:
            eng.push_epochs(outs, tlm_cls(tow_at_epoch_ms=tow,
                                          tow_valid=np.ones(tow.shape,
                                                            bool),
                                          new_ephemerides=[]))
            out += eng.pull_ticks(int(outs["sample_counter"][-1].min()))
        epochs.append(out)
    want, got, raw = epochs
    assert len(got) == len(want) == len(raw) > 50
    for g, w in zip(got, want):
        assert np.array_equal(g.valid, w.valid)
        assert g.rx_time_s == w.rx_time_s
        assert np.abs(g.pseudorange_m - w.pseudorange_m).max() <= 1e-6
    diff = np.array([g.pseudorange_m - r.pseudorange_m
                     for g, r in zip(got, raw)])
    assert diff[-1, 0] < -50.0
    assert not all(g.valid[1] for g in got)


CONF_KEYS = {"PVT.iono_model": "Broadcast", "PVT.trop_model": "Saastamoinen",
             "PVT.raim_fde": "true", "PVT.raim_threshold_m": "12.5",
             "Observables.smoothing_factor": "100",
             "PVT.enable_pvt_kf": "true", "Channels_S1.count": "2"}


def test_factory_reads_the_pvt_mode_keys_like_jax():
    """A conf with every PVT mode key and an S1 chain builds the JAX
    factory's configuration (through interop), each key in its field."""
    ref = jfac.receiver_conf_from_config(JConfig(CONF_KEYS))
    got = pfac.receiver_conf_from_config(InMemoryConfiguration(CONF_KEYS))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert (got.pvt.iono_model, got.pvt.trop_model, got.pvt.raim_fde,
            got.pvt.raim_threshold_m) == ("Broadcast", "Saastamoinen", True,
                                          12.5)
    assert got.obs.smoothing_factor == 100 and got.enable_pvt_kf
    assert [c.signal for c in got.chains] == ["S1"]


def test_session_fix_with_every_mode_like_jax():
    """Each package's receiver session solves the same 20 observation
    epochs (planted biases, atmosphere and a 60 m fault) with the SBAS
    fast and long-term corrections (no grid: the broadcast iono stands),
    the broadcast iono from the decoder, Saastamoinen, RAIM and the PVT
    Kalman filter on: epoch by epoch the same channels and the filtered
    position within 1e-6 m.  The first fix (a cold start) is within 3 m;
    the later ones start from the last fix and skip the atmosphere (see
    test_warm_start_skips_the_atmosphere_like_jax)."""
    sols = []
    for obs_mod, eph_mod, sbas_mod, rx_mod, conf_of in (
            (jobs, jeph, jsbas, jrx, lambda c: c),
            (pobs, peph, psbas, prx, lambda c: interop.
             receiver_conf_from_fields(dataclasses.asdict(c)))):
        jconf = jrx.ReceiverConf(
            fs=2e6, max_channels=len(PRNS), enable_pvt_kf=True,
            pvt=jpvt.PvtConf(iono_model="Broadcast",
                             trop_model="Saastamoinen", raim_fde=True,
                             raim_threshold_m=10.0),
            chains=(jrx.sbas_l1_chain(2e6, prns=(133,), n_channels=1),))
        conf = conf_of(jconf)
        kw = {} if rx_mod is jrx else {"device": "cpu"}
        ses = rx_mod.Receiver(conf, **kw).start_session(
            ephemerides={e.prn: e for e in _ephs(eph_mod)})
        for c, prn in enumerate(PRNS):
            ses.chains[0].mgr.channels[c].prn = prn
        ses.chains[0].tlm.iono_utc = {
            **{f"alpha{i}": a for i, a in enumerate(ALPHA)},
            **{f"beta{i}": b for i, b in enumerate(BETA)}}
        ses.conf.pvt.iono_alpha = ALPHA
        ses.conf.pvt.iono_beta = BETA
        ses.sbas_corr = _sbas_state(sbas_mod, BIAS, grid=False)
        rng = np.random.default_rng(7)
        eps = [_epoch(obs_mod, rng, T0 + 60.0 + 0.02 * i, bias=BIAS,
                      fault=(3, 60.0)) for i in range(20)]
        for ep in eps:
            ep.valid = np.concatenate([ep.valid, [False]])
            for k in ("pseudorange_m", "interp_tow_ms", "carrier_doppler_hz",
                      "carrier_phase_cycles", "cn0_db_hz"):
                setattr(ep, k, np.concatenate([getattr(ep, k), [0.0]]))
        ses.obs_eng.pull_ticks = lambda bound, eps=eps: list(eps)
        ses._solve(0)
        assert ses.pvt_kf is not None
        sols.append(ses.solutions)
    want, got = sols
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert np.array_equal(g.used_channels, w.used_channels)
        assert 3 not in w.used_channels
        assert np.abs(g.rx_ecef_m - w.rx_ecef_m).max() <= 1e-6
    assert np.linalg.norm(want[0].rx_ecef_m - RX) < 3.0


def test_warm_start_skips_the_atmosphere_like_jax():
    """The reference's atmosphere block (Klobuchar, Saastamoinen, the SBAS
    iono grid) runs at the LS loop's fourth iteration; started from a
    position near the truth (the receiver's x0 = the last fix) the loop
    converges before it, so the delays are never applied: the fix equals
    the one with the models OFF (the SBAS fast and long-term corrections,
    applied before the loop, in both), in both packages, while the cold fix
    differs from it by metres (kept as the reference does; ROADMAP.md
    queue 3)."""
    for obs_mod, eph_mod, sbas_mod, pvt_mod in (
            (jobs, jeph, jsbas, jpvt), (pobs, peph, psbas, ppvt)):
        ep = _epoch(obs_mod, np.random.default_rng(8), T0 + 75.0)
        table = {e.prn: e for e in _ephs(eph_mod)}
        on = pvt_mod.PvtConf(iono_model="Broadcast",
                             trop_model="Saastamoinen", iono_alpha=ALPHA,
                             iono_beta=BETA)
        corr = _sbas_state(sbas_mod, [0.0] * len(PRNS))
        x0 = RX + np.array([0.4, -0.3, 0.2])
        cold = pvt_mod.solve_pvt(ep, PRNS, table, on, sbas_corrections=corr)
        warm = pvt_mod.solve_pvt(ep, PRNS, table, on, x0=x0,
                                 sbas_corrections=corr)
        off = pvt_mod.solve_pvt(ep, PRNS, table, x0=x0,
                                sbas_corrections=corr)
        assert np.abs(warm.rx_ecef_m - off.rx_ecef_m).max() < 1e-6
        assert np.linalg.norm(cold.rx_ecef_m - off.rx_ecef_m) > 1.0
        assert np.linalg.norm(cold.rx_ecef_m - RX) < 3.0
