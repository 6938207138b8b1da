"""The port's celestial environment and orbital-dynamics PVT EKF against
the JAX package's (both host float64 NumPy).

- utils/environment.py: gravity, its Jacobian and the frame rotations of
  the Earth and Moon models, relative 1e-12;
- models/pvt_ekf_orbital.py on tests/test_pvt_ekf_orbital.py's LEO epochs
  (seed 7, 120 epochs at 1 s): each package's EKF seeded from its own LS
  fix of the same epoch, the state and covariance after every update and
  after a 30 s coast, relative 1e-9; and JAX's two contracts held on the
  port: the EKF beats epoch-wise LS by 0.6x, and coasts under 50 m.
"""

import dataclasses

import numpy as np
import pytest

from gnss_sim_receiver_tpu.models import pvt as jpvt
from gnss_sim_receiver_tpu.models import pvt_ekf_orbital as jekf
from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu.utils import environment as jenv
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import pvt as ppvt
from gnss_sim_receiver_tpu_torch.models import pvt_ekf_orbital as pekf
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from gnss_sim_receiver_tpu_torch.utils import environment as penv
from tests.test_pvt_ekf_orbital import T0, _epoch, _leo_state

# the JAX tests' filter tuning
CONF = dict(update_interval_s=1.0, measures_pos_sd_m=2.0,
            measures_vel_sd_ms=0.05, system_pos_sd_m=0.05,
            system_vel_sd_ms=0.01)
RTOL = 1e-9


@pytest.mark.parametrize("body", ["earth", "moon"])
def test_environment_matches_jax(body):
    rng = np.random.default_rng(3)
    jb = getattr(jenv, body)(T0)
    pb = getattr(penv, body)(T0)
    assert dataclasses.asdict(jb) == dataclasses.asdict(pb)
    assert penv.gps_to_tt(T0) == jenv.gps_to_tt(T0)
    for _ in range(5):
        pos = rng.standard_normal(3) * 7e6
        x = np.concatenate([pos, rng.standard_normal(3) * 7e3])
        t = T0 + rng.uniform(-3600.0, 3600.0)
        for name, args in (("gravity_acceleration", (pos,)),
                           ("gravity_jacobian", (pos,)),
                           ("dcm_i2fixed", (t,)),
                           ("state_i2fixed", (x, t)),
                           ("state_fixed2i", (x, t))):
            np.testing.assert_allclose(getattr(pb, name)(*args),
                                       getattr(jb, name)(*args),
                                       rtol=1e-12, atol=0, err_msg=name)


@pytest.fixture(scope="module")
def leo():
    """tests/test_pvt_ekf_orbital.py's leo_run: the same epochs (JAX
    ObservationEpoch objects and the port's copies) and each package's
    ephemerides of the same sky."""
    ephs = make_sky_constellation(0.0, 0.0, toe=T0 + 600)
    rng = np.random.default_rng(7)
    prns = [e.prn for e in ephs]
    times = T0 + np.arange(0.0, 120.0, 1.0)
    epochs, truth = [], []
    for t in times:
        st = _leo_state(t)
        epochs.append(_epoch(ephs, t, st[:3], st[3:6], 1e-4, rng))
        truth.append(st)
    j_ephs = {e.prn: e for e in ephs}
    p_ephs = {e.prn: peph.GpsEphemeris(**dataclasses.asdict(e))
              for e in ephs}
    p_epochs = [interop.observation_epoch_from(e) for e in epochs]
    return prns, j_ephs, p_ephs, times, epochs, p_epochs, np.asarray(truth)


def _filters():
    return (jekf.PvtEkfOrbital(jekf.PvtEkfConf(**CONF), t0_gps_s=T0),
            pekf.PvtEkfOrbital(pekf.PvtEkfConf(**CONF), t0_gps_s=T0))


def _same_state(jf, pf, what):
    np.testing.assert_allclose(pf.x, jf.x, rtol=RTOL, atol=0,
                               err_msg=f"x {what}")
    np.testing.assert_allclose(pf.P, jf.P, rtol=RTOL,
                               atol=RTOL * np.abs(jf.P).max(),
                               err_msg=f"P {what}")
    assert pf.t == jf.t
    for a, b in zip(pf.state_ecef(), jf.state_ecef()):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                   err_msg=f"state_ecef {what}")


def test_ekf_matches_jax_every_update_and_coast(leo):
    prns, j_ephs, p_ephs, times, epochs, p_epochs, _ = leo
    jf, pf = _filters()
    for k in range(60):
        js = jpvt.solve_pvt(epochs[k], prns, j_ephs)
        ps = ppvt.solve_pvt(p_epochs[k], prns, p_ephs)
        assert js.valid and ps.valid
        if not jf.initialized:
            jf.init_from_fix(js, times[k])
            pf.init_from_fix(ps, times[k])
        else:
            assert (pf.update(p_epochs[k], prns, p_ephs, times[k])
                    == jf.update(epochs[k], prns, j_ephs, times[k]))
        _same_state(jf, pf, f"epoch {k}")
    # a 30 s outage on the dynamics alone, then the reacquisition
    jf.propagate_to(times[59] + 30.0)
    pf.propagate_to(times[59] + 30.0)
    _same_state(jf, pf, "after the 30 s coast")
    for k in range(90, len(times)):
        assert (pf.update(p_epochs[k], prns, p_ephs, times[k])
                == jf.update(epochs[k], prns, j_ephs, times[k]))
        _same_state(jf, pf, f"epoch {k} after the outage")


def test_ekf_beats_ls_noise(leo):
    """tests/test_pvt_ekf_orbital.py's first contract on the port."""
    prns, _, p_ephs, times, _, p_epochs, truth = leo
    _, ekf = _filters()
    ls_errs, ekf_errs = [], []
    for k, (t, ep) in enumerate(zip(times, p_epochs)):
        sol = ppvt.solve_pvt(ep, prns, p_ephs)
        assert sol.valid
        ls_errs.append(np.linalg.norm(sol.rx_ecef_m - truth[k, :3]))
        if not ekf.initialized:
            ekf.init_from_fix(sol, t)
            continue
        assert ekf.update(ep, prns, p_ephs, t)
        ekf_errs.append(np.linalg.norm(ekf.state_ecef()[0] - truth[k, :3]))
    ls_rms = float(np.sqrt(np.mean(np.square(ls_errs[60:]))))
    ekf_rms = float(np.sqrt(np.mean(np.square(ekf_errs[60:]))))
    assert ekf_rms < 0.6 * ls_rms, (ekf_rms, ls_rms)


def test_ekf_coasts_through_outage(leo):
    """tests/test_pvt_ekf_orbital.py's second contract on the port."""
    prns, _, p_ephs, times, _, p_epochs, truth = leo
    _, ekf = _filters()
    for k in range(60):
        if not ekf.initialized:
            ekf.init_from_fix(ppvt.solve_pvt(p_epochs[k], prns, p_ephs),
                              times[k])
            continue
        ekf.update(p_epochs[k], prns, p_ephs, times[k])
    t_out = times[59] + 30.0
    ekf.propagate_to(t_out)
    err = np.linalg.norm(ekf.state_ecef()[0] - _leo_state(t_out)[:3])
    assert err < 50.0, err
    for k in range(90, len(times)):
        ekf.update(p_epochs[k], prns, p_ephs, times[k])
    err2 = np.linalg.norm(ekf.state_ecef()[0] - truth[-1, :3])
    assert err2 < 5.0, err2


def test_ekf_conf_crosses_by_interop():
    """A JAX ReceiverConf with the EKF on and its conf becomes the port's,
    the EKF's conf field for field."""
    from gnss_sim_receiver_tpu.models.receiver import ReceiverConf
    ref = ReceiverConf(enable_pvt_ekf=True, pvt_ekf=jekf.PvtEkfConf(
        frame="MCI", outlier_sigma=5.0))
    got = interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got.enable_pvt_ekf
    assert dataclasses.asdict(got.pvt_ekf) == dataclasses.asdict(ref.pvt_ekf)
    assert pekf.PvtEkfOrbital(got.pvt_ekf).body.name == "Moon"
