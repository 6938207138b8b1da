"""The port's sigma-point filters (``ops/nonlinear.py``, kernels K10a and
K10b) against the JAX package's on the CPU.

The same seeded inputs go through JAX's ``sigma_predict`` /
``sigma_update`` and the port's, whose kernels run their plain versions
(``torch.linalg.cholesky_ex``, ``torch.einsum``, ``torch.linalg.solve_ex``) on
CPU tensors: both rules, one filter and a batch of 8 (JAX's ``jax.vmap``
over filters), ``kappa`` given, the 40-step linear system of
tests/test_nonlinear.py against JAX and against the exact Kalman filter,
the tanh measurement, and the batched sin-measurement step of
``test_sigma_rules_jit_and_vmap_over_channels``.

Tolerances: both sides run float32 and factor, sum and solve in other
orders (LAPACK's and XLA's), so one step agrees to 1e-5 of the largest
magnitude of each output (measured: at most 5.1e-6); the 40-step and
150-step runs to 1e-4 of it (measured 2.3e-6 and 1.7e-5), and to the
Kalman filter within tests/test_nonlinear.py's 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.ops import nonlinear as jnl
from gnss_sim_receiver_tpu_torch.ops import cuda_build
from gnss_sim_receiver_tpu_torch.ops import nonlinear as pnl

RULES = ("cubature", "unscented")


def _close(got, want, rtol):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _spd(rng, *lead, n):
    a = rng.standard_normal((*lead, n, n))
    return (a @ np.swapaxes(a, -1, -2) / n + 0.5 * np.eye(n)).astype(
        np.float32)


def _linear_system(rng, nx=4, nz=2, T=40):
    """tests/test_nonlinear.py:_linear_system."""
    F = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    H = rng.standard_normal((nz, nx))
    Q = 0.01 * np.eye(nx)
    R = 0.1 * np.eye(nz)
    x = rng.standard_normal(nx)
    xs, zs = [], []
    for _ in range(T):
        x = F @ x + rng.multivariate_normal(np.zeros(nx), Q)
        zs.append(H @ x + rng.multivariate_normal(np.zeros(nz), R))
        xs.append(x.copy())
    return F, H, Q, R, np.array(xs), np.array(zs)


def _kf(F, H, Q, R, zs, x0, P0):
    """tests/test_nonlinear.py:_kf, the exact Kalman filter."""
    x, P = x0.copy(), P0.copy()
    for z in zs:
        x = F @ x
        P = F @ P @ F.T + Q
        S = H @ P @ H.T + R
        K = np.linalg.solve(S.T, H @ P).T
        x = x + K @ (z - H @ x)
        P = P - K @ S @ K.T
    return x, P


CASES = [(rule, batch, kappa) for rule in RULES for batch in (None, 8)
         for kappa in (None,)] + [("unscented", None, 0.5),
                                  ("unscented", 8, 2.0)]


@pytest.mark.parametrize("rule,batch,kappa", CASES)
def test_one_step_matches_jax(rule, batch, kappa):
    """A predict through a nonlinear transition, then an update through a
    nonlinear measurement, nx = 4, nz = 2."""
    rng = np.random.default_rng(11)
    nx, nz = 4, 2
    lead = () if batch is None else (batch,)
    x = rng.standard_normal((*lead, nx)).astype(np.float32)
    P = _spd(rng, *lead, n=nx)
    Q = _spd(rng, *lead, n=nx) * 0.01
    R = _spd(rng, n=nz) * 0.1
    z = rng.standard_normal((*lead, nz)).astype(np.float32)
    A = (np.eye(nx) + 0.1 * rng.standard_normal((nx, nx))).astype(np.float32)
    H = rng.standard_normal((nz, nx)).astype(np.float32)
    kw = dict(rule=rule, kappa=kappa)

    def jstep(x, P, Q, z):
        xp, Pp = jnl.sigma_predict(x, P, lambda s: jnp.tanh(A @ s), Q, **kw)
        return (xp, Pp, *jnl.sigma_update(z, xp, Pp,
                                          lambda s: jnp.sin(H @ s), R, **kw))
    if batch is not None:
        jstep = jax.vmap(jstep)
    want = jstep(*(jnp.asarray(v) for v in (x, P, Q, z)))

    At, Ht = torch.from_numpy(A), torch.from_numpy(H)
    xp, Pp = pnl.sigma_predict(torch.from_numpy(x), torch.from_numpy(P),
                               lambda s: torch.tanh(At @ s),
                               torch.from_numpy(Q), **kw)
    got = (xp, Pp, *pnl.sigma_update(torch.from_numpy(z), xp, Pp,
                                     lambda s: torch.sin(Ht @ s),
                                     torch.from_numpy(R), **kw))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)


@pytest.mark.parametrize("rule", RULES)
def test_linear_system_matches_jax_and_the_kalman_filter(rule):
    """tests/test_nonlinear.py's 40 steps: on a linear-Gaussian system both
    rules are the Kalman filter up to float32 rounding."""
    rng = np.random.default_rng(3)
    F, H, Q, R, _, zs = _linear_system(rng)
    x0, P0 = np.zeros(4), np.eye(4)
    x_kf, P_kf = _kf(F, H, Q, R, zs, x0, P0)
    jcls = jnl.CubatureFilter if rule == "cubature" else jnl.UnscentedFilter
    pcls = pnl.CubatureFilter if rule == "cubature" else pnl.UnscentedFilter
    jf = jcls(jnp.asarray(x0), jnp.asarray(P0))
    pf = pcls(x0, P0, device="cpu")
    jx, jP = jnp.asarray(x0), jnp.asarray(P0)
    px, pP = pf.get_x_pred(), pf.get_P_x_pred()
    Ft, Ht = (torch.from_numpy(m.astype(np.float32)) for m in (F, H))
    for z in zs:
        jxp, jPp = jf.predict_sequential(jx, jP, lambda s: jnp.asarray(F) @ s,
                                         jnp.asarray(Q))
        jx, jP = jf.update_sequential(jnp.asarray(z), jxp, jPp,
                                      lambda s: jnp.asarray(H) @ s,
                                      jnp.asarray(R))
        pxp, pPp = pf.predict_sequential(px, pP, lambda s: Ft @ s, Q)
        px, pP = pf.update_sequential(z, pxp, pPp, lambda s: Ht @ s, R)
    _close(px, jx, 1e-4)
    _close(pP, jP, 1e-4)
    assert np.linalg.norm(px.numpy() - x_kf) < 1e-2
    assert np.linalg.norm(pP.numpy() - P_kf) < 1e-2


def test_cubature_converges_nonlinear_measurement():
    """tests/test_nonlinear.py's tanh case: the port's CKF tracks the true
    state as JAX's does, step for step."""
    rng = np.random.default_rng(7)
    xs_true = np.cumsum(0.05 * rng.standard_normal(150)) + 1.0
    Q, R = np.array([[0.05 ** 2]]), np.array([[0.01]])
    jx, jP = jnp.array([0.0]), jnp.array([[4.0]])
    px, pP = torch.tensor([0.0]), torch.tensor([[4.0]])
    Qt, Rt = (torch.from_numpy(m.astype(np.float32)) for m in (Q, R))
    errs = []
    for xt in xs_true:
        z = np.tanh(xt) + rng.normal(0, 0.1)
        jx, jP = jnl.sigma_predict(jx, jP, lambda s: s, jnp.asarray(Q))
        jx, jP = jnl.sigma_update(jnp.array([z]), jx, jP, jnp.tanh,
                                  jnp.asarray(R))
        px, pP = pnl.sigma_predict(px, pP, lambda s: s, Qt)
        px, pP = pnl.sigma_update(torch.tensor([z], dtype=torch.float32), px,
                                  pP, torch.tanh, Rt)
        errs.append(abs(float(px[0]) - xt))
        _close(px, jx, 1e-4)
        _close(pP, jP, 1e-4)
    assert np.mean(errs[-30:]) < 0.5 * np.mean(errs[:10])
    assert np.mean(errs[-30:]) < 0.4


def test_batched_sin_measurement_matches_jax_vmap():
    """test_sigma_rules_jit_and_vmap_over_channels: one batched call
    advances 8 filters as JAX's jit(vmap(step)) does."""
    n_ch, nx = 8, 3
    F, Q, R = 0.99 * np.eye(nx), 0.01 * np.eye(nx), np.array([[0.1]])

    def jstep(x, P, z):
        xp, Pp = jnl.sigma_predict(x, P, lambda s: jnp.asarray(F) @ s,
                                   jnp.asarray(Q))
        return jnl.sigma_update(z, xp, Pp,
                                lambda s: jnp.atleast_1d(jnp.sin(s[0])),
                                jnp.asarray(R))
    z = np.linspace(-0.5, 0.5, n_ch, dtype=np.float32)[:, None]
    jx, jP = jax.jit(jax.vmap(jstep))(jnp.zeros((n_ch, nx)),
                                      jnp.tile(jnp.eye(nx), (n_ch, 1, 1)),
                                      jnp.asarray(z))
    Ft = torch.from_numpy(F.astype(np.float32))
    xp, Pp = pnl.sigma_predict(torch.zeros(n_ch, nx),
                               torch.eye(nx).repeat(n_ch, 1, 1),
                               lambda s: Ft @ s, Q)
    x2, P2 = pnl.sigma_update(torch.from_numpy(z), xp, Pp,
                              lambda s: torch.atleast_1d(torch.sin(s[0])), R)
    assert x2.shape == (n_ch, nx) and P2.shape == (n_ch, nx, nx)
    _close(x2, jx, 1e-5)
    _close(P2, jP, 1e-5)
    assert torch.all(P2[:, 0, 0] < 1.0)


@pytest.mark.parametrize("cls", ("CubatureFilter", "UnscentedFilter"))
def test_filter_classes_keep_the_reference_surface(cls):
    """initialize / predict_sequential / update_sequential and the four
    getters (nonlinear_tracking.h:71-74), float32 by default, float64 on
    request as JAX's classes under jax_enable_x64."""
    filt = getattr(pnl, cls)(nx=3, device="cpu")
    assert filt.rule == getattr(jnl, cls).rule
    assert filt.get_x_pred().shape == (3,) and filt.get_x_pred().dtype == \
        torch.float32
    xp, Pp = filt.predict_sequential(filt.get_x_est(), filt.get_P_x_est(),
                                     lambda s: 0.9 * s, 0.1 * np.eye(3))
    x, P = filt.update_sequential([0.3], xp, Pp, lambda s: s[:1],
                                  [[0.2]])
    assert filt.get_x_pred() is xp and filt.get_P_x_pred() is Pp
    assert filt.get_x_est() is x and filt.get_P_x_est() is P
    assert P.shape == (3, 3) and torch.equal(P, P.mT)
    f64 = getattr(pnl, cls)(np.zeros(2), np.eye(2), dtype=torch.float64,
                            device="cpu")
    x, P = f64.update_sequential([1.0], *f64.predict_sequential(
        f64.get_x_est(), f64.get_P_x_est(), lambda s: s, np.eye(2)),
        lambda s: s[:1], [[1.0]])
    assert x.dtype == torch.float64 and P.dtype == torch.float64


def test_unscented_weights_are_carried_unclamped():
    """kappa = 3 - nx: the centre weight is negative above 3 states, as
    JAX's (nonlinear.py:45-51), and the weights sum to 1."""
    w = pnl.sigma_weights(9, "unscented", None, torch.float32, "cpu")
    _, jw = jnl._chol_points_unscented(jnp.zeros(9), jnp.eye(9))
    assert torch.equal(w, torch.from_numpy(np.asarray(jw)))
    assert w[0] < 0 and abs(float(w.sum()) - 1.0) < 1e-6
    w = pnl.sigma_weights(4, "cubature", None, torch.float32, "cpu")
    _, jw = jnl._chol_points_cubature(jnp.zeros(4), jnp.eye(4))
    assert torch.equal(w, torch.from_numpy(np.asarray(jw)))


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """On a card (here: a tensor the device check takes for one) the
    kernels run float32 filters of at most 32 states and measurements; the
    wrappers raise before building or launching anything."""
    monkeypatch.setattr(pnl, "check_kernel_device", lambda t, what: True)
    monkeypatch.setattr(pnl, "_lib", lambda: pytest.fail("launched"))
    with pytest.raises(ValueError, match="at most 32"):
        pnl.sigma_points(torch.zeros(1, 33), torch.eye(33)[None])
    with pytest.raises(ValueError, match="at most 32"):
        pnl.sigma_moments(torch.zeros(1, 66, 33), torch.ones(66),
                          torch.eye(33))
    with pytest.raises(ValueError, match="float32"):
        pnl.sigma_points(torch.zeros(1, 4, dtype=torch.float64),
                         torch.eye(4, dtype=torch.float64)[None])


def test_sigma_library_is_one_unit_with_the_default_flags(monkeypatch,
                                                          tmp_path):
    """K10a and K10b build from csrc/sigma.cu, one unit with the default
    flags (no fast math), whose source is part of the library's hash."""
    assert cuda_build.LIBRARIES["sigma_kernels"] == ("sigma",)
    assert cuda_build.library_of("sigma") == "sigma_kernels"
    assert cuda_build.nvcc_flags("sigma") == cuda_build.NVCC_FLAGS
    assert cuda_build.included("sigma") == []
    path = cuda_build.library_path("sigma_kernels")
    assert path.name.startswith("libsigma_kernels-")
    (tmp_path / "sigma.cu").write_text(
        (cuda_build.CSRC_DIR / "sigma.cu").read_text())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert cuda_build.library_path("sigma_kernels").name == path.name
    with open(tmp_path / "sigma.cu", "a") as f:
        f.write("// edited\n")
    assert cuda_build.library_path("sigma_kernels").name != path.name
