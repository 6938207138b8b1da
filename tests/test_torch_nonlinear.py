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
    assert cuda_build.included("sigma") == ["sigma_plan.cuh"]
    path = cuda_build.library_path("sigma_kernels")
    assert path.name.startswith("libsigma_kernels-")
    for name in ("sigma.cu", "sigma_plan.cuh"):
        (tmp_path / name).write_text(
            (cuda_build.CSRC_DIR / name).read_text())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert cuda_build.library_path("sigma_kernels").name == path.name
    names = {path.name}
    for name in ("sigma_plan.cuh", "sigma.cu"):
        with open(tmp_path / name, "a") as f:
            f.write("// edited\n")
        names.add(cuda_build.library_path("sigma_kernels").name)
    assert len(names) == 3


# ---- the lane-group kernels' order, emulated in float32 ------------------
#
# csrc/sigma.cu runs a filter on a group of G lanes (csrc/sigma_plan.cuh:
# G the next power of two at least its largest dimension and half its
# points, kThreads / G filters a CTA; above kMaxLaneGroup one warp a
# filter) and keeps the replaced kernels' order of operations element by
# element.  The emulation below repeats that order in numpy float32,
# vectorised over filters: every fused multiply-add as one rounding of the
# exact float64 product and sum (the float32 operands' product is exact in
# float64), every other operation rounded on its own.  The plan itself is
# built from its header by g++ and held below.


def _fma(a, b, c):
    """a b + c rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _emu_points(x, P, pre, post, centre):
    """K10a: a[:, c, k] is lane c's register k (row c of pre P, then of
    L).  Right-looking: column j's diagonal from lane j, sqrtf, lanes below
    divide, then each (c, m), j < m <= c, takes its k = j term."""
    b, n = x.shape
    a = (np.float32(pre) * P).astype(np.float32)
    bad = np.zeros(b, bool)
    with np.errstate(invalid="ignore", divide="ignore"):
        for j in range(n):
            diag = a[:, j, j].copy()
            bad |= ~(diag > 0)
            d = np.sqrt(diag)
            a[:, j, j] = d
            a[:, j + 1:, j] = a[:, j + 1:, j] / d[:, None]
            for m in range(j + 1, n):
                a[:, m:, m] = _fma(-a[:, m:, j], a[:, m, j][:, None],
                                   a[:, m:, m])
    spread = np.float32(post) * np.tril(a)              # [b, row, column]
    spread[bad] = np.nan
    cols = np.swapaxes(spread, 1, 2)                    # point i: column i
    pts = [x[:, None, :]] * centre + [x[:, None, :] + cols,
                                      x[:, None, :] - cols]
    return np.concatenate(pts, axis=1).astype(np.float32)


def _emu_sums(w, u, v):
    """sum_p (w_p u_pi) v_pj for every (i, j): the product w_p u_pi rounded,
    then one multiply-add a point, p in order."""
    acc = np.zeros((u.shape[0], u.shape[2], v.shape[2]), np.float32)
    for p in range(u.shape[1]):
        wu = (w[p] * u[:, p]).astype(np.float32)
        acc = _fma(wu[:, :, None], v[:, p, None, :], acc)
    return acc


def _emu_mean(w, y):
    m = np.zeros((y.shape[0], y.shape[2]), np.float32)
    for p in range(y.shape[1]):
        m = _fma(w[p], y[:, p], m)
    return m


def _emu_predict(y, w, q):
    m = _emu_mean(w, y)
    d = (y - m[:, None, :]).astype(np.float32)
    return m, (_emu_sums(w, d, d) + q).astype(np.float32)


def _emu_update(z, x, P, pts, zpts, w, R):
    """K10b's measurement update; also returns each filter's pivot rows."""
    b, _, nz = zpts.shape
    nx = x.shape[1]
    zm = _emu_mean(w, zpts)
    innov = (z - zm).astype(np.float32)
    e = (zpts - zm[:, None, :]).astype(np.float32)
    f = (pts - x[:, None, :]).astype(np.float32)
    pzz = (_emu_sums(w, e, e) + R).astype(np.float32)   # row c: lane c
    lu = np.swapaxes(pzz, 1, 2).copy()                  # P_zz^T
    kt = np.swapaxes(_emu_sums(w, f, e), 1, 2).copy()   # P_xz^T [nz, nx]
    rows = np.arange(b)
    pivots = []
    with np.errstate(invalid="ignore", divide="ignore"):
        for k in range(nz):
            # lane k's scan: the first row of largest |.| (a strict >)
            best, piv = np.abs(lu[:, k, k]), np.full(b, k)
            for r in range(k + 1, nz):
                v = np.abs(lu[:, r, k])
                take = v > best
                best, piv = np.where(take, v, best), np.where(take, r, piv)
            pivots.append(piv)
            for m in (lu, kt):
                held = m[rows, k].copy()
                m[rows, k] = m[rows, piv]
                m[rows, piv] = held
            inv = (np.float32(1.0) / lu[:, k, k]).astype(np.float32)
            for r in range(k + 1, nz):
                ell = (lu[:, r, k] * inv).astype(np.float32)
                lu[:, r, k] = ell
                lu[:, r, k + 1:] = _fma(-ell[:, None], lu[:, k, k + 1:],
                                        lu[:, r, k + 1:])
                kt[:, r] = _fma(-ell[:, None], kt[:, k], kt[:, r])
        for k in range(nz - 1, -1, -1):
            v = (kt[:, k] / lu[:, k, k][:, None]).astype(np.float32)
            kt[:, k] = v
            for i in range(k):
                kt[:, i] = _fma(-v, lu[:, i, k][:, None], kt[:, i])
    gain = np.swapaxes(kt, 1, 2)                        # K [nx, nz]
    acc = np.zeros((b, nx), np.float32)
    tt = np.zeros((b, nx, nz), np.float32)
    for k in range(nz):
        acc = _fma(gain[:, :, k], innov[:, k, None], acc)
        tt = _fma(gain[:, :, k, None], pzz[:, k, None, :], tt)
    mm = np.zeros((b, nx, nx), np.float32)
    for k in range(nz):
        mm = _fma(tt[:, :, k, None], gain[:, None, :, k], mm)
    pe = (P - mm).astype(np.float32)
    p_est = (np.float32(0.5) * (pe + np.swapaxes(pe, 1, 2))).astype(
        np.float32)
    return (x + acc).astype(np.float32), p_est, np.stack(pivots, axis=1)


def _emu_rule(n, rule):
    pre, post, centre = pnl._rule(n, rule, None, torch.float32)
    w = pnl.sigma_weights(n, rule, None, torch.float32, "cpu").numpy()
    return pre, post, centre, w


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("nx", (1, 4, 9))
def test_lane_kernels_order_matches_jax(rule, nx):
    """The emulated kernels through a predict (tanh(A s)) and an update
    (sin(H s)), each from test_one_step_matches_jax's seeded prior at nx
    states (nz = 2, or 1 at nx = 1), within 1e-5 of the largest magnitude
    of JAX's vmapped functions.  The unscented rule's centre weight at
    nx = 4 and 9 (kappa = 3 - nx) is negative and enters the sums as
    given.  (Chained, it makes the predicted P at nx = 9 indefinite: NaN
    in JAX too.)  Also an input whose mean depends on the order of the
    points."""
    rng = np.random.default_rng(11)
    batch, nz = 8, min(nx, 2)
    x = rng.standard_normal((batch, nx)).astype(np.float32)
    P = _spd(rng, batch, n=nx)
    Q = _spd(rng, batch, n=nx) * 0.01
    R = _spd(rng, n=nz) * 0.1
    z = rng.standard_normal((batch, nz)).astype(np.float32)
    A = (np.eye(nx) + 0.1 * rng.standard_normal((nx, nx))).astype(np.float32)
    H = rng.standard_normal((nz, nx)).astype(np.float32)

    def jsteps(x, P, Q, z):
        return (*jnl.sigma_predict(x, P, lambda s: jnp.tanh(A @ s), Q,
                                   rule=rule),
                *jnl.sigma_update(z, x, P, lambda s: jnp.sin(H @ s), R,
                                  rule=rule))
    want = jax.vmap(jsteps)(*(jnp.asarray(v) for v in (x, P, Q, z)))

    pre, post, centre, w = _emu_rule(nx, rule)
    assert (w[0] < 0) == (rule == "unscented" and nx > 3)
    pts = _emu_points(x, P, pre, post, centre)
    # the model functions in torch, as the port applies them
    pt = torch.from_numpy(pts)
    ypts = torch.tanh(pt @ torch.from_numpy(A).T).numpy()
    zpts = torch.sin(pt @ torch.from_numpy(H).T).numpy()
    got = (*_emu_predict(ypts, w, Q),
           *_emu_update(z, x, P, pts, zpts, w, R)[:2])
    for g, v in zip(got, want):
        assert g.dtype == np.float32
        _close(g, v, 1e-5)
    # and the points are added in order p = 0 .. Pn - 1, one multiply-add
    # each: 0.25 (4e8, -4e8, 4, 0) sums to 1 in that order and to 0 in the
    # reverse one (1 - 1e8 rounds to -1e8)
    y = np.zeros((1, 4, 2), np.float32)
    y[0, :, 0] = (4e8, -4e8, 4.0, 0.0)
    y[0, :, 1] = (1.0, 2.0, 3.0, 4.0)
    mean, _ = _emu_predict(y, _emu_rule(2, "cubature")[3],
                           np.zeros((2, 2), np.float32))
    assert mean[0, 0] == 1.0 and mean[0, 1] == 2.5


def test_lane_kernels_give_nan_points_but_the_centre():
    """A P that is not positive definite: NaN points but the centre, which
    is x exactly; the other filters untouched (unscented, nx = 4)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    P = _spd(rng, 6, n=4)
    P[::3] -= 4.0 * np.eye(4, dtype=np.float32)
    pre, post, centre, _ = _emu_rule(4, "unscented")
    pts = _emu_points(x, P, pre, post, centre)
    assert np.array_equal(pts[:, 0], x)
    assert np.isnan(pts[::3, 1:]).all()
    assert np.isfinite(pts[1::3]).all() and np.isfinite(pts[2::3]).all()
    want = pnl._sigma_points_plain(torch.from_numpy(x[1:3]),
                                   torch.from_numpy(P[1:3]), pre, post,
                                   centre)
    _close(pts[1:3], want, 1e-6)


def test_lane_kernels_pivot_on_the_first_of_tied_rows():
    """P_zz = [[s, -s], [-s, 3 s + 1/4]] exactly (zero-mean z points (1, 1)
    and (-1, -1) under the cubature weights 1/8): P_zz^T's first column
    ties in |.|, and the first row pivots, as LAPACK's getrf does."""
    rng = np.random.default_rng(6)
    b, nx = 5, 4
    x = rng.standard_normal((b, nx)).astype(np.float32)
    P = _spd(rng, b, n=nx)
    pre, post, centre, w = _emu_rule(nx, "cubature")
    pts = _emu_points(x, P, pre, post, centre)
    zpts = np.zeros((b, 2 * nx, 2), np.float32)
    zpts[:, 0], zpts[:, 1] = 1.0, -1.0
    s = np.arange(1, b + 1, dtype=np.float32)
    R = np.zeros((b, 2, 2), np.float32)
    R[:, 0, 0] = s - 0.25
    R[:, 0, 1] = R[:, 1, 0] = -s - 0.25
    R[:, 1, 1] = 3 * s
    z = np.ones((b, 2), np.float32)
    x_est, p_est, pivots = _emu_update(z, x, P, pts, zpts, w, R)
    assert np.array_equal(pivots, np.tile([0, 1], (b, 1)))
    t = torch.from_numpy
    want = pnl._sigma_moments_plain(t(zpts), t(w), t(R), t(z), t(x), t(P),
                                    t(pts))
    _close(x_est, want[0], 1e-5)
    _close(p_est, want[1], 1e-5)


_PLAN_SHIM = """
#include "sigma_plan.cuh"
using namespace sigma_plan;
extern "C" {
int plan_constant(int i) {
  const int k[] = {kThreads, kMaxLaneGroup, kMaxDim};
  return k[i];
}
int plan_group(int n, int n_pts) { return group_for(n, n_pts); }
int plan_lane_group(int n) { return lane_group(n); }
int plan_refused(int n, int n_pts) { return bad_dim(n) || bad_points(n_pts); }
unsigned plan_ctas(int batch, int g) { return ctas(batch, g); }
void plan_grid(int batch, int g, long long* filters) {
  for (unsigned b = 0; b < ctas(batch, g); ++b)
    for (unsigned t = 0; t < (unsigned)kThreads; ++t)
      filters[b * kThreads + t] = filter_of(b, t, g);
}
}
"""


@pytest.fixture(scope="module")
def sigma_plan(tmp_path_factory):
    """csrc/sigma_plan.cuh, the kernels' launch plan, built by g++ into a
    library of its own: (the library, kThreads, kMaxLaneGroup, kMaxDim)."""
    import ctypes
    import subprocess
    where = tmp_path_factory.mktemp("sigma_plan")
    (where / "plan.cpp").write_text(_PLAN_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(where / "plan.so"),
                    str(where / "plan.cpp")], check=True)
    lib = ctypes.CDLL(str(where / "plan.so"))
    lib.plan_ctas.restype = ctypes.c_uint
    lib.plan_grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return (lib, *(lib.plan_constant(i) for i in range(3)))


def test_lane_group_holds_every_point(sigma_plan):
    """The plan's G for a filter of largest dimension n summing n_pts
    points: the least of the kernels' groups that holds n lanes and
    2 G + 1 >= n_pts points, for every n and n_pts the launchers take (so
    that a time update to ny = 1 of a 4-state filter's 8 points takes
    G = 4, not 1); K10a's points (2 n or 2 n + 1) never raise it above
    lane_group(n); a 33rd dimension or a 66th point is refused."""
    lib, threads, max_group, max_dim = sigma_plan
    groups = (1, 2, 4, 8, 16, 32)
    assert max_dim == pnl.MAX_KERNEL_DIM == 32 and max_group == 16
    for n in range(1, max_dim + 1):
        assert lib.plan_lane_group(n) == min(g for g in groups if g >= n)
        for centre in (0, 1):
            assert lib.plan_group(n, 2 * n + centre) == lib.plan_lane_group(n)
        for n_pts in range(1, 2 * max_dim + 2):
            assert not lib.plan_refused(n, n_pts)
            g = lib.plan_group(n, n_pts)
            fits = [h for h in groups if h >= n and 2 * h + 1 >= n_pts]
            assert g == fits[0], (n, n_pts, g)
            assert threads % g == 0
        assert lib.plan_refused(n, 2 * max_dim + 2) and lib.plan_refused(n, 0)
    assert lib.plan_group(1, 8) == 4 and lib.plan_group(2, 19) == 16
    assert lib.plan_refused(max_dim + 1, 1) and lib.plan_refused(0, 1)


@pytest.mark.parametrize("batch", (1, 4095, 4096, 4097))
def test_lane_plan_covers_every_filter_once(sigma_plan, batch):
    """The plan's grid at every lane group up to kMaxLaneGroup (G = 32
    takes the replaced kernels' own plan): thread t of CTA b works on
    filter filter_of(b, t, G), lane t % G; every (filter, lane) of `batch`
    filters comes once, and the last CTA holds a filter.  33 dimensions
    are refused before anything is built."""
    lib, threads, max_group, _ = sigma_plan
    for g in (1, 2, 4, 8, 16):
        assert g <= max_group
        ctas = lib.plan_ctas(batch, g)
        filt = np.zeros(ctas * threads, np.int64)
        lib.plan_grid(batch, g, filt.ctypes.data)
        lane = np.arange(ctas * threads) % g
        live = filt < batch
        counts = np.bincount(filt[live] * g + lane[live], minlength=batch * g)
        assert counts.shape == (batch * g,) and (counts == 1).all(), g
        assert filt[(ctas - 1) * threads] < batch
    with pytest.raises(ValueError, match="at most 32"):
        pnl._sigma_empty(batch, 33, 67, "cpu")


def test_sigma_moments_refuses_a_w_or_x_pred_of_the_wrong_shape(
        monkeypatch):
    """On a card (here: a tensor the device check takes for one) a short w
    or x_pred would be read out of bounds: the wrapper raises before
    building or launching anything."""
    monkeypatch.setattr(pnl, "check_kernel_device", lambda t, what: True)
    monkeypatch.setattr(pnl, "_lib", lambda: pytest.fail("launched"))
    b, nx, nz = 3, 4, 2
    ypts, zpts = torch.zeros(b, 8, nx), torch.zeros(b, 8, nz)
    w, Q, R = torch.ones(8), torch.eye(nx), torch.eye(nz)
    with pytest.raises(ValueError, match=r"w must be \[8\]"):
        pnl.sigma_moments(ypts, torch.ones(7), Q)
    with pytest.raises(ValueError, match=r"w must be \[8\]"):
        pnl.sigma_moments(ypts, torch.ones(2, 8), Q)
    upd = dict(z=torch.zeros(b, nz), P_pred=torch.eye(nx).repeat(b, 1, 1),
               pts=torch.zeros(b, 8, nx))
    for x_pred in (torch.zeros(b - 1, nx), torch.zeros(nx),
                   torch.zeros(b, nx, 1)):
        with pytest.raises(ValueError, match="x_pred must be"):
            pnl.sigma_moments(zpts, w, R, x_pred=x_pred, **upd)
    with pytest.raises(ValueError, match="x_pred must be"):
        pnl._sigma_moments_reference(zpts, w, R, x_pred=None, **upd)
