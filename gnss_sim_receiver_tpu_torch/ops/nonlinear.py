"""Nonlinear Bayesian filter library: cubature and unscented Kalman filters
(kernels K10a and K10b).

PyTorch port of ``gnss_sim_receiver_tpu.ops.nonlinear`` (role parity with
the reference's ``CubatureFilter`` / ``UnscentedFilter``,
nonlinear_tracking.h:46-109, after Arasaratnam & Haykin, "Cubature Kalman
Filters", IEEE TAC 54(6), 2009).  Each rule is a pure function of the
carried (x, P):

- the cubature rule takes 2n points at sqrt(n) times the columns of
  chol(P), with equal weights 1 / (2n);
- the unscented rule takes 2n + 1 points, the centre weighted kappa /
  (n + kappa) and the others 1 / (2 (n + kappa)), at the columns of
  chol((n + kappa) P); kappa = 3 - n by default, which makes the centre
  weight negative above 3 states: it is carried as it is.

Where the JAX package ``jax.vmap``s a step over filters, the functions
here take a batch: ``x`` as [nx] or [B, nx], ``P``, ``Q`` and ``R`` with
the same optional leading B (a [n, n] noise matrix serves every filter).
Each step is three stages:

1. K10a :func:`sigma_points`: the Cholesky factor and the points of every
   filter, [B, Pn, nx];
2. the user's model function, written in torch ops for ONE state [nx] ->
   [ny], applied to all B Pn points at once by ``torch.func.vmap``.  Like
   any function under vmap it may not update a tensor in place or read a
   value to the host (``.item()``); ``torch.atleast_1d`` stands for
   ``jnp.atleast_1d``.  Its output is cast to the state's dtype;
3. K10b :func:`sigma_moments`: the weighted moments, and in the
   measurement update the gain (an LU solve), the posterior and its
   symmetrised covariance.

The kernels run on float32 CUDA tensors with at most 32 states and 32
measurements a filter (the reference's GNSS filters have at most 9); the
wrappers raise on anything else on the card.  Up to 16 of them (and up
to 33 points) a filter is a group of lanes of a warp, its column steps by
shuffles between them; above that it is a warp (``csrc/sigma.cu``'s
header, ``csrc/sigma_plan.cuh``).  The kernels
they replaced stay as :func:`_sigma_points_reference` and
:func:`_sigma_moments_reference`, on no path.  A CPU tensor runs the plain
versions, in float32 or float64 (the JAX classes switch to float64 under
``jax_enable_x64``; the port's take a ``dtype``).  There is no backward:
nothing differentiates these.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import (check_kernel_device,
                                                require, resolve_device)
from gnss_sim_receiver_tpu_torch.ops import cuda_build

RULES = ("cubature", "unscented")
# the most states (or measurements) a filter the kernels take: a lane each
MAX_KERNEL_DIM = 32


# ---- the rules ------------------------------------------------------------

def _rule(n: int, rule: str, kappa, dtype: torch.dtype):
    """(pre, post, centre) of K10a's points x +- post chol(pre P)[:, i]
    (with the centre x first when `centre`), each factor rounded to
    `dtype` as the JAX functions round theirs."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    if rule == "cubature":
        return 1.0, float(np.sqrt(np.asarray(n, np_dtype))), 0
    if rule == "unscented":
        kappa = 3.0 - n if kappa is None else kappa
        return float(np.asarray(n + kappa, np_dtype)), 1.0, 1
    raise ValueError(f"rule must be one of {RULES}, got {rule!r}")


def sigma_weights(n: int, rule: str, kappa, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """The rule's [Pn] weights: 1 / (2n) each (cubature); kappa / (n +
    kappa), then 1 / (2 (n + kappa)) each (unscented)."""
    _rule(n, rule, kappa, dtype)
    if rule == "cubature":
        return torch.full((2 * n,), 1.0 / (2 * n), dtype=dtype, device=device)
    kappa = 3.0 - n if kappa is None else kappa
    w = torch.full((2 * n + 1,), 1.0 / (2.0 * (n + kappa)), dtype=dtype,
                   device=device)
    w[0] = kappa / (n + kappa)
    return w


# ---- plain versions -------------------------------------------------------

def _cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors [B, n, n]; NaN for a matrix that is not
    positive definite (as JAX's cholesky returns)."""
    factor, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[:, None, None], factor,
                       torch.full_like(factor, float("nan")))


def _sigma_points_plain(x, P, pre: float, post: float, centre: int):
    spread = post * _cholesky_plain(pre * P).mT           # rows: columns of L
    pts = [x[:, None, :] + spread, x[:, None, :] - spread]
    return torch.cat([x[:, None, :]] * centre + pts, dim=1)


def _sigma_moments_plain(ypts, w, noise, z=None, x_pred=None, P_pred=None,
                         pts=None):
    mean = torch.einsum("p,bpi->bi", w, ypts)
    dev = ypts - mean[:, None, :]
    cov = torch.einsum("p,bpi,bpj->bij", w, dev, dev) + noise
    if z is None:
        return mean, cov
    x_dev = pts - x_pred[:, None, :]
    p_xz = torch.einsum("p,bpi,bpj->bij", w, x_dev, dev)
    # solve_ex: no host sync to check the factor (a singular P_zz gives
    # inf / NaN, as jnp.linalg.solve does)
    gain = torch.linalg.solve_ex(cov.mT, p_xz.mT).result.mT
    x_est = x_pred + (gain @ (z - mean)[..., None])[..., 0]
    p_est = P_pred - gain @ cov @ gain.mT
    return x_est, 0.5 * (p_est + p_est.mT)


# ---- kernels --------------------------------------------------------------

def _lib(extra: tuple[str, ...] = (), build_dir=None):
    """K10a and K10b (``csrc/sigma.cu``), typed; `extra` flags and
    `build_dir` as :func:`cuda_build.load` takes them (the stamped build of
    ``tools/probe_sigma.py``)."""
    lib = cuda_build.load("sigma_kernels", extra, build_dir)
    if lib.sigma_points.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.sigma_points.argtypes = [p, p, p, i, i, f, f, i, p]
        lib.sigma_predict_moments.argtypes = [p, p, p, ll, p, p, i, i, i, p]
        lib.sigma_update_moments.argtypes = [p, p, p, p, p, p, p, ll, p, p,
                                             i, i, i, i, p]
        lib.sigma_points_reference.argtypes = lib.sigma_points.argtypes
        lib.sigma_predict_moments_reference.argtypes = (
            lib.sigma_predict_moments.argtypes)
        lib.sigma_update_moments_reference.argtypes = (
            lib.sigma_update_moments.argtypes)
        lib.sigma_empty.argtypes = [i, i, i, p]
        for fn in (lib.sigma_points, lib.sigma_predict_moments,
                   lib.sigma_update_moments, lib.sigma_points_reference,
                   lib.sigma_predict_moments_reference,
                   lib.sigma_update_moments_reference, lib.sigma_empty):
            fn.restype = ctypes.c_int
    return lib


def _kernel_dims(what: str, **dims) -> None:
    big = {k: v for k, v in dims.items() if v > MAX_KERNEL_DIM}
    if big:
        raise ValueError(f"{what}: the kernel runs at most {MAX_KERNEL_DIM} "
                         f"states and measurements a filter, got {big}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sigma_points(x: torch.Tensor, P: torch.Tensor, rule: str = "cubature",
                 kappa=None) -> torch.Tensor:
    """K10a: the rule's points [B, Pn, nx] for x [B, nx], P [B, nx, nx]:
    per filter the lower Cholesky factor L of P (cubature) or of (n +
    kappa) P (unscented), then x +- sqrt(n) L[:, i] (cubature) or x, x +-
    L[:, i] (unscented).  Counted in ``sigma_points.launches``."""
    b, n = x.shape
    pre, post, centre = _rule(n, rule, kappa, x.dtype)
    if not check_kernel_device(x, "sigma_points"):
        return _sigma_points_plain(x, P, pre, post, centre)
    pts = _points_launch(x, P, pre, post, centre, "sigma_points")
    sigma_points.launches += 1
    return pts


sigma_points.launches = 0


def _points_launch(x, P, pre: float, post: float, centre: int,
                   entry: str) -> torch.Tensor:
    """Check K10a's operands, then launch the library's `entry`."""
    b, n = x.shape
    _kernel_dims("sigma_points", nx=n)
    require(x, torch.float32, x.device, "sigma_points: x")
    require(P, torch.float32, x.device, "sigma_points: P")
    if P.shape != (b, n, n):
        raise ValueError("sigma_points: P must be [B, nx, nx]")
    pts = torch.empty((b, 2 * n + centre, n), dtype=torch.float32,
                      device=x.device)
    cuda_build.check(getattr(_lib(), entry)(
        x.data_ptr(), P.data_ptr(), pts.data_ptr(), b, n, pre, post, centre,
        _stream(x)), entry)
    return pts


def _sigma_points_reference(x: torch.Tensor, P: torch.Tensor,
                            rule: str = "cubature", kappa=None):
    """K10a before its redesign: one warp a filter, each row in shared
    memory, as many filters a CTA as 48 KB hold.  The reference of
    :func:`sigma_points` on the card (the same bits), CUDA tensors only;
    on no path, not counted."""
    pre, post, centre = _rule(x.shape[1], rule, kappa, x.dtype)
    return _points_launch(x, P, pre, post, centre, "sigma_points_reference")


def _noise_stride(noise: torch.Tensor, b: int, n: int, what: str) -> int:
    if noise.shape == (n, n):
        return 0
    if noise.shape == (b, n, n):
        return n * n
    raise ValueError(f"{what} must be [{n}, {n}] or [{b}, {n}, {n}]")


def sigma_moments(ypts: torch.Tensor, w: torch.Tensor, noise: torch.Tensor,
                  *, z=None, x_pred=None, P_pred=None, pts=None):
    """K10b, the weighted moments of the propagated points ypts [B, Pn, ny]
    with the weights w [Pn] and the noise Q or R ([ny, ny] or [B, ny,
    ny]).  The time update (no `z`) returns (mean [B, ny], mean spread +
    Q [B, ny, ny]).  The measurement update, given z [B, nz] (ny = nz), the
    prior x_pred [B, nx], P_pred [B, nx, nx] and its points pts [B, Pn, nx],
    returns (x_est [B, nx], P_est [B, nx, nx]): the gain solve(P_zz^T,
    P_xz^T)^T by LU with partial pivoting, x_pred + K (z - z mean), P_pred
    - K P_zz K^T symmetrised as 0.5 (P + P^T).  Counted in
    ``sigma_moments.launches``."""
    if not check_kernel_device(ypts, "sigma_moments"):
        return _sigma_moments_plain(ypts, w, noise, z, x_pred, P_pred, pts)
    out = _moments_launch(ypts, w, noise, z, x_pred, P_pred, pts, "")
    sigma_moments.launches += 1
    return out


sigma_moments.launches = 0


def _moments_launch(ypts, w, noise, z, x_pred, P_pred, pts, suffix: str):
    """Check K10b's operands, then launch the library's time or
    measurement update (its name + `suffix`)."""
    if ypts.dim() != 3:
        raise ValueError("sigma_moments: ypts must be [B, Pn, ny]")
    b, n_pts, ny = ypts.shape
    dev = ypts.device
    if w.shape != (n_pts,):
        raise ValueError(f"sigma_moments: w must be [{n_pts}] (one weight "
                         f"a point), got {list(w.shape)}")
    nx = 0
    if z is not None:
        if x_pred is None or x_pred.dim() != 2 or x_pred.shape[0] != b:
            raise ValueError(f"sigma_moments: x_pred must be [{b}, nx]")
        nx = x_pred.shape[1]
    _kernel_dims("sigma_moments", ny=ny, nx=nx)
    for t, what in ((ypts, "ypts"), (w, "w"), (noise, "noise")):
        require(t, torch.float32, dev, f"sigma_moments: {what}")
    stride = _noise_stride(noise, b, ny, "sigma_moments: noise")
    stream = _stream(ypts)
    if z is None:
        mean = torch.empty((b, ny), dtype=torch.float32, device=dev)
        cov = torch.empty((b, ny, ny), dtype=torch.float32, device=dev)
        entry = "sigma_predict_moments" + suffix
        cuda_build.check(getattr(_lib(), entry)(
            ypts.data_ptr(), w.data_ptr(), noise.data_ptr(), stride,
            mean.data_ptr(), cov.data_ptr(), b, n_pts, ny, stream), entry)
        return mean, cov
    for t, what in ((z, "z"), (x_pred, "x_pred"), (P_pred, "P_pred"),
                    (pts, "pts")):
        require(t, torch.float32, dev, f"sigma_moments: {what}")
    if (z.shape != (b, ny) or P_pred.shape != (b, nx, nx)
            or pts.shape != (b, n_pts, nx)):
        raise ValueError("sigma_moments: z [B, nz], x_pred [B, nx], P_pred "
                         "[B, nx, nx], pts [B, Pn, nx]")
    x_est = torch.empty((b, nx), dtype=torch.float32, device=dev)
    p_est = torch.empty((b, nx, nx), dtype=torch.float32, device=dev)
    entry = "sigma_update_moments" + suffix
    cuda_build.check(getattr(_lib(), entry)(
        z.data_ptr(), x_pred.data_ptr(), P_pred.data_ptr(), pts.data_ptr(),
        ypts.data_ptr(), w.data_ptr(), noise.data_ptr(), stride,
        x_est.data_ptr(), p_est.data_ptr(), b, n_pts, nx, ny, stream), entry)
    return x_est, p_est


def _sigma_moments_reference(ypts, w, noise, *, z=None, x_pred=None,
                             P_pred=None, pts=None):
    """K10b before its redesign: one warp a filter, the column steps through
    shared memory.  The reference of :func:`sigma_moments` on the card (the
    same bits), CUDA tensors only; on no path, not counted."""
    return _moments_launch(ypts, w, noise, z, x_pred, P_pred, pts,
                           "_reference")


def _sigma_empty(batch: int, n: int, n_pts: int, device) -> None:
    """An empty kernel on the grid K10a and K10b launch for `batch` filters
    whose largest dimension is `n` and which sum `n_pts` points (kThreads /
    G filters a CTA): the launch floor chip_smoke.py times them against;
    not counted."""
    _kernel_dims("sigma_empty", n=n)
    cuda_build.check(_lib().sigma_empty(
        batch, n, n_pts, torch.cuda.current_stream(device).cuda_stream),
        "sigma_empty")


# ---- the filter steps -----------------------------------------------------

def _batched(x: torch.Tensor, P: torch.Tensor):
    """(x [B, nx], P [B, nx, nx], whether the caller gave one filter)."""
    if x.dim() == 1:
        return x[None].contiguous(), P[None].contiguous(), True
    return x.contiguous(), P.contiguous(), False


def _noise(m, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=x.dtype, device=x.device).contiguous()


def _propagate(pts: torch.Tensor, fcn, dtype) -> torch.Tensor:
    """The model function on every point of every filter, [B, Pn, ny]."""
    b, n_pts, n = pts.shape
    y = torch.func.vmap(fcn)(pts.reshape(b * n_pts, n))
    return y.reshape(b, n_pts, -1).to(dtype).contiguous()


def sigma_predict(x_post, P_post, transition_fcn, Q, *, rule="cubature",
                  kappa=None):
    """Time update: the posterior pushed through ``transition_fcn``.
    Returns (x_pred, P_pred), batched as `x_post` is.  ``rule``:
    "cubature" | "unscented".  Mirrors CubatureFilter::predict_sequential /
    UnscentedFilter::predict_sequential (nonlinear_tracking.cc)."""
    x, P, single = _batched(x_post, P_post)
    pts = sigma_points(x, P, rule, kappa)
    w = sigma_weights(x.shape[1], rule, kappa, x.dtype, x.device)
    mean, cov = sigma_moments(_propagate(pts, transition_fcn, x.dtype), w,
                              _noise(Q, x))
    return (mean[0], cov[0]) if single else (mean, cov)


def sigma_update(z, x_pred, P_pred, measurement_fcn, R, *,
                 rule="cubature", kappa=None):
    """Measurement update.  Returns (x_est, P_est), batched as `x_pred` is.
    Cross and innovation covariances from the same sigma-point set
    (CubatureFilter::update_sequential role)."""
    x, P, single = _batched(x_pred, P_pred)
    pts = sigma_points(x, P, rule, kappa)
    w = sigma_weights(x.shape[1], rule, kappa, x.dtype, x.device)
    zpts = _propagate(pts, measurement_fcn, x.dtype)
    z = torch.as_tensor(z, dtype=x.dtype, device=x.device).reshape(
        x.shape[0], -1).contiguous()
    x_est, p_est = sigma_moments(zpts, w, _noise(R, x), z=z, x_pred=x,
                                 P_pred=P, pts=pts)
    return (x_est[0], p_est[0]) if single else (x_est, p_est)


class CubatureFilter:
    """Stateful convenience wrapper with the reference's method surface
    (initialize / predict_sequential / update_sequential / get_*); the math
    lives in the pure functions above.  One filter, in `dtype` on `device`
    (None: the CUDA card)."""

    rule = "cubature"

    def __init__(self, x0=None, P0=None, nx: int | None = None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        if x0 is None:
            nx = nx or 1
            x0 = torch.zeros(nx)
            P0 = torch.eye(nx)
        self.initialize(x0, P0)

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def initialize(self, x0, P0):
        self.x_pred = self._t(x0).reshape(-1)
        self.P_pred = self._t(P0)
        self.x_est = self.x_pred
        self.P_est = self.P_pred

    def predict_sequential(self, x_post, P_post, transition_fcn, Q):
        self.x_pred, self.P_pred = sigma_predict(
            self._t(x_post).reshape(-1), self._t(P_post), transition_fcn,
            self._t(Q), rule=self.rule)
        return self.x_pred, self.P_pred

    def update_sequential(self, z, x_pred, P_pred, measurement_fcn, R):
        self.x_est, self.P_est = sigma_update(
            self._t(z).reshape(-1), self._t(x_pred).reshape(-1),
            self._t(P_pred), measurement_fcn, self._t(R), rule=self.rule)
        return self.x_est, self.P_est

    def get_x_pred(self):
        return self.x_pred

    def get_P_x_pred(self):
        return self.P_pred

    def get_x_est(self):
        return self.x_est

    def get_P_x_est(self):
        return self.P_est


class UnscentedFilter(CubatureFilter):
    rule = "unscented"
