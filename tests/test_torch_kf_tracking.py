"""The Kalman trackers (tracking_mode "kf" and "gaussian") and the
second-order PLL of the port against the JAX package on the CPU.

- One epoch op by op: JAX's _epoch_step under jax.disable_jit against the
  port's split plain path (K2's plain version, then K9's plain closure),
  from tests/test_torch_epoch_step.py's GPS edge states with Kalman edges
  added: random positive definite covariances, Doppler rates and NIW
  posteriors, a covariance whose innovation matrix S has a negative
  determinant (the 1e-20 floor), and a posterior with nu < 3 and scale
  sums under R's floors (the gaussian mode).  The second-order PLL's
  op-by-op case is tests/test_torch_epoch_step.py's "gps_pll2_ext20".
- A chunk: 200 epochs of tests/test_torch_tracking.py's `clean` scenario
  through JAX's track_chunk and the port's, in each of the three forms.
- JAX's own KF tests (tests/test_kf_tracking.py), their three scenarios
  through both engines: the port passes JAX's assertions, and the two
  agree.

Tolerances.  The port forms F P F^T as F P first, then (F P) F^T, each
sum in index order (models/tracking.py:_mat4); JAX forms it in one einsum
in an order of its own, so the covariance differs in the last bits:
measured 3e-6 of a channel's largest entry in one epoch.  One epoch:
every integer and bool field, the sign buffer and histogram bit for bit;
every float field, per channel, within 1e-5 of that channel's largest
modulus in the field, of a chip or a sample at least for the code phase
(measured 4e-8; the code phase 1.6e-8 chip); the
carrier phase remnant and the Kahan compensation bit for bit but on the
channel whose S is singular: its carrier steps by ~1e16 cycles there, and
a float32 remainder of that by 2 pi lands anywhere for a last-bit
difference (its cycle count agrees to 3e-7).  Over a chunk the loops carry rounding as the DLL/PLL chunk
does: tests/test_torch_tracking.py's bounds; the covariance within 1e-5
of its largest entry (measured 7.5e-7), the Doppler rate within 0.02
Hz/s (measured 0.0052), the posterior's count equal (it reads no
measurement) and its scale sums within 2e-3 of their largest (measured
3.8e-4).  Over JAX's 1000 to 2000-epoch noisy
scenarios: the Doppler of the last 300 epochs within 1 Hz, the Doppler
rate within 0.5 Hz/s, the posterior's count equal and its scale sums
within 5 %.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from tests import test_torch_epoch_step as ep
from tests.test_torch_block_step import _jax_state
from tests.test_torch_tracking import _clean_scenario, _compare_outputs

FS = 2_000_000.0
CODE_RATE = 1.023e6
KALMAN = ("kf", "gaussian")
# the Kalman tracker feeds its phase steps into the NCO: these read them
PHASE = ("rem_code_phase", "rem_carr_phase", "acc_phase_cycles",
         "acc_phase_comp")
EXACT = tuple(k for k in ep.EXACT if k not in PHASE)
SINGULAR = 3              # the channel whose S is singular


def _kalman_edges(a, rng):
    """Kalman fields on edges (gps_ext1's channels: 0 on a lock loss, 1
    inactive, 2 in the FLL pull-in, 3 mid-window): random positive
    definite covariances, but channel 3's, whose S is not positive
    definite (its determinant floored); channel 2's posterior has nu < 3
    and scale sums under the floors."""
    scale = np.sqrt([1e-2, 1e-2, 30.0, 3.0])
    m = rng.standard_normal((4, 4, 4)) * scale[None, :, None]
    a["kf_p"] = (m @ m.transpose(0, 2, 1) / 4.0
                 + np.diag([1e-4, 1e-5, 1.0, 0.1])[None]).astype(np.float32)
    a["kf_p"][3] = np.diag([0.05, 0.05, 100.0, 10.0])
    a["kf_p"][3, 0, 1] = a["kf_p"][3, 1, 0] = 0.2
    a["kf_fdot"] = rng.uniform(-5.0, 5.0, 4).astype(np.float32)
    nu = rng.uniform(30.0, 200.0, 4)
    a["bayes_nu"] = nu.astype(np.float32)
    a["bayes_psi_code"] = (nu * rng.uniform(1e-3, 1e-2, 4)).astype(np.float32)
    a["bayes_psi_carr"] = (nu * rng.uniform(1e-4, 1e-3, 4)).astype(np.float32)
    a["bayes_nu"][2] = 2.5
    a["bayes_psi_code"][2] = 1e-7
    a["bayes_psi_carr"][2] = 1e-8


# the fields whose values pass through zero: their tolerance is against
# their natural scale (a chip, a sample) where the channel's value is less
FLOORS = {"rem_code_phase": 1.0, "code_phase_samples": 1.0}


def _close(got, want, rtol, what, axis):
    """Within rtol of the largest modulus of `want` along the channel axis
    `axis` (0 for [C, ...] fields, 1 for [T, C] planes), channel by
    channel (FLOORS: of at least that scale)."""
    got = np.moveaxis(np.asarray(got), axis, 0)
    want = np.moveaxis(np.asarray(want), axis, 0)
    for ch in range(want.shape[0]):
        g, w = g_w = (got[ch].astype(np.complex128).ravel(),
                      want[ch].astype(np.complex128).ravel())
        scale = max(np.abs(w).max(), FLOORS.get(what, 1e-30))
        assert np.abs(g - w).max() <= rtol * scale, (what, ch, g_w)


@pytest.mark.parametrize("mode", KALMAN)
def test_kalman_closure_edges_match_jax_op_by_op(mode):
    c = ep._scenario("gps_ext1", 11)
    c["jconf"] = dataclasses.replace(c["jconf"], tracking_mode=mode)
    c["pconf"] = dataclasses.replace(c["pconf"], tracking_mode=mode)
    assert dataclasses.asdict(c["pconf"]) == {
        f.name: getattr(c["jconf"], f.name)
        for f in dataclasses.fields(c["pconf"])}
    rng = np.random.default_rng(11)
    a = ep._armed(c["sig"], c["pconf"])
    reached = ep._edge("gps_ext1", c, a, rng)
    _kalman_edges(a, rng)
    with jax.disable_jit():
        sj, oj = jtrk._epoch_step(
            c["jconf"], jnp.asarray(c["codes"]), jnp.asarray(c["taps"]),
            jnp.asarray(c["x"]), _jax_state(a))
    pst = interop.track_state_from_numpy(a, "cpu")
    sp, op = ptrk._epoch_step(c["pconf"], torch.from_numpy(c["codes"]),
                              torch.from_numpy(c["taps"]),
                              torch.from_numpy(c["x"]), pst)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    assert sorted(dj) == sorted(dp)
    for k in EXACT:
        assert np.array_equal(dj[k], dp[k]), (k, dj[k], dp[k])
    rest = np.arange(4) != SINGULAR
    for k in ("rem_carr_phase", "acc_phase_comp"):
        assert np.array_equal(dj[k][rest], dp[k][rest]), k
    for k in dp:
        if k not in EXACT and k not in ("rem_carr_phase", "acc_phase_comp"):
            _close(dp[k], dj[k], 1e-5, k, 0)
    for k in ("prompt", "pilot_prompt", "code_phase_samples",
              "acc_phase_cycles", "early_mag", "late_mag"):
        _close(op[k].numpy(), np.asarray(oj[k]), 1e-5, k, 0)
    for k in ("pos_start", "n_samples", "valid", "rem_code_phase_chips"):
        assert np.array_equal(op[k].numpy(), np.asarray(oj[k])), k
    # the edges were reached: S's determinant floored on channel 3, the
    # posterior's floors on channel 2 (gaussian), the covariance and the
    # Doppler rate moved on the active channels and held on the inactive
    n_c = ptrk._epoch_length(c["pconf"], pst)
    pred = ptrk._kf_predict(c["pconf"], pst.kf_p,
                            n_c.to(torch.float32) / np.float32(FS)).numpy()
    r_code, r_carr = ((c["pconf"].kf_r_code_chips2, c["pconf"].kf_r_phase_cyc2)
                      if mode == "kf" else
                      (v.numpy() for v in ptrk._bayes_r(pst)))
    r_code, r_carr = np.broadcast_to(r_code, 4), np.broadcast_to(r_carr, 4)
    det = ((pred[:, 0, 0] + r_code) * (pred[:, 1, 1] + r_carr)
           - pred[:, 0, 1] ** 2)
    assert det[SINGULAR] <= 1e-20 and (det[[0, 2]] > 1e-20).all()
    if mode == "gaussian":
        assert r_code[2] == np.float32(1e-5) and r_carr[2] == np.float32(1e-6)
        assert dp["bayes_nu"][0] != a["bayes_nu"][0]
    ch = reached["inactive"]
    assert np.array_equal(dp["kf_p"][ch], a["kf_p"][ch])
    assert dp["kf_fdot"][ch] == a["kf_fdot"][ch]
    assert not np.array_equal(dp["kf_p"][0], a["kf_p"][0])
    assert dp["kf_fdot"][0] != a["kf_fdot"][0]
    # the loops' fields: the PLL velocity is the Doppler, the DLL held
    assert np.array_equal(dp["pll.vel"][[0, 2]], dp["carrier_doppler"][[0, 2]])
    assert np.array_equal(dp["dll.vel"], a["dll.vel"])


FORMS = {"kf": dict(tracking_mode="kf"),
         "gaussian": dict(tracking_mode="gaussian"),
         "pll2": dict(pll_filter_order=2)}


@pytest.mark.parametrize("form", list(FORMS))
def test_chunk_matches_jax(form):
    """200 epochs of the `clean` scenario (three noise-free 50 dB-Hz
    satellites armed on truth) in each form."""
    c = _clean_scenario()
    jconf = dataclasses.replace(c["jconf"], **FORMS[form])
    pconf = dataclasses.replace(c["pconf"], **FORMS[form])
    t = 200
    sj, oj = jtrk.track_chunk(jconf, t, jnp.asarray(c["tables"]),
                              jnp.asarray(c["taps"]), jnp.asarray(c["x"]),
                              c["jst"])
    sp, op = ptrk.track_chunk(pconf, t, torch.from_numpy(c["tables"]),
                              torch.from_numpy(c["taps"]),
                              torch.from_numpy(c["x"]), c["pst"])
    _compare_outputs(oj, op, prompt_max=0.02, prompt_med=0.002, pos_tol=1,
                     dop_tol=0.2, boundary_tol=0.05)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["pos"] - dp["pos"]).max() <= 1
    assert np.abs(dj["carrier_doppler"] - dp["carrier_doppler"]).max() < 0.2
    assert np.array_equal(dj["bayes_nu"], dp["bayes_nu"])
    for k, rtol in (("kf_p", 1e-5), ("bayes_psi_code", 2e-3),
                    ("bayes_psi_carr", 2e-3)):
        scale = max(np.abs(dj[k]).max(), 1e-30)
        assert np.abs(dp[k] - dj[k]).max() <= rtol * scale, k
    assert np.abs(dp["kf_fdot"] - dj["kf_fdot"]).max() < 0.02
    moved = dict(kf=("kf_p", "kf_fdot"),
                 gaussian=("kf_p", "kf_fdot", "bayes_nu", "bayes_psi_code"),
                 pll2=())[form]
    init = interop.track_state_to_numpy(c["pst"])
    for k in moved:
        assert not np.array_equal(dp[k], init[k]), k
    if form == "pll2":        # the second-order PLL holds its acceleration
        assert np.array_equal(dp["pll.acc"], init["pll.acc"])


# ---- tests/test_kf_tracking.py's scenarios, both engines ------------------

def _run_both(mode, sat, x, n, prn):
    """JAX's _run of tests/test_kf_tracking.py in both packages."""
    out = []
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for trk, kw in ((jtrk, {}), (ptrk, {"device": "cpu"})):
            eng = trk.TrackingEngine(trk.TrackingConf(fs=FS,
                                                      tracking_mode=mode),
                                     prns=[prn], **kw)
            eng.start_tracking(0, sat.doppler_hz + 80.0,
                               int(round(sat.delay_chips * FS / CODE_RATE)))
            outs = eng.process(x, 0, n)
            out.append(({k: np.asarray(v) for k, v in outs.items()},
                        interop.track_state_to_numpy(eng.state)))
    finally:
        torch.set_num_threads(threads)
    return out


def _agree(pair, tail=300):
    (oj, sj), (op, sp) = pair
    assert sorted(oj) == sorted(op)
    assert sj["lock_lost"][0] == sp["lock_lost"][0]
    d = np.abs(oj["carrier_doppler_hz"][-tail:, 0]
               - op["carrier_doppler_hz"][-tail:, 0])
    assert d.max() < 1.0, d.max()
    assert abs(sj["kf_fdot"][0] - sp["kf_fdot"][0]) < 0.5
    assert sj["bayes_nu"][0] == sp["bayes_nu"][0]
    for k in ("bayes_psi_code", "bayes_psi_carr"):
        assert abs(sp[k][0] - sj[k][0]) <= 0.05 * abs(sj[k][0]), k


def test_kf_tracks_doppler_ramp_with_less_jitter_like_jax():
    bits = np.ones(1500, np.int8)
    sat = SatelliteSignalParams(prn=7, cn0_db_hz=45.0, doppler_hz=1250.0,
                                doppler_rate_hz_s=5.0, delay_chips=300.5,
                                nav_bits=bits)
    x = generate_baseband([sat], FS, int(FS * 1.2), noise=True, seed=1)
    pll, kf = _run_both("dll_pll", sat, x, 1100, 7), \
        _run_both("kf", sat, x, 1100, 7)
    for pair in (pll, kf):
        _agree(pair)
    (_, _), (outs_pll, st_pll) = pll
    (_, _), (outs_kf, st_kf) = kf
    for outs, st in ((outs_pll, st_pll), (outs_kf, st_kf)):
        assert not st["lock_lost"][0]
        assert abs(outs["carrier_doppler_hz"][-50:, 0].mean() - 1255.5) < 4.0
    std_pll = outs_pll["carrier_doppler_hz"][-200:, 0].std()
    std_kf = outs_kf["carrier_doppler_hz"][-200:, 0].std()
    assert std_kf < std_pll
    assert 0.0 < st_kf["kf_fdot"][0] < 15.0, st_kf["kf_fdot"][0]


def test_kf_code_tracking_unbiased_like_jax():
    bits = np.ones(1500, np.int8)
    sat = SatelliteSignalParams(prn=7, cn0_db_hz=48.0, doppler_hz=-2000.0,
                                delay_chips=100.25, nav_bits=bits)
    x = generate_baseband([sat], FS, int(FS * 1.1), noise=True, seed=3,
                          bandlimit_oversample=4)
    pair = _run_both("kf", sat, x, 1000, 7)
    _agree(pair)
    (oj, _), (outs, _) = pair
    assert np.array_equal(oj["pos_start"][-300:], outs["pos_start"][-300:])
    s = outs["pos_start"][-300:, 0].astype(np.float64)
    rem = outs["rem_code_phase_chips"][-300:, 0].astype(np.float64)
    tau = (s / FS) * (1 - 2000.0 / 1575.42e6) - 100.25 / CODE_RATE
    truth = (tau * CODE_RATE) % 1023
    truth = np.where(truth > 511, truth - 1023, truth)
    err = rem - truth
    assert abs(err.mean()) < 0.02, err.mean()


def test_gaussian_adaptive_tracking_like_jax():
    bits = (np.random.default_rng(4).integers(0, 2, 200) * 2 - 1
            ).astype(np.int8)
    sat = SatelliteSignalParams(prn=9, cn0_db_hz=45.0, doppler_hz=900.0,
                                delay_chips=150.0, nav_bits=bits)
    x = generate_baseband([sat], FS, int(FS * 2.2), noise=True, seed=6)
    pair = _run_both("gaussian", sat, x, 2000, 9)
    _agree(pair)
    (_, _), (outs, st) = pair
    dop = outs["carrier_doppler_hz"][-300:, 0]
    assert abs(dop.mean() - 900.0) < 5.0
    assert not st["lock_lost"][0]
    nu = float(st["bayes_nu"][0])
    r_code = float(st["bayes_psi_code"][0]) / max(nu - 2.0, 1.0)
    assert 1e-4 < r_code < 5e-2, r_code
    assert nu > 50.0
