"""Parity of the port's two-step acquisition (kernel K3b: the wipeoff with a
Doppler row set per channel) with the JAX package on the CPU, where the
port's wrappers run their plain versions.

Tolerances: the grid and the statistics agree to 1e-4 relative (float32
FFTs of 2000 points in another library); detections, delays and the
refined Doppler bins must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.ops import pcps as ppcps
from tests.fixtures import FS, static_scenario_capture

M, N = 2, 2000
PRNS = tuple(range(1, 11))
TWO_STEP = dict(fs_in=FS, max_dwells=2, make_two_steps=True,
                doppler_step2=125.0, num_doppler_bins_step2=4)


@pytest.fixture(scope="module")
def per_channel_inputs():
    """[M, N] dwells of noise, [C, N] conj code FFTs and a [C, D2] Doppler
    table with another row set for each channel, from a numpy seed."""
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))
         ).astype(np.complex64)
    prns = [3, 7, 11]
    codes = np.stack([jpc.sample_code(jpc.gps_l1_ca_code(p), FS, 1.023e6, N)
                      for p in prns])
    cfc = np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)
    centers = np.array([1250.0, -3000.0, 4750.0], np.float32)
    dops = (centers[:, None]
            + (np.arange(9, dtype=np.float32) - 4.0) * np.float32(125.0))
    return x, cfc, dops.astype(np.float32)


def test_pcps_grid_per_channel_matches_jax(per_channel_inputs):
    x, cfc, dops = per_channel_inputs
    want = np.asarray(jpcps.pcps_grid_per_channel(
        jnp.asarray(x), jnp.asarray(cfc), jnp.asarray(dops), FS))
    got = ppcps.pcps_grid_per_channel(
        torch.from_numpy(x), torch.from_numpy(cfc), torch.from_numpy(dops),
        FS).numpy()
    assert got.shape == want.shape == (3, 9, N)
    # 1e-4 of the grid's scale: two float32 FFTs of another library
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_wipe_per_channel_is_the_flat_wipe(per_channel_inputs):
    """Given a [C, D2] table (K3b) the wipeoff hands the kernel the table's
    C * D2 rows as its Doppler axis: on the CPU the two plain versions must
    agree exactly."""
    x, _, dops = per_channel_inputs
    t = ppcps.time_axis(N, FS, "cpu")
    xt, dt = torch.from_numpy(x), torch.from_numpy(dops)
    per_channel = ppcps.pcps_wipe(xt, dt, t)
    flat = ppcps.pcps_wipe(xt, dt.reshape(-1), t)
    assert per_channel.shape == (M, 3, 9, N)
    assert torch.equal(per_channel.reshape(M, 27, N), flat)


@pytest.fixture(scope="module")
def capture():
    x, _ = static_scenario_capture()
    return x


def test_fused_search_packing_matches_jax(capture):
    """pcps_search_two_steps returns the JAX [4, C] packing (stat,
    doppler_hz, delay_idx, stat2)."""
    x = capture[:M * N].reshape(M, N)
    jeng = jacq.PcpsAcquisitionEngine(jacq.AcqConf(**TWO_STEP), PRNS)
    peng = pacq.PcpsAcquisitionEngine(pacq.AcqConf(**TWO_STEP), PRNS,
                                      device="cpu")
    want = np.asarray(jacq._acquire_fused(
        jnp.asarray(x), jeng.code_fft_conj, jeng.dopplers, fs=FS,
        use_cfar=True, spc=2, two_steps=True, n_side=4, step2=125.0))
    got = ppcps.pcps_search_two_steps(
        torch.from_numpy(x), peng.code_fft_conj, peng.dopplers, peng._t,
        two_steps=True, n_side=4, step2=125.0).numpy()
    assert got.shape == want.shape == (4, len(PRNS))
    assert got.dtype == np.float32
    assert np.array_equal(got[1], want[1])          # refined Doppler, Hz
    assert np.array_equal(got[2], want[2])          # delay index
    assert np.allclose(got[0], want[0], rtol=1e-4)  # coarse statistic
    assert np.allclose(got[3], want[3], rtol=1e-4)  # step-two statistic
    one = ppcps.pcps_search_two_steps(
        torch.from_numpy(x), peng.code_fft_conj, peng.dopplers, peng._t,
        two_steps=False, n_side=4, step2=125.0).numpy()
    assert np.array_equal(one[3], np.zeros(len(PRNS), np.float32))
    assert np.array_equal(one[0], got[0]) and np.array_equal(one[2], got[2])


@pytest.mark.parametrize("where", ["host", "device"])
def test_two_step_acquire_from_matches_jax(capture, where):
    """acquire_from with make_two_steps on a window of the static scenario:
    the same detections and delays, Doppler on the same 125 Hz bin, the
    statistic max(stat, stat2) to 1e-4 relative."""
    jeng = jacq.PcpsAcquisitionEngine(jacq.AcqConf(**TWO_STEP), PRNS)
    peng = pacq.PcpsAcquisitionEngine(pacq.AcqConf(**TWO_STEP), PRNS,
                                      device="cpu")
    assert peng.threshold == jeng.threshold
    if where == "host":
        x = capture[:8000]
        jr = jeng.acquire_from(x, 2000)
        pr = peng.acquire_from(x, 2000)
    else:
        x = capture[:40000]
        jr = jeng.acquire_from(jnp.asarray(x), 9000)
        pr = peng.acquire_from(torch.from_numpy(x), 9000)
    assert pr.samplestamp == jr.samplestamp
    assert np.array_equal(pr.detected, jr.detected)
    assert sorted(np.asarray(PRNS)[pr.detected]) == [1, 3, 4, 5, 9, 10]
    assert np.array_equal(pr.delay_samples, jr.delay_samples)
    assert np.abs(pr.doppler_hz - jr.doppler_hz).max() < 125.0 / 2
    assert np.allclose(pr.test_stat, jr.test_stat, rtol=1e-4)
    # the refinement lands off the coarse 250 Hz grid for some satellite
    assert np.any(np.mod(pr.doppler_hz[pr.detected], 250.0) != 0.0)


def test_two_step_statistic_folds_in_the_second_step(capture):
    """max(stat, stat2) under CFAR: never below the one-step statistic, and
    no detection of the one-step search is lost."""
    x = capture[:8000]
    one = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(fs_in=FS, max_dwells=2), PRNS, device="cpu"
    ).acquire_from(x, 0)
    two = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(**TWO_STEP), PRNS, device="cpu").acquire_from(x, 0)
    assert np.all(two.test_stat >= one.test_stat)
    assert np.all(two.detected[one.detected])
    assert np.array_equal(two.delay_samples, one.delay_samples)
    assert np.abs(two.doppler_hz - one.doppler_hz).max() <= 4 * 125.0


def test_two_step_refinement_nears_the_true_doppler():
    """tests/test_acquisition.py::test_two_step_doppler_refinement on the
    port: a noiseless satellite at 1375 Hz, half way between two 250 Hz
    bins, is refined to within one 62.5 Hz bin, nearer than the coarse
    hit."""
    sat = SatelliteSignalParams(prn=5, cn0_db_hz=47.0, doppler_hz=1375.0,
                                delay_chips=42.0)
    x = generate_baseband([sat], FS, 8000, noise=False, seed=1)
    conf = dict(fs_in=FS, max_dwells=2)
    coarse = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(**conf), [5], device="cpu").acquire_from(x, 0)
    fine = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(**conf, make_two_steps=True, doppler_step2=62.5,
                     num_doppler_bins_step2=4), [5],
        device="cpu").acquire_from(x, 0)
    ref = jacq.PcpsAcquisitionEngine(
        jacq.AcqConf(**conf, make_two_steps=True, doppler_step2=62.5,
                     num_doppler_bins_step2=4), [5]).acquire_from(x, 0)
    assert bool(fine.detected[0])
    assert abs(fine.doppler_hz[0] - 1375.0) <= 62.5
    assert abs(fine.doppler_hz[0] - 1375.0) < abs(coarse.doppler_hz[0]
                                                  - 1375.0)
    assert fine.doppler_hz[0] == ref.doppler_hz[0]
    assert fine.delay_samples[0] == ref.delay_samples[0]


def test_doppler_center_shifts_the_grid():
    eng = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(fs_in=FS, doppler_center=1000.0), [1], device="cpu")
    ref = jacq.PcpsAcquisitionEngine(
        jacq.AcqConf(fs_in=FS, doppler_center=1000.0), [1])
    assert np.array_equal(eng.dopplers.numpy(), np.asarray(ref.dopplers))
    assert eng.dopplers[0] == -4000.0 and eng.dopplers[-1] == 6000.0
