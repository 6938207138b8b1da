"""The port's ROC harness (``models/acq_performance.py``) against the JAX
package's on the CPU.

- ``trial_stats_of``, the trials as the channel axis of one PCPS search,
  against the JAX ``pcps_grid`` and statistic of each trial on the same
  NumPy noise (both statistics): the statistic within rtol 1e-4; and the
  batched layout equals a loop over the trials.
- ``trial_signal``'s replica (the difference of two draws from one seed)
  against the JAX harness's formula.
- ``sweep`` under tests/test_acq_performance.py's own bounds at its size
  (384 trials): the noise comes from a ``torch.Generator``, so the
  agreement with the JAX sweep is statistical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu_torch.models import acq_performance as pperf
from gnss_sim_receiver_tpu_torch.ops import pcps as ppcps

FS = 2_000_000.0
N = 2000
SPC = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs this file beside other
    workers, and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _code():
    return jpc.sample_code(jpc.gps_l1_ca_code(1), FS, 1.023e6, N)


@pytest.mark.parametrize("use_cfar", [True, False])
def test_trial_stats_match_jax_per_trial(use_cfar):
    """Six trials of two dwells (three noise-only, three with PRN 1 at
    45 dB-Hz), made in NumPy from a seed: the port's statistic of each
    trial, all trials in one search, against the JAX grid and statistic of
    that trial; and against the port's search of each trial alone."""
    rng = np.random.default_rng(11)
    m, t = 2, 6
    code = _code()
    amp = np.sqrt(2.0 * 10.0 ** 4.5 / FS)
    tt = (np.arange(m * N) / FS).reshape(m, N)
    sig = np.roll(code, 700)[None] * np.exp(2j * np.pi * 1375.0 * tt)
    x = ((rng.standard_normal((t, m, N)) + 1j * rng.standard_normal(
        (t, m, N))) * np.sqrt(0.5)
        + amp * (np.arange(t) >= 3)[:, None, None] * sig[None])
    x = x.astype(np.complex64)
    cfc = np.conj(np.fft.fft(code))[None].astype(np.complex64)
    dops = jpcps.doppler_grid(5000.0, 250.0)
    want = []
    for xi in x:
        grid = jpcps.pcps_grid(jnp.asarray(xi), jnp.asarray(cfc),
                               jnp.asarray(dops), FS)
        stat = (jpcps.max_to_input_power_stat(grid, jnp.float32(m)) if
                use_cfar else jpcps.first_vs_second_peak_stat(grid, SPC))[0]
        want.append(float(stat[0]))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    ct, dt = torch.from_numpy(cfc), torch.from_numpy(dops)
    got = pperf.trial_stats_of(xt, ct, dt, FS, use_cfar, SPC)
    assert got.shape == (t,) and got.dtype == torch.float32
    assert np.allclose(got.numpy(), want, rtol=1e-4)
    assert got[3:].min() > 2.0 * got[:3].max()      # the signal stands out
    one = torch.cat([pperf.trial_stats_of(xt[:, i:i + 1].contiguous(), ct,
                                          dt, FS, use_cfar, SPC)
                     for i in range(t)])
    assert torch.equal(got, one)


def test_trial_signal_replica_matches_jax_formula():
    """Two draws from the same seed, at amplitudes a and 0, differ by a
    times the JAX harness's replica: the code rolled by the delay at the
    true Doppler, the time running on over the dwells."""
    m, t, amp = 2, 3, 0.25
    code = torch.from_numpy(_code().astype(np.float32))
    draws = []
    for a in (amp, 0.0):
        gen = torch.Generator().manual_seed(4)
        draws.append(pperf.trial_signal(gen, code, a, 1375.0, 700, N, t, FS,
                                        m))
    assert draws[0].shape == (m, t, N) and draws[0].dtype == torch.complex64
    tt = jnp.arange(m * N) / FS
    want = np.asarray((jnp.roll(jnp.asarray(_code())[None].repeat(m, axis=0),
                                700, axis=-1)
                       * jnp.exp(2j * jnp.pi * 1375.0 * tt.reshape(m, N))))
    got = ((draws[0] - draws[1]) / amp).numpy()
    assert np.allclose(got, want[:, None, :], atol=2e-5)
    # the noise: unit power per complex sample
    assert abs(float(draws[1].abs().pow(2).mean()) - 1.0) < 0.05


def test_sweep_meets_the_jax_roc_bounds():
    """tests/test_acq_performance.py's two ROC tests on the port's sweep, at
    their size and seeds: the measured Pfa near the CFAR design point, Pd
    a proper ROC over 30, 40 and 45 dB-Hz, and the dwell gain at 38."""
    pfa_hat, pd, thr = pperf.sweep(cn0_db_hz=(30.0, 40.0, 45.0), pfa=0.05,
                                   n_trials=384, seed=2, device="cpu")
    assert thr == jpcps.cfar_threshold(0.05, N * 41, 1)
    assert 0.002 <= pfa_hat <= 0.075, pfa_hat
    assert pd[30.0] <= 0.2 and pd[45.0] >= 0.95, pd
    assert pd[30.0] <= pd[40.0] <= pd[45.0], pd
    _, pd1, _ = pperf.sweep(cn0_db_hz=(38.0,), pfa=0.01, n_trials=384,
                            max_dwells=1, seed=5, device="cpu")
    _, pd2, _ = pperf.sweep(cn0_db_hz=(38.0,), pfa=0.01, n_trials=384,
                            max_dwells=2, seed=5, device="cpu")
    assert pd2[38.0] >= pd1[38.0], (pd1, pd2)
    assert pd2[38.0] - pd1[38.0] > 0.05 or pd1[38.0] > 0.9
