"""Parity of the port's multicorrelator (kernel K2) with the JAX package's
``gather_blocks`` + ``correlate_multitap`` on the CPU, where the wrapper
runs its plain version.

Tolerance: 1e-5 of the largest correlation magnitude.  The NCO phases,
the code-table indices and the wipeoff are the same float32 operations in
the same order; only the 2048-term sums run in another order (float32
rounding, ~1e-7 relative per term).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.ops import correlator as jcorr
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu_torch.ops import correlator as pcorr

FS = 2_000_000.0
B = 2048


def _random_state(seed: int, c: int, n: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    codes = np.stack([jpc.bandlimited_table_normalized(
        jpc.gps_l1_ca_code(p), FS, 1.023e6, 2000, 8)
        for p in rng.choice(np.arange(1, 33), c, replace=False)])
    state = dict(
        pos=rng.integers(-100, n - B + 100, c).astype(np.int32),
        rem_code=rng.uniform(-0.5, 1.0, c).astype(np.float32),
        code_freq=(1.023e6 + rng.uniform(-6, 6, c)).astype(np.float32),
        rem_carr=rng.uniform(0, 2 * np.pi, c).astype(np.float32),
        dop=rng.uniform(-5000, 5000, c).astype(np.float32),
        n_samples=rng.integers(1990, 2010, c).astype(np.int32))
    return x, codes, state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multicorrelate_matches_jax(seed):
    """Random channel state (positions beyond both ends included, so the
    clamp of gather_blocks is exercised)."""
    c, n = 8, 1 << 14
    x, codes, s = _random_state(seed, c, n)
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    blocks = jcorr.gather_blocks(jnp.asarray(x), jnp.asarray(s["pos"]), B)
    want = np.asarray(jcorr.correlate_multitap(
        blocks, jnp.asarray(codes), jnp.asarray(taps),
        jnp.asarray(s["rem_code"]), jnp.asarray(s["code_freq"]),
        jnp.asarray(s["rem_carr"]), jnp.asarray(s["dop"]),
        jnp.asarray(s["n_samples"]), FS, table_oversample=8))
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    got = pcorr.multicorrelate(
        torch.from_numpy(x), t["pos"], B, torch.from_numpy(codes),
        torch.from_numpy(taps), t["rem_code"], t["code_freq"], t["rem_carr"],
        t["dop"], t["n_samples"], FS, table_oversample=8).numpy()
    assert got.shape == (c, 3) and got.dtype == np.complex64
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_gather_blocks_clamps_like_jax():
    x = np.arange(5000, dtype=np.float32).astype(np.complex64)
    pos = np.array([-7, 0, 1234, 4000, 9999], np.int32)
    want = np.asarray(jcorr.gather_blocks(jnp.asarray(x), jnp.asarray(pos), B))
    got = pcorr.gather_blocks(torch.from_numpy(x), torch.from_numpy(pos),
                              B).numpy()
    assert np.array_equal(got, want)


def test_plain_run_counts_no_launch():
    """The launch counter counts kernel launches only: a CPU tensor runs
    the plain version and leaves it as it was."""
    x, codes, s = _random_state(3, 2, 1 << 13)
    before = pcorr.multicorrelate.launches
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    pcorr.multicorrelate(torch.from_numpy(x), t["pos"], B,
                         torch.from_numpy(codes),
                         torch.tensor([0.25, 0.0, -0.25]), t["rem_code"],
                         t["code_freq"], t["rem_carr"], t["dop"],
                         t["n_samples"], FS, table_oversample=8)
    assert pcorr.multicorrelate.launches == before
