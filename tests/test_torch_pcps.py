"""Parity of the port's PCPS acquisition (kernel K3: the wipeoff kernel and
the peak/CFAR epilogue kernel around cuFFT) with the JAX package on the CPU,
where the wrappers run their plain versions.

Tolerances: the grid and the statistic agree to 1e-4 relative (float32
FFTs of 2000 points in another library: ~1e-6 relative per value, summed);
the Doppler and delay indices must be identical.  K3's row kernel's
tile rule (a fixed tile looped over the row, per-lane running maxima)
is written out in numpy and held to the plain rows exactly, ties
included, and its launch plan never takes a tile above 2048 lanes.
"""

import math
import re
from pathlib import Path

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

M, N, C = 2, 2000, 4


@pytest.fixture(scope="module")
def grid_inputs():
    """Two 1 ms dwells holding PRNs 3 and 11 (45 dB-Hz, off-grid Doppler)
    in noise, searched for PRNs 3, 7, 11, 20 over 41 Doppler bins."""
    prns = [3, 7, 11, 20]
    sats = [SatelliteSignalParams(prn=3, cn0_db_hz=45.0, doppler_hz=1310.0,
                                  delay_chips=211.3,
                                  nav_bits=np.ones(8, np.int8)),
            SatelliteSignalParams(prn=11, cn0_db_hz=45.0, doppler_hz=-2890.0,
                                  delay_chips=777.7,
                                  nav_bits=np.ones(8, np.int8))]
    x = generate_baseband(sats, FS, M * N, noise=True, seed=5
                          ).reshape(M, N).astype(np.complex64)
    codes = np.stack([jpc.sample_code(jpc.gps_l1_ca_code(p), FS, 1.023e6, N)
                      for p in prns])
    cfc = np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)
    dops = jpcps.doppler_grid(5000.0, 250.0)
    assert len(dops) == 41
    return x, cfc, dops


def test_pcps_grid_matches_jax(grid_inputs):
    x, cfc, dops = grid_inputs
    want = np.asarray(jpcps.pcps_grid(jnp.asarray(x), jnp.asarray(cfc),
                                      jnp.asarray(dops), FS))
    got = ppcps.pcps_grid(torch.from_numpy(x), torch.from_numpy(cfc),
                          torch.from_numpy(dops), FS).numpy()
    assert got.shape == (C, 41, N)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_cfar_statistic_matches_jax(grid_inputs):
    """max_to_input_power_stat on each side's grid, and the port's whole
    search (wipeoff -> FFT -> product -> IFFT -> peak) against JAX."""
    x, cfc, dops = grid_inputs
    grid = jpcps.pcps_grid(jnp.asarray(x), jnp.asarray(cfc),
                           jnp.asarray(dops), FS)
    js, jd, jn = (np.asarray(a) for a in jpcps.max_to_input_power_stat(
        grid, jnp.float32(M)))
    t = ppcps.time_axis(N, FS, "cpu")
    ps, pd, pn = (a.numpy() for a in ppcps.pcps_search(
        torch.from_numpy(x), torch.from_numpy(cfc), torch.from_numpy(dops),
        t))
    assert np.array_equal(pd, jd) and np.array_equal(pn, jn)
    assert pd.dtype == np.int32 and pn.dtype == np.int32
    assert np.allclose(ps, js, rtol=1e-4)
    # the two present satellites stand above the absent ones
    assert min(ps[0], ps[2]) > max(ps[1], ps[3])


def test_grid_peak_first_index_on_ties():
    """argmax over (Doppler, delay) returns the FIRST maximal cell, as
    jnp.argmax does (a flat grid is all ties)."""
    g = np.zeros((2, 5, 7), np.float32)
    g[1, 3, 2] = g[1, 1, 6] = g[1, 4, 0] = 2.0
    jp, jd, jn = (np.asarray(a) for a in jpcps.grid_peak(jnp.asarray(g)))
    pp, pd, pn = (a.numpy() for a in ppcps.grid_peak(torch.from_numpy(g)))
    assert np.array_equal(pd, jd) and np.array_equal(pn, jn)
    assert (pd[1], pn[1]) == (1, 6) and (pd[0], pn[0]) == (0, 0)


def test_cfar_threshold_and_grid_copies():
    assert np.array_equal(ppcps.doppler_grid(5000.0, 250.0, 100.0),
                          jpcps.doppler_grid(5000.0, 250.0, 100.0))
    for pfa, cells, dwells in ((0.01, 82000, 2), (1e-3, 41 * 4000, 1)):
        assert ppcps.cfar_threshold(pfa, cells, dwells) == \
            jpcps.cfar_threshold(pfa, cells, dwells)


@pytest.fixture(scope="module")
def capture():
    x, _ = static_scenario_capture()
    return x


@pytest.mark.parametrize("where", ["host", "device"])
def test_acquire_from_matches_jax(capture, where):
    """The engines on the first 2 ms of the static scenario (PRNs 1-10 of
    which 1, 3, 4, 5, 9, 10 are present): the same detections, Doppler and
    delay.  'host' passes NumPy (the window starts exactly at the cursor);
    'device' passes the device-resident capture (a JAX array / a tensor),
    whose window start rounds down to the same 128-aligned row grid in
    both, here from a cursor of 5000."""
    prns = tuple(range(1, 11))
    conf_j = jacq.AcqConf(fs_in=FS, max_dwells=2)
    conf_p = pacq.AcqConf(fs_in=FS, max_dwells=2)
    jeng = jacq.PcpsAcquisitionEngine(conf_j, prns)
    peng = pacq.PcpsAcquisitionEngine(conf_p, prns, device="cpu")
    assert peng.threshold == jeng.threshold
    if where == "host":
        x = capture[:8000]
        jr = jeng.acquire_from(x, 0)
        pr = peng.acquire_from(x, 0)
    else:
        x = capture[:40000]
        jr = jeng.acquire_from(jnp.asarray(x), 5000)
        pr = peng.acquire_from(torch.from_numpy(x), 5000)
    assert pr.samplestamp == jr.samplestamp
    assert np.array_equal(pr.detected, jr.detected)
    assert sorted(np.asarray(prns)[pr.detected]) == [1, 3, 4, 5, 9, 10]
    assert np.array_equal(pr.doppler_hz, jr.doppler_hz)
    assert np.array_equal(pr.delay_samples, jr.delay_samples)
    assert np.allclose(pr.test_stat, jr.test_stat, rtol=1e-4)


# ---- K3's row kernel: the tile rule -----------------------------------------

def _tiled_rows(grid, block):
    """The row kernel's reduction of a [C, D, N] grid in numpy, tile by
    tile of `block` lanes: per lane the running max (strict >, so a lane
    keeps its first index) and the running sum, then per row the max, the
    least index among the lanes at the max, and the sum of the lanes.

    Written by hand to mirror gnss_sim_receiver_tpu_torch/ops/pcps.py:
    536-555 (row_kernel's loop over the tiles and its closing reduction):
    an edit to either must be made to the other.  It checks the rule, not
    the Triton kernel; chip_smoke.py holds the kernel to the plain version
    on the card."""
    c, d, n = grid.shape
    best = np.full((c, d, block), -np.inf, np.float32)
    best_i = np.zeros((c, d, block), np.int64)
    total = np.zeros((c, d, block), np.float32)
    lanes = np.arange(block)
    for start in range(0, n, block):
        offs = start + lanes
        mask = offs < n
        acc = np.zeros((c, d, block), np.float32)
        acc[..., mask] = grid[..., offs[mask]]
        vals = np.where(mask, acc, -np.inf)
        better = vals > best
        best = np.where(better, vals, best)
        best_i = np.where(better, offs, best_i)
        total += acc
    rmax = best.max(axis=-1)
    rarg = np.where(best == rmax[..., None], best_i, n).min(axis=-1)
    return rmax, rarg, total.sum(axis=-1)


def test_row_tile_rule_first_index_on_ties():
    """At N = 40000 (the wideband L5I search's doubled FFT) the tiled
    reduction gives _rows_plain's max, first argmax and sum: small integer
    correlations (every value and sum exact in float32), the row's peak
    planted twice in one tile, in two tiles on one lane, in two tiles with
    the later tile's lane lower, and at the row's ends."""
    m, c, d, n = 2, 2, 3, 40000
    block, _ = ppcps.row_plan(n, "plain")
    rng = np.random.default_rng(40)
    corr = (rng.integers(-3, 4, (m, c, d, n))
            + 1j * rng.integers(-3, 4, (m, c, d, n))).astype(np.complex64)
    plants = {(0, 0): (5000, 5100),                  # one tile
              (0, 1): (100, 100 + block),            # one lane, two tiles
              (0, 2): (block + 52, 2 * block + 10),  # later tile, lower lane
              (1, 0): (block - 1, block),            # across a tile edge
              (1, 1): (0, n - 1),                    # the row's ends
              (1, 2): (n - 1, n - 2)}
    for (ci, di), cells in plants.items():
        for cell in cells:
            corr[:, ci, di, cell] = 9 + 9j
    grid = np.sum(corr.real ** 2 + corr.imag ** 2, axis=0, dtype=np.float32)
    want = [w.numpy() for w in ppcps._rows_plain(torch.from_numpy(corr))]
    got = _tiled_rows(grid, block)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for (ci, di), cells in plants.items():
        assert got[1][ci, di] == min(cells)


@pytest.mark.parametrize("n", [2000, 20000, 40000, 80000])
def test_row_plan_tile(n):
    """The row kernel never holds more than 2048 lanes of a row (one
    program once held a 65536-lane row at N = 40000), in a power-of-two
    tile."""
    for form in ppcps.FORMS:
        block, _ = ppcps.row_plan(n, form)
        assert block <= 2048 and block & (block - 1) == 0


# ---- the wipeoff kernel: its index arithmetic and phase, step for step -----

def _wipe_constants():
    """kThreads, kPerThread and kDwells of csrc/pcps_wipe.cu."""
    src = (Path(ppcps.__file__).parents[1] / "csrc"
           / "pcps_wipe.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
                 for name in ("kThreads", "kPerThread", "kDwells"))


def _wipe_writes(m_dw, rows, n):
    """pcps_wipe_kernel's stores in numpy: for every store, the flat output
    element it writes and the dwell, row and sample it reads x, t and the
    Doppler table at -> four int64 arrays.

    Written by hand to mirror csrc/pcps_wipe.cu:71-102 (a thread's row,
    samples and dwell slice, the early exit and the odd tail sample, the
    element each store writes; the 16-byte path stores the same two
    elements as the 8-byte one) and the grid of :114-117: an edit to
    either must be made to the other.  Only kThreads, kPerThread and
    kDwells are read from the source, so these tests check this copy."""
    threads, per, dwells = _wipe_constants()
    assert per == 2, "the mirror holds two samples a thread"
    gx = -(-n // (threads * per))
    gz = -(-m_dw // dwells)
    n0 = (np.arange(gx)[:, None] * threads
          + np.arange(threads)[None, :]).ravel() * per
    n0 = n0[n0 < n]
    dst, m_of, row_of, n_of = [], [], [], []
    for z in range(gz):
        for m in range(z * dwells, min(m_dw, z * dwells + dwells)):
            for row in range(rows):
                for lane, keep in ((0, np.ones_like(n0, bool)),
                                   (1, n0 + 1 < n)):
                    nn = n0[keep] + lane
                    dst.append((m * rows + row) * n + nn)
                    n_of.append(nn)
                    m_of.append(np.full_like(nn, m))
                    row_of.append(np.full_like(nn, row))
    return tuple(np.concatenate(a) for a in (dst, m_of, row_of, n_of))


@pytest.mark.parametrize("n", [2000, 4001, 160000])
@pytest.mark.parametrize("form", ["grid", "table"])
def test_wipe_kernel_covers_plain_outputs(form, n):
    """Every element of _wipe_plain's [M, D, N] (form "grid") or
    _wipe_per_channel_plain's [M, C, D2, N] output ("table", row c D2 + j)
    is stored exactly once, from x[m, n], t[n] and the row's Doppler;
    N odd takes the 8-byte path's lone last sample, and M = 19 three dwell
    slices, the last partial."""
    m_dw = 19 if n == 2000 else 2
    dops = (torch.linspace(-500.0, 500.0, 5) if form == "grid"
            else torch.linspace(-500.0, 500.0, 6).reshape(2, 3))
    x = torch.zeros((m_dw, n), dtype=torch.complex64)
    t = ppcps.time_axis(n, 2e6, torch.device("cpu"))
    plain = ppcps.pcps_wipe(x, dops, t)      # the plain version on the CPU
    assert plain.shape == (m_dw, *dops.shape, n)
    rows = dops.numel()
    dst, m_of, row_of, n_of = _wipe_writes(m_dw, rows, n)
    counts = np.bincount(dst, minlength=plain.numel())
    assert counts.shape == (plain.numel(),) and (counts == 1).all()
    np.testing.assert_array_equal(dst, (m_of * rows + row_of) * n + n_of)
    assert n_of.max() == n - 1 and m_of.max() == m_dw - 1


@pytest.mark.parametrize("form", ["grid", "table"])
def test_wipe_kernel_phase_is_the_plain_phase(form):
    """The kernel's phase, w = float32(-2 pi) * f rounded, then w * t[n]
    rounded (csrc/pcps_wipe.cu:77-80), in numpy, is the plain version's
    phase bit for bit: the receivers' grid at 2 and 20 Msps over N = 2000
    and 80000 samples, and a [C, D2] table of off-grid Dopplers."""
    rng = np.random.default_rng(3)
    for fs, n in ((2e6, 2000), (20e6, 80000)):
        if form == "grid":
            dops = ppcps.doppler_grid(5000.0, 250.0)
        else:
            dops = (rng.uniform(-5000.0, 5000.0, (10, 1))
                    + 62.5 * np.arange(-4, 5)[None, :]).astype(np.float32)
        t = ppcps.time_axis(n, fs, torch.device("cpu"))
        want = ppcps._wipe_phase(torch.from_numpy(dops), t).numpy()
        w = np.float32(-2.0 * math.pi) * dops
        assert w.dtype == np.float32
        got = w[..., None] * t.numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert np.float32(ppcps.NEG_TWO_PI) == np.float32(-2.0 * math.pi)


# ---- K7's fold on the card (csrc/pcps_rows.cu), emulated --------------------

def _fold_emulated(corr, n: int):
    """K7 in numpy on [D, (W + 1) N] correlations: per lag k the windows'
    |corr[d, w N + k]|^2 added in window order w = 0 .. W - 1 from 0, in
    float32; the halo's last N lags are not read."""
    d, row_len = corr.shape
    acc = np.zeros((d, n), np.float32)
    for w in range(row_len // n - 1):
        c = corr[:, w * n:(w + 1) * n]
        acc = acc + (c.real * c.real + c.imag * c.imag)
    return acc


def _jax_fold(corr, n: int):
    """The JAX fold expression (parallel/shard_steps.py:225-226) on the
    valid lags."""
    d, row_len = corr.shape
    lags = jnp.asarray(corr[:, :row_len - n])
    mag = jnp.real(lags) ** 2 + jnp.imag(lags) ** 2
    return np.asarray(mag.reshape(d, -1, n).sum(axis=1))


@pytest.mark.parametrize("n, windows", [(2000, 5), (1999, 5), (2000, 1),
                                        (333, 1), (64, 127)])
def test_fold_emulation_matches_jax_and_plain(n, windows):
    """The in-order window sum against the JAX fold and the port's plain
    version (1e-5 of the scale: their sums take their own order) at even
    and odd N, at L = N (one window) and at phase 9's 127 windows."""
    rng = np.random.default_rng(n + windows)
    d = 3
    corr = (rng.standard_normal((d, (windows + 1) * n))
            + 1j * rng.standard_normal((d, (windows + 1) * n))
            ).astype(np.complex64)
    got = _fold_emulated(corr, n)
    plain = ppcps.pcps_window_fold(torch.from_numpy(corr), n).numpy()
    for want in (_jax_fold(corr, n), plain):
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 1e-5 * scale
    if windows == 1:
        c = corr[:, :n]
        np.testing.assert_array_equal(got, c.real * c.real + c.imag * c.imag)


@pytest.mark.parametrize("n", [8, 9])
def test_fold_emulation_adds_windows_in_order(n):
    """The order is visible in the bits: 2^24 in window 0 then ones stays
    2^24 (each + 1 rounds to even), while the ones first would give
    2^24 + 4; the same lag with 2^24 last gives 2^24 + 4.  Integer cells,
    so no contraction changes them; the halo holds a value that must not
    be read."""
    windows = 5
    corr = np.zeros((2, (windows + 1) * n), np.complex64)
    corr[:, :windows * n] = 1.0
    corr[0, 3] = 4096.0                      # lag 3, window 0: 2^24
    corr[1, (windows - 1) * n + 3] = 4096.0  # lag 3, the last window
    corr[:, windows * n:] = 1e6              # the halo
    got = _fold_emulated(corr, n)
    assert got[0, 3] == np.float32(2.0 ** 24)
    assert got[1, 3] == np.float32(2.0 ** 24 + 4)
    assert (np.delete(got, 3, axis=1) == np.float32(windows)).all()
