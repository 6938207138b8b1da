"""The acquisition tail of the port (``use_CFAR_algorithm=false``: the
first-vs-second-peak statistic, kernel K3c; the fixed threshold of
``pfa <= 0``; ``bit_transition_flag`` on every variant) against the JAX
package on the CPU, where K3c's wrapper runs its plain version.

- ``first_vs_second_peak_stat`` on tests/test_torch_pcps.py's grid and on
  a grid whose peaks lie within samples_per_chip of the row's two ends
  (the exclusion zone wraps): the whole search (wipeoff, FFT, product,
  IFFT, K3c) against the JAX grid and statistic.
- K3c's dual (CCCWSR, 8 ms) and CAF (E5a I/Q, b = 1) forms against the JAX
  engine's ``_stat_pack`` of ``pcps_cccwsr_grid``, ``pcps_8ms_grid`` and
  ``pcps_e5a_noncoherent_iq_grid``.
- ``acquire_from`` under the statistic with a fixed threshold (two-step
  PCPS, the step-two statistic not folded in), from a host array and from
  a device-resident capture.
- Tong, Fine Doppler, QuickSync, CCCWSR and 8 ms with
  ``bit_transition_flag``, under either statistic.
- The factory on the new keys against the JAX factory.
- The CLI at the canonical operating point with the fixed threshold.

Tolerances: indices (Doppler, delay) and detections identical; the
statistic within rtol 1e-4 (two float32 FFT libraries, and the kernel's
|c|^2 may contract into an FMA where torch's does not).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.__main__ import main as jax_main
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import factory as jfactory
from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JInMemory
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch import signals as psig
from gnss_sim_receiver_tpu_torch.__main__ import run_cli
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import factory
from gnss_sim_receiver_tpu_torch.ops import pcps as ppcps
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
from tests.fixtures import static_scenario_capture
from tests.test_acq_variants import _e1_capture
from tests.test_factory_chains import _sim_l1
from tests.test_torch_cli import CONF, _tracked

FS = 2_000_000.0
M, N = 2, 2000
SPC = 2                       # round(2 Msps / 1.023 Mcps)
# the fixed threshold of the first-vs-second-peak statistic: at it the JAX
# receiver acquires exactly the static scenario's PRNs 1, 3, 4, 5, 9, 10
# (present 3.9 to 6.0, absent below 2.0 on its 2 Msps capture); the card's
# phase 4e takes the same value
THRESHOLD = 2.5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs this file beside other
    workers, and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _grid_case(delays):
    """tests/test_torch_pcps.py's grid_inputs (PRNs 3 and 11 at 45 dB-Hz in
    two 1 ms dwells, searched for PRNs 3, 7, 11, 20 over 41 bins) with the
    two satellites at `delays` (chips)."""
    prns = [3, 7, 11, 20]
    sats = [SatelliteSignalParams(prn=3, cn0_db_hz=45.0, doppler_hz=1310.0,
                                  delay_chips=delays[0],
                                  nav_bits=np.ones(8, np.int8)),
            SatelliteSignalParams(prn=11, cn0_db_hz=45.0, doppler_hz=-2890.0,
                                  delay_chips=delays[1],
                                  nav_bits=np.ones(8, np.int8))]
    x = generate_baseband(sats, FS, M * N, noise=True, seed=5
                          ).reshape(M, N).astype(np.complex64)
    codes = np.stack([jpc.sample_code(jpc.gps_l1_ca_code(p), FS, 1.023e6, N)
                      for p in prns])
    cfc = np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)
    return x, cfc, jpcps.doppler_grid(5000.0, 250.0)


# grid_inputs' delays, and delays whose peaks fall within SPC samples of
# lag 0 and of lag N - 1
GRID_CASES = {"grid_inputs": (211.3, 777.7), "zone_wraps": (0.4, 1022.6)}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_first_vs_second_matches_jax(case):
    x, cfc, dops = _grid_case(GRID_CASES[case])
    grid = jpcps.pcps_grid(jnp.asarray(x), jnp.asarray(cfc),
                           jnp.asarray(dops), FS)
    js, jd, jn = (np.asarray(a) for a in
                  jpcps.first_vs_second_peak_stat(grid, SPC))
    # the plain statistic on the JAX grid, line for line
    ps, pd, pn = (a.numpy() for a in ppcps.first_vs_second_peak_stat(
        torch.from_numpy(np.array(grid)), SPC))
    assert np.array_equal(pd, jd) and np.array_equal(pn, jn)
    assert np.allclose(ps, js, rtol=1e-6)
    # the port's whole search: wipeoff, FFT, product, IFFT, K3c
    xt, ct, dt = (torch.from_numpy(a) for a in (x, cfc, dops))
    t = ppcps.time_axis(N, FS, "cpu")
    ss, sd, sn = (a.numpy() for a in ppcps.pcps_search(
        xt, ct, dt, t, use_cfar=False, samples_per_chip=SPC))
    assert np.array_equal(sd, jd) and np.array_equal(sn, jn)
    assert sd.dtype == np.int32 and sn.dtype == np.int32
    assert np.allclose(ss, js, rtol=1e-4)
    # the present satellites stand above the absent ones
    assert min(ss[0], ss[2]) > 2.0 * max(ss[1], ss[3])
    if case == "zone_wraps":
        assert min(jn[0], N - 1 - jn[0]) <= SPC
        assert min(jn[2], N - 1 - jn[2]) <= SPC
    # K3c's wrapper on the search's correlations
    corr = torch.fft.ifft(torch.fft.fft(ppcps.pcps_wipe(xt, dt, t), dim=-1)
                          [:, None] * ct[None, :, None], dim=-1)
    ks, kd, kn = ppcps.pcps_second_peak(corr, M, SPC)
    assert np.array_equal(kd.numpy(), jd) and np.array_equal(kn.numpy(), jn)
    assert np.allclose(ks.numpy(), js, rtol=1e-4)


def test_zone_wraps_on_a_planted_grid():
    """Cells within SPC of the peak delay, circularly, are excluded: a
    second peak at the far end of the row inside the zone is skipped, one
    just outside it is taken."""
    g = np.full((3, 4, 50), 0.5, np.float32)
    g[:, 2, 1] = 10.0                        # the peak at delay 1
    g[0, 2, 49] = 9.0                        # distance 2: inside the zone
    g[1, 2, 47] = 4.0                        # distance 4: outside
    g[2, 2, 48] = 5.0                        # distance 3: inside at SPC 3
    for spc in (2, 3):
        js = np.asarray(jpcps.first_vs_second_peak_stat(jnp.asarray(g),
                                                        spc)[0])
        ps = ppcps.first_vs_second_peak_stat(torch.from_numpy(g),
                                             spc)[0].numpy()
        assert np.array_equal(ps, js)
    assert np.allclose(ps, [20.0, 2.5, 20.0])


# ---- K3c's plain form on the card (csrc/pcps_rows.cu), emulated -----------

ROWS_CU = Path(ppcps.__file__).parents[1] / "csrc" / "pcps_rows.cu"


def _cu_zone_dist():
    """zone_dist of csrc/pcps_rows.cu (the circular distance of delay k
    from the row's argmax): the operand of its % read from the source and
    evaluated here; the kernel takes its % n as at most two subtractions
    of n, which needs the operand in [0, 3 n) for k and the argmax in
    [0, N) (the + n keeps it >= 0).  dist(k, peak, n) -> int64 array."""
    body = re.search(r"int zone_dist\(int k, int peak, int n, int half\) "
                     r"\{(.*?)\n\}", ROWS_CU.read_text(), re.S)[1]
    operand = re.search(r"int x = (.*?);", body)[1]

    def dist(k, peak, n):
        half = n // 2
        x = eval(operand, {}, {"k": np.asarray(k, np.int64),
                               "peak": np.asarray(peak, np.int64),
                               "n": n, "half": half})
        assert ((x >= 0) & (x < 3 * n)).all()
        x = x - np.where(x >= n, n, 0)
        x = x - np.where(x >= n, n, 0)
        return np.abs(x - half)
    return dist


def _k3c_emulated(grid, spc: int, tiles: bool):
    """csrc/pcps_rows.cu's K3c in numpy on a [C, D, N] float32 grid.  Per
    (channel, row), one CTA's work: the row's max and first argmax, then
    its own second around its own argmax.  A row of one round keeps its
    cells (`tiles` False): the max of the threads' parts
    (:func:`_own_seconds`).  A
    longer row (`tiles` True) takes the max of the kTileCells-cell tile
    maxima of the tiles wholly outside the zone and of the cells outside
    the zone of the (at most two) tiles holding the zone's ends
    (s = argmax - spc and e = argmax + spc, modulo N; a tile holding
    neither end is decided by its first cell).  Per channel, the last
    CTA's work: the first row at the channel's max, its argmax, its
    second, the ratio.  Written by hand to mirror the kernel; only
    kTileCells, kThreads, kSlots and zone_dist are read from the
    source."""
    src = ROWS_CU.read_text()
    tc, threads, slots = (int(re.search(rf"constexpr int {name} = (\d+);",
                                        src)[1])
                          for name in ("kTileCells", "kThreads", "kSlots"))
    dist = _cu_zone_dist()
    c, d, n = grid.shape
    n_tiles = -(-n // tc)
    padded = np.zeros((c, d, n_tiles * tc), np.float32)
    padded[..., :n] = grid
    tile_max = padded.reshape(c, d, n_tiles, tc).max(axis=-1)
    rmax, rarg = grid.max(axis=-1), grid.argmax(axis=-1)
    first = np.arange(n_tiles) * tc
    second = np.zeros((c, d), np.float32)
    zero = np.float32(0.0)
    for ci in range(c):
        for di in range(d):
            k = int(rarg[ci, di])
            if not tiles:
                second[ci, di] = _own_seconds(grid[ci, di], k, spc, dist,
                                              threads, slots).max()
                continue
            s, e = ((k - spc) % n + n) % n, (k + spc) % n
            ends = {s // tc, e // tc}
            whole = ((dist(first, k, n) > spc)
                     & ~np.isin(np.arange(n_tiles), list(ends)))
            best = tile_max[ci, di, whole].max(initial=zero)
            for j in ends:
                cells = np.arange(j * tc, min(j * tc + tc, n))
                keep = cells[dist(cells, k, n) > spc]
                best = max(best, grid[ci, di, keep].max(initial=zero))
            second[ci, di] = best
    d_star = rmax.argmax(axis=-1)              # the first row at the max
    ch = np.arange(c)
    stat = rmax[ch, d_star] / np.maximum(second[ch, d_star],
                                         np.float32(1e-30))
    return (stat.astype(np.float32), d_star.astype(np.int32),
            rarg[ch, d_star].astype(np.int32))


def _own_seconds(row, k: int, spc: int, dist, threads: int, slots: int):
    """A one-round row's per-thread parts of the second around its argmax
    k: thread t holds the pairs u threads + t (u < slots), cells 2 p and
    2 p + 1; its part is its own first max where that lies outside the
    zone, else the max of its cells outside the zone."""
    n = row.shape[0]
    p = np.arange(slots)[None, :] * threads + np.arange(threads)[:, None]
    idx = np.stack([2 * p, 2 * p + 1], axis=-1).reshape(threads, -1)
    assert idx.max() >= n - 1 and (np.diff(idx, axis=1) > 0).all()
    valid = idx < n
    idx = np.minimum(idx, n - 1)               # the invalid cells unread
    cells = np.where(valid, row[idx], np.float32(-1.0))
    first = cells.argmax(axis=1)
    best = cells[np.arange(threads), first]
    best_i = idx[np.arange(threads), first]
    outside = valid & (dist(idx, k, n) > spc)
    scanned = np.where(outside, cells, np.float32(0.0)).max(axis=1)
    own = (best >= 0) & (dist(best_i, k, n) > spc)
    return np.where(own, best, scanned).astype(np.float32)


def _k3c_against_jax(grid, spc: int):
    """The emulation, in both forms, bit for bit JAX's
    first_vs_second_peak_stat."""
    want = [np.asarray(a) for a in
            jpcps.first_vs_second_peak_stat(jnp.asarray(grid), spc)]
    for tiles in (False, True):
        got = _k3c_emulated(grid, spc, tiles)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(
            got[0].view(np.int32), want[0].astype(np.float32).view(np.int32))
    return got


def test_cu_zone_dist_is_the_circular_distance():
    """zone_dist as csrc/pcps_rows.cu writes it is min(|k - peak|,
    N - |k - peak|) for every (k, peak) at an even and an odd N; without
    its + n the operand of its % goes negative."""
    dist = _cu_zone_dist()
    for n in (64, 65):
        k, peak = np.meshgrid(np.arange(n), np.arange(n))
        r = np.abs(k - peak)
        np.testing.assert_array_equal(dist(k, peak, n), np.minimum(r, n - r))


@pytest.mark.parametrize("n", [64, 65, 100, 2000, 2001])
@pytest.mark.parametrize("spc", [0, 1, 2, 31, 64])
def test_k3c_emulation_matches_jax_on_random_grids(n, spc):
    """Random grids (exponential cells, one channel with a strong peak)
    at N a whole tile, a tile and one, ragged, the receivers' 2000 and
    odd; the zone from a single cell to two whole tiles."""
    rng = np.random.default_rng(n * 100 + spc)
    grid = rng.standard_exponential((3, 5, n)).astype(np.float32)
    grid[1, 3, n // 3] = 40.0
    _k3c_against_jax(grid, spc)


def test_k3c_emulation_on_the_search_grid():
    """tests/test_torch_pcps.py's search grid (JAX's pcps_grid) and its
    zone-wrapping variant, the receiver's spc = 2."""
    for delays in GRID_CASES.values():
        x, cfc, dops = _grid_case(delays)
        grid = np.asarray(jpcps.pcps_grid(jnp.asarray(x), jnp.asarray(cfc),
                                          jnp.asarray(dops), FS))
        _k3c_against_jax(grid, SPC)


def _planted(n=200, d=6, c=2, seed=7):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (c, d, n)).astype(np.float32)


def test_k3c_emulation_tie_across_rows():
    """Two rows at the channel's max: the first row wins, with its own
    delay and second, not the later row's."""
    g = _planted()
    g[0, 1, 150], g[0, 4, 20] = 9.0, 9.0
    g[0, 1, 10], g[0, 4, 100] = 3.0, 6.0        # the rows' own seconds
    g[1, 5, 60], g[1, 2, 61] = 9.0, 9.0
    stat, d_star, k_star = _k3c_against_jax(g, 2)
    assert list(d_star) == [1, 2] and list(k_star) == [150, 61]
    assert stat[0] == np.float32(3.0)


def test_k3c_emulation_tie_within_a_row():
    """Two delays of one row at the max: the first is k*; outside the zone
    the other is the second (ratio 1), inside it the other is zeroed."""
    g = _planted()
    g[0, 3, 40], g[0, 3, 170] = 9.0, 9.0
    g[1, 2, 40], g[1, 2, 42] = 9.0, 9.0
    stat, d_star, k_star = _k3c_against_jax(g, 2)
    assert list(k_star) == [40, 40] and stat[0] == np.float32(1.0)
    assert stat[1] > 9.0


@pytest.mark.parametrize("at", [0, -1])
def test_k3c_emulation_peak_at_the_row_ends(at):
    """k* at 0 and at N - 1 (N odd and even): the zone wraps; the cell
    across the wrap at distance spc is zeroed, the one at spc + 1 is the
    second."""
    for n in (200, 201):
        g = _planted(n)
        k = at % n
        g[:, 2, k] = 9.0
        g[:, 2, (k + 2) % n] = 8.0              # inside the zone
        g[0, 2, (k - 2) % n] = 8.5              # inside the zone
        g[0, 2, (k + 3) % n] = 4.0              # the second, outside
        g[1, 2, (k - 3) % n] = 5.0
        stat, d_star, k_star = _k3c_against_jax(g, 2)
        assert list(k_star) == [k, k]
        assert list(stat) == [np.float32(9.0 / 4.0), np.float32(9.0 / 5.0)]


def test_k3c_emulation_zone_covers_the_row():
    """spc >= N / 2: every cell is in the zone, the second is 0 and the
    ratio peak / 1e-30; spc = N / 2 - 1 at even N leaves the antipode."""
    for n in (64, 200, 201):
        g = _planted(n)
        stat, _, _ = _k3c_against_jax(g, n // 2)
        peak = g.max(axis=(1, 2))
        np.testing.assert_array_equal(stat, peak / np.float32(1e-30))
    g = _planted(200)
    stat, d_star, k_star = _k3c_against_jax(g, 99)
    for ci in range(2):
        row = g[ci, d_star[ci]]
        assert stat[ci] == row.max() / row[(k_star[ci] + 100) % 200]


def _je(conf_kw, prns, **kw):
    return jacq.PcpsAcquisitionEngine(jacq.AcqConf(**conf_kw), prns, **kw)


def _pe(conf_kw, prns, **kw):
    return pacq.PcpsAcquisitionEngine(pacq.AcqConf(**conf_kw), prns,
                                      device="cpu", **kw)


E1_KW = dict(fs_in=4_500_000.0, doppler_center=1750.0, doppler_max=500.0,
             doppler_step=125.0, max_dwells=2, sampled_ms=4,
             use_cfar_algorithm=False)


def _e1_providers():
    sig = jsig.GALILEO_E1B
    jkw = dict(code_provider=lambda p: jsig.subchip_table(sig, p),
               sc_rate=sig.sc_rate,
               code_provider2=lambda p: jsig.boc11_expand(
                   jsig.galileo_e1_code(p, "C")))
    pkw = dict(code_provider=psig.CodeProvider("1B"),
               sc_rate=psig.GALILEO_E1B.sc_rate,
               code_provider2=psig.CodeProvider("1B", "C"))
    return jkw, pkw


@pytest.mark.parametrize("variant", ["cccwsr", "8ms"])
def test_dual_form_matches_jax_stat_pack(variant):
    """K3c's dual form on the port's [M, C, D, 2, N] planes against the JAX
    engine's _stat_pack of its sign-recovery grid."""
    x, n, fs = _e1_capture()
    jkw, pkw = _e1_providers()
    kw = dict(E1_KW, variant=variant)
    je, pe = _je(kw, [11, 19], **jkw), _pe(kw, [11, 19], **pkw)
    assert pe.samples_per_chip == je.samples_per_chip == 2
    width = n * (2 if variant == "8ms" else 1)
    xd = np.asarray(x[: M * width]).reshape(M, width).astype(np.complex64)
    if variant == "cccwsr":
        grid = jpcps.pcps_cccwsr_grid(jnp.asarray(xd), je.code2_fft_conj,
                                      je.code_fft_conj, je.dopplers, fs)
    else:
        grid = jpcps.pcps_8ms_grid(jnp.asarray(xd), je.code_fft_conj,
                                   je.dopplers, fs)
    js, jdel, jdop = je._stat_pack(grid, 2 * M)
    corr = ppcps.dual_correlations(
        torch.from_numpy(xd), pe.code_fft_conj, pe.code2_fft_conj,
        pe.dopplers, pe._t, variant)
    stat, di, de = ppcps.pcps_second_peak(corr, M, pe.samples_per_chip,
                                          "dual")
    assert np.array_equal(de.numpy(), jdel)
    assert np.array_equal(pe.dopplers[di.long()].numpy(), jdop)
    assert np.allclose(stat.numpy(), js, rtol=1e-4)
    assert stat[0] > 2.0 * stat[1]
    buf = ppcps.pcps_search_dual(torch.from_numpy(xd), pe.code_fft_conj,
                                 pe.code2_fft_conj, pe.dopplers, pe._t,
                                 variant, use_cfar=False,
                                 samples_per_chip=pe.samples_per_chip)
    assert torch.equal(buf[0], stat) and torch.equal(buf[2], de.float())


def test_caf_form_matches_jax_stat_pack():
    """K3c's CAF form (b = 1) against the JAX engine's _stat_pack of
    pcps_e5a_noncoherent_iq_grid on tests/test_torch_iq_caf.py's dwells
    (E5a-I PRN 3 present, PRN 27 absent; 12.5 Msps, D=33)."""
    from tests.test_torch_iq_caf import RATE
    fs = 12_500_000.0
    n = int(fs * 1e-3)
    sat = SatelliteSignalParams(prn=3, system="Galileo", signal="5X",
                                cn0_db_hz=47.0, doppler_hz=-1800.0,
                                delay_chips=5000.25,
                                nav_bits=np.ones(40, np.int8))
    x = generate_baseband([sat], fs, 3 * n, noise=True, seed=5
                          )[: M * n].reshape(M, n).astype(np.complex64)
    kw = dict(fs_in=fs, doppler_max=4000.0, doppler_step=250.0, max_dwells=M,
              variant="iq_caf", caf_bins=1, use_cfar_algorithm=False)
    je = _je(kw, [3, 27], sc_rate=RATE,
             code_provider=lambda p: jsig.galileo_e5a_code(p, "I"),
             code_provider2=lambda p: jsig.galileo_e5a_code(p, "Q"))
    pe = _pe(kw, [3, 27], sc_rate=RATE,
             code_provider=psig.CodeProvider("5X"),
             code_provider2=psig.CodeProvider("5X", "Q"))
    assert pe.samples_per_chip == je.samples_per_chip == 1
    grid = jpcps.pcps_e5a_noncoherent_iq_grid(
        jnp.asarray(x), je.code_fft_conj, je.code2_fft_conj, je.dopplers,
        fs, caf_bins=1)
    js, jdel, jdop = je._stat_pack(grid, 2 * M)
    buf = ppcps.pcps_search_iq_caf(
        torch.from_numpy(x), pe.code_fft_conj, pe.code2_fft_conj,
        pe.dopplers, pe._t, 1, use_cfar=False, samples_per_chip=1)
    assert np.array_equal(buf[2].numpy().astype(np.int64), jdel)
    assert np.array_equal(buf[1].numpy(), jdop.astype(np.float32))
    assert np.allclose(buf[0].numpy(), js, rtol=1e-4)
    assert buf[0, 0] > 2.0 * buf[0, 1]


@pytest.fixture(scope="module")
def capture():
    x, _ = static_scenario_capture()
    return x


@pytest.mark.parametrize("where", ["host", "device"])
def test_acquire_from_fixed_threshold_matches_jax(capture, where):
    """Two-step PCPS under the first-vs-second-peak statistic with the
    fixed threshold (pfa = 0), PRNs 1-10 on the static scenario: the same
    detections (exactly the present PRNs), Doppler (the narrow grid's),
    delay, statistic and threshold; the step-two CFAR statistic is not
    folded into the detection."""
    kw = dict(fs_in=FS, max_dwells=2, pfa=0.0, threshold=THRESHOLD,
              use_cfar_algorithm=False, make_two_steps=True,
              doppler_step2=125.0, num_doppler_bins_step2=4)
    prns = tuple(range(1, 11))
    je, pe = _je(kw, prns), _pe(kw, prns)
    assert pe.threshold == je.threshold == THRESHOLD
    if where == "host":
        jr, pr = je.acquire_from(capture[:8000], 0), \
            pe.acquire_from(capture[:8000], 0)
    else:
        x = capture[:40000]
        jr = je.acquire_from(jnp.asarray(x), 5000)
        pr = pe.acquire_from(torch.from_numpy(x), 5000)
    assert pr.samplestamp == jr.samplestamp
    assert np.array_equal(pr.detected, jr.detected)
    assert sorted(np.asarray(prns)[pr.detected]) == [1, 3, 4, 5, 9, 10]
    assert np.array_equal(pr.doppler_hz, jr.doppler_hz)
    assert np.array_equal(pr.delay_samples, jr.delay_samples)
    assert np.allclose(pr.test_stat, jr.test_stat, rtol=1e-4)
    assert pr.test_stat.max() < 20.0     # the ratio, not the CFAR statistic


# variant -> (conf fields, PRNs, capture, the engines' code providers)
def _gps(variant, **fields):
    return (dict(fs_in=FS, variant=variant, **fields), [5, 11],
            lambda: _sim_l1(n_ms=24), lambda: ({}, {}))


BIT_CASES = {
    "tong": _gps("tong", tong_init=1, tong_max=3, tong_max_dwells=6),
    "fine_doppler": _gps("fine_doppler", doppler_step=500.0, max_dwells=2),
    "quicksync": _gps("quicksync", max_dwells=4, quicksync_fold=4),
    "cccwsr": (dict(E1_KW, variant="cccwsr"), [11, 19],
               lambda: _e1_capture(dwells=4)[0], _e1_providers),
    "8ms": (dict(E1_KW, variant="8ms"), [11, 19],
            lambda: _e1_capture(dwells=4)[0], _e1_providers),
}


# (use_CFAR_algorithm, bit_transition_flag) of each case
MODES = {"cfar_bit": (True, True), "ratio": (False, False),
         "ratio_bit": (False, True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("variant", list(BIT_CASES))
def test_tail_variants_match_jax(variant, mode):
    """bit_transition_flag on every variant but pcps and iq_caf (held in
    tests/test_torch_wideband.py): the doubled FFT and cell count, the
    delay modulo one code period; QuickSync keeps its one period and the
    CFAR statistic, whatever use_CFAR_algorithm says.  Under the
    first-vs-second-peak statistic the threshold is fixed (pfa = 0).  The
    same detections, Doppler, delay, threshold and statistic (rtol 1e-4) as
    the JAX engine.  The present PRN alone is detected, but under the
    ratio with the doubled FFT: the peak repeats one code period later
    and, with no bit edge in these captures to cut one of the two
    periods, the ratio stays near 1 in both packages
    (acquisition.py:45-48), so nothing is."""
    use_cfar, bit = MODES[mode]
    fields, prns, capture, providers = BIT_CASES[variant]
    ratio = not use_cfar and variant != "quicksync"
    kw = dict(fields, bit_transition_flag=bit, pfa=0.0 if ratio else 0.01,
              threshold=THRESHOLD, use_cfar_algorithm=use_cfar)
    jkw, pkw = providers()
    je, pe = _je(kw, prns, **jkw), _pe(kw, prns, **pkw)
    assert pe.n_samples_needed == je.n_samples_needed
    assert pe.fft_size == je.fft_size == (1 + bit) * pe.n_coherent
    x = capture()
    want = je.acquire(x[:je.n_samples_needed])
    got = pe.acquire_from(torch.from_numpy(np.asarray(x)), 0)
    assert got.threshold == want.threshold
    assert np.array_equal(got.detected, want.detected)
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert got.delay_samples.max() < pe.n_coherent
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    if ratio and bit:
        assert not got.detected.any() and got.test_stat.max() < 1.8
    else:
        assert list(got.detected) == [True, False]


# the new keys on every ported acquisition string
FACTORY_CASES = [
    ("1C", "GPS_L1_CA_PCPS_Acquisition"),
    ("1C", "GPS_L1_CA_PCPS_QuickSync_Acquisition"),
    ("1C", "GPS_L1_CA_PCPS_Tong_Acquisition"),
    ("1C", "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler"),
    ("1B", "Galileo_E1_PCPS_Ambiguous_Acquisition"),
    ("1B", "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition"),
    ("1B", "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition"),
    ("L5", "GPS_L5i_PCPS_Acquisition"),
    ("5X", "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF"),
]


@pytest.mark.parametrize("sig,impl", FACTORY_CASES)
def test_factory_reads_the_tail_keys_like_jax(sig, impl):
    """use_CFAR_algorithm=false, pfa=0 with a threshold and
    bit_transition_flag=true build the JAX factory's configuration."""
    props = {"GNSS-SDR.internal_fs_sps": "4000000",
             f"Channels_{sig}.count": "4",
             f"Acquisition_{sig}.implementation": impl,
             f"Acquisition_{sig}.use_CFAR_algorithm": "false",
             f"Acquisition_{sig}.pfa": "0",
             f"Acquisition_{sig}.threshold": "3.2",
             f"Acquisition_{sig}.bit_transition_flag": "true"}
    ref = jfactory.receiver_conf_from_config(JInMemory(dict(props)))
    got = factory.receiver_conf_from_config(InMemoryConfiguration(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    acq = got.acq if sig == "1C" else got.chains[0].acq
    assert (acq.use_cfar_algorithm, acq.pfa, acq.threshold,
            acq.bit_transition_flag) == (False, 0, 3.2, True)


def test_cli_fixed_threshold_like_jax(tmp_path, capsys):
    """Both CLIs at the canonical operating point with
    use_CFAR_algorithm=false and the fixed threshold, on 4 s of the static
    scenario at 4 Msps (2 Msps repeated) written as ishort: the same tracked
    PRNs, the scenario's."""
    x, _ = static_scenario_capture()
    cap = tmp_path / "cap.ishort"
    write_samples(cap, np.repeat(x[: int(2e6 * 4)], 2), "ishort",
                  scale=200.0)
    conf = tmp_path / "rx.conf"
    conf.write_text(CONF.format(filename=cap).replace(
        "Acquisition_1C.pfa=0.01",
        "Acquisition_1C.pfa=0\nAcquisition_1C.use_CFAR_algorithm=false\n"
        f"Acquisition_1C.threshold={THRESHOLD}"))
    res = run_cli([f"--config_file={conf}", "--device=cpu"])
    out = capsys.readouterr().out
    assert res.exit_code == 1                    # no ephemeris in 4 s
    prns = _tracked(out)
    assert set(prns) == {1, 3, 4, 5, 9, 10}
    assert jax_main([f"--config_file={conf}"]) == 1
    assert sorted(_tracked(capsys.readouterr().out)) == sorted(prns)
