"""The PyTorch port's device signal generator (kernel K6's path) against the
JAX package's on the CPU.

- ``_anchors``: bit for bit, for the whole capture and for a chunk of it
  (the anchors of one launch over the capture are those of the chunked
  JAX run).
- The noiseless output of ``generate_baseband_device_resident`` (K6's
  plain version) against JAX's ``generate_baseband_device(noise=False)``
  for GPS L1 C/A, Galileo E1-B and E1-C satellites at 4.092 Msps over
  0.25 s, one of them 70 ms late, so that its first blocks gather at
  sub-chip indices k < 0: tests/test_device_generator.py's criteria (median
  error below 1e-3 of the signal's rms, mean-square error below 1e-3 of its
  power, correlation above 0.999).
- Chunking is seamless; the noise has zero mean and unit variance (+-0.02);
  a sub-chip index past 2^31 raises OverflowError.
- K6's tiled index arithmetic (one floor division per thread and
  satellite, then compare-and-subtract), written out in numpy step for
  step, gives exactly ``_expand_plain``'s chip and symbol indices: on the
  first blocks of chip_smoke.py's hybrid and wideband scenarios (k < 0),
  where k turns >= 0 (the nav-bit table wraps), and on steps longer than
  a code period or symbol, or backwards (the kernel's fallback).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat

FS = 4_092_000.0


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs this file beside other
    workers, and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _sats(cls):
    rng = np.random.default_rng(0)

    def mk(n):
        return (rng.integers(0, 2, n) * 2 - 1).astype(np.int8)
    return [
        cls(prn=7, system="GPS", signal="1C", cn0_db_hz=46.0,
            doppler_hz=1800.0, delay_chips=213.4, nav_bits=mk(100)),
        cls(prn=11, system="Galileo", signal="1B", cn0_db_hz=44.0,
            doppler_hz=-2600.0, doppler_rate_hz_s=1.5, delay_chips=1001.25,
            nav_bits=mk(300)),
        cls(prn=12, system="Galileo", signal="1P", cn0_db_hz=45.0,
            doppler_hz=700.0, delay_chips=87.0, nav_bits=mk(200)),
        # a real signal delay: k < 0 over the first 70 ms
        cls(prn=3, system="GPS", signal="1C", cn0_db_hz=47.0,
            doppler_hz=-3100.0, doppler_rate_hz_s=-0.4, delay_sec=0.0712,
            carrier_phase_rad=1.3, nav_bits=mk(100)),
    ]


@pytest.mark.parametrize("start,nblk", [(0, 125), (5 * 8192, 40),
                                        (123_456_789, 7)])
def test_anchors_bit_equal(start, nblk):
    want = jdg._anchors(_sats(JSat), FS, start, nblk, None)
    got = pdg._anchors(_sats(PSat), FS, start, nblk, None)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # a chunk's anchors are the capture's, block for block
    whole = pdg._anchors(_sats(PSat), FS, 0, 125, None)
    part = pdg._anchors(_sats(PSat), FS, 5 * 8192, 40, None)
    for w, p in zip(whole[:5], part[:5]):
        assert np.array_equal(w[:, 5:45], p)
    assert (whole[0][3, :30] < 0).all()              # the late satellite


def _assert_agrees(got, ref):
    """tests/test_device_generator.py:31-41's criteria: float32 rounding
    and occasional one-sample chip-edge flips only (XLA contracts the
    chip-offset multiply-add, the port does not)."""
    p_sig = float(np.mean(np.abs(ref) ** 2))
    err = np.abs(got - ref)
    assert np.median(err) < 1e-3 * np.sqrt(p_sig)
    assert float(np.mean(err ** 2)) < 1e-3 * p_sig
    corr = np.vdot(ref, got).real / np.sqrt(
        np.vdot(ref, ref).real * np.vdot(got, got).real)
    assert corr > 0.999


def test_noiseless_matches_jax():
    n = int(FS * 0.25)
    ref = jdg.generate_baseband_device(_sats(JSat), FS, n, noise=False,
                                       seed=1)
    got = pdg.generate_baseband_device_resident(
        _sats(PSat), FS, n, noise=False, seed=1, chunk_samples=1 << 18,
        device="cpu")
    assert got.dtype == torch.complex64 and got.shape == (n,)
    _assert_agrees(got.numpy(), ref)
    # the late satellite alone over its first 2^18 samples, every one of
    # them gathered at k < 0
    n_neg = 1 << 18
    assert n_neg < 0.0712 * FS
    one = pdg.generate_baseband_device_resident(
        [_sats(PSat)[3]], FS, n_neg, noise=False, device="cpu").numpy()
    _assert_agrees(one, jdg.generate_baseband_device(
        [_sats(JSat)[3]], FS, n_neg, noise=False))


def test_host_entry_point_and_chunking_are_seamless():
    n = int(FS * 0.12)
    a = pdg.generate_baseband_device(_sats(PSat), FS, n, noise=False, seed=2,
                                     chunk_samples=13 * 8192, device="cpu")
    b = pdg.generate_baseband_device_resident(
        _sats(PSat), FS, n, noise=False, seed=2, chunk_samples=1 << 21,
        device="cpu")
    assert isinstance(a, np.ndarray) and a.dtype == np.complex64
    np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        pdg.generate_baseband_device(_sats(PSat), FS, n, chunk_samples=1000,
                                     device="cpu")


def test_nav_bits_drawn_as_jax_draws_them():
    sats_p = [PSat(prn=5, cn0_db_hz=45.0), PSat(prn=6, cn0_db_hz=45.0)]
    sats_j = [JSat(prn=5, cn0_db_hz=45.0), JSat(prn=6, cn0_db_hz=45.0)]
    pdg.generate_baseband_device_resident(sats_p, FS, 8192, noise=False,
                                          seed=9, device="cpu")
    jdg.generate_baseband_device(sats_j, FS, 8192, noise=False, seed=9)
    for p, j in zip(sats_p, sats_j):
        assert np.array_equal(p.nav_bits, j.nav_bits)


def test_noise_statistics():
    n = 400_000
    sat = _sats(PSat)[:1]
    gen = torch.Generator().manual_seed(3)
    x = pdg.generate_baseband_device_resident(sat, FS, n, noise=True,
                                              generator=gen, device="cpu")
    y = pdg.generate_baseband_device_resident(_sats(PSat)[:1], FS, n,
                                              noise=False, device="cpu")
    z = (x - y).numpy()
    assert abs(float(np.mean(z.real))) < 0.01
    assert abs(float(np.mean(z.imag))) < 0.01
    assert abs(float(np.mean(np.abs(z) ** 2)) - 1.0) < 0.02
    assert abs(float(np.var(z.real)) - 0.5) < 0.01
    # the seed decides the realization
    x2 = pdg.generate_baseband_device_resident(_sats(PSat)[:1], FS, n,
                                               noise=True, seed=3,
                                               device="cpu")
    assert torch.equal(x, x2)


def test_overflow_is_refused():
    late = 2100.0 * FS          # 2.1e3 s: GPS sub-chip index past 2^31
    with pytest.raises(OverflowError):
        jdg.generate_baseband_device(_sats(JSat)[:1], FS, 8192,
                                     start_sample=int(late), noise=False)
    with pytest.raises(OverflowError):
        pdg.generate_baseband_device_resident(
            _sats(PSat)[:1], FS, 8192, start_sample=int(late), noise=False,
            device="cpu")


# ---- the tiled kernel's index arithmetic, step for step --------------------

def _kernel_constants():
    """kThreads and kPerThread of csrc/device_generator.cu."""
    src = (Path(pdg.__file__).parents[1] / "csrc"
           / "device_generator.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
                 for name in ("kThreads", "kPerThread"))


def _tiled_indices(code_len, bits_len, sps, base, frac, crate):
    """device_generator_kernel's chip and symbol indices of every sample of
    [S, nblk] anchors, in numpy, step for step: a thread takes the floor
    divisions at its first sample, then for each of its next samples
    (kThreads on) advances by dk with the kernel's compare-and-subtract and
    its fallback.  -> two [S, nblk * 8192] int64 arrays.

    Written by hand to mirror csrc/device_generator.cu:172-198 (the
    first sample's divisions in device_generator_kernel, then the
    per-sample advance and its two fallbacks): an edit to either must be
    made to the other.  Only kThreads and kPerThread are read from the
    source, so these tests check this copy; what holds the kernel itself
    is chip_smoke.py's bit-for-bit check against the reference kernel."""
    threads, per = _kernel_constants()
    b = 8192
    j0 = (np.arange(b // (threads * per))[:, None] * threads * per
          + np.arange(threads)[None, :]).ravel()     # first samples in a block
    n_sat, nblk = base.shape
    chip_out = np.empty((n_sat, nblk, b), np.int64)
    sym_out = np.empty((n_sat, nblk, b), np.int64)

    def floor_at(fr, cr, nloc):
        return np.floor(fr + cr * nloc.astype(np.float32)).astype(np.int64)
    for s in range(n_sat):
        lc, sp, nb = int(code_len[s]), int(sps[s]), int(bits_len[s])
        fr, cr = frac[s][:, None], crate[s][:, None]
        f = floor_at(fr, cr, j0)
        k = base[s][:, None].astype(np.int64) + f
        ci = np.mod(k, lc)
        q = np.floor_divide(k, sp)
        si = k - q * sp
        bi = np.mod(q, nb)
        for r in range(per):
            if r:
                fn = floor_at(fr, cr, j0 + r * threads)
                dk = fn - f
                f = fn
                ci = ci + dk
                ci = np.where(ci >= lc, ci - lc, ci)
                ci = np.where((ci < 0) | (ci >= lc), np.mod(ci, lc), ci)
                si = si + dk
                edge = si >= sp
                si = np.where(edge, si - sp, si)
                bi = np.where(edge, np.where(bi + 1 == nb, 0, bi + 1), bi)
                far = (si < 0) | (si >= sp)
                qs = np.floor_divide(si, sp)
                si = np.where(far, si - qs * sp, si)
                bi = np.where(far, np.mod(bi + qs, nb), bi)
            chip_out[s][:, j0 + r * threads] = ci
            sym_out[s][:, j0 + r * threads] = bi
    return chip_out.reshape(n_sat, -1), sym_out.reshape(n_sat, -1)


def _hold_to_plain(tabs, blocks):
    """The tiled indices of anchor blocks `blocks` against _expand_plain's
    own (_plain_indices); returns the plain indices."""
    code_len, bits_len, sps = (t.numpy() for t in (tabs[1], tabs[3],
                                                   tabs[4]))
    base, frac, crate = (t[:, blocks].contiguous() for t in tabs[5:8])
    want = pdg._plain_indices(tabs[1], tabs[3], tabs[4], base, frac, crate)
    got = _tiled_indices(code_len, bits_len, sps, base.numpy(),
                         frac.numpy(), crate.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    return want


@pytest.fixture(scope="module")
def scenarios():
    """The hybrid (phase 5) and wideband (phase 7) scenarios of
    chip_smoke.py, their tables and anchors on the CPU over 10 s."""
    import chip_smoke
    out = {}
    for name, sats, fs in (("hybrid", chip_smoke.hybrid_sats(),
                            chip_smoke.FS_REF_HYBRID),
                           ("wideband", chip_smoke.wideband_sats(),
                            chip_smoke.FS_WIDEBAND)):
        pdg._fill_nav_bits(sats, 17)
        out[name] = pdg._prepare(sats, fs, int(fs * 10.0), 0,
                                  torch.device("cpu"))
    return out


@pytest.mark.parametrize("name", ["hybrid", "wideband"])
def test_tiled_indices_first_chunk(scenarios, name):
    """The first 16 blocks: every satellite's sub-chip index k < 0."""
    tabs = scenarios[name]
    assert (tabs[5][:, :16] < 0).all()
    _hold_to_plain(tabs, slice(0, 16))


@pytest.mark.parametrize("name", ["hybrid", "wideband"])
def test_tiled_indices_table_wraps(scenarios, name):
    """The blocks where k turns from negative to >= 0 for every satellite:
    the symbol index wraps the nav-bit table (Nb - 1 -> 0) there, and the
    chip index wraps the code table at least twice."""
    tabs = scenarios[name]
    neg = (tabs[5] < 0).sum(dim=1)
    lo, hi = int(neg.min()) - 2, int(neg.max()) + 2
    chip_i, sym_i = _hold_to_plain(tabs, slice(lo, hi))
    nb = tabs[3][:, None]
    assert ((sym_i[:, :-1] == nb - 1) & (sym_i[:, 1:] == 0)).any(dim=1).all()
    assert (torch.diff(chip_i, dim=1) < 0).sum(dim=1).min() >= 2


@pytest.mark.parametrize("crate", [3.7, 41.0, -0.3])
def test_tiled_indices_fallback(crate):
    """Steps past a whole code period or symbol (dk >= 2 Lc, 2 sps) and
    backwards (dk < 0) take the kernel's fallback, with the same indices:
    tiny tables, anchors on both sides of 0."""
    rng = np.random.default_rng(int(abs(crate) * 10))
    nblk = 3
    tabs = [None, torch.tensor([13, 7], dtype=torch.int32), None,
            torch.tensor([5, 3], dtype=torch.int32),
            torch.tensor([4, 9], dtype=torch.int32),
            torch.from_numpy(rng.integers(-40000, 40000, (2, nblk))
                             .astype(np.int32)),
            torch.from_numpy(rng.random((2, nblk)).astype(np.float32)),
            torch.full((2, nblk), crate, dtype=torch.float32)]
    _hold_to_plain(tabs, slice(0, nblk))
