"""Kernels K2 (per-epoch multicorrelator) and K1 (block correlator) split
each channel over S CTAs and sum the slabs' partial correlations in slab
order inside the launch (``ops/correlator.py:plan_k2``,
``models/tracking_block.py:plan_k1``).  The kernels run only on the card;
on the CPU:

- the planners' slabs cover every shape ``chip_smoke.py`` launches the
  kernels at (2, 4 and 20 Msps; the GPS L1 C/A, Galileo E1 and E5a/L5
  tables; C = 8, 10 and 12, and K1 at bench.py's C = 48 and 192) exactly
  once with no empty slab, and K2's staged table span holds every code
  index a slab reads there;
- a plain rendering of each kernel's slab-then-ordered sum (the plain
  version on one slab's samples or bins at a time, the partials added in
  slab order) agrees with the plain version and with the JAX function on
  the same numpy inputs, within 1e-4 of the largest plain magnitude: the
  tolerance ``chip_smoke.py`` holds the kernels to (float32 sums taken in
  another order);
- K1's plain version selects the JAX program's window rows (the start
  clipped to [0, W - E]) when the start lies outside that range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.ops import correlator as jcorr
from gnss_sim_receiver_tpu_torch import signals
from gnss_sim_receiver_tpu_torch.device import H100_SMS
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.ops import correlator as pcorr
from gnss_sim_receiver_tpu_torch.ops import prn_codes

RTOL = 1e-4
OVS = 8                 # table entries per chip (TrackingEngine)


def _conf(sig: str, fs: float) -> ptrk.TrackingConf:
    if sig == "gps":
        return ptrk.TrackingConf(fs=fs)
    chain = {"e1": prx.galileo_e1b_chain, "l5": prx.gps_l5_chain,
             "e5a": prx.galileo_e5a_chain}[sig]
    return chain(fs).trk


# (signal, fs) of every K1 and K2 launch in chip_smoke.py
SHAPES = [("gps", 2e6), ("gps", 4e6), ("gps", 20e6), ("e1", 4e6),
          ("e1", 20e6), ("l5", 20e6), ("e5a", 20e6)]


def _slab_edges(n: int, slabs: int) -> list[tuple[int, int]]:
    """[lo, hi) of each slab of n items as both kernels cut them: slab s
    starts at s * n // S (csrc/multicorrelator.cu, block_correlator.cu)."""
    return [(s * n // slabs, (s + 1) * n // slabs) for s in range(slabs)]


def _covers(edges, n):
    assert edges[0][0] == 0 and edges[-1][1] == n
    for (lo, hi), (lo2, _) in zip(edges, edges[1:] + [(n, n)]):
        assert lo < hi == lo2


@pytest.mark.parametrize("sig,fs", SHAPES)
@pytest.mark.parametrize("c", [8, 10, 12])
def test_k2_plan_covers_the_block(sig, fs, c):
    """Slabs tile [0, B) exactly once; short blocks run one CTA per
    channel; the staged span of a slab holds every index its samples
    read (or the whole table is staged), for code rates within +-10
    chip/s of nominal (Doppler), any code phase and the conf's taps
    (computed as the kernel does, in float32)."""
    conf = _conf(sig, fs)
    b, ovs = conf.block_size, float(OVS)
    table_len = conf.code_length_chips * OVS
    data = sig == "e1" and fs == 20e6          # phase 8's data form
    plan = pcorr.plan_k2(c, b, table_len, OVS, table_len if data else 0,
                         OVS)
    assert plan.slabs == 1 if b <= pcorr.K2_SMALL_BLOCK else plan.slabs > 1
    assert plan.stage + plan.data_stage <= pcorr.K2_MAX_STAGE
    assert plan.data_stage == (plan.stage if data else 0)
    edges = _slab_edges(b, plan.slabs)
    _covers(edges, b)
    d, dv = conf.early_late_space_chips, conf.very_early_late_space_chips
    taps = np.float32([dv, d / 2, 0.0, -d / 2, -dv])
    inv_fs = np.float32(1.0 / fs)
    for cf in (conf.code_rate_cps - 10.0, conf.code_rate_cps + 10.0):
        for rem in (0.0, 0.37, 0.999):
            for lo, hi in edges:
                n = np.float32([lo, hi - 1])
                chips = np.float32(rem) + np.float32(cf) * n * inv_fs
                raw = np.floor((chips[:, None] + taps[None]) * np.float32(ovs))
                # the kernel stages [min - 1, max + 1], or the whole table
                assert (raw.max() - raw.min() + 3 <= plan.stage
                        or plan.stage == table_len)


def test_k2_plan_raises_where_nothing_fits():
    for args in ((0, 2048, 8184, 8), (65536, 2048, 8184, 8),
                 (8, 0, 8184, 8), (8, 2048, 0, 8)):
        with pytest.raises(ValueError):
            pcorr.plan_k2(*args)


@pytest.mark.parametrize("sig,fs", SHAPES)
@pytest.mark.parametrize("c", [8, 10, 12, 48, 192])
def test_k1_plan_covers_the_bins(sig, fs, c):
    """Slabs tile [0, F) exactly once, none under K1_MIN_SLAB bins, at
    most K1_CTAS_PER_SM CTAs per SM in all; a 20 Msps shape fills that."""
    conf = _conf(sig, fs)
    nfft = ptb.block_fft_size(conf)
    e = 5 if sig == "e1" else 20
    s = ptb.plan_k1(c, e, nfft)
    edges = _slab_edges(nfft, s)
    _covers(edges, nfft)
    assert min(hi - lo for lo, hi in edges) >= min(ptb.K1_MIN_SLAB, nfft)
    slots = ptb.K1_CTAS_PER_SM * H100_SMS
    assert s * c <= max(slots, c)
    if fs == 20e6 and c <= 12:
        assert s * c > slots - c


def test_k1_plan_raises_where_nothing_fits():
    for args in ((0, 20, 4096), (65536, 20, 4096), (8, 0, 4096),
                 (8, 20, 1)):
        with pytest.raises(ValueError):
            ptb.plan_k1(*args)


@pytest.mark.parametrize("sms", [114, 132])
def test_plans_follow_the_card(sms):
    """Both planners aim at the SM count they are given (an H100 PCIe's
    114, an SXM's 132): at 20 Msps and C = 10 they fill, without passing,
    the card's CTA slots."""
    conf = _conf("gps", 20e6)
    s1 = ptb.plan_k1(10, 20, ptb.block_fft_size(conf), sms)
    assert 2 * sms - 10 < s1 * 10 <= 2 * sms
    s2 = pcorr.plan_k2(10, conf.block_size, conf.code_length_chips * OVS,
                       OVS, sms=sms).slabs
    assert 2 * sms - 10 < s2 * 10 <= 2 * sms


# ---- the slab-then-ordered sums ------------------------------------------

def _k2_case(sig: str, fs: float, c: int, data: bool, seed: int):
    """Numpy inputs of one K2 launch: a capture, the channels' band-limited
    tables (and data tables), the taps and a channel state."""
    rng = np.random.default_rng(seed)
    conf = _conf(sig, fs)
    b, s0 = conf.block_size, conf.nominal_epoch_samples
    n = 3 * b
    prov = (prn_codes.gps_l1_ca_code if sig == "gps"
            else signals.CodeProvider("1B", "C" if data else "B"))

    def tables(p):
        return np.stack([prn_codes.bandlimited_table_normalized(
            p(prn), fs, conf.code_rate_cps, s0, OVS)
            for prn in range(1, c + 1)])
    d, dv = conf.early_late_space_chips, conf.very_early_late_space_chips
    taps = [dv, d / 2, 0.0, -d / 2, -dv] if dv > 0 else [d / 2, 0.0, -d / 2]
    return dict(
        x=(rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64),
        pos=rng.integers(-50, n - b + 50, c).astype(np.int32), b=b,
        codes=tables(prov).astype(np.float32),
        data=tables(signals.CodeProvider("1B")).astype(np.float32)
        if data else None,
        taps=np.float32(taps),
        nco=[rng.uniform(0, 1, c).astype(np.float32),
             (conf.code_rate_cps + rng.uniform(-5, 5, c)).astype(np.float32),
             rng.uniform(0, 2 * np.pi, c).astype(np.float32),
             rng.uniform(-5000, 5000, c).astype(np.float32),
             rng.integers(s0 - 1, s0 + 2, c).astype(np.int32)],
        fs=fs)


def _k2_plain(k, blocks):
    """The plain version's [C, K(+1)] on gathered `blocks`."""
    t = torch.from_numpy
    nco = [t(v) for v in k["nco"]] + [k["fs"]]
    out = pcorr.correlate_multitap(blocks, t(k["codes"]), t(k["taps"]), *nco,
                                   OVS)
    if k["data"] is None:
        return out
    return torch.cat([out, pcorr.correlate_multitap(
        blocks, t(k["data"]), torch.zeros(1), *nco, OVS)], 1)


@pytest.mark.parametrize("sig,fs,data", [("gps", 20e6, False),
                                         ("e1", 4e6, True)])
def test_k2_slab_order_sum_matches_plain_and_jax(sig, fs, data):
    c = 3
    k = _k2_case(sig, fs, c, data, seed=11)
    b = k["b"]
    blocks = pcorr.gather_blocks(torch.from_numpy(k["x"]),
                                 torch.from_numpy(k["pos"]), b)
    plan = pcorr.plan_k2(c, b, k["codes"].shape[1], OVS,
                         0 if k["data"] is None else k["data"].shape[1], OVS)
    assert plan.slabs > 1
    acc = torch.zeros((c, len(k["taps"]) + data), dtype=torch.complex64)
    for lo, hi in _slab_edges(b, plan.slabs):
        keep = torch.zeros(b, dtype=torch.complex64)
        keep[lo:hi] = 1.0
        acc = acc + _k2_plain(k, blocks * keep)       # one CTA's partial
    plain = _k2_plain(k, blocks).numpy()
    # the JAX package's gather_blocks + correlate_multitap (and the second
    # correlate_multitap of a track_pilot chain on the data tables)
    jb = jcorr.gather_blocks(jnp.asarray(k["x"]), jnp.asarray(k["pos"]), b)
    nco = [jnp.asarray(v) for v in k["nco"]] + [k["fs"]]
    want = [np.asarray(jcorr.correlate_multitap(
        jb, jnp.asarray(k["codes"]), jnp.asarray(k["taps"]), *nco,
        table_oversample=OVS))]
    if data:
        want.append(np.asarray(jcorr.correlate_multitap(
            jb, jnp.asarray(k["data"]), jnp.zeros(1, jnp.float32), *nco,
            table_oversample=OVS)))
    want = np.concatenate(want, 1)
    scale = np.abs(plain).max()
    assert np.abs(acc.numpy() - plain).max() <= RTOL * scale
    assert np.abs(acc.numpy() - want).max() <= RTOL * scale
    assert np.abs(plain - want).max() <= RTOL * scale


def _k1_case(c: int, seed: int, w0=None):
    """Numpy inputs of one K1 launch at Galileo E1's 4 Msps block shape
    (E = 5, the 5 VEML taps, F = 32400), drawn as chip_smoke.py draws
    them."""
    rng = np.random.default_rng(seed)
    conf = _conf("e1", 4e6)
    fs, rate = conf.fs, conf.code_rate_cps
    s0, nfft, e = conf.nominal_epoch_samples, ptb.block_fft_size(conf), 5
    n = 12 * s0 + nfft
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64))
    xf_all = ptb._window_spectra(x, s0, nfft).numpy()
    n_wins = xf_all.shape[0]
    lag = rng.uniform(16.0, 16.0 + s0, (c, e)).astype(np.float32)
    lag_int = np.round(lag).astype(np.int32)
    d, dv = conf.early_late_space_chips, conf.very_early_late_space_chips
    taps = np.asarray([dv, d / 2, 0.0, -d / 2, -dv])
    w_max = 2 * np.pi * 5000.0 / fs
    return [xf_all,
            (rng.standard_normal((c, nfft)) + 1j * rng.standard_normal(
                (c, nfft))).astype(np.complex64),
            (rng.integers(0, n_wins - e, c) if w0 is None else np.asarray(w0)
             ).astype(np.int32),
            lag_int, (lag - lag_int).astype(np.float32),
            rng.uniform(0, 650, (c, e)).astype(np.float32),
            np.outer(rng.uniform(0.97, 0.99, c), -taps).astype(np.float32)
            * np.float32(fs / rate),
            rng.uniform(-w_max, w_max, c).astype(np.float32)]


def _jax_k1(xf_all, rf, w0, lag_int, lag_frac, ph_sc, tap_samps, omega):
    """The JAX block scan's K1 lines (gnss_sim_receiver_tpu/models/
    tracking_block.py:169-171, 227-232, 279-295), op by op."""
    n_wins, nfft = xf_all.shape
    c, e = lag_int.shape
    f_raw = jnp.arange(nfft, dtype=jnp.float32)
    f_bins = jnp.where(f_raw >= nfft // 2, f_raw - nfft, f_raw)
    two_pi = jnp.float32(2.0 * np.pi)
    w0 = jnp.clip(w0, 0, jnp.int32(max(n_wins - e, 0)))
    xf = jnp.stack([jax.lax.dynamic_slice(xf_all, (w0[i], 0), (e, nfft))
                    for i in range(c)])
    f_int = f_bins.astype(jnp.int32)
    prod_mod = jnp.mod(f_int[None, None, :] * lag_int[..., None],
                       jnp.int32(nfft)).astype(jnp.float32)
    ang_l = (two_pi * (prod_mod + f_bins[None, None, :] * lag_frac[..., None])
             / jnp.float32(nfft) - ph_sc[..., None])
    pl = jax.lax.complex(jnp.cos(ang_l), jnp.sin(ang_l))
    ang_t = (two_pi * f_bins[None, None, :] * tap_samps[..., None]
             / jnp.float32(nfft) - (omega[:, None] * tap_samps)[..., None])
    pt = jax.lax.complex(jnp.cos(ang_t), jnp.sin(ang_t))
    z = xf * rf[:, None, :] * pl
    return jnp.einsum("cef,ckf->cek", z, pt,
                      preferred_element_type=jnp.complex64) / jnp.float32(nfft)


def _run_jax_k1(args):
    with jax.disable_jit():
        return np.asarray(_jax_k1(*[jnp.asarray(a) for a in args]))


def test_k1_slab_order_sum_matches_plain_and_jax():
    c = 3
    args = _k1_case(c, seed=21)
    t = [torch.from_numpy(a) for a in args]
    nfft = args[0].shape[1]
    slabs = ptb.plan_k1(c, 5, nfft)
    assert slabs > 1
    acc = torch.zeros((c, 5, 5), dtype=torch.complex64)
    for lo, hi in _slab_edges(nfft, slabs):
        keep = torch.zeros(nfft, dtype=torch.complex64)
        keep[lo:hi] = 1.0
        acc = acc + ptb._block_correlate_plain(t[0], t[1] * keep, *t[2:])
    plain = ptb._block_correlate_plain(*t).numpy()
    want = _run_jax_k1(args)
    scale = np.abs(plain).max()
    assert np.abs(acc.numpy() - plain).max() <= RTOL * scale
    assert np.abs(acc.numpy() - want).max() <= RTOL * scale
    assert np.abs(plain - want).max() <= RTOL * scale


def test_k1_clamps_the_start_like_jax():
    """Starts below 0, past W - E, at W and at W - E: the plain version's
    rows are the JAX program's clipped dynamic slice (rows W - E .. W - 1,
    not a per-row clamp that would repeat row W - 1)."""
    n_wins, e = _k1_case(1, seed=31)[0].shape[0], 5
    args = _k1_case(4, seed=31, w0=[-2, n_wins - e + 3, n_wins, n_wins - e])
    got = ptb.block_correlate(*[torch.from_numpy(a) for a in args]).numpy()
    want = _run_jax_k1(args)
    assert np.abs(got - want).max() <= RTOL * np.abs(got).max()
