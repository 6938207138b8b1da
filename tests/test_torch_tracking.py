"""Parity of the PyTorch port's tracking with the JAX package on the CPU.

The same armed TrackState (carried across with the port's interop module)
and the same capture go through the JAX per-epoch scan / block scan and the
port's, whose kernels K2 (multicorrelator) and K1 (block correlator) run
their plain PyTorch versions on CPU tensors.

Tolerances: one epoch agrees to float32 rounding (the correlation sums run
in another order).  Through the loops that rounding flips the last bit of
the float32 code rate now and then (one ulp is 0.0625 chip/s at 1.023
Mchip/s), which walks the code phase by ~1e-4 sample per epoch until the
DLL pulls it back, and nudges the PLL by hundredths of a Hz.  The bounds
below sit a few times above what was measured and far below the JAX
package's own block-vs-per-epoch bounds (tests/test_tracking_block.py:
prompt median 1 %, max 5 %; positions 2 samples; code phase 0.1 sample).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb

FS = 2_000_000.0
CODE_RATE = 1.023e6
E_BLOCK = 20
PRNS = [5, 13, 27]
DOPS = [-2400.0, 0.0, 3100.0]
DELAYS = [587, 980, 1520]
T = 200


def _armed(conf, prns, dops, delay_samples):
    """The armed state of tests/test_tracking_block.py:_armed_state."""
    st = jtrk._init_state(len(prns))
    for ch in range(len(prns)):
        f0 = conf.code_rate_cps * (1.0 + dops[ch] / conf.carrier_freq_hz)
        st = jtrk._arm_channel(st, ch, float(dops[ch]), float(f0))
    pos = np.asarray(delay_samples, np.int64)
    phase0 = np.mod(2.0 * np.pi * np.asarray(dops) * pos / conf.fs,
                    2.0 * np.pi).astype(np.float32)
    return st._replace(pos=jnp.asarray(pos.astype(np.int32)),
                       rem_carr_phase=jnp.asarray(phase0))


def _tables(prns):
    return np.stack([jpc.bandlimited_table_normalized(
        jpc.gps_l1_ca_code(p), FS, CODE_RATE, 2000) for p in prns])


def _clean_scenario():
    """Three noise-free 50 dB-Hz satellites, armed on truth (the regime
    of tests/test_tracking_block.py)."""
    sats = [SatelliteSignalParams(prn=p, cn0_db_hz=50.0, doppler_hz=d,
                                  delay_chips=n * CODE_RATE / FS,
                                  nav_bits=np.ones(64, np.int8))
            for p, d, n in zip(PRNS, DOPS, DELAYS)]
    x = generate_baseband(sats, FS, max(DELAYS) + (T + 4) * 2000 + 4096,
                          noise=False)
    jconf = jtrk.TrackingConf(fs=FS, enable_fll_pullin=False)
    pconf = ptrk.TrackingConf(fs=FS, enable_fll_pullin=False)
    st = _armed(jconf, PRNS, DOPS, DELAYS)
    tables = _tables(PRNS)
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    return dict(x=x, jconf=jconf, pconf=pconf, jst=st,
                pst=interop.track_state_from_numpy(
                    interop.track_state_to_numpy(st), "cpu"),
                tables=tables, taps=taps)


@pytest.fixture(scope="module")
def clean():
    return _clean_scenario()


def _compare_outputs(oj, op, prompt_max, prompt_med, pos_tol, dop_tol,
                     boundary_tol, flip_share=0.02):
    pj = np.asarray(oj["prompt"])
    pp = op["prompt"].numpy()
    scale = np.abs(pj).mean()
    rel = np.abs(pp - pj) / scale
    assert rel.max() < prompt_max, rel.max()
    assert np.median(rel) < prompt_med, np.median(rel)
    ends = []
    for o in (oj, op):
        o = {k: np.asarray(v) for k, v in o.items()}
        assert o["pos_start"].dtype == np.int32
        end = o["pos_start"].astype(np.int64) + o["n_samples"]
        # the code boundary the observables read: sample counter at epoch
        # end minus the replica's code phase there (a one-sample rounding
        # flip of an epoch length moves both terms together)
        ends.append((end, end - o["code_phase_samples"].astype(np.float64)))
    d = np.abs(ends[0][0] - ends[1][0])
    assert d.max() <= pos_tol, d.max()
    assert np.mean(d > 0) < flip_share, np.mean(d > 0)
    d = np.abs(ends[0][1] - ends[1][1])
    assert d.max() < boundary_tol, d.max()
    d = np.abs(np.asarray(oj["carrier_doppler_hz"])
               - op["carrier_doppler_hz"].numpy())
    assert d.max() < dop_tol, d.max()
    assert np.array_equal(np.asarray(oj["valid"]), op["valid"].numpy())


def test_track_chunk_matches_jax(clean):
    """200 epochs of the per-epoch scan (kernel K2's plain version).
    Measured: prompt max 0.31 %, median 0.024 % of the mean prompt; 0.5 %
    of the epoch ends one sample apart (a length rounded the other way);
    Doppler within 0.045 Hz; code boundary within 0.01 sample."""
    c = clean
    sj, oj = jtrk.track_chunk(c["jconf"], T, jnp.asarray(c["tables"]),
                              jnp.asarray(c["taps"]), jnp.asarray(c["x"]),
                              c["jst"])
    sp, op = ptrk.track_chunk(c["pconf"], T, torch.from_numpy(c["tables"]),
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


def test_track_chunk_blocks_matches_jax(clean):
    """5 blocks of 20 epochs from the armed state (kernel K1's plain
    version).  Measured: prompt max 0.019 %, median 0.003 % of the mean
    prompt; sample bookkeeping identical; Doppler 0.0005 Hz; code phase
    0.008 sample."""
    c = clean
    rep = jtb.code_spectra(c["jconf"], c["tables"])
    prep = ptb.code_spectra(c["pconf"], c["tables"], "cpu")
    assert np.array_equal(np.asarray(rep), prep.numpy())
    sj, oj = jtb.track_chunk_blocks(c["jconf"], 5, E_BLOCK, rep,
                                    jnp.asarray(c["taps"]),
                                    jnp.asarray(c["x"]), c["jst"])
    sp, op = ptb.track_chunk_blocks(c["pconf"], 5, E_BLOCK, prep,
                                    torch.from_numpy(c["taps"]),
                                    torch.from_numpy(c["x"]), c["pst"])
    _compare_outputs(oj, op, prompt_max=0.002, prompt_med=0.0003,
                     pos_tol=0, dop_tol=0.01, boundary_tol=0.03)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "pos", "epoch", "lock_lost", "ext_n", "bit_synced"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["carrier_doppler"] - dp["carrier_doppler"]).max() < 0.01


# the one-block op-by-op cases beyond the 2 Msps `clean` scenario: the
# rates and code lengths of the hybrid (GPS L1 C/A at 20 Msps) and wideband
# (Galileo E5a-I, 10230 chips at 10.23 Mcps, 20 Msps) conf paths, where the
# int32 lag product f * lag_int of K1 passes 2^31
OP_CASES = {
    "gps_l1_2msps": None,
    "gps_l1_20msps": dict(signal="1C", prns=PRNS, dops=DOPS,
                          delays=[5870, 9800, 15200]),
    "galileo_e5a_20msps": dict(signal="5X", prns=[11, 19],
                               dops=[-1800.0, 2300.0], delays=[7001, 13456]),
}
FS_WIDE = 20_000_000.0


def _wide_scenario(signal, prns, dops, delays):
    """Noise-free 50 dB-Hz satellites at 20 Msps armed on truth, with the
    conf the path tracks them with: GPS L1 C/A under the `clean`
    scenario's conf, E5a-I under the wideband chain's (FLL pull-in on)."""
    if signal == "1C":
        jconf = jtrk.TrackingConf(fs=FS_WIDE, enable_fll_pullin=False)
        pconf = ptrk.TrackingConf(fs=FS_WIDE, enable_fll_pullin=False)
        codes = [jpc.gps_l1_ca_code(p) for p in prns]
        extra = {}
    else:
        jconf = jrx.galileo_e5a_chain(FS_WIDE).trk
        pconf = prx.galileo_e5a_chain(FS_WIDE).trk
        codes = [jsig.galileo_e5a_code(p, "I") for p in prns]
        extra = dict(system="Galileo", carrier_ref_hz=jconf.carrier_freq_hz)
    rate, s0 = jconf.code_rate_cps, jconf.nominal_epoch_samples
    sats = [SatelliteSignalParams(
        prn=p, signal=signal, cn0_db_hz=50.0, doppler_hz=d,
        code_doppler_hz=d if extra else None,
        delay_chips=n * rate / FS_WIDE, nav_bits=np.ones(64, np.int8),
        **extra) for p, d, n in zip(prns, dops, delays)]
    x = generate_baseband(sats, FS_WIDE, max(delays) + 24 * s0 + 4096,
                          noise=False)
    st = _armed(jconf, prns, dops, delays)
    tables = np.stack([jpc.bandlimited_table_normalized(c, FS_WIDE, rate, s0)
                       for c in codes])
    return dict(x=x, jconf=jconf, pconf=pconf, jst=st,
                pst=interop.track_state_from_numpy(
                    interop.track_state_to_numpy(st), "cpu"),
                tables=tables, taps=np.array([0.25, 0.0, -0.25], np.float32))


@pytest.mark.parametrize("case", list(OP_CASES))
def test_block_matches_jax_op_by_op(clean, case):
    """One block against the JAX program run op by op (jax.disable_jit):
    the port is that program's arithmetic, so the code NCO (code rate,
    code phase remnant, sample pointer) agrees bit for bit and the rest
    to float32 rounding, at 2 Msps and at the 20 Msps of the hybrid and
    wideband paths (there the int32 lag product wraps, in both packages
    alike).  The jitted JAX program differs from both by XLA's own float
    rewrites (multiply-add contraction, reciprocal multiplication): at
    block 1 the code phase of the zero-Doppler channel is 0 there and
    -1/512 chip here and op by op — the source of the meter-level
    pseudorange differences test_torch_receiver.py bounds.

    The DLL velocity is held to 1e-5 of itself; at 20 Msps also to 1e-7
    chip/s absolute, because there the channels armed on truth close E - L
    to ~1e-7 of |E| and the velocity (~1e-5 chip/s) carries the float32
    rounding of the two FFT and sin/cos libraries and of the contraction
    order magnified by that cancellation (measured: up to 2.1e-8 chip/s,
    1.5e-3 of itself); the code rate it feeds, bit-exact above, has an ulp
    of 0.0625 chip/s at 1.023 Mchip/s."""
    c = clean if OP_CASES[case] is None else _wide_scenario(**OP_CASES[case])
    rep = jtb.code_spectra(c["jconf"], c["tables"])
    with jax.disable_jit():
        sj, _ = jtb.track_chunk_blocks(c["jconf"], 1, E_BLOCK, rep,
                                       jnp.asarray(c["taps"]),
                                       jnp.asarray(c["x"]), c["jst"])
    sp, _ = ptb.track_chunk_blocks(
        c["pconf"], 1, E_BLOCK, ptb.code_spectra(c["pconf"], c["tables"],
                                                 "cpu"),
        torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]), c["pst"])
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("pos", "rem_code_phase", "code_freq", "epoch", "ext_n",
              "active"):
        assert np.array_equal(dj[k], dp[k]), (k, dj[k], dp[k])
    atol = 0.0 if OP_CASES[case] is None else 1e-7
    assert np.allclose(dj["dll.vel"], dp["dll.vel"], rtol=1e-5, atol=atol)
    assert np.abs(dj["carrier_doppler"] - dp["carrier_doppler"]).max() < 1e-3


def _unpack(buf, t, c, decim):
    """Split a packed decimated buffer (tracking.py:807-840 layout)."""
    raw = np.asarray(buf)
    td = len(range(decim - 1, t, decim))
    nw = (t * c + 3) // 4
    sym = raw[:nw].view(np.int8)[: t * c].reshape(t, c)
    f = raw[nw: nw + 4 * td * c].view(np.float32).reshape(4, td, c)
    rest = raw[nw + 4 * td * c:]
    return sym, f, rest[: td * c], rest[td * c: td * c + 3 * c], \
        rest[td * c + 3 * c:].view(np.float32)


def _compare_packed(bj, bp, t, c, decim):
    bp = bp.numpy()
    assert bj.dtype == np.int32 and bp.dtype == np.int32
    assert bj.shape == bp.shape
    sj, fj, scj, metaj, scalej = _unpack(bj, t, c, decim)
    sp, fp, scp, metap, scalep = _unpack(bp, t, c, decim)
    # int8 symbols: the same quantization; a value on a rounding edge may
    # land one step apart
    assert np.abs(sj.astype(int) - sp.astype(int)).max() <= 1
    # the signs are the bits telemetry reads
    assert np.array_equal(np.sign(sj), np.sign(sp))
    assert np.array_equal(sj == -128, sp == -128)
    assert np.allclose(fj[0], fp[0], atol=0.2)          # Doppler, Hz
    assert np.allclose(fj[1], fp[1], atol=1e-2)         # carrier cycles
    assert np.allclose(fj[2], fp[2], atol=0.03)         # code phase, samples
    assert np.array_equal(scj, scp)                     # sample counter
    assert np.array_equal(metaj, metap)                 # pos, active, lost
    assert np.allclose(scalej, scalep, rtol=1e-3)


@pytest.mark.parametrize("kind", ["per_epoch", "blocks"])
def test_packed_decim_buffers_match_jax(clean, kind):
    """The single int32 transfer of a chunk, byte layout and contents."""
    c = clean
    decim = 20
    if kind == "per_epoch":
        _, bj = jtrk.track_chunk_packed_decim(
            c["jconf"], T, decim, jnp.asarray(c["tables"]),
            jnp.asarray(c["taps"]), jnp.asarray(c["x"]), c["jst"])
        _, bp = ptrk.track_chunk_packed_decim(
            c["pconf"], T, decim, torch.from_numpy(c["tables"]),
            torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]), c["pst"])
        t = T
    else:
        rep = jtb.code_spectra(c["jconf"], c["tables"])
        _, bj = jtb.track_chunk_blocks_packed_decim(
            c["jconf"], 5, E_BLOCK, decim, rep, jnp.asarray(c["taps"]),
            jnp.asarray(c["x"]), c["jst"])
        _, bp = ptb.track_chunk_blocks_packed_decim(
            c["pconf"], 5, E_BLOCK, decim,
            ptb.code_spectra(c["pconf"], c["tables"], "cpu"),
            torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]), c["pst"])
        t = 5 * E_BLOCK
    _compare_packed(np.asarray(bj), bp, t, len(PRNS), decim)


def test_pack_decim_short_tail():
    """A tail chunk shorter than one tick stride packs symbols and state
    only (no observable rows), as the JAX layout does."""
    t, c = 7, 2
    outs = {"prompt": torch.complex(torch.linspace(-3, 3, t * c).reshape(t, c),
                                    torch.zeros(t, c)),
            "valid": torch.ones(t, c, dtype=torch.bool),
            "pos_start": torch.zeros(t, c, dtype=torch.int32),
            "n_samples": torch.full((t, c), 2000, dtype=torch.int32)}
    for k in ptrk._DECIM_F32:
        outs[k] = torch.zeros(t, c)
    st = ptrk._init_state(c, "cpu")
    buf = ptrk.pack_decim(outs, st, t, 20).numpy()
    sym, f, sc, meta, scale = _unpack(buf, t, c, 20)
    assert f.shape == (4, 0, c) and sc.size == 0 and meta.size == 3 * c
    assert sym.max() == 126 and sym.min() == -126
    assert np.allclose(scale, 3.0 / 126.0)


def test_block_pullin_from_acquisition_errors_matches_jax():
    """FLL pull-in in block mode from acquisition-grade errors (+125 Hz,
    2 samples late, random nav bits, 42 dB-Hz with noise): the port meets
    the JAX test's own assertions (test_tracking_block.py:187-221) and
    ends within 1 Hz of the JAX loop (measured: 0.01 Hz)."""
    prn, dop_true, delay_n = 21, 1700.0, 700
    rng = np.random.default_rng(7)
    bits = np.where(rng.random(128) < 0.5, 1, -1).astype(np.int8)
    sats = [SatelliteSignalParams(prn=prn, cn0_db_hz=42.0,
                                  doppler_hz=dop_true,
                                  delay_chips=delay_n * CODE_RATE / FS,
                                  nav_bits=bits)]
    n_blocks = 120
    x = generate_baseband(sats, FS, delay_n + (n_blocks * E_BLOCK + 8) * 2000
                          + 4096, noise=True, seed=11)
    jconf = jtrk.TrackingConf(fs=FS)
    pconf = ptrk.TrackingConf(fs=FS)
    st = _armed(jconf, [prn], [dop_true - 125.0], [delay_n])
    st = st._replace(pos=st.pos + 2)
    tables = _tables([prn])
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    sj, _ = jtb.track_chunk_blocks(jconf, n_blocks, E_BLOCK,
                                   jtb.code_spectra(jconf, tables),
                                   jnp.asarray(taps), jnp.asarray(x), st)
    sp, op = ptb.track_chunk_blocks(
        pconf, n_blocks, E_BLOCK, ptb.code_spectra(pconf, tables, "cpu"),
        torch.from_numpy(taps), torch.from_numpy(x),
        interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                       "cpu"))
    assert bool(sp.active[0]) and not bool(sp.lock_lost[0])
    assert abs(float(sp.carrier_doppler[0]) - dop_true) < 5.0
    p = op["prompt"].numpy()[-200:, 0]
    assert np.abs(p.real).mean() > 2.5 * np.abs(p.imag).mean()
    assert float(sp.cn0_db_hz[0]) > 38.0
    assert abs(float(sp.carrier_doppler[0])
               - float(np.asarray(sj.carrier_doppler)[0])) < 1.0
