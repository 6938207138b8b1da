"""The PyTorch port's Galileo E1-B pieces against the JAX package on the CPU.

The same NumPy inputs go through both packages: the E1 code tables, the
I/NAV page encoder and decoder (K=7 Viterbi, deinterleaver, CRC-24Q), the
Galileo ephemeris words, the E1-B telemetry decoder, the E1-B/E1-C
simulator, the VEMLP discriminator and the 5-tap VEML tracking of the
per-epoch scan (kernel K2's plain version) and of the block scan (kernel
K1's plain version, which closes E - L on taps 1 and 3 as the JAX block
closure does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.nav import ephemeris as jeph
from gnss_sim_receiver_tpu.nav import inav as jinav
from gnss_sim_receiver_tpu.ops import discriminators as jdisc
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch import signals as psig
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e1b_chain
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from gnss_sim_receiver_tpu_torch.nav import inav as pinav
from gnss_sim_receiver_tpu_torch.ops import discriminators as pdisc
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen

FS = 4_000_000.0
SC_RATE = 2.046e6
S0 = 16000                   # samples per 4 ms E1 epoch at 4 Msps


def _gal_eph(mod, prn=12):
    """A Galileo ephemeris of the hybrid scenario's kind (the sky
    constellation recast, tests/test_hybrid_position.py:33-43)."""
    base = mod.make_sky_constellation(40.0, -75.0, toe=345600.0 + 600)
    return dataclasses.replace(base[5], system="Galileo", prn=prn,
                               toe=346200.0, toc=346200.0, iod_nav=137,
                               bgd_e1e5b=-2.3e-9, bgd_e1e5a=1.4e-9)


# ---- signals and codes -----------------------------------------------------

@pytest.mark.parametrize("component", ["B", "C"])
def test_e1_codes_equal_jax(component):
    for prn in range(1, 37):
        assert np.array_equal(psig.galileo_e1_code(prn, component),
                              jsig.galileo_e1_code(prn, component)), prn
    assert psig.galileo_e1_code(1, component).dtype == np.float32


def test_e1_tables_and_definitions_equal_jax():
    assert np.array_equal(psig.e1c_secondary_code(),
                          jsig.e1c_secondary_code())
    for prn in (1, 11, 36):
        assert np.array_equal(psig.subchip_table(psig.GALILEO_E1B, prn),
                              jsig.subchip_table(jsig.GALILEO_E1B, prn))
        assert np.array_equal(psig.subchip_table(psig.GPS_L1CA, prn),
                              jsig.subchip_table(jsig.GPS_L1CA, prn))
        assert np.array_equal(psig.CodeProvider("1B", "C")(prn),
                              jsig.boc11_expand(jsig.galileo_e1_code(prn,
                                                                     "C")))
    for name in ("sc_rate", "sc_length", "code_period_s", "carrier_freq_hz",
                 "symbol_rate_sps"):
        assert getattr(psig.GALILEO_E1B, name) == \
            getattr(jsig.GALILEO_E1B, name)


# ---- I/NAV -----------------------------------------------------------------

def test_inav_pages_encode_equal_jax():
    """The simulator side: the same ephemeris gives the same symbol
    stream, word by word and CRC included."""
    pe, je = _gal_eph(peph), _gal_eph(jeph)
    for wt, fields in peph.galileo_ephemeris_to_words(pe).items():
        assert fields == jeph.galileo_ephemeris_to_words(je)[wt]
        assert np.array_equal(pinav.pack_word(wt, fields),
                              jinav.pack_word(wt, fields))
    got = pinav.pages_for_ephemeris(pe, t0_gst_s=345600.0, n_repeats=2)
    want = jinav.pages_for_ephemeris(je, t0_gst_s=345600.0, n_repeats=2)
    assert got.shape == (10 * 500,) and np.array_equal(got, want)
    bits = np.random.default_rng(0).integers(0, 2, 196)
    assert pinav.crc24q(bits) == jinav.crc24q(bits)


def test_viterbi_matches_the_jax_decoder():
    """The port's NumPy Viterbi against the JAX package's native one on
    noisy coded parts, bit for bit."""
    from gnss_sim_receiver_tpu import native
    rng = np.random.default_rng(3)
    for _ in range(20):
        bits = rng.integers(0, 2, 114)
        coded = jinav.conv27_encode(np.concatenate([bits, np.zeros(6, int)]),
                                    invert_g2=False)
        soft = ((2.0 * coded - 1.0)
                + rng.normal(0.0, 0.8, coded.shape)).astype(np.float32)
        got = pinav.viterbi27_decode(soft)
        assert np.array_equal(got, native.viterbi27_decode(soft))
    assert np.array_equal(pinav.viterbi27_decode(2.0 * coded - 1.0)[:114],
                          bits)


def _soft_stream(symbols01, rng, sigma, invert):
    s = (2.0 * symbols01 - 1.0) * (-1.0 if invert else 1.0)
    return s + rng.normal(0.0, sigma, s.shape)


@pytest.mark.parametrize("invert", [False, True])
def test_inav_decoder_words_equal_jax(invert):
    """Both page decoders on the same noisy (and, with `invert`, 180-degree
    flipped) soft symbols emit the same words, page starts and CRC
    verdicts, and the words rebuild the same ephemeris."""
    stream = jinav.pages_for_ephemeris(_gal_eph(jeph), 345600.0, n_repeats=2)
    soft = _soft_stream(stream, np.random.default_rng(5), 0.7, invert)
    soft = np.concatenate([np.random.default_rng(6).normal(0, 1, 37), soft])
    jd, pd = jinav.InavPageDecoder(), pinav.InavPageDecoder()
    jev, pev = [], []
    for part in np.array_split(soft, 7):          # chunked pushes
        jev += jd.push_symbols(part)
        pev += pd.push_symbols(part)
    assert len(pev) == len(jev) >= 6
    assert [dataclasses.astuple(e) for e in pev] == \
        [dataclasses.astuple(e) for e in jev]
    words = {e.word_type: e.fields for e in pev if e.crc_ok}
    assert set(words) >= {1, 2, 3, 4, 5}
    got = peph.words_to_galileo_ephemeris(12, words)
    want = jeph.words_to_galileo_ephemeris(12, words)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.system == "Galileo" and got.iod_nav == 137


def test_galileo_sat_states_equal_jax():
    """Mixed GPS + Galileo ephemerides (each system's GM) through the batch
    propagator and the scalar one."""
    ephs_p = [peph.make_sky_constellation(40.0, -75.0, 346200.0)[0],
              _gal_eph(peph)]
    ephs_j = [jeph.make_sky_constellation(40.0, -75.0, 346200.0)[0],
              _gal_eph(jeph)]
    t = np.array([345610.0, 345611.5])
    for a, b in zip(peph.sat_states_batch(ephs_p, t),
                    jeph.sat_states_batch(ephs_j, t)):
        assert np.array_equal(a, b)
    for ep, ej in zip(ephs_p, ephs_j):
        for a, b in zip(ep.sat_pos_clock(t), ej.sat_pos_clock(t)):
            assert np.array_equal(a, b)


def test_e1b_telemetry_decoder_equal_jax():
    """GalileoE1bTelemetryDecoder on the same 4 ms-epoch prompt stream (one
    I/NAV symbol per epoch, noisy, an unsynchronized lead-in, a masked
    epoch range), fed in chunks: the same TOW stamps and ephemerides."""
    rng = np.random.default_rng(9)
    stream = jinav.pages_for_ephemeris(_gal_eph(jeph), 345600.0, n_repeats=2)
    lead = 113
    t = lead + len(stream)
    prompt = np.zeros((t, 2), np.complex64)
    prompt[lead:, 0] = _soft_stream(stream, rng, 0.5, False) * 900.0
    prompt[lead:, 1] = _soft_stream(stream, rng, 0.5, True) * 700.0
    prompt[:lead] = rng.normal(0, 300, (lead, 2))
    valid = np.ones((t, 2), bool)
    valid[:lead - 20, 1] = False
    jd = jtlm.GalileoE1bTelemetryDecoder([12, 12])
    pd = ptlm.GalileoE1bTelemetryDecoder([12, 12])
    n_eph = 0
    for sl in np.array_split(np.arange(t), 5):
        outs = {"prompt": prompt[sl], "valid": valid[sl]}
        rj, rp = jd.process(outs), pd.process(outs)
        assert np.array_equal(rj.tow_valid, rp.tow_valid)
        assert np.array_equal(rj.tow_at_epoch_ms[rj.tow_valid],
                              rp.tow_at_epoch_ms[rp.tow_valid])
        assert [(c, dataclasses.asdict(e)) for c, e in rp.new_ephemerides] \
            == [(c, dataclasses.asdict(e)) for c, e in rj.new_ephemerides]
        n_eph += len(rp.new_ephemerides)
    assert n_eph == 2 and rp.tow_valid[-1].all()


def test_e1_simulator_equal_jax():
    """E1-B data and E1-C pilot synthesis, band-limited, sample for
    sample."""
    def sats(cls):
        return [cls(prn=11, system="Galileo", signal="1B", cn0_db_hz=45.0,
                    doppler_hz=900.0, delay_chips=1234.5,
                    nav_bits=np.array([1, -1, -1, 1] * 5, np.int8)),
                cls(prn=11, system="Galileo", signal="1P", cn0_db_hz=45.0,
                    doppler_hz=900.0, delay_chips=1234.5,
                    nav_bits=-np.ones(20, np.int8))]
    got = pgen(sats(PSat), FS, 40000, noise=True, seed=9,
               bandlimit_oversample=4)
    want = jgen(sats(JSat), FS, 40000, noise=True, seed=9,
                bandlimit_oversample=4)
    assert np.array_equal(got, want)


# ---- discriminators --------------------------------------------------------

def test_vemlp_and_decision_fll_discriminators_match_jax():
    rng = np.random.default_rng(2)
    ve, e, l, vl = (np.abs(rng.normal(0, 1, 200)).astype(np.float32)
                    for _ in range(4))
    ve[:3] = e[:3] = l[:3] = vl[:3] = 0.0           # the denom == 0 branch
    got = pdisc.dll_nc_vemlp_normalized(*map(torch.from_numpy,
                                             (ve, e, l, vl)), 1.2).numpy()
    want = np.asarray(jdisc.dll_nc_vemlp_normalized(ve, e, l, vl, 1.2))
    assert np.abs(got - want).max() < 1e-6
    a, b = (rng.normal(0, 1, (2, 200)).astype(np.float32) for _ in range(2))
    pa = (a[0] + 1j * a[1]).astype(np.complex64)
    pb = (b[0] + 1j * b[1]).astype(np.complex64)
    got = pdisc.fll_cross_dot_decision(torch.from_numpy(pa),
                                       torch.from_numpy(pb),
                                       torch.tensor(0.004)).numpy()
    want = np.asarray(jdisc.fll_cross_dot_decision(pa, pb,
                                                   np.float32(0.004)))
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()


# ---- 5-tap VEML tracking ---------------------------------------------------

PRNS = [11, 14]
DOPS = [1625.0, -2125.0]
DELAYS = [5021, 11790]


def _e1_kw():
    chain = galileo_e1b_chain(FS, very_early_late_space_chips=1.2,
                              pll_bw_hz=15.0)
    return {f.name: getattr(chain.trk, f.name)
            for f in dataclasses.fields(chain.trk)}


def _e1_scenario():
    """Two noise-free 48 dB-Hz E1-B satellites with random symbols, armed
    on truth (the regime of tests/test_torch_tracking.py); the conf of the
    factory's E1 chain (5 VEML taps, 0.6 chips very-early-late,
    decision-directed FLL pull-in)."""
    rng = np.random.default_rng(4)
    sats = [JSat(prn=p, system="Galileo", signal="1B", cn0_db_hz=48.0,
                 doppler_hz=d, delay_chips=n * 1.023e6 / FS,
                 nav_bits=np.where(rng.random(80) < 0.5, 1, -1
                                   ).astype(np.int8))
            for p, d, n in zip(PRNS, DOPS, DELAYS)]
    x = jgen(sats, FS, max(DELAYS) + 64 * S0, noise=False)
    kw = _e1_kw()
    jconf, pconf = jtrk.TrackingConf(**kw), ptrk.TrackingConf(**kw)
    st = jtrk._init_state(len(PRNS))
    for ch, d in enumerate(DOPS):
        st = jtrk._arm_channel(st, ch, d, SC_RATE * (1.0 + d / 1575.42e6))
    pos = np.asarray(DELAYS, np.int64)
    st = st._replace(
        pos=jnp.asarray(pos.astype(np.int32)),
        rem_carr_phase=jnp.asarray(np.mod(
            2.0 * np.pi * np.asarray(DOPS) * pos / FS, 2.0 * np.pi
        ).astype(np.float32)))
    tables = np.stack([jpc.bandlimited_table_normalized(
        jsig.subchip_table(jsig.GALILEO_E1B, p), FS, SC_RATE, S0)
        for p in PRNS])
    d, dv = kw["early_late_space_chips"], kw["very_early_late_space_chips"]
    taps = np.array([dv, d / 2, 0.0, -d / 2, -dv], np.float32)
    return dict(x=x, jconf=jconf, pconf=pconf, jst=st, tables=tables,
                taps=taps, pst=interop.track_state_from_numpy(
                    interop.track_state_to_numpy(st), "cpu"))


@pytest.fixture(scope="module")
def e1_clean():
    return _e1_scenario()


def test_e1_engine_tables_and_taps_equal_jax(e1_clean):
    """The port's engine builds the JAX engine's 8184 x 8 band-limited
    tables and 5-tap list from the same conf and code provider."""
    c = e1_clean
    pe = ptrk.TrackingEngine(c["pconf"], PRNS,
                             code_provider=psig.CodeProvider("1B"),
                             device="cpu")
    je = jtrk.TrackingEngine(
        c["jconf"], PRNS,
        code_provider=lambda p: jsig.subchip_table(jsig.GALILEO_E1B, p))
    assert pe.codes.shape == (2, 8184 * 8)
    assert np.array_equal(pe.codes.numpy(), np.asarray(je.codes))
    assert np.array_equal(pe.codes.numpy(), c["tables"])
    assert np.array_equal(pe.taps.numpy(), np.asarray(je.taps))
    assert np.array_equal(pe.taps.numpy(), c["taps"])
    assert pe.block_epochs == je.block_epochs == 5
    assert pe._read_margin() == je._read_margin()


def _ends(o):
    o = {k: np.asarray(v) for k, v in o.items()}
    end = o["pos_start"].astype(np.int64) + o["n_samples"]
    return end, end - o["code_phase_samples"].astype(np.float64)


def _compare(oj, op, prompt_max, pos_tol, dop_tol, boundary_tol):
    pj, pp = np.asarray(oj["prompt"]), op["prompt"].numpy()
    rel = np.abs(pp - pj) / np.abs(pj).mean()
    assert rel.max() < prompt_max, rel.max()
    (ej, bj), (ep, bp) = _ends(oj), _ends(op)
    assert np.abs(ej - ep).max() <= pos_tol
    assert np.abs(bj - bp).max() < boundary_tol, np.abs(bj - bp).max()
    d = np.abs(np.asarray(oj["carrier_doppler_hz"])
               - op["carrier_doppler_hz"].numpy())
    assert d.max() < dop_tol, d.max()
    assert np.array_equal(np.asarray(oj["valid"]), op["valid"].numpy())


def test_e1_track_chunk_5_taps_matches_jax(e1_clean):
    """60 epochs (240 ms) of the per-epoch scan with the VEMLP
    discriminator.  Measured against the jitted JAX scan: prompt max
    0.91 %, median 0.46 % of the mean prompt; 1.7 % of the epoch ends one
    sample apart; code boundary 0.036 sample; Doppler 0.036 Hz; DLL state
    0.015 sub-chip/s.  The code rate differs by one float32 ulp (0.125
    sub-chip/s at 2.046 Msub-chip/s, twice GPS's) where XLA rewrites the
    arithmetic; op by op it is bit-exact (the test below)."""
    c = e1_clean
    sj, oj = jtrk.track_chunk(c["jconf"], 60, jnp.asarray(c["tables"]),
                              jnp.asarray(c["taps"]), jnp.asarray(c["x"]),
                              c["jst"])
    sp, op = ptrk.track_chunk(c["pconf"], 60, torch.from_numpy(c["tables"]),
                              torch.from_numpy(c["taps"]),
                              torch.from_numpy(c["x"]), c["pst"])
    _compare(oj, op, prompt_max=0.03, pos_tol=1, dop_tol=0.2,
             boundary_tol=0.1)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost", "pos"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["dll.vel"] - dp["dll.vel"]).max() < 0.1


def test_e1_track_chunk_blocks_5_taps_matches_jax(e1_clean):
    """10 blocks of 5 epochs of the block scan: 5 taps through K1's plain
    version, the closure on taps 1 and 3 (E - L) as in the JAX program.
    Measured: prompt max 0.12 %, median 0.01 %; 1 % of the epoch ends one
    sample apart, the chunk's end state identical; code boundary 0.016
    sample; Doppler 0.009 Hz."""
    c = e1_clean
    rep = jtb.code_spectra(c["jconf"], c["tables"])
    prep = ptb.code_spectra(c["pconf"], c["tables"], "cpu")
    assert prep.shape == (2, ptb.block_fft_size(c["pconf"])) == (2, 32400)
    assert np.array_equal(np.asarray(rep), prep.numpy())
    sj, oj = jtb.track_chunk_blocks(c["jconf"], 10, 5, rep,
                                    jnp.asarray(c["taps"]),
                                    jnp.asarray(c["x"]), c["jst"])
    sp, op = ptb.track_chunk_blocks(c["pconf"], 10, 5, prep,
                                    torch.from_numpy(c["taps"]),
                                    torch.from_numpy(c["x"]), c["pst"])
    _compare(oj, op, prompt_max=0.005, pos_tol=1, dop_tol=0.05,
             boundary_tol=0.05)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "pos", "epoch", "lock_lost", "ext_n"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["carrier_doppler"] - dp["carrier_doppler"]).max() < 0.01


@pytest.mark.parametrize("kind", ["per_epoch", "blocks"])
def test_e1_5_taps_match_jax_op_by_op(e1_clean, kind):
    """5 epochs / 2 blocks against the JAX programs run op by op
    (jax.disable_jit): the code and carrier NCOs agree bit for bit, 5 taps
    and VEMLP or E - L closure included."""
    c = e1_clean
    taps, x = jnp.asarray(c["taps"]), jnp.asarray(c["x"])
    with jax.disable_jit():
        if kind == "per_epoch":
            sj, _ = jtrk.track_chunk(c["jconf"], 5, jnp.asarray(c["tables"]),
                                     taps, x, c["jst"])
        else:
            sj, _ = jtb.track_chunk_blocks(
                c["jconf"], 2, 5, jtb.code_spectra(c["jconf"], c["tables"]),
                taps, x, c["jst"])
    if kind == "per_epoch":
        sp, _ = ptrk.track_chunk(c["pconf"], 5, torch.from_numpy(c["tables"]),
                                 torch.from_numpy(c["taps"]),
                                 torch.from_numpy(c["x"]), c["pst"])
    else:
        sp, _ = ptb.track_chunk_blocks(
            c["pconf"], 2, 5,
            ptb.code_spectra(c["pconf"], c["tables"], "cpu"),
            torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]), c["pst"])
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("pos", "rem_code_phase", "code_freq", "carrier_doppler",
              "rem_carr_phase", "epoch", "active"):
        assert np.array_equal(dj[k], dp[k]), (k, dj[k], dp[k])
    assert np.allclose(dj["dll.vel"], dp["dll.vel"], rtol=1e-5, atol=1e-7)
