"""The GLONASS L1 and L2 C/A chains of the PyTorch port against the JAX
package on the CPU, at small sizes (inputs from a seed with NumPy;
tolerances stated per test):

- the 511-chip C/A code, the FDMA constants, the SignalDefs and the
  engines' sub-chip tables, bit for bit;
- nav/gnav.py: the KX Hamming code with one flipped bit, the strings packed
  and unpacked, the ephemeris <-> strings converters, the symbol stream,
  the RK4 states at tb +- 900 s and GnavStringDecoder at an offset and
  inverted, event for event;
- GlonassTelemetryDecoder with a day base on noisy soft prompts in odd
  chunk sizes;
- the host simulator and K6's plain version at slots -7 and +6;
- the cold search centred on slot -7's offset; 300 per-epoch epochs at
  slots -7 and +6 and a block chunk at slot -7, the FDMA bias taken off
  the code rate in both packages;
- both chain builders and the factory's per-slot chains through interop;
- a fix over GLONASS ephemerides raises the same error in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import factory as jfactory
from gnss_sim_receiver_tpu.models import pvt as jpvt
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.models.observables import \
    ObservationEpoch as JObs
from gnss_sim_receiver_tpu.nav import gnav as jgnav
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.ops import prn_codes_multi as jpcm
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JConfig
from gnss_sim_receiver_tpu_torch import constants, interop, signals
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import factory
from gnss_sim_receiver_tpu_torch.models import pvt as ppvt
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.models.observables import \
    ObservationEpoch as PObs
from gnss_sim_receiver_tpu_torch.nav import gnav as pgnav
from gnss_sim_receiver_tpu_torch.ops import prn_codes_multi as ppcm
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
from tests.test_torch_device_generator import _assert_agrees
from tests.test_torch_fnav_cnav import _run_decoders, _same_eph
from tests.test_torch_tracking import _compare_outputs

F_L1, DF_L1 = 1602.0e6, 0.5625e6
F_L2, DF_L2 = 1246.0e6, 0.4375e6
FS = 10_000_000.0                 # slot -7 at -3.94 MHz +- 0.511 MHz
T0 = 345600.0                     # a frame start (a multiple of 30 s)
DAY = 4 * 86400.0                 # T0's day


def _eph(cls, slot=10, k=-7):
    """tests/test_gnav.py's circular orbit state at tb (PZ-90)."""
    r = 25_508_000.0
    v = np.sqrt(jgnav._GM / r)
    return cls(prn=slot, freq_slot=k, tb_s=T0 + 900.0,
               pos_m=(r * 0.6, r * 0.64, r * 0.48),
               vel_ms=(-v * 0.5, v * 0.1, v * 0.49),
               acc_ms2=(1.9e-9, -2.4e-9, 0.9e-9),
               tau_n=-4.7e-5, gamma_n=1.8e-12)


def _sat(cls, signal: str, k: int, phys: float, delay: float,
         n_sym: int = 60, seed: int = 3, cn0: float = 48.0, prn: int = 10):
    """One GLONASS satellite on slot k: the slot offset in the carrier
    Doppler, the physical Doppler alone in the code (on the slot's own
    carrier), random 100-sps meander-half symbols."""
    f0, df = (F_L1, DF_L1) if signal == "1G" else (F_L2, DF_L2)
    rng = np.random.default_rng(seed)
    return cls(prn=prn, system="GLONASS", signal=signal, cn0_db_hz=cn0,
               doppler_hz=k * df + phys, code_doppler_hz=phys,
               carrier_ref_hz=f0 + k * df, delay_chips=delay,
               nav_bits=(rng.integers(0, 2, n_sym) * 2 - 1).astype(np.int8))


# ---- codes -----------------------------------------------------------------

def test_codes_and_tables_equal_jax():
    """The C/A code bit for bit (one cached array), the SignalDefs, both
    signals' sub-chip tables for every PRN, the FDMA constants and the
    PRN -> slot table."""
    assert np.array_equal(ppcm.glonass_l1_ca_code(),
                          jpcm.glonass_l1_ca_code())
    assert ppcm.glonass_l1_ca_code() is ppcm.glonass_l1_ca_code()
    for name in ("GLONASS_L1_CA", "GLONASS_L2_CA"):
        assert dataclasses.astuple(getattr(signals, name)) == \
            dataclasses.astuple(getattr(jsig, name))
        for prn in range(1, 25):
            assert np.array_equal(
                signals.subchip_table(getattr(signals, name), prn),
                jsig.subchip_table(getattr(jsig, name), prn))
    for name in ("GLONASS_L1_FREQ_HZ", "GLONASS_L1_DFREQ_HZ",
                 "GLONASS_L2_FREQ_HZ", "GLONASS_L2_DFREQ_HZ",
                 "GLONASS_CA_CODE_RATE_CPS", "GLONASS_CA_CODE_LENGTH_CHIPS",
                 "GLONASS_PRN_SLOT"):
        assert getattr(constants, name) == getattr(jconst, name), name
    assert signals.SIGNALS["1G"] is signals.GLONASS_L1_CA
    assert signals.SIGNALS["2G"] is signals.GLONASS_L2_CA


# ---- nav/gnav.py -----------------------------------------------------------

def test_kx_and_strings_like_jax():
    """kx_encode on random data, kx_check with each single bit flipped (both
    refuse), every string packed and unpacked, the string symbols."""
    rng = np.random.default_rng(0)
    for _ in range(10):
        data = rng.integers(0, 2, 76)
        s = pgnav.kx_encode(data)
        assert np.array_equal(s, jgnav.kx_encode(data))
        assert pgnav.kx_check(s) and jgnav.kx_check(s)
        bad = s.copy()
        bad[int(rng.integers(0, 85))] ^= 1
        assert not pgnav.kx_check(bad) and not jgnav.kx_check(bad)
    fields = pgnav.glonass_ephemeris_to_strings(_eph(pgnav.GlonassEphemeris))
    assert fields == jgnav.glonass_ephemeris_to_strings(
        _eph(jgnav.GlonassEphemeris))
    for sid, f in fields.items():
        bits = pgnav.pack_string(sid, f)
        assert np.array_equal(bits, jgnav.pack_string(sid, f))
        assert pgnav.unpack_string(bits) == jgnav.unpack_string(bits)
        assert np.array_equal(pgnav.encode_string_symbols(bits),
                              jgnav.encode_string_symbols(bits))
    assert pgnav.STRING_FIELDS == jgnav.STRING_FIELDS
    assert np.array_equal(pgnav.TIME_MARK, jgnav.TIME_MARK)


def test_ephemeris_strings_and_rk4_like_jax():
    """The strings -> ephemeris converter with a day base and a slot, the
    30 s frame stream, and the RK4 states (position, clock, velocity) at
    tb and tb +- 900 s: equal to JAX's to 1e-6 m, 1e-15 s, 1e-6 m/s."""
    ep, ej = _eph(pgnav.GlonassEphemeris), _eph(jgnav.GlonassEphemeris)
    strings = {sid: pgnav.unpack_string(pgnav.pack_string(sid, f))[2]
               for sid, f in pgnav.glonass_ephemeris_to_strings(ep).items()}
    got = pgnav.strings_to_glonass_ephemeris(10, strings, day_base_s=DAY,
                                             freq_slot=-7)
    want = jgnav.strings_to_glonass_ephemeris(10, strings, day_base_s=DAY,
                                              freq_slot=-7)
    _same_eph(want, got)
    assert got.tb_s == ep.tb_s and got.toe == ep.tb_s and got.tgd == 0.0
    assert np.array_equal(pgnav.strings_for_ephemeris(ep, T0, 2),
                          jgnav.strings_for_ephemeris(ej, T0, 2))
    with pytest.raises(ValueError):
        pgnav.strings_for_ephemeris(ep, T0 + 1.0)
    for dt in (-900.0, 0.0, 900.0):
        t = ep.tb_s + dt
        (pp, cp), (pj, cj) = ep.sat_pos_clock(t), ej.sat_pos_clock(t)
        assert np.abs(np.asarray(pp) - np.asarray(pj)).max() <= 1e-6
        assert abs(cp - cj) <= 1e-15
        assert np.abs(ep.sat_vel(t) - ej.sat_vel(t)).max() <= 1e-6
        # the decoded set propagates within the strings' quantization
        p2, c2 = got.sat_pos_clock(t)
        assert np.linalg.norm(np.asarray(p2) - np.asarray(pp)) < 3.0
        assert abs(c2 - cp) < 2e-9


def _events(evs):
    return [(e.string_id, e.fields, e.string_start_symbol, e.kx_ok)
            for e in evs]


@pytest.mark.parametrize("invert", [False, True])
def test_string_decoder_like_jax(invert):
    """GnavStringDecoder on two frames cut 113 symbols in, noisy, in random
    chunks (tests/test_gnav.py:test_string_stream_decode): the same events,
    string for string; strings 1-5 among them."""
    sym = pgnav.strings_for_ephemeris(_eph(pgnav.GlonassEphemeris), T0, 2)
    s = (2.0 * sym - 1.0).astype(np.float64)[113:]
    if invert:
        s = -s
    rng = np.random.default_rng(6)
    s = s + 0.3 * rng.standard_normal(len(s))
    chunks = rng.integers(50, 450, 40)
    out = []
    for dec in (pgnav.GnavStringDecoder(), jgnav.GnavStringDecoder()):
        evs, i = [], 0
        for n in chunks:
            evs.extend(dec.push_symbols(s[i:i + n]))
            i += n
        out.append(_events(evs))
    assert out[0] == out[1]
    ok = {e[0] for e in out[0] if e[3]}
    assert {1, 2, 3, 4, 5} <= ok


# ---- the telemetry decoder -------------------------------------------------

def test_telemetry_decoder_like_jax():
    """GlonassTelemetryDecoder in both packages (slot -7, a day base) on
    1 ms prompts of the GNAV stream (10 epochs a symbol), cut mid-symbol,
    noisy, in odd chunks: equal TOW stamps (NaN pattern included), each
    the epoch's end on the day's timescale to 1e-9 ms, and one ephemeris,
    equal field by field, its slot and tb on that day."""
    ep = _eph(pgnav.GlonassEphemeris)
    sym = pgnav.strings_for_ephemeris(ep, T0, 2)
    off = 37
    epochs = np.repeat(2.0 * sym - 1.0, 10)[off:]
    rng = np.random.default_rng(12)
    soft = 2.0 * epochs + 0.8 * rng.standard_normal(len(epochs))
    chunks = rng.integers(301, 2999, 40) | 1
    decs = (ptlm.GlonassTelemetryDecoder([10], freq_slots={10: -7},
                                         day_base_s=DAY),
            jtlm.GlonassTelemetryDecoder([10], freq_slots={10: -7},
                                         day_base_s=DAY))
    (tow_p, new_p), (tow_j, new_j) = _run_decoders(decs, soft, chunks)
    assert len(new_p) == len(new_j) == 1
    _same_eph(new_j[0][1], new_p[0][1])
    eph = new_p[0][1]
    assert (eph.prn, eph.freq_slot, eph.tb_s) == (10, -7, ep.tb_s)
    assert np.array_equal(np.isnan(tow_p), np.isnan(tow_j))
    m = ~np.isnan(tow_p)
    assert m.sum() > 20_000 and np.array_equal(tow_p[m], tow_j[m])
    idx = np.flatnonzero(m)
    np.testing.assert_allclose(tow_p[m], T0 * 1000.0 + (off + idx + 1),
                               atol=1e-9)


# ---- the simulator ---------------------------------------------------------

@pytest.mark.parametrize("signal,k", [("1G", -7), ("1G", 6), ("2G", -7)])
def test_host_generator_equals_jax(signal, k):
    """20 ms of a slot-k satellite, noiseless, sample for sample."""
    n = int(0.02 * FS)
    want = jgen([_sat(JSat, signal, k, 1750.0, 100.25)], FS, n,
                start_sample=777, noise=False)
    got = pgen([_sat(PSat, signal, k, 1750.0, 100.25)], FS, n,
               start_sample=777, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    """K6's plain version against the JAX device generator on three
    satellites at slots -7, 0 and +6 (L1) over 0.1 s at 10 Msps
    (tests/test_device_generator.py's criteria), the anchors bit for
    bit."""
    def sats(cls):
        return [_sat(cls, "1G", -7, 2300.0, 100.5, prn=10),
                _sat(cls, "1G", 0, -1700.0, 310.25, seed=4, prn=11),
                _sat(cls, "1G", 6, 900.0, 47.75, seed=5, prn=4)]
    nblk = int(0.1 * FS) // 8192
    want = jdg.generate_baseband_device(sats(JSat), FS, nblk * 8192,
                                        noise=False)
    got = pdg.generate_baseband_device_resident(
        sats(PSat), FS, nblk * 8192, noise=False, device="cpu").numpy()
    _assert_agrees(got, want)
    for w, g in zip(jdg._anchors(sats(JSat), FS, 0, nblk, None),
                    pdg._anchors(sats(PSat), FS, 0, nblk, None)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- acquisition and tracking ----------------------------------------------

def test_acquisition_matches_jax():
    """The slot -7 chain's cold search (two 1 ms dwells, 250 Hz then
    62.5 Hz, centred on -3.9375 MHz) on 4 ms of its satellite in noise:
    the same detection, Doppler and delay, the statistic to 1e-4; the
    Doppler within one step-two bin of the truth, the delay within 3
    samples."""
    chain = prx.glonass_l1_chain(FS, prns=(10, 14), freq_slot=-7)
    jchain = jrx.glonass_l1_chain(FS, prns=(10, 14), freq_slot=-7)
    assert chain.acq.doppler_center == -7 * DF_L1
    x = jgen([_sat(JSat, "1G", -7, 2300.0, 100.5)], FS, int(0.004 * FS),
             noise=True, seed=12)
    je = jacq.PcpsAcquisitionEngine(
        jchain.acq, prns=[10], code_provider=jchain.code_provider,
        sc_rate=jchain.sc_rate)
    pe = pacq.PcpsAcquisitionEngine(
        chain.acq, prns=[10], code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, device="cpu")
    want, got = je.acquire(x), pe.acquire(x)
    assert list(got.detected) == list(want.detected) == [True]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    assert abs(got.doppler_hz[0] - (-7 * DF_L1 + 2300.0)) <= 62.5
    truth = 100.5 / 0.511e6 * FS
    n1 = int(FS * 1e-3)
    err = abs(got.delay_samples[0] - truth) % n1
    assert min(err, n1 - err) <= 3.0


def _armed(conf, dop: float, delay: int):
    """One channel armed on the truth as start_tracking arms it: the code
    rate from the Doppler less the FDMA bias."""
    st = jtrk._init_state(1)
    f0 = conf.code_rate_cps * (1.0 + (dop - conf.doppler_bias_hz)
                               / conf.carrier_freq_hz)
    st = jtrk._arm_channel(st, 0, float(dop), float(f0))
    phase0 = np.float32(np.mod(2.0 * np.pi * dop * delay / conf.fs,
                               2.0 * np.pi))
    return st._replace(pos=jnp.asarray(np.array([delay], np.int32)),
                       rem_carr_phase=jnp.asarray(np.array([phase0])))


def _slot_case(k: int, n_epochs: int, tail: int = 4096):
    """The slot-k chain's confs in both packages (equal field by field),
    its satellite noise-free at 48 dB-Hz, both armed states and the
    band-limited replica table."""
    jconf = jrx.glonass_l1_chain(FS, prns=(10,), freq_slot=k).trk
    pconf = prx.glonass_l1_chain(FS, prns=(10,), freq_slot=k).trk
    for f in dataclasses.fields(pconf):
        assert getattr(pconf, f.name) == getattr(jconf, f.name), f.name
    assert pconf.doppler_bias_hz == k * DF_L1
    phys, delay = 2300.0 if k < 0 else -1900.0, 1503
    x = jgen([_sat(JSat, "1G", k, phys, delay * 0.511e6 / FS,
                   n_sym=n_epochs // 10 + 2)],
             FS, delay + (n_epochs + 4) * 10_000 + tail, noise=False)
    st = _armed(jconf, k * DF_L1 + phys, delay)
    pst = interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                         "cpu")
    tables = jpc.bandlimited_table_normalized(
        jpcm.glonass_l1_ca_code(), FS, jconf.code_rate_cps, 10_000)[None]
    return jconf, pconf, x, st, pst, tables, k * DF_L1 + phys


# The FDMA slot rides in the tracked Doppler: at |k| >= 4 (2.25 MHz and
# up) a float32 Doppler moves in steps of 0.25 Hz.  The packages round
# their float32 sums in different orders (XLA contracts multiply-adds, the
# port does not), so after a closure their Dopplers part by one or two
# such steps (0.0001 Hz at slot 0, the same runs), and the carrier phase
# then parts at up to 2 pi 0.5 Hz a second: 0.063 rad over a 20 ms block.
# The biased runs' tolerances are set for that: prompt max 8 %, median
# 3 % of the mean prompt (at slot 0: 0.02 % and 0.008 %); Doppler 1 Hz
# (four steps); epoch ends within one sample, flipped on under 5 % of the
# epochs (4.3 % at slot +6), and the code boundary within 0.05 sample, as
# tests/test_torch_tracking.py's.
BIASED = dict(prompt_max=0.08, prompt_med=0.03, pos_tol=1, dop_tol=1.0,
              boundary_tol=0.05, flip_share=0.05)


@pytest.mark.parametrize("k", [-7, 6])
def test_per_epoch_bias_matches_jax(k):
    """300 epochs of 1 ms from the armed state at slot k (the FDMA bias
    -3.9375 or +3.375 MHz), under glonass_l1_chain's loops (400-epoch FLL
    pull-in, rectified lock test), with the BIASED tolerances.  Both hold
    lock, their last 50 Dopplers' means within 1 Hz of each other (the
    pull-in moves both ~14 Hz off the truth by then), and the code rate is
    the one of the Doppler less the bias (within 1e-3 cps)."""
    n_ep = 300
    jconf, pconf, x, st, pst, tables, dop = _slot_case(k, n_ep)
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    sj, oj = jtrk.track_chunk(jconf, n_ep, jnp.asarray(tables),
                              jnp.asarray(taps), jnp.asarray(x), st)
    sp, op = ptrk.track_chunk(pconf, n_ep, torch.from_numpy(tables),
                              torch.from_numpy(taps), torch.from_numpy(x),
                              pst)
    _compare_outputs(oj, op, **BIASED)
    assert op["valid"].all()
    d = op["carrier_doppler_hz"].numpy()[-50:, 0]
    dj = np.asarray(oj["carrier_doppler_hz"])[-50:, 0]
    assert abs(d.mean() - dj.mean()) < 1.0 and abs(d.mean() - dop) < 20.0
    # the code runs at the physical Doppler's rate: the DLL's output (well
    # under 1 cps here) beside 0.511 Mcps * (dop - bias) / f_c, against the
    # 1.26 to 1.08 kcps that the bias would add
    rate = float(op["code_freq_cps"].numpy()[-1, 0])
    want = 0.511e6 * (1.0 + (float(d[-1]) - k * DF_L1) / (F_L1 + k * DF_L1))
    assert abs(rate - want) < 1.0
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for key in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[key], dp[key]), key
    assert not dp["lock_lost"][0]


def test_block_bias_chunk_matches_jax():
    """One block chunk of 4 blocks of E = 20 epochs (80 ms) at slot -7
    from the armed state, with the BIASED tolerances; the replica spectra
    equal; the channel keeps lock within 5 Hz of the truth."""
    n_blk, e_blk = 4, 20
    jconf, pconf, x, st, pst, tables, dop = _slot_case(-7, n_blk * e_blk,
                                                       tail=8192)
    eng = ptrk.TrackingEngine(pconf, [10], device="cpu",
                              code_provider=signals.CodeProvider("1G"))
    assert eng.block_epochs == e_blk
    rep = jtb.code_spectra(jconf, tables)
    prep = ptb.code_spectra(pconf, tables, "cpu")
    assert np.array_equal(np.asarray(rep), prep.numpy())
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    sj, oj = jtb.track_chunk_blocks(jconf, n_blk, e_blk, rep,
                                    jnp.asarray(taps), jnp.asarray(x), st)
    sp, op = ptb.track_chunk_blocks(pconf, n_blk, e_blk, prep,
                                    torch.from_numpy(taps),
                                    torch.from_numpy(x), pst)
    _compare_outputs(oj, op, **BIASED)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for key in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[key], dp[key]), key
    assert np.abs(dj["pos"] - dp["pos"]).max() <= 1
    assert not dp["lock_lost"][0]
    assert abs(float(dp["carrier_doppler"][0]) - dop) < 5.0


# ---- the chains, the factory and the fix -----------------------------------

@pytest.mark.parametrize("builder", ["glonass_l1_chain", "glonass_l2_chain"])
def test_chain_conf_like_jax(builder):
    """Both builders at slots -7 and +6 with a day base give the JAX chains
    (compared through interop): the slot's carrier, the bias, the search
    centre; the decoder carries the slot and the day base; L2 waits for
    L1's assistance."""
    for k in (-7, 6):
        kw = dict(prns=(10, 14), freq_slot=k, day_base_s=DAY)
        ref = getattr(jrx, builder)(FS, **kw)
        got = getattr(prx, builder)(FS, **kw)
        assert got == interop._chain_from_fields(dataclasses.asdict(ref),
                                                 builder)
    sig, f0, df = (("1G", F_L1, DF_L1) if "l1" in builder
                   else ("2G", F_L2, DF_L2))
    assert (got.signal, got.system, got.assist_wait) == (
        sig, "GLONASS", sig == "2G")
    assert got.trk.carrier_freq_hz == f0 + 6 * df
    assert got.trk.doppler_bias_hz == got.acq.doppler_center == 6 * df
    assert got.code_provider == signals.CodeProvider(sig)
    dec = got.telemetry_decoder([0, 0])
    assert isinstance(dec, ptlm.GlonassTelemetryDecoder)
    assert dec.day_base_s == DAY and dec.freq_slots == {10: 6, 14: 6}


@pytest.mark.parametrize("count", [8, 24])
def test_factory_slot_chains_like_jax(count):
    """Channels_1G.count and Channels_2G.count build one chain per occupied
    slot in sorted slot order until the count is used (8: slots -7 to -2
    only), each centred on its slot, equal to the JAX factory's chains
    through interop, Channel<i>.satellite pinning counted in that order;
    an SBAS chain beside them comes last, as in JAX (it was refused until
    the SBAS chain was ported)."""
    props = {"GNSS-SDR.internal_fs_sps": str(FS), "Channels_1C.count": "2",
             "Channels_1G.count": str(count), "Channels_2G.count": "3",
             "Channel5.satellite": "20"}
    ref = jfactory.receiver_conf_from_config(JConfig(props))
    got = factory.receiver_conf_from_config(InMemoryConfiguration(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    l1 = [c for c in got.chains if c.signal == "1G"]
    assert sum(c.n_channels for c in l1) == count
    slots = [c.freq_slot for c in l1]
    assert slots == sorted(slots) and slots[0] == -7
    assert slots[-1] == (-2 if count == 8 else 6)
    for c in got.chains:
        df = DF_L1 if c.signal == "1G" else DF_L2
        assert c.acq.doppler_center == c.trk.doppler_bias_hz \
            == c.freq_slot * df
    # global channel 5 is the third channel of the first L1 chain... or
    # wherever the JAX order puts it: both packages pin the same one
    assert [c.pinned for c in got.chains] == \
        [c.pinned for c in ref.chains]
    props["Channels_S1.count"] = "1"
    ref = jfactory.receiver_conf_from_config(JConfig(props))
    got = factory.receiver_conf_from_config(InMemoryConfiguration(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got.chains[-1].signal == "S1"
    assert [c.pinned for c in got.chains] == \
        [c.pinned for c in ref.chains]


def test_glonass_fix_raises_like_jax():
    """solve_pvt over four GLONASS channels with ephemerides raises in the
    JAX package (its satellite states read Kepler fields a
    GlonassEphemeris lacks): the port raises the same error."""
    errors = []
    for pvt, obs_cls, gnav in ((jpvt, JObs, jgnav), (ppvt, PObs, pgnav)):
        ephs = {("GLONASS", p): _eph(gnav.GlonassEphemeris, slot=p)
                for p in (1, 2, 3, 4)}
        obs = obs_cls(rx_time_s=T0 + 900.0, tick_sample=0,
                      valid=np.ones(4, bool),
                      pseudorange_m=np.full(4, 2.2e7),
                      interp_tow_ms=np.full(4, (T0 + 900.0) * 1e3),
                      carrier_doppler_hz=np.zeros(4),
                      carrier_phase_cycles=np.zeros(4),
                      cn0_db_hz=np.full(4, 45.0))
        with pytest.raises(AttributeError) as err:
            pvt.solve_pvt(obs, [1, 2, 3, 4], ephs, systems=["GLONASS"] * 4)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "toc" in errors[0]
