"""The BeiDou B1I and B3I chains of the PyTorch port against the JAX package
on the CPU, at small sizes (inputs from a seed with NumPy; tolerances
stated per test):

- the B1I and B3I codes of PRN 1-63 (and the out-of-range PRNs), NH20 and
  the engines' sub-chip tables, bit for bit;
- nav/dnav.py: BCH(15,11) with one flipped bit a word, the word
  interleaving, D1 subframes and D2 pages packed and unpacked (with
  tests/test_dnav.py's ICD bit spots), the ephemeris converters, the bit
  streams and epoch signs, is_geo_prn, and both streaming decoders at an
  offset and inverted, event for event;
- BeidouB1iTelemetryDecoder's D1 and D2 arms on noisy soft prompts in odd
  chunk sizes;
- the host simulator and K6's plain version on B1 and B3 satellites;
- the B3I search at 12.5 Msps and the B1I search with the doubled FFT;
  300 per-epoch B3I epochs and a B1I block chunk at E = 20;
- the BeiDou ephemeris's satellite states (CGCS2000's GM);
- both chains through interop (the factory's MULTI_CONF parity is
  tests/test_torch_l2c.py's);
- a B1I + B3I receiver run on two RF streams, cut to 2.5 s: B3I acquires
  around the B1I lock scaled by the carrier ratio.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.nav import dnav as jdnav
from gnss_sim_receiver_tpu.nav import ephemeris as jephm
from gnss_sim_receiver_tpu.nav.ephemeris import GpsEphemeris as JEph
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.ops import prn_codes_multi as jpcm
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu_torch import constants, interop, signals
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.nav import dnav as pdnav
from gnss_sim_receiver_tpu_torch.nav import ephemeris as pephm
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris as PEph
from gnss_sim_receiver_tpu_torch.ops import prn_codes_multi as ppcm
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from tests.test_torch_device_generator import _assert_agrees
from tests.test_torch_fnav_cnav import _run_decoders, _same_eph
from tests.test_torch_tracking import _armed, _compare_outputs

F_B1 = 1561.098e6
F_B3 = 1268.52e6
FS_B1 = 4_092_000.0               # tests/test_device_generator.py's rate
FS_B3 = 12_500_000.0              # tests/test_b3i.py's rate
PRNS = [14, 21]
DOPS = [1350.0, -2700.0]
DELAYS = [1234, 3009]             # samples at FS_B1 (B1I), FS_B3 (B3I) / 4

# tests/test_dnav.py:_test_eph
BDS_EPH = dict(
    prn=14, system="BeiDou", week=810, toe=345600.0, toc=345600.0,
    af0=2.4e-4, af1=-1.1e-11, af2=0.0, tgd=-5.2e-9,
    sqrt_a=float(np.sqrt(27_906_100.0)), ecc=0.0021, m0_sc=-0.73,
    delta_n_sc=1.3e-9, omega_sc=0.41, omega0_sc=-0.18, i0_sc=0.306,
    omega_dot_sc=-2.2e-9, idot_sc=4.4e-11, cuc=2.1e-7, cus=-6.3e-6,
    crc=187.5, crs=44.25, cic=-3.1e-8, cis=6.6e-8, iode=21, iodc=21)
T0 = 345600.0


def _eph(cls, **kw):
    return cls(**{**BDS_EPH, **kw})


def _sats(cls, signal: str, fs: float, n_epochs: int = 400, seed: int = 8,
          cn0: float = 48.0):
    """Two BeiDou satellites of `signal` ("B1" or "B3") with random D1 bits
    spread by NH20 as per-epoch signs, Doppler and code Doppler on the
    band's carrier."""
    rng = np.random.default_rng(seed)
    f_c, rate = (F_B1, 2.046e6) if signal == "B1" else (F_B3, 10.23e6)
    delays = DELAYS if signal == "B1" else [4 * d for d in DELAYS]
    return [cls(prn=p, system="BeiDou", signal=signal, cn0_db_hz=cn0,
                doppler_hz=d, code_doppler_hz=d, carrier_ref_hz=f_c,
                delay_chips=n * rate / fs,
                nav_bits=pdnav.b1i_epoch_signs(
                    rng.integers(0, 2, n_epochs // 20 + 1)))
            for p, d, n in zip(PRNS, DOPS, delays)]


# ---- codes ---------------------------------------------------------------------

def test_codes_and_tables_equal_jax():
    """PRN 1-63 of both codes bit for bit, NH20, the SignalDefs, the
    sub-chip tables, the constants; PRN 0 and 64 raise in both."""
    for name in ("BEIDOU_B1I", "BEIDOU_B3I"):
        assert dataclasses.astuple(getattr(signals, name)) == \
            dataclasses.astuple(getattr(jsig, name))
    assert signals.SIGNALS["B1"] is signals.BEIDOU_B1I
    assert signals.SIGNALS["B3"] is signals.BEIDOU_B3I
    assert ppcm.BEIDOU_NH20 == jpcm.BEIDOU_NH20
    jdefs = {"B1": jsig.BEIDOU_B1I, "B3": jsig.BEIDOU_B3I}
    for prn in range(1, 64):
        for sig, gen_p, gen_j, n in (
                ("B1", ppcm.beidou_b1i_code, jpcm.beidou_b1i_code, 2046),
                ("B3", ppcm.beidou_b3i_code, jpcm.beidou_b3i_code, 10230)):
            got = gen_p(prn)
            assert got.dtype == np.float32 and got.shape == (n,)
            assert np.array_equal(got, gen_j(prn)), (sig, prn)
            assert np.array_equal(signals.CodeProvider(sig)(prn), got)
            assert np.array_equal(
                signals.subchip_table(signals.SIGNALS[sig], prn),
                jsig.subchip_table(jdefs[sig], prn)), (sig, prn)
    for prn in (0, 64):
        for gen, what in ((ppcm.beidou_b1i_code, "B1I"),
                          (jpcm.beidou_b1i_code, "B1I"),
                          (ppcm.beidou_b3i_code, "B3I"),
                          (jpcm.beidou_b3i_code, "B3I")):
            with pytest.raises(ValueError, match=f"{what} PRN out of range"):
                gen(prn)
    for name in ("FREQ_HZ", "CODE_RATE_CPS", "CODE_LENGTH_CHIPS"):
        for band in ("B1I", "B3I"):
            key = f"BEIDOU_{band}_{name}"
            assert getattr(constants, key) == getattr(jconst, key), key


# ---- nav/dnav.py ---------------------------------------------------------------

def test_bch_and_interleaving_like_jax():
    """Every 11-bit word's codeword equal; each of its 15 single-bit errors
    corrected to the same word in both; a two-bit error gives the same
    (ok, bits); interleaving and its inverse equal."""
    rng = np.random.default_rng(0)
    for v in list(range(0, 2048, 7)) + [2047]:
        d = np.array([(v >> (10 - i)) & 1 for i in range(11)], np.int64)
        cw = pdnav.bch_encode(d)
        assert np.array_equal(cw, jdnav.bch_encode(d))
        for pos in range(15):
            bad = cw.copy()
            bad[pos] ^= 1
            okp, dp = pdnav.bch_decode(bad)
            okj, dj = jdnav.bch_decode(bad)
            assert okp and okj and np.array_equal(dp, d) \
                and np.array_equal(dj, d)
        bad = cw.copy()
        bad[rng.choice(15, 2, replace=False)] ^= 1
        okp, dp = pdnav.bch_decode(bad)
        okj, dj = jdnav.bch_decode(bad)
        assert okp == okj and np.array_equal(dp, dj)
    a, b = rng.integers(0, 2, (2, 15))
    w = pdnav.interleave_word(a, b)
    assert np.array_equal(w, jdnav.interleave_word(a, b))
    for got, want in zip(pdnav.deinterleave_word(w),
                         jdnav.deinterleave_word(w)):
        assert np.array_equal(got, want)


def _flip_one_per_word(bits, rng):
    rx = bits.copy()
    for w in range(10):
        rx[30 * w + int(rng.integers(0, 30))] ^= 1
    return rx


def test_d1_subframes_like_jax():
    """The three D1 subframes of an ephemeris packed bit for bit, unpacked
    (with one flipped bit a word) to the same fields; the ephemeris back
    field by field; a filler subframe (FraID 4)."""
    rng = np.random.default_rng(1)
    sf_p = pdnav.beidou_ephemeris_to_subframes(_eph(PEph))
    assert sf_p == jdnav.beidou_ephemeris_to_subframes(_eph(JEph))
    dec = {}
    for fra in (1, 2, 3, 4):
        f = dict(sf_p.get(fra, {}), sow=T0 + 6.0 * fra)
        bits = pdnav.pack_subframe(fra, f)
        assert np.array_equal(bits, jdnav.pack_subframe(fra, f))
        rx = _flip_one_per_word(bits, rng)
        got, want = pdnav.unpack_subframe(rx), jdnav.unpack_subframe(rx)
        assert got == want and got[0] and got[1] == fra
        dec[fra] = got[2]
    got = pdnav.subframes_to_beidou_ephemeris(14, dec)
    _same_eph(jdnav.subframes_to_beidou_ephemeris(14, dec), got)
    assert isinstance(got, PEph) and got.system == "BeiDou"


def test_d2_pages_like_jax():
    """The ten D2 pages of an ephemeris and the SOW-only subframes 2-5
    packed bit for bit and unpacked (one flipped bit a word) alike; the
    ephemeris back field by field."""
    rng = np.random.default_rng(2)
    geo = dict(prn=3, sqrt_a=float(np.sqrt(42_164_000.0)), ecc=0.0004)
    pages = pdnav.beidou_ephemeris_to_d2_pages(_eph(PEph, **geo))
    assert pages == jdnav.beidou_ephemeris_to_d2_pages(_eph(JEph, **geo))
    dec = {}
    for pnum, f in pages.items():
        for fra in (1, 2, 5):
            fields = dict(f if fra == 1 else {}, sow=300.0 + pnum)
            bits = pdnav.pack_d2_subframe(fra, fields)
            assert np.array_equal(bits, jdnav.pack_d2_subframe(fra, fields))
            rx = _flip_one_per_word(bits, rng)
            got = pdnav.unpack_d2_subframe(rx)
            assert got == jdnav.unpack_d2_subframe(rx) and got[0]
            if fra == 1:
                assert got[2] == pnum
                dec[pnum] = got[3]
    got = pdnav.d2_pages_to_beidou_ephemeris(3, dec)
    _same_eph(jdnav.d2_pages_to_beidou_ephemeris(3, dec), got)


def test_icd_raw_bit_positions():
    """tests/test_dnav.py's ICD spots on the port's frames: SOW at 19-26
    and 31-42, D1 WN at 61-73, D2 Pnum at 43-46, D2 WN at 65-77."""
    f = pdnav.pack_subframe(1, {"sow": 0b10110011_001111000011 * 1.0,
                                "wn": 0b1010101010101 * 1.0})
    ok, frame = pdnav._tx_to_frame(f)
    assert ok
    bits = "".join(str(int(b)) for b in frame)
    assert bits[18:26] == "10110011"
    assert bits[30:42] == "001111000011"
    assert bits[60:73] == "1010101010101"
    ok, frame = pdnav._tx_to_frame(pdnav.pack_d2_subframe(1, {"pnum": 9.0}))
    assert ok and "".join(str(int(b)) for b in frame)[42:46] == "1001"
    ok, frame = pdnav._tx_to_frame(pdnav.pack_d2_subframe(
        1, {"pnum": 1.0, "wn": 0b1100110011001 * 1.0}))
    assert ok and "".join(str(int(b)) for b in frame)[64:77] == \
        "1100110011001"


def test_streams_signs_and_geo_prns_like_jax():
    """bits_for_ephemeris, d2_bits_for_ephemeris, both epoch-sign helpers
    and is_geo_prn over PRN 0-70 equal; the t0 grids refused alike."""
    bp = pdnav.bits_for_ephemeris(_eph(PEph), T0, n_repeats=2)
    assert np.array_equal(bp, jdnav.bits_for_ephemeris(_eph(JEph), T0,
                                                       n_repeats=2))
    assert bp.shape == (1800,)
    d2 = pdnav.d2_bits_for_ephemeris(_eph(PEph), 300.0, n_frames=3)
    assert np.array_equal(d2, jdnav.d2_bits_for_ephemeris(_eph(JEph), 300.0,
                                                          n_frames=3))
    for got, want in ((pdnav.b1i_epoch_signs(bp[:97]),
                       jdnav.b1i_epoch_signs(bp[:97])),
                      (pdnav.d2_epoch_signs(d2[:333]),
                       jdnav.d2_epoch_signs(d2[:333]))):
        assert got.dtype == want.dtype == np.int8
        assert np.array_equal(got, want)
    for prn in range(71):
        assert pdnav.is_geo_prn(prn) == jdnav.is_geo_prn(prn), prn
    for mod in (pdnav, jdnav):
        with pytest.raises(ValueError, match="multiple of 6 s"):
            mod.bits_for_ephemeris(_eph(PEph), T0 + 1.0)
        with pytest.raises(ValueError, match="multiple of 3 s"):
            mod.d2_bits_for_ephemeris(_eph(PEph), 301.0)


def _events(ev):
    return [dataclasses.astuple(e) for e in ev]


@pytest.mark.parametrize("invert", [False, True])
def test_streaming_decoders_like_jax(invert):
    """DnavSubframeDecoder on soft bits and D2SubframeDecoder on soft
    symbols, each stream cut at an offset, in noise, optionally inverted,
    pushed in random chunks: the same events in both packages, in
    order."""
    rng = np.random.default_rng(5 + invert)
    sign = -1.0 if invert else 1.0
    d1 = sign * (2.0 * pdnav.bits_for_ephemeris(_eph(PEph), T0, 3)
                 - 1.0)[37:]
    d1 = d1 + 0.4 * rng.standard_normal(len(d1))
    d2 = pdnav.d2_epoch_signs(pdnav.d2_bits_for_ephemeris(
        _eph(PEph, prn=2), 300.0, n_frames=11)).astype(np.float64)
    d2 = sign * np.concatenate([0.1 * rng.standard_normal(7),
                                3.0 * d2 + rng.standard_normal(len(d2))])
    for stream, mk_p, mk_j, push, lo, hi in (
            (d1, pdnav.DnavSubframeDecoder, jdnav.DnavSubframeDecoder,
             "push_bits", 40, 400),
            (d2, pdnav.D2SubframeDecoder, jdnav.D2SubframeDecoder,
             "push_symbols", 500, 3000)):
        dp, dj = mk_p(), mk_j()
        evp, evj, i = [], [], 0
        while i < len(stream):
            n = int(rng.integers(lo, hi))
            evp += _events(getattr(dp, push)(stream[i:i + n]))
            evj += _events(getattr(dj, push)(stream[i:i + n]))
            i += n
        assert evp == evj
        assert sum(e[-1] for e in evp) >= 4


# ---- the telemetry decoder -------------------------------------------------------

@pytest.mark.parametrize("arm", ["D1", "D2"])
def test_telemetry_decoder_like_jax(arm):
    """BeidouB1iTelemetryDecoder in both packages on 1 ms prompts (D1: the
    NH20-spread bit stream, cut mid-bit; D2: a GEO PRN's 500 bps symbols,
    cut mid-symbol), noise, odd chunks: equal TOW stamps (NaN pattern
    included), each the epoch's end in BDT to 1e-9 ms, and equal
    ephemerides field by field."""
    rng = np.random.default_rng(31)
    if arm == "D1":
        prn, t0, off = 14, T0, 13
        epochs = pdnav.b1i_epoch_signs(pdnav.bits_for_ephemeris(
            _eph(PEph), T0, n_repeats=2))
        chunks = rng.integers(301, 2999, 60) | 1
    else:
        prn, t0, off = 3, 600.0, 1
        epochs = pdnav.d2_epoch_signs(pdnav.d2_bits_for_ephemeris(
            _eph(PEph, prn=3), 600.0, n_frames=11))
        chunks = rng.integers(201, 1999, 60) | 1
    soft = 3.0 * epochs.astype(np.float64)[off:]
    soft = soft + 0.7 * rng.standard_normal(len(soft))
    decs = (ptlm.BeidouB1iTelemetryDecoder([prn]),
            jtlm.BeidouB1iTelemetryDecoder([prn]))
    (tow_p, new_p), (tow_j, new_j) = _run_decoders(decs, soft, chunks)
    assert len(new_p) == len(new_j) == 1
    _same_eph(new_j[0][1], new_p[0][1])
    assert new_p[0][1].prn == prn and new_p[0][1].system == "BeiDou"
    assert np.array_equal(np.isnan(tow_p), np.isnan(tow_j))
    m = ~np.isnan(tow_p)
    assert m.sum() > 5_000 and np.array_equal(tow_p[m], tow_j[m])
    idx = np.flatnonzero(m)
    np.testing.assert_allclose(tow_p[m], t0 * 1000.0 + (off + idx + 1),
                               atol=1e-9)


def test_reset_channel_switches_the_arm():
    """reset_channel to a GEO PRN gives the D2 decoder and back, as JAX's;
    the epoch base carries."""
    for mod in (ptlm, jtlm):
        dec = mod.BeidouB1iTelemetryDecoder([14, 2])
        assert type(dec.ch[0].decoder).__name__ == "DnavSubframeDecoder"
        assert type(dec.ch[1].decoder).__name__ == "D2SubframeDecoder"
        dec.reset_channel(0, prn=59, epoch_base=77)
        assert type(dec.ch[0].decoder).__name__ == "D2SubframeDecoder"
        assert dec.prns[0] == 59 and dec.ch[0].epoch_count == 77
        dec.reset_channel(1, prn=30)
        assert type(dec.ch[1].decoder).__name__ == "DnavSubframeDecoder"


# ---- the simulator ---------------------------------------------------------------

@pytest.mark.parametrize("signal", ["B1", "B3"])
def test_host_generator_equals_jax(signal):
    """0.1 s of two satellites, noiseless, sample for sample."""
    fs = FS_B1 if signal == "B1" else FS_B3
    n = int(0.1 * fs)
    want = jgen(_sats(JSat, signal, fs), fs, n, start_sample=777,
                noise=False)
    got = pgen(_sats(PSat, signal, fs), fs, n, start_sample=777, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    """K6's plain version against the JAX device generator on
    tests/test_device_generator.py's B1 satellite (PRN 8, 45 dB-Hz, 700 Hz,
    87 chips) and a B3I one beside it over 0.1 s at 12.5 Msps
    (tests/test_device_generator.py's criteria), the anchors bit for
    bit."""
    def sats(cls):
        rng = np.random.default_rng(0)
        return [cls(prn=8, system="BeiDou", signal="B1", cn0_db_hz=45.0,
                    doppler_hz=700.0, delay_chips=87.0,
                    nav_bits=(rng.integers(0, 2, 200) * 2 - 1).astype(
                        np.int8)),
                cls(prn=21, system="BeiDou", signal="B3", cn0_db_hz=47.0,
                    doppler_hz=-2700.0, code_doppler_hz=-2700.0,
                    carrier_ref_hz=F_B3, delay_chips=7000.5,
                    nav_bits=(rng.integers(0, 2, 200) * 2 - 1).astype(
                        np.int8))]
    nblk = int(0.1 * FS_B3) // 8192
    want = jdg.generate_baseband_device(sats(JSat), FS_B3, nblk * 8192,
                                        noise=False)
    got = pdg.generate_baseband_device_resident(
        sats(PSat), FS_B3, nblk * 8192, noise=False, device="cpu").numpy()
    _assert_agrees(got, want)
    for w, g in zip(jdg._anchors(sats(JSat), FS_B3, 0, nblk, None),
                    pdg._anchors(sats(PSat), FS_B3, 0, nblk, None)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- acquisition and tracking ----------------------------------------------------

@pytest.mark.parametrize("signal", ["B1", "B3"])
def test_acquisition_matches_jax(signal):
    """The chains' searches (two 1 ms dwells, each a doubled FFT, 250 Hz
    then 62.5 Hz) on 4 ms of the two satellites in noise, PRN 9 absent:
    the same detections, Doppler and delay, the statistic to 1e-4; the
    first PRN within one step-two bin and 3 samples of its truth."""
    fs = FS_B1 if signal == "B1" else FS_B3
    chain = (prx.beidou_b1i_chain if signal == "B1"
             else prx.beidou_b3i_chain)(fs)
    jchain = (jrx.beidou_b1i_chain if signal == "B1"
              else jrx.beidou_b3i_chain)(fs)
    assert chain.acq.bit_transition_flag
    x = jgen(_sats(JSat, signal, fs), fs, int(0.004 * fs), noise=True,
             seed=12)
    je = jacq.PcpsAcquisitionEngine(
        jchain.acq, prns=[14, 21, 9], code_provider=jchain.code_provider,
        sc_rate=jchain.sc_rate)
    pe = pacq.PcpsAcquisitionEngine(
        chain.acq, prns=[14, 21, 9], code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, device="cpu")
    n1 = int(round(fs * 1e-3))
    assert pe.fft_size == je.fft_size == 2 * n1
    want, got = je.acquire(x), pe.acquire(x)
    assert list(got.detected) == list(want.detected) == [True, True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    assert got.threshold == want.threshold
    assert abs(got.doppler_hz[0] - DOPS[0]) <= 62.5
    truth = DELAYS[0] if signal == "B1" else 4 * DELAYS[0]
    err = abs(got.delay_samples[0] - truth) % n1
    assert min(err, n1 - err) <= 3.0


def test_per_epoch_b3i_tracking_matches_jax():
    """300 epochs of 1 ms at 12.5 Msps from the armed state, noise-free at
    48 dB-Hz with the NH20-spread bits, under beidou_b3i_chain's loops
    (40 Hz PLL, 100-epoch FLL pull-in), with tests/test_torch_tracking.py's
    per-epoch tolerances: prompt max 2 %, median 0.2 % of the mean prompt;
    epoch ends within one sample; Doppler within 0.2 Hz; code boundary
    within 0.05 sample."""
    n_ep, s0 = 300, 12_500
    delays = [4 * d for d in DELAYS]
    x = jgen(_sats(JSat, "B3", FS_B3), FS_B3,
             max(delays) + (n_ep + 4) * s0 + 4096, noise=False)
    jconf = jrx.beidou_b3i_chain(FS_B3).trk
    pconf = prx.beidou_b3i_chain(FS_B3).trk
    for f in dataclasses.fields(pconf):
        assert getattr(pconf, f.name) == getattr(jconf, f.name), f.name
    st = _armed(jconf, PRNS, DOPS, delays)
    pst = interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                         "cpu")
    tables = np.stack([jpc.bandlimited_table_normalized(
        jpcm.beidou_b3i_code(p), FS_B3, jconf.code_rate_cps, s0)
        for p in PRNS])
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    sj, oj = jtrk.track_chunk(jconf, n_ep, jnp.asarray(tables),
                              jnp.asarray(taps), jnp.asarray(x), st)
    sp, op = ptrk.track_chunk(pconf, n_ep, torch.from_numpy(tables),
                              torch.from_numpy(taps), torch.from_numpy(x),
                              pst)
    _compare_outputs(oj, op, prompt_max=0.02, prompt_med=0.002, pos_tol=1,
                     dop_tol=0.2, boundary_tol=0.05)
    assert op["valid"].all()
    dop = op["carrier_doppler_hz"].numpy()[-50:].mean(axis=0)
    assert np.abs(dop - np.asarray(DOPS)).max() < 5.0
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[k], dp[k]), k


def test_b1i_block_chunk_matches_jax():
    """The block step at B1I's shape (4.092 Msps, E = 20 epochs a block),
    6 blocks (120 ms) from the armed state on the noise-free pair, with
    tests/test_torch_tracking.py's per-epoch tolerances (prompt max 2 %,
    median 0.2 % of the mean prompt; epoch ends within one sample;
    Doppler within 0.2 Hz; code boundary within 0.05 sample); the replica
    spectra equal."""
    s0, n_blk, e_blk = 4092, 6, 20
    x = jgen(_sats(JSat, "B1", FS_B1), FS_B1,
             max(DELAYS) + (n_blk * e_blk + 4) * s0 + 8192, noise=False)
    jconf = jrx.beidou_b1i_chain(FS_B1).trk
    pconf = prx.beidou_b1i_chain(FS_B1).trk
    eng = ptrk.TrackingEngine(pconf, PRNS, device="cpu",
                              code_provider=signals.CodeProvider("B1"))
    assert eng.block_epochs == e_blk
    st = _armed(jconf, PRNS, DOPS, DELAYS)
    pst = interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                         "cpu")
    tables = np.stack([jpc.bandlimited_table_normalized(
        jpcm.beidou_b1i_code(p), FS_B1, jconf.code_rate_cps, s0)
        for p in PRNS])
    rep = jtb.code_spectra(jconf, tables)
    prep = ptb.code_spectra(pconf, tables, "cpu")
    assert np.array_equal(np.asarray(rep), prep.numpy())
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    sj, oj = jtb.track_chunk_blocks(jconf, n_blk, e_blk, rep,
                                    jnp.asarray(taps), jnp.asarray(x), st)
    sp, op = ptb.track_chunk_blocks(pconf, n_blk, e_blk, prep,
                                    torch.from_numpy(taps),
                                    torch.from_numpy(x), pst)
    _compare_outputs(oj, op, prompt_max=0.02, prompt_med=0.002, pos_tol=1,
                     dop_tol=0.2, boundary_tol=0.05)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["pos"] - dp["pos"]).max() <= 1


# ---- the ephemeris and the chains ----------------------------------------------

def test_beidou_satellite_states_like_jax():
    """sat_states_batch on a BeiDou ephemeris beside a GPS one with the
    same elements: the BeiDou states equal JAX's to 1 mm, 1e-15 s and
    1e-6 m/s (sat_pos_clock's too), and differ from the GPS one's
    (CGCS2000's GM, not GPS's)."""
    ephs_p = [_eph(PEph), _eph(PEph, system="GPS")]
    ephs_j = [_eph(JEph), _eph(JEph, system="GPS")]
    t = np.array([T0 + 3600.7, T0 + 3600.7])
    got = pephm.sat_states_batch(ephs_p, t)
    want = jephm.sat_states_batch(ephs_j, t)
    for g, w, tol in zip(got, want, (1e-3, 1e-15, 1e-6)):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= tol
    assert np.linalg.norm(got[0][0] - got[0][1]) > 0.5
    for g, w, tol in zip(ephs_p[0].sat_pos_clock(T0 + 3600.7),
                         ephs_j[0].sat_pos_clock(T0 + 3600.7), (1e-3, 1e-15)):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= tol


@pytest.mark.parametrize("builder", ["beidou_b1i_chain", "beidou_b3i_chain"])
def test_chain_conf_like_jax(builder):
    """Both chain builders give the JAX chains (compared through interop,
    GEO PRNs included); their decoder is the BeiDou one; B3I waits for
    B1I's assistance."""
    for kw in ({}, dict(prns=(2, 14, 59), n_channels=3)):
        ref = getattr(jrx, builder)(FS_B3, **kw)
        got = getattr(prx, builder)(FS_B3, **kw)
        assert got == interop._chain_from_fields(dataclasses.asdict(ref),
                                                 builder)
    sig = "B1" if "b1i" in builder else "B3"
    assert (got.signal, got.system, got.assist_wait) == (
        sig, "BeiDou", sig == "B3")
    assert got.prns == (2, 14, 59)
    assert got.code_provider == signals.CodeProvider(sig)
    dec = got.telemetry_decoder(list(got.prns))
    assert isinstance(dec, ptlm.BeidouB1iTelemetryDecoder)
    assert type(dec.ch[0].decoder) is pdnav.D2SubframeDecoder
    assert type(dec.ch[1].decoder) is pdnav.DnavSubframeDecoder


# ---- the receiver: B1I on RF 0, B3I on RF 1 ------------------------------------

FS_RX_B1 = 2_500_000.0
FS_RX_B3 = 10_500_000.0
RX_DUR = 2.5
DOP_B1 = -1833.0
F_RATIO = F_B3 / F_B1


@pytest.fixture(scope="module")
def two_bands():
    """PRN 14 on B1I (2.5 Msps) and on B3I (10.5 Msps), 48 dB-Hz, the same
    D1 bits, the B3I Doppler the B1I one scaled by the carrier ratio."""
    rng = np.random.default_rng(4)
    signs = jdnav.b1i_epoch_signs(rng.integers(0, 2, 130))
    b1 = JSat(prn=14, system="BeiDou", signal="B1", cn0_db_hz=48.0,
              doppler_hz=DOP_B1, code_doppler_hz=DOP_B1, carrier_ref_hz=F_B1,
              delay_chips=613.25, nav_bits=signs)
    b3 = JSat(prn=14, system="BeiDou", signal="B3", cn0_db_hz=48.0,
              doppler_hz=DOP_B1 * F_RATIO, code_doppler_hz=DOP_B1 * F_RATIO,
              carrier_ref_hz=F_B3, delay_chips=3065.5, nav_bits=signs.copy())
    return (jgen([b1], FS_RX_B1, int(FS_RX_B1 * RX_DUR), noise=True, seed=4),
            jgen([b3], FS_RX_B3, int(FS_RX_B3 * RX_DUR), noise=True, seed=5))


@pytest.fixture
def two_threads():
    """The port's torch on two threads beside the other pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _two_band_session(rx_mod, x1, x2, **kw):
    b3 = dataclasses.replace(
        rx_mod.beidou_b3i_chain(FS_RX_B3, prns=(14,), n_channels=1),
        rf_channel_id=1)
    conf = rx_mod.ReceiverConf(
        fs=FS_RX_B1, gps_chain=False, rf_fs={1: FS_RX_B3},
        chains=(rx_mod.beidou_b1i_chain(FS_RX_B1, prns=(14,), n_channels=1),
                b3))
    session = rx_mod.Receiver(conf, **kw).start_session()
    session.attach_arrays({0: x1, 1: x2})
    session.run_to_end()
    return session


def test_b1i_b3i_receiver_like_jax(two_bands, two_threads):
    """Both bands tracking PRN 14; the B3I search assisted (none cold),
    its centre within 50 Hz of the B1I Doppler x f_B3 / f_B1; the port
    against the JAX receiver: the same assist log with the centres within
    1 Hz, and each band's last Doppler within 1 Hz; the B3I Doppler within
    5 Hz of the scaled B1I one."""
    got = _two_band_session(prx, *two_bands, device="cpu")
    want = _two_band_session(jrx, *two_bands)
    run = got.result()
    assert all(st == ChannelState.TRACKING
               for st in run.channel_states), run.channel_states
    assert got.assist_log, "no assisted acquisition happened"
    sig, prn, center, detected = got.assist_log[0]
    assert sig == "B3" and prn == 14 and detected
    assert abs(center - DOP_B1 * F_RATIO) < 50.0, center
    assert got.searches[("B3", "assisted")] >= 1
    assert not got.searches[("B3", "cold")]
    assert [e[:2] + e[3:] for e in got.assist_log] == \
        [e[:2] + e[3:] for e in want.assist_log]
    for g, w in zip(got.assist_log, want.assist_log):
        assert abs(g[2] - w[2]) < 1.0, (g, w)
    dops = []
    for session in (got, want):
        dops.append([float(interop.track_state_to_numpy(rt.trk.state)[
            "carrier_doppler"][0]) for rt in session.chains])
    assert np.abs(np.subtract(*dops)).max() < 1.0, dops
    # B3I locks ~1 s before the end: its loop still settles there, JAX's
    # alike (both read 2.4 Hz above the scaled B1I Doppler)
    b1, b3 = dops[0]
    assert abs(b3 - b1 * F_RATIO) < 5.0, dops
