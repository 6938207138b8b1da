"""The PyTorch port's Galileo F/NAV and GPS CNAV layers and their telemetry
decoders against the JAX package on the CPU: the cases of
tests/test_fnav.py and tests/test_cnav_chain.py:108,144 run through both
packages on the same inputs.

- F/NAV word and CNAV message round trips: the same 238 / 300 bits, the
  same decoded fields, the CRC gate;
- the symbol streams of an ephemeris (F/NAV pages, CNAV at 50 bps) and
  their per-epoch E5a-I (CS20) and L5-I (NH10) signs: equal;
- the streaming page decoder on noisy, cut and inverted streams: the same
  events;
- the E5a CS20 and the L5 NH10 synchronization on the same noisy 1 ms
  prompt streams pushed in the same random chunks: the same ephemerides
  (every field) and the same per-epoch TOW stamps, exactly.
"""

import dataclasses

import numpy as np
import pytest

from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models.receiver import galileo_e5a_chain as jchain5
from gnss_sim_receiver_tpu.models.receiver import gps_l5_chain as jchainl5
from gnss_sim_receiver_tpu.nav import cnav as jcnav
from gnss_sim_receiver_tpu.nav import fnav as jfnav
from gnss_sim_receiver_tpu.nav.ephemeris import GpsEphemeris as JEph
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models.receiver import (galileo_e5a_chain,
                                                         gps_l5_chain)
from gnss_sim_receiver_tpu_torch.nav import cnav as pcnav
from gnss_sim_receiver_tpu_torch.nav import fnav as pfnav
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris as PEph

T0 = 345600.0

# tests/test_fnav.py:_test_eph and tests/test_cnav_chain.py:_test_eph
GAL_EPH = dict(
    prn=19, system="Galileo", week=1045, iod_nav=209, toe=345600.0,
    toc=345600.0, af0=-2.2e-4, af1=3.1e-12, af2=0.0, bgd_e1e5a=3.49e-9,
    sqrt_a=5440.588, ecc=0.000431, m0_sc=0.17, delta_n_sc=1.1e-9,
    omega0_sc=-0.41, i0_sc=0.311, omega_sc=0.53, omega_dot_sc=-2.61e-9,
    idot_sc=-7.3e-11, cuc=3.2e-7, cus=-7.7e-6, crc=98.5, crs=12.4,
    cic=1.9e-8, cis=-4.4e-8)
GPS_EPH = dict(
    prn=4, week=2200, toe=345600.0, toc=345600.0, af0=-3.1e-4,
    af1=-6.2e-12, tgd=-8.4e-9, sqrt_a=float(np.sqrt(26_560_123.0)),
    ecc=0.0123, m0_sc=0.42, delta_n_sc=1.5e-9, omega_sc=-0.66,
    omega0_sc=0.31, i0_sc=0.305, omega_dot_sc=-2.51e-9, idot_sc=1.1e-10,
    cuc=-4.5e-7, cus=8.9e-6, crc=212.5, crs=-18.4)


def _same_eph(a, b):
    """Every field of the JAX ephemeris equals the port's."""
    for f in dataclasses.fields(b):
        assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_fnav_words_round_trip_like_jax():
    words_j = jfnav.galileo_ephemeris_to_fnav_words(
        JEph(**GAL_EPH), iono=dict(ai0=33.0, ai1=0.11))
    words_p = pfnav.galileo_ephemeris_to_fnav_words(
        PEph(**GAL_EPH), iono=dict(ai0=33.0, ai1=0.11))
    assert words_j == words_p
    words_p[4].update(a0=1.2e-8, a1=3.1e-15, dt_ls=18.0)
    for wt, f in words_p.items():
        f = dict(f, tow=345610.0)
        bits = pfnav.pack_word(wt, f)
        assert np.array_equal(bits, jfnav.pack_word(wt, f))
        assert pfnav.unpack_word(bits) == jfnav.unpack_word(bits)
        assert pfnav.unpack_word(bits)[:2] == (True, wt)
        assert np.array_equal(pfnav.encode_page(bits),
                              jfnav.encode_page(bits))
    bits = pfnav.pack_word(2, words_p[2])
    bits[50] ^= 1
    assert not pfnav.unpack_word(bits)[0]
    # the ephemeris with the (f_E1/f_E5a)^2 BGD scaling
    dec = {wt: pfnav.unpack_word(pfnav.pack_word(wt, f))[2]
           for wt, f in words_p.items()}
    _same_eph(jfnav.fnav_words_to_ephemeris(19, dec),
              pfnav.fnav_words_to_ephemeris(19, dec))
    eph = pfnav.fnav_words_to_ephemeris(19, dec)
    assert eph.tgd == pytest.approx(eph.bgd_e1e5a * (1575.42 / 1176.45) ** 2)


def test_cnav_messages_round_trip_like_jax():
    msgs = pcnav.cnav_ephemeris_to_messages(PEph(**GPS_EPH))
    assert msgs == jcnav.cnav_ephemeris_to_messages(JEph(**GPS_EPH))
    dec = {}
    for mt, f in msgs.items():
        bits = pcnav.pack_message(4, mt, T0 + 6.0, f)
        assert np.array_equal(bits, jcnav.pack_message(4, mt, T0 + 6.0, f))
        assert pcnav.unpack_message(bits) == jcnav.unpack_message(bits)
        ok, prn, mt2, tow, fields = pcnav.unpack_message(bits)
        assert ok and prn == 4 and mt2 == mt and tow == T0 + 6.0
        dec[mt] = fields
    bits[100] ^= 1
    assert not pcnav.unpack_message(bits)[0]
    _same_eph(jcnav.messages_to_ephemeris(4, dec),
              pcnav.messages_to_ephemeris(4, dec))


def test_symbol_streams_and_epoch_signs_equal_jax():
    sym_p = pfnav.pages_for_ephemeris(PEph(**GAL_EPH), T0, n_repeats=2)
    sym_j = jfnav.pages_for_ephemeris(JEph(**GAL_EPH), T0, n_repeats=2)
    assert np.array_equal(sym_p, sym_j) and len(sym_p) == 4000
    assert np.array_equal(pfnav.e5a_epoch_signs(sym_p, 19),
                          jfnav.e5a_epoch_signs(sym_j, 19))
    sym_p = pcnav.symbols_for_ephemeris(PEph(**GPS_EPH), T0, n_repeats=2,
                                        bps=50.0)
    sym_j = jcnav.symbols_for_ephemeris(JEph(**GPS_EPH), T0, n_repeats=2,
                                        bps=50.0)
    assert sym_p.dtype == np.int64 and np.array_equal(sym_p, sym_j)
    signs = pcnav.l5i_epoch_signs(sym_p)
    assert signs.dtype == np.int8 and len(signs) == 10 * len(sym_p)
    assert np.array_equal(signs, jcnav.l5i_epoch_signs(sym_j))


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("offset", [0, 777])
def test_page_stream_decode_like_jax(invert, offset):
    sym = pfnav.pages_for_ephemeris(PEph(**GAL_EPH), T0, n_repeats=2,
                                    iono=dict(ai0=33.0))
    s = (2.0 * sym - 1.0).astype(np.float64)[offset:]
    if invert:
        s = -s
    rng = np.random.default_rng(2)
    s = s + 0.3 * rng.standard_normal(len(s))
    cuts = rng.integers(60, 600, 40)
    events = []
    for dec in (pfnav.FnavPageDecoder(), jfnav.FnavPageDecoder()):
        evs, i = [], 0
        for n in cuts:
            evs.extend(dec.push_symbols(s[i:i + n]))
            i += n
        events.append([(e.word_type, e.fields, e.page_start_symbol,
                        e.crc_ok) for e in evs])
    assert events[0] == events[1]
    ok = [e for e in events[0] if e[3]]
    assert len(ok) >= 6 and {1, 2, 3, 4} <= {e[0] for e in ok}


def _run_decoders(decoders, soft, chunks):
    """The same soft 1 ms prompts pushed in the same chunks through each
    decoder -> per decoder (TOW [T], new ephemerides)."""
    out = []
    for tlm in decoders:
        tow, new, i = [], [], 0
        for n in chunks:
            chunk = soft[i:i + n]
            r = tlm.process({"prompt": (chunk + 0j).reshape(-1, 1),
                             "valid": np.ones((len(chunk), 1), bool)})
            tow.append(r.tow_at_epoch_ms[:, 0])
            new.extend(r.new_ephemerides)
            i += n
        out.append((np.concatenate(tow), new))
    return out


@pytest.mark.parametrize("system", ["galileo_e5a", "gps_l5"])
def test_secondary_sync_and_decode_like_jax(system):
    """tests/test_fnav.py:test_e5a_telemetry_cs20_sync and
    tests/test_cnav_chain.py:test_l5_cnav_telemetry_nh_sync on both
    packages: the stream cut mid-symbol, noise, random chunks."""
    if system == "galileo_e5a":
        sym = pfnav.pages_for_ephemeris(PEph(**GAL_EPH), T0, n_repeats=2)
        epochs = pfnav.e5a_epoch_signs(sym, prn=19).astype(np.float64)
        off, prn, seed, lo, hi = 13, 19, 21, 500, 2500
        decs = (ptlm.GalileoE5aTelemetryDecoder([prn]),
                jtlm.GalileoE5aTelemetryDecoder([prn]))
    else:
        sym = pcnav.symbols_for_ephemeris(PEph(**GPS_EPH), T0, n_repeats=2,
                                          bps=50.0)
        epochs = pcnav.l5i_epoch_signs(sym).astype(np.float64)
        off, prn, seed, lo, hi = 7, 4, 11, 300, 1500
        decs = (ptlm.GpsCnavTelemetryDecoder([prn], signal="L5"),
                jtlm.GpsCnavTelemetryDecoder([prn], signal="L5"))
    epochs = epochs[off:]
    rng = np.random.default_rng(seed)
    soft = 3.0 * epochs + rng.standard_normal(len(epochs))
    chunks = rng.integers(lo, hi, len(soft) // lo + 1)
    (tow_p, new_p), (tow_j, new_j) = _run_decoders(decs, soft, chunks)
    assert len(new_p) == len(new_j) == 1
    _same_eph(new_j[0][1], new_p[0][1])
    assert new_p[0][1].prn == prn
    assert np.array_equal(np.isnan(tow_p), np.isnan(tow_j))
    m = ~np.isnan(tow_p)
    assert m.sum() > 3000 and np.array_equal(tow_p[m], tow_j[m])
    idx = np.flatnonzero(m)
    np.testing.assert_allclose(tow_p[m], T0 * 1000.0 + (off + idx + 1),
                               atol=1e-9)


@pytest.mark.parametrize("signal", ["L5", "5X"])
def test_wideband_chain_confs_like_jax(signal):
    fs = 12_500_000.0
    jb, pb = {"L5": (jchainl5, gps_l5_chain),
              "5X": (jchain5, galileo_e5a_chain)}[signal]
    j, p = jb(fs, prns=(3,), n_channels=1), pb(fs, prns=(3,), n_channels=1)
    for f in ("signal", "system", "prns", "n_channels", "max_acq_channels",
              "sc_rate", "assist_wait"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.trk.nominal_epoch_samples == 12_500
    for f in dataclasses.fields(p.acq):
        assert getattr(p.acq, f.name) == getattr(j.acq, f.name), f.name
    for f in dataclasses.fields(p.trk):
        assert getattr(p.trk, f.name) == getattr(j.trk, f.name), f.name
    kind = {"L5": ptlm.GpsCnavTelemetryDecoder,
            "5X": ptlm.GalileoE5aTelemetryDecoder}[signal]
    dec = p.telemetry_decoder([0])
    assert isinstance(dec, kind)
    assert getattr(dec, "signal", signal) == signal
