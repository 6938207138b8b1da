"""The Galileo E6-B (HAS) chain of the PyTorch port against the JAX package
on the CPU, at small sizes (inputs from a seed with NumPy; tolerances
stated per test):

- the E6-B codes of PRN 1-50, the SignalDef, the constants and the
  engines' sub-chip tables, bit for bit;
- nav/reed_solomon.py: the generator, encode, and decode with erasures
  only, with errors and erasures, and with too many errors;
- nav/cnav_e6.py: pages encoded, decoded with noise, and the streaming
  decoder at an offset and inverted, event for event;
- nav/has.py: MT1 pack/parse of every section, the page encoder with
  parity PIDs, and message assembly across channels from parity PIDs;
- GalileoE6bTelemetryDecoder with a GalileoTowMap in odd chunk sizes, and
  the receiver's per-epoch sample counter rebuilt from decimated rows;
- the host simulator and K6's plain version on E6 satellites;
- the cold E6 search at 12.5 Msps and a block chunk at E = 20 with the
  rectified lock test;
- the chain builder through interop (the factory's order is
  tests/test_torch_l2c.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.nav import cnav_e6 as jcnav
from gnss_sim_receiver_tpu.nav import has as jhas
from gnss_sim_receiver_tpu.nav import reed_solomon as jrs
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu_torch import constants, interop, signals
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.nav import cnav_e6 as pcnav
from gnss_sim_receiver_tpu_torch.nav import has as phas
from gnss_sim_receiver_tpu_torch.nav import reed_solomon as prs
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from tests.test_torch_device_generator import _assert_agrees
from tests.test_torch_glonass import _armed
from tests.test_torch_tracking import _compare_outputs

FS = 12_500_000.0                 # tests/test_e6_has.py's rate
F_E6 = 1278.75e6
PRNS = [11, 13]
DOPS = [-2200.0, 1650.0]
DELAYS = [1234, 9017]             # samples at FS


def _sat_mask(prns):
    m = 0
    for p in prns:
        m |= 1 << (40 - p)
    return m


def _has_fixture(mod):
    """tests/test_e6_has.py:_has_fixture in either package: every MT1
    section (mask, orbit, clock full set and subset, code and phase
    biases) over two systems."""
    d = mod.HasData()
    d.header = mod.HasHeader(
        toh=450, mask_flag=True, orbit_correction_flag=True,
        clock_fullset_flag=True, clock_subset_flag=True,
        code_bias_flag=True, phase_bias_flag=True, mask_id=9,
        iod_set_id=3)
    d.nsys = 2
    d.gnss_id_mask = [mod.GPS_SYSTEM, mod.GALILEO_SYSTEM]
    d.satellite_mask = [_sat_mask([1, 3, 5]), _sat_mask([2, 4])]
    d.signal_mask = [0b1100000000000000, 0b1010000000000000]
    d.cell_mask_flag = [False, True]
    d.cell_mask = [np.ones((3, 2), bool), np.array([[1, 0], [1, 1]], bool)]
    d.nav_message = [0, 0]
    d.validity_orbit = 5
    d.gnss_iod = [17, 18, 19, 257, 258]
    d.delta_radial_m = [0.1, -0.2, 0.3, 0.05, -0.0725]
    d.delta_in_track_m = [0.4, -0.8, 0.16, 0.024, -0.032]
    d.delta_cross_track_m = [0.08, 0.016, -0.24, 0.8, 0.056]
    d.validity_clock = 2
    d.delta_clock_multiplier = [1, 2]
    d.delta_clock_m = [0.05, -0.1, 0.0025, 0.01, -0.005]
    d.validity_clock_subset = 1
    d.nsys_sub = 1
    d.gnss_id_clock_subset = [mod.GPS_SYSTEM]
    d.multiplier_clock_subset = [2]
    d.satellite_submask = [0b101]
    d.delta_clock_subset_m = [[0.01, -0.02]]
    d.validity_code_bias = 9
    d.code_bias_m = [[0.5, -0.3], [0.2, 0.1], [-0.8, 0.04],
                     [1.2], [0.6, -0.02]]
    d.validity_phase_bias = 11
    d.phase_bias_cycles = [[0.25, -0.1], [0.0, 0.05], [-0.3, 0.12],
                           [0.07], [0.2, -0.01]]
    d.phase_discontinuity = [[0, 1], [2, 3], [1, 0], [2], [3, 0]]
    return d


def _same_has(a, b):
    """Two HasData equal field by field: the header's fields exactly, the
    corrections within 1e-12, the masks and lists exactly."""
    assert dataclasses.asdict(a.header) == dataclasses.asdict(b.header)
    for f in dataclasses.fields(b):
        if f.name == "header":
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name.endswith(("_m", "_cycles")):
            flat = (np.concatenate(va) if va and isinstance(va[0], list)
                    else np.asarray(va, np.float64))
            flat_b = (np.concatenate(vb) if vb and isinstance(vb[0], list)
                      else np.asarray(vb, np.float64))
            np.testing.assert_allclose(flat, flat_b, atol=1e-12,
                                       err_msg=f.name)
        elif f.name == "cell_mask":
            assert all(np.array_equal(x, y) for x, y in zip(va, vb))
            assert len(va) == len(vb)
        else:
            assert va == vb, f.name


# ---- codes -----------------------------------------------------------------

def test_codes_and_tables_equal_jax():
    """PRN 1-50 of the E6-B memory code bit for bit (the port's own table),
    the SignalDef, the sub-chip tables and the constants."""
    for prn in range(1, 51):
        assert np.array_equal(signals.galileo_e6_code(prn),
                              jsig.galileo_e6_code(prn, "B"))
        assert np.array_equal(
            signals.subchip_table(signals.GALILEO_E6B, prn),
            jsig.subchip_table(jsig.GALILEO_E6B, prn))
    assert dataclasses.astuple(signals.GALILEO_E6B) == \
        dataclasses.astuple(jsig.GALILEO_E6B)
    assert signals.SIGNALS["E6"] is signals.GALILEO_E6B
    for name in ("GALILEO_E6_FREQ_HZ", "GALILEO_E6_CODE_RATE_CPS",
                 "GALILEO_E6_CODE_LENGTH_CHIPS"):
        assert getattr(constants, name) == getattr(jconst, name), name


# ---- nav/reed_solomon.py ---------------------------------------------------

def test_rs_generator_and_encode_like_jax():
    """The field tables and the generator polynomial equal JAX's, e_0's
    parity the reference's generator-matrix column
    (tests/test_e6_has.py), and 20 random words encode alike."""
    assert np.array_equal(prs._EXP, jrs._EXP)
    assert np.array_equal(prs._LOG, jrs._LOG)
    assert np.array_equal(prs._GENPOLY, jrs._GENPOLY)
    info = np.zeros(32, np.int64)
    info[0] = 1
    assert prs.encode(info)[32:47].tolist() == [
        19, 27, 98, 95, 172, 117, 243, 90, 164, 211, 220, 110, 164, 251, 116]
    rng = np.random.default_rng(1)
    for _ in range(20):
        info = rng.integers(0, 256, 32)
        assert np.array_equal(prs.encode(info), jrs.encode(info))


@pytest.mark.parametrize("case", ["erasures", "errors_and_erasures",
                                  "too_many_errors", "too_many_erasures"])
def test_rs_decode_like_jax(case):
    """Erasures only (any 32 of 255 kept), 50 erasures with 10 errors, 120
    errors beside 30 erasures (past the code's reach), and 20 known
    symbols of 32: both packages give the same word, the codeword where it
    is decodable, None where it is not."""
    rng = np.random.default_rng({"erasures": 7, "errors_and_erasures": 8,
                                 "too_many_errors": 10,
                                 "too_many_erasures": 9}[case])
    cw = prs.encode(rng.integers(0, 256, 32))
    if case == "erasures":
        keep = rng.choice(255, 32, replace=False)
        rx = np.zeros(255, np.int64)
        rx[keep] = cw[keep]
        eras = sorted(set(range(255)) - set(keep.tolist()))
    elif case == "errors_and_erasures":
        rx = cw.copy()
        eras = rng.choice(255, 50, replace=False).tolist()
        rx[eras] = 0
        for p in rng.choice(255, 10, replace=False):
            if p not in eras:
                rx[p] ^= int(rng.integers(1, 256))
    elif case == "too_many_errors":
        pos = rng.choice(255, 150, replace=False)
        eras, errs = pos[:30].tolist(), pos[30:]
        rx = cw.copy()
        rx[errs] ^= rng.integers(1, 256, len(errs))
    else:
        rx = np.zeros(255, np.int64)
        rx[:20] = cw[:20]
        eras = list(range(20, 255))
    got, want = prs.decode(rx, eras), jrs.decode(rx, eras)
    if case == "too_many_errors":
        # past the reach: a refusal or a wrong codeword, the same in both
        assert (got is None and want is None) or (
            np.array_equal(got, want) and not np.array_equal(got, cw))
    elif case == "too_many_erasures":
        assert got is None and want is None
    else:
        assert np.array_equal(got, want) and np.array_equal(got, cw)


# ---- nav/cnav_e6.py --------------------------------------------------------

def test_pages_like_jax():
    """encode_page on random octets and headers, decode_page_symbols on the
    page with noise (crc ok, equal events), a flipped-CRC page refused in
    both, and the epoch signs."""
    rng = np.random.default_rng(2)
    for pid in (1, 33, 200):
        octets = rng.integers(0, 256, 53)
        kw = dict(has_status=1, message_type=1, message_id=7,
                  message_size=3, message_page_id=pid)
        sym = pcnav.encode_page(pcnav.HasPageHeader(**kw), octets)
        assert np.array_equal(sym, jcnav.encode_page(
            jcnav.HasPageHeader(**kw), octets))
        soft = (2.0 * sym[16:] - 1.0) + 0.6 * rng.standard_normal(984)
        evs = [pcnav.decode_page_symbols(soft),
               jcnav.decode_page_symbols(soft)]
        assert evs[0].crc_ok and evs[1].crc_ok
        assert dataclasses.asdict(evs[0].header) == \
            dataclasses.asdict(evs[1].header) == dict(kw, reserved=0)
        assert np.array_equal(evs[0].octets, evs[1].octets)
        assert np.array_equal(evs[0].octets, octets)
        bad = soft.copy()
        bad[100:140] = -bad[100:140]
        assert not pcnav.decode_page_symbols(bad).crc_ok
        assert not jcnav.decode_page_symbols(bad).crc_ok
    assert np.array_equal(pcnav.e6b_epoch_signs(sym),
                          jcnav.e6b_epoch_signs(sym))


def _page_events(evs):
    return [(dataclasses.asdict(e.header), e.octets.tolist(),
             e.start_symbol, e.crc_ok) for e in evs]


@pytest.mark.parametrize("invert", [False, True])
def test_streaming_page_decoder_like_jax(invert):
    """CnavPageDecoder on six pages cut 377 symbols in, noisy, in random
    chunks: the same events, page for page."""
    pages = phas.mt1_to_pages(_has_fixture(phas), message_id=4,
                              pids=[1, 2, 3, 40, 41, 250])
    s = 2.0 * (2.0 * np.concatenate(pages) - 1.0)[377:]
    if invert:
        s = -s
    rng = np.random.default_rng(3)
    s = s + 0.7 * rng.standard_normal(len(s))
    chunks = rng.integers(100, 900, 20)
    out = []
    for dec in (pcnav.CnavPageDecoder(), jcnav.CnavPageDecoder()):
        evs, i = [], 0
        for n in chunks:
            evs.extend(dec.push_symbols(s[i:i + n]))
            i += n
        out.append(_page_events(evs))
    assert out[0] == out[1]
    assert sum(e[3] for e in out[0]) >= 4


# ---- nav/has.py ------------------------------------------------------------

def test_mt1_pack_parse_like_jax():
    """pack_mt1 of the fixture's every section: the same bits; parse_mt1
    of them: the same HasData field by field (corrections within 1e-12),
    and the fixture back."""
    bits = phas.pack_mt1(_has_fixture(phas))
    assert np.array_equal(bits, jhas.pack_mt1(_has_fixture(jhas)))
    got, want = phas.parse_mt1(bits), jhas.parse_mt1(bits)
    _same_has(got, want)
    _same_has(got, _has_fixture(phas))
    assert got.prns(0) == [1, 3, 5] and got.prns(1) == [2, 4]
    assert got.sats_per_system() == [3, 2]


def test_has_assembly_from_parity_pages_like_jax():
    """The message's pages from three satellites, each sending different
    PIDs (parity PIDs above 32 among them) and none enough alone, through
    each channel's streaming decoder into one assembler: the port rebuilds
    the planted message by Reed-Solomon erasure decoding, equal field by
    field to JAX's parse of JAX's bits.  The pages equal JAX's, and a
    C-matrix column decodes to JAX's word at the assembler's 223 erasures
    (JAX's assembler takes ~70 s of CPU a message, so it runs one column
    here)."""
    d = _has_fixture(phas)
    size = len(phas.mt1_to_pages(d, message_id=14))
    assert size >= 2
    per_sat = [[2], [140], [33]]
    assert all(len(p) < size for p in per_sat)
    rng = np.random.default_rng(5)
    asm = phas.HasMessageAssembler()
    for pids in per_sat:
        pages = phas.mt1_to_pages(d, message_id=14, pids=pids)
        for mine, theirs in zip(pages, jhas.mt1_to_pages(
                _has_fixture(jhas), message_id=14, pids=pids)):
            assert np.array_equal(mine, theirs)
        dec = pcnav.CnavPageDecoder()
        soft = (1.0 - 2.0 * np.concatenate(pages + pages[:1])) * 2.0
        soft = soft + 0.7 * rng.standard_normal(len(soft))
        for ev in dec.push_symbols(soft):
            asm.push_page(ev)
    assert len(asm.messages) == 1
    _same_has(asm.messages[0],
              jhas.parse_mt1(jhas.pack_mt1(_has_fixture(jhas))))
    # one column as the assembler decodes it: PIDs 2 and 140 received (the
    # first `size` distinct ones), the rows past `size` known zero
    info = np.zeros(32, np.int64)
    info[:size] = rng.integers(0, 256, size)
    cw = prs.encode(info)
    rx = np.zeros(255, np.int64)
    got_pids = [2, 140]
    rx[[p - 1 for p in got_pids]] = cw[[p - 1 for p in got_pids]]
    eras = [p - 1 for p in range(1, 256)
            if p not in got_pids and not size < p <= 32]
    assert len(eras) == 255 - 2 - (32 - size) == 223
    got, want = prs.decode(rx, eras), jrs.decode(rx, eras)
    assert np.array_equal(got, want) and np.array_equal(got, cw)
    # the assembler's batched decode: each row decode()'s word (at 223
    # erasures the 32 known symbols fix a codeword, so an altered one
    # decodes to another), and row by row at other erasure counts
    other = rx.copy()
    other[1] ^= 9
    cols = prs.decode_columns(np.stack([rx, other, rx]), eras)
    assert cols.shape == (3, 255)
    assert (cols[[0, 2]] == want).all()
    assert np.array_equal(cols[1], prs.decode(other, eras))
    row_by_row = prs.decode(rx, eras[1:])
    got = prs.decode_columns(rx[None], eras[1:])
    assert (got is None and row_by_row is None) or np.array_equal(
        got[0], row_by_row)


# ---- the telemetry decoder and the TOW map ---------------------------------

def _run_e6(dec, soft, chunks, nominal, sc0):
    tow, i = [], 0
    for n in chunks:
        chunk = soft[i:i + n]
        sc = sc0 + (np.arange(i, i + len(chunk)) + 1) * nominal
        r = dec.process({"prompt": (chunk + 0j).reshape(-1, 1),
                         "valid": np.ones((len(chunk), 1), bool),
                         "sample_counter": sc.reshape(-1, 1)})
        assert r.new_ephemerides == []
        tow.append(r.tow_at_epoch_ms[:, 0])
        i += n
    return np.concatenate(tow)


def test_telemetry_decoder_with_tow_map_like_jax():
    """GalileoE6bTelemetryDecoder in both packages on 25 pages of one PID
    as 1 ms prompts, noisy, in odd chunks, PRN 7's TOW published once by
    another band at sample 1e6 (tests/test_e6_has.py's case) with a
    20 s age bound: equal TOW arrays (NaN pattern included: the epochs
    past the bound unstamped), each 1 ms an epoch from the published TOW
    (1e-9 ms), and the same CRC-clean pages.  (One PID never completes the
    two-page message, which JAX's assembler takes ~70 s of CPU to decode;
    the port's decoder alone then rebuilds it from both PIDs.)"""
    pages = phas.mt1_to_pages(_has_fixture(phas), message_id=1)
    assert len(pages) == 2
    signs = pcnav.e6b_epoch_signs(np.concatenate(pages[:1] * 25))
    rng = np.random.default_rng(6)
    soft = 3.0 * signs + rng.standard_normal(len(signs))
    chunks = rng.integers(301, 1999, 40) | 1
    nominal = FS * 1e-3
    outs = []
    for mod in (ptlm, jtlm):
        tow_map = mod.GalileoTowMap(fs=FS, max_age_s=20.0)
        tow_map.update(7, 100_000.0, 1_000_000.0)
        dec = mod.GalileoE6bTelemetryDecoder(prns=[7], tow_map=tow_map)
        tow = _run_e6(dec, soft, chunks, nominal, 1_000_000.0)
        assert dec.has.messages == []
        outs.append((tow, [(c, dataclasses.asdict(e.header),
                            e.octets.tolist(), e.start_symbol)
                           for c, e in dec.pages]))
    (tow_p, pages_p), (tow_j, pages_j) = outs
    assert np.array_equal(np.isnan(tow_p), np.isnan(tow_j))
    m = ~np.isnan(tow_p)
    assert np.array_equal(tow_p[m], tow_j[m])
    assert m[:19_999].all() and not m[20_000:].any()
    np.testing.assert_allclose(tow_p[m], 100_000.0 + np.flatnonzero(m) + 1,
                               atol=1e-9)
    assert pages_p == pages_j and len(pages_p) >= 20
    # both PIDs: the port's decoder rebuilds the message
    signs = pcnav.e6b_epoch_signs(np.concatenate(pages * 2))
    soft = 3.0 * signs + rng.standard_normal(len(signs))
    dec = ptlm.GalileoE6bTelemetryDecoder(prns=[7])
    tow = _run_e6(dec, soft, [1001, 1999, 1000], nominal, 0.0)
    assert np.isnan(tow).all()          # no map: no TOW
    assert len(dec.has.messages) == 2    # once per pair of PIDs
    for msg in dec.has.messages:
        _same_has(msg, jhas.parse_mt1(jhas.pack_mt1(_has_fixture(jhas))))
    # a map that no band published this PRN to: no TOW either
    dec = ptlm.GalileoE6bTelemetryDecoder(prns=[7],
                                          tow_map=ptlm.GalileoTowMap(FS))
    assert np.isnan(_run_e6(dec, soft[:3000], [1001, 1999], nominal,
                            0.0)).all()


def test_tow_map_across_rates_like_jax():
    """The receiver builds its TOW map at the primary rate (JAX
    models/receiver.py:672-678), but each chain publishes and reads its
    own sample counter (:1477-1486): an E1 chain at 4 Msps publishing and
    an E6 chain on another RF stream at 12.5 Msps reading the same
    instant (10 s into the capture) get the TOW 21.25 s late in both
    packages, and past the map's 30 s bound none at all (ROADMAP.md
    queue 3)."""
    got = []
    for mod in (ptlm, jtlm):
        tow_map = mod.GalileoTowMap(fs=4e6)
        tow_map.update(7, 345_610_000.0, 10.0 * 4e6)
        got.append((tow_map.tow_at_sample(7, 10.0 * 12.5e6),
                    tow_map.tow_at_sample(7, 20.0 * 12.5e6)))
    assert got[0] == got[1]
    assert got[0][0] == 345_610_000.0 + (125e6 - 40e6) / 4e6 * 1e3
    assert got[0][1] is None


def test_tail_chunk_raises_like_jax():
    """A receiver's tail chunk shorter than one tick stride reaches the
    telemetry without the sample counter (receiver.py's tail branch, in
    both packages); the E6-B decoder reads it for its TOW map, so both
    raise the same KeyError there (ROADMAP.md queue 3)."""
    soft = np.ones((7, 1), np.complex64)
    for mod in (ptlm, jtlm):
        dec = mod.GalileoE6bTelemetryDecoder(prns=[7])
        with pytest.raises(KeyError) as err:
            dec.process({"prompt": soft, "valid": np.ones((7, 1), bool)})
        assert err.value.args == ("sample_counter",)


def test_expand_sc_like_jax():
    """The per-epoch sample counter rebuilt from decimated rows (the rows
    the receiver keeps at a 20-epoch tick stride, the ends extrapolated at
    the nominal epoch length) equals JAX's."""
    rng = np.random.default_rng(9)
    rows = np.arange(7, 400, 20)
    sc = (12_500.0 * rows[:, None] + rng.normal(0.0, 0.3, (len(rows), 3))
          + np.array([0.0, 1e6, 2.5e6]))
    got = prx._expand_sc(sc, rows, 400, 12_500)
    want = jrx._expand_sc(sc, rows, 400, 12_500)
    assert got.shape == (400, 3) and np.array_equal(got, want)


# ---- the simulator ---------------------------------------------------------

def _sats(cls, n_epochs=60, seed=8, cn0=50.0):
    """Two E6 satellites with random C/NAV symbols as per-epoch signs,
    Doppler and code Doppler on E6's carrier."""
    rng = np.random.default_rng(seed)
    return [cls(prn=p, system="Galileo", signal="E6", cn0_db_hz=cn0,
                doppler_hz=d, code_doppler_hz=d, carrier_ref_hz=F_E6,
                delay_chips=n * 5.115e6 / FS,
                nav_bits=pcnav.e6b_epoch_signs(rng.integers(0, 2,
                                                            n_epochs)))
            for p, d, n in zip(PRNS, DOPS, DELAYS)]


def test_host_generator_equals_jax():
    """20 ms of the two satellites, noiseless, sample for sample."""
    n = int(0.02 * FS)
    want = jgen(_sats(JSat), FS, n, start_sample=777, noise=False)
    got = pgen(_sats(PSat), FS, n, start_sample=777, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    """K6's plain version against the JAX device generator on the two E6
    satellites over 0.05 s at 12.5 Msps (tests/test_device_generator.py's
    criteria), the anchors bit for bit."""
    nblk = int(0.05 * FS) // 8192
    want = jdg.generate_baseband_device(_sats(JSat), FS, nblk * 8192,
                                        noise=False)
    got = pdg.generate_baseband_device_resident(
        _sats(PSat), FS, nblk * 8192, noise=False, device="cpu").numpy()
    _assert_agrees(got, want)
    for w, g in zip(jdg._anchors(_sats(JSat), FS, 0, nblk, None),
                    pdg._anchors(_sats(PSat), FS, 0, nblk, None)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- acquisition and tracking ----------------------------------------------

def test_acquisition_matches_jax():
    """galileo_e6b_chain's cold search (two 1 ms dwells, D = 41 at 250 Hz,
    N = 12500, then 62.5 Hz) on 4 ms of the two satellites in noise, PRN 9
    absent: the same detections, Doppler and delay, the statistic to
    1e-4; each PRN within 3 samples and one step-one bin of its truth (a
    symbol flips every epoch, so a dwell cut by a flip widens the peak:
    PRN 11 lands 137.5 Hz off in both packages)."""
    chain = prx.galileo_e6b_chain(FS)
    jchain = jrx.galileo_e6b_chain(FS)
    x = jgen(_sats(JSat), FS, int(0.004 * FS), noise=True, seed=12)
    je = jacq.PcpsAcquisitionEngine(
        jchain.acq, prns=[11, 13, 9], code_provider=jchain.code_provider,
        sc_rate=jchain.sc_rate)
    pe = pacq.PcpsAcquisitionEngine(
        chain.acq, prns=[11, 13, 9], code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, device="cpu")
    assert pe.fft_size == je.fft_size == 12_500
    want, got = je.acquire(x), pe.acquire(x)
    assert list(got.detected) == list(want.detected) == [True, True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    for k in range(2):
        assert abs(got.doppler_hz[k] - DOPS[k]) <= 250.0
        err = abs(got.delay_samples[k] - DELAYS[k]) % 12_500
        assert min(err, 12_500 - err) <= 3.0


def test_block_chunk_matches_jax():
    """The block step at E6's shape (12.5 Msps, E = 20 epochs a block, the
    rectified lock test), 3 blocks (60 ms) from the armed state on the
    noise-free pair, with tests/test_torch_tracking.py's per-epoch
    tolerances (prompt max 2 %, median 0.2 % of the mean prompt; epoch
    ends within one sample; Doppler within 0.2 Hz; code boundary within
    0.05 sample); the replica spectra equal."""
    s0, n_blk, e_blk = 12_500, 3, 20
    x = jgen(_sats(JSat), FS, max(DELAYS) + (n_blk * e_blk + 4) * s0 + 8192,
             noise=False)
    jconf = jrx.galileo_e6b_chain(FS).trk
    pconf = prx.galileo_e6b_chain(FS).trk
    for f in dataclasses.fields(pconf):
        assert getattr(pconf, f.name) == getattr(jconf, f.name), f.name
    assert pconf.lock_rectify
    eng = ptrk.TrackingEngine(pconf, PRNS, device="cpu",
                              code_provider=signals.CodeProvider("E6"))
    assert eng.block_epochs == e_blk
    st = _stack(*(_armed(jconf, d, n) for d, n in zip(DOPS, DELAYS)))
    pst = interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                         "cpu")
    tables = np.stack([jpc.bandlimited_table_normalized(
        jsig.galileo_e6_code(p, "B"), FS, jconf.code_rate_cps, s0)
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
    assert not dp["lock_lost"].any()


def _stack(*states):
    """Single-channel JAX track states as one state of as many channels."""
    return jax.tree_util.tree_map(lambda *v: jnp.concatenate(v), *states)


# ---- the chain -------------------------------------------------------------

def test_chain_conf_like_jax():
    """galileo_e6b_chain gives the JAX chain (compared through interop) at
    its defaults and with PRNs and a count; E6 waits for another Galileo
    band's assistance; its decoder is the E6-B one, with no TOW map until
    a receiver gives it one."""
    for kw in ({}, dict(prns=(11, 13), n_channels=2)):
        ref = jrx.galileo_e6b_chain(FS, **kw)
        got = prx.galileo_e6b_chain(FS, **kw)
        assert got == interop._chain_from_fields(dataclasses.asdict(ref),
                                                 "galileo_e6b_chain")
    assert (got.signal, got.system, got.assist_wait) == ("E6", "Galileo",
                                                         True)
    assert got.code_provider == signals.CodeProvider("E6")
    dec = got.telemetry_decoder([0, 0])
    assert isinstance(dec, ptlm.GalileoE6bTelemetryDecoder)
    assert dec.tow_map is None
    conf = prx.ReceiverConf(fs=FS, gps_chain=False,
                            chains=(prx.galileo_e1b_chain(FS), got))
    rx = prx.Receiver(conf, device="cpu").start_session()
    e6 = [rt for rt in rx.chains if rt.spec.signal == "E6"][0]
    assert e6.tlm.tow_map is rx.tow_map and rx.tow_map.fs == FS
