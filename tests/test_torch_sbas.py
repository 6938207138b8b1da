"""The SBAS L1 chain of the PyTorch port against the JAX package on the
CPU, at small sizes (inputs from a seed with NumPy; tolerances stated per
test):

- the SBAS codes of PRN 120-138, the SignalDef and the engines' sub-chip
  tables, bit for bit;
- nav/sbas.py: the 250-bit framing, every message type's pack and parse,
  the symbol stream (the port's nav/fec.py against JAX's native encoder),
  the streaming decoder at both polarities and an odd start, the
  corrections state and the GEO ephemeris adapter;
- SbasL1TelemetryDecoder over the same prompt planes in several chunk
  splits: messages, pairing phase, MT12 TOW columns; a stream too sparse
  for the pairing vote;
- the receiver's SBAS and broadcast-iono feeds, and the GEO as a ranging
  source (it raises in both packages);
- the host simulator and K6's plain version on an S1 satellite, the
  acquisition at 2 Msps and a block chunk at the GPS C/A 1 ms shape with
  the rectified lock test;
- the chain builder through interop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import observables as jobs
from gnss_sim_receiver_tpu.models import pvt as jpvt
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.nav import ephemeris as jeph
from gnss_sim_receiver_tpu.nav import sbas as jsbas
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu_torch import interop, signals
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import observables as pobs
from gnss_sim_receiver_tpu_torch.models import pvt as ppvt
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from gnss_sim_receiver_tpu_torch.nav import sbas as psbas
from gnss_sim_receiver_tpu_torch.ops import prn_codes as ppc
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from tests.test_torch_device_generator import _assert_agrees
from tests.test_torch_glonass import _armed
from tests.test_torch_tracking import _compare_outputs

FS = 2_000_000.0                  # phase 4's rate after the x2 FIR
T0 = 345600.0
PRNS = [122, 133]
DOPS = [950.0, -1370.0]
DELAYS = [611, 1517]              # samples at FS


# ---- codes ------------------------------------------------------------------

def test_codes_and_tables_equal_jax():
    """Every SBAS PRN's code and the engines' sub-chip table, bit for bit;
    the SignalDef field for field; the same refusal outside 120-138."""
    for prn in range(120, 139):
        want = jpc.sbas_l1_code(prn)
        got = ppc.sbas_l1_code(prn)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(signals.subchip_table(signals.SBAS_L1, prn),
                              jsig.subchip_table(jsig.SBAS_L1, prn))
        assert np.array_equal(signals.CodeProvider("S1")(prn), want)
    assert dataclasses.astuple(signals.SBAS_L1) == \
        dataclasses.astuple(jsig.SBAS_L1)
    assert signals.SIGNALS["S1"] is signals.SBAS_L1
    for mod in (ppc, jpc):
        with pytest.raises(ValueError, match="SBAS PRN out of range"):
            mod.sbas_l1_code(119)


# ---- messages ---------------------------------------------------------------

def test_message_framing_like_jax():
    """pack_message over the three preambles, unpack_message of it and of
    a copy with one bit flipped, bit for bit."""
    rng = np.random.default_rng(0)
    for k in range(4):
        payload = rng.integers(0, 2, 212)
        want = jsbas.pack_message(17 + k, payload, preamble_idx=k)
        got = psbas.pack_message(17 + k, payload, preamble_idx=k)
        assert np.array_equal(got, want)
        for msg in (want, np.where(np.arange(250) == 90 + k, 1 - want,
                                   want)):
            ok_j, mt_j, pl_j = jsbas.unpack_message(msg)
            ok_p, mt_p, pl_p = psbas.unpack_message(msg)
            assert (ok_p, mt_p) == (ok_j, mt_j)
            assert np.array_equal(pl_p, pl_j)
    assert not jsbas.unpack_message(msg)[0]


def _geo_nav(mod, rng):
    return mod.SbasGeoNav(
        iodn=int(rng.integers(0, 256)), t0_s=16.0 * rng.integers(0, 5400),
        ura=int(rng.integers(0, 16)),
        pos_m=tuple(rng.uniform(-4e7, 4e7, 2)) + (rng.uniform(-6e6, 6e6),),
        vel_ms=tuple(rng.uniform(-30, 30, 2)) + (rng.uniform(-200, 200),),
        acc_ms2=tuple(rng.uniform(-6e-3, 6e-3, 2))
        + (rng.uniform(-0.03, 0.03),),
        agf0_s=rng.uniform(-9e-7, 9e-7), agf1_ss=rng.uniform(-1e-10, 1e-10))


def _payloads(mod, seed: int):
    """(msg_type, payload, parsed) of every type the module packs, from
    one seed."""
    rng = np.random.default_rng(seed)
    prns = sorted(rng.choice(np.arange(1, 211), 9, replace=False).tolist())
    out = [(1, mod.pack_mt1(prns, iodp=2))]
    for mt in (2, 3, 4, 5):
        prc = (rng.integers(-2047, 2048, 13) * 0.125).tolist()
        out.append((mt, mod.pack_mt2(prc, mt=mt, iodf=mt - 2, iodp=1)))
    out.append((9, mod.pack_mt9(_geo_nav(mod, rng))))
    out.append((12, mod.pack_mt12(float(rng.integers(0, 604800)),
                                  week=int(rng.integers(0, 1024)))))
    out.append((18, mod.pack_mt18(3, sorted(rng.choice(
        201, 30, replace=False).tolist()), n_bands=4, iodi=1)))
    out.append((26, mod.pack_mt26(3, 1, (rng.integers(0, 512, 15)
                                         * 0.125).tolist(), iodi=1)))
    halves = [mod.SbasLongTerm(slot=int(rng.integers(1, 52)),
                               iode=int(rng.integers(0, 256)),
                               dpos_m=tuple(rng.integers(-255, 256, 3)
                                            * 0.125),
                               daf0_s=float(rng.integers(-511, 512))
                               * 2.0 ** -31) for _ in range(2)]
    out.append((25, mod.pack_mt25(halves, iodp=3)))
    return out


_PARSE = {1: "parse_mt1", 2: "parse_mt2", 3: "parse_mt2", 4: "parse_mt2",
          5: "parse_mt2", 9: "parse_mt9", 12: "parse_mt12",
          18: "parse_mt18", 25: "parse_mt25", 26: "parse_mt26"}


@pytest.mark.parametrize("seed", [1, 2])
def test_payloads_like_jax(seed):
    """MT1, 2-5, 9, 12, 18, 25 and 26: the port's payload bits equal JAX's
    for the same fields, and each parser gives JAX's values for them."""
    want, got = _payloads(jsbas, seed), _payloads(psbas, seed)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (mt, pw), (_, pg) in zip(want, got):
        assert pg.shape == (212,) and np.array_equal(pg, pw), mt
        rj = getattr(jsbas, _PARSE[mt])(pw)
        rp = getattr(psbas, _PARSE[mt])(pw)
        if mt == 9:
            assert dataclasses.astuple(rp) == dataclasses.astuple(rj)
            t = rj.t0_s + 321.5
            assert np.array_equal(psbas.geo_nav_pos(rp, t),
                                  jsbas.geo_nav_pos(rj, t))
        elif mt == 25:
            assert [dataclasses.astuple(v) for v in rp] == \
                [dataclasses.astuple(v) for v in rj]
        else:
            assert rp == rj, mt


def _messages(mod, seed: int = 3, tow: float = T0 + 7.0):
    """A message sequence with MT12 (GPS time), MT9, corrections and an
    MT12 again, each a second."""
    out = _payloads(mod, seed)
    by_mt = dict(out)
    return [(12, mod.pack_mt12(tow)), (9, by_mt[9]), (1, by_mt[1]),
            (2, by_mt[2]), (12, mod.pack_mt12(tow + 4.0)), (25, by_mt[25]),
            (18, by_mt[18])]


def test_symbols_for_messages_like_jax():
    """The continuous 500-sps stream (one encoder across the messages,
    preambles cycling from 1): the port's nav/fec.py encoder against JAX's
    native one, bit for bit; the per-epoch signs too."""
    want = jsbas.symbols_for_messages(_messages(jsbas), first_preamble_idx=1)
    got = psbas.symbols_for_messages(_messages(psbas), first_preamble_idx=1)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (7 * 500,)
    sj, sp = jsbas.sbas_epoch_signs(want), psbas.sbas_epoch_signs(got)
    assert sp.dtype == sj.dtype and np.array_equal(sp, sj)


def _event_tuple(ev):
    return (ev.msg_type, ev.payload.tolist(), ev.start_symbol,
            ev.preamble_idx, ev.crc_ok)


@pytest.mark.parametrize("sign,lead", [(1.0, 0), (-1.0, 3)])
def test_message_decoder_like_jax(sign, lead):
    """SbasMessageDecoder on the same noisy soft symbols, upright and
    inverted with an odd number of leading symbols, pushed in uneven
    pieces: the same events (type, payload, start symbol, preamble, CRC)
    and the same MT9 navigation."""
    rng = np.random.default_rng(4)
    syms = jsbas.symbols_for_messages(_messages(jsbas))
    soft = sign * np.concatenate([
        rng.standard_normal(lead) * 0.1,
        (2.0 * syms - 1.0) * 2.0 + rng.standard_normal(len(syms)) * 0.8])
    decs = (jsbas.SbasMessageDecoder(), psbas.SbasMessageDecoder())
    events = ([], [])
    for a, b in ((0, 333), (333, 1900), (1900, len(soft))):
        for dec, evs in zip(decs, events):
            evs.extend(dec.push_symbols(soft[a:b]))
    assert len(events[0]) >= 5
    assert [_event_tuple(e) for e in events[1]] == \
        [_event_tuple(e) for e in events[0]]
    assert dataclasses.astuple(decs[1].geo_nav) == \
        dataclasses.astuple(decs[0].geo_nav)
    assert (decs[1].base, len(decs[1].sym)) == (decs[0].base,
                                                len(decs[0].sym))


@pytest.mark.parametrize("splits", [(803,), (97, 1500, 64, 2501),
                                    (40, 700)])
def test_telemetry_decoder_like_jax(splits):
    """SbasL1TelemetryDecoder on the same prompt planes (two channels: one
    at an odd epoch offset with invalid leading rows, one inverted) cut
    into chunks of the given sizes, repeated: after every chunk the same
    pairing vote (a first chunk of 40 epochs leaves it under its 64), at
    the end the same messages, pairing phase, MT12 anchor and TOW columns
    (the NaN pattern equal, values within 1e-9 ms)."""
    rng = np.random.default_rng(5)
    epochs = jsbas.sbas_epoch_signs(
        jsbas.symbols_for_messages(_messages(jsbas))).astype(np.float64)
    n = len(epochs) + 1
    a = np.concatenate([[0.4], 3.0 * epochs])
    b = np.concatenate([-3.0 * epochs, [0.0]])
    prompt = np.stack([a, b], axis=1) + rng.standard_normal((n, 2)) * 0.7 \
        + 1j * rng.standard_normal((n, 2))
    valid = np.ones((n, 2), bool)
    valid[:8, 0] = False
    decs = (jtlm.SbasL1TelemetryDecoder(prns=PRNS),
            ptlm.SbasL1TelemetryDecoder(prns=PRNS))
    tows = ([], [])
    i = k = 0
    while i < n:
        m = min(splits[k % len(splits)], n - i)
        for dec, tow in zip(decs, tows):
            out = dec.process({"prompt": prompt[i:i + m],
                               "valid": valid[i:i + m]})
            assert np.array_equal(out.tow_valid, ~np.isnan(
                out.tow_at_epoch_ms))
            tow.append(out.tow_at_epoch_ms)
        assert [(c.phase, c.n_voted) for c in decs[1].ch] == \
            [(c.phase, c.n_voted) for c in decs[0].ch]
        i += m
        k += 1
    jd, pd = decs
    assert [(c, p) + _event_tuple(e) for c, p, e in pd.messages] == \
        [(c, p) + _event_tuple(e) for c, p, e in jd.messages]
    assert sum(e.msg_type == 12 for _, _, e in jd.messages) >= 3
    for c in range(2):
        assert (pd.ch[c].phase, pd.ch[c].anchor_epoch,
                pd.ch[c].anchor_tow_ms) == (jd.ch[c].phase,
                                            jd.ch[c].anchor_epoch,
                                            jd.ch[c].anchor_tow_ms)
        assert dataclasses.astuple(pd.geo_nav(c)) == \
            dataclasses.astuple(jd.geo_nav(c))
    assert [jd.ch[c].phase for c in range(2)] == [1, 0]
    tj, tp = np.concatenate(tows[0]), np.concatenate(tows[1])
    assert np.array_equal(np.isnan(tp), np.isnan(tj))
    assert (~np.isnan(tj)).sum() > 2000
    assert np.nanmax(np.abs(tp - tj)) <= 1e-9


def test_sparse_stream_leaves_the_pairing_undecided_like_jax():
    """The epoch-pairing vote decides only when the two alignments'
    products differ by half the larger, which needs symbol changes at a
    quarter of the boundaries: a stream of null messages (MT63, zero
    payloads) changes at fewer, and neither package ever pairs its epochs
    or decodes a message (the reference's behaviour, kept; ROADMAP.md
    queue 3).  The same stream with random payloads decodes; with sparse
    ones (a bit set at 8 %: changes at 22 % of the boundaries) it does
    not."""
    rng = np.random.default_rng(9)
    for payload, decodes in ((lambda: np.zeros(212, np.int64), False),
                             (lambda: rng.integers(0, 2, 212), True),
                             (lambda: (rng.random(212) < 0.08).astype(
                                 np.int64), False)):
        msgs = [(63, payload()) for _ in range(6)]
        syms = jsbas.symbols_for_messages(msgs)
        assert (np.mean(syms[1:] != syms[:-1]) > 0.25) == decodes
        soft = 3.0 * jsbas.sbas_epoch_signs(syms) + rng.standard_normal(
            2 * len(syms)) * 0.5
        outs = {"prompt": (soft + 0j).reshape(-1, 1),
                "valid": np.ones((len(soft), 1), bool)}
        decs = (jtlm.SbasL1TelemetryDecoder(prns=[133]),
                ptlm.SbasL1TelemetryDecoder(prns=[133]))
        for dec in decs:
            dec.process(outs)
        jd, pd = decs
        assert (pd.ch[0].phase, pd.ch[0].n_voted) == (jd.ch[0].phase,
                                                      jd.ch[0].n_voted)
        assert len(pd.messages) == len(jd.messages)
        assert (jd.ch[0].phase is not None) == bool(jd.messages) == decodes


# ---- corrections ------------------------------------------------------------

def _correction_events(mod):
    """Events that fill every part of the state: the mask, fast
    corrections over two blocks, long-term halves, an MT26 before its
    band's mask (dropped), two bands of masks and delays."""
    rng = np.random.default_rng(6)

    def ev(mt, payload):
        return mod.SbasMessageEvent(msg_type=mt, payload=payload,
                                    start_symbol=0, preamble_idx=0,
                                    crc_ok=True)
    evs = [ev(26, mod.pack_mt26(2, 0, [9.0] * 15)),
           ev(1, mod.pack_mt1(list(range(1, 17)) + [120, 133]))]
    for mt in (2, 3):
        evs.append(ev(mt, mod.pack_mt2(
            (rng.integers(-400, 400, 13) * 0.125).tolist(), mt=mt)))
    evs.append(ev(25, mod.pack_mt25([
        mod.SbasLongTerm(slot=3, iode=5, dpos_m=(1.5, -2.0, 0.625),
                         daf0_s=3e-8),
        mod.SbasLongTerm(slot=14, iode=9, dpos_m=(-4.0, 0.125, 2.0),
                         daf0_s=-1e-8)])))
    n_igp = mod.IGP_LONS_PER_BAND * len(mod.IGP_LATS)
    for band in (2, 3):
        evs.append(ev(18, mod.pack_mt18(band, list(range(0, n_igp, 1)))))
        for blk in range((n_igp + 14) // 15):
            evs.append(ev(26, mod.pack_mt26(
                band, blk, (rng.integers(0, 160, 15) * 0.125).tolist())))
    return evs


def test_corrections_like_jax():
    """SbasCorrections fed the same events: the same state, and every
    query within 1e-9 m (1e-18 s for the clock): the fast correction of
    PRNs 1-40, the long-term deltas, the slant iono delay over a pierce
    point and elevation grid (None where a cell is not monitored, in both
    packages alike); SbasGeoEphemeris's position, clock and velocity."""
    cj, cp = jsbas.SbasCorrections(), psbas.SbasCorrections()
    for ej, ep in zip(_correction_events(jsbas), _correction_events(psbas)):
        cj.push(ej)
        cp.push(ep)
    assert cp.prn_mask == cj.prn_mask and cp.fast_prc == cj.fast_prc
    assert cp.igp_mask == cj.igp_mask and cp.iono == cj.iono
    assert len(cj.iono) == 2 * 184 and len(cj.long_term) == 2
    for prn in range(1, 41):
        assert abs(cp.code_correction_m(prn)
                   - cj.code_correction_m(prn)) <= 1e-9
        lj, lp = cj.sat_correction(prn), cp.sat_correction(prn)
        assert (lj is None) == (lp is None)
        if lj is not None:
            assert np.abs(lp[0] - lj[0]).max() <= 1e-9
            assert abs(lp[1] - lj[1]) <= 1e-18
    n_none = 0
    for lat in np.linspace(-62.0, 62.0, 23):
        for lon in np.linspace(-105.0, -55.0, 17):
            for el in (0.1, 0.5, 1.2):
                vj = cj.iono_delay_m(lat, lon, el)
                vp = cp.iono_delay_m(lat, lon, el)
                assert (vj is None) == (vp is None)
                if vj is None:
                    n_none += 1
                else:
                    assert abs(vp - vj) <= 1e-9
    assert 0 < n_none < 23 * 17 * 3
    rng = np.random.default_rng(7)
    nav_j, nav_p = _geo_nav(jsbas, rng), _geo_nav(psbas,
                                                   np.random.default_rng(7))
    gj = jsbas.SbasGeoEphemeris(135, nav_j)
    gp = psbas.SbasGeoEphemeris(135, nav_p)
    assert (gp.system, gp.prn, gp.tgd, gp.toe, gp.week) == \
        (gj.system, gj.prn, gj.tgd, gj.toe, gj.week)
    for dt in (-300.0, 0.0, 77.25, 900.0):
        t = nav_j.t0_s + dt
        (pj, kj), (pp, kp) = gj.sat_pos_clock(t), gp.sat_pos_clock(t)
        assert np.abs(pp - pj).max() <= 1e-9 and abs(kp - kj) <= 1e-18
        assert np.abs(gp.sat_vel(t) - gj.sat_vel(t)).max() <= 1e-9


def _rx_ecef(geodesy):
    return geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)


def test_geo_as_ranging_source_raises_like_jax():
    """A fix with the GEO's observable valid (its channel stamped by MT12)
    and its MT9 ephemeris held: both packages hand the SbasGeoEphemeris to
    the batched Kepler evaluation, which reads fields the adapter lacks,
    and raise the same AttributeError (the reference's behaviour, kept)."""
    from gnss_sim_receiver_tpu.utils import geodesy as jgeo
    rx = _rx_ecef(jgeo)
    nav = dict(t0_s=T0, pos_m=(-5.9e6, -4.17e7, 0.0))
    errs = []
    for eph_mod, sbas_mod, obs_mod, pvt_mod in (
            (jeph, jsbas, jobs, jpvt), (peph, psbas, pobs, ppvt)):
        ephs = [e for e in eph_mod.make_sky_constellation(
            40.0, -75.0, toe=T0 + 600) if e.prn in (1, 3, 4, 5)]
        table = {e.prn: e for e in ephs}
        table[("SBAS", 133)] = sbas_mod.SbasGeoEphemeris(
            133, sbas_mod.SbasGeoNav(**nav))
        n = 5
        ep = obs_mod.ObservationEpoch(
            rx_time_s=T0 + 60.07, tick_sample=0, valid=np.ones(n, bool),
            pseudorange_m=np.full(n, 2.2e7), interp_tow_ms=np.full(
                n, (T0 + 60.0) * 1e3), carrier_doppler_hz=np.zeros(n),
            carrier_phase_cycles=np.zeros(n), cn0_db_hz=np.full(n, 45.0))
        with pytest.raises(AttributeError) as err:
            pvt_mod.solve_pvt(ep, [1, 3, 4, 5, 133], table,
                              systems=["GPS"] * 4 + ["SBAS"], x0=rx)
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "toc" in errs[0]


def _session_pair(props=None):
    """A GPS + S1 receiver session of each package (JAX's built but never
    run), from the same conf."""
    jconf = jrx.ReceiverConf(fs=FS, max_channels=2, chains=(
        jrx.sbas_l1_chain(FS, prns=tuple(PRNS)),), **(props or {}))
    pconf = interop.receiver_conf_from_fields(dataclasses.asdict(jconf))
    return (jrx.Receiver(jconf).start_session(),
            prx.Receiver(pconf, device="cpu").start_session())


def test_receiver_feeds_like_jax():
    """The session's per-chunk feeds, given the same decoder state: the
    CRC-passed S1 messages into SbasCorrections (JAX's inline loop, run
    here on its own session's state) with MT9 published as the ("SBAS",
    prn) ephemeris, in two passes (the consumed count carried); the
    broadcast iono into conf.pvt, in place, under iono_model=Broadcast
    only."""
    js, ps = _session_pair()
    assert isinstance(ps.sbas_corr, psbas.SbasCorrections)
    jrt, prt = js.chains[1], ps.chains[1]
    assert prt.spec.signal == jrt.spec.signal == "S1"
    msgs = _messages(jsbas)
    evs = [jsbas.SbasMessageEvent(mt, pl, 500 * k, k % 3, k != 3)
           for k, (mt, pl) in enumerate(msgs)]
    pev = [psbas.SbasMessageEvent(e.msg_type, e.payload, e.start_symbol,
                                  e.preamble_idx, e.crc_ok) for e in evs]
    nav = jsbas.parse_mt9(msgs[1][1])
    jrt.tlm.ch[1].decoder.geo_nav = nav
    prt.tlm.ch[1].decoder.geo_nav = psbas.parse_mt9(msgs[1][1])
    for a, b in ((0, 3), (3, len(evs))):
        jrt.tlm.messages.extend((1, 133, e) for e in evs[a:b])
        prt.tlm.messages.extend((1, 133, e) for e in pev[a:b])
        for c, prn, ev in jrt.tlm.messages[jrt.sbas_consumed:]:
            if ev.crc_ok:
                js.sbas_corr.push(ev)
                if ev.msg_type == 9:
                    js.ephemerides[("SBAS", prn)] = \
                        jsbas.SbasGeoEphemeris(prn, jrt.tlm.geo_nav(c))
        jrt.sbas_consumed = len(jrt.tlm.messages)
        ps._feed_sbas(prt)
        assert prt.sbas_consumed == jrt.sbas_consumed == b
    for k in ("prn_mask", "fast_prc", "igp_mask", "iono"):
        assert getattr(ps.sbas_corr, k) == getattr(js.sbas_corr, k), k
    assert sorted(ps.sbas_corr.long_term) == sorted(js.sbas_corr.long_term)
    assert not ps.sbas_corr.fast_prc      # the MT2 was the failed CRC
    geo = ps.ephemerides[("SBAS", 133)]
    assert isinstance(geo, psbas.SbasGeoEphemeris)
    assert dataclasses.astuple(geo.nav) == dataclasses.astuple(nav)
    iono = {f"alpha{i}": 1e-8 * (i + 1) for i in range(4)}
    iono.update({f"beta{i}": 8e4 * (i + 1) for i in range(4)})
    for model in ("OFF", "Broadcast"):
        pconf = prx.ReceiverConf(fs=FS, pvt=ppvt.PvtConf(iono_model=model))
        ses = prx.Receiver(pconf, device="cpu").start_session()
        ses.chains[0].tlm.iono_utc = iono
        ses._feed_iono(ses.chains[0])
        want = (tuple(1e-8 * (i + 1) for i in range(4)),
                tuple(8e4 * (i + 1) for i in range(4)))
        got = (pconf.pvt.iono_alpha, pconf.pvt.iono_beta)
        assert got == (want if model == "Broadcast"
                       else ((0.0,) * 4, (0.0,) * 4))


# ---- the simulator ---------------------------------------------------------

def _sats(cls, n_epochs=80, seed=8, cn0=50.0):
    """Two SBAS satellites with a random symbol stream as per-epoch signs
    (two epochs a symbol)."""
    rng = np.random.default_rng(seed)
    return [cls(prn=p, system="SBAS", signal="S1", cn0_db_hz=cn0,
                doppler_hz=d, delay_chips=n * 1.023e6 / FS,
                nav_bits=psbas.sbas_epoch_signs(
                    rng.integers(0, 2, n_epochs // 2)))
            for p, d, n in zip(PRNS, DOPS, DELAYS)]


def test_host_generator_equals_jax():
    """20 ms of the two satellites, noiseless, sample for sample."""
    n = int(0.02 * FS)
    want = jgen(_sats(JSat), FS, n, start_sample=777, noise=False)
    got = pgen(_sats(PSat), FS, n, start_sample=777, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    """K6's plain version against the JAX device generator on the two
    satellites over 0.06 s (tests/test_device_generator.py's criteria),
    the anchors bit for bit."""
    nblk = int(0.06 * FS) // 8192
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
    """sbas_l1_chain's search (two 1 ms dwells on the doubled FFT, D = 41
    at 250 Hz, N = 2000, then 62.5 Hz) on 6 ms of the two satellites in
    noise, PRN 120 absent: the same detections, Doppler and delay, the
    statistic to 1e-4; each PRN within 2 samples and 75 Hz of its truth."""
    chain = prx.sbas_l1_chain(FS)
    jchain = jrx.sbas_l1_chain(FS)
    x = jgen(_sats(JSat, cn0=47.0), FS, int(0.006 * FS), noise=True,
             seed=12)
    je = jacq.PcpsAcquisitionEngine(
        jchain.acq, prns=[122, 133, 120], code_provider=jchain.code_provider,
        sc_rate=jchain.sc_rate)
    pe = pacq.PcpsAcquisitionEngine(
        chain.acq, prns=[122, 133, 120], code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, device="cpu")
    assert pe.fft_size == je.fft_size == 4000
    want, got = je.acquire(x), pe.acquire(x)
    assert list(got.detected) == list(want.detected) == [True, True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    for k in range(2):
        assert abs(got.doppler_hz[k] - DOPS[k]) <= 75.0
        err = abs(got.delay_samples[k] - DELAYS[k]) % 2000
        assert min(err, 2000 - err) <= 2.0


def test_block_chunk_matches_jax():
    """The block step at the S1 chain's shape (2 Msps, C = 2, E = 20 epochs
    a block, the rectified lock test), 3 blocks (60 ms) from the armed
    state on the noise-free pair, with tests/test_torch_tracking.py's
    per-epoch tolerances (prompt max 2 %, median 0.2 % of the mean
    prompt; epoch ends within one sample; Doppler within 0.2 Hz; code
    boundary within 0.05 sample); the replica spectra equal."""
    s0, n_blk, e_blk = 2000, 3, 20
    x = jgen(_sats(JSat), FS, max(DELAYS) + (n_blk * e_blk + 4) * s0 + 8192,
             noise=False)
    jconf = jrx.sbas_l1_chain(FS).trk
    pconf = prx.sbas_l1_chain(FS).trk
    for f in dataclasses.fields(pconf):
        assert getattr(pconf, f.name) == getattr(jconf, f.name), f.name
    assert pconf.lock_rectify
    eng = ptrk.TrackingEngine(pconf, PRNS, device="cpu",
                              code_provider=signals.CodeProvider("S1"))
    assert eng.block_epochs == e_blk
    st = jax.tree_util.tree_map(
        lambda *v: jnp.concatenate(v),
        *(_armed(jconf, d, n) for d, n in zip(DOPS, DELAYS)))
    pst = interop.track_state_from_numpy(interop.track_state_to_numpy(st),
                                         "cpu")
    tables = np.stack([jpc.bandlimited_table_normalized(
        jpc.sbas_l1_code(p), FS, jconf.code_rate_cps, s0) for p in PRNS])
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


# ---- the chain -------------------------------------------------------------

def test_chain_conf_like_jax():
    """sbas_l1_chain gives the JAX chain (compared through interop) at its
    defaults and with PRNs and a count: the decision-directed FLL pull-in
    on (JAX's code, not its docstring), the rectified lock test, the
    doubled-FFT two-step search; its decoder is the SBAS one; a session
    with an S1 chain holds a corrections state, one without none."""
    for kw in ({}, dict(prns=(133,), n_channels=1)):
        ref = jrx.sbas_l1_chain(FS, **kw)
        got = prx.sbas_l1_chain(FS, **kw)
        assert got == interop._chain_from_fields(dataclasses.asdict(ref),
                                                 "sbas_l1_chain")
    assert (got.signal, got.system, got.assist_wait) == ("S1", "SBAS",
                                                         False)
    assert got.trk.enable_fll_pullin and got.trk.fll_decision_directed
    assert got.trk.lock_rectify and got.acq.bit_transition_flag
    assert got.code_provider == signals.CodeProvider("S1")
    assert isinstance(got.telemetry_decoder([0]),
                      ptlm.SbasL1TelemetryDecoder)
    assert prx.Receiver(prx.ReceiverConf(fs=FS), device="cpu"
                        ).start_session().sbas_corr is None
