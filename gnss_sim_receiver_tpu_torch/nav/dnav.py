"""BeiDou B1I D1 NAV message layer: subframe encode (simulator) and
streaming decode.

Mirrors the reference's beidou_b1i_telemetry_decoder_gs (preamble
correlation, BCH(15,11,1) decode with de-interleaving, subframes 1-3 ->
ephemeris/clock/iono) — src/algorithms/telemetry_decoder/gnuradio_blocks/
beidou_b1i_telemetry_decoder_gs.cc and
src/core/system_parameters/beidou_dnav_navigation_message.cc.

Structure per the BDS-SIS-ICD-2.0 (D1, MEO/IGSO):
  frame = 5 subframes x 6 s; subframe = 10 words x 30 bits at 50 bps;
  bits additionally spread by the NH20 secondary code (20 x 1 ms epochs
  per bit — handled by the tracking/telemetry secondary-code layer).
  word 1 = preamble(11) + rev(4) + FraID(3) + data(8) + BCH parity(4)
           (only its last 15 bits are one BCH(15,11) codeword);
  words 2-10 = two BCH(15,11) codewords bit-interleaved (22 data + 8
           parity bits per word).
  Subframes 1-3 carry clock/iono/health + the Kepler ephemeris (CGCS2000,
  same GM as Galileo); 4-5 carry almanac (placeholder here).
  GEO satellites (PRN 1-5, >58) use D2 at 500 bps — see the D2 section
  below (2 code epochs per bit, no NH; subframe 1 split into 10 pages).

Copy of ``gnss_sim_receiver_tpu.nav.dnav`` for the PyTorch port (the port
imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris
from gnss_sim_receiver_tpu_torch.ops.prn_codes_multi import BEIDOU_NH20

PREAMBLE = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.int64)
SUBFRAME_BITS = 300
SUBFRAME_SECONDS = 6.0
WORD_BITS = 30

BDS_GM = 3.986004418e14
BDS_OMEGA_E = 7.2921150e-5


# --------------------------------------------------------------------------
# BCH(15,11,1): g(x) = x^4 + x + 1 (ICD 5.1.3), single-error correcting
# --------------------------------------------------------------------------

def bch_encode(data11: np.ndarray) -> np.ndarray:
    """11 data bits -> 15-bit codeword (systematic, parity last)."""
    reg = 0
    for b in np.asarray(data11, dtype=np.int64):
        fb = ((reg >> 3) & 1) ^ int(b)
        reg = ((reg << 1) & 0xF) ^ (fb * 0b0011)
        # g = x^4 + x + 1: feedback into taps x^1 and x^0
    out = np.concatenate([np.asarray(data11, np.int64),
                          np.array([(reg >> 3) & 1, (reg >> 2) & 1,
                                    (reg >> 1) & 1, reg & 1], np.int64)])
    return out


_SYNDROME_TO_POS = None


def _syndromes():
    """Map syndrome -> error position by simulating single-bit errors."""
    global _SYNDROME_TO_POS
    if _SYNDROME_TO_POS is None:
        table = {}
        base = bch_encode(np.zeros(11, np.int64))
        for pos in range(15):
            w = base.copy()
            w[pos] ^= 1
            s = _syndrome(w)
            table[s] = pos
        _SYNDROME_TO_POS = table
    return _SYNDROME_TO_POS


def _syndrome(word15: np.ndarray) -> int:
    re_enc = bch_encode(np.asarray(word15[:11], np.int64))
    s = 0
    for i in range(4):
        s = (s << 1) | int(re_enc[11 + i] ^ word15[11 + i])
    return s


def bch_decode(word15: np.ndarray):
    """-> (ok, corrected 11 data bits); corrects single-bit errors."""
    w = np.asarray(word15, dtype=np.int64).copy()
    s = _syndrome(w)
    if s == 0:
        return True, w[:11]
    pos = _syndromes().get(s)
    if pos is None:
        return False, w[:11]
    w[pos] ^= 1
    return _syndrome(w) == 0, w[:11]


def interleave_word(cw1: np.ndarray, cw2: np.ndarray) -> np.ndarray:
    """Two BCH codewords -> 30-bit word, bit-interleaved (ICD 5.1.3)."""
    out = np.empty(30, dtype=np.int64)
    out[0::2] = cw1
    out[1::2] = cw2
    return out


def deinterleave_word(word30: np.ndarray):
    w = np.asarray(word30, dtype=np.int64)
    return w[0::2], w[1::2]


# --------------------------------------------------------------------------
# subframe field layouts in RAW ICD coordinates: 1-based bit positions on
# the DE-INTERLEAVED 300-bit frame, exactly the reference's decode_subframe
# reassembly (beidou_b1i_telemetry_decoder_gs.cc:200-243: word 1 raw; each
# word >= 2 re-ordered to [11+11 data | 4+4 BCH parity]).  Positions and
# splits match Beidou_DNAV.h D1_*/D2_* tables bit for bit, so a real B1I
# broadcast decodes and the packed frames are ICD-interoperable.
# Field spec: name -> (((start, len), ...), scale, signed).
# --------------------------------------------------------------------------

_SOW = ((19, 8), (31, 12))

_SF1 = {
    "sow":     (_SOW, 1.0, False),
    "sat_h1":  (((43, 1),), 1.0, False),
    "aodc":    (((44, 5),), 1.0, False),
    "urai":    (((49, 4),), 1.0, False),
    "wn":      (((61, 13),), 1.0, False),
    "toc":     (((74, 9), (91, 8)), 8.0, False),
    "tgd1":    (((99, 10),), 1e-10, True),
    "tgd2":    (((109, 4), (121, 6)), 1e-10, True),
    "alpha0":  (((127, 8),), 2.0 ** -30, True),
    "alpha1":  (((135, 8),), 2.0 ** -27, True),
    "alpha2":  (((151, 8),), 2.0 ** -24, True),
    "alpha3":  (((159, 8),), 2.0 ** -24, True),
    "beta0":   (((167, 6), (181, 2)), 2.0 ** 11, True),
    "beta1":   (((183, 8),), 2.0 ** 14, True),
    "beta2":   (((191, 8),), 2.0 ** 16, True),
    "beta3":   (((199, 4), (211, 4)), 2.0 ** 16, True),
    "a2":      (((215, 11),), 2.0 ** -66, True),
    "a0":      (((226, 7), (241, 17)), 2.0 ** -33, True),
    "a1":      (((258, 5), (271, 17)), 2.0 ** -50, True),
    "aode":    (((288, 5),), 1.0, False),
}
_SF2 = {
    "sow":     (_SOW, 1.0, False),
    "delta_n": (((43, 10), (61, 6)), 2.0 ** -43, True),
    "cuc":     (((67, 16), (91, 2)), 2.0 ** -31, True),
    "m0":      (((93, 20), (121, 12)), 2.0 ** -31, True),
    "ecc":     (((133, 10), (151, 22)), 2.0 ** -33, False),
    "cus":     (((181, 18),), 2.0 ** -31, True),
    "crc":     (((199, 4), (211, 14)), 2.0 ** -6, True),
    "crs":     (((225, 8), (241, 10)), 2.0 ** -6, True),
    "sqrt_a":  (((251, 12), (271, 20)), 2.0 ** -19, False),
    "toe_msb": (((291, 2),), 1.0, False),
}
_SF3 = {
    "sow":       (_SOW, 1.0, False),
    "toe_lsb":   (((43, 10), (61, 5)), 1.0, False),
    "i0":        (((66, 17), (91, 15)), 2.0 ** -31, True),
    "cic":       (((106, 7), (121, 11)), 2.0 ** -31, True),
    "omega_dot": (((132, 11), (151, 13)), 2.0 ** -43, True),
    "cis":       (((164, 9), (181, 9)), 2.0 ** -31, True),
    "idot":      (((190, 13), (211, 1)), 2.0 ** -43, True),
    "omega0":    (((212, 21), (241, 11)), 2.0 ** -31, True),
    "omega":     (((252, 11), (271, 21)), 2.0 ** -31, True),
}
SUBFRAME_FIELDS = {1: _SF1, 2: _SF2, 3: _SF3}

# data-bit positions (0-based) available for packing: word 1 bits 18-25
# after the FraID (SOW msb slot), words 2-10 bits base..base+21
_FRAID_SEG = ((16, 3),)


def _pack_fields(frame: np.ndarray, layout: dict, fields: dict) -> None:
    for name, (segs, scale, signed) in layout.items():
        n = sum(ln for _, ln in segs)
        raw = int(round(fields.get(name, 0.0) / scale))
        if signed:
            lim = 1 << (n - 1)
            raw = max(-lim, min(lim - 1, raw)) & ((1 << n) - 1)
        else:
            raw = max(0, min((1 << n) - 1, raw))
        pos = 0
        for start, ln in segs:
            for i in range(ln):
                frame[start - 1 + i] = (raw >> (n - 1 - pos - i)) & 1
            pos += ln


def _unpack_fields(layout: dict, frame: np.ndarray) -> dict:
    fields = {}
    for name, (segs, scale, signed) in layout.items():
        n = sum(ln for _, ln in segs)
        raw = 0
        for start, ln in segs:
            for i in range(ln):
                raw = (raw << 1) | int(frame[start - 1 + i])
        if signed and raw >> (n - 1):
            raw -= 1 << n
        fields[name] = raw * scale
    return fields


def _frame_to_tx(frame: np.ndarray) -> np.ndarray:
    """De-interleaved data frame -> transmitted 300 bits: compute BCH
    parity per word, interleave words 2-10 (ICD 5.1.3)."""
    tx = np.empty(SUBFRAME_BITS, dtype=np.int64)
    w1 = bch_encode(frame[15:26])
    tx[:15] = frame[:15]
    tx[15:30] = w1
    for w in range(1, 10):
        b0 = 30 * w
        cw1 = bch_encode(frame[b0:b0 + 11])
        cw2 = bch_encode(frame[b0 + 11:b0 + 22])
        tx[b0:b0 + 30] = interleave_word(cw1, cw2)
    return tx


def _tx_to_frame(bits300: np.ndarray):
    """Transmitted bits -> (ok, de-interleaved BCH-corrected frame):
    the reference decode_word/decode_subframe reassembly."""
    b = np.asarray(bits300, dtype=np.int64)
    frame = np.zeros(SUBFRAME_BITS, dtype=np.int64)
    frame[:15] = b[:15]
    ok, w1 = bch_decode(b[15:30])
    frame[15:26] = w1
    frame[26:30] = b[26:30]
    for w in range(1, 10):
        b0 = 30 * w
        cw1, cw2 = deinterleave_word(b[b0:b0 + 30])
        o1, d1 = bch_decode(cw1)
        o2, d2 = bch_decode(cw2)
        ok = ok and o1 and o2
        frame[b0:b0 + 11] = d1
        frame[b0 + 11:b0 + 22] = d2
    return ok, frame


def pack_subframe(fra_id: int, fields: dict) -> np.ndarray:
    """D1 subframe -> 300 transmitted bits (preamble + FraID + fields at
    their ICD positions + per-word BCH parity + interleaving)."""
    frame = np.zeros(SUBFRAME_BITS, dtype=np.int64)
    frame[:11] = PREAMBLE
    for i in range(3):
        frame[15 + i] = (fra_id >> (2 - i)) & 1
    _pack_fields(frame, SUBFRAME_FIELDS.get(fra_id, {"sow": _SF1["sow"]}),
                 fields)
    return _frame_to_tx(frame)


def unpack_subframe(bits300: np.ndarray):
    """-> (ok, fra_id, fields); BCH-corrects every word."""
    ok, frame = _tx_to_frame(bits300)
    fra_id = int(frame[15]) << 2 | int(frame[16]) << 1 | int(frame[17])
    fields = _unpack_fields(SUBFRAME_FIELDS.get(fra_id,
                                                {"sow": _SF1["sow"]}),
                            frame)
    return ok, fra_id, fields


# --------------------------------------------------------------------------
# ephemeris <-> subframes (Kepler broadcast, CGCS2000)
# --------------------------------------------------------------------------

def beidou_ephemeris_to_subframes(eph) -> dict[int, dict]:
    toe_cnt = int(round(eph.toe / 8.0))
    return {
        1: dict(wn=eph.week, toc=eph.toc, a0=eph.af0, a1=eph.af1,
                a2=eph.af2, tgd1=eph.tgd, aodc=21, aode=21),
        2: dict(delta_n=eph.delta_n_sc, cuc=eph.cuc, m0=eph.m0_sc,
                ecc=eph.ecc, cus=eph.cus, crc=eph.crc, crs=eph.crs,
                sqrt_a=eph.sqrt_a, toe_msb=(toe_cnt >> 15) & 0x3),
        3: dict(toe_lsb=toe_cnt & 0x7FFF, i0=eph.i0_sc, cic=eph.cic,
                omega_dot=eph.omega_dot_sc, cis=eph.cis, idot=eph.idot_sc,
                omega0=eph.omega0_sc, omega=eph.omega_sc),
    }


def subframes_to_beidou_ephemeris(prn: int, sfs: dict[int, dict]):
    """Subframes 1-3 -> ephemeris (BDS Kepler; GM == Galileo's value so the
    propagator reuses the 'Galileo' branch; BDT week/epoching is kept on
    the common sim timescale)."""
    s1, s2, s3 = sfs[1], sfs[2], sfs[3]
    toe = ((int(s2["toe_msb"]) << 15) | int(round(s3["toe_lsb"]))) * 8.0
    return GpsEphemeris(
        prn=prn, system="BeiDou", week=int(s1["wn"]),
        toc=s1["toc"], af0=s1["a0"], af1=s1["a1"], af2=s1["a2"],
        tgd=s1["tgd1"],
        delta_n_sc=s2["delta_n"], cuc=s2["cuc"], m0_sc=s2["m0"],
        ecc=s2["ecc"], cus=s2["cus"], crc=s2["crc"], crs=s2["crs"],
        sqrt_a=s2["sqrt_a"], toe=toe,
        i0_sc=s3["i0"], cic=s3["cic"], omega_dot_sc=s3["omega_dot"],
        cis=s3["cis"], idot_sc=s3["idot"], omega0_sc=s3["omega0"],
        omega_sc=s3["omega"],
        iode=int(s1.get("aode", 0)), iodc=int(s1.get("aodc", 0)),
    )


def bits_for_ephemeris(eph, t0_bdt_s: float, n_repeats: int = 3
                       ) -> np.ndarray:
    """D1 bit stream {0,1} at 50 bps cycling subframes 1,2,3 (4-5 almanac
    placeholders skipped — frames here are 18 s).  `t0_bdt_s` must be a
    multiple of 6 s; each subframe's SOW stamps its own first bit."""
    if t0_bdt_s % SUBFRAME_SECONDS:
        raise ValueError("t0_bdt_s must be a multiple of 6 s")
    sfs = beidou_ephemeris_to_subframes(eph)
    out = []
    t = t0_bdt_s
    for _ in range(n_repeats):
        for fra in (1, 2, 3):
            f = dict(sfs[fra], sow=t % 604800.0)
            out.append(pack_subframe(fra, f))
            t += SUBFRAME_SECONDS
    return np.concatenate(out)


@dataclasses.dataclass
class DnavSubframeEvent:
    fra_id: int
    fields: dict
    subframe_start_bit: int     # stream bit index of the subframe start
    ok: bool


class DnavSubframeDecoder:
    """Streaming D1 subframe synchronizer/decoder for one channel: feed
    soft 50-bps bits (NH20 already wiped by the telemetry layer); preamble
    + BCH gates, polarity from the preamble sign."""

    def __init__(self):
        self.bits: list[float] = []
        self._aligned = False
        self._inverted = False
        self._next_sf = 0
        self._fails = 0

    def push_bits(self, soft) -> list[DnavSubframeEvent]:
        self.bits.extend(float(s) for s in soft)
        events = []
        while True:
            if not self._aligned and not self._try_align():
                break
            if len(self.bits) < self._next_sf + SUBFRAME_BITS:
                break
            ev = self._decode_subframe()
            if ev is not None:
                events.append(ev)
        return events

    def _try_align(self) -> bool:
        s = np.sign(np.asarray(self.bits, dtype=np.float64))
        pre = 2.0 * PREAMBLE - 1.0
        n = len(s)
        i = max(self._next_sf, 0)
        while i + SUBFRAME_BITS + 11 <= n:
            c0 = float(np.dot(s[i:i + 11], pre))
            if abs(c0) == 11.0:
                c1 = float(np.dot(s[i + SUBFRAME_BITS:
                                    i + SUBFRAME_BITS + 11], pre))
                if c1 == c0:
                    self._aligned = True
                    self._inverted = c0 < 0
                    self._next_sf = i
                    return True
            i += 1
        self._next_sf = max(self._next_sf, n - SUBFRAME_BITS - 11)
        return False

    def _decode_subframe(self):
        i = self._next_sf
        raw = np.asarray(self.bits[i:i + SUBFRAME_BITS], dtype=np.float64)
        if self._inverted:
            raw = -raw
        hard = (raw > 0).astype(np.int64)
        start = i
        self._next_sf = i + SUBFRAME_BITS
        ok, fra, fields = unpack_subframe(hard)
        if not ok:
            self._fails += 1
            if self._fails >= 4:
                self._aligned = False
                self._fails = 0
            return DnavSubframeEvent(-1, {}, start, False)
        self._fails = 0
        return DnavSubframeEvent(fra, fields, start, True)


def b1i_epoch_signs(bits01: np.ndarray) -> np.ndarray:
    """D1 bits {0,1} at 50 bps -> +-1 per 1 ms B1I code epoch: each 20 ms
    bit is spread by the NH20 secondary code (the per-epoch modulation the
    simulator applies)."""
    nh = 1 - 2 * np.asarray(BEIDOU_NH20, np.int64)
    b = 2 * np.asarray(bits01, np.int64) - 1
    return (np.repeat(b, 20) * np.tile(nh, len(b))).astype(np.int8)


# ==========================================================================
# D2 NAV (GEO satellites, PRN 1-5 / >58): 500 bps, 2 code epochs per bit,
# no NH modulation; subframe 1 split into 10 pages carrying the full
# ephemeris/clock/iono set.  Mirrors the reference's D2 arm
# (beidou_b1i_telemetry_decoder_gs.cc:268-276 GEO dispatch,
# beidou_dnav_navigation_message.cc:377 d2_subframe_decoder; field widths
# from Beidou_DNAV.h D2_* tables).  Same word/BCH(15,11)/interleave layer
# as D1; page layouts are self-consistent over the 206-bit payload.
# ==========================================================================

D2_SECONDS_PER_BIT = 2e-3
D2_FRAME_SECONDS = 3.0           # 5 subframes x 0.6 s
D2_PAGES = 10

# D2 subframe-1 page layouts in the same RAW ICD coordinates
# (Beidou_DNAV.h D2_* tables; split-field widths: a1 = 4+18, cuc = 14+4,
# e = 10+22, cic = 10+8, i0 = 21+11, omega_dot = 19+5, omega = 27+5;
# each page's *_lsb fields are read on the page AFTER the *_msb page,
# beidou_dnav_navigation_message.cc d2_subframe_decoder cases).
_D2_HDR = {"sow": (_SOW, 1.0, False), "pnum": (((43, 4),), 1.0, False)}
_D2_PAGE = {
    1: {"sat_h1": (((47, 1),), 1.0, False),
        "aodc": (((48, 5),), 1.0, False),
        "urai": (((61, 4),), 1.0, False),
        "wn": (((65, 13),), 1.0, False),
        "toc": (((78, 5), (91, 12)), 8.0, False),
        "tgd1": (((103, 10),), 1e-10, True),
        "tgd2": (((121, 10),), 1e-10, True)},
    2: {"alpha0": (((47, 6), (61, 2)), 2.0 ** -30, True),
        "alpha1": (((63, 8),), 2.0 ** -27, True),
        "alpha2": (((71, 8),), 2.0 ** -24, True),
        "alpha3": (((79, 4), (91, 4)), 2.0 ** -24, True),
        "beta0": (((95, 8),), 2.0 ** 11, True),
        "beta1": (((103, 8),), 2.0 ** 14, True),
        "beta2": (((111, 2), (121, 6)), 2.0 ** 16, True),
        "beta3": (((127, 8),), 2.0 ** 16, True)},
    3: {"a0": (((101, 12), (121, 12)), 2.0 ** -33, True),
        "a1_msb": (((133, 4),), 1.0, False)},
    4: {"a1_lsb": (((47, 6), (61, 12)), 1.0, False),
        "a2": (((73, 10), (91, 1)), 2.0 ** -66, True),
        "aode": (((92, 5),), 1.0, False),
        "delta_n": (((97, 16),), 2.0 ** -43, True),
        "cuc_msb": (((121, 14),), 1.0, False)},
    5: {"cuc_lsb": (((47, 4),), 1.0, False),
        "m0": (((51, 2), (61, 22), (91, 8)), 2.0 ** -31, True),
        "cus": (((99, 14), (121, 4)), 2.0 ** -31, True),
        "e_msb": (((125, 10),), 1.0, False)},
    6: {"e_lsb": (((47, 6), (61, 16)), 1.0, False),
        "sqrt_a": (((77, 6), (91, 22), (121, 4)), 2.0 ** -19, False),
        "cic_msb": (((125, 10),), 1.0, False)},
    7: {"cic_lsb": (((47, 6), (61, 2)), 1.0, False),
        "cis": (((63, 18),), 2.0 ** -31, True),
        "toe": (((81, 2), (91, 15)), 8.0, False),
        "i0_msb": (((106, 7), (121, 14)), 1.0, False)},
    8: {"i0_lsb": (((47, 6), (61, 5)), 1.0, False),
        "crc": (((66, 17), (91, 1)), 2.0 ** -6, True),
        "crs": (((92, 18),), 2.0 ** -6, True),
        "omega_dot_msb": (((110, 3), (121, 16)), 1.0, False)},
    9: {"omega_dot_lsb": (((47, 5),), 1.0, False),
        "omega0": (((52, 1), (61, 22), (91, 9)), 2.0 ** -31, True),
        "omega_msb": (((100, 13), (121, 14)), 1.0, False)},
    10: {"omega_lsb": (((47, 5),), 1.0, False),
         "idot": (((52, 1), (61, 13)), 2.0 ** -43, True)},
}


def _d2_layout(pnum: int) -> dict:
    return {**_D2_HDR, **_D2_PAGE.get(pnum, {})}


def pack_d2_subframe(fra_id: int, fields: dict) -> np.ndarray:
    """D2 subframe -> 300 transmitted bits.  Subframe 1 needs
    fields['pnum']; subframes 2-5 are SOW-only fillers here (the
    reference decodes nothing from them,
    beidou_dnav_navigation_message.cc:540-554)."""
    layout = (_d2_layout(int(fields.get("pnum", 0))) if fra_id == 1
              else _D2_HDR)
    frame = np.zeros(SUBFRAME_BITS, dtype=np.int64)
    frame[:11] = PREAMBLE
    for i in range(3):
        frame[15 + i] = (fra_id >> (2 - i)) & 1
    _pack_fields(frame, layout, fields)
    return _frame_to_tx(frame)


def unpack_d2_subframe(bits300: np.ndarray):
    """-> (ok, fra_id, pnum, fields)."""
    ok, frame = _tx_to_frame(bits300)
    fra_id = int(frame[15]) << 2 | int(frame[16]) << 1 | int(frame[17])
    hdr = _unpack_fields(_D2_HDR, frame)
    pnum = int(hdr["pnum"])
    fields = _unpack_fields(_d2_layout(pnum) if fra_id == 1 else _D2_HDR,
                            frame)
    return ok, fra_id, pnum, fields


def _split(raw: int, n_total: int, n_lsb: int):
    return (raw >> n_lsb) & ((1 << (n_total - n_lsb)) - 1), \
        raw & ((1 << n_lsb) - 1)


def _join_signed(msb: float, lsb: float, n_total: int, n_lsb: int,
                 scale: float) -> float:
    raw = (int(round(msb)) << n_lsb) | int(round(lsb))
    if raw >> (n_total - 1):
        raw -= 1 << n_total
    return raw * scale


def beidou_ephemeris_to_d2_pages(eph) -> dict[int, dict]:
    """Ephemeris -> the 10 D2 subframe-1 page field sets."""
    def raw(v, scale, n):
        r = int(round(v / scale))
        return r & ((1 << n) - 1)

    a1_m, a1_l = _split(raw(eph.af1, 2.0 ** -50, 22), 22, 18)
    cuc_m, cuc_l = _split(raw(eph.cuc, 2.0 ** -31, 18), 18, 4)
    e_m, e_l = _split(raw(eph.ecc, 2.0 ** -33, 32), 32, 22)
    cic_m, cic_l = _split(raw(eph.cic, 2.0 ** -31, 18), 18, 8)
    i0_m, i0_l = _split(raw(eph.i0_sc, 2.0 ** -31, 32), 32, 11)
    od_m, od_l = _split(raw(eph.omega_dot_sc, 2.0 ** -43, 24), 24, 5)
    om_m, om_l = _split(raw(eph.omega_sc, 2.0 ** -31, 32), 32, 5)
    return {
        1: dict(pnum=1, sat_h1=0, aodc=21, urai=0, wn=eph.week,
                toc=eph.toc, tgd1=eph.tgd),
        2: dict(pnum=2, alpha0=0.0, alpha1=0.0, alpha2=0.0, alpha3=0.0,
                beta0=0.0, beta1=0.0, beta2=0.0, beta3=0.0),
        3: dict(pnum=3, a0=eph.af0, a1_msb=a1_m),
        4: dict(pnum=4, a1_lsb=a1_l, a2=eph.af2, aode=21,
                delta_n=eph.delta_n_sc, cuc_msb=cuc_m),
        5: dict(pnum=5, cuc_lsb=cuc_l, m0=eph.m0_sc, cus=eph.cus,
                e_msb=e_m),
        6: dict(pnum=6, e_lsb=e_l, sqrt_a=eph.sqrt_a, cic_msb=cic_m),
        7: dict(pnum=7, cic_lsb=cic_l, cis=eph.cis, toe=eph.toe,
                i0_msb=i0_m),
        8: dict(pnum=8, i0_lsb=i0_l, crc=eph.crc, crs=eph.crs,
                omega_dot_msb=od_m),
        9: dict(pnum=9, omega_dot_lsb=od_l, omega0=eph.omega0_sc,
                omega_msb=om_m),
        10: dict(pnum=10, omega_lsb=om_l, idot=eph.idot_sc),
    }


def d2_pages_to_beidou_ephemeris(prn: int, pages: dict[int, dict]):
    """Pages 1-10 -> ephemeris, joining the MSB/LSB split fields (the
    reference's *_msb_bits << shift | *_lsb assembly)."""
    p = pages
    return GpsEphemeris(
        prn=prn, system="BeiDou", week=int(p[1]["wn"]),
        toc=p[1]["toc"], tgd=p[1]["tgd1"],
        af0=p[3]["a0"],
        af1=_join_signed(p[3]["a1_msb"], p[4]["a1_lsb"], 22, 18, 2.0 ** -50),
        af2=p[4]["a2"],
        delta_n_sc=p[4]["delta_n"],
        cuc=_join_signed(p[4]["cuc_msb"], p[5]["cuc_lsb"], 18, 4,
                         2.0 ** -31),
        m0_sc=p[5]["m0"], cus=p[5]["cus"],
        ecc=((int(round(p[5]["e_msb"])) << 22)
             | int(round(p[6]["e_lsb"]))) * 2.0 ** -33,
        sqrt_a=p[6]["sqrt_a"],
        cic=_join_signed(p[6]["cic_msb"], p[7]["cic_lsb"], 18, 8,
                         2.0 ** -31),
        cis=p[7]["cis"], toe=p[7]["toe"],
        i0_sc=_join_signed(p[7]["i0_msb"], p[8]["i0_lsb"], 32, 11,
                           2.0 ** -31),
        crc=p[8]["crc"], crs=p[8]["crs"],
        omega_dot_sc=_join_signed(p[8]["omega_dot_msb"],
                                  p[9]["omega_dot_lsb"], 24, 5, 2.0 ** -43),
        omega0_sc=p[9]["omega0"],
        omega_sc=_join_signed(p[9]["omega_msb"], p[10]["omega_lsb"], 32, 5,
                              2.0 ** -31),
        idot_sc=p[10]["idot"],
        iode=int(p[4].get("aode", 0)), iodc=int(p[1].get("aodc", 0)),
    )


def d2_bits_for_ephemeris(eph, t0_bdt_s: float, n_frames: int = 10
                          ) -> np.ndarray:
    """D2 bit stream {0,1} at 500 bps: frames of 5 subframes (0.6 s each);
    subframe 1 cycles pages 1-10 across frames, subframes 2-5 are SOW-only
    fillers.  Full ephemeris needs 10 frames = 30 s.  SOW is an integer
    second count stamping the first bit of the CURRENT FRAME (BDS ICD
    5.3.2, D2), carried by all 5 subframes; t0 must be a multiple of 3 s."""
    if t0_bdt_s % D2_FRAME_SECONDS:
        raise ValueError("t0_bdt_s must be a multiple of 3 s (frame grid)")
    pages = beidou_ephemeris_to_d2_pages(eph)
    out = []
    for f in range(n_frames):
        pnum = (f % D2_PAGES) + 1
        sow = (t0_bdt_s + f * D2_FRAME_SECONDS) % 604800.0
        out.append(pack_d2_subframe(1, dict(pages[pnum], sow=sow)))
        for fra in (2, 3, 4, 5):
            out.append(pack_d2_subframe(fra, dict(sow=sow)))
    return np.concatenate(out)


def d2_epoch_signs(bits01: np.ndarray) -> np.ndarray:
    """D2 bits {0,1} at 500 bps -> +-1 per 1 ms code epoch (2 epochs per
    bit, no NH modulation)."""
    b = 2 * np.asarray(bits01, np.int64) - 1
    return np.repeat(b, 2).astype(np.int8)


@dataclasses.dataclass
class D2SubframeEvent:
    fra_id: int
    pnum: int
    fields: dict
    subframe_start_sym: int     # stream symbol (1 ms epoch) index
    ok: bool


class D2SubframeDecoder:
    """Streaming D2 synchronizer/decoder for one GEO channel: feed soft
    1 ms-epoch prompt values (1000 sps, 2 per bit); preamble correlation at
    symbol granularity finds both the subframe boundary and the bit
    pairing phase (the reference's GEO arm runs its preamble correlator on
    the same 1 ms symbol history, d_symbol_duration_ms = 2)."""

    SYM_PER_BIT = 2
    SF_SYMS = SUBFRAME_BITS * SYM_PER_BIT

    def __init__(self):
        self.syms: list[float] = []
        self._base = 0              # absolute stream index of self.syms[0]
        self._aligned = False
        self._inverted = False
        self._next_sf = 0           # absolute stream index
        self._fails = 0
        self._pre = np.repeat(2.0 * PREAMBLE - 1.0, self.SYM_PER_BIT)

    def push_symbols(self, soft) -> list[D2SubframeEvent]:
        self.syms.extend(float(s) for s in soft)
        events = []
        while True:
            if not self._aligned and not self._try_align():
                break
            if self._base + len(self.syms) < self._next_sf + self.SF_SYMS:
                break
            ev = self._decode_subframe()
            if ev is not None:
                events.append(ev)
        # bounded memory: drop consumed symbols (decode and failed
        # alignment scans both advance _next_sf)
        drop = self._next_sf - self._base
        if drop > 0:
            del self.syms[:drop]
            self._base = self._next_sf
        return events

    def _try_align(self) -> bool:
        s = np.sign(np.asarray(self.syms, dtype=np.float64))
        npre = len(self._pre)
        n = len(s)
        i = max(self._next_sf - self._base, 0)
        while i + self.SF_SYMS + npre <= n:
            c0 = float(np.dot(s[i:i + npre], self._pre))
            if abs(c0) == npre:
                c1 = float(np.dot(s[i + self.SF_SYMS:
                                    i + self.SF_SYMS + npre], self._pre))
                if c1 == c0:
                    self._aligned = True
                    self._inverted = c0 < 0
                    self._next_sf = self._base + i
                    return True
            i += 1
        self._next_sf = max(self._next_sf,
                            self._base + n - self.SF_SYMS - npre)
        return False

    def _decode_subframe(self):
        i = self._next_sf - self._base
        raw = np.asarray(self.syms[i:i + self.SF_SYMS], dtype=np.float64)
        if self._inverted:
            raw = -raw
        bits = raw.reshape(-1, self.SYM_PER_BIT).sum(axis=1)
        hard = (bits > 0).astype(np.int64)
        start = self._next_sf
        self._next_sf = start + self.SF_SYMS
        ok, fra, pnum, fields = unpack_d2_subframe(hard)
        if not ok:
            self._fails += 1
            if self._fails >= 4:
                self._aligned = False
                self._fails = 0
            return D2SubframeEvent(-1, 0, {}, start, False)
        self._fails = 0
        return D2SubframeEvent(fra, pnum, fields, start, True)


def is_geo_prn(prn: int) -> bool:
    """BDS GEO satellites broadcast D2 (PRN 1-5 and 59+,
    beidou_b1i_telemetry_decoder_gs.cc:268)."""
    return 0 < prn < 6 or prn > 58
