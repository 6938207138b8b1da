"""Galileo E5a F/NAV message layer: page encode (simulator) and decode.

Mirrors the F/NAV half of the reference's unified Galileo telemetry
decoder (galileo_telemetry_decoder_gs.cc frame_type=2: 12-symbol
un-encoded sync pattern, 8x61 block deinterleaver, G2-inverted rate-1/2
K=7 convolutional code) and the page/word logic of
galileo_fnav_message.cc.

Structure per the Galileo OS SIS ICD 2.0 section 4.2:
  page = 10 s = 500 symbols at 50 sps:
    12-symbol sync pattern 101101110000 (transmitted uncoded) +
    488 coded symbols = conv(page bits 238 + 6 zero tail), G2 NOT-ed,
    block-interleaved 61 cols x 8 rows (deinterleave
    out[c*8+r] = in[r*61+c]);
  page bits = page type (6) + nav data (208) + CRC-24Q (24) = 238,
    CRC over the leading 214 bits.
  Word types 1-4 carry clock+iono+BGD / ephemeris(1/3) / ephemeris(2/3) /
  GST-UTC; each stamps WN+TOW.  E5a single-frequency users correct the
  satellite clock with BGD(E1,E5a) * (f_E1/f_E5a)^2 (ICD 5.1.5).

Copy of ``gnss_sim_receiver_tpu.nav.fnav`` for the PyTorch port, with the
NumPy Viterbi decoder of nav.fec in place of the JAX package's native
helper library.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import signals
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris
from gnss_sim_receiver_tpu_torch.nav.fec import (conv27_encode, crc24q,
                                                 viterbi27_decode)

PREAMBLE = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0], dtype=np.int64)
PAGE_SYMBOLS = 500          # incl. 12-symbol sync
PAGE_SECONDS = 10.0
DATA_SYMBOLS = 488
PAGE_BITS = 238
CRC_SPAN_BITS = 214

_F_E1_E5A_SQ = (1575.42 / 1176.45) ** 2   # BGD frequency-ratio factor

# word layouts: name -> (start bit 1-indexed incl. the 6-bit type, n bits,
# scale, signed); angles in SEMICIRCLES.  OS SIS ICD tables 27-30.
_W1 = {
    "svid":      (7, 6, 1.0, False),
    "iod_nav":   (13, 10, 1.0, False),
    "toc":       (23, 14, 60.0, False),
    "af0":       (37, 31, 2.0 ** -34, True),
    "af1":       (68, 21, 2.0 ** -46, True),
    "af2":       (89, 6, 2.0 ** -59, True),
    "sisa":      (95, 8, 1.0, False),
    "ai0":       (103, 11, 2.0 ** -2, False),
    "ai1":       (114, 11, 2.0 ** -8, True),
    "ai2":       (125, 14, 2.0 ** -15, True),
    "regions":   (139, 5, 1.0, False),
    "bgd_e1e5a": (144, 10, 2.0 ** -32, True),
    "e5a_hs":    (154, 2, 1.0, False),
    "wn":        (156, 12, 1.0, False),
    "tow":       (168, 20, 1.0, False),
    "e5a_dvs":   (188, 1, 1.0, False),
}
_W2 = {
    "iod_nav":   (7, 10, 1.0, False),
    "m0":        (17, 32, 2.0 ** -31, True),
    "omega_dot": (49, 24, 2.0 ** -43, True),
    "ecc":       (73, 32, 2.0 ** -33, False),
    "sqrt_a":    (105, 32, 2.0 ** -19, False),
    "omega0":    (137, 32, 2.0 ** -31, True),
    "idot":      (169, 14, 2.0 ** -43, True),
    "wn":        (183, 12, 1.0, False),
    "tow":       (195, 20, 1.0, False),
}
_W3 = {
    "iod_nav":   (7, 10, 1.0, False),
    "i0":        (17, 32, 2.0 ** -31, True),
    "omega":     (49, 32, 2.0 ** -31, True),
    "delta_n":   (81, 16, 2.0 ** -43, True),
    "cuc":       (97, 16, 2.0 ** -29, True),
    "cus":       (113, 16, 2.0 ** -29, True),
    "crc":       (129, 16, 2.0 ** -5, True),
    "crs":       (145, 16, 2.0 ** -5, True),
    "toe":       (161, 14, 60.0, False),
    "wn":        (175, 12, 1.0, False),
    "tow":       (187, 20, 1.0, False),
}
_W4 = {
    "iod_nav":   (7, 10, 1.0, False),
    "cic":       (17, 16, 2.0 ** -29, True),
    "cis":       (33, 16, 2.0 ** -29, True),
    "a0":        (49, 32, 2.0 ** -30, True),
    "a1":        (81, 24, 2.0 ** -50, True),
    "dt_ls":     (105, 8, 1.0, True),
    "t0t":       (113, 8, 3600.0, False),
    "wn0t":      (121, 8, 1.0, False),
    "wn_lsf":    (129, 8, 1.0, False),
    "dn":        (137, 3, 1.0, False),
    "dt_lsf":    (140, 8, 1.0, True),
    "t0g":       (148, 8, 3600.0, False),
    "a0g":       (156, 16, 2.0 ** -35, True),
    "a1g":       (172, 12, 2.0 ** -51, True),
    "wn0g":      (184, 6, 1.0, False),
    "tow":       (190, 20, 1.0, False),
}
WORD_FIELDS = {1: _W1, 2: _W2, 3: _W3, 4: _W4}


def interleave(coded: np.ndarray) -> np.ndarray:
    """Transmit order: tx[r*61+c] = coded[c*8+r] (inverse of the 8x61
    deinterleaver the reference applies for F/NAV)."""
    return np.asarray(coded).reshape(61, 8).T.reshape(-1)


def deinterleave(rx: np.ndarray) -> np.ndarray:
    return np.asarray(rx).reshape(8, 61).T.reshape(-1)


def pack_word(word_type: int, fields: dict[str, float]) -> np.ndarray:
    """Physical fields -> 238-bit page (type + data + CRC)."""
    bits = np.zeros(PAGE_BITS, dtype=np.int64)
    for i in range(6):
        bits[i] = (word_type >> (5 - i)) & 1
    for name, (start, n, scale, signed) in WORD_FIELDS[word_type].items():
        raw = int(round(fields.get(name, 0.0) / scale))
        if signed:
            lim = 1 << (n - 1)
            raw = max(-lim, min(lim - 1, raw)) & ((1 << n) - 1)
        else:
            raw = max(0, min((1 << n) - 1, raw))
        for i in range(n):
            bits[start - 1 + i] = (raw >> (n - 1 - i)) & 1
    crc = crc24q(bits[:CRC_SPAN_BITS])
    for i in range(24):
        bits[CRC_SPAN_BITS + i] = (crc >> (23 - i)) & 1
    return bits


def unpack_word(page_bits: np.ndarray):
    """238-bit page -> (crc_ok, word_type, fields)."""
    b = np.asarray(page_bits, dtype=np.int64)
    crc_rx = 0
    for i in range(24):
        crc_rx = (crc_rx << 1) | int(b[CRC_SPAN_BITS + i])
    ok = crc24q(b[:CRC_SPAN_BITS]) == crc_rx
    word_type = 0
    for i in range(6):
        word_type = (word_type << 1) | int(b[i])
    fields = {}
    for name, (start, n, scale, signed) in WORD_FIELDS.get(word_type,
                                                           {}).items():
        raw = 0
        for i in range(n):
            raw = (raw << 1) | int(b[start - 1 + i])
        if signed and raw >> (n - 1):
            raw -= 1 << n
        fields[name] = raw * scale
    return ok, word_type, fields


def encode_page(page_bits: np.ndarray) -> np.ndarray:
    """238 page bits -> 500 transmitted symbols {0,1}."""
    coded = conv27_encode(
        np.concatenate([np.asarray(page_bits, np.int64),
                        np.zeros(6, np.int64)]), invert_g2=True)
    return np.concatenate([PREAMBLE, interleave(coded)])


def galileo_ephemeris_to_fnav_words(eph, iono: dict | None = None
                                    ) -> dict[int, dict]:
    iod = int(getattr(eph, "iod_nav", 0) or eph.iode) % 1024
    w1 = dict(svid=eph.prn, iod_nav=iod, toc=eph.toc, af0=eph.af0,
              af1=eph.af1, af2=eph.af2, sisa=107,
              bgd_e1e5a=eph.bgd_e1e5a, wn=eph.week)
    w1.update(iono or {})
    w2 = dict(iod_nav=iod, m0=eph.m0_sc, omega_dot=eph.omega_dot_sc,
              ecc=eph.ecc, sqrt_a=eph.sqrt_a, omega0=eph.omega0_sc,
              idot=eph.idot_sc, wn=eph.week)
    w3 = dict(iod_nav=iod, i0=eph.i0_sc, omega=eph.omega_sc,
              delta_n=eph.delta_n_sc, cuc=eph.cuc, cus=eph.cus,
              crc=eph.crc, crs=eph.crs, toe=eph.toe, wn=eph.week)
    w4 = dict(iod_nav=iod, cic=eph.cic, cis=eph.cis)
    return {1: w1, 2: w2, 3: w3, 4: w4}


def fnav_words_to_ephemeris(prn: int, words: dict[int, dict]):
    """F/NAV words 1-3 (+4) -> ephemeris.  The E5a single-frequency group
    delay is BGD(E1,E5a) scaled by (f_E1/f_E5a)^2 (OS SIS ICD 5.1.5)."""
    w1, w2, w3 = words[1], words[2], words[3]
    w4 = words.get(4, {})
    return GpsEphemeris(
        prn=prn, system="Galileo", week=int(w1.get("wn", 0)),
        iod_nav=int(w1["iod_nav"]), iode=int(w1["iod_nav"]),
        iodc=int(w1["iod_nav"]),
        toc=w1["toc"], af0=w1["af0"], af1=w1["af1"], af2=w1["af2"],
        m0_sc=w2["m0"], omega_dot_sc=w2["omega_dot"], ecc=w2["ecc"],
        sqrt_a=w2["sqrt_a"], omega0_sc=w2["omega0"], idot_sc=w2["idot"],
        i0_sc=w3["i0"], omega_sc=w3["omega"], delta_n_sc=w3["delta_n"],
        cuc=w3["cuc"], cus=w3["cus"], crc=w3["crc"], crs=w3["crs"],
        toe=w3["toe"],
        cic=w4.get("cic", 0.0), cis=w4.get("cis", 0.0),
        bgd_e1e5a=w1["bgd_e1e5a"],
        tgd=w1["bgd_e1e5a"] * _F_E1_E5A_SQ,
    )


def pages_for_ephemeris(eph, t0_gst_s: float, n_repeats: int = 2,
                        iono: dict | None = None) -> np.ndarray:
    """F/NAV symbol stream {0,1} cycling words 1,2,3,4; every word's TOW
    field stamps the GST of its own page's first symbol.  `t0_gst_s` must
    be a multiple of 10 s (page grid)."""
    if t0_gst_s % PAGE_SECONDS:
        raise ValueError("t0_gst_s must be a multiple of 10 s (page grid)")
    words = galileo_ephemeris_to_fnav_words(eph, iono)
    out = []
    page_i = 0
    for _ in range(n_repeats):
        for wt in (1, 2, 3, 4):
            f = dict(words[wt])
            f["tow"] = (t0_gst_s + page_i * PAGE_SECONDS) % 604800
            out.append(encode_page(pack_word(wt, f)))
            page_i += 1
    return np.concatenate(out)


@dataclasses.dataclass
class FnavWordEvent:
    word_type: int
    fields: dict
    page_start_symbol: int      # stream index of the page's first symbol
    crc_ok: bool


class FnavPageDecoder:
    """Streaming F/NAV page synchronizer/decoder for one channel (soft
    50-sps symbols in, FnavWordEvents out); the INAV decoder's structure
    with the 12-symbol uncoded sync pattern and 8x61 deinterleaver."""

    CRC_ERROR_LIMIT = 4

    def __init__(self):
        self.sym: list[float] = []
        self._aligned = False
        self._inverted = False
        self._next_page = 0
        self._crc_fails = 0

    def push_symbols(self, soft) -> list[FnavWordEvent]:
        self.sym.extend(float(s) for s in soft)
        events = []
        while True:
            if not self._aligned and not self._try_align():
                break
            if len(self.sym) < self._next_page + PAGE_SYMBOLS:
                break
            ev = self._decode_page()
            if ev is not None:
                events.append(ev)
        return events

    def _try_align(self) -> bool:
        s = np.sign(np.asarray(self.sym, dtype=np.float64))
        pre = 2.0 * PREAMBLE - 1.0
        n = len(s)
        i = self._next_page
        while i + PAGE_SYMBOLS + len(PREAMBLE) <= n:
            c0 = float(np.dot(s[i:i + 12], pre))
            if abs(c0) == 12.0:
                c1 = float(np.dot(s[i + PAGE_SYMBOLS:
                                    i + PAGE_SYMBOLS + 12], pre))
                if c1 == c0:
                    self._aligned = True
                    self._inverted = c0 < 0
                    self._next_page = i
                    return True
            i += 1
        self._next_page = max(self._next_page, n - PAGE_SYMBOLS - 12)
        return False

    def _decode_page(self):
        i = self._next_page
        raw = np.asarray(self.sym[i + 12:i + PAGE_SYMBOLS],
                         dtype=np.float32)
        if self._inverted:
            raw = -raw
        soft = deinterleave(raw).astype(np.float32)
        soft[1::2] = -soft[1::2]       # undo the G2 NOT gate
        bits = viterbi27_decode(soft).astype(np.int64)[:PAGE_BITS]
        start = i
        self._next_page = i + PAGE_SYMBOLS
        ok, wt, fields = unpack_word(bits)
        if not ok:
            self._crc_fails += 1
            if self._crc_fails >= self.CRC_ERROR_LIMIT:
                self._aligned = False
                self._crc_fails = 0
            return FnavWordEvent(-1, {}, start, False)
        self._crc_fails = 0
        return FnavWordEvent(wt, fields, start, True)


def e5a_epoch_signs(symbols01: np.ndarray, prn: int) -> np.ndarray:
    """F/NAV symbols {0,1} at 50 sps -> +-1 per 1 ms E5a code epoch: each
    20 ms symbol is spread by the satellite's 20-chip secondary code (the
    per-epoch modulation the simulator applies)."""
    cs = signals.e5a_secondary_code(prn, "I").astype(np.int64)
    sym = 2 * np.asarray(symbols01, np.int64) - 1
    return (np.repeat(sym, 20) * np.tile(cs, len(sym))).astype(np.int8)
