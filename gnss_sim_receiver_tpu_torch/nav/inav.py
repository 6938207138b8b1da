"""Galileo E1B and E5b-I I/NAV message layer: page encode (simulator) and
decode, and the E5b-I per-epoch CS4 spreading of the symbols.

Mirrors the reference's galileo_inav_message.cc (split_page, CRC-24Q test,
page_jk_decoder word layouts from Galileo_INAV.h) and the INAV part of
galileo_telemetry_decoder_gs.cc (preamble sync, 8x30 block deinterleaver,
G2-inverted rate-1/2 K=7 convolutional code, even/odd page join) — see
src/algorithms/telemetry_decoder/gnuradio_blocks/
galileo_telemetry_decoder_gs.cc:342-425 and
src/core/system_parameters/galileo_inav_message.cc:47-198.

Copy of ``gnss_sim_receiver_tpu.nav.inav`` for the PyTorch port, with the
NumPy Viterbi decoder of nav.fec in place of the JAX package's native
helper library.

Structure per the Galileo OS SIS ICD 2.0:
  nominal page = 2 s = even part (1 s) + odd part (1 s);
  each part    = 10-symbol preamble 0101100000 + 240 coded symbols;
  240 symbols  = rate-1/2 conv. coding (K=7, G1=171o, G2=133o, G2 output
                 NOT-ed) of 114 part bits + 6 zero tail bits, then 8x30
                 block interleaving (written per rows of 30, read per
                 columns of 8 — deinterleaver out[c*8+r] = in[r*30+c]);
  even part    = [even/odd=0, page type, Data_k(112)]            (114 bits)
  odd part     = [even/odd=1, page type, Data_j(16), OSNMA(40),
                  SAR(22), spare(2), CRC24(24), SSP(8)]          (114 bits)
  CRC-24Q over even(114) + odd bits before the CRC field (82) = 196 bits.
  Data_jk (128 bits) = word type (6) + content (words 1-5 here).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import signals
from gnss_sim_receiver_tpu_torch.nav.fec import (conv27_encode, crc24q,
                                                 viterbi27_decode)

PREAMBLE = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.int64)
PART_SYMBOLS = 250          # incl. preamble
PART_SECONDS = 1.0
PAGE_SECONDS = 2.0
DATA_SYMBOLS = 240
PART_BITS = 114
DATA_JK_BITS = 128
CRC_FRAME_BITS = 196

# plain SSP patterns cycled over nominal pages (Galileo_INAV.h:283-285)
_SSP = (np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int64),
        np.array([0, 0, 1, 0, 1, 0, 1, 1], np.int64),
        np.array([0, 0, 1, 0, 1, 1, 1, 1], np.int64))


# The K=7 rate-1/2 code (G1=171o, G2=133o) with Galileo's G2 output NOT-ed
# (ICD figure 13; undone in the reference at
# galileo_telemetry_decoder_gs.cc:360-368 by negating odd-index symbols),
# the CRC-24Q and the Viterbi decoder live in nav.fec, shared with F/NAV and
# CNAV.

def interleave(coded: np.ndarray) -> np.ndarray:
    """Transmit order: tx[r*30+c] = coded[c*8+r] (inverse of the reference
    deinterleaver, galileo_telemetry_decoder_gs.cc:342-352)."""
    return np.asarray(coded).reshape(30, 8).T.reshape(-1)


def deinterleave(rx: np.ndarray) -> np.ndarray:
    return np.asarray(rx).reshape(8, 30).T.reshape(-1)


# --------------------------------------------------------------------------
# Word (Data_jk, 128 bits) field layouts — Galileo_INAV.h bit tables.
# name -> (start_bit 1-indexed, n_bits, scale, signed); angle scales are in
# SEMICIRCLES to match the GpsEphemeris *_sc convention.
# --------------------------------------------------------------------------

_W1 = {
    "iod_nav": (7, 10, 1.0, False),
    "toe":     (17, 14, 60.0, False),
    "m0":      (31, 32, 2.0 ** -31, True),
    "ecc":     (63, 32, 2.0 ** -33, False),
    "sqrt_a":  (95, 32, 2.0 ** -19, False),
}
_W2 = {
    "iod_nav": (7, 10, 1.0, False),
    "omega0":  (17, 32, 2.0 ** -31, True),
    "i0":      (49, 32, 2.0 ** -31, True),
    "omega":   (81, 32, 2.0 ** -31, True),
    "idot":    (113, 14, 2.0 ** -43, True),
}
_W3 = {
    "iod_nav":   (7, 10, 1.0, False),
    "omega_dot": (17, 24, 2.0 ** -43, True),
    "delta_n":   (41, 16, 2.0 ** -43, True),
    "cuc":       (57, 16, 2.0 ** -29, True),
    "cus":       (73, 16, 2.0 ** -29, True),
    "crc":       (89, 16, 2.0 ** -5, True),
    "crs":       (105, 16, 2.0 ** -5, True),
    "sisa":      (121, 8, 1.0, False),
}
_W4 = {
    "iod_nav": (7, 10, 1.0, False),
    "svid":    (17, 6, 1.0, False),
    "cic":     (23, 16, 2.0 ** -29, True),
    "cis":     (39, 16, 2.0 ** -29, True),
    "toc":     (55, 14, 60.0, False),
    "af0":     (69, 31, 2.0 ** -34, True),
    "af1":     (100, 21, 2.0 ** -46, True),
    "af2":     (121, 6, 2.0 ** -59, True),
}
_W5 = {
    "ai0":        (7, 11, 2.0 ** -2, False),
    "ai1":        (18, 11, 2.0 ** -8, True),
    "ai2":        (29, 14, 2.0 ** -15, True),
    "region1":    (43, 1, 1.0, False),
    "region2":    (44, 1, 1.0, False),
    "region3":    (45, 1, 1.0, False),
    "region4":    (46, 1, 1.0, False),
    "region5":    (47, 1, 1.0, False),
    "bgd_e1e5a":  (48, 10, 2.0 ** -32, True),
    "bgd_e1e5b":  (58, 10, 2.0 ** -32, True),
    "e5b_hs":     (68, 2, 1.0, False),
    "e1b_hs":     (70, 2, 1.0, False),
    "e5b_dvs":    (72, 1, 1.0, False),
    "e1b_dvs":    (73, 1, 1.0, False),
    "wn":         (74, 12, 1.0, False),
    "tow":        (86, 20, 1.0, False),
}
# Word 6: GST-UTC conversion (subset); word 0: time/spare
_W6 = {
    "a0":       (7, 32, 2.0 ** -30, True),
    "a1":       (39, 24, 2.0 ** -50, True),
    "dt_ls":    (63, 8, 1.0, True),
    "t0t":      (71, 8, 3600.0, False),
    "wn0t":     (79, 8, 1.0, False),
    "wn_lsf":   (87, 8, 1.0, False),
    "dn":       (95, 3, 1.0, False),
    "dt_lsf":   (98, 8, 1.0, True),
    "tow":      (106, 20, 1.0, False),
}
WORD_FIELDS = {1: _W1, 2: _W2, 3: _W3, 4: _W4, 5: _W5, 6: _W6}


def pack_word(word_type: int, fields: dict[str, float]) -> np.ndarray:
    """Physical fields -> 128-bit Data_jk array (word type in bits 1-6)."""
    bits = np.zeros(DATA_JK_BITS, dtype=np.int64)
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
    return bits


def unpack_word(data_jk: np.ndarray) -> tuple[int, dict[str, float]]:
    """128-bit Data_jk -> (word_type, physical fields)."""
    b = np.asarray(data_jk, dtype=np.int64)
    word_type = 0
    for i in range(6):
        word_type = (word_type << 1) | int(b[i])
    fields = {}
    layout = WORD_FIELDS.get(word_type)
    if layout is None:
        return word_type, fields
    for name, (start, n, scale, signed) in layout.items():
        raw = 0
        for i in range(n):
            raw = (raw << 1) | int(b[start - 1 + i])
        if signed and raw >> (n - 1):
            raw -= 1 << n
        fields[name] = raw * scale
    return word_type, fields


# --------------------------------------------------------------------------
# Page assembly (encode) and streaming decode
# --------------------------------------------------------------------------

def encode_page(data_jk: np.ndarray, ssp_idx: int = 0) -> np.ndarray:
    """One nominal page (500 symbols {0,1}) carrying the 128-bit word."""
    even = np.zeros(PART_BITS, dtype=np.int64)
    even[0] = 0                     # even/odd
    even[1] = 0                     # page type: nominal
    even[2:114] = data_jk[:112]     # Data_k
    odd = np.zeros(PART_BITS, dtype=np.int64)
    odd[0] = 1
    odd[1] = 0
    odd[2:18] = data_jk[112:128]    # Data_j
    # OSNMA(40) + SAR(22) + spare(2) left zero at bits 18..81
    crc = crc24q(np.concatenate([even, odd[:82]]))
    for i in range(24):
        odd[82 + i] = (crc >> (23 - i)) & 1
    odd[106:114] = _SSP[ssp_idx % 3]
    parts = []
    for part in (even, odd):
        coded = conv27_encode(np.concatenate([part, np.zeros(6, np.int64)]),
                              invert_g2=True)
        parts.append(np.concatenate([PREAMBLE, interleave(coded)]))
    return np.concatenate(parts)


def pages_for_ephemeris(eph, t0_gst_s: float, n_repeats: int = 3,
                        iono: dict | None = None) -> np.ndarray:
    """INAV symbol stream {0,1} cycling words 1,2,3,4,5 (+0 spare), with
    word 5's GST stamped so TOW_5 = GST at its even-part start — the
    semantics the reference recovers at galileo_telemetry_decoder_gs.cc:1109
    (TOW_at_Preamble = TOW5).  `t0_gst_s` is the GST of symbol 0 and must be
    a multiple of 2 s (page grid)."""
    if t0_gst_s % PAGE_SECONDS:
        raise ValueError("t0_gst_s must be a multiple of 2 s (page grid)")
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        galileo_ephemeris_to_words
    words = galileo_ephemeris_to_words(eph)
    iono = iono or {}
    out = []
    page_i = 0
    for _ in range(n_repeats):
        for wt in (1, 2, 3, 4, 5):
            f = dict(words[wt])
            if wt == 5:
                f.update(iono)
                f["wn"] = eph.week
                f["tow"] = (t0_gst_s + page_i * PAGE_SECONDS) % 604800
            out.append(encode_page(pack_word(wt, f), ssp_idx=page_i))
            page_i += 1
    return np.concatenate(out)


@dataclasses.dataclass
class InavWordEvent:
    word_type: int
    fields: dict
    page_start_symbol: int   # stream index of the even part's first symbol
    crc_ok: bool


class InavPageDecoder:
    """Streaming INAV page synchronizer/decoder for one channel.

    Feed soft symbols (prompt correlator outputs at 250 sps, sign = bit,
    possibly 180-deg phase flipped); emits InavWordEvents.  Implements the
    preamble lock -> part decode -> even/odd join -> CRC pipeline of
    galileo_telemetry_decoder_gs.cc:938-1095 as a host-side scanner."""

    def __init__(self):
        self.sym: list[float] = []
        self._aligned = False
        self._inverted = False
        self._next_part = 0       # stream index of next part to decode
        self._even: np.ndarray | None = None
        self._even_start = 0
        self._crc_fails = 0

    def push_symbols(self, soft) -> list[InavWordEvent]:
        self.sym.extend(float(s) for s in soft)
        events = []
        while True:
            if not self._aligned and not self._try_align():
                break
            if len(self.sym) < self._next_part + PART_SYMBOLS:
                break
            ev = self._decode_part()
            if ev is not None:
                events.append(ev)
        return events

    # -- internals ----------------------------------------------------------
    def _try_align(self) -> bool:
        """Find a preamble at i confirmed by another at i+250 with the same
        polarity (the reference's preamble_diff == period check)."""
        s = np.sign(np.asarray(self.sym, dtype=np.float64))
        pre = 2.0 * PREAMBLE - 1.0  # bit {0,1} -> symbol sign {-1,+1}
        n = len(s)
        i = self._next_part
        while i + PART_SYMBOLS + len(PREAMBLE) <= n:
            c0 = float(np.dot(s[i:i + 10], pre))
            if abs(c0) == 10.0:
                c1 = float(np.dot(s[i + 250:i + 260], pre))
                if c1 == c0:
                    self._aligned = True
                    self._inverted = c0 < 0
                    self._next_part = i
                    return True
            i += 1
        self._next_part = max(self._next_part, n - PART_SYMBOLS - 10)
        return False

    def _decode_part(self):
        i = self._next_part
        raw = np.asarray(self.sym[i + 10:i + PART_SYMBOLS], dtype=np.float32)
        if self._inverted:
            raw = -raw
        soft = deinterleave(raw).astype(np.float32)
        soft[1::2] = -soft[1::2]        # undo the G2 NOT gate
        bits = viterbi27_decode(soft).astype(np.int64)[:PART_BITS]
        self._next_part = i + PART_SYMBOLS
        if bits[0] == 0:                # even part: stash
            self._even = bits
            self._even_start = i
            return None
        if self._even is None:
            return None
        even, self._even = self._even, None
        crc_rx = 0
        for k in range(24):
            crc_rx = (crc_rx << 1) | int(bits[82 + k])
        ok = crc24q(np.concatenate([even, bits[:82]])) == crc_rx
        if not ok:
            self._crc_fails += 1
            if self._crc_fails >= 6:    # reference CRC_ERROR_LIMIT
                self._aligned = False
                self._crc_fails = 0
            return InavWordEvent(-1, {}, self._even_start, False)
        self._crc_fails = 0
        data_jk = np.concatenate([even[2:114], bits[2:18]])
        wt, fields = unpack_word(data_jk)
        return InavWordEvent(wt, fields, self._even_start, True)


def e5b_epoch_signs(symbols01: np.ndarray) -> np.ndarray:
    """I/NAV symbols {0,1} at 250 sps -> +-1 per 1 ms E5b code epoch: each
    4 ms symbol is spread by the fixed 4-chip CS4 secondary code (the
    per-epoch modulation the simulator applies on E5b-I)."""
    cs = signals.e5b_secondary_code().astype(np.int64)
    sym = 2 * np.asarray(symbols01, np.int64) - 1
    return (np.repeat(sym, 4) * np.tile(cs, len(sym))).astype(np.int8)
