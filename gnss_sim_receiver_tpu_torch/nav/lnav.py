"""GPS LNAV (L1 C/A 50 bps) bit-level encode/decode.

Decoder mirrors the reference's gps_navigation_message.cc /
gps_l1_ca_telemetry_decoder_gs.cc (subframe sync, word parity, ephemeris
field extraction); the encoder is its exact inverse and feeds the signal
simulator (the role bladeGPS's LNAV generator plays for the reference).

All per IS-GPS-200: 30-bit words = 24 data + 6 parity with the (D29*, D30*)
recursion of Table 20-XIV; subframes of 10 words; fields of subframes 1-3
per Table 20-III.  Bit numbering: d1..d24 MSB-first within a word.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PREAMBLE_BITS = (1, 0, 0, 0, 1, 0, 1, 1)
WORDS_PER_SUBFRAME = 10
BITS_PER_WORD = 30
BITS_PER_SUBFRAME = 300
SUBFRAME_SECONDS = 6.0
BIT_PERIOD_MS = 20.0

# Parity equations (IS-GPS-200 Table 20-XIV): for D25..D30, the indices of
# d1..d24 XORed in, and whether D29* (False) or D30* (True) seeds the sum.
_PARITY_TAPS = (
    ((1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23), False),   # D25
    ((2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24), True),    # D26
    ((1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22), False),    # D27
    ((2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23), True),     # D28
    ((1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24), True),  # D29
    ((3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24), False),       # D30
)


def _parity6(d: np.ndarray, d29s: int, d30s: int) -> list[int]:
    """Compute D25..D30 from data bits d[0..23] (already source bits, not
    yet complemented) and previous-word parity bits."""
    out = []
    for taps, use_d30 in _PARITY_TAPS:
        acc = d30s if use_d30 else d29s
        for t in taps:
            acc ^= int(d[t - 1])
        out.append(acc)
    return out


def encode_word(data24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Source 24 data bits -> transmitted 30-bit word.  Transmitted data
    bits are complemented by D30* (IS-GPS-200 20.3.5)."""
    d = np.asarray(data24, dtype=np.int64)
    par = _parity6(d, d29s, d30s)
    tx = np.empty(30, dtype=np.int64)
    tx[:24] = d ^ d30s
    tx[24:] = par
    return tx


def solve_parity_bits(data22: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """For HOW (word 2) and word 10: choose the two non-information bits
    d23, d24 so that transmitted D29 = D30 = 0 (IS-GPS-200 20.3.3.2)."""
    for b23 in (0, 1):
        for b24 in (0, 1):
            d = np.concatenate([data22, [b23, b24]]).astype(np.int64)
            par = _parity6(d, d29s, d30s)
            if par[4] == 0 and par[5] == 0:
                return d
    raise AssertionError("parity solve failed")  # impossible: XOR is affine


def check_word(word30: np.ndarray, d29s: int, d30s: int):
    """Parity-check one received 30-bit word given the previous word's last
    two bits.  Returns (ok, decoded 24 source bits) — mirrors
    gps_l1_ca_telemetry_decoder_gs.cc:191 gps_word_parityCheck."""
    w = np.asarray(word30, dtype=np.int64)
    d = w[:24] ^ d30s           # undo complement
    par = _parity6(d, d29s, d30s)
    return bool((w[24:] == par).all()), d


# --------------------------------------------------------------------------
# Subframe field layout (IS-GPS-200 Table 20-III).  Each field is a list of
# (word_index 1..10, start_bit 1..24, n_bits) segments, MSB first, plus a
# scale factor (applied as raw * 2^scale_exp) and signedness.
# --------------------------------------------------------------------------

_SF1_FIELDS = {
    "week":   ([(3, 1, 10)], 0, False),
    "ura":    ([(3, 13, 4)], 0, False),
    "health": ([(3, 17, 6)], 0, False),
    "iodc":   ([(3, 23, 2), (8, 1, 8)], 0, False),
    "tgd":    ([(7, 17, 8)], -31, True),
    "toc":    ([(8, 9, 16)], 4, False),
    "af2":    ([(9, 1, 8)], -55, True),
    "af1":    ([(9, 9, 16)], -43, True),
    "af0":    ([(10, 1, 22)], -31, True),
}
_SF2_FIELDS = {
    "iode":    ([(3, 1, 8)], 0, False),
    "crs":     ([(3, 9, 16)], -5, True),
    "delta_n": ([(4, 1, 16)], -43, True),     # semicircles/s
    "m0":      ([(4, 17, 8), (5, 1, 24)], -31, True),
    "cuc":     ([(6, 1, 16)], -29, True),
    "ecc":     ([(6, 17, 8), (7, 1, 24)], -33, False),
    "cus":     ([(8, 1, 16)], -29, True),
    "sqrt_a":  ([(8, 17, 8), (9, 1, 24)], -19, False),
    "toe":     ([(10, 1, 16)], 4, False),
}
_SF3_FIELDS = {
    "cic":       ([(3, 1, 16)], -29, True),
    "omega0":    ([(3, 17, 8), (4, 1, 24)], -31, True),
    "cis":       ([(5, 1, 16)], -29, True),
    "i0":        ([(5, 17, 8), (6, 1, 24)], -31, True),
    "crc":       ([(7, 1, 16)], -5, True),
    "omega":     ([(7, 17, 8), (8, 1, 24)], -31, True),
    "omega_dot": ([(9, 1, 24)], -43, True),   # semicircles/s
    "iode_sf3":  ([(10, 1, 8)], 0, False),
    "idot":      ([(10, 9, 14)], -43, True),  # semicircles/s
}
_FIELDS_BY_SF = {1: _SF1_FIELDS, 2: _SF2_FIELDS, 3: _SF3_FIELDS}

# Subframe 4/5 page layouts (IS-GPS-200 20.3.3.5.1.2): pages carry a
# 2-bit data ID + 6-bit SV ID in word 3; SV ID 1-32 = almanac for that
# PRN, SV ID 56 (SF4 page 18) = iono/UTC parameters.
_SF_ALM_FIELDS = {
    "data_id":   ([(3, 1, 2)], 0, False),
    "sv_id":     ([(3, 3, 6)], 0, False),
    "ecc":       ([(3, 9, 16)], -21, False),
    "toa":       ([(4, 1, 8)], 12, False),
    "delta_i":   ([(4, 9, 16)], -19, True),    # semicircles, rel. to 0.3
    "omega_dot": ([(5, 1, 16)], -38, True),    # semicircles/s
    "health":    ([(5, 17, 8)], 0, False),
    "sqrt_a":    ([(6, 1, 24)], -11, False),
    "omega0":    ([(7, 1, 24)], -23, True),
    "omega":     ([(8, 1, 24)], -23, True),
    "m0":        ([(9, 1, 24)], -23, True),
    "af0":       ([(10, 1, 8), (10, 20, 3)], -20, True),
    "af1":       ([(10, 9, 11)], -38, True),
}
_SF_IONO_FIELDS = {
    "data_id":     ([(3, 1, 2)], 0, False),
    "sv_id":       ([(3, 3, 6)], 0, False),
    "alpha0":      ([(3, 9, 8)], -30, True),
    "alpha1":      ([(3, 17, 8)], -27, True),
    "alpha2":      ([(4, 1, 8)], -24, True),
    "alpha3":      ([(4, 9, 8)], -24, True),
    "beta0":       ([(4, 17, 8)], 11, True),
    "beta1":       ([(5, 1, 8)], 14, True),
    "beta2":       ([(5, 9, 8)], 16, True),
    "beta3":       ([(5, 17, 8)], 16, True),
    "a1":          ([(6, 1, 24)], -50, True),
    "a0":          ([(7, 1, 24), (8, 1, 8)], -30, True),
    "tot":         ([(8, 9, 8)], 12, False),
    "wn_t":        ([(8, 17, 8)], 0, False),
    "delta_t_ls":  ([(9, 1, 8)], 0, True),
    "wn_lsf":      ([(9, 9, 8)], 0, False),
    "dn":          ([(9, 17, 8)], 0, False),
    "delta_t_lsf": ([(10, 1, 8)], 0, True),
}
IONO_SV_ID = 56            # SF4 page 18


def pack_page45(sf_id: int, tow_next_s: float, sv_id: int,
                physical: dict[str, float]) -> np.ndarray:
    """Subframe 4/5 page source bits: almanac page (sv_id 1-32) or the
    iono/UTC page (sv_id 56)."""
    words = np.zeros((WORDS_PER_SUBFRAME, 24), dtype=np.int64)
    words[0, :8] = PREAMBLE_BITS
    tow_count = int(round(tow_next_s / 6.0)) % (1 << 17)
    for i in range(17):
        words[1, i] = (tow_count >> (16 - i)) & 1
    words[1, 19:22] = (1, 0, 0) if sf_id == 4 else (1, 0, 1)
    fields = _SF_IONO_FIELDS if sv_id == IONO_SV_ID else _SF_ALM_FIELDS
    physical = dict(physical, data_id=1, sv_id=sv_id)
    for name, (segments, scale_exp, signed) in fields.items():
        total = sum(n for _, _, n in segments)
        raw = int(round(physical.get(name, 0.0) / (2.0 ** scale_exp)))
        if signed:
            lim = 1 << (total - 1)
            raw = max(-lim, min(lim - 1, raw))
        else:
            raw = max(0, min((1 << total) - 1, raw))
        _insert_raw(words, segments, raw)
    return words


def unpack_page45(words: np.ndarray) -> tuple[int, dict[str, float]]:
    """(sv_id, fields) for a subframe 4/5 page's source bits."""
    sv_id = _extract_raw(words, [(3, 3, 6)])
    fields = _SF_IONO_FIELDS if sv_id == IONO_SV_ID else _SF_ALM_FIELDS
    out = {}
    for name, (segments, scale_exp, signed) in fields.items():
        total = sum(n for _, _, n in segments)
        raw = _extract_raw(words, segments)
        if signed:
            raw = _to_signed(raw, total)
        out[name] = raw * (2.0 ** scale_exp)
    return int(sv_id), out


def _insert_raw(words: np.ndarray, segments, raw: int) -> None:
    total = sum(n for _, _, n in segments)
    raw &= (1 << total) - 1
    pos = 0
    for word, start, n in segments:
        seg = (raw >> (total - pos - n)) & ((1 << n) - 1)
        for i in range(n):
            words[word - 1, start - 1 + i] = (seg >> (n - 1 - i)) & 1
        pos += n


def _extract_raw(words: np.ndarray, segments) -> int:
    raw = 0
    for word, start, n in segments:
        for i in range(n):
            raw = (raw << 1) | int(words[word - 1, start - 1 + i])
    return raw


def _to_signed(raw: int, n_bits: int) -> int:
    return raw - (1 << n_bits) if raw >> (n_bits - 1) else raw


def pack_subframe(sf_id: int, tow_next_s: float,
                  physical: dict[str, float]) -> np.ndarray:
    """Build one subframe's 10x24 source data bits.  `tow_next_s` is the GPS
    TOW (seconds) of the START OF THE NEXT subframe (HOW semantics).
    `physical` maps field name -> physical value (scaling applied here)."""
    words = np.zeros((WORDS_PER_SUBFRAME, 24), dtype=np.int64)
    # word 1: TLM — preamble + message (zeros)
    words[0, :8] = PREAMBLE_BITS
    # word 2: HOW — 17-bit truncated TOW count (units of 6 s = 1.5s*4),
    # alert=0, AS=0, subframe id; last 2 bits solved later
    tow_count = int(round(tow_next_s / 6.0)) % (1 << 17)
    for i in range(17):
        words[1, i] = (tow_count >> (16 - i)) & 1
    sf_bits = (0, 0, 1) if sf_id == 1 else ((0, 1, 0) if sf_id == 2
                                            else (0, 1, 1))
    words[1, 19:22] = sf_bits
    fields = _FIELDS_BY_SF[sf_id]
    for name, (segments, scale_exp, signed) in fields.items():
        total = sum(n for _, _, n in segments)
        raw = int(round(physical.get(name, 0.0) / (2.0 ** scale_exp)))
        if signed:
            lim = 1 << (total - 1)
            raw = max(-lim, min(lim - 1, raw))
        else:
            raw = max(0, min((1 << total) - 1, raw))
        _insert_raw(words, segments, raw)
    return words


def unpack_subframe(sf_id: int, words: np.ndarray) -> dict[str, float]:
    """Inverse of pack_subframe on parity-checked source data bits."""
    out = {}
    for name, (segments, scale_exp, signed) in _FIELDS_BY_SF[sf_id].items():
        total = sum(n for _, _, n in segments)
        raw = _extract_raw(words, segments)
        if signed:
            raw = _to_signed(raw, total)
        out[name] = raw * (2.0 ** scale_exp)
    return out


def decode_how(word2: np.ndarray):
    """(tow_next_s, subframe_id) from HOW source bits."""
    tow_count = 0
    for i in range(17):
        tow_count = (tow_count << 1) | int(word2[i])
    sf_id = (int(word2[19]) << 2) | (int(word2[20]) << 1) | int(word2[21])
    return tow_count * 6.0, sf_id


def encode_subframe_stream(subframes: list[np.ndarray]) -> np.ndarray:
    """Chain subframes through the parity recursion -> transmitted bit
    stream {0,1} of len 300*len(subframes).  D29*/D30* start at 0."""
    d29s = d30s = 0
    out = []
    for words in subframes:
        for w in range(WORDS_PER_SUBFRAME):
            data = np.array(words[w], dtype=np.int64)
            if w in (1, 9):  # HOW and word 10 carry parity-solve bits
                data = solve_parity_bits(data[:22], d29s, d30s)
            tx = encode_word(data, d29s, d30s)
            d29s, d30s = int(tx[28]), int(tx[29])
            out.append(tx)
    return np.concatenate(out)


def frames_for_ephemeris(eph, tow_first_subframe_s: float,
                         n_frames: int = 5,
                         subframe_cycle=(1, 2, 3, 4, 5),
                         almanac: list | None = None,
                         iono_utc: dict | None = None) -> np.ndarray:
    """LNAV bit stream carrying `eph` (a GpsEphemeris), starting with
    subframe 1 whose first bit is transmitted at tow_first_subframe_s.
    Cycles `subframe_cycle` (default the real 1..5; fixtures may use
    (1,2,3) to shorten time-to-ephemeris).

    Subframes 4/5 rotate real pages when assistance data is given:
    `almanac` is a list of (sv_id, fields) pages (IS-GPS-200
    20.3.3.5.1.2) and `iono_utc` the SF4-page-18 field dict; without
    them they are parity-valid filler."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import ephemeris_to_fields
    f1, f2, f3 = ephemeris_to_fields(eph)
    pages = list(almanac or [])
    if iono_utc is not None:
        pages.insert(0, (IONO_SV_ID, iono_utc))
    subframes = []
    tow = tow_first_subframe_s
    page_i = 0
    for _ in range(n_frames):
        for sf_id in subframe_cycle:
            tow += SUBFRAME_SECONDS
            if sf_id <= 3:
                words = pack_subframe(sf_id, tow, (f1, f2, f3)[sf_id - 1])
            elif pages:
                sv_id, fields = pages[page_i % len(pages)]
                page_i += 1
                words = pack_page45(sf_id, tow, sv_id, fields)
            else:
                words = pack_subframe(3, tow, {})  # filler with valid parity
                words[1, 19:22] = (1, 0, 0) if sf_id == 4 else (1, 0, 1)
            subframes.append(words)
    return encode_subframe_stream(subframes)


@dataclasses.dataclass
class SubframeEvent:
    sf_id: int
    tow_next_s: float
    fields: dict
    bit_index: int       # index (in the decoder's bit stream) of the
    #                      subframe's first bit
    # the preamble matched phase-inverted: the PLL is locked 180 deg off
    # (the reference's Flag_PLL_180_deg_phase_locked,
    # gps_l1_ca_telemetry_decoder_gs.cc frame_synchronization) — carrier
    # phase observables need a half-cycle correction
    inverted: bool = False


class LnavFrameDecoder:
    """Streaming subframe synchronizer + decoder for one channel.

    Feed hard bits {0,1} (20-ms nav bits, possibly phase-inverted);
    emits SubframeEvents.  Mirrors the preamble-correlation + parity frame
    sync of gps_l1_ca_telemetry_decoder_gs.cc:261-520."""

    def __init__(self):
        self.bits: list[int] = []
        self.events: list[SubframeEvent] = []
        self._next_search = 0

    def push_bits(self, bits) -> list[SubframeEvent]:
        self.bits.extend(int(b) for b in bits)
        new = []
        while True:
            ev = self._try_decode()
            if ev is None:
                break
            new.append(ev)
        self.events.extend(new)
        return new

    def _try_decode(self):
        pre = np.array(PREAMBLE_BITS)
        b = np.asarray(self.bits, dtype=np.int64)
        i = self._next_search
        while i + BITS_PER_SUBFRAME <= len(b):
            window = b[i:i + 8]
            direct = (window == pre).all()
            inverted = (window == (1 - pre)).all()
            if direct or inverted:
                w = b[i:i + BITS_PER_SUBFRAME] ^ (1 if inverted else 0)
                words = w.reshape(10, 30)
                # previous word's D29/D30 seed the parity chain; prefer the
                # actual preceding stream bits, but fall back to all four
                # combinations (a chance 10-word parity pass is ~2^-60, so
                # this cannot false-accept; it buys frame sync when the
                # preamble follows garbage, e.g. right after bit sync)
                cands = []
                if i >= 2:
                    cands.append((int(b[i - 2] ^ (1 if inverted else 0)),
                                  int(b[i - 1] ^ (1 if inverted else 0))))
                cands += [(0, 0), (0, 1), (1, 0), (1, 1)]
                ok = False
                src = np.zeros((10, 24), dtype=np.int64)
                for d29s, d30s in cands:
                    ok = True
                    p29, p30 = d29s, d30s
                    for k in range(10):
                        okk, data = check_word(words[k], p29, p30)
                        if not okk:
                            ok = False
                            break
                        src[k] = data
                        p29, p30 = int(words[k][28]), int(words[k][29])
                    if ok:
                        break
                if ok:
                    tow_next, sf_id = decode_how(src[1])
                    if sf_id in (1, 2, 3):
                        fields = unpack_subframe(sf_id, src)
                    elif sf_id in (4, 5):
                        sv_id, fields = unpack_page45(src)
                    else:
                        fields = {}
                    self._next_search = i + BITS_PER_SUBFRAME
                    return SubframeEvent(sf_id=sf_id, tow_next_s=tow_next,
                                         fields=fields, bit_index=i,
                                         inverted=bool(inverted))
            i += 1
        self._next_search = max(self._next_search,
                                len(b) - BITS_PER_SUBFRAME + 1)
        return None
