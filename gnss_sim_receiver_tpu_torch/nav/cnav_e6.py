"""Galileo E6-B C/NAV page layer (HAS SIS ICD 1.0, section 2.3).

One C/NAV page per second at 1000 sps: a 16-symbol preamble
(1011011101110000) followed by 984 symbols — the 8x123 block-interleaved,
rate-1/2 K=7 convolutional encoding (G2 NOT'd, like I/NAV) of 492 bits:

    462 "HAS page" bits (14 reserved + 24 page header + 424 message bits)
  +  24 CRC-24Q over those 462
  +   6 zero tail bits

The 424 message bits are 53 octets: one row of the HAS Reed-Solomon
C-matrix, indexed by the header's message page ID (PID).

Role equivalent of the reference's E6 telemetry path
(galileo_telemetry_decoder_gs.cc:253,682-720 decode_CNAV_word) and
galileo_cnav_message.cc (read_HAS_page / read_HAS_page_header); the
encoder half replaces a signal generator the reference lacks.  Page
constants: Galileo_CNAV.h:60-107.

Copy of ``gnss_sim_receiver_tpu.nav.cnav_e6`` for the PyTorch port (the
port imports nothing from the JAX package).  The JAX module decodes
through its C helper library (``native.viterbi27_decode``); the port
takes the NumPy decoder of ``nav.fec``, bit-exact with it, and the
encoder and CRC from there too (the G2 output inverted, as on I/NAV).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch.nav.fec import (conv27_encode, crc24q,
                                              viterbi27_decode)

PREAMBLE = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0],
                    np.int64)                       # Galileo_CNAV.h:99
SYMBOLS_PER_PAGE = 1000
RESERVED_BITS = 14
HEADER_BITS = 24
MESSAGE_BITS = 424          # 53 octets
DATA_BITS = RESERVED_BITS + HEADER_BITS + MESSAGE_BITS   # 462, CRC'd
PAGE_BITS = DATA_BITS + 24 + 6                           # 492
CODED_SYMBOLS = 2 * PAGE_BITS                            # 984
INTERLEAVER_ROWS = 8
INTERLEAVER_COLS = 123
OCTETS_PER_PAGE = 53


def interleave(coded: np.ndarray) -> np.ndarray:
    """tx[r*123 + c] = coded[c*8 + r] (inverse of the reference's
    deinterleaver with rows=8, cols=123)."""
    return np.asarray(coded).reshape(INTERLEAVER_COLS,
                                     INTERLEAVER_ROWS).T.reshape(-1)


def deinterleave(rx: np.ndarray) -> np.ndarray:
    return np.asarray(rx).reshape(INTERLEAVER_ROWS,
                                  INTERLEAVER_COLS).T.reshape(-1)


def _bits(value: int, n: int) -> np.ndarray:
    return np.array([(int(value) >> (n - 1 - i)) & 1 for i in range(n)],
                    np.int64)


def _val(bits: np.ndarray) -> int:
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


@dataclasses.dataclass
class HasPageHeader:
    """24-bit C/NAV page header (HAS SIS ICD Table 6;
    Galileo_CNAV.h:102-107 field positions)."""
    has_status: int = 0       # 0=test, 1=operational, 2=reserved, 3=dnu
    reserved: int = 0
    message_type: int = 1     # only MT1 defined
    message_id: int = 0       # 5 bits
    message_size: int = 1     # 5 bits: number of pages s (1..32)
    message_page_id: int = 1  # 8 bits: PID (1..255)

    def pack(self) -> np.ndarray:
        return np.concatenate([
            _bits(self.has_status, 2), _bits(self.reserved, 2),
            _bits(self.message_type, 2), _bits(self.message_id, 5),
            _bits(self.message_size, 5), _bits(self.message_page_id, 8)])

    @staticmethod
    def unpack(bits: np.ndarray) -> "HasPageHeader":
        return HasPageHeader(
            has_status=_val(bits[0:2]), reserved=_val(bits[2:4]),
            message_type=_val(bits[4:6]), message_id=_val(bits[6:11]),
            message_size=_val(bits[11:16]),
            message_page_id=_val(bits[16:24]))


@dataclasses.dataclass
class HasPageEvent:
    """One CRC-clean C/NAV page."""
    header: HasPageHeader
    octets: np.ndarray        # [53] uint8 message octets (one C-matrix row)
    start_symbol: int         # stream symbol index of the page's preamble
    crc_ok: bool


def encode_page(header: HasPageHeader, octets: np.ndarray) -> np.ndarray:
    """53 message octets + header -> 1000 tx symbols {0,1}."""
    octets = np.asarray(octets, np.int64)
    if len(octets) != OCTETS_PER_PAGE:
        raise ValueError("need 53 octets")
    msg_bits = np.unpackbits(octets.astype(np.uint8)[:, None],
                             axis=1).reshape(-1).astype(np.int64)
    data = np.concatenate([np.zeros(RESERVED_BITS, np.int64),
                           header.pack(), msg_bits])
    crc = crc24q(data)
    bits = np.concatenate([data, _bits(crc, 24), np.zeros(6, np.int64)])
    coded = conv27_encode(bits, invert_g2=True)
    return np.concatenate([PREAMBLE, interleave(coded)])


def decode_page_symbols(soft: np.ndarray) -> HasPageEvent | None:
    """984 soft symbols (positive value = bit 1, preamble already stripped
    and polarity corrected — the streaming CnavPageDecoder handles the
    sign ambiguity) -> page event; crc_ok False on CRC failure."""
    raw = deinterleave(np.asarray(soft, np.float32)).astype(np.float32)
    raw[1::2] = -raw[1::2]                     # undo the G2 NOT gate
    bits = viterbi27_decode(raw).astype(np.int64)[:PAGE_BITS]
    crc_rx = _val(bits[DATA_BITS:DATA_BITS + 24])
    ok = crc24q(bits[:DATA_BITS]) == crc_rx
    header = HasPageHeader.unpack(bits[RESERVED_BITS:
                                       RESERVED_BITS + HEADER_BITS])
    msg = bits[RESERVED_BITS + HEADER_BITS:DATA_BITS]
    octets = np.packbits(msg.astype(np.uint8)).astype(np.uint8)
    return HasPageEvent(header=header, octets=octets, start_symbol=0,
                        crc_ok=ok)


class CnavPageDecoder:
    """Streaming E6-B page synchronizer for one channel: preamble lock on
    two consecutive 1000-symbol-spaced preambles, then page-at-a-time
    decode (the E6 arm of galileo_telemetry_decoder_gs.cc)."""

    CRC_ERROR_LIMIT = 6

    def __init__(self):
        self.sym: list[float] = []
        self._base = 0              # absolute stream index of self.sym[0]
        self._aligned = False
        self._inverted = False
        self._next = 0              # absolute stream index
        self._crc_fails = 0

    def push_symbols(self, soft) -> list[HasPageEvent]:
        self.sym.extend(float(s) for s in soft)
        events = []
        while True:
            if not self._aligned and not self._try_align():
                break
            if self._base + len(self.sym) < self._next + SYMBOLS_PER_PAGE:
                break
            ev = self._decode_page()
            if ev is not None:
                events.append(ev)
        # bounded memory: drop consumed symbols (everything before _next —
        # both decode and a failed alignment scan advance it)
        drop = self._next - self._base
        if drop > 0:
            del self.sym[:drop]
            self._base = self._next
        return events

    def _try_align(self) -> bool:
        s = np.sign(np.asarray(self.sym, np.float64))
        pre = 2.0 * PREAMBLE - 1.0
        n = len(s)
        i = self._next - self._base
        while i + SYMBOLS_PER_PAGE + len(PREAMBLE) <= n:
            c0 = float(np.dot(s[i:i + 16], pre))
            if abs(c0) == 16.0:
                c1 = float(np.dot(s[i + SYMBOLS_PER_PAGE:
                                    i + SYMBOLS_PER_PAGE + 16], pre))
                if c1 == c0:
                    self._aligned = True
                    self._inverted = c0 < 0
                    self._next = self._base + i
                    return True
            i += 1
        self._next = max(self._next,
                         self._base + n - SYMBOLS_PER_PAGE - 16)
        return False

    def _decode_page(self) -> HasPageEvent | None:
        i = self._next - self._base
        raw = np.asarray(self.sym[i + 16:i + SYMBOLS_PER_PAGE], np.float32)
        if self._inverted:
            raw = -raw
        ev = decode_page_symbols(raw)
        start_abs = self._next
        self._next = start_abs + SYMBOLS_PER_PAGE
        if ev is None or not ev.crc_ok:
            self._crc_fails += 1
            if self._crc_fails >= self.CRC_ERROR_LIMIT:
                self._aligned = False
                self._crc_fails = 0
            return ev
        self._crc_fails = 0
        ev.start_symbol = start_abs
        return ev


def e6b_epoch_signs(symbols01: np.ndarray) -> np.ndarray:
    """C/NAV symbols {0,1} at 1000 sps -> +-1 per 1 ms E6-B code epoch
    (one symbol per code period; the simulator's nav_bits for "E6")."""
    return (1.0 - 2.0 * np.asarray(symbols01, np.float64))
