"""GPS CNAV message layer (L2C CM / L5I): encode (simulator) and decode.

The role of the reference's libswiftcnav C library
(src/algorithms/telemetry_decoder/libs/libswiftcnav/cnav_msg.c: preamble
search + sliding Viterbi + CRC gate) feeding
gps_l2c_telemetry_decoder_gs.cc / gps_l5_telemetry_decoder_gs.cc, plus the
CNAV ephemeris assembly of gps_cnav_navigation_message.cc.

Structure per IS-GPS-200 section 30 (L2C) / IS-GPS-705 (L5):
  message = 300 bits: preamble 10001011 (8) | PRN (6) | msg type (6) |
            TOW count (17, units of 6 s; TOW of the NEXT message start) |
            alert (1) | payload (238) | CRC-24Q (24)
  stream  = rate-1/2 K=7 convolutional code (G1=171o, G2=133o, no
            inversion), NOT block-terminated — a continuous symbol stream
            at 50 sps (L2C CM, 1 symbol / 20 ms code epoch) or 100 sps
            (L5I, 1 symbol / 10 Neuman-Hofman-wiped 1 ms epochs).

Message types implemented: 10 + 11 (ephemeris halves) and 30
(clock/TGD/iono) — the set the reference decodes for PVT.

Copy of ``gnss_sim_receiver_tpu.nav.cnav`` for the PyTorch port, with the
NumPy encoder and Viterbi decoder of nav.fec in place of the JAX package's
native helper library.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris
from gnss_sim_receiver_tpu_torch.nav.fec import (conv27_encode, crc24q,
                                                 viterbi27_decode)

PREAMBLE_BITS = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int64)
MSG_BITS = 300
CNAV_A_REF = 26_559_710.0          # semi-major axis reference [m]
CNAV_OMEGA_DOT_REF_SC = -2.6e-9    # Omega-dot reference [semicircles/s]

# field -> (start bit 1-indexed within the 300-bit message, n bits, scale,
# signed); headers occupy bits 1..38, CRC bits 277..300.  Angles in
# SEMICIRCLES (GpsEphemeris *_sc convention).  IS-GPS-200 figs 30-1/2/3,
# tables 30-I..III.
_HDR = {
    "prn":      (9, 6, 1.0, False),
    "msg_type": (15, 6, 1.0, False),
    "tow_6s":   (21, 17, 1.0, False),
    "alert":    (38, 1, 1.0, False),
}
_MT10 = {
    "wn":        (39, 13, 1.0, False),
    "health":    (52, 3, 1.0, False),
    "top":       (55, 11, 300.0, False),
    "ura_ed":    (66, 5, 1.0, True),
    "toe":       (71, 11, 300.0, False),
    "delta_a":   (82, 26, 2.0 ** -9, True),
    "a_dot":     (108, 25, 2.0 ** -21, True),
    "delta_n0":  (133, 17, 2.0 ** -44, True),
    "delta_n0_dot": (150, 23, 2.0 ** -57, True),
    "m0":        (173, 33, 2.0 ** -32, True),
    "ecc":       (206, 33, 2.0 ** -34, False),
    "omega":     (239, 33, 2.0 ** -32, True),
    "int_flags": (272, 3, 1.0, False),
}
_MT11 = {
    "toe":       (39, 11, 300.0, False),
    "omega0":    (50, 33, 2.0 ** -32, True),
    "i0":        (83, 33, 2.0 ** -32, True),
    "delta_omega_dot": (116, 17, 2.0 ** -44, True),
    "i0_dot":    (133, 15, 2.0 ** -44, True),
    "cis":       (148, 16, 2.0 ** -30, True),
    "cic":       (164, 16, 2.0 ** -30, True),
    "crs":       (180, 24, 2.0 ** -8, True),
    "crc":       (204, 24, 2.0 ** -8, True),
    "cus":       (228, 21, 2.0 ** -30, True),
    "cuc":       (249, 21, 2.0 ** -30, True),
}
_MT30 = {
    "top":       (39, 11, 300.0, False),
    "ura_ned0":  (50, 5, 1.0, True),
    "ura_ned1":  (55, 3, 1.0, False),
    "ura_ned2":  (58, 3, 1.0, False),
    "toc":       (61, 11, 300.0, False),
    "af0":       (72, 26, 2.0 ** -35, True),
    "af1":       (98, 20, 2.0 ** -48, True),
    "af2":       (118, 10, 2.0 ** -60, True),
    "tgd":       (128, 13, 2.0 ** -35, True),
    "isc_l1ca":  (141, 13, 2.0 ** -35, True),
    "isc_l2c":   (154, 13, 2.0 ** -35, True),
    "isc_l5i":   (167, 13, 2.0 ** -35, True),
    "isc_l5q":   (180, 13, 2.0 ** -35, True),
    "alpha0":    (193, 8, 2.0 ** -30, True),
    "alpha1":    (201, 8, 2.0 ** -27, True),
    "alpha2":    (209, 8, 2.0 ** -24, True),
    "alpha3":    (217, 8, 2.0 ** -24, True),
    "beta0":     (225, 8, 2.0 ** 11, True),
    "beta1":     (233, 8, 2.0 ** 14, True),
    "beta2":     (241, 8, 2.0 ** 16, True),
    "beta3":     (249, 8, 2.0 ** 16, True),
    "wn_op":     (257, 8, 1.0, False),
}
MSG_FIELDS = {10: _MT10, 11: _MT11, 30: _MT30}


def _put(bits, start, n, value, scale, signed):
    raw = int(round(value / scale))
    if signed:
        lim = 1 << (n - 1)
        raw = max(-lim, min(lim - 1, raw)) & ((1 << n) - 1)
    else:
        raw = max(0, min((1 << n) - 1, raw))
    for i in range(n):
        bits[start - 1 + i] = (raw >> (n - 1 - i)) & 1


def _get(bits, start, n, scale, signed):
    raw = 0
    for i in range(n):
        raw = (raw << 1) | int(bits[start - 1 + i])
    if signed and raw >> (n - 1):
        raw -= 1 << n
    return raw * scale


def pack_message(prn: int, msg_type: int, tow_s: float,
                 fields: dict[str, float]) -> np.ndarray:
    """One 300-bit CNAV message.  `tow_s` is the GPS TOW of the NEXT
    message's start (IS-GPS-200 30.3.3: the TOW count points ahead)."""
    bits = np.zeros(MSG_BITS, dtype=np.int64)
    bits[:8] = PREAMBLE_BITS
    _put(bits, *_HDR["prn"][:2], prn, 1.0, False)
    _put(bits, *_HDR["msg_type"][:2], msg_type, 1.0, False)
    _put(bits, *_HDR["tow_6s"][:2], (tow_s / 6.0) % (1 << 17), 1.0, False)
    layout = MSG_FIELDS[msg_type]
    for name, (start, n, scale, signed) in layout.items():
        _put(bits, start, n, fields.get(name, 0.0), scale, signed)
    crc = crc24q(bits[:276])
    for i in range(24):
        bits[276 + i] = (crc >> (23 - i)) & 1
    return bits


def unpack_message(bits: np.ndarray):
    """300 bits -> (crc_ok, prn, msg_type, tow_s, fields)."""
    b = np.asarray(bits, dtype=np.int64)
    crc_rx = 0
    for i in range(24):
        crc_rx = (crc_rx << 1) | int(b[276 + i])
    ok = crc24q(b[:276]) == crc_rx
    prn = int(_get(b, *_HDR["prn"]))
    mt = int(_get(b, *_HDR["msg_type"]))
    tow_s = _get(b, *_HDR["tow_6s"]) * 6.0
    fields = {}
    for name, (start, n, scale, signed) in MSG_FIELDS.get(mt, {}).items():
        fields[name] = _get(b, start, n, scale, signed)
    return ok, prn, mt, tow_s, fields


# ---------------------------------------------------------------------------
# ephemeris <-> message fields
# ---------------------------------------------------------------------------

def cnav_ephemeris_to_messages(eph) -> dict[int, dict]:
    """GpsEphemeris -> MT10/11/30 field dicts (CNAV parameterization:
    delta-A around A_ref, delta-Omega-dot around the reference rate)."""
    m10 = dict(wn=eph.week, toe=eph.toe, top=eph.toe,
               delta_a=eph.sqrt_a ** 2 - CNAV_A_REF, a_dot=0.0,
               delta_n0=eph.delta_n_sc, delta_n0_dot=0.0,
               m0=eph.m0_sc, ecc=eph.ecc, omega=eph.omega_sc)
    m11 = dict(toe=eph.toe, omega0=eph.omega0_sc, i0=eph.i0_sc,
               delta_omega_dot=eph.omega_dot_sc - CNAV_OMEGA_DOT_REF_SC,
               i0_dot=eph.idot_sc, cis=eph.cis, cic=eph.cic,
               crs=eph.crs, crc=eph.crc, cus=eph.cus, cuc=eph.cuc)
    m30 = dict(top=eph.toe, toc=eph.toc, af0=eph.af0, af1=eph.af1,
               af2=eph.af2, tgd=eph.tgd)
    return {10: m10, 11: m11, 30: m30}


def messages_to_ephemeris(prn: int, msgs: dict[int, dict]):
    """MT10+11(+30) decoded fields -> GpsEphemeris.  MT10/11 must share
    toe (the reference's CNAV consistency gate,
    gps_cnav_navigation_message.cc have_new_ephemeris)."""
    m10, m11 = msgs[10], msgs[11]
    m30 = msgs.get(30, {})
    a = CNAV_A_REF + m10["delta_a"]
    return GpsEphemeris(
        prn=prn, week=int(m10["wn"]),
        toe=m10["toe"], toc=m30.get("toc", m10["toe"]),
        sqrt_a=float(np.sqrt(a)), ecc=m10["ecc"], m0_sc=m10["m0"],
        delta_n_sc=m10["delta_n0"], omega_sc=m10["omega"],
        omega0_sc=m11["omega0"], i0_sc=m11["i0"],
        omega_dot_sc=CNAV_OMEGA_DOT_REF_SC + m11["delta_omega_dot"],
        idot_sc=m11["i0_dot"],
        cis=m11["cis"], cic=m11["cic"], crs=m11["crs"], crc=m11["crc"],
        cus=m11["cus"], cuc=m11["cuc"],
        af0=m30.get("af0", 0.0), af1=m30.get("af1", 0.0),
        af2=m30.get("af2", 0.0), tgd=m30.get("tgd", 0.0),
        iode=int(m10["toe"] / 300.0) % 256, iodc=int(m10["toe"] / 300) % 256,
    )


# ---------------------------------------------------------------------------
# symbol stream (encode) and streaming decode
# ---------------------------------------------------------------------------

def symbols_for_ephemeris(eph, t0_gps_s: float, n_repeats: int = 3,
                          extra_mt30: dict | None = None,
                          bps: float = 25.0) -> np.ndarray:
    """Continuous CNAV symbol stream {0,1} cycling MT 10,11,30, starting at
    GPS time t0 (must be on the 300/bps-second message grid: 12 s for L2C
    at 25 bps, 6 s for L5 at 50 bps).  Each message's TOW field stamps the
    NEXT message start."""
    msg_s = MSG_BITS / bps
    if t0_gps_s % msg_s:
        raise ValueError(f"t0_gps_s must be a multiple of {msg_s} s")
    msgs = cnav_ephemeris_to_messages(eph)
    if extra_mt30:
        msgs[30].update(extra_mt30)
    bits = []
    t = t0_gps_s
    for _ in range(n_repeats):
        for mt in (10, 11, 30):
            t += msg_s
            bits.append(pack_message(eph.prn, mt, t, msgs[mt]))
    return conv27_encode(np.concatenate(bits))


def l5i_epoch_signs(symbols01: np.ndarray) -> np.ndarray:
    """CNAV symbols {0,1} at 100 sps -> +-1 per 1 ms L5 code epoch: each
    10 ms symbol is spread by the 10-chip Neuman-Hofman code (IS-GPS-705
    3.3.3.1) — the per-epoch modulation the simulator applies."""
    nh = 1 - 2 * np.asarray(constants.GPS_L5I_NH_CODE, np.int64)
    sym = 2 * np.asarray(symbols01, np.int64) - 1
    return (np.repeat(sym, 10) * np.tile(nh, len(sym))).astype(np.int8)


@dataclasses.dataclass
class CnavMessageEvent:
    prn: int
    msg_type: int
    tow_s: float                 # GPS TOW of the NEXT message start
    fields: dict
    start_symbol: int            # stream symbol index of the message start
    crc_ok: bool


class CnavDecoder:
    """Streaming CNAV decoder for one channel: Viterbi over a sliding
    window, preamble + CRC message gate (cnav_msg.c equivalent).

    Feed soft symbols (sign = bit 1 positive); polarity ambiguity is
    resolved by trying both (the conv code is transparent to inversion
    only up to re-encoding, so both hypotheses run through the CRC gate).
    """

    #: Viterbi window, the unreliable un-terminated tail, and the warm-up
    #: prefix kept across consumptions (the encoder state at a window start
    #: mid-stream is unknown, so the first bits of a decode are unreliable)
    WINDOW_BITS = 400   # >= HEAD + MSG + TAIL; smaller = less stream
    #                     lookahead needed before a tail message decodes
    TAIL_BITS = 40
    HEAD_BITS = 12

    def __init__(self):
        self.sym: list[float] = []
        self.base = 0            # stream symbol index of sym[0]
        self._head = 0           # unreliable leading bits of the buffer

    def push_symbols(self, soft) -> list[CnavMessageEvent]:
        self.sym.extend(float(s) for s in soft)
        events = []
        while True:
            base0, len0 = self.base, len(self.sym)
            ev = self._try_decode()
            if ev is not None:
                events.append(ev)
                continue
            # a failed window scan still consumes the scanned region —
            # keep sliding while the buffer holds another window.
            # (Stopping at the first None starved large pushes: a
            # receiver chunk of 10k+ epochs got ONE scan per chunk and
            # never reached the message — fixed r4.)
            if self.base == base0 and len(self.sym) == len0:
                break
        return events

    def _decode_bits(self, arr: np.ndarray) -> np.ndarray:
        return viterbi27_decode(np.asarray(arr, np.float32)).astype(np.int64)

    def _consume_bits(self, n_bits: int) -> None:
        """Drop decoded bits but retain HEAD_BITS of symbol overlap so the
        next window's Viterbi warms up through known symbols."""
        drop = 2 * max(n_bits - self.HEAD_BITS, 0)
        del self.sym[:drop]
        self.base += drop
        self._head = self.HEAD_BITS

    def _try_decode(self):
        win = 2 * self.WINDOW_BITS
        if len(self.sym) < win + 1:
            return None
        # four hypotheses: symbol-pair parity (a half-bit stream slip) x
        # polarity (both conv polynomials have odd weight, so an inverted
        # stream decodes to inverted bits — the preamble gate resolves it)
        for par in (0, 1):
            arr = np.asarray(self.sym[par:par + win], dtype=np.float64)
            for sign in (1.0, -1.0):
                bits = self._decode_bits(sign * arr)
                lim = len(bits) - self.TAIL_BITS - MSG_BITS
                if lim <= self._head:
                    return None
                for off in range(self._head, lim):
                    if not np.array_equal(bits[off:off + 8], PREAMBLE_BITS):
                        continue
                    ok, prn, mt, tow_s, fields = unpack_message(
                        bits[off:off + MSG_BITS])
                    if not ok:
                        continue
                    start = self.base + par + 2 * off
                    if par:   # re-align the buffer to the found parity
                        del self.sym[:1]
                        self.base += 1
                    self._consume_bits(off + MSG_BITS)
                    return CnavMessageEvent(prn, mt, tow_s, fields, start,
                                            True)
        # no message: drop only the region actually scanned so an unscanned
        # message start is never skipped
        self._consume_bits(lim)
        return None
