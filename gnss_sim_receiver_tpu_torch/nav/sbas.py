"""SBAS L1 message layer: encode (simulator) and streaming decode.

Mirrors the reference's sbas_l1_telemetry_decoder_gs
(src/algorithms/telemetry_decoder/gnuradio_blocks/
sbas_l1_telemetry_decoder_gs.cc): 250-bit messages at 250 bps, rate-1/2
K=7 (171,133 octal) convolutional coding to 500 sps symbols (each symbol
spans two 1 ms code epochs), three cycling 8-bit distributed preambles
0x53/0x9A/0xC6, CRC-24Q over the leading 226 bits (DO-229).  The decoder
follows the reference's hypothesis structure — two symbol-pair alignments
x two polarities, preamble + CRC gated (Sample_Aligner /
Symbol_Aligner_And_Decoder / Frame_Detector / Crc_Verifier roles) — on the
framework's shared windowed-Viterbi pattern (nav.cnav.CnavDecoder).

MT9 (GEO navigation, sbas_ephemeris.cc role) and MT12 (time) payloads get
typed parsers; all other message types surface as raw payload bits.

Copy of ``gnss_sim_receiver_tpu.nav.sbas`` for the PyTorch port, with the
NumPy encoder and Viterbi decoder of nav.fec in place of the JAX package's
native helper library (the same bits: the plain G1/G2 code, no G2
inversion).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch.nav.fec import (conv27_encode, crc24q,
                                                 viterbi27_decode)

MSG_BITS = 250
DATA_BITS = 226                  # preamble(8) + MT(6) + payload(212)
SYMBOLS_PER_BIT = 2
EPOCHS_PER_SYMBOL = 2            # 500 sps symbols over 1 ms code epochs
MSG_SECONDS = 1.0

# distributed preamble: 0x53, 0x9A, 0xC6 cycling across consecutive
# messages (sbas_l1_telemetry_decoder_gs.cc:240-243)
PREAMBLES = np.array([
    [0, 1, 0, 1, 0, 0, 1, 1],
    [1, 0, 0, 1, 1, 0, 1, 0],
    [1, 1, 0, 0, 0, 1, 1, 0],
], dtype=np.int64)


def pack_message(msg_type: int, payload212: np.ndarray,
                 preamble_idx: int = 0) -> np.ndarray:
    """-> 250 bits {0,1}: preamble + MT + payload + CRC-24Q."""
    payload212 = np.asarray(payload212, np.int64)
    if payload212.shape != (212,):
        raise ValueError("payload must be 212 bits")
    mt = np.array([(int(msg_type) >> (5 - i)) & 1 for i in range(6)],
                  np.int64)
    head = np.concatenate([PREAMBLES[preamble_idx % 3], mt, payload212])
    crc = crc24q(head)
    crc_bits = np.array([(crc >> (23 - i)) & 1 for i in range(24)],
                        np.int64)
    return np.concatenate([head, crc_bits])


def unpack_message(bits250: np.ndarray):
    """-> (crc_ok, msg_type, payload212)."""
    b = np.asarray(bits250, np.int64)
    crc_rx = 0
    for i in range(24):
        crc_rx = (crc_rx << 1) | int(b[DATA_BITS + i])
    ok = crc24q(b[:DATA_BITS]) == crc_rx
    mt = 0
    for i in range(6):
        mt = (mt << 1) | int(b[8 + i])
    return ok, mt, b[14:DATA_BITS]


# ---------------------------------------------------------------------------
# typed payloads
# ---------------------------------------------------------------------------

def _get(bits, start, n, scale=1.0, signed=False):
    raw = 0
    for i in range(n):
        raw = (raw << 1) | int(bits[start + i])
    if signed and raw >> (n - 1):
        raw -= 1 << n
    return raw * scale


def _put(bits, start, n, value, scale=1.0, signed=False):
    raw = int(round(value / scale))
    if signed:
        raw &= (1 << n) - 1
    for i in range(n):
        bits[start + i] = (raw >> (n - 1 - i)) & 1


@dataclasses.dataclass
class SbasGeoNav:
    """MT9 GEO navigation message (DO-229 A.4.4.11; the reference's
    Sbas_Ephemeris, sbas_ephemeris.h): ECEF position/velocity/acceleration
    + clock at t0."""
    iodn: int = 0
    t0_s: float = 0.0            # x16 s
    ura: int = 0
    pos_m: tuple = (0.0, 0.0, 0.0)      # x0.08 m (x,y), x0.4 m (z)
    vel_ms: tuple = (0.0, 0.0, 0.0)     # x0.000625 / x0.004 m/s
    acc_ms2: tuple = (0.0, 0.0, 0.0)    # x0.0000125 / x0.0000625 m/s^2
    agf0_s: float = 0.0          # x2^-31 s
    agf1_ss: float = 0.0         # x2^-40 s/s


_MT9 = [  # (start, n, scale, signed) per field, DO-229 layout
    ("iodn", 0, 8, 1.0, False),
    ("t0", 8, 13, 16.0, False),
    ("ura", 21, 4, 1.0, False),
    ("x", 25, 30, 0.08, True),
    ("y", 55, 30, 0.08, True),
    ("z", 85, 25, 0.4, True),
    ("vx", 110, 17, 0.000625, True),
    ("vy", 127, 17, 0.000625, True),
    ("vz", 144, 18, 0.004, True),
    ("ax", 162, 10, 0.0000125, True),
    ("ay", 172, 10, 0.0000125, True),
    ("az", 182, 10, 0.0000625, True),
    ("agf0", 192, 12, 2.0 ** -31, True),
    ("agf1", 204, 8, 2.0 ** -40, True),
]


def pack_mt9(nav: SbasGeoNav) -> np.ndarray:
    bits = np.zeros(212, np.int64)
    vals = dict(iodn=nav.iodn, t0=nav.t0_s, ura=nav.ura,
                x=nav.pos_m[0], y=nav.pos_m[1], z=nav.pos_m[2],
                vx=nav.vel_ms[0], vy=nav.vel_ms[1], vz=nav.vel_ms[2],
                ax=nav.acc_ms2[0], ay=nav.acc_ms2[1], az=nav.acc_ms2[2],
                agf0=nav.agf0_s, agf1=nav.agf1_ss)
    for name, start, n, scale, signed in _MT9:
        _put(bits, start, n, vals[name], scale, signed)
    return bits


def parse_mt9(payload212: np.ndarray) -> SbasGeoNav:
    b = np.asarray(payload212, np.int64)
    v = {name: _get(b, start, n, scale, signed)
         for name, start, n, scale, signed in _MT9}
    return SbasGeoNav(
        iodn=int(v["iodn"]), t0_s=v["t0"], ura=int(v["ura"]),
        pos_m=(v["x"], v["y"], v["z"]),
        vel_ms=(v["vx"], v["vy"], v["vz"]),
        acc_ms2=(v["ax"], v["ay"], v["az"]),
        agf0_s=v["agf0"], agf1_ss=v["agf1"])


def geo_nav_pos(nav: SbasGeoNav, t_s: float) -> np.ndarray:
    """Quadratic GEO position propagation (sbas_ephemeris.cc sat_pos)."""
    dt = t_s - nav.t0_s
    p = np.asarray(nav.pos_m, np.float64)
    v = np.asarray(nav.vel_ms, np.float64)
    a = np.asarray(nav.acc_ms2, np.float64)
    return p + v * dt + 0.5 * a * dt * dt


# ---------------------------------------------------------------------------
# Correction messages: MT1 PRN mask, MT2-5 fast, MT25 long-term,
# MT18 IGP mask + MT26 iono delays (DO-229 A.4.4; the decode/apply roles
# of the reference's rtklib_sbas.cc sbsdecodemsg + sbsioncorr/sbssatcorr)
# ---------------------------------------------------------------------------

def pack_mt1(prns: list[int], iodp: int = 0) -> np.ndarray:
    """PRN mask: slot i (1-based) = i-th set bit among the 210 mask
    positions (position p = PRN p for GPS 1-37)."""
    bits = np.zeros(212, np.int64)
    for p in prns:
        bits[p - 1] = 1
    _put(bits, 210, 2, iodp)
    return bits


def parse_mt1(payload212: np.ndarray) -> tuple[list[int], int]:
    b = np.asarray(payload212, np.int64)
    prns = [int(i) + 1 for i in np.flatnonzero(b[:210])]
    return prns, int(_get(b, 210, 2))


def pack_mt2(slot_prc_m: list[float], mt: int = 2, iodf: int = 0,
             iodp: int = 0) -> np.ndarray:
    """Fast corrections for 13 mask slots (MT2: slots 1-13, MT3: 14-26,
    MT4: 27-39, MT5: 40-51): 12-bit PRC x 0.125 m."""
    bits = np.zeros(212, np.int64)
    _put(bits, 0, 2, iodf)
    _put(bits, 2, 2, iodp)
    for i, prc in enumerate(slot_prc_m[:13]):
        _put(bits, 4 + 12 * i, 12, prc, 0.125, True)
    # 13 x 4-bit UDREI follow; left at 0 (best accuracy)
    return bits


def parse_mt2(payload212: np.ndarray):
    b = np.asarray(payload212, np.int64)
    iodf = int(_get(b, 0, 2))
    iodp = int(_get(b, 2, 2))
    prc = [float(_get(b, 4 + 12 * i, 12, 0.125, True)) for i in range(13)]
    return prc, iodf, iodp


@dataclasses.dataclass
class SbasLongTerm:
    """MT25 half-message, velocity code 0: position + clock offsets for
    one satellite (DO-229 A.4.4.7)."""
    slot: int = 0                # PRN mask slot (1-based)
    iode: int = 0
    dpos_m: tuple = (0.0, 0.0, 0.0)    # x0.125 m
    daf0_s: float = 0.0                # x2^-31 s


def pack_mt25(halves: list[SbasLongTerm], iodp: int = 0) -> np.ndarray:
    """Two velocity-code-0 half messages (each half then carries TWO
    satellites; we fill the first satellite of each half and zero the
    second)."""
    bits = np.zeros(212, np.int64)
    for h, lt in enumerate(halves[:2]):
        off = 106 * h
        _put(bits, off, 1, 0)             # velocity code 0
        _put(bits, off + 1, 6, lt.slot)
        _put(bits, off + 7, 8, lt.iode)
        _put(bits, off + 15, 9, lt.dpos_m[0], 0.125, True)
        _put(bits, off + 24, 9, lt.dpos_m[1], 0.125, True)
        _put(bits, off + 33, 9, lt.dpos_m[2], 0.125, True)
        _put(bits, off + 42, 10, lt.daf0_s, 2.0 ** -31, True)
        # second satellite of the half left zero (slot 0 = unused)
        _put(bits, off + 104, 2, iodp)
    return bits


def parse_mt25(payload212: np.ndarray) -> list[SbasLongTerm]:
    b = np.asarray(payload212, np.int64)
    out = []
    for h in range(2):
        off = 106 * h
        if int(_get(b, off, 1)):
            continue    # velocity code 1 (pos+vel) not modeled
        for s in range(2):
            so = off + 1 + 51 * s
            slot = int(_get(b, so, 6))
            if slot == 0:
                continue
            out.append(SbasLongTerm(
                slot=slot, iode=int(_get(b, so + 6, 8)),
                dpos_m=(_get(b, so + 14, 9, 0.125, True),
                        _get(b, so + 23, 9, 0.125, True),
                        _get(b, so + 32, 9, 0.125, True)),
                daf0_s=_get(b, so + 41, 10, 2.0 ** -31, True)))
    return out


def pack_mt12(tow_s: float, week: int = 0) -> np.ndarray:
    """MT12 SBAS network time / UTC: the GPS-time fields only (GPS TOW x
    1 s at bit 107, GPS week at 127 — DO-229 A.4.4.15 layout; the UTC
    polynomial fields are left zero)."""
    bits = np.zeros(212, np.int64)
    _put(bits, 107, 20, tow_s)
    _put(bits, 127, 10, week)
    return bits


def parse_mt12(payload212: np.ndarray) -> tuple[float, int]:
    b = np.asarray(payload212, np.int64)
    return float(_get(b, 107, 20)), int(_get(b, 127, 10))


# IGP grid model: regular 5 x 5 deg within +-55 deg latitude, bands of 40
# deg longitude (9 bands x 8 meridians x 23 latitudes = 184 IGPs/band).
# This covers the dense part of the DO-229 band tables; the sparse polar
# rows (|lat| > 55) are not modeled, so a real broadcast using them would
# need the full band tables (rtklib_sbas.cc sbsigpband).
IGP_LATS = np.arange(-55, 60, 5)          # 23
IGP_LONS_PER_BAND = 8


def igp_latlon(band: int, idx: int) -> tuple[float, float]:
    """IGP (lat, lon) for mask index idx (0-based) in band (0-8)."""
    mer = idx // len(IGP_LATS)
    lat = IGP_LATS[idx % len(IGP_LATS)]
    lon = -180.0 + 40.0 * band + 5.0 * mer
    return float(lat), float(lon)


def pack_mt18(band: int, igp_indices: list[int], n_bands: int = 1,
              iodi: int = 0) -> np.ndarray:
    """IGP mask for one band: bit i set = IGP i of the band is monitored."""
    bits = np.zeros(212, np.int64)
    _put(bits, 0, 4, n_bands)
    _put(bits, 4, 4, band)
    _put(bits, 8, 2, iodi)
    for i in igp_indices:
        bits[10 + i] = 1
    return bits


def parse_mt18(payload212: np.ndarray):
    b = np.asarray(payload212, np.int64)
    return (int(_get(b, 4, 4)), [int(i) for i in np.flatnonzero(b[10:211])],
            int(_get(b, 8, 2)))


def pack_mt26(band: int, block: int, delays_m: list[float],
              iodi: int = 0) -> np.ndarray:
    """Iono delays for 15 masked IGPs starting at block*15 (9-bit x
    0.125 m vertical delay; GIVEI left 0)."""
    bits = np.zeros(212, np.int64)
    _put(bits, 0, 4, band)
    _put(bits, 4, 4, block)
    for i, d in enumerate(delays_m[:15]):
        _put(bits, 8 + 13 * i, 9, d, 0.125)
    _put(bits, 203, 2, iodi)
    return bits


def parse_mt26(payload212: np.ndarray):
    b = np.asarray(payload212, np.int64)
    band = int(_get(b, 0, 4))
    block = int(_get(b, 4, 4))
    delays = [float(_get(b, 8 + 13 * i, 9, 0.125)) for i in range(15)]
    return band, block, delays


class SbasCorrections:
    """Aggregated SBAS correction state (the rtklib sbssat_t/sbsion_t
    role): feed decoded message events, then query per-satellite code
    corrections and iono delays for PVT (rtklib_sbas.cc sbssatcorr /
    sbsioncorr)."""

    def __init__(self):
        self.prn_mask: list[int] = []
        self.fast_prc: dict[int, float] = {}       # prn -> meters
        self.long_term: dict[int, SbasLongTerm] = {}
        self.igp_mask: dict[int, list[int]] = {}   # band -> igp indices
        self.iono: dict[tuple[float, float], float] = {}  # (lat,lon)->m

    def push(self, ev) -> None:
        mt, payload = ev.msg_type, ev.payload
        if mt == 1:
            self.prn_mask, _ = parse_mt1(payload)
        elif mt in (2, 3, 4, 5):
            prc, _, _ = parse_mt2(payload)
            base = {2: 0, 3: 13, 4: 26, 5: 39}[mt]
            for i, v in enumerate(prc):
                slot = base + i
                if slot < len(self.prn_mask):
                    self.fast_prc[self.prn_mask[slot]] = v
        elif mt == 25:
            for lt in parse_mt25(payload):
                if lt.slot - 1 < len(self.prn_mask):
                    self.long_term[self.prn_mask[lt.slot - 1]] = lt
        elif mt == 18:
            band, idx, _ = parse_mt18(payload)
            self.igp_mask[band] = idx
        elif mt == 26:
            band, block, delays = parse_mt26(payload)
            mask = self.igp_mask.get(band)
            if mask is None:
                return
            for i, d in enumerate(delays):
                j = block * 15 + i
                if j < len(mask):
                    self.iono[igp_latlon(band, mask[j])] = d

    # -- application --------------------------------------------------------

    def code_correction_m(self, prn: int) -> float:
        """Fast correction: ADD to the pseudorange (DO-229 PR_corrected =
        PR + PRC)."""
        return self.fast_prc.get(prn, 0.0)

    def sat_correction(self, prn: int):
        """(dpos_ecef [3], dclk_s) long-term correction: ADD dpos to the
        broadcast satellite position, ADD dclk to the SV clock."""
        lt = self.long_term.get(prn)
        if lt is None:
            return None
        return np.asarray(lt.dpos_m, np.float64), lt.daf0_s

    def iono_delay_m(self, lat_ipp_deg: float, lon_ipp_deg: float,
                     elevation_rad: float) -> float | None:
        """Slant iono delay at the pierce point: bilinear interpolation of
        the 4 surrounding monitored IGPs x the DO-229 obliquity factor;
        None when the cell is not fully monitored (caller falls back to
        its broadcast model)."""
        la0 = np.floor(lat_ipp_deg / 5.0) * 5.0
        lo0 = np.floor(lon_ipp_deg / 5.0) * 5.0
        corners = [(la0, lo0), (la0 + 5, lo0), (la0, lo0 + 5),
                   (la0 + 5, lo0 + 5)]
        vals = []
        for la, lo in corners:
            v = self.iono.get((float(la), float(lo)))
            if v is None:
                return None
            vals.append(v)
        fx = (lat_ipp_deg - la0) / 5.0
        fy = (lon_ipp_deg - lo0) / 5.0
        vert = (vals[0] * (1 - fx) * (1 - fy) + vals[1] * fx * (1 - fy)
                + vals[2] * (1 - fx) * fy + vals[3] * fx * fy)
        re, hi = 6378136.3, 350e3
        f = 1.0 / np.sqrt(1.0 - (re * np.cos(elevation_rad)
                                 / (re + hi)) ** 2)
        return float(vert * f)


class SbasGeoEphemeris:
    """Adapter exposing MT9 GEO navigation through the Kepler-ephemeris
    interface PVT consumes (sat_pos_clock / sat_vel / tgd), so the GEO
    itself can be ranged on (sbas_ephemeris.cc sat_pos role)."""

    system = "SBAS"

    def __init__(self, prn: int, nav: SbasGeoNav, week: int = 0):
        self.prn = int(prn)
        self.nav = nav
        self.week = week
        self.tgd = 0.0
        self.toe = nav.t0_s

    def sat_pos_clock(self, t_s):
        dt = float(t_s) - self.nav.t0_s
        clk = self.nav.agf0_s + self.nav.agf1_ss * dt
        return geo_nav_pos(self.nav, float(t_s)), clk

    def sat_vel(self, t_s, dt: float = 1e-3):
        p1 = geo_nav_pos(self.nav, float(t_s) - dt)
        p2 = geo_nav_pos(self.nav, float(t_s) + dt)
        return (p2 - p1) / (2.0 * dt)


# ---------------------------------------------------------------------------
# symbol stream (encode)
# ---------------------------------------------------------------------------

def symbols_for_messages(msgs: list[tuple[int, np.ndarray]],
                         first_preamble_idx: int = 0) -> np.ndarray:
    """[(msg_type, payload212)] -> continuous 500 sps symbol stream {0,1}
    (one convolutional encoder across the whole stream, preambles
    cycling)."""
    bits = np.concatenate([
        pack_message(mt, pl, first_preamble_idx + k)
        for k, (mt, pl) in enumerate(msgs)])
    return conv27_encode(bits)


def sbas_epoch_signs(symbols01: np.ndarray) -> np.ndarray:
    """Symbols {0,1} at 500 sps -> +-1 per 1 ms code epoch (2 epochs per
    symbol, no secondary code)."""
    s = 2 * np.asarray(symbols01, np.int64) - 1
    return np.repeat(s, EPOCHS_PER_SYMBOL).astype(np.int8)


# ---------------------------------------------------------------------------
# streaming decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SbasMessageEvent:
    msg_type: int
    payload: np.ndarray          # 212 bits
    start_symbol: int            # stream symbol index of the message start
    preamble_idx: int
    crc_ok: bool


class SbasMessageDecoder:
    """Streaming SBAS decoder for one channel: feed soft 500 sps symbols
    (sign > 0 = symbol 1); two symbol-pair alignments x two polarities run
    through the windowed Viterbi and the preamble/CRC gate — the role of
    the reference's Sample_Aligner + Symbol_Aligner_And_Decoder +
    Frame_Detector + Crc_Verifier chain."""

    WINDOW_BITS = 420
    TAIL_BITS = 40
    # generous Viterbi warm-up overlap: a message starting right at the
    # scan edge must sit past several constraint lengths of converged
    # trellis (5*K bits), or its leading bits decode wrong and the CRC
    # rejects a clean message
    HEAD_BITS = 40

    def __init__(self):
        self.sym: list[float] = []
        self.base = 0
        self._head = 0
        self.geo_nav: SbasGeoNav | None = None

    def push_symbols(self, soft) -> list[SbasMessageEvent]:
        self.sym.extend(float(s) for s in soft)
        events = []
        while True:
            base0, len0 = self.base, len(self.sym)
            ev = self._try_decode()
            if ev is None:
                # a failed window scan still consumes the scanned region;
                # keep sliding while the buffer holds another window
                # (stopping at the first None starved large pushes — the
                # CnavDecoder r4 fix applies here identically)
                if self.base == base0 and len(self.sym) == len0:
                    break
                continue
            if ev.msg_type == 9:
                self.geo_nav = parse_mt9(ev.payload)
            events.append(ev)
        return events

    def _consume_bits(self, n_bits: int) -> None:
        drop = 2 * max(n_bits - self.HEAD_BITS, 0)
        del self.sym[:drop]
        self.base += drop
        self._head = self.HEAD_BITS

    def _try_decode(self):
        win = 2 * self.WINDOW_BITS
        if len(self.sym) < win + 1:
            return None
        for par in (0, 1):
            arr = np.asarray(self.sym[par:par + win], dtype=np.float64)
            for sign in (1.0, -1.0):
                bits = viterbi27_decode(
                    np.asarray(sign * arr, np.float32)).astype(np.int64)
                lim = len(bits) - self.TAIL_BITS - MSG_BITS
                if lim <= self._head:
                    return None
                for off in range(self._head, lim):
                    pre = bits[off:off + 8]
                    hits = np.flatnonzero((PREAMBLES == pre).all(axis=1))
                    if hits.size == 0:
                        continue
                    ok, mt, payload = unpack_message(
                        bits[off:off + MSG_BITS])
                    if not ok:
                        continue
                    start = self.base + par + 2 * off
                    if par:
                        del self.sym[:1]
                        self.base += 1
                    self._consume_bits(off + MSG_BITS)
                    return SbasMessageEvent(mt, payload, start,
                                            int(hits[0]), True)
        self._consume_bits(lim)
        return None
