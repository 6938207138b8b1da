"""RTCM 3.x messages: framing, CRC-24Q, MSM observables, ephemerides.

Role parity with the reference's `src/algorithms/PVT/libs/rtcm.cc`
(6,670 LoC: message encode/decode, transport framing, CRC24) and
`rtcm_printer.cc` (TCP server) — redesigned as a compact table-driven
codec:

- transport frame: 0xD3 | 6 reserved bits | 10-bit length | payload |
  CRC-24Q over header+payload (RTCM 10403.3 section 4);
- ephemerides: 1019 (GPS LNAV), 1045 (Galileo F/NAV), 1042 (BeiDou D1)
  <-> nav.ephemeris.GpsEphemeris, field tables in wire order;
- station coordinates: 1005 (stationary antenna reference point ECEF);
- observables: MSM4 and MSM7 for GPS (1074/1077), Galileo (1094/1097),
  BeiDou (1124/1127) <-> models.observables.ObservationEpoch vectors;
- `RtcmBaseEncoder` turns a base receiver's observation stream +
  ephemerides into a frame stream (stateful: picks the phase-range
  integer offset once per lock so PhaseRange stays near Pseudorange as
  real receivers do, preserving DD ambiguity constancy);
- `RtcmBaseDecoder` reassembles frames into `rtk.BaseObservations` so
  the RTK engine can ride a real base-station link instead of a RINEX
  file; `serve_frames`/`read_frames` provide the TCP transport
  (rtcm_printer.cc server role).

Conventions (documented where RTCM leaves receiver latitude):
- phase-range-rate is encoded as -doppler_hz * lambda (range-rate m/s,
  positive = receding), decoded back symmetrically;
- BeiDou epoch time is encoded directly from the receiver timescale
  (the simulator runs GGTO/BGTO = 0).

Copy of ``gnss_sim_receiver_tpu.models.rtcm`` for the PyTorch port: host
float64 NumPy, no kernel.
"""

from __future__ import annotations

import dataclasses
import socket
import threading

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris

C = constants.SPEED_OF_LIGHT_M_S
_WEEK_MS = 604800000

# ---------------------------------------------------------------------------
# CRC-24Q (poly 0x1864CFB, init 0) — rtcm.cc / rtklib crc24q
_CRC24_POLY = 0x1864CFB
_CRC24_TAB = []


def _crc24_table():
    global _CRC24_TAB
    if _CRC24_TAB:
        return _CRC24_TAB
    tab = []
    for i in range(256):
        crc = i << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
        tab.append(crc & 0xFFFFFF)
    _CRC24_TAB = tab
    return tab


def crc24q(data: bytes) -> int:
    tab = _crc24_table()
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFF) ^ tab[(crc >> 16) ^ b]
    return crc


# ---------------------------------------------------------------------------
# bit cursor helpers


class BitWriter:
    def __init__(self):
        self._bits = []

    def u(self, value: int, nbits: int):
        v = int(value)
        if v < 0 or v >= (1 << nbits):
            raise ValueError(f"u{nbits} out of range: {value}")
        self._bits.extend((v >> (nbits - 1 - i)) & 1 for i in range(nbits))
        return self

    def s(self, value: int, nbits: int):
        v = int(value)
        lo, hi = -(1 << (nbits - 1)), (1 << (nbits - 1)) - 1
        if not lo <= v <= hi:
            raise ValueError(f"s{nbits} out of range: {value}")
        return self.u(v & ((1 << nbits) - 1), nbits)

    @property
    def nbits(self):
        return len(self._bits)

    def tobytes(self) -> bytes:
        bits = self._bits + [0] * ((-len(self._bits)) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            byte = 0
            for b in bits[i:i + 8]:
                byte = (byte << 1) | b
            out.append(byte)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, nbits: int) -> int:
        v = self.u(nbits)
        if v & (1 << (nbits - 1)):
            v -= 1 << nbits
        return v


# ---------------------------------------------------------------------------
# transport framing


def frame(payload: bytes) -> bytes:
    """0xD3 + 10-bit length + payload + CRC24Q."""
    if len(payload) > 1023:
        raise ValueError("payload > 1023 bytes")
    head = bytes([0xD3, (len(payload) >> 8) & 0x03, len(payload) & 0xFF])
    crc = crc24q(head + payload)
    return head + payload + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF,
                                   crc & 0xFF])


def iter_frames(stream: bytes):
    """Yield CRC-valid payloads from a byte stream, resyncing on 0xD3
    (transport robustness of rtklib input_rtcm3)."""
    i = 0
    n = len(stream)
    while i + 6 <= n:
        if stream[i] != 0xD3:
            i += 1
            continue
        length = ((stream[i + 1] & 0x03) << 8) | stream[i + 2]
        end = i + 3 + length + 3
        if end > n:
            # could be a spurious 0xD3 inside garbage claiming a huge
            # length — keep scanning rather than dropping the tail
            i += 1
            continue
        blk = stream[i:i + 3 + length]
        crc = ((stream[end - 3] << 16) | (stream[end - 2] << 8)
               | stream[end - 1])
        if crc24q(blk) == crc:
            yield stream[i + 3:i + 3 + length]
            i = end
        else:
            i += 1


def message_number(payload: bytes) -> int:
    return (payload[0] << 4) | (payload[1] >> 4)


# ---------------------------------------------------------------------------
# ephemeris messages — field tables in wire order.
# Each row: (attr, nbits, scale, signed) with attr a GpsEphemeris field,
# or ("=k", nbits, None, None) for a constant field we do not model.
_P2 = lambda e: 2.0 ** e

_EPH_1019 = [
    ("prn", 6, 1, False), ("week", 10, 1, False), ("=0", 4, None, None),
    ("=0", 2, None, None), ("idot_sc", 14, _P2(-43), True),
    ("iode", 8, 1, False), ("toc", 16, 16.0, False),
    ("af2", 8, _P2(-55), True), ("af1", 16, _P2(-43), True),
    ("af0", 22, _P2(-31), True), ("iodc", 10, 1, False),
    ("crs", 16, _P2(-5), True), ("delta_n_sc", 16, _P2(-43), True),
    ("m0_sc", 32, _P2(-31), True), ("cuc", 16, _P2(-29), True),
    ("ecc", 32, _P2(-33), False), ("cus", 16, _P2(-29), True),
    ("sqrt_a", 32, _P2(-19), False), ("toe", 16, 16.0, False),
    ("cic", 16, _P2(-29), True), ("omega0_sc", 32, _P2(-31), True),
    ("cis", 16, _P2(-29), True), ("i0_sc", 32, _P2(-31), True),
    ("crc", 16, _P2(-5), True), ("omega_sc", 32, _P2(-31), True),
    ("omega_dot_sc", 24, _P2(-43), True), ("tgd", 8, _P2(-31), True),
    ("=0", 6, None, None), ("=0", 1, None, None), ("=0", 1, None, None),
]

_EPH_1045 = [
    ("prn", 6, 1, False), ("week", 12, 1, False),
    ("iod_nav", 10, 1, False), ("=107", 8, None, None),   # SISA index
    ("idot_sc", 14, _P2(-43), True), ("toc", 14, 60.0, False),
    ("af2", 6, _P2(-59), True), ("af1", 21, _P2(-46), True),
    ("af0", 31, _P2(-34), True), ("crs", 16, _P2(-5), True),
    ("delta_n_sc", 16, _P2(-43), True), ("m0_sc", 32, _P2(-31), True),
    ("cuc", 16, _P2(-29), True), ("ecc", 32, _P2(-33), False),
    ("cus", 16, _P2(-29), True), ("sqrt_a", 32, _P2(-19), False),
    ("toe", 14, 60.0, False), ("cic", 16, _P2(-29), True),
    ("omega0_sc", 32, _P2(-31), True), ("cis", 16, _P2(-29), True),
    ("i0_sc", 32, _P2(-31), True), ("crc", 16, _P2(-5), True),
    ("omega_sc", 32, _P2(-31), True), ("omega_dot_sc", 24, _P2(-43), True),
    ("bgd_e1e5a", 10, _P2(-32), True), ("=0", 2, None, None),
    ("=0", 1, None, None), ("=0", 7, None, None),
]

_EPH_1042 = [
    ("prn", 6, 1, False), ("week", 13, 1, False), ("=0", 4, None, None),
    ("idot_sc", 14, _P2(-43), True), ("iode", 5, 1, False),
    ("toc", 17, 8.0, False), ("af2", 11, _P2(-66), True),
    ("af1", 22, _P2(-50), True), ("af0", 24, _P2(-33), True),
    ("iodc", 5, 1, False), ("crs", 18, _P2(-6), True),
    ("delta_n_sc", 16, _P2(-43), True), ("m0_sc", 32, _P2(-31), True),
    ("cuc", 18, _P2(-31), True), ("ecc", 32, _P2(-33), False),
    ("cus", 18, _P2(-31), True), ("sqrt_a", 32, _P2(-19), False),
    ("toe", 17, 8.0, False), ("cic", 18, _P2(-31), True),
    ("omega0_sc", 32, _P2(-31), True), ("cis", 18, _P2(-31), True),
    ("i0_sc", 32, _P2(-31), True), ("crc", 18, _P2(-6), True),
    ("omega_sc", 32, _P2(-31), True), ("omega_dot_sc", 24, _P2(-43), True),
    ("tgd", 10, 1e-10, True), ("=0", 10, None, None), ("=0", 1, None, None),
]

_EPH_MSGS = {1019: (_EPH_1019, "GPS"), 1045: (_EPH_1045, "Galileo"),
             1042: (_EPH_1042, "BeiDou")}
_EPH_MSG_FOR_SYSTEM = {"GPS": 1019, "Galileo": 1045, "BeiDou": 1042}

# IODC/IODE field truncation per message (1042 has only 5 bits)
_EPH_SYSTEM_FIELD_MASK = {1042: {"iode": 0x1F, "iodc": 0x1F}}


def encode_ephemeris(eph: GpsEphemeris) -> bytes:
    """GpsEphemeris -> RTCM payload (1019/1045/1042 by eph.system)."""
    msg = _EPH_MSG_FOR_SYSTEM[eph.system]
    table, _ = _EPH_MSGS[msg]
    mask = _EPH_SYSTEM_FIELD_MASK.get(msg, {})
    w = BitWriter()
    w.u(msg, 12)
    for attr, nbits, scale, signed in table:
        if attr.startswith("="):
            w.u(int(attr[1:]), nbits)
            continue
        v = getattr(eph, attr)
        q = int(round(float(v) / scale))
        if attr in mask:
            q &= mask[attr]
        if attr == "week" and msg == 1019:
            q %= 1024          # DF076 is the LNAV mod-1024 week
        if signed:
            w.s(q, nbits)
        else:
            w.u(q, nbits)
    return w.tobytes()


def decode_ephemeris(payload: bytes) -> GpsEphemeris:
    r = BitReader(payload)
    msg = r.u(12)
    table, system = _EPH_MSGS[msg]
    eph = GpsEphemeris(system=system)
    for attr, nbits, scale, signed in table:
        if attr.startswith("="):
            r.u(nbits)
            continue
        q = r.s(nbits) if signed else r.u(nbits)
        v = q * scale
        if attr == "week" and msg == 1019:
            # resolve the mod-1024 LNAV week into the current GPS era
            # (week 2048-3071, i.e. 2019-2038) — same convention as the
            # repo's LNAV decoder
            v = int(v) + 2048
        if attr in ("prn", "week", "iode", "iodc", "iod_nav"):
            setattr(eph, attr, int(v))
        else:
            setattr(eph, attr, float(v))
    return eph


# ---------------------------------------------------------------------------
# 1005: stationary reference-station ARP (base position for RTK)


def encode_station(ecef_m, station_id: int = 0) -> bytes:
    x, y, z = [int(round(float(v) / 1e-4)) for v in ecef_m]
    w = BitWriter()
    w.u(1005, 12).u(station_id, 12).u(0, 6).u(1, 1).u(1, 1).u(1, 1).u(0, 1)
    w.s(x, 38).u(0, 1).u(0, 1).s(y, 38).u(0, 2).s(z, 38)
    return w.tobytes()


def decode_station(payload: bytes):
    r = BitReader(payload)
    assert r.u(12) == 1005
    station_id = r.u(12)
    r.u(6 + 1 + 1 + 1 + 1)
    x = r.s(38)
    r.u(1 + 1)
    y = r.s(38)
    r.u(2)
    z = r.s(38)
    return np.array([x, y, z], np.float64) * 1e-4, station_id


# ---------------------------------------------------------------------------
# MSM observables

# (msm4, msm7) message numbers per system
_MSM_BASE = {"GPS": 1070, "GLONASS": 1080, "Galileo": 1090, "SBAS": 1100,
             "QZSS": 1110, "BeiDou": 1120}
_MSM_SYSTEM = {v + k: (s, k) for s, v in _MSM_BASE.items() for k in (4, 7)}

# repo signal name -> MSM signal id (RTCM 10403.3 tables 3.5-91/96/103)
_SIG_ID = {
    ("GPS", "1C"): 2, ("GPS", "2S"): 15, ("GPS", "L5"): 22,
    ("Galileo", "1B"): 4, ("Galileo", "5X"): 22, ("Galileo", "7X"): 14,
    ("Galileo", "E6"): 10,
    ("BeiDou", "B1"): 2, ("BeiDou", "B3"): 8,
    ("GLONASS", "1G"): 2, ("GLONASS", "2G"): 8,   # L1/L2 C/A (3.5-96)
    ("SBAS", "S1"): 2,                            # L1 C/A (3.5-102)
}
_SIG_NAME = {(s, i): n for (s, n), i in _SIG_ID.items()}

# carrier frequency per (system, signal) for phase <-> meters
_SIG_FREQ = {
    ("GPS", "1C"): constants.GPS_L1_FREQ_HZ,
    ("GPS", "2S"): 1227.60e6, ("GPS", "L5"): 1176.45e6,
    ("Galileo", "1B"): constants.GPS_L1_FREQ_HZ,
    ("Galileo", "5X"): 1176.45e6, ("Galileo", "7X"): 1207.14e6,
    ("Galileo", "E6"): 1278.75e6,
    ("BeiDou", "B1"): 1561.098e6, ("BeiDou", "B3"): 1268.52e6,
    ("SBAS", "S1"): constants.GPS_L1_FREQ_HZ,
}

# GLONASS FDMA (slot k in -7..+6): carrier = base + k * spacing; the MSM
# extended-satellite-info field carries k+7 (RTCM 10403.3 table 3.5-77)
_GLO_FDMA = {"1G": (1602.0e6, 562.5e3), "2G": (1246.0e6, 437.5e3)}


def _sig_lambda(system: str, signal: str, freq_slot: int = 0) -> float:
    if system == "GLONASS":
        base, step = _GLO_FDMA[signal]
        return C / (base + freq_slot * step)
    return C / _SIG_FREQ[(system, signal)]


@dataclasses.dataclass
class MsmObservation:
    """One satellite-signal observable decoded from / encoded to MSM."""
    prn: int
    system: str
    signal: str
    pseudorange_m: float
    carrier_phase_cycles: float
    doppler_hz: float | None          # None in MSM4 (no rate fields)
    cn0_db_hz: float
    lock_s: float = 100.0
    freq_slot: int = 0                # GLONASS FDMA channel (-7..+6)


@dataclasses.dataclass
class MsmEpoch:
    tow_ms: int
    system: str
    obs: list            # [MsmObservation]


def encode_msm(system: str, tow_ms: int, obs: list, *, msm: int = 7,
               station_id: int = 0) -> bytes:
    """Encode one constellation's epoch as MSM4 or MSM7."""
    msgnum = _MSM_BASE[system] + msm
    obs = [o for o in obs if o.system == system]
    if not obs:
        raise ValueError("no observations for " + system)
    sats = sorted({o.prn for o in obs})
    sigs = sorted({_SIG_ID[(system, o.signal)] for o in obs})
    cell = {(o.prn, _SIG_ID[(system, o.signal)]): o for o in obs}

    w = BitWriter()
    w.u(msgnum, 12).u(station_id, 12)
    w.u(int(tow_ms) % _WEEK_MS, 30)
    w.u(0, 1)            # multiple-message bit: last/only
    w.u(0, 3).u(0, 7).u(0, 2).u(0, 2).u(0, 1).u(0, 3)
    for i in range(1, 65):
        w.u(1 if i in sats else 0, 1)
    for i in range(1, 33):
        w.u(1 if i in sigs else 0, 1)
    cells = [(s, g) for s in sats for g in sigs]
    for s, g in cells:
        w.u(1 if (s, g) in cell else 0, 1)

    # per-satellite rough ranges from the first present cell, quantized
    # once (1/1024 ms) so encoder fine offsets and decoder reconstruction
    # use the identical value
    rough_q = {}
    for s in sats:
        o = next(cell[(s, g)] for g in sigs if (s, g) in cell)
        q = int(round(o.pseudorange_m / C * 1e3 * 1024.0))
        rough_q[s] = q / 1024.0
    # satellite data is FIELD-GROUPED (all DF397, then all extended
    # infos, then all DF398, then all DF399 — MSM spec ordering)
    for s in sats:
        w.u((int(rough_q[s] * 1024.0) >> 10) & 0xFF, 8)   # integer ms
    if msm == 7:
        for s in sats:
            if system == "GLONASS":
                o = next(cell[(s, g)] for g in sigs if (s, g) in cell)
                w.u(o.freq_slot + 7, 4)       # FDMA channel (3.5-77)
            else:
                w.u(0, 4)                                 # ext sat info
    for s in sats:
        w.u(int(rough_q[s] * 1024.0) & 0x3FF, 10)
    if msm == 7:
        for s in sats:
            o = next(cell[(s, g)] for g in sigs if (s, g) in cell)
            lam = _sig_lambda(system, o.signal, o.freq_slot)
            rate = (-o.doppler_hz * lam) if o.doppler_hz is not None else 0.0
            w.s(int(round(rate)), 14)

    # per-cell fine values
    def fine_fields(o, s):
        lam = _sig_lambda(o.system, o.signal, o.freq_slot)
        pr_ms = o.pseudorange_m / C * 1e3
        ph_ms = o.carrier_phase_cycles * lam / C * 1e3
        return pr_ms - rough_q[s], ph_ms - rough_q[s], lam

    present = [(s, g) for (s, g) in cells if (s, g) in cell]
    if msm == 7:
        for s, g in present:
            dpr, _, _ = fine_fields(cell[(s, g)], s)
            w.s(int(round(dpr / _P2(-29))), 20)
        for s, g in present:
            _, dph, _ = fine_fields(cell[(s, g)], s)
            w.s(int(round(dph / _P2(-31))), 24)
        for s, g in present:
            w.u(min(704, int(cell[(s, g)].lock_s * 10)), 10)
        for s, g in present:
            w.u(0, 1)                                     # half-cycle amb
        for s, g in present:
            w.u(int(round(cell[(s, g)].cn0_db_hz / _P2(-4))) & 0x3FF, 10)
        for s, g in present:
            o = cell[(s, g)]
            lam = _sig_lambda(o.system, o.signal, o.freq_slot)
            rate = (-o.doppler_hz * lam) if o.doppler_hz is not None else 0.0
            fine = rate - int(round(rate))
            w.s(int(round(fine / 1e-4)), 15)
    else:
        for s, g in present:
            dpr, _, _ = fine_fields(cell[(s, g)], s)
            w.s(int(round(dpr / _P2(-24))), 15)
        for s, g in present:
            _, dph, _ = fine_fields(cell[(s, g)], s)
            w.s(int(round(dph / _P2(-29))), 22)
        for s, g in present:
            w.u(min(15, max(0, int(cell[(s, g)].lock_s).bit_length())), 4)
        for s, g in present:
            w.u(0, 1)
        for s, g in present:
            w.u(int(round(cell[(s, g)].cn0_db_hz)) & 0x3F, 6)
    return w.tobytes()


def decode_msm(payload: bytes) -> MsmEpoch:
    r = BitReader(payload)
    msgnum = r.u(12)
    system, msm = _MSM_SYSTEM[msgnum]
    r.u(12)                                               # station id
    tow_ms = r.u(30)
    r.u(1)
    r.u(3 + 7 + 2 + 2 + 1 + 3)
    sats = [i for i in range(1, 65) if r.u(1)]
    sigs = [i for i in range(1, 33) if r.u(1)]
    cells = [(s, g) for s in sats for g in sigs]
    present = [cells[i] for i in range(len(cells)) if r.u(1)]

    rough_int = {s: r.u(8) for s in sats}
    slots = {s: 0 for s in sats}
    if msm == 7:
        for s in sats:
            ext = r.u(4)
            if system == "GLONASS":
                slots[s] = ext - 7
    rough_mod = {s: r.u(10) for s in sats}
    rates = {}
    if msm == 7:
        rates = {s: r.s(14) for s in sats}
    rough_q = {s: rough_int[s] + rough_mod[s] / 1024.0 for s in sats}

    if msm == 7:
        dpr = [r.s(20) * _P2(-29) for _ in present]
        dph = [r.s(24) * _P2(-31) for _ in present]
        lock = [r.u(10) / 10.0 for _ in present]
        _ = [r.u(1) for _ in present]
        cn0 = [r.u(10) * _P2(-4) for _ in present]
        fine_rate = [r.s(15) * 1e-4 for _ in present]
    else:
        dpr = [r.s(15) * _P2(-24) for _ in present]
        dph = [r.s(22) * _P2(-29) for _ in present]
        lock = [float(1 << r.u(4)) for _ in present]
        _ = [r.u(1) for _ in present]
        cn0 = [float(r.u(6)) for _ in present]
        fine_rate = [None] * len(present)

    obs = []
    for i, (s, g) in enumerate(present):
        signal = _SIG_NAME.get((system, g))
        if signal is None:
            continue
        lam = _sig_lambda(system, signal, slots[s])
        pr_m = (rough_q[s] + dpr[i]) * 1e-3 * C
        ph_m = (rough_q[s] + dph[i]) * 1e-3 * C
        dop = None
        if msm == 7:
            dop = -(rates[s] + fine_rate[i]) / lam
        obs.append(MsmObservation(
            prn=s, system=system, signal=signal, pseudorange_m=pr_m,
            carrier_phase_cycles=ph_m / lam, doppler_hz=dop,
            cn0_db_hz=cn0[i], lock_s=lock[i], freq_slot=slots[s]))
    return MsmEpoch(tow_ms=tow_ms, system=system, obs=obs)


# ---------------------------------------------------------------------------
# base-station stream: receiver run -> frames -> BaseObservations


class RtcmBaseEncoder:
    """Stateful encoder of a base receiver's observable stream.

    Phase continuity: real receivers report PhaseRange close to
    Pseudorange by absorbing the unknown integer ambiguity once at lock;
    the encoder picks that integer offset per (system, prn, signal) on
    first sight and keeps it, so double-difference ambiguities stay
    constant across the stream (what RTK needs)."""

    def __init__(self, base_ecef_m, station_id: int = 0, msm: int = 7,
                 signals=None):
        self.base_ecef_m = np.asarray(base_ecef_m, np.float64)
        self.station_id = station_id
        self.msm = msm
        self._phase_off = {}
        self._signals = signals

    def station_frame(self) -> bytes:
        return frame(encode_station(self.base_ecef_m, self.station_id))

    def ephemeris_frames(self, ephemerides: dict) -> list[bytes]:
        out = []
        for eph in ephemerides.values():
            if getattr(eph, "system", "GPS") in _EPH_MSG_FOR_SYSTEM:
                out.append(frame(encode_ephemeris(eph)))
        return out

    def epoch_frames(self, epoch, prns, systems, signals=None) -> list:
        """ObservationEpoch (+channel maps) -> one MSM frame per
        constellation present."""
        signals = signals or self._signals or ["1C"] * len(prns)
        by_sys = {}
        for c in range(len(prns)):
            if not epoch.valid[c] or prns[c] <= 0:
                continue
            system = systems[c]
            sig = signals[c]
            if (system, sig) not in _SIG_ID:
                continue
            lam = C / _SIG_FREQ[(system, sig)]
            key = (system, prns[c], sig)
            # the chain's accumulated-PLL-phase sign is OPPOSITE the
            # RINEX/RTCM PhaseRange convention (models/outputs.py RINEX
            # writer negates identically); negate onto the wire here and
            # back in base_observations()
            wire_cyc = -epoch.carrier_phase_cycles[c]
            if key not in self._phase_off:
                self._phase_off[key] = round(
                    (epoch.pseudorange_m[c] - wire_cyc * lam) / lam)
            ph_cyc = wire_cyc + self._phase_off[key]
            by_sys.setdefault(system, []).append(MsmObservation(
                prn=int(prns[c]), system=system, signal=sig,
                pseudorange_m=float(epoch.pseudorange_m[c]),
                carrier_phase_cycles=float(ph_cyc),
                doppler_hz=float(epoch.carrier_doppler_hz[c]),
                cn0_db_hz=float(epoch.cn0_db_hz[c])))
        tow_ms = int(round(epoch.rx_time_s * 1e3))
        return [frame(encode_msm(system, tow_ms, obs, msm=self.msm,
                                 station_id=self.station_id))
                for system, obs in sorted(by_sys.items())]

    def encode_run(self, run, ephemerides: dict | None = None) -> bytes:
        """Whole base run -> one byte stream (station + eph + epochs)."""
        chunks = [self.station_frame()]
        if ephemerides:
            chunks.extend(self.ephemeris_frames(ephemerides))
        systems = (list(run.channel_systems) if run.channel_systems
                   else ["GPS"] * len(run.channel_prns))
        for ep in run.observation_epochs:
            chunks.extend(self.epoch_frames(ep, run.channel_prns, systems))
        return b"".join(chunks)


class RtcmBaseDecoder:
    """Frame stream -> rtk.BaseObservations + ephemerides."""

    def __init__(self):
        self.base_ecef_m = None
        self.ephemerides = {}
        self._epochs = {}        # tow_ms -> {(system, prn, signal): obs}

    def feed(self, data: bytes):
        for payload in iter_frames(data):
            self.feed_payload(payload)

    def feed_payload(self, payload: bytes):
        msg = message_number(payload)
        if msg == 1005:
            self.base_ecef_m, _ = decode_station(payload)
        elif msg in _EPH_MSGS:
            eph = decode_ephemeris(payload)
            key = eph.prn if eph.system == "GPS" else (eph.system, eph.prn)
            self.ephemerides[key] = eph
        elif msg in _MSM_SYSTEM:
            ep = decode_msm(payload)
            slot = self._epochs.setdefault(ep.tow_ms, {})
            for o in ep.obs:
                slot[(o.system, o.prn, o.signal)] = o

    def base_observations(self):
        """Materialize rtk.BaseObservations from everything decoded."""
        from gnss_sim_receiver_tpu_torch.models.observables import ObservationEpoch
        from gnss_sim_receiver_tpu_torch.models.rtk import BaseObservations
        keys = sorted({k for slot in self._epochs.values() for k in slot})
        idx = {k: i for i, k in enumerate(keys)}
        n = len(keys)
        epochs = []
        for tow_ms in sorted(self._epochs):
            slot = self._epochs[tow_ms]
            valid = np.zeros(n, bool)
            pr = np.zeros(n)
            ph = np.zeros(n)
            dop = np.zeros(n)
            cn0 = np.zeros(n)
            for k, o in slot.items():
                i = idx[k]
                valid[i] = True
                pr[i] = o.pseudorange_m
                # wire PhaseRange -> the chain's accumulated-PLL-phase
                # sign (inverse of the encoder's negation; the DD engine
                # re-flips at ingestion, rtk.py)
                ph[i] = -o.carrier_phase_cycles
                dop[i] = o.doppler_hz or 0.0
                cn0[i] = o.cn0_db_hz
            # per-satellite transmit TOW: rx epoch minus travel time (the
            # observables engine's convention — satellite positions are
            # evaluated at these, so the epoch time alone would shift
            # them by ~70 ms x satellite velocity = hundreds of meters)
            tow_tx = np.where(valid, tow_ms - pr / C * 1e3, float(tow_ms))
            epochs.append(ObservationEpoch(
                rx_time_s=tow_ms * 1e-3, tick_sample=0, valid=valid,
                pseudorange_m=pr, interp_tow_ms=tow_tx,
                carrier_doppler_hz=dop, carrier_phase_cycles=ph,
                cn0_db_hz=cn0))
        if self.base_ecef_m is None:
            raise ValueError("no 1005 station message decoded")
        return BaseObservations(
            epochs=epochs, prns=[k[1] for k in keys],
            systems=[k[0] for k in keys],
            base_ecef_m=self.base_ecef_m)


# ---------------------------------------------------------------------------
# TCP transport (rtcm_printer.cc server / rtklib stream client roles)

_SOCKET_TIMEOUT_S = 10.0    # a served client's send, and close()'s join


class FrameServer:
    """Loopback TCP server sending one byte stream to every client that
    connects, on a thread of its own.  Every socket has a timeout; close()
    stops the thread, joins it and closes the listening socket."""

    def __init__(self, data: bytes, host: str = "127.0.0.1", port: int = 0):
        if host not in ("127.0.0.1", "localhost"):
            raise ValueError(f"serve_frames serves loopback only, not {host}")
        self.data = bytes(data)
        self._stop = threading.Event()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind((host, port))
            self.sock.listen(4)
            # accept() wakes this often to see close()
            self.sock.settimeout(0.1)
        except OSError:
            self.sock.close()
            raise
        self.port = self.sock.getsockname()[1]
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(_SOCKET_TIMEOUT_S)
                conn.sendall(self.data)
            except OSError:
                pass
            finally:
                conn.close()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(_SOCKET_TIMEOUT_S + 1.0)
        self.sock.close()


def serve_frames(data: bytes, host: str = "127.0.0.1", port: int = 0):
    """Serve an RTCM byte stream on loopback to every client that connects;
    returns (port, server), as the JAX package's does: server.close() stops
    the serving thread, joins it and closes the socket.  Single-shot helper
    for tests and tools; a real deployment would stream epochs as they
    form."""
    srv = FrameServer(data, host, port)
    return srv.port, srv


def read_frames(host: str, port: int, timeout_s: float = 10.0) -> bytes:
    """Read an RTCM byte stream from a TCP server until EOF."""
    s = socket.create_connection((host, port), timeout=timeout_s)
    try:
        s.settimeout(timeout_s)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    finally:
        s.close()
    return b"".join(chunks)
