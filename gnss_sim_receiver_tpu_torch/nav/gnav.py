"""GLONASS L1/L2 C/A GNAV message layer: string encode (simulator) and
streaming decode, plus the PZ-90 ECEF-state ephemeris model.

Mirrors the reference's glonass_l1_ca_telemetry_decoder_gs /
glonass_gnav_navigation_message (time-mark correlation, meander wipeoff,
KX Hamming check, strings 1-5 -> ephemeris/clock) and the ECEF ephemeris
propagation of rtklib_ephemeris.cc geph2pos (RK4 over the PZ-90 equations
of motion with J2 and the broadcast luni-solar acceleration).

Structure per the GLONASS ICD 5.1:
  superframe = 5 frames; frame = 15 strings; string = 2 s:
    1.7 s of data = 85 bits x 20 ms, each bit XOR-ed with a 10 ms meander
    square wave (=> 170 symbols at 100 sps, "bi-binary" encoding), then
    0.3 s time mark = fixed 30-symbol sequence at 100 sps.
  string bits (transmission order b85..b1): b85 idle(0), b84..b9 data,
    b8..b1 the KX (85,77) Hamming check bits (C1..C7 + C_Sigma).
  Strings 1-4 carry the ephemeris: ECEF position/velocity/acceleration of
  the satellite at epoch tb (15-min grid), SV clock tau_n / gamma_n.

Symbol rate on the signal: the 511-chip code repeats every 1 ms; GNAV
symbols span 10 ms (meander half-bits), so one telemetry symbol per 10
code epochs.

Copy of ``gnss_sim_receiver_tpu.nav.gnav`` for the PyTorch port (the port
imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 30-symbol time mark (ICD: 0.3 s at 100 sps; glonass_gnav_telemetry)
TIME_MARK = np.array([1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0,
                      1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0],
                     dtype=np.int64)
STRING_SYMBOLS = 200        # 170 data symbols + 30 time mark
STRING_SECONDS = 2.0
DATA_BITS = 85              # incl. idle bit + 8 check bits
SYMBOLS_PER_BIT = 2         # meander halves
EPOCHS_PER_SYMBOL = 10      # 10 ms symbol over 1 ms code epochs

_KM = 1000.0


# --------------------------------------------------------------------------
# KX (85,77) Hamming code — C1..C7 + overall parity C_Sigma.  Index sets
# follow the standard Hamming construction over data-bit positions 9..84
# (idle bit 85 excluded), self-consistent between encode and check.
# --------------------------------------------------------------------------

def _kx_sets():
    sets = []
    for i in range(7):
        sets.append([b for b in range(9, 86) if ((b - 1) >> i) & 1])
    return sets


_KX = _kx_sets()


def kx_encode(data76: np.ndarray) -> np.ndarray:
    """76 data bits (b84..b9, MSB-first transmission order) -> 85-bit
    string [b85..b1]: idle 0 + data + 8 check bits."""
    bits = np.zeros(86, dtype=np.int64)   # 1-indexed b1..b85
    d = np.asarray(data76, dtype=np.int64)
    for k in range(76):
        bits[84 - k] = d[k]               # b84 first
    for i, s in enumerate(_KX):
        bits[i + 1] = int(np.sum(bits[s]) & 1)
    bits[8] = int(np.sum(bits[1:8]) + np.sum(bits[9:86])) & 1   # C_Sigma
    return bits[1:][::-1].copy()          # transmission order b85..b1


def kx_check(string85: np.ndarray) -> bool:
    """Verify the 8 KX parities of an 85-bit string in transmission
    order (b85 first)."""
    rx = np.asarray(string85, dtype=np.int64)[::-1]   # b1..b85
    bits = np.concatenate([[0], rx])                  # 1-indexed
    for i, s in enumerate(_KX):
        if int(np.sum(bits[s]) & 1) != bits[i + 1]:
            return False
    c_sig = int(np.sum(bits[1:8]) + np.sum(bits[9:86])) & 1
    return c_sig == bits[8]


# --------------------------------------------------------------------------
# string payload layouts: field -> (start, n, scale, signed) over the 76
# data bits (1-indexed within b84..b9, i.e. position 1 = b84).  Sign
# convention: ICD sign-magnitude replaced by two's complement here
# (self-consistent encode/decode), scales per ICD tables 4.5/4.9.
# --------------------------------------------------------------------------

_S1 = {
    "tk_s":  (5, 12, 30.0, False),            # time of frame start
    "vx":    (17, 24, 2.0 ** -20 * _KM, True),
    "ax":    (41, 5, 2.0 ** -30 * _KM, True),
    "x":     (46, 27, 2.0 ** -11 * _KM, True),
}
_S2 = {
    "bn":    (1, 3, 1.0, False),
    "tb_s":  (8, 7, 15.0 * 60.0, False),      # 15-min grid epoch
    "vy":    (17, 24, 2.0 ** -20 * _KM, True),
    "ay":    (41, 5, 2.0 ** -30 * _KM, True),
    "y":     (46, 27, 2.0 ** -11 * _KM, True),
}
_S3 = {
    "p3":       (1, 1, 1.0, False),
    "gamma_n":  (2, 11, 2.0 ** -40, True),
    "vz":       (17, 24, 2.0 ** -20 * _KM, True),
    "az":       (41, 5, 2.0 ** -30 * _KM, True),
    "z":        (46, 27, 2.0 ** -11 * _KM, True),
}
_S4 = {
    "tau_n":     (1, 22, 2.0 ** -30, True),
    "delta_tau": (23, 5, 2.0 ** -30, True),
    "en_days":   (28, 5, 1.0, False),
    "ft":        (43, 4, 1.0, False),
    "nt_days":   (50, 11, 1.0, False),
    "slot":      (61, 5, 1.0, False),
    "m_type":    (66, 2, 1.0, False),
}
_S5 = {
    "na_days": (1, 11, 1.0, False),
    "tau_c":   (12, 32, 2.0 ** -31, True),
    "n4":      (45, 5, 1.0, False),
    "tau_gps": (50, 22, 2.0 ** -30, True),
}
STRING_FIELDS = {1: _S1, 2: _S2, 3: _S3, 4: _S4, 5: _S5}


def pack_string(string_id: int, fields: dict[str, float]) -> np.ndarray:
    """string number (4 bits) + payload -> 85 bits in transmission order."""
    data = np.zeros(76, dtype=np.int64)
    for i in range(4):
        data[i] = (string_id >> (3 - i)) & 1
    layout = STRING_FIELDS[string_id]
    for name, (start, n, scale, signed) in layout.items():
        raw = int(round(fields.get(name, 0.0) / scale))
        if signed:
            lim = 1 << (n - 1)
            raw = max(-lim, min(lim - 1, raw)) & ((1 << n) - 1)
        else:
            raw = max(0, min((1 << n) - 1, raw))
        for i in range(n):
            data[4 + start - 1 + i] = (raw >> (n - 1 - i)) & 1
    return kx_encode(data)


def unpack_string(string85: np.ndarray):
    """85 bits (transmission order) -> (kx_ok, string_id, fields)."""
    ok = kx_check(string85)
    rx = np.asarray(string85, dtype=np.int64)
    data = rx[1:77]                       # b84..b9
    sid = 0
    for i in range(4):
        sid = (sid << 1) | int(data[i])
    fields = {}
    for name, (start, n, scale, signed) in STRING_FIELDS.get(sid,
                                                             {}).items():
        raw = 0
        for i in range(n):
            raw = (raw << 1) | int(data[4 + start - 1 + i])
        if signed and raw >> (n - 1):
            raw -= 1 << n
        fields[name] = raw * scale
    return ok, sid, fields


def encode_string_symbols(string85: np.ndarray) -> np.ndarray:
    """85 bits -> 200 transmitted symbols {0,1}: bi-binary (bit XOR
    meander 10-01) + time mark."""
    b = np.asarray(string85, dtype=np.int64)
    sym = np.empty(170, dtype=np.int64)
    sym[0::2] = b ^ 1      # meander first half
    sym[1::2] = b          # second half
    return np.concatenate([sym, TIME_MARK])


# --------------------------------------------------------------------------
# PZ-90 ECEF ephemeris with RK4 propagation (rtklib geph2pos equivalent)
# --------------------------------------------------------------------------

_GM = 398_600.44e9          # PZ-90.11 [m^3/s^2]
_J2 = 1.0826257e-3
_RE = 6_378_136.0           # [m]
_OMGE = 7.292115e-5         # earth rotation [rad/s]


def _glo_deriv(state, acc_ls):
    """d/dt of [r, v] in the rotating PZ-90 frame: central + J2 gravity,
    Coriolis/centrifugal, broadcast luni-solar acceleration."""
    x, y, z, vx, vy, vz = state
    r2 = x * x + y * y + z * z
    r = np.sqrt(r2)
    a = -_GM / (r2 * r)
    b = 1.5 * _J2 * _GM * _RE * _RE / (r2 * r2 * r)   # J2 coefficient
    c = 5.0 * z * z / r2
    return np.array([
        vx, vy, vz,
        a * x - b * (1.0 - c) * x + _OMGE * _OMGE * x
        + 2.0 * _OMGE * vy + acc_ls[0],
        a * y - b * (1.0 - c) * y + _OMGE * _OMGE * y
        - 2.0 * _OMGE * vx + acc_ls[1],
        a * z - b * (3.0 - c) * z + acc_ls[2],
    ])


@dataclasses.dataclass
class GlonassEphemeris:
    """Broadcast ECEF state at tb (strings 1-4).  Times are seconds on the
    same continuous timescale the receiver's TOW stamps use (the simulator
    keeps GPS/GLONASS offsets at zero; real-data conversion is a PVT
    concern, rtklib gpst2utc+3h)."""
    prn: int = 0                 # orbital slot number
    freq_slot: int = 0           # FDMA k in [-7, 6]
    system: str = "GLONASS"
    week: int = 0
    tb_s: float = 0.0            # state epoch
    pos_m: tuple = (0.0, 0.0, 0.0)
    vel_ms: tuple = (0.0, 0.0, 0.0)
    acc_ms2: tuple = (0.0, 0.0, 0.0)   # broadcast luni-solar acceleration
    tau_n: float = 0.0           # SV clock bias [s] (ICD sign: dt = -tau)
    gamma_n: float = 0.0         # relative frequency offset
    iode: int = 0                # tb-derived age marker

    @property
    def toe(self):
        return self.tb_s

    @property
    def tgd(self):
        return 0.0

    def sat_pos_clock(self, t_s, step: float = 60.0):
        """RK4-propagated ECEF position [m] + SV clock bias [s] at
        transmit time t_s (rtklib geph2pos: 60 s RK4 steps)."""
        t = float(np.asarray(t_s).reshape(-1)[0]) \
            if np.ndim(t_s) else float(t_s)
        state = np.concatenate([np.asarray(self.pos_m, np.float64),
                                np.asarray(self.vel_ms, np.float64)])
        acc = np.asarray(self.acc_ms2, np.float64)
        dt = t - self.tb_s
        n = max(1, int(np.ceil(abs(dt) / step)))
        h = dt / n
        for _ in range(n):
            k1 = _glo_deriv(state, acc)
            k2 = _glo_deriv(state + 0.5 * h * k1, acc)
            k3 = _glo_deriv(state + 0.5 * h * k2, acc)
            k4 = _glo_deriv(state + h * k3, acc)
            state = state + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        clk = -self.tau_n + self.gamma_n * dt
        return state[:3], clk

    def sat_vel(self, t_s):
        p1, _ = self.sat_pos_clock(t_s - 0.5)
        p2, _ = self.sat_pos_clock(t_s + 0.5)
        return (np.asarray(p2) - np.asarray(p1))


def glonass_ephemeris_to_strings(eph: GlonassEphemeris) -> dict[int, dict]:
    p, v, a = eph.pos_m, eph.vel_ms, eph.acc_ms2
    day_s = eph.tb_s % 86400.0
    return {
        1: dict(tk_s=(eph.tb_s % 86400.0) // 30 * 30,
                x=p[0], vx=v[0], ax=a[0]),
        2: dict(tb_s=day_s, y=p[1], vy=v[1], ay=a[1]),
        3: dict(gamma_n=eph.gamma_n, z=p[2], vz=v[2], az=a[2]),
        4: dict(tau_n=eph.tau_n, slot=eph.prn, nt_days=0, ft=2),
        5: dict(tau_c=0.0, n4=7),
    }


def strings_to_glonass_ephemeris(slot_hint: int, strings: dict[int, dict],
                                 day_base_s: float = 0.0,
                                 freq_slot: int = 0) -> GlonassEphemeris:
    """Strings 1-4 -> ephemeris.  `day_base_s` restores the day count the
    7-bit tb field cannot carry (the reference gets it from the receiver
    date)."""
    s1, s2, s3, s4 = strings[1], strings[2], strings[3], strings[4]
    tb = day_base_s + s2["tb_s"]
    return GlonassEphemeris(
        prn=int(s4.get("slot", slot_hint)) or slot_hint,
        freq_slot=freq_slot,
        tb_s=tb,
        pos_m=(s1["x"], s2["y"], s3["z"]),
        vel_ms=(s1["vx"], s2["vy"], s3["vz"]),
        acc_ms2=(s1["ax"], s2["ay"], s3["az"]),
        tau_n=s4["tau_n"], gamma_n=s3["gamma_n"],
        iode=int(s2["tb_s"] / 900.0) % 128,
    )


def strings_for_ephemeris(eph: GlonassEphemeris, t0_s: float,
                          n_repeats: int = 2) -> np.ndarray:
    """GNAV symbol stream {0,1} at 100 sps: full ICD frames of 15 strings
    (30 s) — strings 1-5 ephemeris/time, strings 6-15 zero-payload
    placeholders where the ICD carries almanac (gap item).  `t0_s` must be
    a multiple of 30 s (frame grid — tk's resolution); string 1 of frame f
    starts at t0 + 30 f and carries tk = that time-of-day.  The time mark
    TRAILS each string's data (ICD: last 0.3 s)."""
    if t0_s % 30.0:
        raise ValueError("t0_s must be a multiple of 30 s (frame grid)")
    fields = glonass_ephemeris_to_strings(eph)
    out = []
    for frame in range(n_repeats):
        f1 = dict(fields[1], tk_s=(t0_s + frame * 30.0) % 86400.0)
        for sid in range(1, 16):
            f = f1 if sid == 1 else fields.get(sid, {})
            out.append(encode_string_symbols(pack_string(sid, f)
                       if sid <= 5 else kx_encode(_sid_only(sid))))
    return np.concatenate(out)


def _sid_only(sid: int) -> np.ndarray:
    data = np.zeros(76, dtype=np.int64)
    for i in range(4):
        data[i] = (sid >> (3 - i)) & 1
    return data


@dataclasses.dataclass
class GnavStringEvent:
    string_id: int
    fields: dict
    string_start_symbol: int     # stream symbol index of the string start
    kx_ok: bool


class GnavStringDecoder:
    """Streaming GNAV string synchronizer/decoder for one channel: feed
    soft 100-sps symbols (10 ms meander halves); time-mark correlation
    aligns the 200-symbol string grid, meander is wiped by differencing
    the two halves of each bit, KX parity gates the output."""

    def __init__(self):
        self.sym: list[float] = []
        self._aligned = False
        self._inverted = False
        self._next_string = 0
        self._kx_fails = 0

    def push_symbols(self, soft) -> list[GnavStringEvent]:
        self.sym.extend(float(s) for s in soft)
        events = []
        while True:
            if not self._aligned and not self._try_align():
                break
            if len(self.sym) < self._next_string + STRING_SYMBOLS:
                break
            ev = self._decode_string()
            if ev is not None:
                events.append(ev)
        return events

    def _try_align(self) -> bool:
        """Time-mark search: the 30-symbol mark occupies the LAST 30
        symbols of each 200-symbol string; require two marks one string
        apart with equal polarity."""
        s = np.sign(np.asarray(self.sym, dtype=np.float64))
        tm = 2.0 * TIME_MARK - 1.0
        n = len(s)
        i = max(self._next_string, 0)
        while i + STRING_SYMBOLS + 230 <= n:
            c0 = float(np.dot(s[i + 170:i + 200], tm))
            if abs(c0) == 30.0:
                c1 = float(np.dot(s[i + 370:i + 400], tm))
                if c1 == c0:
                    self._aligned = True
                    self._inverted = c0 < 0
                    self._next_string = i
                    return True
            i += 1
        self._next_string = max(self._next_string, n - STRING_SYMBOLS - 230)
        return False

    def _decode_string(self):
        i = self._next_string
        raw = np.asarray(self.sym[i:i + 170], dtype=np.float64)
        if self._inverted:
            raw = -raw
        # meander wipeoff: bit soft metric = second half - first half
        soft_bits = raw[1::2] - raw[0::2]
        bits = (soft_bits > 0).astype(np.int64)
        start = i
        self._next_string = i + STRING_SYMBOLS
        ok, sid, fields = unpack_string(bits)
        if not ok:
            self._kx_fails += 1
            if self._kx_fails >= 4:
                self._aligned = False
                self._kx_fails = 0
            return GnavStringEvent(-1, {}, start, False)
        self._kx_fails = 0
        return GnavStringEvent(sid, fields, start, True)
