"""GPS ephemeris model: Keplerian broadcast ephemeris -> satellite position
and clock (IS-GPS-200 20.3.3.4.3), the equivalent of the reference's
Gps_Ephemeris (src/core/system_parameters/gps_ephemeris.h) plus the SV
position math of rtklib_ephemeris.cc (eph2pos).

Angles that LNAV transmits in semicircles are stored in semicircles here so
the encode/decode roundtrip is bit-exact; the propagator converts.

Copy of the GPS, Galileo and BeiDou parts of
``gnss_sim_receiver_tpu.nav.ephemeris``
for the PyTorch port (the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants

_PI = np.pi  # semicircle -> rad


@dataclasses.dataclass
class GpsEphemeris:
    prn: int = 0
    week: int = 0
    # constellation ("GPS", "Galileo" or "BeiDou"): selects GM for the
    # propagator and the group-delay fields that apply (tgd vs bgd_*); the
    # Kepler broadcast model is otherwise identical (Galileo OS SIS ICD
    # 5.1.1, BDS-SIS-ICD 5.2.4 vs IS-GPS-200)
    system: str = "GPS"
    # clock (subframe 1)
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    iodc: int = 0
    # orbit (subframes 2-3); *_sc fields are in SEMICIRCLES (LNAV units)
    iode: int = 0
    toe: float = 0.0
    sqrt_a: float = 0.0
    ecc: float = 0.0
    m0_sc: float = 0.0
    delta_n_sc: float = 0.0
    omega0_sc: float = 0.0
    omega_sc: float = 0.0
    omega_dot_sc: float = 0.0
    i0_sc: float = 0.0
    idot_sc: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    # Galileo broadcast group delays (INAV word 5); unused for GPS
    bgd_e1e5a: float = 0.0
    bgd_e1e5b: float = 0.0
    iod_nav: int = 0

    def sat_pos_clock(self, t_gps_s):
        """ECEF position [m] and SV clock bias [s] at GPS transmit time
        t_gps_s (seconds of week).  Vectorized over t."""
        t = np.asarray(t_gps_s, dtype=np.float64)
        a = self.sqrt_a ** 2
        n0 = np.sqrt(_gm(self.system) / a ** 3)
        tk = _wrap_week(t - self.toe)
        n = n0 + self.delta_n_sc * _PI
        m = self.m0_sc * _PI + n * tk
        e = self.ecc
        ek = _kepler(m, e)
        sin_ek, cos_ek = np.sin(ek), np.cos(ek)
        nu = np.arctan2(np.sqrt(1 - e * e) * sin_ek, cos_ek - e)
        phi = nu + self.omega_sc * _PI
        s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
        du = self.cus * s2p + self.cuc * c2p
        dr = self.crs * s2p + self.crc * c2p
        di = self.cis * s2p + self.cic * c2p
        u = phi + du
        r = a * (1 - e * cos_ek) + dr
        inc = self.i0_sc * _PI + self.idot_sc * _PI * tk + di
        omega = (self.omega0_sc * _PI
                 + (self.omega_dot_sc * _PI
                    - constants.GPS_OMEGA_EARTH_DOT) * tk
                 - constants.GPS_OMEGA_EARTH_DOT * self.toe)
        xp = r * np.cos(u)
        yp = r * np.sin(u)
        so, co = np.sin(omega), np.cos(omega)
        si, ci = np.sin(inc), np.cos(inc)
        pos = np.stack([xp * co - yp * ci * so,
                        xp * so + yp * ci * co,
                        yp * si], axis=-1)
        # SV clock: polynomial + relativistic correction (no TGD here; L1
        # pseudorange correction applies tgd at the solver, as RTKLIB does)
        dtc = _wrap_week(t - self.toc)
        clk = (self.af0 + self.af1 * dtc + self.af2 * dtc * dtc
               + constants.GPS_F_RELATIVISTIC * e * self.sqrt_a * sin_ek)
        return pos, clk

    def sat_vel(self, t_gps_s, dt: float = 1e-3):
        """Numerical ECEF velocity [m/s] (sufficient for Doppler truth and
        the LS velocity solver)."""
        p1, _ = self.sat_pos_clock(np.asarray(t_gps_s) - dt)
        p2, _ = self.sat_pos_clock(np.asarray(t_gps_s) + dt)
        return (p2 - p1) / (2 * dt)


_BATCH_FIELDS = ("toe", "toc", "sqrt_a", "ecc", "m0_sc", "delta_n_sc",
                 "omega0_sc", "omega_sc", "omega_dot_sc", "i0_sc",
                 "idot_sc", "cuc", "cus", "crc", "crs", "cic", "cis",
                 "af0", "af1", "af2")


def sat_states_batch(ephs, t_sv_s):
    """Vectorized satellite states for one observation epoch: positions
    [K, 3], clock biases [K] and velocities [K, 3] for K ephemerides at
    per-satellite SV transmit times t_sv_s [K].

    One broadcast Kepler solve replaces K scalar sat_pos_clock calls per
    LS iteration — the PVT solver calls this once per epoch (the
    profiled receiver spent ~20% of its host time in per-satellite
    scalar ephemeris evaluations).  Matches sat_pos_clock()/sat_vel()
    exactly: the SV->GPS clock iteration and the central-difference
    velocity are evaluated on the same stacked math."""
    k = len(ephs)
    f = {name: np.array([getattr(e, name) for e in ephs], np.float64)
         for name in _BATCH_FIELDS}
    gm = np.array([_gm(e.system) for e in ephs], np.float64)

    def _eval(t):
        # t [..., K] broadcast against the [K] field arrays
        a = f["sqrt_a"] ** 2
        n0 = np.sqrt(gm / a ** 3)
        tk = _wrap_week(t - f["toe"])
        m = f["m0_sc"] * _PI + (n0 + f["delta_n_sc"] * _PI) * tk
        e = f["ecc"]
        ek = _kepler(m, e)
        sin_ek, cos_ek = np.sin(ek), np.cos(ek)
        nu = np.arctan2(np.sqrt(1 - e * e) * sin_ek, cos_ek - e)
        phi = nu + f["omega_sc"] * _PI
        s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
        u = phi + f["cus"] * s2p + f["cuc"] * c2p
        r = a * (1 - e * cos_ek) + f["crs"] * s2p + f["crc"] * c2p
        inc = (f["i0_sc"] * _PI + f["idot_sc"] * _PI * tk
               + f["cis"] * s2p + f["cic"] * c2p)
        omega = (f["omega0_sc"] * _PI
                 + (f["omega_dot_sc"] * _PI
                    - constants.GPS_OMEGA_EARTH_DOT) * tk
                 - constants.GPS_OMEGA_EARTH_DOT * f["toe"])
        xp = r * np.cos(u)
        yp = r * np.sin(u)
        so, co = np.sin(omega), np.cos(omega)
        si, ci = np.sin(inc), np.cos(inc)
        pos = np.stack([xp * co - yp * ci * so,
                        xp * so + yp * ci * co,
                        yp * si], axis=-1)
        dtc = _wrap_week(t - f["toc"])
        clk = (f["af0"] + f["af1"] * dtc + f["af2"] * dtc * dtc
               + constants.GPS_F_RELATIVISTIC * e * f["sqrt_a"] * sin_ek)
        return pos, clk

    t_sv = np.asarray(t_sv_s, np.float64)
    _, clk0 = _eval(t_sv)
    t_gps = t_sv - clk0
    pos, clk = _eval(t_gps)
    dt = 1e-3
    p1, _ = _eval(t_gps - dt)
    p2, _ = _eval(t_gps + dt)
    vel = (p2 - p1) / (2 * dt)
    assert pos.shape == (k, 3)
    return pos, clk, vel


def _gm(system: str) -> float:
    """Earth's gravitational constant of the system's broadcast model:
    Galileo (GTRF) and BeiDou (CGCS2000) broadcast the same value."""
    return (constants.GALILEO_GM if system in ("Galileo", "BeiDou")
            else constants.GPS_GM)


def _wrap_week(dt):
    """Half-week wrap of time differences (IS-GPS-200 20.3.3.4.3)."""
    dt = np.asarray(dt, dtype=np.float64)
    dt = np.where(dt > 302400.0, dt - 604800.0, dt)
    return np.where(dt < -302400.0, dt + 604800.0, dt)


def _kepler(m, e, iters: int = 12):
    """Solve E - e sin E = M by Newton iteration (vectorized)."""
    ek = np.asarray(m, dtype=np.float64).copy()
    for _ in range(iters):
        ek = ek - (ek - e * np.sin(ek) - m) / (1 - e * np.cos(ek))
    return ek


def ephemeris_to_fields(eph: GpsEphemeris):
    """GpsEphemeris -> the three LNAV subframe physical-field dicts consumed
    by nav.lnav.pack_subframe."""
    f1 = dict(week=eph.week % 1024, ura=0, health=0, iodc=eph.iodc,
              tgd=eph.tgd, toc=eph.toc, af2=eph.af2, af1=eph.af1,
              af0=eph.af0)
    f2 = dict(iode=eph.iode, crs=eph.crs, delta_n=eph.delta_n_sc,
              m0=eph.m0_sc, cuc=eph.cuc, ecc=eph.ecc, cus=eph.cus,
              sqrt_a=eph.sqrt_a, toe=eph.toe)
    f3 = dict(cic=eph.cic, omega0=eph.omega0_sc, cis=eph.cis, i0=eph.i0_sc,
              crc=eph.crc, omega=eph.omega_sc, omega_dot=eph.omega_dot_sc,
              iode_sf3=eph.iode, idot=eph.idot_sc)
    return f1, f2, f3


def fields_to_ephemeris(prn: int, f1: dict, f2: dict, f3: dict
                        ) -> GpsEphemeris:
    """Decoded subframe fields -> GpsEphemeris (inverse of
    ephemeris_to_fields)."""
    return GpsEphemeris(
        prn=prn, week=int(f1["week"]), toc=f1["toc"], af0=f1["af0"],
        af1=f1["af1"], af2=f1["af2"], tgd=f1["tgd"], iodc=int(f1["iodc"]),
        iode=int(f2["iode"]), toe=f2["toe"], sqrt_a=f2["sqrt_a"],
        ecc=f2["ecc"], m0_sc=f2["m0"], delta_n_sc=f2["delta_n"],
        omega0_sc=f3["omega0"], omega_sc=f3["omega"],
        omega_dot_sc=f3["omega_dot"], i0_sc=f3["i0"], idot_sc=f3["idot"],
        cuc=f2["cuc"], cus=f2["cus"], crc=f3["crc"], crs=f2["crs"],
        cic=f3["cic"], cis=f3["cis"],
    )


def galileo_ephemeris_to_words(eph: GpsEphemeris) -> dict[int, dict]:
    """Ephemeris -> INAV word-type 1..5 physical field dicts (inverse of
    words_to_galileo_ephemeris; layouts in nav.inav.WORD_FIELDS)."""
    iod = int(eph.iod_nav or eph.iode) % 1024
    w1 = dict(iod_nav=iod, toe=eph.toe, m0=eph.m0_sc, ecc=eph.ecc,
              sqrt_a=eph.sqrt_a)
    w2 = dict(iod_nav=iod, omega0=eph.omega0_sc, i0=eph.i0_sc,
              omega=eph.omega_sc, idot=eph.idot_sc)
    w3 = dict(iod_nav=iod, omega_dot=eph.omega_dot_sc,
              delta_n=eph.delta_n_sc, cuc=eph.cuc, cus=eph.cus,
              crc=eph.crc, crs=eph.crs, sisa=107)
    w4 = dict(iod_nav=iod, svid=eph.prn, cic=eph.cic, cis=eph.cis,
              toc=eph.toc, af0=eph.af0, af1=eph.af1, af2=eph.af2)
    w5 = dict(bgd_e1e5a=eph.bgd_e1e5a, bgd_e1e5b=eph.bgd_e1e5b,
              wn=eph.week, tow=0.0)
    return {1: w1, 2: w2, 3: w3, 4: w4, 5: w5}


def words_to_galileo_ephemeris(prn: int, words: dict[int, dict]
                               ) -> GpsEphemeris:
    """INAV decoded word fields (types 1-4, optionally 5) -> ephemeris.
    Caller is responsible for IOD_nav consistency across words 1-4
    (galileo_inav_message.cc:202 have_new_ephemeris)."""
    w1, w2, w3, w4 = words[1], words[2], words[3], words[4]
    w5 = words.get(5, {})
    return GpsEphemeris(
        prn=prn, system="Galileo", week=int(w5.get("wn", 0)),
        iod_nav=int(w1["iod_nav"]), iode=int(w1["iod_nav"]),
        iodc=int(w1["iod_nav"]),
        toe=w1["toe"], m0_sc=w1["m0"], ecc=w1["ecc"], sqrt_a=w1["sqrt_a"],
        omega0_sc=w2["omega0"], i0_sc=w2["i0"], omega_sc=w2["omega"],
        idot_sc=w2["idot"],
        omega_dot_sc=w3["omega_dot"], delta_n_sc=w3["delta_n"],
        cuc=w3["cuc"], cus=w3["cus"], crc=w3["crc"], crs=w3["crs"],
        cic=w4["cic"], cis=w4["cis"], toc=w4["toc"],
        af0=w4["af0"], af1=w4["af1"], af2=w4["af2"],
        bgd_e1e5a=w5.get("bgd_e1e5a", 0.0),
        bgd_e1e5b=w5.get("bgd_e1e5b", 0.0),
        # INAV clock terms are E1/E5b dual-frequency referenced, so an
        # E1-only user corrects with BGD(E1,E5b) (OS SIS ICD 5.1.5)
        tgd=w5.get("bgd_e1e5b", 0.0),
    )


def almanac_to_ephemeris(prn: int, fields: dict, week: int = 0
                         ) -> GpsEphemeris:
    """Reduced-precision GpsEphemeris from LNAV subframe 4/5 almanac
    fields (IS-GPS-200 20.3.3.5.2.1: i = 0.3 semicircles + delta_i, no
    harmonic corrections), good to ~1-2 km: what visible-satellite
    prediction needs (control_thread.cc get_visible_sats)."""
    return GpsEphemeris(
        prn=int(prn), week=week,
        toc=float(fields.get("toa", 0.0)), toe=float(fields.get("toa",
                                                                0.0)),
        af0=float(fields.get("af0", 0.0)), af1=float(fields.get("af1",
                                                                0.0)),
        af2=0.0, iodc=0, iode=0,
        sqrt_a=float(fields.get("sqrt_a", 0.0)),
        ecc=float(fields.get("ecc", 0.0)),
        m0_sc=float(fields.get("m0", 0.0)),
        delta_n_sc=0.0,
        omega_sc=float(fields.get("omega", 0.0)),
        omega0_sc=float(fields.get("omega0", 0.0)),
        omega_dot_sc=float(fields.get("omega_dot", 0.0)),
        i0_sc=0.3 + float(fields.get("delta_i", 0.0)),
        idot_sc=0.0,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0)


def save_ephemerides(path, ephemerides: dict) -> None:
    """Write decoded ephemerides as JSON for a warm or hot start (the
    reference's gps_ephemeris.xml dumps, control_thread.cc:500-560)."""
    import json
    out = {str(prn): dataclasses.asdict(e) for prn, e in ephemerides.items()}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)


def load_ephemerides(path) -> dict:
    """The ephemerides save_ephemerides wrote, keyed by PRN."""
    import json
    with open(path) as fh:
        raw = json.load(fh)
    return {int(prn): GpsEphemeris(**fields) for prn, fields in raw.items()}


def make_sky_constellation(rx_lat_deg: float, rx_lon_deg: float,
                           toe: float, week: int = 2200,
                           offsets_deg=None) -> list[GpsEphemeris]:
    """Fabricate a constellation guaranteed visible from a ground site:
    each satellite's sub-satellite point at t=toe is placed at the receiver
    lat/lon plus an offset, by inverting the circular-orbit geometry
    (inclination 55 deg: geocentric lat = asin(sin i sin u),
    ECEF lon = node_lon + atan2(cos i sin u, cos u)).

    Simulator fixture only — gives 6-10 usable satellites with realistic
    MEO dynamics for position/TTFF system tests."""
    if offsets_deg is None:
        offsets_deg = [(0.0, 0.0), (40.0, 15.0), (-35.0, 20.0), (15.0, 55.0),
                       (-20.0, -50.0), (45.0, -25.0), (-45.0, -15.0),
                       (5.0, -60.0), (30.0, 40.0), (-10.0, 62.0)]
    inc = np.radians(55.0)
    toe = round(toe / 16.0) * 16.0   # toe/toc LNAV LSB is 2^4 s — a
    #                                  non-representable toe decodes 8 s off
    #                                  and wrecks the recovered orbit
    out = []
    for k, (dlat, dlon) in enumerate(offsets_deg):
        lat_t = np.radians(np.clip(rx_lat_deg + dlat, -54.0, 54.0))
        lon_t = np.radians(rx_lon_deg + dlon)
        u = np.arcsin(np.clip(np.sin(lat_t) / np.sin(inc), -1.0, 1.0))
        if k % 2:  # alternate ascending/descending passes for geometry
            u = np.pi - u
        node_lon = lon_t - np.arctan2(np.cos(inc) * np.sin(u), np.cos(u))
        omega0 = node_lon + constants.GPS_OMEGA_EARTH_DOT * toe
        omega0 = (omega0 + np.pi) % (2 * np.pi) - np.pi
        out.append(GpsEphemeris(
            prn=k + 1, week=week, toc=toe, toe=toe,
            af0=(k - 4) * 2e-5, af1=(k - 4) * 1e-12, af2=0.0,
            iodc=21, iode=21,
            sqrt_a=np.sqrt(26_559_710.0),
            ecc=0.003 + 0.0005 * k,
            m0_sc=float(u) / _PI,      # e small: M ~= u with omega = 0
            delta_n_sc=1.2e-9,
            omega_sc=0.0,
            omega0_sc=float(omega0) / _PI,
            omega_dot_sc=-2.5e-9,
            i0_sc=55.0 / 180.0,
            idot_sc=8e-11,
            cuc=1.5e-6, cus=6e-6, crc=180.0, crs=25.0,
            cic=8e-8, cis=-9e-8,
        ))
    return out


def adj_gps_week(week: int, pre_2009_file: bool = False,
                 now_week: int | None = None) -> int:
    """Resolve the LNAV 10-bit week ambiguity (rtklib_rtkcmn.cc:2117
    adjgpsweek, driven by GNSS-SDR.pre_2009_file,
    control_thread.cc:161): full weeks pass through; pre-2009 captures
    add one 1024-week rollover; otherwise align to the current (or
    supplied) receiver week."""
    week = int(week)
    if week > 1023:
        return week
    if pre_2009_file:
        return week + 1024
    if now_week is None:
        import time as _time
        # days since the GPS epoch 1980-01-06
        now_week = int((_time.time() - 315964800.0) // 604800)
    now_week = max(now_week, 1560)       # not earlier than 2009-12-01
    return week + (now_week - week + 512) // 1024 * 1024
