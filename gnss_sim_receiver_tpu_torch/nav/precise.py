"""Precise-product readers for PPP: SP3 orbits/clocks, clock RINEX,
IONEX TEC grids, and solid-earth tide displacement.

Role parity (behavior, not code) with the reference's rtklib precise
modules:

- SP3-c orbit/clock files and polynomial interpolation:
  rtklib_preceph.cc:434 (src/algorithms/libs/rtklib/)
  (``peph2pos``: NMAX=10 centered polynomial interpolation for position,
  linear interpolation for the clock) and ``readsp3`` (:1 header /
  ``*`` epoch / ``P`` record parsing; positions km, clocks microseconds,
  999999.999999 = no clock).
- Clock RINEX ``AS`` records: rtklib_preceph.cc ``readrnxc`` role.
- IONEX VTEC grids with bilinear space + linear time interpolation and
  the single-layer slant mapping:
  rtklib_ionex.cc (``iontec``,
  ``interptec``, ``ionmapf``).
- Degree-2 solid-earth tide displacement driven by low-precision
  analytic Sun/Moon positions:
  rtklib_tides.cc:40
  (``tidedisp`` -> ``tide_solid`` -> ``tide_pl``) and
  rtklib_sbas/rtkcmn ``sunmoonpos_eci``.

These run on the host at PVT cadence (a few Hz), pure NumPy float64, as
in the JAX package: the card's time belongs to tracking.  Copy of
``gnss_sim_receiver_tpu.nav.precise`` for the PyTorch port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants

C = constants.SPEED_OF_LIGHT_M_S
GM_EARTH = constants.GPS_GM
GM_SUN = 1.32712440018e20       # [m^3/s^2]
GM_MOON = 4.902800066e12        # [m^3/s^2]
RE_M = 6378137.0
SECONDS_WEEK = 604800.0
# GPS epoch 1980-01-06 00:00 as Julian Date
JD_GPS_EPOCH = 2444244.5
JD_J2000 = 2451545.0


def _gps_calendar_to_tow(year, month, day, hour, minute, sec):
    """Calendar (GPS time scale) -> (gps_week, tow_s).  Integer
    Fliegel-Van Flandern day count so sub-ns time survives the round
    trip (rtklib epoch2time/time2gpst role); float JD arithmetic loses
    ~1e-5 s at J2000 which is cm of orbit."""
    a = (14 - month) // 12
    y = year + 4800 - a
    m = month + a * 12 - 3
    jdn = (day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100
           + y // 400 - 32045)
    days = jdn - 2444245            # JDN of 1980-01-06 (GPS epoch)
    week, dow = divmod(days, 7)
    tow = dow * 86400.0 + hour * 3600.0 + minute * 60.0 + sec
    return week, tow


def _tow_to_jd(week, tow_s):
    return JD_GPS_EPOCH + week * 7 + tow_s / 86400.0


# ---------------------------------------------------------------------------
# SP3 precise orbits + clocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Sp3Sat:
    """Interpolating view over one satellite's SP3 samples; quacks like
    nav.ephemeris.GpsEphemeris for PppEngine/PVT (``sat_pos_clock``)."""

    tow_s: np.ndarray       # [T] sample times (TOW, seconds)
    pos_m: np.ndarray       # [T,3]
    clk_s: np.ndarray       # [T] (NaN where absent)
    order: int = 10

    def sat_pos_clock(self, t_gps_s):
        t = float(t_gps_s)
        n = len(self.tow_s)
        k = int(np.searchsorted(self.tow_s, t))
        half = (self.order + 1) // 2
        i0 = max(0, min(k - half, n - (self.order + 1)))
        i1 = min(n, i0 + self.order + 1)
        ts = self.tow_s[i0:i1]
        # Neville's algorithm on each coordinate (rtklib interppol)
        dt = ts - t
        p = self.pos_m[i0:i1].copy()
        m = len(ts)
        for j in range(1, m):
            for i in range(m - j):
                denom = ts[i + j] - ts[i]
                p[i] = (dt[i + j] * p[i] - dt[i] * p[i + 1]) / denom
        pos = p[0]
        # clock: linear between the two bracketing finite samples
        clk = self._clock(t)
        return pos, clk

    def _clock(self, t):
        good = np.isfinite(self.clk_s)
        if not good.any():
            return 0.0
        ts = self.tow_s[good]
        cs = self.clk_s[good]
        if len(ts) == 1 or t <= ts[0]:
            return float(cs[0])
        if t >= ts[-1]:
            return float(cs[-1])
        k = int(np.searchsorted(ts, t))
        w = (t - ts[k - 1]) / (ts[k] - ts[k - 1])
        return float((1 - w) * cs[k - 1] + w * cs[k])


class Sp3Ephemeris:
    """Parsed SP3-c file: per-satellite precise positions + clocks.

    ``satellites()`` returns a dict keyed exactly like the broadcast
    ephemeris dicts fed to PppEngine/PVT (int PRN for GPS, ("SYS", prn)
    tuples otherwise) so precise products are a drop-in substitute.
    """

    SYS = {"G": "GPS", "E": "Galileo", "C": "BeiDou", "R": "GLONASS"}

    def __init__(self, text: str):
        self.samples = {}       # key -> (tow list, pos list, clk list)
        week = None
        tow = None
        for line in text.splitlines():
            if line.startswith("*"):
                f = line[1:].split()
                year, month, day, hh, mm = (int(x) for x in f[:5])
                week, tow = _gps_calendar_to_tow(
                    year, month, day, hh, mm, float(f[5]))
                if self.samples and week is not None:
                    pass
            elif line.startswith("P") and tow is not None:
                sysc = line[1]
                prn = int(line[2:4])
                sysname = self.SYS.get(sysc, "GPS")
                key = prn if sysname == "GPS" else (sysname, prn)
                x = float(line[4:18]) * 1e3
                y = float(line[18:32]) * 1e3
                z = float(line[32:46]) * 1e3
                c_us = float(line[46:60])
                clk = np.nan if c_us >= 999999.0 else c_us * 1e-6
                rec = self.samples.setdefault(key, ([], [], []))
                rec[0].append(week * SECONDS_WEEK + tow)
                rec[1].append((x, y, z))
                rec[2].append(clk)
        self.week = week

    def satellites(self, order: int = 10, clock_rinex=None):
        out = {}
        for key, (ts, ps, cs) in self.samples.items():
            tow = np.asarray(ts) - (self.week or 0) * SECONDS_WEEK
            clk = np.asarray(cs, np.float64)
            if clock_rinex is not None and key in clock_rinex:
                rts, rcs = clock_rinex[key]
                clk = np.interp(tow, rts, rcs)
            out[key] = _Sp3Sat(tow_s=tow, pos_m=np.asarray(ps),
                               clk_s=clk,
                               order=min(order, len(ts) - 1))
        return out


def write_sp3(path, week, tow_s, sat_pos_clk, agency="TPU"):
    """Write an SP3-c file.  ``sat_pos_clk``: {key: (pos_m[T,3],
    clk_s[T])} sampled at ``tow_s`` [T].  Inverse of Sp3Ephemeris for
    tests and the simulator."""
    tow_s = np.asarray(tow_s)
    nt = len(tow_s)
    keys = sorted(sat_pos_clk, key=str)
    lines = []
    days0 = week * 7 + tow_s[0] / 86400.0
    lines.append("#cP2000  1  1  0  0  0.00000000     %3d ORBIT IGS14 HLM"
                 " %s" % (nt, agency))
    step = tow_s[1] - tow_s[0] if nt > 1 else 900.0
    lines.append("## %4d %15.8f %14.8f %5d %15.13f"
                 % (week, tow_s[0], step, int(days0), 0.0))
    ids = []
    for k in keys:
        if isinstance(k, tuple):
            sysname, prn = k
            c = {v: s for s, v in Sp3Ephemeris.SYS.items()}[sysname]
        else:
            c, prn = "G", k
        ids.append("%s%02d" % (c, prn))
    lines.append("+  %3d   %s" % (len(ids), "".join(ids)))
    for it, t in enumerate(tow_s):
        # integer inverse Fliegel-Van Flandern (see _gps_calendar_to_tow)
        dayn, secs = divmod(float(t), 86400.0)
        jdn = int(dayn) + week * 7 + 2444245
        a = jdn + 32044
        b = (4 * a + 3) // 146097
        cq = a - 146097 * b // 4
        d = (4 * cq + 3) // 1461
        e = cq - 1461 * d // 4
        m = (5 * e + 2) // 153
        day = e - (153 * m + 2) // 5 + 1
        month = m + 3 - 12 * (m // 10)
        year = 100 * b + d - 4800 + m // 10
        hh = int(secs // 3600)
        mm = int((secs - hh * 3600) // 60)
        ss = secs - hh * 3600 - mm * 60
        lines.append("*  %4d %2d %2d %2d %2d %11.8f"
                     % (year, month, day, hh, mm, ss))
        for k, sid in zip(keys, ids):
            pos, clk = sat_pos_clk[k]
            p = np.asarray(pos)[it] / 1e3
            cval = np.asarray(clk)[it]
            c_us = 999999.999999 if not np.isfinite(cval) else cval * 1e6
            lines.append("P%s%14.6f%14.6f%14.6f%14.6f"
                         % (sid, p[0], p[1], p[2], c_us))
    lines.append("EOF")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def read_clock_rinex(text: str):
    """Minimal clock-RINEX reader: ``AS`` records -> {key: (tow[], clk_s[])}
    (rtklib_preceph.cc readrnxc role)."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("AS "):
            continue
        f = line.split()
        sid = f[1]
        sysname = Sp3Ephemeris.SYS.get(sid[0], "GPS")
        prn = int(sid[1:])
        key = prn if sysname == "GPS" else (sysname, prn)
        year, month, day, hh, mm = (int(x) for x in f[2:7])
        sec = float(f[7])
        _, tow = _gps_calendar_to_tow(year, month, day, hh, mm, sec)
        clk = float(f[9])
        rec = out.setdefault(key, ([], []))
        rec[0].append(tow)
        rec[1].append(clk)
    return {k: (np.asarray(t), np.asarray(c)) for k, (t, c) in out.items()}


# ---------------------------------------------------------------------------
# IONEX TEC grids
# ---------------------------------------------------------------------------

class IonexTecGrid:
    """IONEX VTEC maps: bilinear lat/lon + linear time interpolation and
    the single-layer slant factor (rtklib_ionex.cc iontec/interptec/
    ionmapf)."""

    def __init__(self, text: str):
        lines = text.splitlines()
        self.h_km = 450.0
        exp = -1
        i = 0
        lat1 = lat2 = dlat = lon1 = lon2 = dlon = None
        while i < len(lines):
            ln = lines[i]
            label = ln[60:].strip()
            if label == "HGT1 / HGT2 / DHGT":
                self.h_km = float(ln.split()[0])
            elif label == "LAT1 / LAT2 / DLAT":
                lat1, lat2, dlat = (float(x) for x in ln.split()[:3])
            elif label == "LON1 / LON2 / DLON":
                lon1, lon2, dlon = (float(x) for x in ln.split()[:3])
            elif label == "EXPONENT":
                exp = int(ln.split()[0])
            elif label == "END OF HEADER":
                i += 1
                break
            i += 1
        self.lats = np.arange(lat1, lat2 + dlat / 2, dlat)
        self.lons = np.arange(lon1, lon2 + dlon / 2, dlon)
        nlat, nlon = len(self.lats), len(self.lons)
        self.epoch_tow = []
        self.maps = []
        cur = None
        row = None
        vals = []
        while i < len(lines):
            ln = lines[i]
            label = ln[60:].strip()
            if label == "EPOCH OF CURRENT MAP":
                f = ln.split()
                _, tow = _gps_calendar_to_tow(*(int(x) for x in f[:5]),
                                              float(f[5]))
                cur = np.zeros((nlat, nlon))
                self.epoch_tow.append(tow)
            elif label == "LAT/LON1/LON2/DLON/H":
                if row is not None:
                    cur[row, :] = vals[:nlon]
                lat = float(ln[2:8])
                row = int(round((lat - lat1) / dlat))
                vals = []
            elif label == "END OF TEC MAP":
                if row is not None:
                    cur[row, :] = vals[:nlon]
                    row = None
                self.maps.append(cur * (10.0 ** exp))
                cur = None
            elif cur is not None and row is not None and label == "":
                vals.extend(float(ln[k:k + 5]) for k in range(0, len(ln.rstrip()), 5))
            i += 1
        self.epoch_tow = np.asarray(self.epoch_tow)

    def vtec(self, tow_s, lat_deg, lon_deg):
        """Vertical TEC [TECU] at ionospheric pierce point."""
        t = float(tow_s)
        et = self.epoch_tow
        if len(et) == 1 or t <= et[0]:
            m0 = m1 = self.maps[0]
            w = 0.0
        elif t >= et[-1]:
            m0 = m1 = self.maps[-1]
            w = 0.0
        else:
            k = int(np.searchsorted(et, t))
            m0, m1 = self.maps[k - 1], self.maps[k]
            w = (t - et[k - 1]) / (et[k] - et[k - 1])

        def bilin(m):
            la = np.clip((lat_deg - self.lats[0])
                         / (self.lats[1] - self.lats[0]), 0,
                         len(self.lats) - 1.001)
            lo = np.clip((lon_deg - self.lons[0])
                         / (self.lons[1] - self.lons[0]), 0,
                         len(self.lons) - 1.001)
            i0, j0 = int(la), int(lo)
            fa, fo = la - i0, lo - j0
            return ((1 - fa) * (1 - fo) * m[i0, j0]
                    + fa * (1 - fo) * m[i0 + 1, j0]
                    + (1 - fa) * fo * m[i0, j0 + 1]
                    + fa * fo * m[i0 + 1, j0 + 1])
        return (1 - w) * bilin(m0) + w * bilin(m1)

    def slant_delay_m(self, tow_s, lat_deg, lon_deg, elevation_rad,
                      freq_hz):
        """Slant ionospheric group delay [m] via the single-layer map
        (rtklib ionmapf): 1/cos(z'), sin z' = Re/(Re+H) cos(el)."""
        sinz = RE_M / (RE_M + self.h_km * 1e3) * np.cos(elevation_rad)
        mf = 1.0 / np.sqrt(max(1.0 - sinz * sinz, 1e-6))
        tec = self.vtec(tow_s, lat_deg, lon_deg)
        return 40.30e16 * tec / (freq_hz * freq_hz) * mf


# ---------------------------------------------------------------------------
# Solid-earth tides
# ---------------------------------------------------------------------------

def sun_moon_ecef(week, tow_s):
    """Low-precision analytic Sun and Moon ECEF positions [m]
    (rtklib rtkcmn.c sunmoonpos_eci role, Montenbruck & Gill ch. 3;
    ~0.1% accuracy -- plenty for the ~r^4/R^3-scaled tide term)."""
    jd = _tow_to_jd(week, tow_s)
    t = (jd - JD_J2000) / 36525.0
    d2r = np.pi / 180.0
    eps = 23.439291 * d2r
    # Sun
    ms = (357.5277233 + 35999.05034 * t) * d2r
    ls = (280.460 + 36000.770 * t + 1.914666471 * np.sin(ms)
          + 0.019994643 * np.sin(2 * ms)) * d2r
    rs = 1.495978707e11 * (1.000140612 - 0.016708617 * np.cos(ms)
                           - 0.000139589 * np.cos(2 * ms))
    sun_eci = rs * np.array([np.cos(ls),
                             np.cos(eps) * np.sin(ls),
                             np.sin(eps) * np.sin(ls)])
    # Moon
    lm = (218.32 + 481267.883 * t) * d2r
    pm = (134.9 + 477198.85 * t) * d2r
    fm = (93.3 + 483202.03 * t) * d2r
    dm = (297.85 + 445267.12 * t) * d2r
    lon = lm + (6.29 * np.sin(pm) - 1.27 * np.sin(pm - 2 * dm)
                + 0.66 * np.sin(2 * dm) + 0.21 * np.sin(2 * pm)
                - 0.19 * np.sin(ms) - 0.11 * np.sin(2 * fm)) * d2r
    lat = (5.13 * np.sin(fm) + 0.28 * np.sin(pm + fm)
           - 0.28 * np.sin(fm - pm) - 0.17 * np.sin(fm - 2 * dm)) * d2r
    hp = (0.9508 + 0.0518 * np.cos(pm) + 0.0095 * np.cos(pm - 2 * dm)
          + 0.0078 * np.cos(2 * dm) + 0.0028 * np.cos(2 * pm)) * d2r
    rm = RE_M / np.sin(hp)
    cl, sl = np.cos(lat), np.sin(lat)
    moon_eci = rm * np.array([
        cl * np.cos(lon),
        np.cos(eps) * cl * np.sin(lon) - np.sin(eps) * sl,
        np.sin(eps) * cl * np.sin(lon) + np.cos(eps) * sl])
    # ECI -> ECEF: rotate by GMST (polar motion ignored at tide accuracy)
    ut_days = jd - JD_J2000
    gmst = (280.46061837 + 360.98564736629 * ut_days) % 360.0 * d2r
    cg, sg = np.cos(gmst), np.sin(gmst)
    rot = np.array([[cg, sg, 0.0], [-sg, cg, 0.0], [0.0, 0.0, 1.0]])
    return rot @ sun_eci, rot @ moon_eci


def solid_earth_tide(week, tow_s, rx_ecef_m):
    """Degree-2 solid-earth tide displacement [m, ECEF] at the receiver
    (rtklib_tides.cc:40 tide_pl with h2=0.6078, l2=0.0847; degree-3 and
    the frequency-dependent K1 term are below the cm level and omitted)."""
    h2, l2 = 0.6078, 0.0847
    r = np.asarray(rx_ecef_m, np.float64)
    rn = np.linalg.norm(r)
    if rn < 1.0:
        return np.zeros(3)
    er = r / rn
    disp = np.zeros(3)
    for gm_b, body in zip((GM_SUN, GM_MOON), sun_moon_ecef(week, tow_s)):
        rb = np.linalg.norm(body)
        eb = body / rb
        k = gm_b / GM_EARTH * rn ** 4 / rb ** 3
        dotp = float(er @ eb)
        disp += k * (3.0 * l2 * dotp * eb
                     + (3.0 * (h2 / 2.0 - l2) * dotp * dotp
                        - h2 / 2.0) * er)
    return disp
