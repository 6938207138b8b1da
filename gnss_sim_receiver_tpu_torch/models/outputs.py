"""PVT output writers: the RINEX 3.02 observation file, written and read.

The observation half of the reference's rinex_printer.cc
(src/algorithms/PVT/libs/), as functional writers over ObservationEpoch
streams: the RTK base stream travels as such a file
(PVT.rtk_base_rinex_obs).  Copy of those functions of
``gnss_sim_receiver_tpu.models.outputs`` for the PyTorch port (host
NumPy, no kernel); its NMEA, KML, GPX, GeoJSON, XML, RINEX navigation and
RINEX 2 writers are not ported yet.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

from gnss_sim_receiver_tpu_torch import constants

# GPS epoch (1980-01-06) for week/TOW -> UTC conversion (ignoring leap
# seconds unless provided, like the reference before UTC params arrive)
GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


def gps_time_to_utc(week: int, tow_s: float,
                    leap_s: float = 18.0) -> datetime.datetime:
    return GPS_EPOCH + datetime.timedelta(weeks=week,
                                          seconds=tow_s - leap_s)


# ---------------------------------------------------------------------------
# RINEX 3.02 (rinex_printer.cc — functional multi-GNSS subset)
# ---------------------------------------------------------------------------

def _band_code(system: str, freq_hz: float | None) -> str:
    """RINEX 3 band digit + attribute for a (system, carrier) pair —
    the observation-code mapping of rinex_printer.cc signalStrength /
    obs-type tables."""
    if freq_hz is None:
        return {"GPS": "1C", "Galileo": "1B", "GLONASS": "1C",
                "BeiDou": "2I", "SBAS": "1C"}.get(system, "1C")
    mhz = freq_hz / 1e6
    table = {
        "GPS": [(1575.42, "1C"), (1227.60, "2S"), (1176.45, "5I")],
        "Galileo": [(1575.42, "1B"), (1176.45, "5I"), (1207.14, "7I"),
                    (1278.75, "6B")],
        "GLONASS": [(1602.0, "1C"), (1246.0, "2C")],
        "BeiDou": [(1561.098, "2I"), (1268.52, "6I")],
        "SBAS": [(1575.42, "1C")],
    }.get(system, [(1575.42, "1C")])
    return min(table, key=lambda kv: abs(kv[0] - mhz))[1]


def write_rinex_obs(path, epochs, prns, week: int, *,
                    systems=None, carrier_freq_hz=None,
                    marker: str = "TPU0") -> None:
    """RINEX 3.02 multi-GNSS observation file: per-system observation
    types (C/L/D/S per band actually present), one satellite line per
    epoch with same-satellite multi-band channels merged onto one record
    (rinex_printer.cc log_rinex_obs multi-system path).  Carrier phase is
    negated into the RINEX sign convention (chain phase grows as
    -range/lambda)."""
    n = len(prns)
    systems = list(systems) if systems is not None else ["GPS"] * n
    freqs = (np.asarray(carrier_freq_hz, np.float64)
             if carrier_freq_hz is not None else [None] * n)
    bands = [_band_code(systems[c], None if freqs[c] is None
                        else float(freqs[c])) for c in range(n)]
    sys_letters = [_SYS_RINEX.get(systems[c], "G") for c in range(n)]
    # per-system ordered band list
    sys_bands: dict = {}
    for c in range(n):
        sys_bands.setdefault(sys_letters[c], [])
        if bands[c] not in sys_bands[sys_letters[c]]:
            sys_bands[sys_letters[c]].append(bands[c])
    lines = []
    ftype = ("G: GPS" if set(sys_letters) == {"G"} else "M: MIXED")
    lines.append(f"{'3.02':>9}{'':11}{'OBSERVATION DATA':<20}"
                 f"{ftype:<20}{'RINEX VERSION / TYPE'}")
    # the JAX package's program name, so that both packages write the same
    # bytes
    lines.append(f"{'gnss_sim_receiver_tpu':<20}{'':40}"
                 f"{'PGM / RUN BY / DATE'}")
    lines.append(f"{marker:<60}{'MARKER NAME'}")
    for letter in sorted(sys_bands):
        obs = " ".join(f"C{b} L{b} D{b} S{b}" for b in sys_bands[letter])
        n_obs = 4 * len(sys_bands[letter])
        lines.append(f"{letter:<1}{'':2}{n_obs:3d} {obs:<53}"
                     f"{'SYS / # / OBS TYPES'}")
    first = gps_time_to_utc(week, epochs[0].rx_time_s, 0.0)
    lines.append(f"{first.year:6d}{first.month:6d}{first.day:6d}"
                 f"{first.hour:6d}{first.minute:6d}{first.second:13.7f}"
                 f"{'GPS':>8}{'':9}{'TIME OF FIRST OBS'}")
    lines.append(f"{'':60}{'END OF HEADER'}")
    for ep in epochs:
        t = gps_time_to_utc(week, ep.rx_time_s, 0.0)
        # merge channels onto (system, prn) records
        recs: dict = {}
        for c in range(n):
            if not ep.valid[c]:
                continue
            recs.setdefault((sys_letters[c], int(prns[c])), {})[bands[c]] \
                = c
        if not recs:
            continue
        lines.append(f"> {t.year:4d} {t.month:02d} {t.day:02d} "
                     f"{t.hour:02d} {t.minute:02d}"
                     f"{t.second + t.microsecond / 1e6:11.7f}"
                     f"  0{len(recs):3d}")
        for (letter, prn) in sorted(recs):
            row = f"{letter}{prn:02d}"
            for b in sys_bands[letter]:
                c = recs[(letter, prn)].get(b)
                if c is None:
                    row += " " * 64
                    continue
                phase_cyc = -ep.carrier_phase_cycles[c]   # RINEX sign
                row += (f"{ep.pseudorange_m[c]:14.3f}  "
                        f"{phase_cyc:14.3f}  "
                        f"{ep.carrier_doppler_hz[c]:14.3f}  "
                        f"{ep.cn0_db_hz[c]:14.3f}  ")
            lines.append(row.rstrip() if row.strip() else row)
    Path(path).write_text("\n".join(lines) + "\n")


_RINEX_SYS = {"G": "GPS", "E": "Galileo", "R": "GLONASS", "C": "BeiDou",
              "S": "SBAS"}
_SYS_RINEX = {v: k for k, v in _RINEX_SYS.items()}


def read_rinex_obs(path):
    """Parse a RINEX observation file written by write_rinex_obs back into
    (epochs, prns, systems): a list of ObservationEpoch in a channel space
    with one channel per satellite seen in the file (the role of rtklib's
    readrnxobs feeding the base obs stream for relative positioning).

    The carrier phase is negated back to the chain's accumulated-PLL-phase
    convention (write_rinex_obs negates it for the RINEX sign convention),
    and interp_tow_ms is reconstructed from rx_time - pseudorange/c —
    the inverse of the observables engine's compute_pranges.
    """
    from gnss_sim_receiver_tpu_torch.models.observables import ObservationEpoch
    recs = []          # (rx_time_s, [(system, prn, pr, ph, dop, cn0)])
    cur = None
    with open(path) as fh:
        lines = fh.readlines()
    in_header = True
    for ln in lines:
        if in_header:
            if "END OF HEADER" in ln:
                in_header = False
            continue
        if ln.startswith(">"):
            p = ln[1:].split()
            y, mo, d, h, mi = (int(p[0]), int(p[1]), int(p[2]), int(p[3]),
                               int(p[4]))
            sec = float(p[5])
            t = datetime.datetime(y, mo, d, h, mi,
                                  tzinfo=datetime.timezone.utc) \
                + datetime.timedelta(seconds=sec)
            total_s = (t - GPS_EPOCH).total_seconds()
            rx_time_s = total_s % 604800.0
            cur = (rx_time_s, [])
            recs.append(cur)
        elif cur is not None and ln[:1] in _RINEX_SYS:
            sysname = _RINEX_SYS[ln[0]]
            prn = int(ln[1:3])
            # first non-blank band group (fixed 16-char fields, 64 chars
            # per C/L/D/S group); multi-band base files contribute their
            # first observed band per satellite
            body = ln[3:].rstrip("\n")
            group = None
            for g in range(max(1, (len(body) + 63) // 64)):
                seg = body[64 * g: 64 * (g + 1)]
                if seg.strip():
                    group = seg
                    break
            if group is None:
                continue
            vals = group.split()
            if len(vals) < 4:
                continue
            pr, ph, dop, cn0 = (float(vals[0]), float(vals[1]),
                                float(vals[2]), float(vals[3]))
            cur[1].append((sysname, prn, pr, -ph, dop, cn0))
    # channel space: one channel per satellite, order of first appearance
    chan = {}
    for _, obs in recs:
        for sysname, prn, *_ in obs:
            chan.setdefault((sysname, prn), len(chan))
    n = len(chan)
    epochs = []
    for rx_time_s, obs in recs:
        valid = np.zeros(n, bool)
        pr = np.zeros(n)
        tow = np.full(n, np.nan)
        dop = np.zeros(n)
        ph = np.zeros(n)
        cn0 = np.zeros(n)
        for sysname, prn, p, f, dd, c0 in obs:
            c = chan[(sysname, prn)]
            valid[c] = True
            pr[c] = p
            ph[c] = f
            dop[c] = dd
            cn0[c] = c0
            tow[c] = rx_time_s * 1000.0 - p / (constants.SPEED_OF_LIGHT_M_S
                                               / 1000.0)
        epochs.append(ObservationEpoch(
            rx_time_s=rx_time_s, tick_sample=0, valid=valid,
            pseudorange_m=pr, interp_tow_ms=tow, carrier_doppler_hz=dop,
            carrier_phase_cycles=ph, cn0_db_hz=cn0))
    keys = sorted(chan, key=chan.get)
    return epochs, [p for _, p in keys], [s for s, _ in keys]
