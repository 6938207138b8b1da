"""Geometry-level scenario -> per-satellite signal parameters.

The role bladeGPS/gnss-sim play for the reference's system tests
(src/tests/system-tests/position_test.cc spawns gnss-sim): given a receiver
position and a broadcast-ephemeris constellation, compute each satellite's
time-varying signal delay and Doppler and emit SatelliteSignalParams (+ LNAV
bit streams) for the signal synthesizer.

Timing model (matches sim.signal_generator):
  sample 0 of the capture <-> GPS time t_gps0 (must be a multiple of 6 s so
  LNAV subframe boundaries land on TOW multiples);
  signal transmit-time tau(t) = t - delay(t) with
  delay(t) = range(t)/c - dt_sv(t); tau indexes both the spreading code and
  the LNAV bit stream whose first subframe starts at TOW = t_gps0.

GPS L1 C/A, GPS L5 and Galileo E1-B copy of
``gnss_sim_receiver_tpu.sim.scenario`` for the PyTorch port.
The quadratic fit of delay(t) over the scenario duration keeps residuals
sub-millimeter for <= 60 s static scenarios (MEO range acceleration
< 1 m/s^2 changes by < 1e-3 m/s^2).
"""

from __future__ import annotations

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.nav import cnav, inav, lnav
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams
from gnss_sim_receiver_tpu_torch.utils import geodesy

C = constants.SPEED_OF_LIGHT_M_S


def _light_time_delay(eph, rx_ecef, t_gps_rx):
    """delay(t) = range/c - dt_sv solved by light-time iteration, with
    Sagnac (ECEF frame rotation during propagation)."""
    tau = 0.07
    for _ in range(4):
        t_tx = t_gps_rx - tau
        pos, clk = eph.sat_pos_clock(t_tx)
        ang = constants.GPS_OMEGA_EARTH_DOT * tau
        rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                        [-np.sin(ang), np.cos(ang), 0.0],
                        [0.0, 0.0, 1.0]])
        r = np.linalg.norm(rot @ pos - rx_ecef)
        tau = r / C
    return tau - clk


def visible_satellites(ephemerides, rx_ecef, t_gps_s,
                       elevation_mask_deg: float = 5.0):
    """PRNs above the elevation mask (the role of the flowgraph's
    priorize_satellites / get_visible_sats)."""
    out = []
    for eph in ephemerides:
        pos, _ = eph.sat_pos_clock(t_gps_s)
        el, _ = geodesy.elevation_azimuth(rx_ecef, pos)
        if np.degrees(el) >= elevation_mask_deg:
            out.append(eph.prn)
    return out


def build_static_scenario(ephemerides, rx_ecef, t_gps0: float,
                          duration_s: float, cn0_db_hz: float = 47.0,
                          elevation_mask_deg: float = 5.0,
                          n_frames: int | None = None,
                          subframe_cycle=(1, 2, 3, 4, 5),
                          band: str = "L1"
                          ) -> list[SatelliteSignalParams]:
    """SatelliteSignalParams for every visible satellite of a static
    receiver.  t_gps0 must be a multiple of 6 (LNAV subframe grid; also a
    multiple of the 2 s INAV page grid, so Galileo ephemerides — marked by
    eph.system — get an E1B signal whose INAV page stream starts at
    t_gps0).  band="L5" gives the GPS satellites' L5I signals instead
    (CNAV at 50 bps, NH10-spread) and skips the others."""
    if t_gps0 % 6.0:
        raise ValueError("t_gps0 must be a multiple of 6 s (subframe grid)")
    rx_ecef = np.asarray(rx_ecef, dtype=np.float64)
    if n_frames is None:
        n_frames = int(np.ceil((duration_s + 60.0)
                               / (6.0 * len(subframe_cycle))))
    sats = []
    ts = np.array([0.0, duration_s / 2.0, duration_s])
    for eph in ephemerides:
        pos, _ = eph.sat_pos_clock(t_gps0)
        el, _ = geodesy.elevation_azimuth(rx_ecef, pos)
        if np.degrees(el) < elevation_mask_deg:
            continue
        d = np.array([_light_time_delay(eph, rx_ecef, t_gps0 + t)
                      for t in ts])
        # quadratic fit d(t) = d0 + d1 t + d2 t^2/2 through the 3 samples
        d0 = d[0]
        d2 = (d[2] - 2.0 * d[1] + d[0]) / (duration_s / 2.0) ** 2
        d1 = (d[2] - d[0]) / duration_s - d2 * duration_s / 2.0
        f_c = constants.GPS_L1_FREQ_HZ   # == Galileo E1 carrier
        code_dop = None
        carrier_ref = None
        if band == "L5":
            # GPS L5 stream of the SAME constellation (dual-band front
            # end): geometry identical, Doppler/phase on the L5 carrier,
            # CNAV@50bps x NH10 per-epoch signs
            if eph.system != "GPS":
                continue
            f_c = constants.GPS_L5_FREQ_HZ
            n_rep = int(np.ceil((duration_s + 24.0) / 18.0))
            sym = cnav.symbols_for_ephemeris(eph, t_gps0,
                                             n_repeats=n_rep, bps=50.0)
            system, signal = "GPS", "L5"
            nav_bits = cnav.l5i_epoch_signs(sym)   # already +-1 per epoch
            code_dop = -f_c * d1
            carrier_ref = f_c
        elif eph.system == "Galileo":
            n_rep = int(np.ceil((duration_s + 12.0)
                                / (5 * inav.PAGE_SECONDS)))
            stream = inav.pages_for_ephemeris(eph, t0_gst_s=t_gps0,
                                              n_repeats=n_rep)
            system, signal = "Galileo", "1B"
            nav_bits = (2 * stream - 1).astype(np.int8)
        else:
            stream = lnav.frames_for_ephemeris(
                eph, t_gps0, n_frames=n_frames,
                subframe_cycle=subframe_cycle)
            system, signal = "GPS", "1C"
            nav_bits = (2 * stream - 1).astype(np.int8)
        sats.append(SatelliteSignalParams(
            prn=eph.prn, system=system, signal=signal,
            cn0_db_hz=cn0_db_hz,
            doppler_hz=-f_c * d1, doppler_rate_hz_s=-f_c * d2,
            delay_sec=d0, delay_chips=0.0,
            # geometric carrier phase at t=0: the received phase is
            # -2*pi*f_c*delay(t); without the constant term the simulated
            # carrier has a per-satellite-per-receiver phase offset that
            # makes double-difference ambiguities non-integer (RTK)
            carrier_phase_rad=float(np.mod(-2.0 * np.pi * f_c * d0,
                                           2.0 * np.pi)),
            code_doppler_hz=code_dop, carrier_ref_hz=carrier_ref,
            nav_bits=nav_bits))
    return sats
