"""Geodetic conversions (WGS-84) — the subset of the reference's
geofunctions (src/algorithms/libs/geofunctions.cc) and rtklib_rtkcmn.cc
coordinate helpers that the PVT chain needs."""

from __future__ import annotations

import numpy as np

WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def llh_to_ecef(lat_rad: float, lon_rad: float, h_m: float) -> np.ndarray:
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    return np.array([(n + h_m) * cl * np.cos(lon_rad),
                     (n + h_m) * cl * np.sin(lon_rad),
                     (n * (1.0 - WGS84_E2) + h_m) * sl])


def ecef_to_llh(xyz) -> tuple[float, float, float]:
    x, y, z = float(xyz[0]), float(xyz[1]), float(xyz[2])
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(6):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    h = p / np.cos(lat) - n
    return float(lat), float(lon), float(h)


def ecef_to_enu_matrix(lat_rad: float, lon_rad: float) -> np.ndarray:
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    so, co = np.sin(lon_rad), np.cos(lon_rad)
    return np.array([[-so, co, 0.0],
                     [-sl * co, -sl * so, cl],
                     [cl * co, cl * so, sl]])


def ecef_to_enu(dx_ecef, ref_llh) -> np.ndarray:
    return ecef_to_enu_matrix(ref_llh[0], ref_llh[1]) @ np.asarray(dx_ecef)


def elevation_azimuth(rx_ecef, sat_ecef) -> tuple[float, float]:
    lat, lon, _ = ecef_to_llh(rx_ecef)
    enu = ecef_to_enu(np.asarray(sat_ecef) - np.asarray(rx_ecef), (lat, lon))
    horiz = np.hypot(enu[0], enu[1])
    return float(np.arctan2(enu[2], horiz)), float(np.arctan2(enu[0], enu[1]))


def antenna_elevation_azimuth(rx_ecef, sat_ecef, boresight_az_rad: float,
                              boresight_el_rad: float) -> tuple:
    """Satellite elevation/azimuth in the RECEIVER-ANTENNA frame (fork
    feature: rtklib_rtkcmn.cc satazel/enu2ant/mat_enu2ant with
    nav->rec_ant_dir from the ReceiverAntennaAttitude.* conf keys).

    With the default boresight (az=0, el=90 deg) this reduces exactly to
    the geographic elevation_azimuth; tilting the boresight turns the
    elevation mask into an antenna field-of-view mask (the fork's
    lunar/orbital receivers do not point their antennas up)."""
    lat, lon, _ = ecef_to_llh(rx_ecef)
    enu = ecef_to_enu(np.asarray(sat_ecef) - np.asarray(rx_ecef),
                      (lat, lon))
    n = np.linalg.norm(enu)
    if n > 0:
        enu = enu / n
    sa, ca = np.sin(boresight_az_rad), np.cos(boresight_az_rad)
    se, ce = np.sin(boresight_el_rad), np.cos(boresight_el_rad)
    # mat_enu2ant rows (col-major E in the reference):
    e_ant = np.array([
        se * ca * enu[0] + se * sa * enu[1] - ce * enu[2],
        -sa * enu[0] + ca * enu[1],
        ce * ca * enu[0] + ce * sa * enu[1] + se * enu[2]])
    az = 0.0 if (e_ant[0] ** 2 + e_ant[1] ** 2) < 1e-12 \
        else float(np.arctan2(e_ant[0], e_ant[1]))
    if az < 0.0:
        az += 2.0 * np.pi
    return float(np.arcsin(np.clip(e_ant[2], -1.0, 1.0))), az
