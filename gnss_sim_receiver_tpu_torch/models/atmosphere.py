"""Atmospheric delay models for single-point PVT.

Equivalents of the reference's pntpos corrections
(src/algorithms/libs/rtklib/rtklib_pntpos.cc: ionocorr -> Klobuchar
broadcast model, tropcorr -> Saastamoinen), selected by the same config
strings (PVT.iono_model=Broadcast / OFF, PVT.trop_model=Saastamoinen /
OFF).

Copy of ``gnss_sim_receiver_tpu.models.atmosphere`` for the PyTorch port.
"""

from __future__ import annotations

import numpy as np

from gnss_sim_receiver_tpu_torch import constants


def klobuchar_delay(alpha, beta, lat_rad, lon_rad, el_rad, az_rad,
                    gps_tow_s) -> float:
    """Klobuchar broadcast ionospheric delay on L1 [m]
    (IS-GPS-200 20.3.3.5.2.5; rtklib ionmodel)."""
    psi = 0.0137 / (el_rad / np.pi + 0.11) - 0.022          # semicircles
    phi_i = lat_rad / np.pi + psi * np.cos(az_rad)
    phi_i = np.clip(phi_i, -0.416, 0.416)
    lam_i = lon_rad / np.pi + psi * np.sin(az_rad) / np.cos(phi_i * np.pi)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)
    t = 43200.0 * lam_i + gps_tow_s
    t = t % 86400.0
    f = 1.0 + 16.0 * (0.53 - el_rad / np.pi) ** 3
    amp = alpha[0] + phi_m * (alpha[1] + phi_m * (alpha[2]
                                                  + phi_m * alpha[3]))
    per = beta[0] + phi_m * (beta[1] + phi_m * (beta[2] + phi_m * beta[3]))
    amp = max(amp, 0.0)
    per = max(per, 72000.0)
    x = 2.0 * np.pi * (t - 50400.0) / per
    if abs(x) < 1.57:
        delay = f * (5e-9 + amp * (1.0 - x * x / 2.0 + x ** 4 / 24.0))
    else:
        delay = f * 5e-9
    return float(delay * constants.SPEED_OF_LIGHT_M_S)


def saastamoinen_delay(lat_rad, h_m, el_rad, humidity: float = 0.7) -> float:
    """Saastamoinen tropospheric delay [m] (rtklib tropmodel): standard
    atmosphere pressure/temperature from height."""
    h = max(min(h_m, 11_000.0), 0.0)
    pres = 1013.25 * (1.0 - 2.2557e-5 * h) ** 5.2568
    temp = 15.0 - 6.5e-3 * h + 273.16
    e = 6.108 * humidity * np.exp((17.15 * temp - 4684.0) / (temp - 38.45))
    z = np.pi / 2.0 - el_rad
    trph = (0.0022768 * pres
            / (1.0 - 0.00266 * np.cos(2.0 * lat_rad) - 0.00028 * h / 1e3)
            / np.cos(z))
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / np.cos(z)
    return float(trph + trpw)
