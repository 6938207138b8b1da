"""Celestial environment: body gravity + body-fixed <-> inertial frames.

Role of the fork's environment library
(reference src/algorithms/libs/environment/: celestial_body.cc, earth.cc,
moon.cc, frame.cc, time_system.cc), which the fork's orbital-dynamics PVT
EKF (pvt_ekf.cc) uses for two-body gravity in an inertial frame and
SPICE-based frame conversions (celestial_body.cc:97-133 point-mass
GetGravityAcceleration + sxform_c ECEF<->ECI).

SPICE is not available here by design; the frame models are closed-form:

- Earth: point-mass gravity (mu = 398600.4418e9 m^3/s^2, same constant
  class as the reference's gravity_constant_ in km^3/s^2) and an
  ECEF<->ECI conversion as a Z-rotation at the IAU-76 GMST rate.  This is
  the same Earth-rotation model the GNSS measurement chain already uses
  for the Sagnac correction (constants.GPS_OMEGA_EARTH_DOT), so receiver
  dynamics and measurement geometry stay mutually consistent — which is
  what matters for the EKF (an absolute-orientation offset is unobservable
  for a GNSS-only filter).
- Moon: point-mass gravity (mu = 4902.800066e9) and a uniform-rotation
  principal-axis frame (sidereal rate 2*pi / 27.321661 d) standing in for
  the SPICE MOON_PA frame of moon.cc:38-58.

Time: TT = GPS + 51.184 s (time_system.cc role).

Copy of ``gnss_sim_receiver_tpu.utils.environment`` for the PyTorch
port: host float64 NumPy, no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants

GPS_TO_TT_S = 51.184          # TT - GPS (19 s GPS->TAI + 32.184 s TAI->TT)


def gps_to_tt(t_gps_s: float) -> float:
    return t_gps_s + GPS_TO_TT_S


@dataclasses.dataclass(frozen=True)
class CelestialBody:
    """Point-mass body with a uniformly rotating body-fixed frame
    (celestial_body.{h,cc} role).  theta(t) = theta0 + rate * (t - t0)
    about +Z maps inertial -> body-fixed."""
    name: str
    mu_m3_s2: float
    rotation_rate_rad_s: float
    theta0_rad: float = 0.0
    t0_s: float = 0.0             # epoch (same timescale as callers use)

    def gravity_acceleration(self, pos_i_m: np.ndarray) -> np.ndarray:
        """Two-body gravity in the inertial frame
        (celestial_body.cc:97-110)."""
        r = np.linalg.norm(pos_i_m)
        return -self.mu_m3_s2 / r ** 3 * np.asarray(pos_i_m, np.float64)

    def gravity_jacobian(self, pos_i_m: np.ndarray) -> np.ndarray:
        """d(acc)/d(pos): mu * (3 rr^T / r^5 - I / r^3)
        (pvt_ekf.cc JacobiMatrix two-body terms)."""
        p = np.asarray(pos_i_m, np.float64)
        r = np.linalg.norm(p)
        return self.mu_m3_s2 * (3.0 * np.outer(p, p) / r ** 5
                                - np.eye(3) / r ** 3)

    def _theta(self, t_s: float) -> float:
        return self.theta0_rad + self.rotation_rate_rad_s * (t_s - self.t0_s)

    def dcm_i2fixed(self, t_s: float) -> np.ndarray:
        th = self._theta(t_s)
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])

    def state_i2fixed(self, x_i: np.ndarray, t_s: float) -> np.ndarray:
        """[pos, vel] inertial -> body-fixed, including the omega x r
        frame-rotation velocity term (the 6x6 sxform of
        celestial_body.cc:114-122)."""
        a = self.dcm_i2fixed(t_s)
        w = np.array([0.0, 0.0, self.rotation_rate_rad_s])
        pos = a @ x_i[:3]
        vel = a @ x_i[3:6] - np.cross(w, pos)
        return np.concatenate([pos, vel])

    def state_fixed2i(self, x_f: np.ndarray, t_s: float) -> np.ndarray:
        a = self.dcm_i2fixed(t_s).T
        w = np.array([0.0, 0.0, self.rotation_rate_rad_s])
        pos = a @ x_f[:3]
        vel = a @ (x_f[3:6] + np.cross(w, x_f[:3]))
        return np.concatenate([pos, vel])


# IAU-76 GMST rate == the broadcast-ephemeris Earth rotation rate used by
# the Sagnac/ECEF machinery; theta0 = 0 puts ECI == ECEF at t0, which is
# exact enough for a GNSS-only EKF (absolute RA offset is unobservable).
def earth(t0_gps_s: float = 0.0) -> CelestialBody:
    """Earth model (earth.{h,cc} role)."""
    return CelestialBody(name="Earth", mu_m3_s2=398600.4418e9,
                         rotation_rate_rad_s=constants.GPS_OMEGA_EARTH_DOT,
                         t0_s=t0_gps_s)


def moon(t0_gps_s: float = 0.0) -> CelestialBody:
    """Moon model with a uniformly rotating principal-axis frame standing
    in for SPICE MOON_PA (moon.{h,cc} role)."""
    sidereal_s = 27.321661 * 86400.0
    return CelestialBody(name="Moon", mu_m3_s2=4902.800066e9,
                         rotation_rate_rad_s=2.0 * np.pi / sidereal_s,
                         t0_s=t0_gps_s)
