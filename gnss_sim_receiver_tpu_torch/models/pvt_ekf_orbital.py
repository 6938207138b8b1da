"""Orbital-dynamics PVT EKF (the fork's headline cislunar filter).

Role of the fork's Pvt_Ekf (reference src/algorithms/PVT/libs/
pvt_ekf.{h,cc}, run_Ekf at pvt_ekf.cc:61; hooked into the PVT adapter at
rtklib_pvt.cc:491-515): an 8-state extended Kalman filter

    x = [pos_i (3), c*clock_offset (m), vel_i (3), c*clock_drift (m/s)]

whose position/velocity live in an INERTIAL frame (ECI about Earth or MCI
about the Moon, pvt_ekf.h FrameType) and propagate under two-body
point-mass gravity — the dynamics of a spacecraft receiver in free fall,
which is what makes the filter able to coast through GNSS outages on a
cislunar trajectory.  Prediction integrates the state AND the state
transition matrix with RK4 (pvt_ekf.cc:348-385 predict); the Jacobian has
the classic mu*(3 rr^T/r^5 - I/r^3) gravity-gradient block
(pvt_ekf.cc:426-470 JacobiMatrix).  The measurement update ingests
pseudorange residuals and Doppler residuals (pvt_ekf.cc:587-710
get_observation, rescode + resdop roles) with the dR_dot/dr line-of-sight
rotation term.

The celestial environment (gravity constants, body-fixed <-> inertial
frames) comes from utils.environment — the SPICE-free equivalent of the
fork's environment library.

Differences by design: measurements come from the framework's
ObservationEpoch (not rtklib obsd_t); frames are closed-form uniform
rotations (see utils.environment docstring).

Copy of ``gnss_sim_receiver_tpu.models.pvt_ekf_orbital`` for the PyTorch
port: host float64 NumPy, no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.utils import environment

C = constants.SPEED_OF_LIGHT_M_S
OMEGA_E = constants.GPS_OMEGA_EARTH_DOT


@dataclasses.dataclass
class PvtEkfConf:
    """init_Ekf parameter set (pvt_ekf.cc:61-108) + frame selection."""
    frame: str = "ECI"                 # "ECI" | "MCI" (pvt_ekf.h FrameType)
    update_interval_s: float = 0.02
    initial_pos_sd_m: float = 100.0
    initial_vel_sd_ms: float = 10.0
    measures_pos_sd_m: float = 3.0
    measures_vel_sd_ms: float = 0.3
    system_pos_sd_m: float = 0.5
    system_vel_sd_ms: float = 0.05
    system_clock_offset_sd_m: float = 1.0
    system_clock_drift_sd_ms: float = 0.1
    # innovation gate (chi-square-ish, per-measurement sigma multiple)
    outlier_sigma: float = 8.0


class PvtEkfOrbital:
    """Sequential filter: init from a PvtSolution (or explicit ECEF
    state), then `update(epoch, prns, ephemerides)` per observable epoch;
    `propagate_to(t)` coasts through outages on dynamics alone."""

    def __init__(self, conf: PvtEkfConf = PvtEkfConf(),
                 t0_gps_s: float = 0.0):
        self.conf = conf
        self.body = (environment.moon(t0_gps_s) if conf.frame == "MCI"
                     else environment.earth(t0_gps_s))
        self.x = None                 # [8] inertial-frame state
        self.P = None
        self.t = None                 # GPS time of state validity [s]

    # -- init ---------------------------------------------------------------

    def init_from_fix(self, sol, t_gps_s: float) -> None:
        """Seed from a single-point LS fix (the adapter calls init_Ekf
        with the first rtklib solution, rtklib_pvt.cc:497-505)."""
        x_ecef = np.concatenate([sol.rx_ecef_m, sol.rx_vel_ecef_ms])
        self.init_ecef(x_ecef, C * sol.rx_clock_bias_s,
                       C * sol.rx_clock_drift_ss, t_gps_s)

    def init_ecef(self, pos_vel_ecef: np.ndarray, clk_m: float,
                  clk_drift_ms: float, t_gps_s: float) -> None:
        conf = self.conf
        xi = self.body.state_fixed2i(np.asarray(pos_vel_ecef, np.float64),
                                     t_gps_s)
        self.x = np.array([xi[0], xi[1], xi[2], clk_m,
                           xi[3], xi[4], xi[5], clk_drift_ms])
        self.P = np.zeros((8, 8))
        self.P[:3, :3] = conf.initial_pos_sd_m ** 2 * np.eye(3)
        self.P[3, 3] = conf.initial_pos_sd_m ** 2
        self.P[4:7, 4:7] = conf.initial_vel_sd_ms ** 2 * np.eye(3)
        self.P[7, 7] = conf.initial_vel_sd_ms ** 2
        self.t = float(t_gps_s)

    @property
    def initialized(self) -> bool:
        return self.x is not None

    # -- dynamics -----------------------------------------------------------

    def _deriv(self, x: np.ndarray) -> np.ndarray:
        """state_derivative (pvt_ekf.cc:387-424): free-fall two-body
        gravity; the clock block is NOT propagated through the dynamics
        (drift accuracy may be bad — reference comment)."""
        dx = np.zeros(8)
        dx[:3] = x[4:7]
        dx[4:7] = self.body.gravity_acceleration(x[:3])
        return dx

    def _jac(self, x: np.ndarray) -> np.ndarray:
        """JacobiMatrix (pvt_ekf.cc:426-470)."""
        f = np.zeros((8, 8))
        f[:3, 4:7] = np.eye(3)
        f[4:7, :3] = self.body.gravity_jacobian(x[:3])
        return f

    def propagate_to(self, t_gps_s: float, n_substeps: int | None = None
                     ) -> None:
        """RK4 of state + STM (predict, pvt_ekf.cc:348-385), then the
        covariance time update P = F P F^T + Q * dt/Ti."""
        dt_total = float(t_gps_s) - self.t
        if dt_total <= 0:
            return
        conf = self.conf
        n_sub = n_substeps or max(1, int(np.ceil(dt_total / 10.0)))
        h = dt_total / n_sub
        x = self.x.copy()
        phi = np.eye(8)
        for _ in range(n_sub):
            k1 = self._deriv(x)
            f1 = self._jac(x) @ phi
            k2 = self._deriv(x + 0.5 * h * k1)
            f2 = self._jac(x + 0.5 * h * k1) @ (phi + 0.5 * h * f1)
            k3 = self._deriv(x + 0.5 * h * k2)
            f3 = self._jac(x + 0.5 * h * k2) @ (phi + 0.5 * h * f2)
            k4 = self._deriv(x + h * k3)
            f4 = self._jac(x + h * k3) @ (phi + h * f3)
            x = x + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            phi = phi + h / 6.0 * (f1 + 2 * f2 + 2 * f3 + f4)
        # clock: offset integrates drift (the F(3,7)=Ti coupling the
        # reference folds into its discrete F)
        x[3] = self.x[3] + self.x[7] * dt_total
        phi[3, 7] = dt_total
        q = np.zeros((8, 8))
        q[:3, :3] = conf.system_pos_sd_m ** 2 * np.eye(3)
        q[3, 3] = conf.system_clock_offset_sd_m ** 2
        q[4:7, 4:7] = conf.system_vel_sd_ms ** 2 * np.eye(3)
        q[7, 7] = conf.system_clock_drift_sd_ms ** 2
        self.x = x
        self.P = phi @ self.P @ phi.T + q * (dt_total
                                             / conf.update_interval_s)
        self.P = 0.5 * (self.P + self.P.T)
        self.t = float(t_gps_s)

    # -- measurement update ---------------------------------------------------

    def update(self, obs, prns, ephemerides: dict, t_gps_s: float,
               systems=None, carrier_freq_hz=None) -> bool:
        """Propagate to t_gps_s, then update from one ObservationEpoch's
        pseudoranges + Dopplers (get_observation roles: rescode + resdop
        residuals, dR_dot/dr terms).  Returns True if the update ran."""
        if not self.initialized:
            return False
        self.propagate_to(t_gps_s)
        conf = self.conf
        prns = np.asarray(prns)
        systems = systems if systems is not None else ["GPS"] * len(prns)

        def _key(c):
            return (int(prns[c]) if systems[c] == "GPS"
                    else (systems[c], int(prns[c])))

        idx = [c for c in range(len(prns))
               if obs.valid[c] and _key(c) in ephemerides]
        if not idx:
            return False

        # predicted receiver state in ECEF (conv_states_i2ecef)
        xi = np.concatenate([self.x[:3], self.x[4:7]])
        xe = self.body.state_i2fixed(xi, self.t)
        rx, vx = xe[:3], xe[3:6]
        a_i2f = self.body.dcm_i2fixed(self.t)

        rows_h = []
        rows_z = []
        rows_r = []
        lam_all = (C / np.asarray(carrier_freq_hz, np.float64)
                   if carrier_freq_hz is not None
                   else np.full(len(prns), C / constants.GPS_L1_FREQ_HZ))
        for c in idx:
            eph = ephemerides[_key(c)]
            t_sv = obs.interp_tow_ms[c] / 1000.0
            _, clk = eph.sat_pos_clock(t_sv)
            pos, clk = eph.sat_pos_clock(t_sv - clk)
            vel = eph.sat_vel(t_sv - clk)
            tau = np.linalg.norm(pos - rx) / C
            ang = OMEGA_E * tau
            rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                            [-np.sin(ang), np.cos(ang), 0.0],
                            [0.0, 0.0, 1.0]])
            p = rot @ pos
            d = p - rx
            r = np.linalg.norm(d)
            los = d / r
            # pseudorange residual row: z - h(x) with h = r + clk_m - c dts
            z_pr = obs.pseudorange_m[c] - (r + self.x[3] - C * clk)
            h_pr = np.zeros(8)
            h_pr[:3] = -los @ a_i2f
            h_pr[3] = 1.0
            rows_h.append(h_pr)
            rows_z.append(z_pr)
            rows_r.append(conf.measures_pos_sd_m ** 2)
            # Doppler residual row (resdop + the dR_dot/dr term)
            lam = lam_all[c]
            rate_meas = -lam * obs.carrier_doppler_hz[c]
            rel_v = vel - vx
            z_dop = rate_meas - (los @ rel_v + self.x[7])
            h_dop = np.zeros(8)
            drdot_dr = -(rel_v - los * (los @ rel_v)) / r     # ECEF
            h_dop[:3] = drdot_dr @ a_i2f
            h_dop[4:7] = -los @ a_i2f
            h_dop[7] = 1.0
            rows_h.append(h_dop)
            rows_z.append(z_dop)
            rows_r.append(conf.measures_vel_sd_ms ** 2)

        H = np.asarray(rows_h)
        z = np.asarray(rows_z)
        Rd = np.asarray(rows_r)
        # innovation gating (outlier rejection)
        s_diag = np.einsum("ij,jk,ik->i", H, self.P, H) + Rd
        keep = np.abs(z) <= conf.outlier_sigma * np.sqrt(s_diag)
        if keep.sum() < 4:
            return False
        H, z, Rd = H[keep], z[keep], Rd[keep]
        S = H @ self.P @ H.T + np.diag(Rd)
        K = np.linalg.solve(S, H @ self.P).T
        self.x = self.x + K @ z
        self.P = (np.eye(8) - K @ H) @ self.P
        self.P = 0.5 * (self.P + self.P.T)
        return True

    # -- outputs --------------------------------------------------------------

    def state_ecef(self):
        """(pos_ecef [3], vel_ecef [3], clock_bias_s, clock_drift_ss) —
        get_states_Kf role (pvt_ekf.cc conv_states_i2ecef)."""
        xi = np.concatenate([self.x[:3], self.x[4:7]])
        xe = self.body.state_i2fixed(xi, self.t)
        return (xe[:3].copy(), xe[3:6].copy(),
                self.x[3] / C, self.x[7] / C)
