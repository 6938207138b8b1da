"""PVT Kalman filter: constant-velocity smoothing of LS fixes.

Equivalent of the reference Pvt_Kf (src/algorithms/PVT/libs/pvt_kf.cc,
133 LoC): an 6-state (pos, vel) Kalman filter fed by the single-point LS
position/velocity, enabled by PVT.enable_pvt_kf with the same noise
configuration keys.

Copy of ``gnss_sim_receiver_tpu.models.pvt_kf`` for the PyTorch port."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PvtKfConf:
    measures_ecef_pos_sd_m: float = 1.0
    measures_ecef_vel_sd_ms: float = 0.1
    system_ecef_pos_sd_m: float = 0.01
    system_ecef_vel_sd_ms: float = 0.001


class PvtKf:
    def __init__(self, conf: PvtKfConf = PvtKfConf()):
        self.conf = conf
        self.x = None            # [6] pos+vel
        self.p = None
        self.t_last = None

    def reset(self) -> None:
        self.x = None
        self.p = None
        self.t_last = None

    def update(self, sol) -> None:
        """Filter a PvtSolution in place (pos/vel smoothed)."""
        z = np.concatenate([sol.rx_ecef_m, sol.rx_vel_ecef_ms])
        t = sol.rx_time_corrected_s
        c = self.conf
        r = np.diag([c.measures_ecef_pos_sd_m ** 2] * 3
                    + [c.measures_ecef_vel_sd_ms ** 2] * 3)
        if self.x is None:
            self.x = z.copy()
            self.p = r * 10.0
            self.t_last = t
            return
        dt = max(t - self.t_last, 1e-3)
        self.t_last = t
        f = np.eye(6)
        f[0:3, 3:6] = np.eye(3) * dt
        q = np.diag([c.system_ecef_pos_sd_m ** 2] * 3
                    + [c.system_ecef_vel_sd_ms ** 2] * 3)
        xp = f @ self.x
        pp = f @ self.p @ f.T + q
        k = pp @ np.linalg.inv(pp + r)
        self.x = xp + k @ (z - xp)
        self.p = (np.eye(6) - k) @ pp
        sol.rx_ecef_m = self.x[:3].copy()
        sol.rx_vel_ecef_ms = self.x[3:].copy()
