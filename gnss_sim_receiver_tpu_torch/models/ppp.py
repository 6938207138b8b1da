"""Precise Point Positioning: undifferenced code+carrier float filter.

The role of the reference's rtklib PPP path (rtklib_ppp.cc pppos:
PMODE_PPP_STATIC / PMODE_PPP_KINEMA routed from rtkpos,
rtklib_rtkpos.cc:2308-2320): a sequential filter over UNDIFFERENCED
pseudorange + carrier-phase observables estimating

    x = [rover ECEF (3), c*clock (m), float ambiguity per satellite]

    x = [rover ECEF (3), c*clock (m), zenith trop delay (m),
         float ambiguity per satellite]

Static mode pins the position states (no process noise); kinematic adds a
random-walk.  The carrier ambiguities stay float (rtklib's default PPP is
float too; PPP-AR needs network products out of scope here).

Dual-frequency: when the same satellite is tracked on two carriers
(multi-band front end), its measurements are combined into the
first-order-iono-free combination (rtklib_ppp.cc L_LC/P_LC roles):
    P_IF = (f1^2 P1 - f2^2 P2) / (f1^2 - f2^2)
with a single float ambiguity on the IF carrier.  Single-band satellites
fall back to their raw measurements.

Troposphere: a residual zenith delay state with a 1/sin(el) mapping
(rtklib_ppp.cc trop_model est-ZTD role); the hydrostatic a priori can be
removed upstream via the PVT Saastamoinen hook.

Sign convention: ObservationEpoch.carrier_phase_cycles is the chain's
accumulated PLL phase (~ -range/lambda); negated at ingestion exactly
like models.rtk (see that module's docstring).

Copy of ``gnss_sim_receiver_tpu.models.ppp`` for the PyTorch port: host
float64 NumPy, no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.utils import geodesy

C = constants.SPEED_OF_LIGHT_M_S
OMEGA_E = constants.GPS_OMEGA_EARTH_DOT


@dataclasses.dataclass
class PppConf:
    mode: str = "static"               # static | kinematic
    elevation_mask_deg: float = 10.0
    code_sigma_m: float = 1.0
    carrier_sigma_m: float = 0.005
    pos_process_noise_ms: float = 1.0  # kinematic random walk [m/sqrt(s)]
    clk_process_noise_m: float = 100.0   # per-epoch clock random walk
    amb_init_var: float = 1e4
    min_sats: int = 4
    # residual zenith tropospheric delay state (m): random walk +
    # initial variance (rtklib prcopt tropopt=TROPOPT_EST role)
    ztd_process_noise_m: float = 1e-4
    ztd_init_sigma_m: float = 0.3
    # precise-product corrections (rtklib_tides.cc tidedisp /
    # rtklib_ionex.cc iontec roles); tides need `week` at update()
    tide_correction: bool = False


@dataclasses.dataclass
class PppSolution:
    valid: bool
    rx_ecef_m: np.ndarray
    rx_clock_bias_s: float
    n_sats: int
    sigma_pos_m: float      # sqrt trace of the position covariance


class PppEngine:
    """Feed one ObservationEpoch per call (`update`); returns the running
    float solution.  State bookkeeping (ambiguity add/drop) mirrors
    models.rtk._ensure_states."""

    def __init__(self, conf: PppConf = PppConf()):
        self.conf = conf
        self.x = None
        self.P = None
        self.amb_keys: list = []

    def _ensure_states(self, keys, amb0):
        keep = [k for k in self.amb_keys if k in keys]
        idx_old = {k: i for i, k in enumerate(self.amb_keys)}
        all_keys = keep + [k for k in keys if k not in idx_old]
        n = 5 + len(all_keys)
        x = np.zeros(n)
        P = np.zeros((n, n))
        x[:5] = self.x[:5]
        P[:5, :5] = self.P[:5, :5]
        for i, k in enumerate(all_keys):
            if k in idx_old:
                j = 5 + idx_old[k]
                x[5 + i] = self.x[j]
                P[5 + i, :5] = self.P[j, :5]
                P[:5, 5 + i] = self.P[:5, j]
                for i2, k2 in enumerate(all_keys):
                    if k2 in idx_old:
                        P[5 + i, 5 + i2] = self.P[j, 5 + idx_old[k2]]
            else:
                x[5 + i] = amb0.get(k, 0.0)
                P[5 + i, 5 + i] = self.conf.amb_init_var
        self.x, self.P, self.amb_keys = x, P, all_keys

    def update(self, obs, prns, ephemerides, systems=None,
               carrier_freq_hz=None, x0=None, week=None,
               ionex=None) -> PppSolution:
        """`ephemerides` may be broadcast ephemeris objects OR the
        precise-orbit dict from nav.precise.Sp3Ephemeris.satellites()
        (same sat_pos_clock interface).  `ionex`: optional
        nav.precise.IonexTecGrid applied to single-band satellites
        (dual-band uses the iono-free combination instead).  `week` +
        conf.tide_correction enable solid-earth tide displacement."""
        conf = self.conf
        bad = PppSolution(False, np.zeros(3), 0.0, 0, float("inf"))
        prns = np.asarray(prns)
        n_ch = len(prns)
        systems = systems if systems is not None else ["GPS"] * n_ch
        lam_all = (C / np.asarray(carrier_freq_hz, np.float64)
                   if carrier_freq_hz is not None
                   else np.full(n_ch, C / constants.GPS_L1_FREQ_HZ))

        # first-call init: seed position from x0 (a single-point LS fix)
        if self.x is None:
            if x0 is None:
                return bad
            self.x = np.concatenate([np.asarray(x0, np.float64),
                                     [0.0, 0.0]])
            self.P = np.diag([100.0 ** 2] * 3
                             + [1e6 ** 2, conf.ztd_init_sigma_m ** 2])
            self.amb_keys = []
        if conf.mode == "kinematic":
            self.P[:3, :3] += np.eye(3) * conf.pos_process_noise_ms ** 2
        self.P[3, 3] += conf.clk_process_noise_m ** 2
        self.P[4, 4] += conf.ztd_process_noise_m ** 2

        rov = self.x[:3]
        # solid-earth tide station displacement (reference applies it to
        # the modeled station position, rtklib_ppp.cc ppp_res via
        # tidedisp): the filter estimates the tide-free mean position
        tide = np.zeros(3)
        if conf.tide_correction and week is not None:
            from gnss_sim_receiver_tpu_torch.nav import precise
            tows = obs.interp_tow_ms[np.asarray(obs.valid, bool)]
            if len(tows):
                tide = precise.solid_earth_tide(
                    week, float(tows[0]) / 1000.0, rov)
        lat0 = lon0 = None
        if ionex is not None:
            lat0, lon0, _ = geodesy.ecef_to_llh(rov)
        raw = {}
        for c in range(n_ch):
            if not obs.valid[c]:
                continue
            sysc = systems[c]
            key = (sysc, int(prns[c]))
            ekey = int(prns[c]) if sysc == "GPS" else key
            eph = ephemerides.get(ekey)
            if eph is None:
                continue
            t_sv = obs.interp_tow_ms[c] / 1000.0
            _, clk = eph.sat_pos_clock(t_sv)
            pos, clk = eph.sat_pos_clock(t_sv - clk)
            tau = np.linalg.norm(pos - rov) / C
            ang = OMEGA_E * tau
            rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                            [-np.sin(ang), np.cos(ang), 0.0],
                            [0.0, 0.0, 1.0]])
            p = rot @ pos
            el, az = geodesy.elevation_azimuth(rov, p)
            if np.degrees(el) < conf.elevation_mask_deg:
                continue
            lam = lam_all[c]
            code = obs.pseudorange_m[c] + C * clk       # clock-corrected
            carr = -lam * obs.carrier_phase_cycles[c] + C * clk
            if ionex is not None:
                # ionospheric pierce point (rtklib ionppp role) then
                # single-layer slant delay; group delays code, advances
                # carrier by the same amount
                re_h = 6378137.0 / (6378137.0 + ionex.h_km * 1e3)
                psi = np.pi / 2 - el - np.arcsin(re_h * np.cos(el))
                lat_i = np.arcsin(np.sin(lat0) * np.cos(psi)
                                  + np.cos(lat0) * np.sin(psi)
                                  * np.cos(az))
                lon_i = lon0 + np.arcsin(
                    np.sin(psi) * np.sin(az) / max(np.cos(lat_i), 1e-6))
                di = ionex.slant_delay_m(
                    t_sv, np.degrees(lat_i), np.degrees(lon_i), el,
                    C / lam)
                code -= di
                carr += di
            raw.setdefault(key, []).append((p, code, carr, lam, el))

        # dual-frequency: iono-free combination per satellite when two
        # carriers are present (rtklib_ppp.cc L_LC/P_LC); the ambiguity
        # state then rides on the IF "wavelength" (kept as the f1 lambda
        # scale for conditioning — it is float anyway)
        meas = {}
        for key, items in raw.items():
            if len(items) >= 2:
                items = sorted(items, key=lambda m: m[3])   # by lambda
                (p1, code1, carr1, lam1, el1) = items[0]
                (p2, code2, carr2, lam2, el2) = items[-1]
                f1 = C / lam1
                f2 = C / lam2
                a1 = f1 * f1 / (f1 * f1 - f2 * f2)
                a2 = -f2 * f2 / (f1 * f1 - f2 * f2)
                meas[key] = (p1, a1 * code1 + a2 * code2,
                             a1 * carr1 + a2 * carr2, lam1, el1, True)
            else:
                p, code, carr, lam, el = items[0]
                meas[key] = (p, code, carr, lam, el, False)
        if len(meas) < conf.min_sats:
            return bad

        amb0 = {k: (m[2] - m[1]) / m[3] for k, m in meas.items()}
        self._ensure_states(list(meas), amb0)
        amb_idx = {k: 5 + i for i, k in enumerate(self.amb_keys)}

        n_m = len(meas)
        n_x = len(self.x)
        H = np.zeros((2 * n_m, n_x))
        z = np.zeros(2 * n_m)
        Rd = np.zeros(2 * n_m)
        rov = self.x[:3]
        for i, (k, (p, code, carr, lam, el, is_if)) in \
                enumerate(meas.items()):
            d = (rov + tide) - p
            r = np.linalg.norm(d)
            e = d / r
            # residual zenith trop delay, 1/sin(el) mapping
            mf = 1.0 / max(np.sin(el), 0.05)
            # IF combination amplifies noise ~3x (GPS L1/L5)
            nf = 3.0 if is_if else 1.0
            # carrier row: carr = r + clk + mf*ztd + lam*N
            z[i] = carr - (r + self.x[3] + mf * self.x[4]
                           + lam * self.x[amb_idx[k]])
            H[i, :3] = e
            H[i, 3] = 1.0
            H[i, 4] = mf
            H[i, amb_idx[k]] = lam
            Rd[i] = (nf * conf.carrier_sigma_m) ** 2
            # code row
            z[n_m + i] = code - (r + self.x[3] + mf * self.x[4])
            H[n_m + i, :3] = e
            H[n_m + i, 3] = 1.0
            H[n_m + i, 4] = mf
            Rd[n_m + i] = (nf * conf.code_sigma_m) ** 2

        S = H @ self.P @ H.T + np.diag(Rd)
        K = np.linalg.solve(S, H @ self.P).T
        self.x = self.x + K @ z
        # Joseph-form update: (I-KH)P(I-KH)' + KRK' stays positive
        # semidefinite under roundoff where the short form (I-KH)P can
        # drive trace(P) negative (a sqrt warning downstream).
        IKH = np.eye(n_x) - K @ H
        self.P = IKH @ self.P @ IKH.T + K @ np.diag(Rd) @ K.T
        self.P = 0.5 * (self.P + self.P.T)
        return PppSolution(
            valid=True, rx_ecef_m=self.x[:3].copy(),
            rx_clock_bias_s=self.x[3] / C, n_sats=n_m,
            sigma_pos_m=float(np.sqrt(max(np.trace(self.P[:3, :3]), 0.0))))
