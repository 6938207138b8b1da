"""PVT: single-point least-squares position/velocity/time solver.

Host-side (float64) equivalent of the reference's pntpos path
(Rtklib_Solver::get_PVT -> rtkpos -> pntpos, src/algorithms/PVT/libs/
rtklib_solver.cc:905 + src/algorithms/libs/rtklib/rtklib_pntpos.cc):
iterated LS on code pseudoranges for (x, y, z, c*dt_r), Earth-rotation
(Sagnac) correction, SV clock + TGD correction, elevation mask, DOPs, and a
linear LS on Doppler for velocity + clock drift, with the broadcast
(Klobuchar) and Saastamoinen atmosphere models, SBAS fast, long-term and
iono-grid corrections and RAIM fault detection and exclusion.  The
simulator emits no iono or tropo delay, so the models stay OFF for its
fixtures unless a scenario plants the delays.

Copy of ``gnss_sim_receiver_tpu.models.pvt`` for the PyTorch port, single
point only (PVT.positioning_mode Single or Static).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.models.atmosphere import (klobuchar_delay,
                                                           saastamoinen_delay)
from gnss_sim_receiver_tpu_torch.nav.ephemeris import sat_states_batch
from gnss_sim_receiver_tpu_torch.utils import geodesy

C = constants.SPEED_OF_LIGHT_M_S
OMEGA_E = constants.GPS_OMEGA_EARTH_DOT


@dataclasses.dataclass
class PvtConf:
    # PVT.positioning_mode (rtklib_pvt.cc:125-170): the port runs the
    # single-point LS solver below only
    positioning_mode: str = "Single"
    elevation_mask_deg: float = 5.0
    max_gdop: float = 30.0
    apply_tgd: bool = True
    iono_model: str = "OFF"        # OFF | Broadcast (Klobuchar)
    trop_model: str = "OFF"        # OFF | Saastamoinen
    iono_alpha: tuple = (0.0, 0.0, 0.0, 0.0)
    iono_beta: tuple = (0.0, 0.0, 0.0, 0.0)
    # PVT.raim_fde (rtklib_pvt.cc -> rtklib raim_fde()): residual-driven
    # fault detection + exclusion; a satellite whose pseudorange residual
    # exceeds the threshold is excluded and the epoch re-solved
    raim_fde: bool = False
    raim_threshold_m: float = 30.0
    raim_max_exclusions: int = 2
    # receiver antenna attitude (fork feature, rtklib_pvt.cc:92-94 ->
    # rtklib satazel/enu2ant): the elevation mask is evaluated in the
    # ANTENNA frame whose boresight points (az, el); the default
    # (0, 90 deg) is exactly the geographic elevation
    antenna_attitude_fix: bool = True
    antenna_az_rad: float = 0.0
    antenna_el_rad: float = np.pi / 2.0


@dataclasses.dataclass
class PvtSolution:
    valid: bool
    rx_ecef_m: np.ndarray        # [3]
    rx_clock_bias_s: float
    rx_vel_ecef_ms: np.ndarray   # [3]
    rx_clock_drift_ss: float
    rx_time_corrected_s: float   # rx_time - clock bias
    gdop: float
    pdop: float
    hdop: float
    vdop: float
    n_sats: int
    residuals_m: np.ndarray
    used_channels: np.ndarray | None = None   # channel index per residual


def solve_pvt(obs, prns, ephemerides: dict, conf: PvtConf = PvtConf(),
              x0=None, systems=None, carrier_freq_hz=None,
              exclude_channels=(), fixed_clock_bias_s=None,
              sbas_corrections=None) -> PvtSolution:
    """Solve position/time (+velocity) from one ObservationEpoch.

    obs: models.observables.ObservationEpoch
    prns: [C] channel -> PRN mapping
    ephemerides: {prn: GpsEphemeris} for GPS; other constellations under
      (system, prn) keys
    systems: optional [C] channel -> constellation (default all "GPS");
      mixed-constellation epochs assume a common timescale (GGTO = 0, true
      for the simulator; broadcast GGTO is an extension hook)
    exclude_channels: channels never used in the solution (the hybrid
      pseudolite channel — its observable is a time-transfer product, not
      a navigation range; rtklib_pvt_gs.cc:2346 erases it from the map)
    fixed_clock_bias_s: hold the rx clock at this value and solve position
      only (3 unknowns) — the fork's rx-clock-propagation mode
      (enable_rx_clock_propagation, rtklib_pvt_gs.cc:2444).  Needs >= 3
      satellites.
    """
    prns = np.asarray(prns)
    if systems is None:
        systems = ["GPS"] * len(prns)

    def _key(c):
        return (int(prns[c]) if systems[c] == "GPS"
                else (systems[c], int(prns[c])))

    excl = set(exclude_channels)
    idx = [c for c in range(len(prns))
           if obs.valid[c] and c not in excl and _key(c) in ephemerides]
    bad = PvtSolution(False, np.zeros(3), 0.0, np.zeros(3), 0.0,
                      obs.rx_time_s, 0, 0, 0, 0, len(idx), np.array([]))
    min_sats = 3 if fixed_clock_bias_s is not None else 4
    if len(idx) < min_sats:
        return bad

    pr = obs.pseudorange_m[idx].copy()
    tow_tx_s = obs.interp_tow_ms[idx] / 1000.0
    ephs = [ephemerides[_key(c)] for c in idx]

    # satellite positions/clocks at transmit time (SV time -> GPS time
    # iteration via the SV clock polynomial, rtklib ephpos/ephclk) —
    # ONE broadcast evaluation for the whole epoch (nav.ephemeris
    # sat_states_batch)
    sat_pos, sat_clk, sat_vel = sat_states_batch(ephs, tow_tx_s)
    if conf.apply_tgd:
        # single-frequency group delay: dt_sv(L1) = dt_sv - T_GD
        # (IS-GPS-200 20.3.3.3.3.2; Galileo BGD is the same form)
        sat_clk = sat_clk - np.array([e.tgd for e in ephs])
    if sbas_corrections is not None:
        # SBAS fast + long-term corrections (DO-229 A.4.4.3/.7;
        # rtklib_sbas.cc sbssatcorr): PR += PRC, sat state += deltas
        for k in range(len(idx)):
            if systems[idx[k]] != "GPS":
                continue
            prn_k = int(prns[idx[k]])
            pr[k] += sbas_corrections.code_correction_m(prn_k)
            lt = sbas_corrections.sat_correction(prn_k)
            if lt is not None:
                sat_pos[k] = sat_pos[k] + lt[0]
                sat_clk[k] = sat_clk[k] + lt[1]

    # iterated LS for (x, y, z, c dtr) — or (x, y, z) with the clock held
    # at the propagated value
    x = np.zeros(4)
    if x0 is not None:
        x[:3] = x0
    clock_fixed = fixed_clock_bias_s is not None
    if clock_fixed:
        x[3] = C * fixed_clock_bias_s
    el_mask_applied = np.ones(len(idx), bool)
    atm = np.zeros(len(idx))
    atm_done = False
    for it in range(10):
        # Sagnac: rotate SV positions into the ECEF frame at reception
        # (vectorized over satellites)
        tau = np.maximum(np.linalg.norm(sat_pos - x[:3], axis=1) / C, 1e-3)
        ang = OMEGA_E * tau
        ca, sa = np.cos(ang), np.sin(ang)
        p = np.stack([ca * sat_pos[:, 0] + sa * sat_pos[:, 1],
                      -sa * sat_pos[:, 0] + ca * sat_pos[:, 1],
                      sat_pos[:, 2]], axis=1)
        d = p - x[:3]
        rng = np.linalg.norm(d, axis=1)
        h = np.concatenate([-d / rng[:, None],
                            np.ones((len(idx), 1))], axis=1)
        # atmospheric corrections once roughly converged (rtklib pntpos
        # ionocorr/tropcorr); the geometry moves < mm afterwards, so they
        # are computed once and reused by later iterations
        if it >= 3 and not atm_done and (conf.iono_model != "OFF"
                                         or conf.trop_model != "OFF"
                                         or sbas_corrections is not None):
            atm_done = True
            lat_i, lon_i, h_i = geodesy.ecef_to_llh(x[:3])
            for k in range(len(idx)):
                el, az = geodesy.elevation_azimuth(x[:3], sat_pos[k])
                el = max(el, np.radians(5.0))
                sbas_iono = None
                if sbas_corrections is not None:
                    # pierce point at 350 km (DO-229 A.4.4.10)
                    re, hi = 6378136.3, 350e3
                    psi = (np.pi / 2 - el
                           - np.arcsin(re / (re + hi) * np.cos(el)))
                    lat_ipp = np.arcsin(
                        np.sin(lat_i) * np.cos(psi)
                        + np.cos(lat_i) * np.sin(psi) * np.cos(az))
                    lon_ipp = lon_i + np.arcsin(
                        np.sin(psi) * np.sin(az) / np.cos(lat_ipp))
                    sbas_iono = sbas_corrections.iono_delay_m(
                        np.degrees(lat_ipp), np.degrees(lon_ipp), el)
                if sbas_iono is not None:
                    atm[k] += sbas_iono    # SBAS grid replaces Klobuchar
                elif conf.iono_model == "Broadcast":
                    atm[k] += klobuchar_delay(conf.iono_alpha,
                                              conf.iono_beta, lat_i, lon_i,
                                              el, az, tow_tx_s[k])
                if conf.trop_model == "Saastamoinen":
                    atm[k] += saastamoinen_delay(lat_i, h_i, el)
        resid = pr - (rng + x[3] - C * sat_clk + atm)
        sel = el_mask_applied
        if sel.sum() < min_sats:
            return bad
        if clock_fixed:
            dx3, *_ = np.linalg.lstsq(h[sel, :3], resid[sel], rcond=None)
            dx = np.concatenate([dx3, [0.0]])
        else:
            dx, *_ = np.linalg.lstsq(h[sel], resid[sel], rcond=None)
        x += dx
        if np.linalg.norm(dx[:3]) < 1e-4:
            break
        if it == 2:  # apply elevation mask once roughly converged
            # antenna-frame elevation (rtklib_pntpos.cc:469 satazel with
            # rec_ant_dir): the default boresight reduces to geographic el
            use_ant = (conf.antenna_attitude_fix
                       and (conf.antenna_az_rad != 0.0
                            or abs(conf.antenna_el_rad
                                   - np.pi / 2.0) > 1e-12))
            for k in range(len(idx)):
                if use_ant:
                    el, _ = geodesy.antenna_elevation_azimuth(
                        x[:3], sat_pos[k], conf.antenna_az_rad,
                        conf.antenna_el_rad)
                else:
                    el, _ = geodesy.elevation_azimuth(x[:3], sat_pos[k])
                el_mask_applied[k] = np.degrees(el) >= conf.elevation_mask_deg

    sel = el_mask_applied
    if sel.sum() < min_sats:
        return bad
    # DOPs from the geometry matrix in ENU
    lat, lon, _ = geodesy.ecef_to_llh(x[:3])
    hq = h[sel, :3] if clock_fixed else h[sel]
    q3 = np.linalg.inv(hq.T @ hq)
    q = np.zeros((4, 4))
    q[:q3.shape[0], :q3.shape[1]] = q3
    gdop = float(np.sqrt(np.trace(q)))
    if not np.isfinite(gdop) or gdop > conf.max_gdop:
        return bad
    e = geodesy.ecef_to_enu_matrix(lat, lon)
    q_enu = e @ q[:3, :3] @ e.T
    pdop = float(np.sqrt(np.trace(q[:3, :3])))
    hdop = float(np.sqrt(q_enu[0, 0] + q_enu[1, 1]))
    vdop = float(np.sqrt(q_enu[2, 2]))

    # velocity: LS on Doppler (rtklib estvel): predicted range rate,
    # per-channel carrier wavelength (L1/E1 default; L2/L5 chains differ)
    if carrier_freq_hz is None:
        lam = C / constants.GPS_L1_FREQ_HZ
    else:
        lam = C / np.asarray(carrier_freq_hz, np.float64)[idx]
    rate_meas = -lam * obs.carrier_doppler_hz[idx]
    dv = sat_pos - x[:3]
    los = dv / np.linalg.norm(dv, axis=1)[:, None]
    rhs = rate_meas - np.einsum("kj,kj->k", los, sat_vel)
    hv = np.concatenate([-los, np.ones((len(idx), 1))], axis=1)
    if clock_fixed:
        # clock held => drift is held too (0: the propagated-clock caller
        # carries drift from the last free fix); with the 3-satellite
        # minimum a 4-unknown solve would be underdetermined and lstsq
        # would return a meaningless minimum-norm drift that the clock
        # propagation loop then feeds back on itself.
        v3, *_ = np.linalg.lstsq(hv[sel, :3], rhs[sel], rcond=None)
        v = np.concatenate([v3, [0.0]])
    else:
        v, *_ = np.linalg.lstsq(hv[sel], rhs[sel], rcond=None)

    resid_final = resid[sel]
    return PvtSolution(
        valid=True, rx_ecef_m=x[:3].copy(), rx_clock_bias_s=x[3] / C,
        rx_vel_ecef_ms=v[:3].copy(), rx_clock_drift_ss=v[3] / C,
        rx_time_corrected_s=obs.rx_time_s - x[3] / C,
        gdop=gdop, pdop=pdop, hdop=hdop, vdop=vdop,
        n_sats=int(sel.sum()), residuals_m=resid_final,
        used_channels=np.asarray(idx)[sel])


def solve_pvt_raim(obs, prns, ephemerides: dict, conf: PvtConf,
                   **kw) -> PvtSolution:
    """RAIM fault detection and exclusion around solve_pvt (the
    PVT.raim_fde=true path of rtklib_pvt.cc -> rtklib.cc raim_fde): when
    the worst pseudorange residual exceeds conf.raim_threshold_m and
    redundancy allows, exclude that satellite's channel and re-solve;
    keep the exclusion only if it shrinks the worst residual."""
    excl = list(kw.pop("exclude_channels", ()))
    sol = solve_pvt(obs, prns, ephemerides, conf,
                    exclude_channels=tuple(excl), **kw)
    if not conf.raim_fde:
        return sol
    for _ in range(conf.raim_max_exclusions):
        if not sol.valid or sol.n_sats <= 5 \
                or sol.used_channels is None:
            break
        k = int(np.argmax(np.abs(sol.residuals_m)))
        worst = float(abs(sol.residuals_m[k]))
        if worst <= conf.raim_threshold_m:
            break
        trial = excl + [int(sol.used_channels[k])]
        sol2 = solve_pvt(obs, prns, ephemerides, conf,
                         exclude_channels=tuple(trial), **kw)
        if (sol2.valid
                and float(np.abs(sol2.residuals_m).max()) < worst):
            excl, sol = trial, sol2
        else:
            break
    return sol
