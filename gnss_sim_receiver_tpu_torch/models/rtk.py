"""RTK: double-differenced carrier-phase positioning with LAMBDA
integer-ambiguity resolution.

Host-side (float64) equivalent of the reference's RTK path
(src/algorithms/libs/rtklib/rtklib_rtkpos.cc: rtkpos -> relpos, ddres;
rtklib_lambda.cc: lambda/reduction/search).  The structure is redesigned
around the framework's ObservationEpoch records instead of rtklib's obsd_t:

  * ``RtkEngine`` — an EKF whose state is the rover position (static or
    kinematic random-walk) plus one double-difference carrier ambiguity per
    (system, PRN) against a per-system reference satellite (the
    highest-elevation one, like rtklib's refsat selection in ddres).
    rtklib carries *single*-difference ambiguities and differences them in
    the measurement model; carrying the DD states directly is equivalent
    for a fixed reference satellite and keeps the state minimal.
  * ``lambda_ils`` — the LAMBDA method: L^T D L factorization, integer
    decorrelation (Gauss transformations + sorted permutations) and a
    shrinking-ellipsoid Schnorr-Euchner search for the two best integer
    candidates, exactly the roles of rtklib_lambda.cc LD/reduction/search.
  * a ratio test (rtklib_rtkpos.cc resamb_LAMBDA) gates the fixed solution;
    the fixed baseline is the float solution conditioned on the fixed
    ambiguities (rtklib holdamb/fix update).

Measurements per epoch: DD carrier phase (cycles -> meters) and DD code
pseudorange on every common, valid satellite; the DD covariance accounts
for the shared reference satellite (off-diagonal var_ref terms).

Sign convention: ``ObservationEpoch.carrier_phase_cycles`` is the tracking
chain's ACCUMULATED PLL PHASE, which grows with +Doppler, i.e. as
-range/lambda (the RINEX writer negates it for the same reason,
models/outputs.py).  The engine negates it at ingestion so the carrier
measurement model sees the +range/lambda + N convention.

Attribution: the LAMBDA implementation (_ld_decomp/_gauss/_perm/
_reduction/_search) is derived from RTKLIB's rtklib_lambda.c
(T. Takasu, 2007-2013, BSD-2-Clause; embedded in the reference at
src/algorithms/libs/rtklib/rtklib_lambda.cc), which implements
P.J.G. Teunissen's LAMBDA method (J. Geodesy 70, 1995) per X.-W. Chang,
X. Yang, T. Zhou, "MLAMBDA: a modified LAMBDA method for integer
least-squares estimation", J. Geodesy 79 (2005).

Copy of ``gnss_sim_receiver_tpu.models.rtk`` for the PyTorch port: host
float64 NumPy, no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.utils import geodesy

C = constants.SPEED_OF_LIGHT_M_S
OMEGA_E = constants.GPS_OMEGA_EARTH_DOT


# ---------------------------------------------------------------------------
# LAMBDA (rtklib_lambda.cc)
# ---------------------------------------------------------------------------

def _ld_decomp(Q: np.ndarray):
    """Q = L^T diag(d) L with L unit lower-triangular (rtklib LD())."""
    n = Q.shape[0]
    A = np.array(Q, dtype=np.float64, copy=True)
    L = np.zeros((n, n))
    d = np.zeros(n)
    for i in range(n - 1, -1, -1):
        d[i] = A[i, i]
        if d[i] <= 0.0:
            raise np.linalg.LinAlgError("LD: Q not positive definite")
        L[i, : i + 1] = A[i, : i + 1] / np.sqrt(d[i])
        for j in range(i):
            A[j, : j + 1] -= L[i, : j + 1] * L[i, j]
        L[i, : i + 1] /= L[i, i]
    return L, d


def _gauss(L, Z, i, j):
    """Integer Gauss transformation: make |L[i,j]| <= 1/2 (rtklib gauss())."""
    mu = int(np.round(L[i, j]))
    if mu != 0:
        L[i:, j] -= mu * L[i:, i]
        Z[:, j] -= mu * Z[:, i]


def _perm(L, d, j, delta, Z):
    """Swap states j and j+1 in the factorization (rtklib perm())."""
    eta = d[j] / delta
    lam = d[j + 1] * L[j + 1, j] / delta
    d[j] = eta * d[j + 1]
    d[j + 1] = delta
    sub = np.array([[-L[j + 1, j], 1.0], [eta, lam]])
    L[j : j + 2, :j] = sub @ L[j : j + 2, :j]
    L[j + 1, j] = lam
    L[j + 2 :, [j, j + 1]] = L[j + 2 :, [j + 1, j]]
    Z[:, [j, j + 1]] = Z[:, [j + 1, j]]


def _reduction(L, d):
    """LAMBDA decorrelation (rtklib reduction()): returns integer Z with
    Qz = Z^T Q Z better conditioned; L, d updated in place for Qz."""
    n = len(d)
    Z = np.eye(n)
    j = n - 2
    k = n - 2
    while j >= 0:
        if j <= k:
            for i in range(j + 1, n):
                _gauss(L, Z, i, j)
        delta = d[j] + L[j + 1, j] ** 2 * d[j + 1]
        if delta + 1e-6 < d[j + 1]:
            _perm(L, d, j, delta, Z)
            k = j
            j = n - 2
        else:
            j -= 1
    return Z


def _search(L, d, zs, m: int = 2):
    """Schnorr-Euchner shrinking search for the m best integer vectors
    minimizing (z - zs)^T Qz^{-1} (z - zs) (rtklib search())."""
    n = len(d)
    LOOPMAX = 10000
    S = np.zeros((n, n))
    dist = np.zeros(n)
    zb = np.zeros(n)
    z = np.zeros(n)
    step = np.zeros(n)
    zn = np.zeros((m, n))
    s = np.full(m, np.inf)
    k = n - 1
    zb[k] = zs[k]
    z[k] = np.round(zb[k])
    y = zb[k] - z[k]
    step[k] = 1.0 if y >= 0 else -1.0
    nn = 0
    imax = 0
    maxdist = np.inf
    for _ in range(LOOPMAX):
        newdist = dist[k] + y * y / d[k]
        if newdist < maxdist:
            if k != 0:
                k -= 1
                dist[k] = newdist
                S[k, : k + 1] = (S[k + 1, : k + 1]
                                 + (z[k + 1] - zb[k + 1]) * L[k + 1, : k + 1])
                zb[k] = zs[k] + S[k, k]
                z[k] = np.round(zb[k])
                y = zb[k] - z[k]
                step[k] = 1.0 if y >= 0 else -1.0
            else:
                if nn < m:
                    if nn == 0 or newdist > s[imax]:
                        imax = nn
                    zn[nn] = z
                    s[nn] = newdist
                    nn += 1
                else:
                    if newdist < s[imax]:
                        zn[imax] = z
                        s[imax] = newdist
                        imax = int(np.argmax(s))
                    maxdist = s[imax]
                z[0] += step[0]
                y = zb[0] - z[0]
                step[0] = -step[0] - (1.0 if step[0] >= 0 else -1.0)
        else:
            if k == n - 1:
                break
            k += 1
            z[k] += step[k]
            y = zb[k] - z[k]
            step[k] = -step[k] - (1.0 if step[k] >= 0 else -1.0)
    order = np.argsort(s[:nn])
    return zn[order], s[order]


def lambda_ils(a_float: np.ndarray, Q: np.ndarray, m: int = 2):
    """Integer least-squares via LAMBDA (rtklib lambda_reduction + search).

    Returns (candidates [m, n] int, sq_norms [m]): the m best integer
    vectors by (a - z)^T Q^{-1} (a - z), best first.
    """
    a_float = np.asarray(a_float, np.float64)
    L, d = _ld_decomp(Q)
    Z = _reduction(L, d)
    zs = Z.T @ a_float
    zn, s = _search(L, d, zs, m=m)
    # back-transform: a = Z^{-T} z (Z integer unimodular)
    zinv_t = np.linalg.inv(Z.T)
    cands = np.array([zinv_t @ z for z in zn])
    return np.round(cands).astype(np.int64), s


# ---------------------------------------------------------------------------
# Base-station observables (two-receiver runs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BaseObservations:
    """Base-station observable stream for RTK: a list of ObservationEpoch
    in the base receiver's own channel space plus its channel -> satellite
    maps and the known base position.  Produced from a second Receiver run
    (`from_receiver_run`) or a RINEX obs file (models.outputs
    read_rinex_obs) — the role of rtklib's base `obsd_t` stream fed by a
    second file/RTCM input (rtklib_rtkpos.cc relpos rover/base halves)."""
    epochs: list                     # [ObservationEpoch]
    prns: list                       # [C_base] int
    systems: list                    # [C_base] str
    base_ecef_m: np.ndarray          # [3]

    def __post_init__(self):
        self._by_ms = {int(round(e.rx_time_s * 1000.0)): e
                       for e in self.epochs}

    @classmethod
    def from_receiver_run(cls, run, base_ecef_m):
        """Wrap a base Receiver run's observation epochs (the final
        channel->PRN map must cover the epochs used; static base)."""
        systems = (list(run.channel_systems) if run.channel_systems
                   else ["GPS"] * len(run.channel_prns))
        return cls(epochs=run.observation_epochs,
                   prns=list(run.channel_prns), systems=systems,
                   base_ecef_m=np.asarray(base_ecef_m, np.float64))

    def epoch_at(self, rx_time_s: float, tol_ms: float = 1.0):
        return self._by_ms.get(int(round(rx_time_s * 1000.0)))

    def aligned_to(self, rx_time_s: float, rover_prns, rover_systems):
        """Return the base epoch at rx_time_s re-indexed into the ROVER's
        channel space by (system, prn) — None if no base epoch matches.
        This is the obs-pairing step of rtklib's relpos (selsat)."""
        be = self.epoch_at(rx_time_s)
        if be is None:
            return None
        key2base = {}
        for i, (s, p) in enumerate(zip(self.systems, self.prns)):
            if p > 0 and be.valid[i]:
                key2base[(s, int(p))] = i
        n = len(rover_prns)
        from gnss_sim_receiver_tpu_torch.models.observables import ObservationEpoch
        valid = np.zeros(n, bool)
        pr = np.zeros(n)
        tow = np.full(n, np.nan)
        dop = np.zeros(n)
        ph = np.zeros(n)
        cn0 = np.zeros(n)
        for c in range(n):
            sysc = rover_systems[c] if rover_systems is not None else "GPS"
            j = key2base.get((sysc, int(rover_prns[c])))
            if j is None:
                continue
            valid[c] = True
            pr[c] = be.pseudorange_m[j]
            tow[c] = be.interp_tow_ms[j]
            dop[c] = be.carrier_doppler_hz[j]
            ph[c] = be.carrier_phase_cycles[j]
            cn0[c] = be.cn0_db_hz[j]
        if not valid.any():
            return None
        return ObservationEpoch(
            rx_time_s=be.rx_time_s, tick_sample=be.tick_sample,
            valid=valid, pseudorange_m=pr, interp_tow_ms=tow,
            carrier_doppler_hz=dop, carrier_phase_cycles=ph,
            cn0_db_hz=cn0)


# ---------------------------------------------------------------------------
# RTK engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RtkConf:
    """PVT.positioning_mode = RTK_* subset of rtklib's prcopt_t."""
    mode: str = "static"            # static | kinematic
    elevation_mask_deg: float = 10.0
    code_sigma_m: float = 0.5       # undifferenced code noise
    carrier_sigma_m: float = 0.003  # undifferenced carrier noise
    ratio_threshold: float = 3.0    # resamb_LAMBDA ratio test
    pos_process_noise_ms: float = 0.0   # kinematic random walk [m/sqrt(s)]
    min_sats: int = 4
    # DLL-settling down-weight (rtklib varerr's lock-count factor role):
    # a freshly tracked channel's pseudorange carries a decaying pull-in
    # transient (up to ~0.05 chips at 2 Msps); its code variance is
    # inflated by (code_settle_sigma_m * exp(-age/code_settle_tau_s))^2
    # for `age` seconds since the satellite first appeared in the
    # rover/base common set, so the float EKF does not bake the early
    # bias into its state
    code_settle_sigma_m: float = 5.0
    code_settle_tau_s: float = 1.0


@dataclasses.dataclass
class RtkSolution:
    valid: bool
    fixed: bool
    ratio: float
    baseline_m: np.ndarray          # rover - base, ECEF [3]
    rover_ecef_m: np.ndarray        # [3]
    float_baseline_m: np.ndarray    # [3]
    ambiguities: dict               # (system, prn) -> fixed DD integer
    n_dd: int


class _SatGeom:
    __slots__ = ("key", "pos", "el", "lam")

    def __init__(self, key, pos, el, lam):
        self.key, self.pos, self.el, self.lam = key, pos, el, lam


def _sat_geometry(obs, prns, systems, ephemerides, base_ecef, freq_hz,
                  el_mask_deg):
    """Satellite ECEF positions (Sagnac-rotated) + elevation at the base,
    for every valid channel with an ephemeris."""
    out = {}
    for c in range(len(prns)):
        if not obs.valid[c]:
            continue
        sysc = systems[c] if systems is not None else "GPS"
        key = (sysc, int(prns[c]))
        ekey = int(prns[c]) if sysc == "GPS" else key
        eph = ephemerides.get(ekey)
        if eph is None:
            continue
        t_sv = obs.interp_tow_ms[c] / 1000.0
        _, clk = eph.sat_pos_clock(t_sv)
        pos, _ = eph.sat_pos_clock(t_sv - clk)
        tau = np.linalg.norm(pos - base_ecef) / C
        ang = OMEGA_E * tau
        rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                        [-np.sin(ang), np.cos(ang), 0.0],
                        [0.0, 0.0, 1.0]])
        pos = rot @ pos
        el, _ = geodesy.elevation_azimuth(base_ecef, pos)
        if np.degrees(el) < el_mask_deg:
            continue
        lam = C / (freq_hz[c] if freq_hz is not None
                   else constants.GPS_L1_FREQ_HZ)
        out[key] = (c, _SatGeom(key, pos, el, lam))
    return out


class RtkEngine:
    """Relative positioning EKF (rtkpos/relpos analogue).

    State: rover ECEF (3) + one DD carrier ambiguity (cycles) per
    (system, prn) currently tracked against the per-system reference
    satellite.  Feed one synchronized (rover, base) ObservationEpoch pair
    per call; the base position is held fixed (known), as in rtklib's
    relative mode.
    """

    def __init__(self, conf: RtkConf, base_ecef_m):
        self.conf = conf
        self.base = np.asarray(base_ecef_m, np.float64)
        self.x = None               # [3 + n_amb]
        self.P = None
        self.amb_keys: list = []    # (system, prn) per ambiguity state
        self.refsat: dict = {}      # system -> (system, prn)
        self.first_seen: dict = {}  # (system, prn) -> rx time first common
        self.last_t = None

    # -- state bookkeeping --------------------------------------------------

    def _ensure_states(self, keys_by_sys, dd0):
        """Add ambiguity states for new DD pairs; drop vanished ones.
        New ambiguities initialize from carrier-minus-code (rtklib
        udbias: bias = (phi - P/lam)) with a large variance."""
        keep = []
        for k in self.amb_keys:
            sys_k = k[0]
            if sys_k in keys_by_sys and k in keys_by_sys[sys_k]:
                keep.append(k)
        idx_old = {k: i for i, k in enumerate(self.amb_keys)}
        new_keys = []
        for sys_k, keys in keys_by_sys.items():
            for k in keys:
                if k not in idx_old:
                    new_keys.append(k)
        all_keys = keep + new_keys
        n = 3 + len(all_keys)
        x = np.zeros(n)
        P = np.zeros((n, n))
        x[:3] = self.x[:3]
        P[:3, :3] = self.P[:3, :3]
        for i, k in enumerate(all_keys):
            if k in idx_old:
                j = 3 + idx_old[k]
                x[3 + i] = self.x[j]
                P[3 + i, :3] = self.P[j, :3]
                P[:3, 3 + i] = self.P[:3, j]
                for i2, k2 in enumerate(all_keys):
                    if k2 in idx_old:
                        P[3 + i, 3 + i2] = self.P[j, 3 + idx_old[k2]]
            else:
                x[3 + i] = dd0.get(k, 0.0)
                P[3 + i, 3 + i] = 100.0 ** 2
        self.x, self.P, self.amb_keys = x, P, all_keys

    # -- main update ----------------------------------------------------------

    def update(self, rover_obs, base_obs, prns, ephemerides,
               systems=None, carrier_freq_hz=None) -> RtkSolution:
        conf = self.conf
        bad = RtkSolution(False, False, 0.0, np.zeros(3), self.base.copy(),
                          np.zeros(3), {}, 0)
        geom_r = _sat_geometry(rover_obs, prns, systems, ephemerides,
                               self.base, carrier_freq_hz,
                               conf.elevation_mask_deg)
        geom_b = _sat_geometry(base_obs, prns, systems, ephemerides,
                               self.base, carrier_freq_hz,
                               conf.elevation_mask_deg)
        common = sorted(set(geom_r) & set(geom_b))
        if len(common) < conf.min_sats:
            return bad

        # single differences rover - base per satellite (meters).  The two
        # receivers' matched epochs carry the same rx-time LABEL but their
        # true tick times can differ by up to one observable interval (each
        # receiver anchors its own 20 ms grid), so each leg's satellite
        # position must be evaluated at that receiver's OWN transmit time
        # (geom_r vs geom_b) — evaluating both legs at the rover's time
        # puts multi-meter errors into the DDs at +-800 m/s range rates
        # (rtklib satposs runs per obs stream for the same reason).
        sd_code = {}
        sd_carr = {}
        geom = {}
        geom_base = {}
        for k in common:
            cr, gr = geom_r[k]
            cb, gb = geom_b[k]
            sd_code[k] = (rover_obs.pseudorange_m[cr]
                          - base_obs.pseudorange_m[cb])
            # chain convention: accumulated PLL phase ~ -range/lambda; the
            # negation yields the +range/lambda + N carrier observable
            # (see module docstring / models/outputs.py RINEX sign flip)
            sd_carr[k] = -gr.lam * (rover_obs.carrier_phase_cycles[cr]
                                    - base_obs.carrier_phase_cycles[cb])
            geom[k] = gr
            geom_base[k] = gb

        # reference satellite per system: highest elevation (ddres refsat)
        by_sys: dict = {}
        for k in common:
            by_sys.setdefault(k[0], []).append(k)
        refs = {}
        for sys_k, keys in by_sys.items():
            refs[sys_k] = max(keys, key=lambda k: geom[k].el)
        # a reference-satellite switch re-biases every DD in that system:
        # drop that system's ambiguity states (rtklib re-initializes the
        # bias states on refsat change)
        for sys_k, ref in refs.items():
            if self.refsat.get(sys_k) not in (None, ref) and self.x is not None:
                keep_i = [i for i, k in enumerate(self.amb_keys)
                          if k[0] != sys_k]
                sel = [0, 1, 2] + [3 + i for i in keep_i]
                self.x = self.x[sel]
                self.P = self.P[np.ix_(sel, sel)]
                self.amb_keys = [self.amb_keys[i] for i in keep_i]
        self.refsat.update(refs)

        dd_keys_by_sys = {s: [k for k in ks if k != refs[s]]
                          for s, ks in by_sys.items()}
        dd_keys = [k for s in sorted(dd_keys_by_sys)
                   for k in dd_keys_by_sys[s]]
        n_dd = len(dd_keys)
        if n_dd < 1:
            return bad

        dd_code = np.array([sd_code[k] - sd_code[refs[k[0]]]
                            for k in dd_keys])
        dd_carr = np.array([sd_carr[k] - sd_carr[refs[k[0]]]
                            for k in dd_keys])
        lam = np.array([geom[k].lam for k in dd_keys])

        # init / time update: rover starts at the base position with a
        # loose prior (the single-point fix could seed this instead)
        if self.x is None:
            self.x = self.base.copy()
            self.P = np.eye(3) * 1e4
            self.amb_keys = []
        if conf.mode == "kinematic" and self.last_t is not None:
            dt = max(rover_obs.rx_time_s - self.last_t, 0.0)
            q = (conf.pos_process_noise_ms or 1.0) ** 2 * dt
            self.P[:3, :3] += np.eye(3) * q
        self.last_t = rover_obs.rx_time_s
        dd0 = {k: (dd_carr[i] - dd_code[i]) / lam[i]
               for i, k in enumerate(dd_keys)}
        self._ensure_states(dd_keys_by_sys, dd0)
        amb_idx = {k: 3 + i for i, k in enumerate(self.amb_keys)}

        # measurement model: z = [dd_carr; dd_code], prediction from rover
        # position + ambiguities
        def dd_range(rov):
            # rover leg at the rover's transmit times, base leg at the
            # base's (see the single-difference note above)
            rng_sd = {k: (np.linalg.norm(geom[k].pos - rov)
                          - np.linalg.norm(geom_base[k].pos - self.base))
                      for k in common}
            return np.array([rng_sd[k] - rng_sd[refs[k[0]]]
                             for k in dd_keys])

        rov = self.x[:3]
        r_pred = dd_range(rov)
        n_x = len(self.x)
        H = np.zeros((2 * n_dd, n_x))
        for i, k in enumerate(dd_keys):
            e_i = (rov - geom[k].pos)
            e_i /= np.linalg.norm(e_i)
            e_r = (rov - geom[refs[k[0]]].pos)
            e_r /= np.linalg.norm(e_r)
            H[i, :3] = e_i - e_r
            H[n_dd + i, :3] = e_i - e_r
            H[i, amb_idx[k]] = lam[i]
        z = np.concatenate([dd_carr, dd_code])
        pred = np.concatenate([
            r_pred + lam * self.x[[amb_idx[k] for k in dd_keys]],
            r_pred])

        # DD covariance: shared reference satellite correlates the DDs
        # within a system (var_i + var_ref diagonal, var_ref off-diagonal).
        # `var_by_key` gives per-satellite undifferenced variances (the
        # DLL-settling code down-weight is per satellite).
        def dd_cov(var_by_key):
            R = np.zeros((n_dd, n_dd))
            for i, ki in enumerate(dd_keys):
                for j, kj in enumerate(dd_keys):
                    if ki[0] != kj[0]:
                        continue
                    v_ref = 2.0 * var_by_key[refs[ki[0]]]  # SD = 2x undiff
                    if i == j:
                        R[i, j] = v_ref + 2.0 * var_by_key[ki]
                    else:
                        R[i, j] = v_ref
            return R

        # track first-common times for the settling down-weight
        t_now = rover_obs.rx_time_s
        for k in common:
            self.first_seen.setdefault(k, t_now)
        carr_var = {k: conf.carrier_sigma_m ** 2 for k in common}
        code_var = {}
        for k in common:
            age = max(t_now - self.first_seen[k], 0.0)
            settle = (conf.code_settle_sigma_m
                      * np.exp(-age / max(conf.code_settle_tau_s, 1e-3)))
            code_var[k] = conf.code_sigma_m ** 2 + settle ** 2

        R = np.zeros((2 * n_dd, 2 * n_dd))
        R[:n_dd, :n_dd] = dd_cov(carr_var)
        R[n_dd:, n_dd:] = dd_cov(code_var)

        # innovation gating: reject CODE rows whose residual exceeds 6
        # sigma of the predicted innovation (settling channels, cycle
        # slips — the rtklib valpos residual test role)
        resid = z - pred
        s_diag = np.einsum("ij,jk,ik->i", H, self.P, H) + np.diag(R)
        keep = np.ones(2 * n_dd, bool)
        keep[n_dd:] = (np.abs(resid[n_dd:])
                       <= 6.0 * np.sqrt(np.maximum(s_diag[n_dd:], 1e-12)))
        if keep.sum() < n_dd + 1:
            keep[:] = True     # too few left: fall back to all rows
        H = H[keep]
        R = R[np.ix_(keep, keep)]
        resid = resid[keep]

        # EKF update
        S = H @ self.P @ H.T + R
        K = np.linalg.solve(S, H @ self.P).T
        self.x = self.x + K @ resid
        self.P = (np.eye(n_x) - K @ H) @ self.P
        self.P = 0.5 * (self.P + self.P.T)

        float_base = self.x[:3] - self.base

        # ambiguity resolution (resamb_LAMBDA)
        fixed = False
        ratio = 0.0
        amb_fixed = {}
        rover_out = self.x[:3].copy()
        if n_dd >= 2:
            a = self.x[3:3 + n_dd]
            Qa = self.P[3:3 + n_dd, 3:3 + n_dd]
            try:
                cands, s = lambda_ils(a, Qa, m=2)
            except np.linalg.LinAlgError:
                cands, s = None, None
            if cands is not None and len(s) == 2 and s[0] > 0:
                ratio = float(s[1] / max(s[0], 1e-12))
                if ratio >= conf.ratio_threshold:
                    fixed = True
                    a_fix = cands[0].astype(np.float64)
                    # conditional update: x_b|a = x_b - P_ba Qa^{-1}(a - a_fix)
                    P_ba = self.P[:3, 3:3 + n_dd]
                    corr = P_ba @ np.linalg.solve(Qa, a - a_fix)
                    rover_out = self.x[:3] - corr
                    amb_fixed = {k: int(cands[0][i])
                                 for i, k in enumerate(self.amb_keys)}
        return RtkSolution(
            valid=True, fixed=fixed, ratio=ratio,
            baseline_m=rover_out - self.base,
            rover_ecef_m=rover_out,
            float_baseline_m=float_base,
            ambiguities=amb_fixed, n_dd=n_dd)
