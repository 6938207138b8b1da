"""Run the three variants of chip_smoke.py's phase 11 that its scenario
choices rest on, and print what each does to the receiver.

    python3 tools/probe_multiband.py [--device cuda|cpu] [--seconds S]

- "cnav_toe": phase 11's receiver (GPS L1 C/A at 8 Msps + L5I at 20 Msps,
  warm) on make_sky_constellation(toe=T0 + 600)'s ephemerides as they
  come, toe = 346208 s: LNAV carries that toe, CNAV rounds it to 346200 s,
  and the decoded CNAV ephemeris replaces the LNAV one under its PRN.
- "xcorr": L1 C/A alone at 2 Msps, noiseless, warm, on the sky of
  make_sky_constellation(toe=T0 + 1200), whose PRNs 4 and 10 sit a few
  Hz apart in Doppler.
- "nh10": the L5I chain alone at 20 Msps, cold, with the chain's default
  FFT (no bit_transition_flag) on phase 11's L5 stream.

Each prints one JSON line: per 2 s window the mean ENU error of the fixes
(cnav_toe, xcorr; cnav_toe also each ephemeris stored: band, PRN, the
cursor's second, its toe), or each channel's final Doppler against the
truth and whether its telemetry ever gave a TOW (nh10).  The captures are made by K6 (its plain version
with --device cpu, which takes minutes and gigabytes at these rates;
--seconds cuts them).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def sky(cs, toe):
    """Phase 11's sky (chip_smoke.multiband_sats) on the ephemerides of
    make_sky_constellation(toe=toe), their toe and toc as given."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    ephs = [e for e in make_sky_constellation(cs.RX_LLH[0], cs.RX_LLH[1],
                                              toe=toe)
            if e.prn in cs.SCENARIO_PRNS]
    l1 = build_static_scenario(ephs, cs.rx_true_ecef(), cs.T0, cs.MB_DUR,
                               cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    l5 = build_static_scenario([e for e in ephs if e.prn in cs.MB_L5_PRNS],
                               cs.rx_true_ecef(), cs.T0, cs.MB_DUR,
                               cn0_db_hz=48.0, band="L5")
    return {e.prn: e for e in ephs}, l1, l5


def windows(cs, run) -> list:
    """(seconds into the capture, mean ENU error m) per 2 s of fixes."""
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    ref = (np.radians(cs.RX_LLH[0]), np.radians(cs.RX_LLH[1]))
    t = np.array([s.rx_time_corrected_s for s in run.solutions]) - cs.T0
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - cs.rx_true_ecef(),
                                        ref) for s in run.solutions])
    out = []
    for w in range(0, int(cs.MB_DUR), 2):
        m = (t >= w) & (t < w + 2)
        if m.any():
            out.append((w, np.round(enu[m].mean(0), 3).tolist()))
    return out


def session_run(cs, conf, streams, ephs, device):
    """A session over `streams`, warm with `ephs` if given: the session,
    its result and each ephemeris stored (band, PRN, the cursor's second,
    toe)."""
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    s = Receiver(conf, device=device).start_session(ephemerides=ephs)
    stored = []
    store = s._store_eph

    def store_logged(rt, eph):
        stored.append((rt.spec.signal, int(eph.prn), round(
            s.cursor / conf.fs, 2), float(eph.toe)))
        store(rt, eph)
    s._store_eph = store_logged
    s.attach_arrays(streams)
    s.run_to_end()
    return s, s.result(), stored


def main() -> int:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    sys.argv = sys.argv[:1]
    import chip_smoke as cs
    from gnss_sim_receiver_tpu_torch.models.receiver import (ReceiverConf,
                                                             gps_l5_chain)
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident as k6
    if args.seconds > 0:
        cs.MB_DUR = args.seconds
    dev = args.device

    # cnav_toe: phase 11's receiver on the toe 346208 s ephemerides
    ephs, l1, l5 = sky(cs, cs.T0 + 600.0)
    conf = cs.multiband_conf()
    streams = {0: k6(l1, cs.FS_MB_L1, int(cs.FS_MB_L1 * cs.MB_DUR),
                     noise=True, seed=41, device=dev),
               1: k6(l5, cs.FS_MB_L5, int(cs.FS_MB_L5 * cs.MB_DUR),
                     noise=True, seed=42, device=dev)}
    _, run, stored = session_run(cs, conf, streams, dict(ephs), dev)
    print(json.dumps({"case": "cnav_toe", "toe": ephs[1].toe,
                      "fixes": len(run.solutions),
                      "ephemerides_stored": stored,
                      "windows": windows(cs, run)}), flush=True)
    del streams

    # xcorr: L1 alone at 2 Msps, noiseless, on the T0 + 1200 s sky
    ephs, l1, _ = sky(cs, cs.T0 + 1200.0)
    dop = {s.prn: round(s.doppler_hz, 1) for s in l1}
    x = k6(l1, 2e6, int(2e6 * cs.MB_DUR), noise=False, seed=41, device=dev)
    conf = ReceiverConf(fs=2e6, prns=tuple(range(1, 11)), max_channels=8,
                        pvt_rate_ms=cs.MB_PVT_RATE_MS)
    _, run, _ = session_run(cs, conf, {0: x}, dict(ephs), dev)
    print(json.dumps({"case": "xcorr", "doppler_hz": dop,
                      "fixes": len(run.solutions),
                      "windows": windows(cs, run)}), flush=True)
    del x

    # nh10: the L5 chain alone, cold, the chain's default FFT
    ephs, _, l5 = sky(cs, cs.T0)
    x = k6(l5, cs.FS_MB_L5, int(cs.FS_MB_L5 * cs.MB_DUR), noise=True,
           seed=42, device=dev)
    chain = gps_l5_chain(cs.FS_MB_L5, prns=cs.MB_L5_PRNS,
                         n_channels=len(cs.MB_L5_PRNS))
    conf = ReceiverConf(fs=cs.FS_MB_L5, gps_chain=False, chains=(chain,))
    s, run, _ = session_run(cs, conf, {0: x}, None, dev)
    st = s.chains[0].trk.state
    print(json.dumps({
        "case": "nh10", "bit_transition_flag": chain.acq.bit_transition_flag,
        "prns": run.channel_prns,
        "doppler_hz": np.round(st.carrier_doppler.cpu().numpy(), 1).tolist(),
        "true_doppler_hz": {p.prn: round(p.doppler_hz, 1) for p in l5},
        "tow_seen": s._tow_seen.tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
