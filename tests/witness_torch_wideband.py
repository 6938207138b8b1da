"""CPU witness of the wideband slice: the PyTorch port's receiver and the
JAX package's on the same cut of chip_smoke.py's phase 7 scenario.

    JAX_PLATFORMS=cpu python tests/witness_torch_wideband.py [--seconds 30]
        [--workdir DIR]

The first `--seconds` of phase 7's capture (GPS PRNs 1, 3, 4, 5 on L5 and
Galileo PRNs 11-15 on E5a, 48 dB-Hz, 20 Msps) are made by the port's device
generator on the CPU (its plain version, seed 17), quantized and written
as an ibyte file as phase 7 writes them.  Each package then reads the file
and runs phase 7's conf through the receiver ``make_receiver(conf)``
builds, one package per child process: the port over the whole array, as
the CLI runs it (``process_array``); the JAX package in its streaming mode,
the file fed in 1 s pieces (``ReceiverSession.feed``; its batch mode held
over 40 GB at 20 Msps on the CPU, and tests/test_control_plane.py holds
the two modes to the same fixes).  The
script prints, per package, the tracked sets, the ephemerides, the fixes
and their mean error, and then the port - JAX pseudorange differences per
system at the observable epochs both produce (pairs, rms, p99, max).

A CPU run: its seconds are the CPU's, not the card's.  With 30 s the CNAV
ephemerides decode (about 26 s), the F/NAV ones do not (about 50 s), so
the fixes are the GPS satellites' alone.  Not collected by pytest: it
takes minutes and gigabytes.
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(capture: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke
    props = chip_smoke.conf_properties(chip_smoke.WIDEBAND_CONF.format(
        capture=capture, fs=int(chip_smoke.FS_WIDEBAND)))
    return props


def make_capture(path: str, seconds: float) -> None:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    torch.set_num_threads(8)
    x = generate_baseband_device_resident(
        chip_smoke.wideband_sats(), chip_smoke.FS_WIDEBAND,
        int(chip_smoke.FS_WIDEBAND * seconds), noise=True, seed=17,
        device="cpu")
    write_samples(path, x, "ibyte", scale=chip_smoke.HYB_BYTE_SCALE)


def run_package(name: str, capture: str, out: str) -> None:
    """One package's receiver over the capture; pickles what the
    comparison needs."""
    if name == "port":
        import torch
        torch.set_num_threads(8)
        from gnss_sim_receiver_tpu_torch.models.factory import make_receiver
        from gnss_sim_receiver_tpu_torch.utils.config import \
            InMemoryConfiguration
        from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
        rx = make_receiver(InMemoryConfiguration(_conf(capture)),
                           device="cpu")
        x = read_samples(capture, "ibyte")
        t0 = time.perf_counter()
        run = rx.process_array(x)
    else:
        from gnss_sim_receiver_tpu.models.factory import make_receiver
        from gnss_sim_receiver_tpu.utils.config import InMemoryConfiguration
        from gnss_sim_receiver_tpu.utils.sample_io import read_samples
        props = _conf(capture)
        session = make_receiver(InMemoryConfiguration(props)).start_session()
        piece = int(props["GNSS-SDR.internal_fs_sps"])      # 1 s
        total = os.path.getsize(capture) // 2               # ibyte: 2 B
        t0 = time.perf_counter()
        for start in range(0, total, piece):
            session.feed(read_samples(capture, "ibyte",
                                      count=min(piece, total - start),
                                      offset_items=start))
        session.run_to_end()
        run = session.result()
    seconds = time.perf_counter() - t0
    with open(out, "wb") as fh:
        pickle.dump(dict(
            seconds=seconds, prns=list(run.channel_prns),
            systems=list(run.channel_systems),
            states=[int(s) for s in run.channel_states],
            ephemerides=sorted(str(k) for k in run.ephemerides),
            fixes=[np.asarray(s.rx_ecef_m, np.float64)
                   for s in run.solutions],
            n_sats=[int(s.n_sats) for s in run.solutions],
            epochs=[(round(e.rx_time_s, 6),
                     np.asarray(e.pseudorange_m, np.float64),
                     np.asarray(e.valid, bool))
                    for e in run.observation_epochs]), fh)


def report(results: dict) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    rx_true = chip_smoke.rx_true_ecef()
    lat, lon = chip_smoke.RX_LLH[:2]
    ref = (np.radians(lat), np.radians(lon))
    for name, r in results.items():
        # ChannelState.TRACKING is 2 in both packages
        tracked = sorted((s, p) for p, s, st in zip(
            r["prns"], r["systems"], r["states"]) if st == 2 and p)
        line = (f"{name}: receiver {r['seconds']:.1f} s (CPU); tracked "
                f"{tracked}; ephemerides {r['ephemerides']}; "
                f"{len(r['fixes'])} fixes")
        if r["fixes"]:
            enu = np.array([geodesy.ecef_to_enu(f - rx_true, ref)
                            for f in r["fixes"]])
            line += (f", the last with {r['n_sats'][-1]} satellites, mean "
                     f"error 2D {np.linalg.norm(enu.mean(0)[:2]):.3f} m, 3D "
                     f"{np.linalg.norm(enu.mean(0)):.3f} m")
        print(line)
    port, jax = results["port"], results["jax"]
    ref_epochs = {t: (pr, v) for t, pr, v in jax["epochs"]}
    for system in ("GPS", "Galileo"):
        cols = [c for c, s in enumerate(port["systems"]) if s == system]
        d = []
        for t, pr, v in port["epochs"]:
            if t not in ref_epochs:
                continue
            rpr, rv = ref_epochs[t]
            d += [pr[c] - rpr[c] for c in cols if v[c] and rv[c]]
        d = np.asarray(d)
        if not len(d):
            print(f"{system}: no common pseudoranges")
            continue
        print(f"{system}: port - JAX pseudoranges over {len(d)} pairs: rms "
              f"{np.sqrt(np.mean(d ** 2)):.3f} m, p99 "
              f"{np.percentile(np.abs(d), 99):.3f} m, max "
              f"{np.abs(d).max():.3f} m, mean {d.mean():+.3f} m")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build"))
    ap.add_argument("--run", choices=("port", "jax"))
    ap.add_argument("--capture")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.run:
        run_package(args.run, args.capture, args.out)
        return 0
    os.makedirs(args.workdir, exist_ok=True)
    capture = os.path.join(args.workdir,
                           f"wideband_witness_{args.seconds:g}s.ibyte")
    if not os.path.exists(capture):
        make_capture(capture, args.seconds)
    results = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    for name in ("port", "jax"):
        out = os.path.join(args.workdir, f"wideband_witness_{name}.pkl")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--run", name, "--capture", capture, "--out", out],
                       check=True, env=env)
        with open(out, "rb") as fh:
            results[name] = pickle.load(fh)
    report(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
