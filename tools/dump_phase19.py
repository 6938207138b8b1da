"""Dump, on one CUDA card, chip_smoke.py phase 19's captures and runs for
a replay on the CPU.

    python3 tools/dump_phase19.py [--out build/phase19_dump]

Makes phase 19's three K6 captures on the card as the phase does (the
base, the rover, (c)'s and (d)'s capture, their seeds), runs (a)'s base
through process_array and its rover through the CLI from an ishort file
with the RTK_Static conf, and (c)'s PPP_Static and (d)'s EKF runs through
process_array, and writes `card19.npz` (every 1009th sample of each
capture and its first 65536; every run's observation epochs; the rover's
RTK solutions; the LS fixes, PPP and EKF solutions of (c) and (d)) and
the base's RINEX observation file `base.obs` under --out.  The witness
`python -m tests.test_torch_rtk <out>/card19.npz` rebuilds the captures
on the CPU and compares them, and the port's runs on them, with these.
Prints the card's name and power limit first.  No checks: chip_smoke.py
holds the results.

Needs the card; imports nothing of JAX.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def samples(x):
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
    idx = np.arange(0, x.size, 1009)
    return dict(idx=idx, strided=x[idx], head=x[:65536].copy())


def obs_arrays(run, tag):
    eps = run.observation_epochs
    return {f"{tag}_t": np.array([e.rx_time_s for e in eps]),
            f"{tag}_tick": np.array([e.tick_sample for e in eps]),
            f"{tag}_valid": np.array([e.valid for e in eps]),
            f"{tag}_pr": np.array([e.pseudorange_m for e in eps]),
            f"{tag}_ph": np.array([e.carrier_phase_cycles for e in eps]),
            f"{tag}_dop": np.array([e.carrier_doppler_hz for e in eps]),
            f"{tag}_cn0": np.array([e.cn0_db_hz for e in eps]),
            f"{tag}_prns": np.array(run.channel_prns)}


def rtk_arrays(run, tag):
    s = run.rtk_solutions
    return {f"{tag}_rtk_t": np.array([t for t, _ in s]),
            f"{tag}_rtk_fixed": np.array([r.fixed for _, r in s]),
            f"{tag}_rtk_valid": np.array([r.valid for _, r in s]),
            f"{tag}_rtk_ratio": np.array([r.ratio for _, r in s]),
            f"{tag}_rtk_base": np.array([r.baseline_m for _, r in s]),
            f"{tag}_rtk_float": np.array([r.float_baseline_m for _, r in s]),
            f"{tag}_rtk_ndd": np.array([r.n_dd for _, r in s])}


def main() -> int:
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    from gnss_sim_receiver_tpu_torch.models import outputs
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "phase19_dump"))
    out_dir = ap.parse_args().out
    if not torch.cuda.is_available():
        print("dump_phase19: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    w = cs.launch_wrappers()
    base_true, rover_true = cs.rx_true_ecef(), cs.rover_true_ecef()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    obs_path = os.path.join(build, "phase19_base.obs")
    cap = os.path.join(build, "phase19_rover_40s_2msps.ishort")
    conf_path = os.path.join(build, "chip_smoke_rtk19.conf")
    base_str = ",".join(f"{v:.4f}" for v in base_true)
    rtk_text = (cs.PVT_MODE_CONF.format(capture=cap)
                + "PVT.positioning_mode=RTK_Static\n"
                  "PVT.AR_ratio_threshold=2.5\n"
                  f"PVT.rtk_base_rinex_obs={obs_path}\n"
                  f"PVT.rtk_base_position_ecef={base_str}\n")
    out = {}
    x_base, _, _ = cs.sky_capture(w, base_true, cs.RTK_BASE_DUR,
                                  cs.RTK_CN0, 191)
    x_rover, _, _ = cs.sky_capture(w, rover_true, cs.RTK_ROVER_DUR,
                                   cs.RTK_CN0, 192)
    for k, v in samples(x_base).items():
        out[f"xb_{k}"] = v
    for k, v in samples(x_rover).items():
        out[f"xr_{k}"] = v
    write_samples(cap, x_rover, "ishort", scale=200.0)
    conf = receiver_conf_from_config(InMemoryConfiguration(
        cs.conf_properties(cs.PVT_MODE_CONF)))
    base_run = Receiver(conf).process_array(x_base)
    out.update(obs_arrays(base_run, "base"))
    week = next(iter(base_run.ephemerides.values())).week
    outputs.write_rinex_obs(obs_path, base_run.observation_epochs,
                            base_run.channel_prns, week)
    with open(obs_path) as fh:
        text = fh.read()
    with open(os.path.join(out_dir, "base.obs"), "w") as fh:
        fh.write(text)
    with open(conf_path, "w") as fh:
        fh.write(rtk_text)
    res = run_cli([f"--config_file={conf_path}"])
    print(f"the rover's CLI exit code {res.exit_code}", flush=True)
    out.update(obs_arrays(res.run, "rover"))
    out.update(rtk_arrays(res.run, "rover"))
    truth = np.asarray(rover_true) - np.asarray(base_true)
    fx = [(t, s) for t, s in res.run.rtk_solutions if s.fixed]
    print(f"(a) the last fixed epoch, rx time {fx[-1][0]:.2f} s: fixed "
          f"{np.linalg.norm(fx[-1][1].baseline_m - truth):.4f} m, float "
          f"{np.linalg.norm(fx[-1][1].float_baseline_m - truth):.4f} m",
          flush=True)
    del x_base, x_rover
    torch.cuda.empty_cache()
    # 19(c), (d)
    truth_p = np.asarray(base_true)
    x, ephs, _ = cs.sky_capture(w, truth_p, cs.PPP_DUR, cs.PPP_CN0, 193)
    for k, v in samples(x).items():
        out[f"xp_{k}"] = v
    for tag, keys, ekf in (("ppp", {"PVT.positioning_mode": "PPP_Static"},
                            False), ("ekf", {}, True)):
        c = receiver_conf_from_config(InMemoryConfiguration(
            {**cs.conf_properties(cs.PVT_MODE_CONF), **keys}))
        c = dataclasses.replace(c, enable_pvt_ekf=ekf)
        run = Receiver(c).process_array(x, ephemerides=dict(ephs))
        out.update(obs_arrays(run, tag))
        out[f"{tag}_ls_t"] = np.array([s.rx_time_corrected_s
                                       for s in run.solutions])
        out[f"{tag}_ls_pos"] = np.array([s.rx_ecef_m for s in run.solutions])
        out[f"{tag}_ppp_t"] = np.array([t for t, _ in run.ppp_solutions])
        out[f"{tag}_ppp_pos"] = np.array([p.rx_ecef_m
                                          for _, p in run.ppp_solutions])
        out[f"{tag}_ekf_t"] = np.array([e[0] for e in run.ekf_solutions])
        out[f"{tag}_ekf_pos"] = np.array([e[1] for e in run.ekf_solutions])
    np.savez_compressed(os.path.join(out_dir, "card19.npz"), **out)
    for p in (obs_path, cap, conf_path):
        os.remove(p)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
