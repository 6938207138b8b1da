"""Run chip_smoke.py's phase 10, the fork's hybrid operating point, on the
CPU through the port's plain versions, and print the gap that phase 10's
clock-difference tolerance (chip_smoke.PS_CLOCK_TOL_S) is stated from.

    python3 tools/probe_hybrid_ps.py [--seconds S] [--threads N]

The scenario is phase 10's (chip_smoke.ps_sats: phase 4's sky and a
pseudolite on PRN 17 at 0 Hz and 50 dB-Hz, its clock PS_DT_S off GPS
time), made by K6's plain version on the CPU (noise seed 29) and written
as ibyte into build/, then run through the port's CLI with PS_CONF (the
hybrid keys) and --device=cpu.  It prints chip_smoke.check_ps_run's
numbers (the fixes, the position error, the channels used, the bias
records' PRNs, the clock differences and their median against PS_DT_S)
as one JSON line, and exits 1 where a check fails.  The full 26 s (the
ephemerides need subframes 1-3, complete at ~24 s) take a few minutes of
CPU and ~2 GB; --seconds cuts the CLI's run (no fix comes before ~24 s).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(args.threads)
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    path = ROOT / "build" / "ps_scenario_26s_3msps_cpu_v1.ibyte"
    t0 = time.perf_counter()
    if not path.exists():
        chip_smoke.make_ps_capture(str(path), "cpu")
    t_make = time.perf_counter() - t0
    conf = ROOT / "build" / "probe_hybrid_ps.conf"
    conf.write_text(chip_smoke.PS_CONF.format(capture=path))
    argv = [f"--config_file={conf}", "--device=cpu"]
    if args.seconds > 0:
        argv.append(f"--duration_s={args.seconds}")
    t0 = time.perf_counter()
    res = run_cli(argv)
    t_run = time.perf_counter() - t0
    if res.exit_code != 0:
        print(f"probe_hybrid_ps: the CLI returned {res.exit_code}")
        return 1
    out = chip_smoke.check_ps_run(res.run)
    out.update(seconds_capture=t_make, seconds_cli=t_run,
               dt_ps_s=chip_smoke.PS_DT_S,
               tolerance_s=chip_smoke.PS_CLOCK_TOL_S)
    print(json.dumps(out, default=float))
    os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
