"""Probe, on one CUDA card, chip_smoke.py's SBAS L1 and PVT-modes slice
alone: phase 3's checks at phase 18's shapes (the S1 search at 2 Msps, the
block step and the chunk kernel at the S1 chain's C=2, K6 on both skies),
then phases 18 (a) and (b).

    python3 tools/probe_sbas.py               # both
    python3 tools/probe_sbas.py --shapes      # phase 3's rows only
    python3 tools/probe_sbas.py --paths       # phase 18 only

Builds every CUDA library of this checkout (chip_smoke.py's phase 2,
without the --fmad=false block library), runs check_sbas_shapes (its rows
and other shapes printed as JSON lines), then sbas_path and modes_path
with the launch counters set to 0 before each and read after, as
chip_smoke.py runs them.  Prints the card's name and power limit first.
A few minutes on the card; the quick check of the slice before a whole
chip_smoke.py run.

Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    both = not (args.shapes or args.paths)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("probe_sbas: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all()
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")
    if both or args.shapes:
        t0 = time.perf_counter()
        rows, extra = [], []
        cs.check_sbas_shapes(dev, card, rows, extra)
        print(f"phase 3's S1 rows took {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"other_shapes": extra}))
        print(json.dumps({"kernels": rows}), flush=True)
    if both or args.paths:
        wrappers = cs.launch_wrappers()
        for name, run in (
                ("18(a)", lambda: cs.sbas_path(str(ROOT), wrappers, card)),
                ("18(b)", lambda: cs.modes_path(wrappers, card))):
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            launches = run()
            print(json.dumps({"phase": name, "launches": {
                k: v for k, v in launches.items() if v}}), flush=True)
            print(f"phase {name} took {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
