"""Probe, on one CUDA card, chip_smoke.py's BeiDou slice alone: phase 3's
checks at phase 15's shapes, then phase 15 (a), (b) and (c).

    python3 tools/probe_beidou.py               # both
    python3 tools/probe_beidou.py --shapes      # phase 3's BeiDou rows only
    python3 tools/probe_beidou.py --paths       # phase 15 only

Builds every CUDA library of this checkout (chip_smoke.py's phase 2,
without the --fmad=false block library), runs check_beidou_shapes (its
rows and other shapes printed as JSON lines), then b1_path, b13_path and
geo_path with the launch counters set to 0 before each and read after,
as chip_smoke.py runs them.  Prints the card's name and power limit first.
A few minutes on the card; the quick check of the BeiDou slice before a
whole chip_smoke.py run.

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
        print("probe_beidou: no CUDA device", file=sys.stderr)
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
        cs.check_beidou_shapes(dev, card, rows, extra)
        print(f"phase 3's BeiDou rows took {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"other_shapes": extra}))
        print(json.dumps({"kernels": rows}), flush=True)
    if both or args.paths:
        wrappers = cs.launch_wrappers()
        t0 = time.perf_counter()
        for name, run in (("15(a)", lambda: cs.b1_path(str(ROOT), wrappers,
                                                       card)),
                          ("15(b)", lambda: cs.b13_path(wrappers, card)),
                          ("15(c)", lambda: cs.geo_path(wrappers, card))):
            print(f"== phase {name}", flush=True)
            launches = run()
            print(json.dumps({"phase": name, "launches": {
                k: v for k, v in launches.items() if v}}), flush=True)
            torch.cuda.empty_cache()
        print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
