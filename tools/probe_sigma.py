"""Probe, on one CUDA card, K10a and K10b, the sigma-point filters' kernels
(csrc/sigma.cu):

- ``--kernels``: the sigma library's ptxas lines (registers and spills of
  every kernel and lane group), then chip_smoke.py's check_k10: every
  shape of SIGMA_SHAPES against the plain versions, bit for bit the
  one-warp-a-filter kernels they replaced, timed in turns with them
  beside an empty kernel on the new grid, and the planted cases;
- ``--filters``: phase 9b (chip_smoke.filters_path): 40 steps of 4096
  filters of tests/test_nonlinear.py's linear system under both rules
  (host ms a step), then the 4096 tanh filters;
- ``--stamps``: K10a and both updates of K10b built with %globaltimer
  stamps of each filter's stages (-DSIGMA_PROBE, into
  build/torch_kernels/sigma_stamps) at nx = 4, nz = 2 and nx = nz = 1,
  B = 4096: from a filter's entry, the loads in, the column steps done,
  the stores issued;
- ``--tree DIR``: the package and chip_smoke.py of another tree (a ``git
  archive`` unpacked under ``build/``), so that two trees are timed in
  one call, in turns.

    python3 tools/probe_sigma.py --kernels --stamps --filters
    python3 tools/probe_sigma.py --filters --tree build/parent

Times by CUDA graph replay (chip_smoke.time_ms); the filter steps on the
host's clock.  Prints the card's name and power limit.  Exits 1 when a
check fails.  Needs the card (~1 min a tree with the build); imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STAMPS = ("-DSIGMA_PROBE",)
STAGES = ("loads in", "column steps done", "stores issued")


def stamped(cs, nl, cuda_build, dev) -> None:
    """Each kernel at phase 9b's two shapes, once warm and once stamped:
    per stage the median and the largest ns from a filter's entry, the
    spread of the entries and the last store from the first entry."""
    import torch
    where = cuda_build.BUILD_DIR / "sigma_stamps"
    lib = nl._lib(STAMPS, where)
    lib.sigma_stamps_read.argtypes = [ctypes.c_void_p]
    lib.sigma_stamps_read.restype = ctypes.c_int
    rng = np.random.default_rng(7)
    b = cs.SIGMA_BATCH
    for nx, nz in ((4, 2), (1, 1)):
        x = torch.from_numpy(rng.standard_normal((b, nx)).astype(
            np.float32)).to(dev)
        P = cs._spd(rng, b, nx, dev)
        w = nl.sigma_weights(nx, "cubature", None, torch.float32, dev)
        pts = nl.sigma_points(x, P)
        zpts = pts[..., :nz].contiguous()
        R = cs._spd(rng, b, nz, dev, 0.1)
        Q = 0.01 * torch.eye(nx, device=dev)
        z = torch.zeros((b, nz), device=dev)
        calls = {
            "K10a": lambda: nl.sigma_points(x, P),
            "K10b time update": lambda: nl.sigma_moments(pts, w, Q),
            "K10b measurement update": lambda: nl.sigma_moments(
                zpts, w, R, z=z, x_pred=x, P_pred=P, pts=pts)}
        for name, call in calls.items():
            buf = np.zeros((4096, 4), np.uint64)
            with mock.patch.object(nl, "_lib", lambda: lib):
                for _ in range(2):     # a warm launch, then the stamped one
                    call()
                    torch.cuda.synchronize()
                    cuda_build.check(lib.sigma_stamps_read(buf.ctypes.data),
                                     "sigma_stamps_read")
            st = buf.astype(np.int64)
            t0 = st[:, 0].min()
            parts = []
            for i, stage in enumerate(STAGES, start=1):
                seen = st[:, i] > 0
                if seen.any():
                    rel = st[seen, i] - st[seen, 0]
                    parts.append(f"{stage} {int(np.median(rel))} / "
                                 f"{int(rel.max())}")
            print(f"  stamps, {name} (B={b}, nx={nx}, nz={nz}; ns from a "
                  f"filter's entry, median / max): " + "; ".join(parts)
                  + f"; entries spread {int(st[:, 0].max() - t0)}, last "
                  f"store {int(st[:, 3].max() - t0)} after the first entry")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--filters", action="store_true")
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("probe_sigma: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    print(f"tree {tree}", flush=True)
    secs = cuda_build.build_all(("sigma_kernels",))["sigma_kernels"]
    log = cuda_build.library_path("sigma_kernels").with_suffix(
        ".log").read_text(errors="replace")
    print(f"sigma_kernels: nvcc {secs:.1f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    dev = torch.device("cuda")
    if args.kernels:
        extra: list = []
        rows = cs.check_k10(dev, np.random.default_rng(7), extra)
        for r in rows + extra:
            print(f"  {r['name']} [{r['shape']}]: {r['ms']:.4f} ms, replaced "
                  f"{r.get('reference_ms', float('nan')):.4f}, empty "
                  f"{r.get('launch_floor_ms', float('nan')):.4f}, bound "
                  f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']:.4f}")
    if args.stamps:
        stamped(cs, nl, cuda_build, dev)
    if args.filters:
        wrappers = {"K10a_sigma_points": (nl.sigma_points, "launches"),
                    "K10b_sigma_moments": (nl.sigma_moments, "launches")}
        print(f"  phase 9b launches: {cs.filters_path(wrappers, dev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
