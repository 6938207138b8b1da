"""Time, on one CUDA card, K4b's resolve kernel (csrc/quicksync_resolve.cu)
beside an empty kernel on its grid and the Triton kernel it replaced.

    python3 tools/probe_resolve.py

At each case (C channels, fold, N samples: phase 4d's C = 8, fold 4,
N = 2000; C = 10, fold 8; C = 8, fold 4 at N = 4000 and at N = 20000) of
noise with delays drawn below N / fold and the last channel's code one
segment repeated (an exact tie of every candidate) it checks the kernel
against the plain version and the replaced kernel (delays identical,
magnitudes within 1e-4 of the scale; the tie to its first candidate) and
times the kernel, the replaced kernel and the empty kernel by CUDA graph
replay (chip_smoke.time_ms).  Prints the card's name and power limit,
the library's ptxas lines and one line a case.  Exit 1 when the kernel
disagrees.  Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CASES = ((8, 4, 2000), (10, 8, 2000), (8, 4, 4000), (8, 4, 20000))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("probe_resolve: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.ops import cuda_build, pcps
    print(chip_smoke.card_line())
    pcps._resolve_lib()
    log = cuda_build.library_path("quicksync_resolve").with_suffix(
        ".log").read_text(errors="replace")
    print("  " + "; ".join(ln.split(":", 1)[-1].strip()
                           for ln in log.splitlines() if "registers" in ln))
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    bad = 0
    for c, fold, n in CASES:
        nf = n // fold
        x = torch.from_numpy((rng.standard_normal(n)
                              + 1j * rng.standard_normal(n)).astype(
                                  np.complex64)).to(dev)
        codes_h = np.sign(rng.standard_normal((c, n))).astype(np.float32)
        codes_h[-1] = np.tile(codes_h[-1][:nf], fold + 1)[:n]
        codes = torch.from_numpy(codes_h).to(dev)
        dop = torch.from_numpy(rng.uniform(-5e3, 5e3, c).astype(
            np.float32)).to(dev)
        lag = torch.from_numpy(rng.integers(0, nf, c).astype(
            np.int32)).to(dev)
        t = pcps.time_axis(n, 2e6, dev)
        want = pcps._resolve_plain(x, codes, dop, lag, t, fold)
        ref = pcps._resolve_reference(x, codes, dop, lag, t, fold)
        ref_ms = chip_smoke.time_ms(
            lambda: pcps._resolve_reference(x, codes, dop, lag, t, fold))
        got = pcps.pcps_quicksync_resolve(x, codes, dop, lag, t, fold)
        torch.cuda.synchronize()
        scale = float(want[1].abs().max())
        ok = (torch.equal(got[0], want[0]) and torch.equal(got[0], ref[0])
              and float((got[1] - want[1]).abs().max()) <= 1e-4 * scale
              and float((got[1] - ref[1]).abs().max()) <= 1e-4 * scale
              and int(got[0][-1]) == int(lag[-1]))
        bad += not ok
        ms = chip_smoke.time_ms(
            lambda: pcps.pcps_quicksync_resolve(x, codes, dop, lag, t, fold))
        floor = chip_smoke.time_ms(lambda: pcps._resolve_empty(c, dev))
        print(f"  C={c}, fold {fold}, N={n}: "
              f"{'agrees' if ok else 'DISAGREES'}; {ms:.4f} ms, the "
              f"replaced kernel {ref_ms:.4f} ms, an empty kernel on its "
              f"grid {floor:.4f} ms ({ms / floor:.2f} x)")
    print(f"probe_resolve: {'the kernel agrees' if not bad else 'FAILED'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
