"""Probe, on one CUDA card, K3c's plain form and K7's fold
(csrc/pcps_rows.cu) against the Triton kernels they replaced:

- the Triton kernels' PTX: every float32 fma, mul, add, div and max of
  K3's row kernel, K3c's tile and ratio kernels and K7's fold, so that
  the contraction of `acc += re * re + im * im` and the ratio's division
  can be read;
- K3c at five shapes (phase 4's M = 2, C = 8, D = 41, N = 2000; N = 4000;
  the ROC harness's M = 1, C = 384; N = 20000 and 40000), each held bit
  for bit to the replaced form (statistic and both indices) and timed in
  turns with it, beside K3's row kernel alone and an empty kernel on its
  grid;
- K3c built with %globaltimer stamps of each CTA's stages (-DK3C_PROBE)
  at phase 4's and the ROC harness's shapes;
- K7 at phase 9's D = 41, L = 127 N and at D = 4, L = 4 N, held bit for
  bit to the Triton kernel and timed in turns with it.

    python3 tools/probe_pcps_rows.py

Times by CUDA graph replay (chip_smoke.time_ms).  Prints the card's name
and power limit and each build's ptxas lines.  Exit 1 when the kernels
disagree with the replaced ones, naming each comparison that failed.
Needs the card (~1 min); imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import re
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STAMPS = ("-DK3C_PROBE",)
# K3c's shapes (M, C, D, N): phase 4's; bit_transition_flag's N; the ROC
# harness's 384 trials (phase 4f); 20 Msps GPS and L5I (long rows)
SHAPES = ((2, 8, 41, 2000), (2, 10, 41, 4000), (1, 384, 41, 2000),
          (2, 10, 41, 20000), (2, 10, 41, 40000))
SPC = 2
PTX_OPS = re.compile(r"^\s*(fma|mul|add|sub|div|max|min)\.[\w.]*f32\b")


def ptx_ops(kernel) -> list[str]:
    """The float32 arithmetic of every compiled variant of a Triton
    kernel, one line an instruction kind with its count and first
    instance."""
    cache = getattr(kernel, "device_caches", None) or getattr(
        kernel, "cache", {})
    lines = []
    for per_dev in cache.values():
        per_dev = per_dev[0] if isinstance(per_dev, tuple) else per_dev
        for compiled in per_dev.values():
            counts: dict = {}
            for ln in compiled.asm["ptx"].splitlines():
                if PTX_OPS.match(ln):
                    op = ln.split()[0]
                    counts.setdefault(op, [0, ln.strip()])[0] += 1
            lines += [f"{op} x{n}: {first}"
                      for op, (n, first) in counts.items()]
    return lines


def bits(t):
    import torch
    return t.contiguous().view(torch.int32)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("probe_pcps_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.ops import cuda_build, pcps
    print(chip_smoke.card_line())
    stamps_dir = cuda_build.BUILD_DIR / "rows_stamps"
    cuda_build.build_all(("pcps_rows",))
    cuda_build.build_all(("pcps_rows",), STAMPS, stamps_dir)
    for flags, where in (((), None), (STAMPS, stamps_dir)):
        log = cuda_build.library_path("pcps_rows", flags, where)
        print(f"  ptxas {' '.join(flags) or 'default'}: " + "; ".join(
            ln.split(":", 1)[-1].strip()
            for ln in log.with_suffix(".log").read_text(
                errors="replace").splitlines()
            if "registers" in ln or "spill" in ln))

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    failed = []
    for i, (m, c, d, n) in enumerate(SHAPES):
        x = chip_smoke._cnoise(rng, m * c * d * n, dev).reshape(m, c, d, n)
        want = pcps._second_peak_reference(x, m, SPC)
        got = pcps._second_peak_cuda(x, m, SPC)
        torch.cuda.synchronize()
        agree = (torch.equal(bits(got[0]), bits(want[0]))
                 and torch.equal(got[1], want[1])
                 and torch.equal(got[2], want[2]))
        if not agree:
            failed.append(f"K3c M={m} C={c} D={d} N={n}")
        if i == 0:
            k = pcps._kernels()
            for name in ("row", "second_tile", "second_stat"):
                print(f"  Triton {name} PTX:")
                print("\n".join(f"    {ln}" for ln in ptx_ops(k[name])))
        ref, new, ref2, new2 = (chip_smoke.time_ms(
            lambda f=f: f(x, m, SPC)) for f in (
                pcps._second_peak_reference, pcps._second_peak_cuda) * 2)
        row_ms = chip_smoke.time_ms(
            lambda: pcps._row_pass(x, m, "plain", 0, "probe"))
        floor = chip_smoke.time_ms(
            lambda: pcps._second_peak_empty(c, d, dev))
        b_ms, _ = chip_smoke.bound_ms(x.numel() * 8 + c * 12, 0)
        print(f"  K3c M={m} C={c} D={d} N={n} "
              f"({'agrees' if agree else 'DISAGREES'}): {new:.4f} / "
              f"{new2:.4f} ms; replaced {ref:.4f} / {ref2:.4f}, K3's row "
              f"kernel {row_ms:.4f}, an empty kernel on its grid "
              f"{floor:.4f}, bound {b_ms:.4f}")

    stamps_lib = pcps._rows_lib(STAMPS, stamps_dir)
    stamps_lib.pcps_second_peak_stamps.argtypes = [ctypes.c_void_p]
    stamps_lib.pcps_second_peak_stamps.restype = ctypes.c_int
    for m, c, d, n in (SHAPES[0], SHAPES[2]):
        x = chip_smoke._cnoise(rng, m * c * d * n, dev).reshape(m, c, d, n)
        buf = np.zeros((4096, 6), np.uint64)
        with mock.patch.object(pcps, "_rows_lib", lambda: stamps_lib):
            for _ in range(2):         # a warm launch, then the stamped one
                pcps._second_peak_cuda(x, m, SPC)
                torch.cuda.synchronize()
                cuda_build.check(stamps_lib.pcps_second_peak_stamps(
                    buf.ctypes.data), "pcps_second_peak_stamps")
        st = buf[:min(c * d, 4096)].astype(np.int64)
        t0 = st[:, 0].min()
        rel = st[:, 1:5] - st[:, :1]
        fin = st[:, 5][st[:, 5] > 0]
        print(f"  K3c stamps M={m} C={c} D={d} N={n} (ns; the first "
              f"{len(st)} CTAs): CTA starts spread {st[:, 0].max() - t0}; "
              "from a CTA's start, median / max: "
              + "; ".join(f"{name} {int(np.median(rel[:, i]))} / "
                          f"{int(rel[:, i].max())}"
                          for i, name in enumerate(
                              ("loads in", "row max", "row second",
                               "ticket drawn")))
              + f"; from the first start: last ticket "
              f"{int(st[:, 4].max() - t0)}, channels finished "
              f"{int(fin.min() - t0)} to {int(fin.max() - t0)}")

    n = 2000
    for d, w in ((41, 127), (4, 4)):
        x = chip_smoke._cnoise(rng, d * (w + 1) * n, dev).reshape(
            d, (w + 1) * n)
        agree = torch.equal(bits(pcps.pcps_window_fold(x, n)),
                            bits(pcps._window_fold_reference(x, n)))
        if not agree:
            failed.append(f"K7 D={d} L={w}N")
        if (d, w) == (41, 127):
            fold = pcps._kernels()["window_fold"]
            print("  Triton window_fold PTX:\n"
                  + "\n".join(f"    {ln}" for ln in ptx_ops(fold)))
        b_ms, _ = chip_smoke.bound_ms(d * w * n * 8 + d * n * 4, 0)
        tri, new, tri2, new2 = (chip_smoke.time_ms(
            lambda f=f: f(x, n)) for f in (
                pcps._window_fold_reference, pcps.pcps_window_fold) * 2)
        print(f"  K7 D={d} L={w}N ({'agrees' if agree else 'DISAGREES'}): "
              f"{new:.4f} / {new2:.4f} ms; Triton {tri:.4f} / {tri2:.4f}, "
              f"bound {b_ms:.4f}")
    print("probe_pcps_rows: " + ("every kernel agrees" if not failed else
                                 "DISAGREES: " + ", ".join(failed)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
