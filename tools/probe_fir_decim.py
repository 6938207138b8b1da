"""Sweep, on one CUDA card, the outputs a thread (R) of K5a's blocked
kernel (csrc/fir_decim.cu) at each decimation it serves.

    python3 tools/probe_fir_decim.py [--n SAMPLES] [--taps T]

Builds the fir_decim library once per R (nvcc -DFIR_R_DEC<dec>=R, each
build in a directory of its own under build/torch_kernels/), then at N
samples of complex noise (default 104,000,000: phase 4's 26 s capture at
4 Msps) and T taps (default 31) checks each build's output bit for bit
against the kernel before its redesign (fir_decim_reference) and times
both by CUDA graph replay (chip_smoke.time_ms), in turns: reference, R
values in order, reference again.  Prints the card's name and power
limit, the ptxas line of every build (registers, spills) and one line a
(decimation, R): ms, the bound (bytes once over 3.35 TB/s) and ms over
the bound.  Exit 1 when a build differs from the reference.  Needs the
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SWEEP = {1: (4, 8, 12), 2: (2, 4, 6, 8), 4: (2, 4, 6)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=104_000_000)
    ap.add_argument("--taps", type=int, default=31)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("probe_fir_decim: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.ops import cuda_build, filters
    print(chip_smoke.card_line())
    builds = {}
    for dec, rs in SWEEP.items():
        for r in rs:
            flag = (f"-DFIR_R_DEC{dec}={r}",)
            where = cuda_build.BUILD_DIR / f"fir_r{dec}_{r}"
            builds[dec, r] = (flag, where)
    # every variant's nvcc at once
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda fw: cuda_build.build_all(("fir_decim",), *fw),
                      builds.values()))
    for (dec, r), (flag, where) in builds.items():
        log = cuda_build.library_path("fir_decim", flag, where).with_suffix(
            ".log").read_text(errors="replace")
        name, regs = "", []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                name = ln
            elif "registers" in ln and f"ILi{dec}ELi{r}E" in name:
                regs.append(ln.split(":", 1)[-1].strip())
        if not regs:
            print(f"  dec {dec}, R {r}: the build holds no such kernel")
            return 1
        print(f"  dec {dec}, R {r}: " + "; ".join(regs))

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((args.n, 2)).astype(np.float32))
    x = torch.view_as_complex(x).to(dev)
    taps = torch.from_numpy(filters.design_lowpass(args.taps, 0.45)).to(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bad = 0
    for dec, rs in SWEEP.items():
        n_out = -(-args.n // dec)
        out = torch.empty(n_out, dtype=torch.complex64, device=dev)

        def call(lib, symbol="fir_decim"):
            err = getattr(lib, symbol)(
                x.data_ptr(), args.n, taps.data_ptr(), args.taps, dec, 0.0,
                0, out.data_ptr(), n_out, stream())
            cuda_build.check(err, symbol)
            return out
        libs = {}
        for r in rs:
            lib = cuda_build.load("fir_decim", *builds[dec, r])
            p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_longlong)
            for fn in (lib.fir_decim, lib.fir_decim_reference):
                fn.argtypes = [p, ll, p, i, i, f, i, p, ll, p]
                fn.restype = ctypes.c_int
            libs[r] = lib
        first = libs[rs[0]]
        ref = call(first, "fir_decim_reference").clone()
        ms = {}
        for r, lib in libs.items():
            got = call(lib)
            torch.cuda.synchronize()
            same = torch.equal(chip_smoke.bits(got), chip_smoke.bits(ref))
            bad += not same
            print(f"  dec {dec}, R {r}: "
                  f"{'bit for bit' if same else 'DIFFERS FROM'} the "
                  "reference")
        ref_ms = [chip_smoke.time_ms(
            lambda: call(first, "fir_decim_reference"), reps=3)]
        for r, lib in libs.items():
            ms[r] = chip_smoke.time_ms(lambda: call(lib), reps=3)
        ref_ms.append(chip_smoke.time_ms(
            lambda: call(first, "fir_decim_reference"), reps=3))
        bound = (8 * args.n + 8 * n_out + 4 * args.taps) / 3.35e12 * 1e3
        print(f"  dec {dec} (N={args.n}, T={args.taps}): reference "
              f"{ref_ms[0]:.4f} / {ref_ms[1]:.4f} ms; bound {bound:.4f} ms")
        for r, t in ms.items():
            print(f"  dec {dec}, R {r}: {t:.4f} ms, {t / bound:.2f} x the "
                  "bound")
        del out, ref
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
