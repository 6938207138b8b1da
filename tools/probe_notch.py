"""Time, on one CUDA card, K5b's single-pass scan (csrc/notch.cu) with
tiles of 1 and 4 sub-tiles, as built and dividing by g; then time its
sections.

    python3 tools/probe_notch.py [--n SAMPLES ...]

Builds the notch library as it is, with the output divided by g (IEEE)
instead of multiplied by 1/g (-DNOTCH_DIVIDE) and with -DNOTCH_PROBE,
each in a directory of its own under build/torch_kernels/, every nvcc
at once.  At each length N (by default 1 M + 5, 4 M and 104 M samples:
phase 4b's, phase 4b's conditioner input and the 26 s capture at 4 Msps)
of complex noise with a continuous wave on the notch (f0 0.1, bw 0.01)
it checks every build with tiles of 1 and 4 sub-tiles against the
three-launch kernel the scan replaced (notch_filter_reference) within
1e-4 of the output's scale, also after CUDA graph replays (the tile
status is reused), and times them all by CUDA graph replay
(chip_smoke.time_ms) in turns: reference, the builds, reference again.
Short lengths (1, 2, 3, one tile of each length and a sample either
side of it) are checked against the plain version, at bw 0.01 and at
the narrow notch's 0.0005.  Prints the card's name and power limit, the
ptxas line of every build (registers, spills), one line a (N, build,
tile length): ms, the bound (16 N bytes over 3.35 TB/s) and ms over the
bound; then, for the probe build at the longest N with each tile
length, each section of a CTA's life in clock64 cycles (median, 90th
percentile, mean over the tiles), the look-back's steps and polls, the
launch's span and the mean number of CTAs in flight (%globaltimer).
Exit 1 when a build disagrees.  Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the builds: the library's, and a variant by an nvcc flag
BUILDS = {"the library's": (), "dividing by g": ("-DNOTCH_DIVIDE",)}
SUBS = (1, 4)               # sub-tiles a tile
# (name, stamp from, stamp to) of notch.cu's probe build
SECTIONS = (("ticket", 0, 1), ("the first sub-tile's load", 1, 2),
            ("zero-state pass over the sub-tiles", 2, 3),
            ("aggregate published", 3, 4),
            ("look-back (its own warp, from the ticket)", 1, 5),
            ("wait for the carry after the aggregate", 4, 6),
            ("rerun and store", 6, 7), ("whole tile", 0, 7))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+",
                    default=[(1 << 20) + 5, 4_000_000, 104_000_000])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("probe_notch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.ops import cuda_build, filters
    print(chip_smoke.card_line())

    builds = {name: (flags, cuda_build.BUILD_DIR / f"notch_variant{i}")
              for i, (name, flags) in enumerate(BUILDS.items())}
    probe_build = (("-DNOTCH_PROBE",), cuda_build.BUILD_DIR / "notch_probe")
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(len(builds) + 1) as pool:
        list(pool.map(lambda fw: cuda_build.build_all(("notch",), *fw),
                      [*builds.values(), probe_build]))
    libs = {}
    for name, (flags, where) in builds.items():
        log = cuda_build.library_path("notch", flags, where).with_suffix(
            ".log").read_text(errors="replace")
        entry, regs = "", []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln
            elif "registers" in ln and "notch_scan" in entry:
                sub = re.search(r"notch_scan_kernelILi(\d)", entry)
                regs.append(f"{sub[1] if sub else '?'} sub-tiles: "
                            + ln.split(":", 1)[-1].strip())
        print(f"  {name}: " + "; ".join(regs))
        libs[name] = filters._notch_lib(flags, where)
    sub_tile = (libs["the library's"].notch_tile_threads()
                * libs["the library's"].notch_per_thread())

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    f0 = 0.1
    bad = 0

    def signal(n):
        x = rng.standard_normal((n, 2)).astype(np.float32)
        x = torch.view_as_complex(torch.from_numpy(x)).to(dev)
        return x + 10.0 * torch.exp(2j * np.pi * f0 * torch.arange(
            n, device=dev, dtype=torch.float64)).to(torch.complex64)

    def check(what, got, want) -> None:
        nonlocal bad
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= 1e-4 * scale
        bad += not ok
        if not ok:
            print(f"  {what}: error {err:.3e} of scale {scale:.3e} "
                  "DISAGREES")

    # every build with tiles of every sub-tile count
    runs = [(name, sub) for name in BUILDS for sub in SUBS]
    short = sorted({1, 2, 3, *(sub_tile * sub + d for sub in SUBS
                               for d in (-1, 0, 1))})
    for bw in (0.01, 0.0005):
        coef = filters.notch_coefficients(f0, bw)
        for n in short:
            x = signal(n)
            want = filters._notch_plain(x, *coef)
            for name, sub in runs:
                check(f"N={n} bw={bw} {name} sub {sub}",
                      filters._notch_scan(libs[name], x, *coef, sub=sub),
                      want)
    print(f"  short lengths {short[0]} to {short[-1]}: "
          f"{'all agree' if not bad else f'{bad} disagree'}")
    coef = filters.notch_coefficients(f0, 0.01)
    for n in args.n:
        x = signal(n)
        ref = filters._notch_reference(x, f0, 0.01)
        reps = 20 if n < 10_000_000 else 3
        for name, sub in runs:
            check(f"N={n} {name} sub {sub}",
                  filters._notch_scan(libs[name], x, *coef, sub=sub), ref)
        ref_ms = [chip_smoke.time_ms(
            lambda: filters._notch_reference(x, f0, 0.01), reps)]
        ms = {(name, sub): chip_smoke.time_ms(
            lambda: filters._notch_scan(libs[name], x, *coef, sub=sub), reps)
            for name, sub in runs}
        ref_ms.append(chip_smoke.time_ms(
            lambda: filters._notch_reference(x, f0, 0.01), reps))
        for name, sub in runs:
            check(f"N={n} {name} sub {sub} after the graph replays",
                  filters._notch_scan(libs[name], x, *coef, sub=sub), ref)
        bound = 16 * n / 3.35e12 * 1e3
        print(f"  N={n}: the replaced kernel {ref_ms[0]:.4f} / "
              f"{ref_ms[1]:.4f} ms; bound {bound:.4f} ms; tiles of "
              f"{filters.notch_sub_tiles(n, sub_tile)} "
              "sub-tiles by default")
        for (name, sub), t in ms.items():
            print(f"  N={n}, {name}, {sub} sub-tiles: {t:.4f} ms, "
                  f"{t / bound:.2f} x the bound")
        del x, ref
        torch.cuda.empty_cache()
    for sub in SUBS:
        sections(filters._notch_lib(*probe_build), signal(max(args.n)), coef,
                 sub)
    print(f"probe_notch: {'every build agrees' if not bad else 'FAILED'}")
    return 1 if bad else 0


def sections(lib, x, coef, sub) -> None:
    """One launch of the probe build on x with tiles of `sub` sub-tiles
    (after one to warm up): its stamps, summarised."""
    import ctypes

    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    lib.notch_probe_words.restype = ctypes.c_longlong
    lib.notch_probe_read.argtypes = [ctypes.c_void_p]
    filters._notch_scan(lib, x, *coef, sub=sub)
    filters._notch_scan(lib, x, *coef, sub=sub)
    torch.cuda.synchronize()
    words = np.zeros(lib.notch_probe_words(), np.uint64)
    err = lib.notch_probe_read(words.ctypes.data)
    if err:
        raise RuntimeError(f"notch_probe_read: CUDA error {err}")
    n_tiles = -(-x.shape[0] // (lib.notch_tile_threads()
                                * lib.notch_per_thread() * sub))
    st = words.reshape(-1, 12)[:n_tiles].astype(np.int64)
    print(f"  sections of the probe build at N={x.shape[0]}, {sub} "
          f"sub-tiles a tile ({n_tiles} tiles; clock64 cycles: median / "
          "p90 / mean):")
    for name, a, b in SECTIONS:
        c = st[:, b] - st[:, a]
        print(f"    {name}: {np.median(c):.0f} / {np.percentile(c, 90):.0f}"
              f" / {c.mean():.0f}")
    life = st[:, 7] - st[:, 0]
    steps, polls = st[:, 11] >> 32, st[:, 11] & 0xffffffff
    print(f"  look-back steps a tile: mean {steps.mean():.2f}, max "
          f"{steps.max()}; polls beyond the first read: mean "
          f"{polls.mean():.1f}, max {polls.max()}")
    ns = st[:, 9] - st[:, 8]
    span = st[:, 9].max() - st[:, 8].min()
    print(f"  launch span {span / 1e3:.1f} us by %globaltimer; a CTA "
          f"{np.median(ns) / 1e3:.2f} us median, {ns.mean() / 1e3:.2f} "
          f"mean; CTAs in flight {ns.sum() / span:.0f} on average over "
          f"{len(set(st[:, 10].tolist()))} SMs; SM clock "
          f"{np.median(life / np.maximum(ns, 1)) * 1e3:.0f} MHz")


if __name__ == "__main__":
    sys.exit(main())
