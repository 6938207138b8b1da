"""Time, on one CUDA card, K5c (pulse blanking) in both forms:

- at 4 M and 104 M samples (phase 4b's length and the 26 s capture's at
  4 Msps), the form it replaced (ops/filters.py _blank_reference: two
  Triton kernels, a torch.sort between them) whole and by its three
  stages (the window powers, the threshold: the sort and the median's
  small torch operations, the blanking), the CUDA kernel
  (csrc/pulse_blank.cu) whole, and what each form runs on the card a call
  with each operation's device time (torch.profiler);
- the kernel built with -DBLANK_PROBE at 1 M, 4 M and 104 M: %globaltimer
  stamps of one call (each launch's first start and last end, the
  selection's stages on its CTA 0) from the power pass's start;
- the kernel built with its selection's cluster forced to 1, 2, 4, 8 and
  16 CTAs (-DBLANK_SELECT_CTAS), timed in turns at 1 M, 4 M, 26 M and
  104 M.

    python3 tools/probe_blanking.py

The streams are chip_smoke.blank_stream's noise with pulses over some
windows; every form and build must give the plain version's output
sample for sample, and the kernel's threshold must be _blank_threshold
of its own window powers bit for bit.
Times by CUDA graph replay (chip_smoke.time_ms); prints the card's name
and power limit, the library's ptxas lines and the bound (16 N bytes +
8 N / 64 over 3.35 TB/s).  Exit 1 when anything disagrees.  Needs the
card (~2 min); imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (4_000_000, 104_000_000)
TH, WINDOW = 4.0, 64
SIZES = (1, 2, 4, 8, 16)
STAGES = ("top bins found", "second digit counted", "cluster barrier",
          "second digit found", "last digit counted", "cluster barrier",
          "threshold formed")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("probe_blanking: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gnss_sim_receiver_tpu_torch.ops import cuda_build, filters
    print(chip_smoke.card_line())
    variants = {"probe": ("-DBLANK_PROBE",),
                **{c: (f"-DBLANK_SELECT_CTAS={c}",) for c in SIZES}}
    dirs = {k: cuda_build.BUILD_DIR / f"blank_{k}" for k in variants}
    builds = [threading.Thread(target=cuda_build.build_all,
                               args=(("pulse_blank",), variants[k], dirs[k]))
              for k in variants]       # one nvcc each, all at once
    for b in builds:
        b.start()
    filters._blank_lib()
    for b in builds:
        b.join()
    log = cuda_build.library_path("pulse_blank").with_suffix(
        ".log").read_text(errors="replace")
    print("  " + "; ".join(ln.split(":", 1)[-1].strip()
                           for ln in log.splitlines() if "registers" in ln))
    libs = {k: _typed(cuda_build.load("pulse_blank", variants[k], dirs[k]))
            for k in variants}
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    bad = 0
    for n in LENGTHS:
        bad += both_forms(chip_smoke, filters,
                          chip_smoke.blank_stream(rng, dev, n, "pulses"))
    for n in (1_000_000, *LENGTHS):
        bad += stamps(libs["probe"], filters,
                      chip_smoke.blank_stream(rng, dev, n, "pulses"))
    for n in (1_000_000, 4_000_000, 26_000_000, 104_000_000):
        bad += cluster_sizes(chip_smoke, libs, filters,
                             chip_smoke.blank_stream(rng, dev, n, "pulses"))
    print(f"probe_blanking: {'every form agrees' if not bad else 'FAILED'}")
    return 1 if bad else 0


def _typed(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pulse_blank.argtypes = [p, ll, i, ctypes.c_float, p, p, p, p, p]
    return lib


def _call(lib, x):
    """One call of a variant build on x: (a callable, its output)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    n = x.shape[0]
    out = torch.empty_like(x)
    pw = torch.empty(n // WINDOW, device=x.device)
    thr = torch.empty(1, device=x.device)
    hist = torch.zeros(2048, dtype=torch.int32, device=x.device)
    th2 = float(np.float32(TH) * np.float32(TH))

    def call():
        cuda_build.check(lib.pulse_blank(
            x.data_ptr(), n, WINDOW, th2, out.data_ptr(), pw.data_ptr(),
            thr.data_ptr(), hist.data_ptr(),
            torch.cuda.current_stream().cuda_stream),
            "pulse_blank (a probe build)")
    return call, out


def both_forms(chip_smoke, filters, x) -> int:
    """Both forms on x against the plain version, timed, the replaced
    form by stage, and each form's device operations.  Returns 1 when a
    form disagrees."""
    import torch
    n = x.shape[0]
    want = filters._blank_plain(x, TH, WINDOW)
    got, pw, thr = filters._blank_cuda(x, TH, WINDOW)
    ref = filters._blank_reference(x, TH, WINDOW)
    thr_want = filters._blank_threshold(pw, TH).reshape(1)
    torch.cuda.synchronize()
    ok = (torch.equal(got, want) and torch.equal(ref, want)
          and torch.equal(thr.view(torch.int32), thr_want.view(torch.int32)))
    _, (power, threshold, blank) = filters._blank_reference_stages(
        x, TH, WINDOW)
    power()
    threshold()                     # the blanking reads its threshold
    parts = {name: chip_smoke.time_ms(fn, 5)
             for name, fn in (("power", power), ("threshold", threshold),
                              ("blank", blank))}
    ref_ms = chip_smoke.time_ms(
        lambda: filters._blank_reference(x, TH, WINDOW), 5)
    ms = chip_smoke.time_ms(lambda: filters.pulse_blanking(x, TH, WINDOW), 5)
    bound = chip_smoke.bound_ms(16 * n + 8 * (n // WINDOW), 5 * n)[0]
    print(f"  N={n}: {'agrees' if ok else 'DISAGREES'}; kernel {ms:.4f} ms "
          f"({ms / bound:.2f} x the bound {bound:.4f}); replaced form "
          f"{ref_ms:.4f} ms: power {parts['power']:.4f}, threshold "
          f"{parts['threshold']:.4f}, blank {parts['blank']:.4f}")
    for label, fn in (
            ("kernel", lambda: filters.pulse_blanking(x, TH, WINDOW)),
            ("replaced form",
             lambda: filters._blank_reference(x, TH, WINDOW))):
        ops = chip_smoke.device_ops(fn)
        print(f"    {label}: {sum(c for c, _ in ops.values()):.0f} device "
              f"operations a call, {sum(u for _, u in ops.values()):.1f} us "
              "(profiler):")
        for name, (c, us) in sorted(ops.items(), key=lambda kv: -kv[1][1]):
            print(f"      {c:.0f} x {name[:90]}: {us:.1f} us")
    return 0 if ok else 1


def stamps(lib, filters, x) -> int:
    """One call of the -DBLANK_PROBE build on x: the launches' spans and
    the selection's stages in microseconds from the power pass's start.
    Returns 1 when its output differs from the plain version's."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    lib.pulse_blank_probe_read.argtypes = [ctypes.c_void_p]
    call, out = _call(lib, x)
    call()
    torch.cuda.synchronize()
    ok = torch.equal(out, filters._blank_plain(x, TH, WINDOW))
    buf = (ctypes.c_ulonglong * lib.pulse_blank_probe_words())()
    cuda_build.check(lib.pulse_blank_probe_reset(), "probe reset")
    call()
    torch.cuda.synchronize()
    cuda_build.check(lib.pulse_blank_probe_read(buf), "probe read")
    t = [(v - buf[0]) / 1e3 for v in buf]
    stages = ", ".join(f"{name} {v:.2f}" for name, v in zip(STAGES, t[6:13]))
    print(f"  N={x.shape[0]}, stamps (us from the power pass's start): "
          f"power ends {t[1]:.2f}; selection {t[2]:.2f} to {t[3]:.2f} "
          f"({stages}); zeroing {t[4]:.2f} to {t[5]:.2f}")
    return 0 if ok else 1


def cluster_sizes(chip_smoke, libs, filters, x) -> int:
    """The builds with the selection's cluster forced to each of SIZES
    CTAs on x, timed in turns (sizes up, then down).  Returns the number
    of builds whose output differed from the plain version's."""
    import torch
    want = filters._blank_plain(x, TH, WINDOW)
    calls, bad = {}, 0
    for c in SIZES:
        calls[c], out = _call(libs[c], x)
        calls[c]()
        torch.cuda.synchronize()
        bad += not torch.equal(out, want)
    reps = 5 if x.shape[0] > 30_000_000 else 20
    ms = {c: [] for c in SIZES}
    for c in SIZES + SIZES[::-1]:
        ms[c].append(chip_smoke.time_ms(calls[c], reps))
    print(f"  N={x.shape[0]}, the selection's cluster forced: " + "; ".join(
        f"{c} CTAs {ms[c][0]:.4f} / {ms[c][1]:.4f} ms" for c in SIZES))
    return bad


if __name__ == "__main__":
    sys.exit(main())
