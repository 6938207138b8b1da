#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GPS receiver on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. build every kernel of the main path from the sources in this checkout
   (the CUDA C++ libraries, one ``nvcc`` per source in parallel, and the
   Triton kernels by a first launch);
3. each kernel against its plain PyTorch version on the card at the shapes
   of the main path, with the stated tolerance, and its time beside the
   plain version's;
4. the main path: a 26 s GPS L1 C/A capture at 2 Msps (the repo's static
   scenario, synthesized by the port's own simulator and cached under
   ``build/``) through ``Receiver(ReceiverConf(fs=2e6, prns=1..10,
   max_channels=8)).process_array(x)``, with every kernel's launch counter
   set to 0 just before and read just after; the tracked PRNs, the fix
   count and the mean position error are checked against the scenario.

The line before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Needs one card; imports nothing
of JAX.  ``--profile`` adds a torch.profiler breakdown of a second run of
the main path (device busy share, time by kernel).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate and the float32 rate
# outside the tensor cores; the bounds below are stated against these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SCENARIO_PRNS = (1, 3, 4, 5, 9, 10)
T0 = 345600.0
DUR = 26.0
FS = 2_000_000.0
RX_LLH = (40.0, -75.0, 100.0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of `fn`: `reps` calls captured in a
    CUDA graph and replayed (so the host's launch cost is not counted),
    the median of 5 replays by CUDA events, over `reps`."""
    import torch
    fn()                                  # compiles, cuFFT plans, pool
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def compare(name, got, want, rtol: float) -> float:
    """Max abs error of `got` against `want`; fails above rtol * max|want|
    for floats, on any difference for integers."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.isfinite(g.to(torch.complex64)).all():
            fail(f"{name}: non-finite output")
        if not (g.is_floating_point() or g.is_complex()):
            if not torch.equal(g, w):
                fail(f"{name}: integer outputs differ: {g} vs {w}")
            continue
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        print(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e}, "
              f"tolerance {rtol:g} x that)")
        if err > rtol * scale:
            fail(f"{name}: error {err:.3e} above {rtol * scale:.3e}")
        worst = max(worst, err)
    return worst


# ---- phase 3: each kernel against its plain version ------------------------

def check_k1(dev, rng):
    """K1 at the main-path shape: C=8 channels, E=20 epochs, K=3 taps,
    F=4096 bins, the window spectra of a 1000-epoch chunk."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    conf = trk.TrackingConf(fs=FS)
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    c, e, k = 8, 20, 3
    n = 1000 * s0 + nfft + 512
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64)).to(dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    n_wins = xf_all.shape[0]
    rf = torch.from_numpy((rng.standard_normal((c, nfft))
                           + 1j * rng.standard_normal((c, nfft))
                           ).astype(np.complex64)).to(dev)
    w0 = torch.from_numpy(rng.integers(0, n_wins - e, c).astype(np.int32)
                          ).to(dev)
    lag = rng.uniform(16.0, 16.0 + s0, (c, e)).astype(np.float32)
    lag_int = np.round(lag).astype(np.int32)
    args = (xf_all, rf, w0, torch.from_numpy(lag_int).to(dev),
            torch.from_numpy((lag - lag_int).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0, 650, (c, e)).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(np.outer(rng.uniform(0.97, 0.99, c),
                                      [-0.25, 0.0, 0.25]).astype(np.float32)
                             * np.float32(FS / 1.023e6)).to(dev),
            torch.from_numpy(rng.uniform(-0.016, 0.016, c).astype(np.float32)
                             ).to(dev))
    got = tb.block_correlate(*args)
    want = tb._block_correlate_plain(*args)
    torch.cuda.synchronize()
    err = compare("K1 block_correlate", got, want, 1e-4)
    ms = time_ms(lambda: tb.block_correlate(*args))
    plain = time_ms(lambda: tb._block_correlate_plain(*args), reps=3)
    rows = len({int(w) + i for w in w0.tolist() for i in range(e)})
    n_bytes = rows * nfft * 8 + c * nfft * 8 + c * e * (4 * 3) + c * e * k * 8
    # per (c, e, f): lag angle 4, sincos 2, two complex products 12;
    # per tap: angle 3, sincos 2, complex multiply-accumulate 8
    n_ops = c * e * nfft * (18 + k * 13)
    return dict(name="K1_block_correlate", route="cuda",
                source="gnss_sim_receiver_tpu_torch/csrc/block_correlator.cu",
                replaces="gnss_sim_receiver_tpu/models/tracking_block.py:148",
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(n_bytes, n_ops))))


def check_k2(dev, rng):
    """K2 at the main-path shape: C=8 channels, B=2048-sample blocks, K=3
    taps, 1023x8 band-limited tables."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.ops import correlator, prn_codes
    conf = trk.TrackingConf(fs=FS)
    c, b = 8, conf.block_size
    n = 1 << 18
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64)).to(dev)
    codes = torch.from_numpy(np.stack([
        prn_codes.bandlimited_table_normalized(
            prn_codes.gps_l1_ca_code(p), FS, conf.code_rate_cps, 2000, 8)
        for p in range(1, c + 1)])).to(dev)
    taps = torch.tensor([0.25, 0.0, -0.25], dtype=torch.float32, device=dev)

    def t(a, dt=np.float32):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)
    args = (x, t(rng.integers(0, n - b, c), np.int32), b, codes, taps,
            t(rng.uniform(0, 1, c)), t(1.023e6 + rng.uniform(-5, 5, c)),
            t(rng.uniform(0, 2 * np.pi, c)), t(rng.uniform(-5000, 5000, c)),
            t(rng.integers(1999, 2002, c), np.int32), FS, 8)
    got = correlator.multicorrelate(*args)

    def plain():
        return correlator.correlate_multitap(
            correlator.gather_blocks(x, args[1], b), codes, taps, *args[5:])
    want = plain()
    torch.cuda.synchronize()
    err = compare("K2 multicorrelate", got, want, 1e-4)
    ms = time_ms(lambda: correlator.multicorrelate(*args))
    plain_ms = time_ms(plain)
    n_samp = int(args[9].sum())
    n_bytes = c * b * 8 + codes.numel() * 4 + c * 3 * 8
    # per sample: phase 3, sincos 2, wipeoff 6, chips 3; per tap: index 3,
    # multiply-accumulate 4
    n_ops = n_samp * (14 + 3 * 7)
    return dict(name="K2_multicorrelate", route="cuda",
                source="gnss_sim_receiver_tpu_torch/csrc/multicorrelator.cu",
                replaces="gnss_sim_receiver_tpu/ops/correlator.py:39",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(n_bytes, n_ops))))


def acq_dwells(dev):
    """2 ms of the static scenario (6 satellites) for the K3 checks."""
    import torch
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        generate_baseband
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in SCENARIO_PRNS]
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, 1.0,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(sats, FS, 4000, noise=True, seed=42,
                          bandlimit_oversample=4)
    return torch.from_numpy(x.astype(np.complex64)).to(dev).reshape(2, 2000)


def check_k3(dev):
    """K3 (both kernels) at the main-path shape: M=2 dwells, D=41 Doppler bins,
    N=2000 samples, C=8 channels (PRNs 1-8)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    acq = AcqConf(fs_in=FS, max_dwells=2)
    x = acq_dwells(dev)
    cfc = torch.from_numpy(code_replicas(acq, range(1, 9))).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    t = pcps.time_axis(2000, FS, dev)
    m, n, d, c = 2, 2000, dops.shape[0], cfc.shape[0]
    out = []

    got = pcps.pcps_wipe(x, dops, t)
    want = pcps._wipe_plain(x, dops, t)
    torch.cuda.synchronize()
    err = compare("K3 pcps_wipe", got, want, 1e-5)
    n_bytes = m * n * 8 + d * 4 + n * 4 + m * d * n * 8
    n_ops = m * d * n * (2 + 2 + 6)      # phase 2, sincos 2, product 6
    out.append(dict(
        name="K3_pcps_wipe", route="triton",
        source="gnss_sim_receiver_tpu_torch/ops/pcps.py",
        replaces="gnss_sim_receiver_tpu/ops/pcps.py:33", max_abs_err=err,
        ms=time_ms(lambda: pcps.pcps_wipe(x, dops, t)),
        plain_ms=time_ms(lambda: pcps._wipe_plain(x, dops, t)),
        library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, n_ops)))))

    spec = torch.fft.fft(want, dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    got = pcps.pcps_peak(corr, m)
    want = pcps._peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare("K3 pcps_peak", got, want, 1e-4)
    n_bytes = m * c * d * n * 8 + c * 12
    n_ops = m * c * d * n * 3 + c * d * n * 2   # |.|^2 3, sum + compare 2
    out.append(dict(
        name="K3_pcps_peak", route="triton",
        source="gnss_sim_receiver_tpu_torch/ops/pcps.py",
        replaces="gnss_sim_receiver_tpu/ops/pcps.py:107", max_abs_err=err,
        ms=time_ms(lambda: pcps.pcps_peak(corr, m)),
        plain_ms=time_ms(lambda: pcps._peak_plain(corr, m)),
        library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, n_ops)))))

    # the whole search: port (wipeoff, cuFFT, peak) beside torch.fft + torch ops
    port = time_ms(lambda: pcps.pcps_search(x, cfc, dops, t))
    torch_ops = time_ms(lambda: pcps.max_to_input_power_stat(
        pcps.pcps_grid(x, cfc, dops, FS), 2.0))
    got = pcps.pcps_search(x, cfc, dops, t)
    want = pcps.max_to_input_power_stat(pcps.pcps_grid(x, cfc, dops, FS), 2.0)
    compare("K3 pcps_search", got, want, 1e-4)
    print(f"  K3 search (M={m}, D={d}, N={n}, C={c}): port {port:.4f} ms, "
          f"torch.fft + torch ops yardstick {torch_ops:.4f} ms")
    return out


# ---- phase 4: the main path ------------------------------------------------

def rx_true_ecef():
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    return geodesy.llh_to_ecef(np.radians(RX_LLH[0]), np.radians(RX_LLH[1]),
                               RX_LLH[2])


def scenario_capture(root: str) -> np.ndarray:
    """The 26 s static scenario (6 satellites, 47 dB-Hz), cached."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        generate_baseband
    path = os.path.join(root, "build", "static_scenario_26s_v2.npy")
    if os.path.exists(path):
        return np.load(path)
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in SCENARIO_PRNS]
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, DUR,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(sats, FS, int(FS * DUR), noise=True, seed=42,
                          bandlimit_oversample=4)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path + ".tmp.npy", x)
    os.replace(path + ".tmp.npy", path)
    return x


def main_path(root: str, wrappers) -> dict:
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    t0 = time.perf_counter()
    x = scenario_capture(root)
    print(f"  capture: {len(x)} samples ({x.nbytes / 1e6:.0f} MB), "
          f"{time.perf_counter() - t0:.1f} s to synthesize or load")
    rx = Receiver(ReceiverConf(fs=FS, prns=tuple(range(1, 11)),
                               max_channels=8))
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = rx.process_array(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    tracked = sorted(p for p, s in zip(run.channel_prns, run.channel_states)
                     if s == ChannelState.TRACKING)
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    rx_true = rx_true_ecef()
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                    for s in run.solutions]).reshape(-1, 3)
    if not np.isfinite(enu).all():
        fail("non-finite position")
    err_2d = float(np.linalg.norm(enu.mean(0)[:2])) if len(enu) else np.inf
    err_3d = float(np.linalg.norm(enu.mean(0))) if len(enu) else np.inf
    print(f"  tracked PRNs {tracked}, {len(run.ephemerides)} ephemerides, "
          f"{len(run.solutions)} fixes, mean error 2D {err_2d:.3f} m, "
          f"3D {err_3d:.3f} m")
    print(f"  wall {wall:.3f} s for {DUR:.0f} s of signal: real-time factor "
          f"{DUR / wall:.3f}")
    print(f"  launches: {launches}")
    if tracked != list(SCENARIO_PRNS):
        fail(f"tracked PRNs {tracked}, expected {list(SCENARIO_PRNS)}")
    if len(run.solutions) < 5:
        fail(f"only {len(run.solutions)} fixes")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return launches


def profile_main_path(root: str) -> None:
    """`--profile`: the main path twice more, plain and under
    torch.profiler: wall time, device busy share (kernel time over wall),
    device time by kernel and host time by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    x = scenario_capture(root)
    rx = Receiver(ReceiverConf(fs=FS, prns=tuple(range(1, 11)),
                               max_channels=8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rx.process_array(x)
    torch.cuda.synchronize()
    print(f"  unprofiled second run: wall {time.perf_counter() - t0:.3f} s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rx.process_array(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in avgs) / 1e6
    n_ops = sum(e.count for e in avgs if e.key.startswith("aten::"))
    print(f"  profiled run: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f} %), {n_ops} aten operator calls")
    for e in sorted(avgs, key=dev_us, reverse=True)[:15]:
        print(f"    {dev_us(e) / 1e3:10.1f} ms  {e.count:8d}x  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"    host {e.self_cpu_time_total / 1e3:10.1f} ms  "
              f"{e.count:8d}x  {e.key[:80]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))

    print("== phase 1: card", flush=True)
    card = card_line()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import correlator, cuda_build, pcps

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all()
    for name, s in secs.items():
        log = cuda_build.library_path(name).with_suffix(".log").read_text(
            errors="replace") if s else ""
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: nvcc {s:.1f} s; {'; '.join(regs)}")
    print(f"  CUDA libraries built in {time.perf_counter() - t0:.1f} s "
          "(parallel)", flush=True)

    print("== phase 3: kernels against their plain versions", flush=True)
    rng = np.random.default_rng(1234)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rows = [check_k1(dev, rng), check_k2(dev, rng), *check_k3(dev)]
    print(f"  phase 3 took {time.perf_counter() - t0:.1f} s (includes the "
          "Triton compiles)", flush=True)

    print("== phase 4: main path", flush=True)
    wrappers = {"K1_block_correlate": tb.block_correlate,
                "K2_multicorrelate": correlator.multicorrelate,
                "K3_pcps_wipe": pcps.pcps_wipe,
                "K3_pcps_peak": pcps.pcps_peak}
    launches = main_path(root, wrappers)
    for r in rows:
        r["launches"] = launches[r["name"]]
    if "--profile" in sys.argv[1:]:
        print("== profile of the main path", flush=True)
        profile_main_path(root)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
