#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GNSS receiver on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. build every kernel from the sources in this checkout (the CUDA C++
   libraries, one ``nvcc`` per source in parallel, and the block library
   a second time with ``--fmad=false`` into a directory of its own; the
   Triton kernels compile at their first launch).  Two child processes
   meanwhile synthesize the captures of phases 4 and 4c into ``build/``
   (outside every timed window);
3. each kernel (the per-epoch closure K9 first, at four shapes, with
   K2's data-table form; then the chunk kernel, K9 redesigned as one
   launch per chunk, against the two-launch chunk, K2 then K9 per epoch,
   bit for bit over 50 epochs at four shapes, timed per chunk and per
   epoch by graph replay and on the host, then at C = 300 channels, more
   than the card keeps resident, in waves of clusters, and a 50-epoch
   chunk of phase 8's E1 pilot chain through it and through the plain
   loop; the block
   step K8a and K8b next, at four shapes, bit for bit against their plain
   versions and against the --fmad=false build, each with K1 and K8b
   fused held bit for bit against K1 then K8b, and with the next block's
   prologue folded in against K1, K8b, then K8a; the two-launch block
   chunk (K8a once, then the cuFFT and the folded launch per block)
   against the three-launch chunk and the plain chunk, bit for bit over
   50 blocks at the same four shapes; K1 and
   K2 with the GPS and the Galileo E1 tables, K3 wipeoff and peak, K3b,
   K4a in both modes, K4b fold and resolve, K4c with and without its
   Doppler boxcar, K3c (the first-vs-second-peak statistic) in its plain,
   dual and CAF forms on K3's, K4a's and K4c's correlations, K5a, K5b,
   K5c, K5d in both modes, K6 (also bit for bit the kernel before its
   redesign, one thread per sample, noiseless and with the phases' noise
   key, on the first and the last chunk of the hybrid, full-chain and
   wideband scenarios; both timed), K3's row kernel alone at phase 9's
   Doppler-sharded shape, K7's overlap-save fold at phase 9's shape
   and at L = 4 N, K10a and K10b, the sigma-point filters' kernels, at
   4096 filters of 4 and of 9 states under both rules, beside
   torch.linalg.cholesky_ex and solve_ex) against its
   plain PyTorch version on the card at the shape its path
   launches it at, with the stated tolerance, and its time there beside
   the plain version's and its bound (K1 and K2, which split each channel
   over S CTAs and reduce in-launch, also launched twice for bit-identical
   results, their arrival counters read back at 0 after the timing, K1
   with two window starts out of range, K2's staged-table misses
   printed); other shapes of the same kernels
   (the ``other_shapes`` line: among them K1, K2, K3, K3b and K6 at phase
   7's shapes, and K3's peak at phase 5's GPS search, N = 20000); once
   phase 4's capture is written, one 50-block chunk of
   phase 4's path through the kernels and through the plain block body;
4. the main path, conf-driven: the repo's 26 s static scenario at 4 Msps
   (synthesized by the port's own simulator, written as an ``ishort``
   file) goes through ``python -m gnss_sim_receiver_tpu_torch
   --config_file=...`` called in process: file -> SignalConditioner (x2
   decimating FIR, K5a) -> Receiver with two-step acquisition (K3, K3b)
   and tracking (K8a once a chunk, K1 with K8b and the next block's
   prologue fused; the chunk kernel on the chunk tails) -> position,
   with every launch counter set to 0 just before and read just after;
   the tracked PRNs, the fix count and the mean position error are
   checked against the scenario;
4b. the conditioner alone on the first 4 M samples, through pulse
   blanking (K5c), FIR + direct resampler and the linear resampler (K5d),
   and on the 1 M samples of phase 3's notch check through the notch (K5b):
   counters read the same way, every output held against the plain
   versions on the same input;
4c. the array entry point, ``Receiver(ReceiverConf(fs=2e6, prns=1..10,
   max_channels=8)).process_array(x)`` on an 8 s capture at 2 Msps: the
   tracked set and the launches of K1, K2 and K3 are checked;
4d. phase 4's conf and capture with QuickSync acquisition (K4b) through the
   CLI to a position; then the Tong and Fine Doppler engines on the
   card-resident 2 Msps capture: the scenario's PRNs detected, each result
   equal to the same engine's plain run on the same samples;
4e. phase 4's conf with use_CFAR_algorithm=false, pfa=0 and a fixed
   threshold through the CLI to a position (K3c on the coarse searches,
   K3's peak kernel on the narrow grids); phase 4's checks; then the Tong
   and Fine Doppler engines under that statistic, with
   bit_transition_flag under CFAR, and with both, each equal to its plain
   run;
4f. the ROC harness (models/acq_performance.py, the trials as K3's
   channel axis) at tests/test_acq_performance.py's size under its
   bounds, and one 384-trial batch under the first-vs-second statistic
   against the plain statistic;
5. the hybrid path at the reference conf's 20 Msps: the 26 s hybrid
   scenario (GPS PRNs 1, 3, 4, 5 and Galileo PRNs 11-15) synthesized on the
   card by the device generator (K6), quantized there and written as an
   ``ibyte`` file, then through the CLI with a GPS L1 C/A + Galileo E1-B
   conf (10 + 10 channels, CCCWSR acquisition on E1, K4a; 5-tap VEML
   tracking through K1 and K2) to a joint position: the tracked sets, the
   ephemerides, the fixes and the mean position error are checked, the
   counters read as in phase 4;
5b. the E1 chain's 8 ms acquisition (K4a) on the card-resident hybrid
   capture: PRNs 11-15 detected, every cell equal to the plain version's;
5c. its CCCWSR and 8 ms acquisitions with use_CFAR_algorithm=false and the
   fixed threshold (K3c's dual form) on the same capture, the same
   checks;
6. the full chain of bench.py: the 12-satellite, 120 s scenario at 2 Msps
   made on the card by the device generator (K6) and kept there, through
   ``Receiver(ReceiverConf(fs=2e6, prns=1..12, max_channels=12,
   max_acq_channels=12, pvt_rate_ms=500)).process_array(x)`` once: the
   tracked set, the fixes and the mean position error are checked, the
   real-time factor printed;
7. the wideband path at 20 Msps: a GPS L5 + Galileo E5a scenario (GPS
   PRNs 1, 3, 4, 5 on L5 with CNAV, Galileo PRNs 11-15 on E5a-I with
   F/NAV, phase 5's geometry, 48 dB-Hz) made on the card by the device
   generator (K6) for 60 s (an F/NAV page carries one word every 10 s and
   words 1-4 repeat every 40 s), written as an ``ibyte`` file, then
   through the CLI with a GPS L5I + Galileo E5a conf (10 + 10 channels,
   Galileo_E5a_Noncoherent_IQ_Acquisition_CAF with a 500 Hz CAF window,
   K4c; two-step PCPS on L5, K3 and K3b; tracking through K1 and K2) to a
   joint position: the tracked sets, the CNAV and F/NAV ephemerides, the
   fixes and the mean position error checked, the counters read as in
   phase 4;
8. the hybrid pilot path at 20 Msps: phase 5's scenario with E1-B and E1-C
   (CS25) on every Galileo satellite, each at -3 dB, made on the card by
   K6 and kept there, through the array entry point's session with phase
   5's conf, GPS tracking at extend_correlation_symbols=20 and the E1
   chain galileo_e1b_chain(track_pilot=True,
   extend_correlation_symbols=5) (E1-C pilot loops with CS25 sync, the
   E1-B data prompt for I/NAV): per-epoch tracking, one launch of the
   chunk kernel per chunk; phase 5's checks, every channel synced, the
   chunk kernel's epochs = the epochs run and its launches = the chunks
   dispatched, the real-time factor printed;
8b. phase 4's conf with Tracking_1C.extend_correlation_symbols=20 through
   the CLI on phase 4's file: phase 4's checks, the chunk kernel alone;
9. the sharded steps (parallel.shard_steps, K7) on one rank over NCCL,
   the process group made once: per-epoch tracking (the chunk kernel) and
   block tracking (K8a, then cuFFT and the fused launch per block) of
   192 GPS L1 C/A channels at 2 Msps (50 epochs, 50 blocks of 20), the
   Doppler-sharded cold start over all 32 PRNs (2 dwells of 1 ms, 41 bins
   of 250 Hz; K3's wipe and row kernel) and the time-sharded overlap-save
   grid over 127 code periods of PRN 7 (K3's wipe, cuFFT, K7's fold).
   One card is a world of one (NCCL refuses two ranks on one card), so
   every collective is a copy: each step must equal the unsharded call of
   the same port functions bit for bit; nothing here shows scaling.  The
   Doppler search's cells must be the plain grid's at the scenario's
   satellites, the overlap-save grid within 2e-4 of its plain version and
   at the injected delay and Doppler; each step's counters (its kernels,
   the NCCL calls) and host seconds are printed;
9b. the sigma-point filters (ops.nonlinear, K10a and K10b around
   torch.func.vmap of the model): 40 steps of 4096 independent filters
   of tests/test_nonlinear.py's linear system under both rules, within
   1e-2 of the exact Kalman filter and 1e-4 of the plain versions' run on
   the CPU, then 4096 tanh-measurement filters converging.

The line before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Needs one card; imports nothing
of JAX.  Every block-tracking phase checks that K1 with K8b fused ran
once per block (= K1's launches), the next block's prologue folded into
it but after each chunk's last block and K8a once per chunk (where the
planner folds), and the chunk kernel on the chunk tails; on every path
the standalone K2, K9 and K8b read 0 (they are held against in phase 3
only).  ``--profile`` adds a torch.profiler breakdown of a
second run of the paths of phases 5, 6, 7 and 8 (device busy share,
kernel launch calls, time by kernel).
``--witness`` adds, after phase 6, the hybrid receiver on variants of
phase 5's capture (rate, chips, quantization, noise seed) to show what moves
its position error.  ``--kernels-only`` stops after phase 3 and prints no
result line: the quick check of a new kernel.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
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
FS_FILE = 4_000_000.0          # the capture file's rate (phase 4)
DIRECT_DUR = 8.0               # phase 4c runs the array entry point this deep
COND_SAMPLES = 4_000_000       # phase 4b: the conditioner alone
# the notch (phases 3 and 4b): its sequential plain version takes about a
# minute per million samples on the card, so both phases use this length
NOTCH_SAMPLES = (1 << 20) + 5
NOTCH_F0, NOTCH_BW = 0.1, 0.01
RX_LLH = (40.0, -75.0, 100.0)
# phase 5: the hybrid scenario of tests/test_hybrid_position.py (4 GPS and
# 5 Galileo satellites, 48 dB-Hz, seed 17), 26 s at the reference hybrid
# conf's 20 Msps, written as ibyte (noise sigma 14 LSB per component)
HYB_GPS_PRNS = (1, 3, 4, 5)
HYB_GAL_PRNS = (11, 12, 13, 14, 15)
FS_REF_HYBRID = 20_000_000.0
HYB_BYTE_SCALE = 20.0
# phase 6: bench.py:_bench_full_chain's scenario (bench.py:128-155): 12
# satellites at these offsets (bench.py:136-139), 47 dB-Hz, seed 3, 120 s
# at 2 Msps, 12 channels, PVT every 500 ms
FULL_OFFSETS = [(0.0, 0.0), (40.0, 15.0), (-35.0, 20.0), (15.0, 55.0),
                (-20.0, -50.0), (45.0, -25.0), (-45.0, -15.0), (5.0, -60.0),
                (30.0, 40.0), (-10.0, 62.0), (25.0, -42.0), (-28.0, 47.0)]
FULL_DUR = 120.0
FULL_PRNS = tuple(range(1, 13))
K6_CHUNK = 1 << 22             # the device generator's launch (its default)
K6_TILE = 2048                 # its samples a CTA (kThreads * kPerThread)
# phase 7: the wideband scenario, phase 5's satellites on L5 and E5a, 60 s
# at 20 Msps (the shortest length at which every F/NAV ephemeris decodes:
# a channel that locks in its first seconds has words 2, 3, 4 and 1 by
# 50 s), toe and toc on the CNAV 300 s and F/NAV 60 s grids
FS_WIDEBAND = 20_000_000.0
WB_DUR = 60.0
WB_TOE = T0 + 600.0
F_L5 = 1_176.45e6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def sm_clock_during(fn, seconds: float = 3.0) -> str:
    """The card's SM clock (MHz; `nvidia-smi` every 100 ms) while `fn`
    runs back to back for `seconds`: "min / median / max of k readings
    (max clock M)", or "not read" when nvidia-smi gives nothing."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [ln.split(",") for ln in out.splitlines()
            if "," in ln and ln.split(",")[0].strip().isdigit()]
    if not rows:
        return "not read"
    # the first readings may come before the launches reach the card
    mhz = sorted(int(r[0]) for r in (rows[3:] or rows))
    top = rows[0][1].strip()
    return (f"{mhz[0]} / {mhz[len(mhz) // 2]} / {mhz[-1]} MHz of "
            f"{len(mhz)} readings (max clock {top} MHz)")


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

def _row(name, route, source, replaces, err, ms, plain_ms, n_bytes, n_ops,
         shape, library_ms=None):
    """One kernel's entry of the `kernels` line.  `shape` says at what
    shape `ms`, `plain_ms`, `bound_ms` and `library_ms` were taken: the one
    the kernel's path launches it at."""
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"  {name} [{shape}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}"
          + ("" if library_ms is None else f", library {library_ms:.4f} ms"))
    return dict(name=name, route=route, source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, shape=shape)


def _cnoise(rng, n, dev):
    import torch
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    return torch.view_as_complex(x).to(dev)


def check_k1(dev, rng, conf, c: int, e: int, taps, chunk_epochs: int,
             name: str, label: str):
    """K1 against its plain version at `conf`'s FFT length, C channels, E
    epochs per block, the given taps (in chips), the window spectra of a
    `chunk_epochs`-epoch chunk; timed there."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    fs, rate = conf.fs, conf.code_rate_cps
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    k = len(taps)
    n = chunk_epochs * s0 + nfft + 512
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64)).to(dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    n_wins = xf_all.shape[0]
    rf = torch.from_numpy((rng.standard_normal((c, nfft))
                           + 1j * rng.standard_normal((c, nfft))
                           ).astype(np.complex64)).to(dev)
    w0_np = rng.integers(0, n_wins - e, c).astype(np.int32)
    w0_np[:2] = (-2, n_wins)       # both clamps: the start below 0, past W-E
    w0 = torch.from_numpy(w0_np).to(dev)
    lag = rng.uniform(16.0, 16.0 + s0, (c, e)).astype(np.float32)
    lag_int = np.round(lag).astype(np.int32)
    w_max = 2 * np.pi * 5000.0 / fs          # +-5 kHz of Doppler
    args = (xf_all, rf, w0, torch.from_numpy(lag_int).to(dev),
            torch.from_numpy((lag - lag_int).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0, 650, (c, e)).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(np.outer(rng.uniform(0.97, 0.99, c),
                                      -np.asarray(taps)).astype(np.float32)
                             * np.float32(fs / rate)).to(dev),
            torch.from_numpy(rng.uniform(-w_max, w_max, c).astype(np.float32)
                             ).to(dev))
    scratch = tb.k1_scratch(c, e, k, nfft, dev)
    slabs = scratch.partials.shape[1]
    got = tb.block_correlate(*args, scratch=scratch)
    again = tb.block_correlate(*args, scratch=scratch)
    want = tb._block_correlate_plain(*args)
    torch.cuda.synchronize()
    err = compare(f"{name} ({label})", got, want, 1e-4)
    same_bits(f"{name} ({label})", got, again)
    ms = time_ms(lambda: tb.block_correlate(*args, scratch=scratch))
    counters_at_zero(f"{name} ({label})", scratch.arrivals)
    plain = time_ms(lambda: tb._block_correlate_plain(*args), reps=3)
    rows = len({min(max(int(w), 0), n_wins - e) + i for w in w0_np
                for i in range(e)})
    n_bytes = rows * nfft * 8 + c * nfft * 8 + c * e * (4 * 3) + c * e * k * 8
    # per (c, k, f): tap angle 3, sincos 2; per (c, e, f): lag angle 4,
    # sincos 2, two complex products 12, a complex multiply-accumulate 8
    # per tap
    n_ops = c * nfft * (k * 5 + e * (18 + k * 8))
    return _row(name, "cuda",
                "gnss_sim_receiver_tpu_torch/csrc/block_correlator.cu",
                "gnss_sim_receiver_tpu/models/tracking_block.py:149",
                err, ms, plain, n_bytes, n_ops,
                f"{label}: C={c} channels, E={e} epochs, K={k} taps, "
                f"F={nfft} bins, S={slabs} slabs")


def same_bits(name, a, b) -> None:
    """Fails unless two launches on the same inputs gave the same bits."""
    import torch
    if not torch.equal(torch.view_as_real(a), torch.view_as_real(b)):
        fail(f"{name}: two launches on the same inputs differ")
    print(f"  {name}: two launches bit-identical")


def counters_at_zero(name, arrivals) -> None:
    """Fails unless every arrival counter is back at 0 (after the timing's
    CUDA-graph replays)."""
    import torch
    torch.cuda.synchronize()
    if bool(arrivals.ne(0).any()):
        fail(f"{name}: arrival counters not reset: {arrivals.tolist()}")
    print(f"  {name}: arrival counters at 0 after the timed replays")


def block_state(rng, conf, c: int, e: int, n_wins: int, dev):
    """A TrackState of C channels with every field the block step reads
    spread over the range its paths give it: the last channel inactive,
    epochs on both sides of the FLL pull-in edge, ext_n on both sides of
    the DLL switch (50), lock_fail up to max_lock_fail, integer bit-sync
    histograms (one channel a transition short of sync), prev_sign in
    {-1, 0, 1}, negative carrier phases."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    s0 = conf.nominal_epoch_samples
    st = interop.track_state_to_numpy(trk._init_state(c, "cpu"))
    dop = rng.uniform(-4500.0, 4500.0, c)
    hist = rng.integers(0, 3, (c, 20)).astype(np.float32)
    hist[0] = 0.0
    hist[0, rng.integers(0, 20)] = conf.bit_sync_min_transitions - 1
    ep = conf.fll_pullin_epochs

    def f(a):
        return np.asarray(a, np.float32)
    st.update({
        "active": np.arange(c) < c - 1,
        "pos": rng.integers(-8, (n_wins - e - 1) * s0, c).astype(np.int32),
        "rem_code_phase": f(rng.uniform(-0.5, 0.5, c)),
        "code_freq": f(conf.code_rate_cps * (1.0 + dop / conf.carrier_freq_hz)
                       + rng.uniform(-0.05, 0.05, c)),
        "carrier_doppler": f(dop),
        "rem_carr_phase": f(rng.uniform(-1.0, 2.0 * np.pi, c)),
        "acc_phase_cycles": f(rng.uniform(-1e5, 1e5, c)),
        "acc_phase_comp": f(rng.uniform(-1e-3, 1e-3, c)),
        "dll.vel": f(rng.uniform(-0.5, 0.5, c)),
        "pll.vel": f(dop + rng.uniform(-1.0, 1.0, c)),
        "pll.acc": f(rng.uniform(-5.0, 5.0, c)),
        "prompt_prev": (rng.standard_normal(c) + 1j * rng.standard_normal(c)
                        ).astype(np.complex64) * 1000,
        "epoch": rng.integers(max(ep - 3 * e, 0), ep + 3 * e, c
                              ).astype(np.int32),
        "carrier_lock": f(rng.uniform(0.3, 1.0, c)),
        "lock_fail": f(rng.integers(0, conf.max_lock_fail + 1, c)),
        "bit_hist": hist,
        "prev_sign": f(rng.choice([-1.0, 0.0, 1.0], c)),
        "bit_synced": rng.random(c) < 0.3,
        "bit_phase": rng.integers(0, 20, c).astype(np.int32),
        "ext_n": rng.integers(45, 55, c).astype(np.int32)})
    return interop.track_state_from_numpy(st, dev)


def block_corr(rng, c: int, e: int, taps, dev):
    """[C, E, K] correlations shaped like a tracked channel's: a triangle
    over the taps, a carrier phase error, nav-bit sign flips and noise."""
    import torch
    amp = rng.uniform(200.0, 2000.0, (c, 1, 1))
    tri = np.maximum(1.0 - np.abs(np.asarray(taps)) * 2.0, 0.1)[None, None]
    bits = np.where(rng.random((c, e, 1)) < 0.2, -1.0, 1.0)
    ph = rng.normal(0.0, 0.3, (c, e, 1))
    noise = rng.standard_normal((c, e, len(taps), 2)) @ [1.0, 1j] * 60.0
    return torch.from_numpy((amp * tri * bits * np.exp(1j * ph) + noise
                             ).astype(np.complex64)).to(dev)


def ulps(got, want):
    """|got - want| in units of want's float32 ulp."""
    import torch
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return ((got - want).abs() / ulp).max().item()


def closure_flips(conf, got, want) -> list:
    """The integer and bool state fields in which K8b's next state differs
    from the plain version's, per channel, each with the plain version's
    margin to the thresholds that decide it (carrier lock and C/N0, the
    only float comparisons upstream of lock_fail, lock_lost and active),
    relative to the threshold."""
    from gnss_sim_receiver_tpu_torch import interop
    g = interop.track_state_to_numpy(got)
    w = interop.track_state_to_numpy(want)
    flips = []
    for k in ("active", "pos", "epoch", "lock_fail", "lock_lost",
              "bit_synced", "bit_phase", "ext_n", "bit_hist"):
        diff = g[k] != w[k]
        for ch in np.flatnonzero(diff.reshape(diff.shape[0], -1).any(1)):
            margin = None
            if k in ("active", "lock_fail", "lock_lost"):
                margin = min(
                    abs(w["carrier_lock"][ch] - conf.carrier_lock_threshold)
                    / conf.carrier_lock_threshold,
                    abs(w["cn0_db_hz"][ch] - conf.cn0_min_db_hz)
                    / conf.cn0_min_db_hz)
            flips.append((k, int(ch), margin))
    return flips


K8_RTOL = 1e-5          # K8b's float fields, of max |plain|
# the block library built a second time with --fmad=false, into a
# directory of its own: block_step.cu rounds explicitly, so its K8a and
# K8b must give the same bits under either flag
FMAD_FALSE = ("--fmad=false",)


def fmad_false_dir():
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    return cuda_build.BUILD_DIR / "fmad_false"


def check_k8(dev, rng, conf, c: int, taps, provider, n_wins: int,
             names, label: str):
    """K8a and K8b against their plain versions at `conf`'s FFT length, C
    channels, E = the conf's block epochs, the given taps (chips), the
    block replica of `provider`'s band-limited codes, a chunk of `n_wins`
    windows; timed there.  K8a: the integer outputs exact, the float ones
    within 2 ulp, the replica within 1e-6 of its row's largest modulus.
    K8b: the float fields of the next state and the block's plane rows
    within K8_RTOL of max |plain|; the integer and bool fields exact, or
    flipped only where the plain version's carrier lock or C/N0 lies
    within K8_RTOL of its threshold.  Then both bit for bit: against their
    plain versions, and against the same kernels of the block library
    built with --fmad=false."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import prn_codes
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
    k = len(taps)
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        provider(p), conf.fs, conf.code_rate_cps, s0, 8)
        for p in range(1, c + 1)])
    codes_rep = tb.code_spectra(conf, tables, dev)
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
    st = block_state(rng, conf, c, e, n_wins, dev)
    shape = (f"{label}: C={c} channels, E={e} epochs, K={k} taps, "
             f"F={nfft} bins")

    # ---- K8a ----------------------------------------------------------
    got = tb.block_prologue(conf, e, codes_rep, taps_t, n_wins, st)
    want = tb._block_prologue_plain(conf, e, codes_rep, taps_t, n_wins, st)
    torch.cuda.synchronize()
    for name in ("n_cum", "n_next", "n_len", "n_total", "w0", "lag_int"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"K8a ({label}): {name} differs from the plain version")
    worst_ulp = 0.0
    for name in ("rem_end", "rem_new", "lag_frac", "ph_sc", "tap_samps",
                 "omega"):
        u = ulps(getattr(got, name), getattr(want, name))
        worst_ulp = max(worst_ulp, u)
        if u > 2.0:
            fail(f"K8a ({label}): {name} {u:g} ulp from the plain version")
    rep_err = ((got.rep_t - want.rep_t).abs().amax(1)
               / want.rep_t.abs().amax(1).clamp(min=1e-30)).max().item()
    print(f"  K8a_block_prologue ({label}): integer outputs identical, "
          f"floats within {worst_ulp:g} ulp (tolerance 2), replica within "
          f"{rep_err:.2e} of its row's max modulus (tolerance 1e-6)")
    if rep_err > 1e-6:
        fail(f"K8a ({label}): replica error {rep_err:.2e}")
    a_err = float((got.rep_t - want.rep_t).abs().max())
    a_ms = time_ms(lambda: tb.block_prologue(conf, e, codes_rep, taps_t,
                                             n_wins, st))
    a_plain = time_ms(lambda: tb._block_prologue_plain(
        conf, e, codes_rep, taps_t, n_wins, st))
    # reads: the replica table and 5 state fields; writes: the complex
    # replica, 6 [C, E] and 4 [C] vectors and the taps;
    # per (c, m): angle 1, sincos 2, two products 2
    a_bytes = c * nfft * (4 + 8) + c * 5 * 4 + c * e * 6 * 4 + c * 4 * 4 \
        + c * k * 4
    a_ops = c * nfft * 5 + c * e * 30
    row_a = _row(names[0], "cuda",
                 "gnss_sim_receiver_tpu_torch/csrc/block_step.cu",
                 "gnss_sim_receiver_tpu/models/tracking_block.py:204",
                 a_err, a_ms, a_plain, a_bytes, a_ops, shape)

    # ---- K8b ----------------------------------------------------------
    corr = block_corr(rng, c, e, taps, dev)
    t = 3 * e
    planes = tb._empty_planes(t, c, dev)
    planes_p = tb._empty_planes(t, c, dev)
    for pl in (planes, planes_p):
        for v in pl.values():
            v.zero_()
    new_k = tb.block_closure(conf, e, corr, want, st, planes, 1)
    new_p, outs = tb._block_closure_plain(conf, e, corr, want, st)
    tb._write_rows(planes_p, outs, 1, e)
    torch.cuda.synchronize()
    flips = closure_flips(conf, new_k, new_p)
    for field, ch, margin in flips:
        print(f"  K8b ({label}): {field} of channel {ch} differs; plain "
              f"margin to its threshold {margin}")
        if margin is None or margin > K8_RTOL:
            fail(f"K8b ({label}): {field} of channel {ch} differs outside "
                 "the float tolerance of its threshold")
    gk = interop.track_state_to_numpy(new_k)
    gp = interop.track_state_to_numpy(new_p)
    b_err = 0.0
    for key in gp:
        if key in ("active", "pos", "epoch", "lock_fail", "lock_lost",
                   "bit_synced", "bit_phase", "ext_n", "bit_hist"):
            continue
        if not np.array_equal(gk[key], gp[key]):
            b_err = max(b_err, compare(
                f"K8b ({label}) state {key}", torch.from_numpy(gk[key]),
                torch.from_numpy(gp[key]), K8_RTOL))
    for key, _ in tb.PLANES:
        if not torch.equal(planes[key], planes_p[key]):
            b_err = max(b_err, compare(f"K8b ({label}) plane {key}",
                                       planes[key], planes_p[key], K8_RTOL))
    print(f"  K8b_block_closure ({label}): {len(flips)} integer or bool "
          f"fields flipped at a threshold; state and plane rows within "
          f"{b_err:.3e} (tolerance {K8_RTOL:g} x max |plain|)")
    same_k8_bits(dev, conf, e, codes_rep, taps_t, n_wins, st, corr, got,
                 want, new_k, new_p, planes, planes_p, label)
    b_ms = time_ms(lambda: tb.block_closure(conf, e, corr, want, st,
                                            planes, 1))

    def plain_closure():
        _, o = tb._block_closure_plain(conf, e, corr, want, st)
        tb._write_rows(planes_p, o, 1, e)
    b_plain = time_ms(plain_closure)
    # reads: 23 state fields (bit_hist 20 wide), the correlations, 6 of
    # K8a's vectors; writes: the next state and E rows of the 12 planes;
    # per (c, e): discriminators 30, FLL 20, lock 10, bit sync 20 + 2E
    # (rank and bin counts); per c: loop filters and commit 80
    st_bytes = c * (22 * 4 + 8 + 20 * 4)
    b_bytes = 2 * st_bytes + c * e * k * 8 + c * e * 4 * 4 + c * 2 * 4 \
        + e * c * (8 + 9 * 4 + 2 * 4 + 1)
    b_ops = c * e * (80 + 2 * e) + c * 80
    row_b = _row(names[1], "cuda",
                 "gnss_sim_receiver_tpu_torch/csrc/block_step.cu",
                 "gnss_sim_receiver_tpu/models/tracking_block.py:359",
                 b_err, b_ms, b_plain, b_bytes, b_ops, shape)
    rows_f = check_block_close(dev, rng, conf, c, e, got, st, n_wins,
                               names[2:],
                               label, shape, (codes_rep, taps_t),
                               (a_bytes, a_ops), (b_ms, b_bytes, b_ops))
    return (row_a, row_b, *rows_f)


def same_k8_bits(dev, conf, e, codes_rep, taps_t, n_wins, st, corr, got,
                 want, new_k, new_p, planes, planes_p, label) -> None:
    """K8a's outputs `got` and K8b's next state `new_k` and plane rows
    `planes` bit for bit those of the plain versions (`want`, `new_p`,
    `planes_p`) and of the block library built with --fmad=false on the
    same inputs."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    alt = tb.bind(cuda_build.load("block_kernels", FMAD_FALSE,
                                  fmad_false_dir()))
    c, nfft = codes_rep.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    got_f = tb._empty_prologue(c, e, nfft, taps_t.shape[0], dev)
    cuda_build.check(alt.block_prologue(tb._prologue_args(
        conf, e, codes_rep, taps_t, n_wins, st, got_f), c, stream),
        "block_prologue (--fmad=false)")
    new_f = tb._empty_state(st)
    planes_f = tb._empty_planes(planes["prompt"].shape[0], c, dev)
    for v in planes_f.values():
        v.zero_()
    cuda_build.check(alt.block_closure(tb._closure_args(
        conf, e, corr, want, st, new_f, planes_f), 1, stream),
        "block_closure (--fmad=false)")
    torch.cuda.synchronize()
    fields = tb.BlockPrologue._fields
    for other, what in ((want, "the plain version"),
                        (got_f, "the --fmad=false build")):
        diff = [n for n in fields if not torch.equal(
            bits(getattr(got, n)), bits(getattr(other, n)))]
        if diff:
            fail(f"K8a ({label}): {diff} differ in bits from {what}")
    for st_o, pl_o, what in ((new_p, planes_p, "the plain version"),
                             (new_f, planes_f, "the --fmad=false build")):
        diff = differing(new_k, st_o, planes, pl_o)
        if diff:
            fail(f"K8b ({label}): {diff} differ in bits from {what}")
    print(f"  K8a and K8b ({label}): every output bit for bit that of the "
          "plain version and of the --fmad=false build")


def bits(t):
    """`t` as integers of its bit pattern (floats and complex floats)."""
    import torch
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def differing(got_state, want_state, got_planes, want_planes) -> list:
    """The state fields and planes whose bits differ."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    gs = interop.track_state_to_numpy(got_state)
    ws = interop.track_state_to_numpy(want_state)
    out = [f"state {k}" for k in ws
           if gs[k].tobytes() != ws[k].tobytes()]
    return out + [f"plane {k}" for k in want_planes
                  if not torch.equal(bits(got_planes[k]),
                                     bits(want_planes[k]))]


def check_block_close(dev, rng, conf, c: int, e: int, pro, st, n_wins: int,
                      names, label: str, shape: str, fold_in, k8a, k8b):
    """K1 with K8b's closure in its epilogue (block_correlate_close, on the
    replica spectrum as the FFT leaves it) against K1 on the conjugated
    spectrum followed by the standalone K8b, from K8a's outputs `pro` and
    the state `st`, on the window spectra of an `n_wins`-window noise
    chunk: the correlations, the next state and the block's plane rows
    bit for bit, two launches bit-identical.  Then with the fold (`fold_in` = the
    replica table and the taps): the same, and the next block's prologue
    bit for bit the standalone K8a's on the next state, the fold flags
    counting the two launches (S > 1) and the arrival counters at 0.
    Timed beside K1 alone on the same inputs (the fused launch less K1's
    is what the closure costs there) and the standalone K8a.  `k8a` and
    `k8b` are (bytes, operations) and (ms, bytes, operations) of the
    standalone kernels.  Returns the rows of the fused launch without and
    with the fold."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    x = _cnoise(rng, n_wins * s0 + nfft, dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    n_wins = xf_all.shape[0]
    rf = torch.fft.fft(pro.rep_t, dim=-1)
    rf_c = torch.conj_physical(rf)
    k = pro.tap_samps.shape[1]
    scratch = tb.k1_scratch(c, e, k, nfft, dev)
    slabs = scratch.partials.shape[1]
    k1_in = (pro.w0, pro.lag_int, pro.lag_frac, pro.ph_sc, pro.tap_samps,
             pro.omega)
    codes_rep, taps_t = fold_in

    def planes():
        pl = tb._empty_planes(3 * e, c, dev)
        for v in pl.values():
            v.zero_()
        return pl

    def next_pro():
        return tb._empty_prologue(c, e, nfft, k, dev)
    corr_r = tb.block_correlate(xf_all, rf_c, *k1_in, scratch=scratch)
    pl_r = planes()
    new_r = tb.block_closure(conf, e, corr_r, pro, st, pl_r, 1)
    nxt_r = tb.block_prologue(conf, e, codes_rep, taps_t, n_wins, new_r)
    outs = []
    for fold in (None, None, next_pro(), next_pro()):
        corr_f, pl_f = torch.empty_like(corr_r), planes()
        new_f = tb.block_correlate_close(
            conf, e, xf_all, rf, pro, st, pl_f, 1, corr=corr_f,
            scratch=scratch,
            fold=None if fold is None else (codes_rep, taps_t, fold))
        outs.append((corr_f, new_f, pl_f, fold))
    torch.cuda.synchronize()
    flags = scratch.flags.tolist()
    if flags != [2 if slabs > 1 else 0] * c:
        fail(f"{names[1]} ({label}): fold flags {flags} after two folded "
             f"launches of S={slabs} slabs")
    counters_at_zero(f"{names[1]} ({label})", scratch.arrivals)
    for i, (corr_f, new_f, pl_f, fold) in enumerate(outs):
        diff = differing(new_f, new_r, pl_f, pl_r)
        if not torch.equal(bits(corr_f), bits(corr_r)):
            diff.insert(0, "correlations")
        if fold is not None:
            diff += [f"next prologue {n}" for n in tb.BlockPrologue._fields
                     if not torch.equal(bits(getattr(fold, n)),
                                        bits(getattr(nxt_r, n)))]
        if diff:
            fail(f"{names[i // 2]} ({label}): launch {i % 2 + 1} differs "
                 f"from K1 then K8b{' then K8a' if fold else ''} in {diff}")
    print(f"  {names[0]} ({label}): correlations, next state and plane "
          "rows bit for bit those of K1 then K8b; two launches "
          f"bit-identical; with the fold ({names[1]}, S={slabs}) also the "
          "next block's prologue bit for bit the standalone K8a's on K8b's "
          f"state, fold flags {flags[0]} after two launches")
    pl_f, corr_f, nxt = planes(), torch.empty_like(corr_r), next_pro()
    ms = time_ms(lambda: tb.block_correlate_close(
        conf, e, xf_all, rf, pro, st, pl_f, 1, corr=corr_f, scratch=scratch))
    ms_fold = time_ms(lambda: tb.block_correlate_close(
        conf, e, xf_all, rf, pro, st, pl_f, 1, corr=corr_f, scratch=scratch,
        fold=(codes_rep, taps_t, nxt)))
    k1_ms = time_ms(lambda: tb.block_correlate(
        xf_all, rf_c, *k1_in, out=corr_r, scratch=scratch))
    k8a_ms = time_ms(lambda: tb.block_prologue(conf, e, codes_rep, taps_t,
                                               n_wins, new_r))
    counters_at_zero(f"{names[0]} ({label})", scratch.arrivals)

    def plain():
        corr = tb._block_correlate_plain(xf_all, torch.conj_physical(rf),
                                         *k1_in)
        _, o = tb._block_closure_plain(conf, e, corr, pro, st)
        tb._write_rows(pl_r, o, 1, e)
    plain_ms = time_ms(plain, reps=3)

    def plain_fold():
        _, _, o, _ = tb._step_plain(conf, e, xf_all, rf, pro, st,
                                    codes_rep, taps_t)
        tb._write_rows(pl_r, o, 1, e)
    plain_fold_ms = time_ms(plain_fold, reps=3)
    print(f"  {names[0]} ({label}): fused {ms:.4f} ms, K1 alone {k1_ms:.4f} "
          f"ms in the same build: the closure adds {ms - k1_ms:.4f} ms "
          f"(standalone K8b {k8b[0]:.4f} ms); with the fold {ms_fold:.4f} "
          f"ms: the next prologue adds {ms_fold - ms:.4f} ms (standalone "
          f"K8a {k8a_ms:.4f} ms; the fold "
          f"{'saves' if ms_fold < ms + k8a_ms else 'costs'} "
          f"{abs(ms + k8a_ms - ms_fold):.4f} ms of device time a block)")
    rows = len({min(max(int(w), 0), n_wins - e) + i
                for w in pro.w0.tolist() for i in range(e)})
    n_bytes = rows * nfft * 8 + c * nfft * 8 + c * e * 12 + c * e * k * 8 \
        + k8b[1]
    n_ops = c * nfft * (k * 5 + e * (18 + k * 8)) + k8b[2]
    src = "gnss_sim_receiver_tpu_torch/csrc/block_correlator.cu"
    at = "gnss_sim_receiver_tpu/models/tracking_block.py:149"
    row = _row(names[0], "cuda", src, at, 0.0, ms, plain_ms, n_bytes, n_ops,
               shape + f", S={slabs} slabs")
    row_fold = _row(names[1], "cuda", src, at, 0.0, ms_fold, plain_fold_ms,
                    n_bytes + k8a[0], n_ops + k8a[1],
                    shape + f", S={slabs} slabs")
    row["k1_ms"] = row_fold["k1_ms"] = k1_ms
    row_fold["k8a_ms"] = k8a_ms
    return row, row_fold


BLOCK_CHUNK_BLOCKS = 50


def check_block_chunk_bits(dev, rng, conf, c: int, taps, provider,
                           label: str) -> dict:
    """The two-launch chunk (K8a for the first block, then per block the
    cuFFT and K1 with K8b's closure and the next block's prologue fused)
    against the three-launch chunk (per block K8a, the cuFFT, K1 with K8b)
    and the plain chunk (the plain K8a and K8b around K1's kernel) over
    BLOCK_CHUNK_BLOCKS blocks at `conf`'s shape with C channels, from
    block_state's edge states on a noise capture: every plane and the final
    state bit for bit; the arrival counters back at 0 and the fold flags at
    the chunk's folded launches (with S > 1).  Timed per chunk by graph
    replay and on the host per block, both forms."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import prn_codes
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
    n = BLOCK_CHUNK_BLOCKS
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        provider(p), conf.fs, conf.code_rate_cps, s0, 8)
        for p in range(1, c + 1)])
    codes_rep = tb.code_spectra(conf, tables, dev)
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
    st = block_state(rng, conf, c, e, 2 * e + 2, dev)
    x = _cnoise(rng, (n * e + 2 * e + 4) * s0 + nfft, dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    args = (conf, n, e, codes_rep, taps_t, xf_all, st)
    k1 = tb.k1_scratch(c, e, len(taps), nfft, dev)
    slabs = k1.partials.shape[1]
    two_st, two = tb._chunk_cuda(*args, fold=True, k1=k1)
    three_st, three = tb._chunk_cuda(*args, fold=False)
    plain_st, plain = tb._chunk_plain(*args)
    torch.cuda.synchronize()
    flags = k1.flags.tolist()
    if flags != [n - 1 if slabs > 1 else 0] * c:
        fail(f"two-launch chunk ({label}): fold flags {flags} after "
             f"{n - 1} folded launches of S={slabs} slabs")
    counters_at_zero(f"two-launch chunk ({label})", k1.arrivals)
    for ref_st, ref, what in ((three_st, three, "the three-launch chunk"),
                              (plain_st, plain, "the plain chunk")):
        diff = differing(two_st, ref_st, two, ref)
        if diff:
            fail(f"two-launch chunk ({label}): {diff} differ in bits from "
                 f"{what}")
    active = int(two_st.active.sum())

    def host_ms(fold):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb._chunk_cuda(*args, fold=fold)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n
    # the median of 5 runs of each, in turns
    runs = [(host_ms(True), host_ms(False)) for _ in range(5)]
    h_two, h_three = (float(np.median(r)) for r in zip(*runs))
    ms_two = time_ms(lambda: tb._chunk_cuda(*args, fold=True), reps=2)
    ms_three = time_ms(lambda: tb._chunk_cuda(*args, fold=False), reps=2)
    print(f"  two-launch chunk ({label}: C={c}, E={e}, F={nfft}, S={slabs}): "
          f"{n} blocks, planes and final state bit for bit those of the "
          f"three-launch chunk and of the plain chunk ({active} channels "
          f"still active); fold flags {flags[0]}; device {ms_two:.4f} ms a "
          f"chunk ({ms_two / n:.5f} a block) against {ms_three:.4f} "
          f"({ms_three / n:.5f}); host {h_two:.4f} ms a block against "
          f"{h_three:.4f} (medians of 5)")
    return dict(name="block_chunk", shape=f"{label}: C={c}, E={e}, "
                f"F={nfft}, S={slabs}, {n} blocks",
                ms_two_launch=ms_two, ms_three_launch=ms_three,
                host_ms_per_block_two_launch=h_two,
                host_ms_per_block_three_launch=h_three)


def check_k2(dev, rng, conf, c: int, taps, provider, name: str,
             label: str, data_provider=None):
    """K2 against its plain version at `conf`'s block size, C channels, the
    given taps (chips) and the band-limited tables of `provider`'s codes
    (8 entries per chip); timed there.  With `data_provider`, K2's data
    form: one more zero-offset tap on that provider's tables in the same
    pass, against a second plain correlation."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import correlator, prn_codes
    fs, s0, b = conf.fs, conf.nominal_epoch_samples, conf.block_size
    n = max(1 << 18, 4 * b)
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64)).to(dev)

    def tables(prov):
        return torch.from_numpy(np.stack([
            prn_codes.bandlimited_table_normalized(
                prov(p), fs, conf.code_rate_cps, s0, 8)
            for p in range(1, c + 1)])).to(dev)
    codes = tables(provider)
    data = None if data_provider is None else tables(data_provider)
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)

    def t(a, dt=np.float32):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)
    args = (x, t(rng.integers(0, n - b, c), np.int32), b, codes, taps_t,
            t(rng.uniform(0, 1, c)),
            t(conf.code_rate_cps + rng.uniform(-5, 5, c)),
            t(rng.uniform(0, 2 * np.pi, c)), t(rng.uniform(-5000, 5000, c)),
            t(rng.integers(s0 - 1, s0 + 2, c), np.int32), fs, 8)

    scratch = correlator.k2_scratch(codes, len(taps), b, 8, data, 8)

    def kernel():
        return correlator.multicorrelate(*args, data_codes=data,
                                         data_oversample=8, scratch=scratch)

    def plain():
        blocks = correlator.gather_blocks(x, args[1], b)
        corr = correlator.correlate_multitap(blocks, codes, taps_t,
                                             *args[5:])
        if data is None:
            return corr
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        return torch.cat([corr, correlator.correlate_multitap(
            blocks, data, zero, *args[5:])], 1)
    got = kernel()
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = compare(f"{name} ({label})", got, want, 1e-4)
    same_bits(f"{name} ({label})", got, again)
    print(f"  {name} ({label}): S={scratch.plan.slabs} slabs, staged "
          f"{scratch.plan.stage} + {scratch.plan.data_stage} table entries, "
          f"{int(scratch.misses)} reads outside them in two launches")
    ms = time_ms(kernel)
    counters_at_zero(f"{name} ({label})", scratch.arrivals)
    n_samp = int(args[9].sum())
    k = len(taps) + (data is not None)
    n_bytes = c * b * 8 + codes.numel() * 4 * (1 + (data is not None)) \
        + c * k * 8
    # per sample: phase 3, sincos 2, wipeoff 6, chips 3; per tap: index 3,
    # multiply-accumulate 4
    n_ops = n_samp * (14 + k * 7)
    return _row(name, "cuda",
                "gnss_sim_receiver_tpu_torch/csrc/multicorrelator.cu",
                "gnss_sim_receiver_tpu/ops/correlator.py:39"
                if data is None else
                "gnss_sim_receiver_tpu/models/tracking.py:398",
                err, ms, time_ms(plain), n_bytes, n_ops,
                f"{label}: C={c} channels, B={b}-sample blocks, K={len(taps)}"
                f" taps{' + the data tap' if data is not None else ''}, "
                f"table{'s' if data is not None else ''} {codes.shape[1]} "
                f"float32, S={scratch.plan.slabs} slabs")


K9_RTOL = 1e-5          # K9's float fields where not identical, of max |plain|


def conf_taps(conf):
    """The engine's taps for `conf`, chips: E, P, L or VE, E, P, L, VL."""
    d, dv = conf.early_late_space_chips, conf.very_early_late_space_chips
    return (dv, d / 2, 0.0, -d / 2, -dv) if dv > 0 else (d / 2, 0.0, -d / 2)


def epoch_corr(rng, c: int, taps, data: bool, dev):
    """[C, K] correlations shaped like a tracked channel's (a triangle over
    the taps, a carrier phase error, sign flips, noise) and, with `data`,
    the data prompt as one more column."""
    import torch
    amp = rng.uniform(200.0, 2000.0, (c, 1))
    tri = np.maximum(1.0 - np.abs(np.asarray(taps)) * 2.0, 0.1)[None]
    bits = np.where(rng.random((c, 1)) < 0.5, -1.0, 1.0)
    ph = rng.normal(0.0, 0.3, (c, 1))
    cols = [amp * tri * bits * np.exp(1j * ph)]
    if data:
        cols.append(0.9 * amp * np.where(rng.random((c, 1)) < 0.5, -1.0, 1.0)
                    * np.exp(1j * ph))
    z = np.concatenate(cols, 1)
    z = z + (rng.standard_normal(z.shape + (2,)) @ [1.0, 1j]) * 60.0
    return torch.from_numpy(z.astype(np.complex64)).to(dev)


def epoch_state(rng, conf, c: int, sign, dev):
    """A TrackState of C >= 6 channels on the per-epoch closure's edges,
    every other field spread over the range its paths give it (consistent
    C/N0 sums, ext sums of ext_n prompts).  `sign` [C]: the sign of each
    channel's prompt-I in the correlations it will meet.  Channel 0: the
    secondary sync about to hit (pilot) or a bit-sync histogram one
    transition short of dominance (GPS); 1: synced (pilot polarity -1), a
    coherent group that closes; 2: a group that restarts at its boundary,
    on the C/N0 window's last epoch; 3: a lock loss on that epoch; 4:
    inactive; 5: in the FLL pull-in."""
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    st = interop.track_state_to_numpy(trk._init_state(c, "cpu"))
    dop = rng.uniform(-4500.0, 4500.0, c)
    ep, w = conf.fll_pullin_epochs, conf.cn0_window_epochs
    k = max(conf.extend_correlation_symbols, 1)
    n = len(conf.secondary_code)
    epoch = rng.integers(ep + 1, ep + 400, c).astype(np.int32)
    epoch[2] = epoch[3] = (ep // w + 3) * w - 1
    epoch[5] = 5
    count = (epoch % w).astype(np.float32)
    amp = rng.uniform(500.0, 2000.0, c)
    lock_i = np.where(np.arange(c) == 3, 0.01, 0.9)

    def f(a):
        return np.asarray(a, np.float32)
    ext_n = rng.integers(0, k, c).astype(np.int32)
    ext_n[1] = k - 1
    ext = (amp * ext_n * np.exp(1j * rng.normal(0, 0.3, c))).astype(
        np.complex64)
    st.update({
        "active": np.arange(c) != 4,
        "pos": rng.integers(0, 1 << 20, c).astype(np.int32),
        "rem_code_phase": f(rng.uniform(-0.5, 0.5, c)),
        "code_freq": f(conf.code_rate_cps * (1.0 + dop / conf.carrier_freq_hz)
                       + rng.uniform(-0.05, 0.05, c)),
        "carrier_doppler": f(dop),
        "rem_carr_phase": f(rng.uniform(-1.0, 2.0 * np.pi, c)),
        "acc_phase_cycles": f(rng.uniform(-1e5, 1e5, c)),
        "acc_phase_comp": f(rng.uniform(-1e-3, 1e-3, c)),
        "dll.vel": f(rng.uniform(-0.5, 0.5, c)),
        "pll.vel": f(dop + rng.uniform(-1.0, 1.0, c)),
        "pll.acc": f(rng.uniform(-5.0, 5.0, c)),
        "prompt_prev": ((rng.standard_normal(c) + 1j * rng.standard_normal(c))
                        * amp).astype(np.complex64),
        "epoch": epoch,
        "cn0_acc.count": count,
        "cn0_acc.sum_abs_i": f(count * amp), "cn0_acc.sum_abs_q": f(
            count * amp * 0.2),
        "cn0_acc.sum_m2": f(count * amp ** 2 * 1.05),
        "cn0_acc.sum_m4": f(count * amp ** 4 * 1.2),
        "cn0_acc.sum_i": f(count * amp * lock_i * sign),
        "cn0_acc.sum_q": f(count * amp * 0.3),
        "cn0_db_hz": f(rng.uniform(30.0, 50.0, c)),
        "carrier_lock": f(np.where(np.arange(c) == 3, 0.3,
                                   rng.uniform(0.8, 1.0, c))),
        "lock_fail": f(np.where(np.arange(c) == 3, conf.max_lock_fail,
                                rng.integers(0, 5, c))),
        "prev_sign": f(rng.choice([-1.0, 1.0], c)),
        "bit_hist": f(rng.integers(0, 4, (c, 20))),
        "bit_synced": np.arange(c) != 0,
        "bit_phase": rng.integers(0, 20, c).astype(np.int32),
        "ext_p": ext, "ext_e": (ext * 0.6).astype(np.complex64),
        "ext_l": (ext * 0.5).astype(np.complex64), "ext_n": ext_n,
        "sec_synced": np.arange(c) != 0,
        "sec_polarity": f(np.where(np.arange(c) == 1, -1.0, 1.0)),
    })
    idx0 = epoch[0] % 20
    st["bit_hist"][0, idx0] = conf.bit_sync_min_transitions - 1
    st["prev_sign"][0] = -sign[0]
    st["bit_phase"][1] = (epoch[1] + 7) % 20
    st["bit_phase"][2] = epoch[2] % 20
    if n:
        from gnss_sim_receiver_tpu_torch.models.tracking import secondary_pm1
        sec = secondary_pm1(conf)
        st["sec_buf"][:, :n] = np.where(rng.random((c, n)) < 0.5, 1.0, -1.0)
        st["sec_off"] = rng.integers(0, n, c).astype(np.int32)
        off0 = int(st["sec_off"][0])
        pol0 = sign[0] * sec[(epoch[0] % n + off0) % n]
        st["sec_buf"][0, :n] = pol0 * sec[(np.arange(n) + off0) % n]
        st["sec_off"][1] = (3 - epoch[1]) % n
        st["sec_off"][2] = (-epoch[2]) % n
    return interop.track_state_from_numpy(st, dev)


def check_k9(dev, rng, conf, c: int, name: str, label: str):
    """K9 against its plain version, one epoch of C channels from the edge
    states of epoch_state on correlations of epoch_corr (with the data
    prompt on a track_pilot conf); timed there.  The target is bit
    equality of the next state, the plane row and the next epoch's
    lengths; integer and bool fields must be identical, float fields where
    not identical within K9_RTOL of max |plain|.  Fails unless the edges
    were reached."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    taps = conf_taps(conf)
    k = len(taps)
    data = conf.track_pilot
    corr = epoch_corr(rng, c, taps, data, dev)
    sign = np.where(corr[:, k // 2].real.cpu().numpy() >= 0, 1.0, -1.0)
    st = epoch_state(rng, conf, c, sign, dev)
    n_c = trk._epoch_length(conf, st)
    planes = trk._empty_planes(3, c, dev, trk.EPOCH_PLANES)
    planes_p = trk._empty_planes(3, c, dev, trk.EPOCH_PLANES)
    for pl in (planes, planes_p):
        for v in pl.values():
            v.zero_()
    nc_k = n_c.clone()
    new_k = trk.epoch_closure(conf, corr, nc_k, st, planes, 1)
    dcol = corr[:, k] if data else None
    new_p, outs = trk._epoch_closure_plain(conf, st, corr[:, :k], dcol, n_c)
    trk._write_row(planes_p, outs, 1)
    nc_p = trk._epoch_length(conf, new_p)
    torch.cuda.synchronize()
    gk = interop.track_state_to_numpy(new_k)
    gp = interop.track_state_to_numpy(new_p)
    pairs = [(f"state {key}", torch.from_numpy(gk[key]),
              torch.from_numpy(gp[key])) for key in gp]
    pairs += [(f"plane {key}", planes[key], planes_p[key])
              for key, _ in trk.EPOCH_PLANES]
    pairs.append(("next n_c", nc_k, nc_p))
    differ, err, worst_ulp = [], 0.0, 0.0
    for what, g, w in pairs:
        if torch.equal(g, w):
            continue
        differ.append(what)
        if not (g.is_floating_point() or g.is_complex()):
            fail(f"{name} ({label}): {what} differs: {g} vs {w}")
        if not g.is_complex():
            worst_ulp = max(worst_ulp, ulps(g, w))
        err = max(err, compare(f"{name} ({label}) {what}", g, w, K9_RTOL))
    # the edges were reached
    k_ext = conf.extend_correlation_symbols
    edges = {"inactive": gp["pos"][4] == int(st.pos[4])
             + conf.nominal_epoch_samples,
             "lock loss": bool(gp["lock_lost"][3]) and not gp["active"][3],
             "window": gp["cn0_acc.count"][2] == 0}
    if conf.secondary_code:
        edges["secondary hit"] = bool(gp["sec_synced"][0])
    elif k_ext > 1:
        edges["bit sync"] = bool(gp["bit_synced"][0])
    if k_ext > 1:
        edges["group closes"] = gp["ext_n"][1] == 0
        edges["group restarts"] = gp["ext_n"][2] == 1
    missed = [e for e, ok in edges.items() if not ok]
    if missed:
        fail(f"{name} ({label}): edges not reached: {missed}")
    print(f"  {name} ({label}): edges {sorted(edges)} reached; "
          + ("next state, plane row and next lengths bit for bit"
             if not differ else f"{len(differ)} fields not identical, "
             f"worst {worst_ulp:g} ulp, within {err:.3e} (tolerance "
             f"{K9_RTOL:g} x max |plain|)"))
    out = trk._empty_epoch_state(st)
    nc_t = n_c.clone()
    args = trk._epoch_args(conf, corr, nc_t, trk._sec_device(conf, dev), st,
                           out, planes)
    ms = time_ms(lambda: trk._launch_closure(
        args, 1, torch.cuda.current_stream(dev).cuda_stream))
    plain = time_ms(lambda: trk._epoch_closure_plain(conf, st, corr[:, :k],
                                                     dcol, n_c))
    # reads and writes the state fields, reads the correlations, reads and
    # writes n_c, writes one row of the 13 planes; per channel ~300
    # operations plus the n_sec x n_sec shift correlation
    st_bytes = c * sum(torch.empty(0, dtype=dt).element_size()
                       * trk._WIDE.get(f, 1)
                       for f, dt in trk._EPOCH_STATE_FIELDS)
    row_bytes = c * (2 * 8 + 8 * 4 + 2 * 4 + 1)
    n_bytes = 2 * st_bytes + corr.numel() * 8 + 2 * c * 4 + row_bytes
    n_sec = len(conf.secondary_code)
    n_ops = c * (300 + 2 * n_sec * n_sec)
    return _row(name, "cuda", "gnss_sim_receiver_tpu_torch/csrc/epoch_step.cu",
                "gnss_sim_receiver_tpu/models/tracking.py:376", err, ms, plain,
                n_bytes, n_ops,
                f"{label}: C={c} channels, K={k} taps"
                + (" + data tap" if data else "")
                + (f", secondary {n_sec}" if n_sec else "")
                + f", k_ext={k_ext}")


CHUNK_CHECK_EPOCHS = 50


def chunk_bytes(x, st0, st1, codes, data, planes) -> float:
    """The bytes one chunk must move: the samples of `x` that its channels
    read (the union of each channel's window, from its position in `st0`
    to its position in `st1`), each code table once (they stay in L2),
    the state in and out once and the planes written once."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    p0, p1 = (s.pos.cpu().numpy().astype(np.int64) for s in (st0, st1))
    lo, hi = np.minimum(p0, p1), np.maximum(p0, p1)
    order = np.argsort(lo)
    n_samp, end = 0, 0
    for a, b in zip(lo[order], hi[order]):      # the union's length
        a = max(a, end)
        if b > a:
            n_samp += b - a
            end = b
    st_bytes = codes.shape[0] * sum(
        torch.empty(0, dtype=dt).element_size() * trk._WIDE.get(f, 1)
        for f, dt in trk._EPOCH_STATE_FIELDS)
    return float(n_samp * x.element_size()
                 + sum(t.numel() * t.element_size() for t in
                       (codes, *(() if data is None else (data,))))
                 + 2 * st_bytes
                 + sum(v.numel() * v.element_size() for v in planes.values()))


def check_epoch_chunk_bits(dev, rng, conf, c: int, name: str, label: str,
                           path_epochs: int, chain=None):
    """The chunk kernel (epoch_chunk) against the two-launch chunk
    (standalone K2 then K9 per epoch) over CHUNK_CHECK_EPOCHS epochs from
    epoch_state's edge states on a noise capture: every plane and the
    final state bit for bit, two launches bit-identical, K2's staged-table
    misses printed; the first epoch's prompts against the plain loop's
    within K2's tolerance.  `chain` gives the code providers (a receiver
    chain; GPS L1 C/A without).  Timed: the chunk of CHUNK_CHECK_EPOCHS
    epochs and the path's chunk of `path_epochs` by graph replay, the
    two-launch chunk and the plain loop of CHUNK_CHECK_EPOCHS; the host
    time per epoch of the chunk kernel and of the two-launch chunk."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    t = CHUNK_CHECK_EPOCHS
    if chain is None:
        eng = trk.TrackingEngine(conf, range(1, c + 1), device=dev)
    else:
        eng = trk.TrackingEngine(conf, range(11, 11 + c),
                                 code_provider=chain.code_provider,
                                 data_code_provider=chain.data_code_provider,
                                 device=dev)
    codes, taps, dcodes = eng.codes, eng.taps, eng.data_codes
    k = taps.shape[0]
    st = epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev)
    x = _cnoise(rng, (1 << 20) + (path_epochs + 2) * conf.block_size, dev)
    args = (conf, t, codes, taps, x, st, dcodes)
    trk.epoch_chunk(*args)                       # builds, plans
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [trk.epoch_chunk(*args, misses=misses) for _ in range(2)]
    ref_st, ref = trk._chunk_two_launch(*args)
    torch.cuda.synchronize()
    for i, (got_st, got) in enumerate(runs):
        diff = differing(got_st, ref_st, got, ref)
        if diff:
            fail(f"{name} ({label}): launch {i + 1} differs from the "
                 f"two-launch chunk in {diff}")
    data, _, _, k2 = trk._chunk_inputs(conf, codes, taps, dcodes)
    n_out = k + int(data is not None)
    plan = trk._chunk_plan(c, k2, n_out)
    print(f"  {name} ({label}): {t} epochs, planes and final state bit for "
          "bit those of the two-launch chunk (K2 then K9 per epoch); two "
          f"launches bit-identical; S={k2.slabs} slabs on clusters of "
          f"S'={plan.cluster} CTAs ({plan.rounds} per CTA, {plan.smem} B of "
          f"dynamic shared memory); {int(misses)} staged-table misses in "
          "two launches")
    plain_t0 = time.perf_counter()
    _, plain = trk._chunk_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - plain_t0)
    err = compare(f"{name} ({label}) first epoch's prompts",
                  (runs[0][1]["prompt"][0], runs[0][1]["pilot_prompt"][0]),
                  (plain["prompt"][0], plain["pilot_prompt"][0]), 1e-4)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / t
    h_chunk = host_ms(lambda: trk.epoch_chunk(*args))
    h_two = host_ms(lambda: trk._chunk_two_launch(*args))

    def fixed(n_ep):
        """A launch of n_ep epochs with its arguments built once."""
        launch = trk.chunk_launch(conf, n_ep, codes, taps, x, st, dcodes,
                                  misses)
        return lambda: trk.launch_chunk(launch)
    ms = time_ms(fixed(t), reps=5)
    ms_path = time_ms(fixed(path_epochs), reps=2)
    two_ms = time_ms(lambda: trk._chunk_two_launch(*args), reps=1)
    print(f"  {name} ({label}): {ms:.4f} ms per chunk of {t} epochs "
          f"({ms / t:.5f} per epoch), {ms_path:.3f} ms per chunk of "
          f"{path_epochs} ({ms_path / path_epochs:.5f} per epoch); the "
          f"two-launch chunk {two_ms:.4f} ms ({two_ms / t:.5f} per epoch); "
          f"host time per epoch: chunk kernel {h_chunk:.4f} ms, two-launch "
          f"{h_two:.4f} ms; plain loop {plain_ms / t:.3f} ms per epoch")
    # per epoch K2's operations (check_k2) and K9's (check_k9)
    n_samp = float(trk._epoch_length(conf, st).sum())
    n_sec = len(conf.secondary_code)
    n_ops = n_samp * (14 + n_out * 7) + c * (300 + 2 * n_sec * n_sec)
    n_bytes = chunk_bytes(x, st, runs[0][0], codes, data, runs[0][1])
    row = _row(name, "cuda", "gnss_sim_receiver_tpu_torch/csrc/epoch_chunk.cu",
               "gnss_sim_receiver_tpu/models/tracking.py:712", err, ms,
               plain_ms, n_bytes, t * n_ops,
               f"{label}: C={c} channels, K={k} taps"
               + (" + data tap" if data is not None else "")
               + f", k_ext={conf.extend_correlation_symbols}, T={t} epochs,"
               f" S={k2.slabs} slabs, S'={plan.cluster}")
    row["ms_per_epoch"] = ms / t
    row["ms_path_chunk"] = ms_path
    row["path_epochs"] = path_epochs
    return row


WAVES_CHANNELS = 300


def check_epoch_chunk_waves(dev, rng):
    """The chunk kernel at GPS 2 Msps (S' = 1) with C = WAVES_CHANNELS,
    more channels than the card keeps clusters resident at once: the
    planner's wave count and the card's resident count printed; over
    CHUNK_CHECK_EPOCHS epochs from epoch_state's edge states every plane
    and the final state bit for bit those of the two-launch chunk, two
    launches bit-identical.  Timed per chunk by graph replay.  Returns its
    row (for the other_shapes line)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    c, t = WAVES_CHANNELS, CHUNK_CHECK_EPOCHS
    conf = trk.TrackingConf(fs=FS)
    eng = trk.TrackingEngine(conf, [1 + i % 32 for i in range(c)],
                             device=dev)
    codes, taps = eng.codes, eng.taps
    st = epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev)
    x = _cnoise(rng, (1 << 20) + (t + 2) * conf.block_size, dev)
    args = (conf, t, codes, taps, x, st, None)
    _, _, _, k2 = trk._chunk_inputs(conf, codes, taps, None)
    plan = trk._chunk_plan(c, k2, taps.shape[0])
    resident = trk._card_max_clusters(c, plan.cluster, plan.smem)
    print(f"  chunk kernel at C={c}: S={k2.slabs}, S'={plan.cluster}, "
          f"{resident} clusters resident on the card, {plan.waves} waves")
    if resident >= c or plan.waves != -(-c // resident):
        fail(f"chunk kernel at C={c}: {resident} resident, plan {plan}")
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [trk.epoch_chunk(*args, misses=misses) for _ in range(2)]
    ref_st, ref = trk._chunk_two_launch(*args)
    torch.cuda.synchronize()
    for i, (got_st, got) in enumerate(runs):
        diff = differing(got_st, ref_st, got, ref)
        if diff:
            fail(f"chunk kernel at C={c} (waves): launch {i + 1} differs "
                 f"from the two-launch chunk in {diff}")
    print(f"  chunk kernel at C={c}: {t} epochs, planes and final state bit "
          "for bit those of the two-launch chunk; two launches "
          f"bit-identical; {int(misses)} staged-table misses")
    launch = trk.chunk_launch(conf, t, codes, taps, x, st, None, misses)
    ms = time_ms(lambda: trk.launch_chunk(launch), reps=2)
    two_ms = time_ms(lambda: trk._chunk_two_launch(*args), reps=1)
    print(f"  chunk kernel at C={c}: {ms:.4f} ms per chunk of {t} epochs "
          f"({ms / t:.5f} per epoch); the two-launch chunk {two_ms:.4f} ms")
    n_samp = float(trk._epoch_length(conf, st).sum())
    k = taps.shape[0]
    n_ops = n_samp * (14 + k * 7) + c * 300
    row = _row("K9_epoch_chunk", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/epoch_chunk.cu",
               "gnss_sim_receiver_tpu/models/tracking.py:712", 0.0, ms,
               two_ms, chunk_bytes(x, st, runs[0][0], codes, None,
                                   runs[0][1]), t * n_ops,
               f"GPS L1 C/A at 2 Msps: C={c} channels, K={k} taps, T={t} "
               f"epochs, S={k2.slabs}, S'={plan.cluster}, {plan.waves} waves "
               f"({resident} clusters resident); plain_ms: the two-launch "
               "chunk")
    row["waves"] = plan.waves
    row["resident"] = resident
    return row


WAVES_MODEL_FS = 20e6
WAVES_MODEL_SLABS = 8


def check_epoch_chunk_cluster_sizes(dev, rng) -> None:
    """The planner's waves rule where it chooses among cluster sizes: GPS
    L1 C/A at 20 Msps, C = WAVES_CHANNELS, K2's plan forced to S =
    WAVES_MODEL_SLABS slabs (plan_k2 gives S = 1 above as many channels as
    the card has SMs, so no path reaches this case).  Every size S'
    that fits is launched over CHUNK_CHECK_EPOCHS epochs; planes and final
    state must be bit for bit equal across sizes (the leader sums the
    slabs in slab order whatever S').  Per size the card's resident
    clusters, waves, rounds, the rule's cost waves x rounds and the time
    per chunk (graph replay) are printed, then the planner's pick beside
    the fastest size."""
    import functools
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.ops import correlator
    c, t, s = WAVES_CHANNELS, CHUNK_CHECK_EPOCHS, WAVES_MODEL_SLABS
    conf = trk.TrackingConf(fs=WAVES_MODEL_FS)
    eng = trk.TrackingEngine(conf, [1 + i % 32 for i in range(c)],
                             device=dev)
    codes, taps = eng.codes, eng.taps
    n_out = taps.shape[0]
    st = epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev)
    x = _cnoise(rng, (1 << 20) + (t + 2) * conf.block_size, dev)
    path_s = trk._chunk_inputs(conf, codes, taps, None)[3].slabs
    k2 = correlator.plan_k2(c, conf.block_size, codes.shape[1],
                            codes.shape[1] // conf.code_length_chips,
                            sms=-(-s * c // 2))
    if k2.slabs != s:
        fail(f"chunk kernel cluster sizes: forced plan {k2}, not S={s}")
    fits = functools.partial(trk._card_max_clusters, c)
    pick = trk.plan_epoch_chunk(c, k2, n_out, fits)
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    launches = []
    for cl in range(1, min(trk.EPOCH_CHUNK_MAX_CLUSTER, s) + 1):
        smem = trk.epoch_chunk_smem(k2, n_out, cl)
        if smem + trk.EPOCH_CHUNK_STATIC_SMEM > trk.SMEM_PER_CTA:
            continue
        resident = fits(cl, smem)
        if resident == 0:
            continue
        plan = trk.EpochChunkPlan(k2, cl, -(-s // cl), smem,
                                  -(-c // resident))
        launches.append((trk.chunk_launch(conf, t, codes, taps, x, st, None,
                                          misses, plan), resident))
        trk.launch_chunk(launches[-1][0])
    torch.cuda.synchronize()
    # compared before any is timed: a launch writes the lengths after the
    # chunk into its n_c, so its replays start from other lengths
    ref = launches[0][0]
    for launch, _ in launches[1:]:
        diff = differing(launch.state, ref.state, launch.planes, ref.planes)
        if diff:
            fail(f"chunk kernel at C={c}, S={s}: S'={launch.plan.cluster} "
                 f"differs from S'={ref.plan.cluster} in {diff}")
    timed = []
    for launch, resident in launches:
        ms = time_ms(lambda: trk.launch_chunk(launch), reps=2)
        plan = launch.plan
        timed.append((ms, plan))
        print(f"  chunk kernel at 20 Msps, C={c}, S={s} (the path's plan: "
              f"S={path_s}): S'={plan.cluster}: {resident} clusters "
              f"resident, {plan.waves} waves x {plan.rounds} rounds = "
              f"{plan.waves * plan.rounds}, {ms:.4f} ms per chunk of {t} "
              "epochs")
    best_ms, best = min(timed, key=lambda m: m[0])
    pick_ms = next(m for m, p in timed if p.cluster == pick.cluster)
    print(f"  chunk kernel at 20 Msps, C={c}, S={s}: {len(timed)} sizes bit "
          f"for bit equal; the planner picks S'={pick.cluster} "
          f"({pick.waves} waves x {pick.rounds} rounds), {pick_ms:.4f} ms; "
          f"the fastest is S'={best.cluster}, {best_ms:.4f} ms "
          f"({pick_ms / best_ms:.3f} x); {int(misses)} staged-table misses")


def acq_dwells(dev, m: int = 2):
    """`m` ms of the static scenario (6 satellites) as [m, 2000] dwells, for
    the K3 and K4b checks."""
    import torch
    x = synthesize(FS, m * 1e-3)
    return torch.from_numpy(x.astype(np.complex64)).to(dev).reshape(m, 2000)


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

    out.append(wipe_case(x, dops, t, f"GPS L1 C/A at {FS / 1e6:g} Msps",
                         k3_search(cfc, m)))
    want = pcps._wipe_plain(x, dops, t)
    spec = torch.fft.fft(want, dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    out.append(k3_peak_row(corr, m, None, 20))

    # the whole search: port (wipeoff, cuFFT, peak) beside torch.fft + torch ops
    port = time_ms(lambda: pcps.pcps_search(x, cfc, dops, t))
    torch_ops = time_ms(lambda: pcps.max_to_input_power_stat(
        pcps.pcps_grid(x, cfc, dops, FS), 2.0))
    got = pcps.pcps_search(x, cfc, dops, t)
    want = pcps.max_to_input_power_stat(pcps.pcps_grid(x, cfc, dops, FS), 2.0)
    compare("K3 pcps_search", got, want, 1e-4)
    print(f"  K3 search (M={m}, D={d}, N={n}, C={c}): port {port:.4f} ms, "
          f"torch.fft + torch ops yardstick {torch_ops:.4f} ms")
    # K3c's plain form on the same correlations (the main path's coarse
    # search under use_CFAR_algorithm=false), and the whole search so
    spc = 2
    out.append(check_k3c("K3c_pcps_second_peak", corr, m, spc, "plain", 0,
                         f"M={m} dwells, C={c} channels, D={d} Doppler "
                         f"bins, N={n} samples"))
    got = pcps.pcps_search(x, cfc, dops, t, use_cfar=False,
                           samples_per_chip=spc)
    want = pcps.first_vs_second_peak_stat(pcps.pcps_grid(x, cfc, dops, FS),
                                          spc)
    compare("K3c pcps_search (first vs second) statistic", got[0], want[0],
            1e-4)
    compare("K3c pcps_search (first vs second) cells", got[1:], want[1:],
            0.0)
    return out


def k3_peak_row(corr, m: int, label, plain_reps: int):
    """K3's peak (the row kernel, then the stat kernel) on the [M, C, D, N]
    correlations `corr` against its plain version: the statistic within
    1e-4 of its scale, the Doppler and delay cells exact; timed beside the
    plain version (`plain_reps` calls a replay)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    _, c, d, n = corr.shape
    where = "" if label is None else f" ({label})"
    got = pcps.pcps_peak(corr, m)
    want = pcps._peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare(f"K3 pcps_peak{where} statistic", got[0], want[0], 1e-4)
    compare(f"K3 pcps_peak{where} cells", got[1:], want[1:], 0.0)
    shape = (f"M={m} dwells, C={c} channels, D={d} Doppler bins, N={n} "
             "samples")
    tile, warps = pcps.row_plan(n, "plain")
    return _row(
        "K3_pcps_peak", "triton", "gnss_sim_receiver_tpu_torch/ops/pcps.py",
        "gnss_sim_receiver_tpu/ops/pcps.py:107", err,
        time_ms(lambda: pcps.pcps_peak(corr, m)),
        time_ms(lambda: pcps._peak_plain(corr, m), reps=plain_reps),
        m * c * d * n * 8 + c * 12,
        m * c * d * n * 3 + c * d * n * 2,      # |.|^2 3, sum + compare 2
        (shape if label is None else f"{label}: {shape}")
        + f", tile {tile} lanes in {warps} warps")


def narrow_table(eng):
    """A [C, D2] narrow Doppler table of `eng`'s two-step search: every
    channel's 2 n2 + 1 bins, doppler_step2 apart, around a bin of the
    coarse grid (channel c at bin 4 c, modulo the grid)."""
    import torch
    acq, dops = eng.conf, eng.dopplers
    c, d2 = eng.code_fft_conj.shape[0], 2 * acq.num_doppler_bins_step2 + 1
    centers = dops[(torch.arange(c, device=dops.device) * 4) % dops.shape[0]]
    offs = (torch.arange(d2, device=dops.device) - d2 // 2) \
        * float(acq.doppler_step2)
    return (centers[:, None] + offs[None, :]).to(torch.float32).contiguous()


def check_k3_search_shapes(dev, extra: list) -> None:
    """The wipeoff (its engine's grid and a [C, 9] narrow table, by
    wipe_case) and K3's peak at three more searches of the phases, each on
    the correlations its engine makes of its own scenario (wipeoff, cuFFT,
    the code replicas), C=10; the rows go to `extra`:
    - phase 5's GPS L1 C/A search at 20 Msps (phase 8 runs the same):
      M=2 dwells of the hybrid scenario made by K6, PRNs 1-10, N=20000
      (one code period, no doubled FFT);
    - phase 8's E1 two-step search (pilot_receiver_conf's E1 chain): M=2
      dwells of phase 8's scenario made by K6, PRNs 11-20, N=80000;
    - phase 4e's GPS L1 C/A search with bit_transition_flag: M=2 dwells of
      the static scenario at 2 Msps, PRNs 1-10, N=4000 (the doubled
      FFT)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration

    def dwells(sats, eng, m):
        return generate_baseband_device_resident(
            sats, FS_REF_HYBRID, m * eng.fft_size, noise=True, seed=17,
            device=dev).reshape(m, eng.fft_size)

    def search(eng, x, label):
        m, cfc = x.shape[0], eng.code_fft_conj
        extra.append(wipe_case(x, eng.dopplers, eng._t, label,
                               k3_search(cfc, m), 3))
        extra.append(wipe_case(x, narrow_table(eng), eng._t, label,
                               k3_search(cfc, m), 3))
        spec = torch.fft.fft(pcps.pcps_wipe(x, eng.dopplers, eng._t), dim=-1)
        corr = torch.fft.ifft(
            spec[:, None] * eng.code_fft_conj[None, :, None], dim=-1)
        del spec
        extra.append(k3_peak_row(corr, x.shape[0], label, 3))
        del corr
        torch.cuda.empty_cache()

    acq = receiver_conf_from_config(InMemoryConfiguration(conf_properties(
        HYBRID_CONF.format(capture="", fs=int(FS_REF_HYBRID))))).acq
    eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
    search(eng, dwells(hybrid_sats(), eng, acq.max_dwells),
           f"GPS L1 C/A at {FS_REF_HYBRID / 1e6:g} Msps")
    e1 = pilot_receiver_conf().chains[0]
    eng = PcpsAcquisitionEngine(e1.acq, tuple(range(11, 21)),
                                code_provider=e1.code_provider,
                                sc_rate=e1.sc_rate, device=dev)
    search(eng, dwells(pilot_sats(), eng, e1.acq.max_dwells),
           f"phase 8's E1 two-step search at {FS_REF_HYBRID / 1e6:g} Msps")
    props = conf_properties(CONF.format(capture=""))
    props.update(BIT_PROPS)
    acq = receiver_conf_from_config(InMemoryConfiguration(props)).acq
    eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
    m, n = acq.max_dwells, eng.fft_size
    x = torch.from_numpy(synthesize(FS, 0.01, m * n).astype(np.complex64))
    search(eng, x.to(dev).reshape(m, n),
           f"GPS L1 C/A at {FS / 1e6:g} Msps, bit_transition_flag")


def check_wipe_path_shapes(dev, extra: list) -> None:
    """The wipeoff at the paths' shapes that the searches above do not
    launch it at, each held by wipe_case; the rows go to `extra`:
    - Tong's 10 single-dwell searches (phases 4d and 4e): 10 ms of the
      static scenario at 2 Msps as [10, N], N = 2000 and, with
      bit_transition_flag, 4000; PRNs 1-10;
    - the ROC harness's trials as dwells (phase 4f): 384 trials of one and
      of two dwells, M = 384 and 768, N = 2000, PRN 1 at 45 dB-Hz in
      unit noise (models/acq_performance.py:trial_signal), the trials
      searched as channels;
    - the time-sharded search's segment with its halo (phase 9): one dwell
      of L + N = 256000 samples of noise, D = 41 (no search: the path
      folds the correlations, K7)."""
    import torch
    from gnss_sim_receiver_tpu_torch import constants
    from gnss_sim_receiver_tpu_torch.models import acq_performance as perf
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    for keys, label in (({}, "Tong"), (BIT_PROPS,
                                        "Tong, bit_transition_flag")):
        props = conf_properties(CONF.format(capture=""))
        props["Acquisition_1C.implementation"] = \
            "GPS_L1_CA_PCPS_Tong_Acquisition"
        props.update(keys)
        acq = receiver_conf_from_config(InMemoryConfiguration(props)).acq
        eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
        m, n = acq.tong_max_dwells, eng.fft_size
        x = torch.from_numpy(synthesize(FS, m * n / FS).astype(
            np.complex64)).to(dev).reshape(m, n)
        extra.append(wipe_case(x, eng.dopplers, eng._t,
                               f"GPS L1 C/A at {FS / 1e6:g} Msps, {label}",
                               k3_search(eng.code_fft_conj, m), 3))
        torch.cuda.empty_cache()
    n, trials = 2000, 384
    code = prn_codes.sample_code(prn_codes.gps_l1_ca_code(1), FS,
                                 constants.GPS_L1_CA_CODE_RATE_CPS, n)
    cfc = torch.from_numpy(
        np.conj(np.fft.fft(code))[None].astype(np.complex64)).to(dev)
    code_t = torch.from_numpy(code.astype(np.float32)).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    amp = float(np.sqrt(2.0 * 10.0 ** 4.5 / FS))
    for m in (1, 2):
        x = perf.trial_signal(gen, code_t, amp, 1375.0, 700, n, trials, FS,
                              m).reshape(m * trials, n)

        def trials_search(w, m=m):
            corr = torch.fft.ifft(torch.fft.fft(w, dim=-1) * cfc[0],
                                  dim=-1).reshape(m, trials, -1, n)
            return pcps.pcps_peak(corr, m)
        extra.append(wipe_case(x, dops, pcps.time_axis(n, FS, dev),
                               f"the ROC harness, {trials} trials of {m} "
                               f"dwell{'s' if m > 1 else ''}",
                               trials_search, 3))
        del x
        torch.cuda.empty_cache()
    n = OS_PERIODS * 2000 + 2000
    x = _cnoise(np.random.default_rng(15), n, dev).reshape(1, n)
    extra.append(wipe_case(x, dops, pcps.time_axis(n, FS, dev),
                           "the time-sharded search's segment and halo",
                           None, 3))
    torch.cuda.empty_cache()


def check_k3c(name: str, corr, m: int, spc: int, form: str, caf_bins: int,
              shape: str):
    """K3c (pcps_second_peak) in the grid form `form` on the correlations
    its search gives it, against its plain version (the grid materialised,
    then first_vs_second_peak_stat): the statistic to 1e-4 of its scale,
    the cells exact.  Timed whole (the form's row kernel, the tiles of the
    peak row, the ratio) and the row kernel alone, whose difference is
    what K3c adds to the search's peak; bound: the correlations read once
    (that of the added part: the peak row's planes read again)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    label = f"{form} form, spc={spc}" + (f", b={caf_bins}" if form == "caf"
                                         else "")
    got = pcps.pcps_second_peak(corr, m, spc, form, caf_bins)
    want = pcps._second_peak_plain(corr, spc, form, caf_bins)
    torch.cuda.synchronize()
    err = compare(f"K3c pcps_second_peak ({label}) statistic", got[0],
                  want[0], 1e-4)
    compare(f"K3c pcps_second_peak ({label}) cells", got[1:], want[1:], 0.0)
    ms = time_ms(lambda: pcps.pcps_second_peak(corr, m, spc, form,
                                               caf_bins))
    row_ms = time_ms(lambda: pcps._row_pass(corr, m, form, caf_bins, "K3c"))
    plain = time_ms(lambda: pcps._second_peak_plain(corr, spc, form,
                                                    caf_bins), reps=3)
    c, d, n = corr.shape[1], corr.shape[2], corr.shape[-1]
    planes = 1 if form == "plain" else 2
    k = 2 * caf_bins + 1 if form == "caf" else 1
    row_bytes = m * c * n * 8 * planes * k
    added_bound, _ = bound_ms(row_bytes, 0)
    print(f"  K3c ({label}): the peak row's tiles and the ratio add "
          f"{ms - row_ms:.4f} ms to the row kernel's {row_ms:.4f} ms; "
          f"their bound {added_bound:.4f} ms (the peak row's planes read "
          f"again, {row_bytes / 1e6:.3f} MB)")
    # per (dwell, cell) of the grid and again of the peak row: |.|^2 3
    # (plain), the sign hypotheses 12 (dual), two |.|^2 and their sum 8
    # per boxcar row (CAF); per cell compare, sum 2; per row cell the zone
    # 4 and the max 1
    per = {"plain": 3, "dual": 12, "caf": 8 * k}[form]
    n_ops = (m * c * d * n * per + c * d * n * (2 + (k if k > 1 else 0))
             + m * c * n * per + c * n * 5)
    row = _row(name, "triton", "gnss_sim_receiver_tpu_torch/ops/pcps.py",
               "gnss_sim_receiver_tpu/ops/pcps.py:123", err, ms, plain,
               corr.numel() * 8 + c * 12, n_ops, f"{label}: {shape}")
    row["added_ms"] = ms - row_ms
    row["added_bound_ms"] = added_bound
    return row


def check_k5a(dev, rng):
    """K5a against its plain version at N = 4 M (+3, an odd length):
    decimation 1, 2, 4 x taps 5, 31, 63 without mixing, and three of those
    with a nonzero IF (N < 2^24, where float32(n) holds every integer).
    Then against its plain version, and timed, at the main path's shape:
    the 26 s capture at 4 Msps (104 M samples), 31 taps, decimation 2, no
    mixing."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    x = _cnoise(rng, COND_SAMPLES + 3, dev)
    worst = 0.0
    cases = [(d, t, 0.0) for d in (1, 2, 4) for t in (5, 31, 63)]
    cases += [(2, 31, 1.0e6), (1, 5, -412.5e3), (4, 63, 1.0e6)]
    for dec, n_taps, fc in cases:
        taps = torch.from_numpy(filters.design_lowpass(n_taps, 0.45)).to(dev)
        w = filters.lo_step(fc, FS_FILE)
        xs = x if fc == 0.0 else x[:COND_SAMPLES]
        got = filters.fir_decim(xs, taps, dec, w)
        want = filters._fir_plain(
            xs if fc == 0.0 else filters._mix_plain(xs, w), taps, dec)
        ref = filters._fir_decim_reference(xs, taps, dec, w)
        torch.cuda.synchronize()
        what = f"K5a fir_decim dec={dec} T={n_taps} IF={fc:g}"
        # 1e-5 of the scale: the kernel sums the taps by fused multiply-adds
        worst = max(worst, compare(what, got, want, 1e-5))
        fir_bits(what, got, ref)
    del x, got, want, ref
    n, n_taps, dec = int(FS_FILE * DUR), 31, 2
    x = _cnoise(rng, n, dev)
    taps = torch.from_numpy(filters.design_lowpass(n_taps, 0.45)).to(dev)
    got = filters.fir_decim(x, taps, dec)
    want = filters._fir_plain(x, taps, dec)
    ref = filters._fir_decim_reference(x, taps, dec)
    torch.cuda.synchronize()
    what = f"K5a fir_decim N={n} dec={dec} T={n_taps} (the main path's shape)"
    worst = max(worst, compare(what, got, want, 1e-5))
    fir_bits(what, got, ref)
    del want, ref
    ms = time_ms(lambda: filters.fir_decim(x, taps, dec), reps=3)
    ref_ms = time_ms(lambda: filters._fir_decim_reference(x, taps, dec),
                     reps=3)
    print(f"  K5a fir_decim (the main path's shape): {ms:.4f} ms, the "
          f"kernel before its redesign {ref_ms:.4f} ms; "
          f"{sm_clock_during(lambda: filters.fir_decim(x, taps, dec))}")
    plain = time_ms(lambda: filters._fir_plain(x, taps, dec), reps=1)
    # the library yardstick: one conv1d over the two planes, given them
    # already split and padded (float32, TF32 off); the port never calls it
    pad = n_taps // 2
    planes = torch.nn.functional.pad(
        torch.view_as_real(x).T.contiguous(), (pad, n_taps - 1 - pad))[:, None]
    kern = taps.flip(0)[None, None].contiguous()
    lib = torch.nn.functional.conv1d(planes, kern, stride=dec)
    compare("K5a conv1d yardstick against the kernel",
            torch.view_as_complex(lib[:, 0].T.contiguous()), got, 1e-5)
    del lib, got
    library = time_ms(lambda: torch.nn.functional.conv1d(planes, kern,
                                                         stride=dec), reps=3)
    n_out = -(-n // dec)
    row = _row("K5a_fir_decim", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/fir_decim.cu",
               "gnss_sim_receiver_tpu/ops/filters.py:29", worst, ms, plain,
               8 * n + 4 * n_taps + 8 * n_out, 4 * n_taps * n_out,
               f"N={n} samples, T={n_taps} taps, decimation {dec}, no mixing",
               library)
    row["reference_ms"] = ref_ms
    return row


def fir_bits(what: str, got, ref) -> None:
    """K5a's output bit for bit that of the kernel before its redesign."""
    import torch
    if not torch.equal(bits(got), bits(ref)):
        fail(f"{what}: differs from the kernel before its redesign in "
             f"{int((bits(got) != bits(ref)).sum())} words")
    print(f"  {what}: bit for bit the kernel before its redesign")


def check_k5b(dev, rng):
    """K5b at the length, notch frequency and width that phase 4b gives it
    (N = 1 M + 5: 16 CTAs of chunks, so the carries cross CTAs) against the
    sequential plain version run on the card over the whole stream, with a
    strong continuous wave on the notch.  Returns the row and the (input,
    plain output) pair, which phase 4b sends through the conditioner."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    n, f0, bw = NOTCH_SAMPLES, NOTCH_F0, NOTCH_BW
    x = _cnoise(rng, n, dev)
    x = x + 10.0 * torch.exp(2j * np.pi * f0 * torch.arange(
        n, device=dev, dtype=torch.float64)).to(torch.complex64)
    got = filters.notch_filter(x, f0, bw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = filters._notch_plain(x, *filters.notch_coefficients(f0, bw))
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    # 1e-4 of the scale: the chunk carries round differently from the
    # sequential scan; the pole radius 1 - pi*bw forgets them
    err = compare(f"K5b notch_filter N={n} f0={f0} bw={bw}", got, want, 1e-4)
    ms = time_ms(lambda: filters.notch_filter(x, f0, bw))
    for n_big in (COND_SAMPLES, int(FS_FILE * DUR)):
        xb = _cnoise(rng, n_big, dev)
        t = time_ms(lambda: filters.notch_filter(xb, f0, bw), reps=3)
        print(f"  K5b notch_filter at N={n_big} (timed only): {t:.4f} ms "
              f"(bound {bound_ms(16 * n_big, 16 * n_big)[0]:.4f} ms)")
        del xb
    row = _row("K5b_notch_filter", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/notch.cu",
               "gnss_sim_receiver_tpu/ops/filters.py:58", err, ms, plain,
               16 * n, 16 * n,
               f"N={n} samples, f0={f0}, bw={bw}; plain_ms is one eager run, "
               "host-timed")
    return row, (x, want)


def check_k5c(dev, rng):
    """K5c at 4 M samples with an even window count, and with an odd count
    and a ragged tail; pulses over some windows.  The outputs must be
    identical: the same windows blanked, every other sample untouched."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    worst = 0.0
    for n in (COND_SAMPLES, COND_SAMPLES - 64 + 17):
        x = _cnoise(rng, n, dev) * float(np.sqrt(0.5))
        for start in rng.integers(0, n - 200, 50):
            x[start:start + 150] += 40.0
        got = filters.pulse_blanking(x, 4.0, 64)
        want = filters._blank_plain(x, 4.0, 64)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        print(f"  K5c pulse_blanking N={n} ({n // 64} windows): "
              f"{int((want == 0).sum())} samples blanked, {n_diff} differ")
        if n_diff:
            fail(f"K5c pulse_blanking: {n_diff} samples differ")
        worst = max(worst, float((got - want).abs().max()))
    ms = time_ms(lambda: filters.pulse_blanking(x, 4.0, 64))
    plain = time_ms(lambda: filters._blank_plain(x, 4.0, 64), reps=5)
    return _row("K5c_pulse_blanking", "triton",
                "gnss_sim_receiver_tpu_torch/ops/filters.py",
                "gnss_sim_receiver_tpu/ops/filters.py:82", worst, ms, plain,
                16 * n + 8 * (n // 64), 5 * n,
                f"N={n} samples, {n // 64} windows of 64 and a ragged tail")


def check_k5d(dev, rng):
    """K5d, both modes at ratios 2.0 and 4/3 from 4 M samples.  Direct
    must be identical (the same float32 index picks the same sample);
    linear to 1e-6 of the scale (multiply-add contraction).  One row per
    mode: each has its wrapper, its counter and its compiled kernel."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import resampler
    n = COND_SAMPLES
    x = _cnoise(rng, n, dev)
    worst = 0.0
    for ratio in (2.0, 4.0 / 3.0):
        n_out = resampler.output_length(n, ratio, 1.0)
        got = resampler.direct_resampler(x, ratio, n_out)
        want = resampler._direct_plain(x, float(np.float32(ratio)), n_out)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K5d direct_resampler ratio {ratio}: outputs differ")
        print(f"  K5d direct_resampler ratio {ratio:.4f}: identical")
        got = resampler.linear_resampler(x, ratio, n_out)
        want = resampler._linear_plain(x, float(np.float32(ratio)), n_out)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"K5d linear_resampler ratio {ratio:.4f}", got, want, 1e-6))
    # both modes timed as phase 4b launches them: direct 4 M -> 2 M (ratio
    # 2), linear 4 M -> 3 M (ratio 4/3)
    src = "gnss_sim_receiver_tpu_torch/ops/resampler.py"
    n_d = resampler.output_length(n, 2.0, 1.0)
    n_l = resampler.output_length(n, 4.0 / 3.0, 1.0)
    r32 = float(np.float32(4.0 / 3.0))
    return [
        _row("K5d_direct_resampler", "triton", src,
             "gnss_sim_receiver_tpu/ops/resampler.py:25", 0.0,
             time_ms(lambda: resampler.direct_resampler(x, 2.0, n_d)),
             time_ms(lambda: resampler._direct_plain(x, 2.0, n_d), reps=5),
             8 * n_d + 8 * n_d, 3 * n_d,
             f"{n} -> {n_d} samples, ratio 2 (reads every second sample)"),
        _row("K5d_linear_resampler", "triton", src,
             "gnss_sim_receiver_tpu/ops/resampler.py:35", worst,
             time_ms(lambda: resampler.linear_resampler(x, 4.0 / 3.0, n_l)),
             time_ms(lambda: resampler._linear_plain(x, r32, n_l), reps=5),
             8 * n + 8 * n_l, 10 * n_l,
             f"{n} -> {n_l} samples, ratio 4/3")]


def check_k3b(dev):
    """K3b at the main-path shape: M=2 dwells, C=8 channels, D2=2*4+1=9
    Doppler rows per channel, N=2000; then the whole two-step search
    against its plain composition."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    acq = AcqConf(fs_in=FS, max_dwells=2)
    x = acq_dwells(dev)
    cfc = torch.from_numpy(code_replicas(acq, range(1, 9))).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    t = pcps.time_axis(2000, FS, dev)
    m, n, c, d2 = 2, 2000, 8, 9
    centers = dops[torch.arange(c, device=dev) * 5]
    dops2 = (centers[:, None] + (torch.arange(d2, device=dev) - 4)[None, :]
             * 125.0).to(torch.float32).contiguous()
    row = wipe_case(x, dops2, t, f"GPS L1 C/A at {FS / 1e6:g} Msps",
                    k3_search(cfc, m))

    def plain_search():
        stat, di, de = pcps.max_to_input_power_stat(
            pcps.pcps_grid(x, cfc, dops, FS), 2.0)
        hz = dops[di.long()]
        d2s = hz[:, None] + ((torch.arange(d2, device=dev) - 4)
                             * 125.0).to(torch.float32)[None, :]
        stat2, di2, _ = pcps.max_to_input_power_stat(
            pcps.pcps_grid_per_channel(x, cfc, d2s, FS), 2.0)
        return torch.stack([stat, torch.gather(d2s, 1, di2.long()[:, None]
                                               )[:, 0],
                            de.to(torch.float32), stat2])
    got = pcps.pcps_search_two_steps(x, cfc, dops, t, True, 4, 125.0)
    want = plain_search()
    compare("K3b two-step search [4, C]", got, want, 1e-4)
    port = time_ms(lambda: pcps.pcps_search_two_steps(x, cfc, dops, t, True,
                                                      4, 125.0))
    print(f"  K3b two-step search (M={m}, C={c}, D=41 then D2={d2}, N={n}): "
          f"port {port:.4f} ms, torch.fft + torch ops yardstick "
          f"{time_ms(plain_search):.4f} ms")
    return row


def hybrid_chain(fs: float, impl: str = "CCCWSR", keys: dict | None = None):
    """The Galileo E1-B chain that the factory builds from phase 5's conf
    text at rate `fs` with Galileo_E1_PCPS_<impl>_Ambiguous_Acquisition
    and the conf `keys`: the path's acquisition and tracking confs."""
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    props = conf_properties(HYBRID_CONF.format(capture="", fs=int(fs)))
    props["Acquisition_1B.implementation"] = \
        f"Galileo_E1_PCPS_{impl}_Ambiguous_Acquisition"
    props.update(keys or {})
    (chain,) = receiver_conf_from_config(InMemoryConfiguration(props)).chains
    return chain


def check_k4a(dev, fs: float, variant: str, extra: list,
              k3c: list):
    """K4a on the planes its path gives it: the hybrid scenario's first
    dwells at rate `fs`, the E1 chain's acquisition conf (M=2 dwells, D=81
    Doppler bins, N = 4 ms of samples), C=10 channels (PRNs 11-20, of which
    11-15 are present).  The kernel against its plain version on the same
    planes (statistic to 1e-4 of its scale, cells exact), and the whole
    search against the JAX-form grid (pcps_cccwsr_grid / pcps_8ms_grid) and
    statistic.  Returns the row of phase 5's shape (CCCWSR at 20 Msps); the
    other results go to `extra`.  At that shape K3c's dual form is held on
    the same planes too, its row appended to `k3c`."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    chain = hybrid_chain(fs, {"cccwsr": "CCCWSR", "8ms": "8ms"}[variant])
    acq = chain.acq
    prns = tuple(range(11, 21))
    eng = PcpsAcquisitionEngine(
        acq, prns, code_provider=chain.code_provider, sc_rate=chain.sc_rate,
        code_provider2=chain.data_code_provider)
    m, need, n = acq.max_dwells, eng.n_samples_needed, eng.fft_size
    x = torch.from_numpy(synthesize_hybrid(fs, need)).to(dev).reshape(m, -1)
    cfc = eng.code_fft_conj
    cfc2 = eng.code2_fft_conj if eng.code2_fft_conj is not None else cfc
    label = f"{variant} at {fs / 1e6:g} Msps"
    if fs == FS_REF_HYBRID:
        extra.append(wipe_case(
            x, eng.dopplers, eng._t, f"Galileo E1 {label}",
            lambda w: pcps.pcps_dual_peak(pcps.dual_from_wiped(
                w, cfc, cfc2, variant), m), 3))
    corr = pcps.dual_correlations(x, cfc, cfc2, eng.dopplers, eng._t,
                                  variant)
    got = pcps.pcps_dual_peak(corr, m)
    want = pcps._dual_peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare(f"K4a pcps_dual_peak ({label}) statistic", got[0], want[0],
                  1e-4)
    compare(f"K4a pcps_dual_peak ({label}) cells", got[1:], want[1:], 0.0)
    # the whole search against the JAX functions' form, line for line
    buf = pcps.pcps_search_dual(x, cfc, cfc2, eng.dopplers, eng._t, variant)
    if variant == "cccwsr":
        grid = pcps.pcps_cccwsr_grid(x, cfc2, cfc, eng.dopplers, fs)
    else:
        grid = pcps.pcps_8ms_grid(x, cfc, eng.dopplers, fs)
    stat, di, de = pcps.max_to_input_power_stat(grid, float(2 * m))
    del grid
    compare(f"K4a search ({label}) statistic", buf[0], stat, 1e-4)
    compare(f"K4a search ({label}) Doppler and delay",
            buf[1:3].to(torch.int64),
            torch.stack([eng.dopplers[di.long()], de.float()]).to(
                torch.int64), 0.0)
    found = [p for p, v in zip(prns, buf[0].tolist()) if v > eng.threshold]
    print(f"  K4a search ({label}): detected PRNs {found} (threshold "
          f"{eng.threshold:.2f})")
    if found != [11, 12, 13, 14, 15]:
        fail(f"K4a search ({label}) detected {found}")
    ms = time_ms(lambda: pcps.pcps_dual_peak(corr, m))
    plain = time_ms(lambda: pcps._dual_peak_plain(corr, m), reps=3)
    c, d = len(prns), len(eng.dopplers)
    # per (dwell, cell): sums and differences 4, two |.|^2 6, max 1,
    # accumulate 1; per cell: compare and sum 2
    row = _row("K4a_pcps_dual_peak", "triton",
               "gnss_sim_receiver_tpu_torch/ops/pcps.py",
               "gnss_sim_receiver_tpu/ops/pcps.py:"
               + ("242" if variant == "cccwsr" else "213"), err, ms, plain,
               corr.numel() * 8 + c * 12, m * c * d * n * 12 + c * d * n * 2,
               f"{label}: M={m} dwells, C={c} channels, D={d} Doppler bins, "
               f"N={n} samples, two [M, C, D, N] complex64 planes "
               f"({corr.numel() * 8 / 1e6:.1f} MB)")
    if variant == "cccwsr" and fs == FS_REF_HYBRID:
        k3c.append(check_k3c(
            "K3c_pcps_second_peak_dual", corr, m, eng.samples_per_chip,
            "dual", 0, f"{label}: M={m} dwells, C={c} channels, D={d} "
            f"Doppler bins, N={n} samples"))
    del corr
    torch.cuda.empty_cache()
    if variant == "cccwsr" and fs == FS_REF_HYBRID:
        return row
    extra.append(row)
    return None


def check_k4c(dev, extra: list, k3c: list):
    """K4c on the planes its path gives it: phase 7's first dwells (the
    device generator's, seed 17), the E5a chain's acquisition conf (M=2
    dwells, D=41 Doppler bins of 250 Hz, N = 2 ms = 40000 samples: the
    doubled FFT of bit_transition_flag), C=10 channels (PRNs 11-20, of
    which 11-15 are present), with the CAF boxcar of phase 7's conf (b=1)
    and without it (b=0).  The kernel against its plain version on the
    same planes (statistic to 1e-4 of its scale, cells exact), the whole
    search against the JAX-form grid (pcps_e5a_noncoherent_iq_grid) and
    statistic, and the detection decision: the same PRNs above the
    threshold as the plain version, at least 3 of them, none absent.
    Returns the row of phase 7's shape (b=1); the b=0 row goes to
    `extra`.  At b=1 K3c's CAF form is held on the same planes too, its
    row appended to `k3c`."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    _, e5a = wideband_chains()
    prns = tuple(range(11, 21))
    eng = PcpsAcquisitionEngine(
        e5a.acq, prns, code_provider=e5a.code_provider, sc_rate=e5a.sc_rate,
        code_provider2=e5a.data_code_provider)
    m, need, n = e5a.acq.max_dwells, eng.n_samples_needed, eng.fft_size
    x = wideband_dwells(dev, need).reshape(m, n)
    cfi, cfq = eng.code_fft_conj, eng.code2_fft_conj
    if n != 2 * eng.n_coherent:
        fail("K4c: phase 7's E5a search does not double its FFT")
    corr = pcps.dual_correlations(x, cfi, cfq, eng.dopplers, eng._t,
                                  "iq_caf")
    c, d = len(prns), len(eng.dopplers)
    row = None
    for b in (0, e5a.acq.caf_bins):
        label = f"E5a I/Q, b={b}, at {FS_WIDEBAND / 1e6:g} Msps"
        got = pcps.pcps_caf_peak(corr, m, b)
        want = pcps._caf_peak_plain(corr, m, b)
        torch.cuda.synchronize()
        err = compare(f"K4c pcps_caf_peak ({label}) statistic", got[0],
                      want[0], 1e-4)
        compare(f"K4c pcps_caf_peak ({label}) cells", got[1:], want[1:], 0.0)
        buf = pcps.pcps_search_iq_caf(x, cfi, cfq, eng.dopplers, eng._t, b)
        stat, di, de = pcps.max_to_input_power_stat(
            pcps.pcps_e5a_noncoherent_iq_grid(x, cfi, cfq, eng.dopplers,
                                              FS_WIDEBAND, b), float(2 * m))
        compare(f"K4c search ({label}) statistic", buf[0], stat, 1e-4)
        compare(f"K4c search ({label}) Doppler and delay",
                buf[1:3].to(torch.int64),
                torch.stack([eng.dopplers[di.long()], de.float()]).to(
                    torch.int64), 0.0)
        found = [p for p, v in zip(prns, buf[0].tolist())
                 if v > eng.threshold]
        plain = [p for p, v in zip(prns, stat.tolist()) if v > eng.threshold]
        print(f"  K4c search ({label}): detected PRNs {found}, the plain "
              f"version {plain} (threshold {eng.threshold:.2f})")
        if found != plain or not set(found) <= set(HYB_GAL_PRNS) \
                or len(found) < 3:
            fail(f"K4c search ({label}) detected {found}, plain {plain}")
        ms = time_ms(lambda: pcps.pcps_caf_peak(corr, m, b))
        plain = time_ms(lambda: pcps._caf_peak_plain(corr, m, b), reps=3)
        # per (dwell, cell): two |.|^2 6, accumulate 2; per cell: the
        # boxcar's 2b + 1 multiply-adds, compare and sum 2
        r = _row("K4c_pcps_caf_peak", "triton",
                 "gnss_sim_receiver_tpu_torch/ops/pcps.py",
                 "gnss_sim_receiver_tpu/ops/pcps.py:269", err, ms, plain,
                 corr.numel() * 8 + c * 12,
                 m * c * d * n * 8 + c * d * n * (2 * (2 * b + 1) + 2),
                 f"{label}: M={m} dwells, C={c} channels, D={d} Doppler "
                 f"bins, N={n} samples, the I and Q [M, C, D, N] complex64 "
                 f"planes ({corr.numel() * 8 / 1e6:.1f} MB)")
        if b == e5a.acq.caf_bins:
            row = r
            k3c.append(check_k3c(
                "K3c_pcps_second_peak_caf", corr, m, eng.samples_per_chip,
                "caf", b, f"E5a I/Q at {FS_WIDEBAND / 1e6:g} Msps: M={m} "
                f"dwells, C={c} channels, D={d} Doppler bins, N={n} "
                "samples"))
        else:
            extra.append(r)
    del corr
    torch.cuda.empty_cache()
    return row


def check_wideband_shapes(dev, rng, extra: list) -> None:
    """K1 and K2 with the 10230-chip E5a-I tables of phase 7's E5a chain,
    and K3 (both kernels) and K3b at its L5 chain's acquisition shape
    (M=2, C=10 PRNs 1-10, D=41, N=20000; D2=9), each against its plain
    version, timed; the rows go to `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    l5, e5a = wideband_chains()
    taps = (0.25, 0.0, -0.25)
    label = f"Galileo E5a-I at {FS_WIDEBAND / 1e6:g} Msps"
    extra += [check_k1(dev, rng, e5a.trk, 10, 20, taps, 250,
                       "K1_block_correlate", label),
              check_k2(dev, rng, e5a.trk, 10, taps, e5a.code_provider,
                       "K2_multicorrelate", label)]
    torch.cuda.empty_cache()
    eng = PcpsAcquisitionEngine(l5.acq, tuple(range(1, 11)),
                                code_provider=l5.code_provider,
                                sc_rate=l5.sc_rate)
    m, n = l5.acq.max_dwells, eng.fft_size
    x = wideband_dwells(dev, eng.n_samples_needed).reshape(m, n)
    dops, t, cfc = eng.dopplers, eng._t, eng.code_fft_conj
    c, d = cfc.shape[0], dops.shape[0]
    label = f"GPS L5I at {FS_WIDEBAND / 1e6:g} Msps"
    extra.append(wipe_case(x, dops, t, label, k3_search(cfc, m), 3))
    want = pcps._wipe_plain(x, dops, t)
    spec = torch.fft.fft(want, dim=-1)
    del want
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    del spec
    extra.append(k3_peak_row(corr, m, label, 3))
    del corr
    d2 = 2 * l5.acq.num_doppler_bins_step2 + 1
    dops2 = (dops[torch.arange(c, device=dev) * 4][:, None]
             + (torch.arange(d2, device=dev) - d2 // 2)[None, :]
             * float(l5.acq.doppler_step2)).to(torch.float32).contiguous()
    extra.append(wipe_case(x, dops2, t, label, k3_search(cfc, m), 3))
    torch.cuda.empty_cache()


def check_k4b(dev, extra: list):
    """K4b (both kernels) at the GPS 2 Msps shape that phase 4d launches:
    M=8 dwells of the static scenario (QUICKSYNC_CONF's max_dwells), D=41
    Doppler bins, N=2000, fold 4, C=8 channels (PRNs 1-8).  The fold kernel
    against its plain version (1e-5 of the scale); the K3 peak kernel that
    follows it, on the [M, C, D, N/fold] planes, against its plain version
    (1e-4; its row at this shape goes to `extra`); the resolve kernel
    against its plain version at the folded search's own peaks (delays
    identical, magnitudes to 1e-4); then the whole search against the
    JAX-form grid, statistic and resolve at M=8."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                sampled_codes)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    fold = 4
    props = conf_properties(QUICKSYNC_CONF)
    m = int(props["Acquisition_1C.max_dwells"])
    if fold != int(props["Acquisition_1C.folding_factor"]):
        fail("K4b: the check's fold is not phase 4d's")
    acq = AcqConf(fs_in=FS, max_dwells=m)
    x = acq_dwells(dev, m)
    codes_h = sampled_codes(acq, range(1, 9))
    codes = torch.from_numpy(codes_h).to(dev)
    cffc = torch.from_numpy(pcps.fold_codes(codes_h, fold)).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    t = pcps.time_axis(2000, FS, dev)
    n, d, c = 2000, dops.shape[0], codes.shape[0]
    nf = n // fold
    src = "gnss_sim_receiver_tpu_torch/ops/pcps.py"
    got = pcps.pcps_quicksync_fold(x, dops, t, fold)
    want = pcps._fold_plain(x, dops, t, fold)
    torch.cuda.synchronize()
    err = compare("K4b pcps_quicksync_fold", got, want, 1e-5)
    rows = [_row(
        "K4b_quicksync_fold", "triton", src,
        "gnss_sim_receiver_tpu/ops/pcps.py:151", err,
        time_ms(lambda: pcps.pcps_quicksync_fold(x, dops, t, fold)),
        time_ms(lambda: pcps._fold_plain(x, dops, t, fold)),
        m * n * 8 + n * 4 + d * 4 + m * d * nf * 8,
        # per (dwell, bin, sample): phase 2, sincos 2, product 6, fold sum 2
        m * d * n * 12,
        f"M={m} dwells, D={d} Doppler bins, N={n} samples, fold {fold} "
        f"-> N/fold={nf}")]
    # the K3 peak kernel on the folded planes, as the search launches it
    spec = torch.fft.fft(want, dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cffc[None, :, None], dim=-1)
    peak = pcps.pcps_peak(corr, m)
    peak_plain = pcps._peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare("K3 pcps_peak (QuickSync planes)", peak, peak_plain, 1e-4)
    extra.append(_row(
        "K3_pcps_peak", "triton", src, "gnss_sim_receiver_tpu/ops/pcps.py:107",
        err, time_ms(lambda: pcps.pcps_peak(corr, m)),
        time_ms(lambda: pcps._peak_plain(corr, m)),
        m * c * d * nf * 8 + c * 12, m * c * d * nf * 3 + c * d * nf * 2,
        f"GPS L1 C/A QuickSync: M={m} dwells, C={c} channels, D={d} Doppler "
        f"bins, N/fold={nf} folded lags"))
    # the resolve at the folded search's peaks
    stat, di, lag = peak
    dop_hz = dops[di.long()].contiguous()
    got = pcps.pcps_quicksync_resolve(x[0], codes, dop_hz, lag, t, fold)
    want = pcps._resolve_plain(x[0], codes, dop_hz, lag, t, fold)
    torch.cuda.synchronize()
    compare("K4b pcps_quicksync_resolve delays", got[0], want[0], 0.0)
    err = compare("K4b pcps_quicksync_resolve magnitudes", got[1], want[1],
                  1e-4)
    rows.append(_row(
        "K4b_quicksync_resolve", "triton", src,
        "gnss_sim_receiver_tpu/ops/pcps.py:182", err,
        time_ms(lambda: pcps.pcps_quicksync_resolve(x[0], codes, dop_hz, lag,
                                                    t, fold)),
        time_ms(lambda: pcps._resolve_plain(x[0], codes, dop_hz, lag, t,
                                            fold)),
        n * 8 + n * 4 + c * n * 4 + c * 8 + c * 8,
        # per (channel, candidate, sample): phase 2, sincos 2, wipeoff 6,
        # index 2, multiply-accumulate 4
        c * fold * n * 16,
        f"C={c} channels x {fold} candidates, N={n} samples (dwell 0)"))
    del corr, spec
    # the whole search against the JAX functions' form
    buf = pcps.pcps_search_quicksync(x, codes, cffc, dops, t, fold)
    grid = pcps.pcps_quicksync_grid(x, codes, dops, FS, fold)
    ws, wd, wl = pcps.max_to_input_power_stat(grid, float(m))
    wdel, _ = pcps.quicksync_resolve(x[0], codes, dops[wd.long()], wl, FS,
                                     fold)
    compare("K4b search statistic", buf[0], ws, 1e-4)
    compare("K4b search Doppler and delay", buf[1:3].to(torch.int64),
            torch.stack([dops[wd.long()], (wdel % n).float()]).to(
                torch.int64), 0.0)
    found = [p for p, v in zip(range(1, 9), buf[0].tolist())
             if v > pcps.cfar_threshold(0.01, nf * d, m)]
    print(f"  K4b search: detected PRNs {found} at fold {fold}, {m} dwells "
          f"(port {time_ms(lambda: pcps.pcps_search_quicksync(x, codes, cffc, dops, t, fold)):.4f} ms)")
    return rows


def check_k6(dev, fs: float, sats, dur: float, seed: int, label: str):
    """K6 at the shape its path launches it at: the scenario `sats` at rate
    `fs`, `dur` seconds, one launch of K6_CHUNK samples.  Noiseless against
    its plain version on the card (1e-5 of the scale) on the first chunk
    (its first blocks gather at sub-chip indices k < 0) and on the last;
    on both chunks and on the path's own last chunk (n_total mod
    K6_CHUNK samples, which ends in a partial tile), noiseless and with
    the noise key the path draws from `seed`, bit for bit the kernel
    before its redesign (the reference, one thread per sample); then the
    noise: zero mean and unit variance (+-0.02), and the same samples
    whether the chunk is made in one launch or in two.  Both kernels timed
    noiseless and noisy, and the SM clock read while the new one runs."""
    import torch
    from gnss_sim_receiver_tpu_torch.sim import device_generator as dg
    b = 8192
    dg._fill_nav_bits(sats, seed)
    n_total = int(fs * dur)
    tabs = dg._prepare(sats, fs, n_total, 0, dev)
    n = K6_CHUNK
    n_sat = len(sats)
    neg = int((tabs[5][:, : n // b] < 0).sum())
    print(f"  K6 ({label}): {n_sat} satellites, {neg} of the first chunk's "
          f"{n_sat * (n // b)} (satellite, block) anchors have base < 0")
    if not neg:
        fail("K6: the first chunk has no negative sub-chip index")
    worst = 0.0
    path_key, _ = dg._noise_key(True, seed, None)

    def plain(blk0, n_s):
        sl = slice(blk0, blk0 + -(-n_s // b))
        return dg._expand_plain(*tabs[:5], *(a[:, sl] for a in tabs[5:10]),
                                tabs[10], n_s)
    # the path's own last chunk ends in a partial tile of the kernel
    tail = n_total % n
    if tail % K6_TILE == 0:
        fail(f"K6 ({label}): the last chunk ({tail} samples) fills whole "
             "tiles")
    for blk0, n_s in ((0, n), ((n_total - n) // b, n),
                      ((n_total - tail) // b, tail)):
        got = dg.expand(*tabs, n_s, blk0=blk0)
        want = plain(blk0, n_s)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"K6 device_generator ({label}, block {blk0}, {n_s} samples)",
            got, want, 1e-5))
        for key in (None, path_key):
            kw = dict(blk0=blk0, noise_key=key, sample0=blk0 * b)
            got = dg.expand(*tabs, n_s, **kw)
            ref = dg._expand_reference(*tabs, n_s, **kw)
            what = (f"K6 ({label}, block {blk0}, {n_s} samples, "
                    f"{'noiseless' if key is None else 'noisy'})")
            if not torch.equal(bits(got), bits(ref)):
                fail(f"{what}: {int((bits(got) != bits(ref)).sum())} words "
                     "differ from the reference kernel's")
            print(f"  {what}: bit for bit the reference kernel")
    clean = dg.expand(*tabs, n)
    key = 0x5EED0000 + seed
    noisy = dg.expand(*tabs, n, noise_key=key)
    half = n // 2
    split = torch.cat([dg.expand(*tabs, half, noise_key=key),
                       dg.expand(*tabs, half, blk0=half // b, noise_key=key,
                                 sample0=half)])
    z = (noisy - clean).to(torch.complex128)
    mean = complex(z.mean())
    var = float((z.abs() ** 2).mean())
    print(f"  K6 noise ({label}): mean {mean:.2e}, variance {var:.5f}; "
          f"two launches {'identical' if torch.equal(split, noisy) else 'DIFFER'}")
    if abs(mean) > 0.01 or abs(var - 1.0) > 0.02 or \
            not torch.equal(split, noisy):
        fail(f"K6 noise ({label})")
    del clean, noisy, split, z, got, want, ref
    ms = time_ms(lambda: dg.expand(*tabs, n))
    noisy_ms = time_ms(lambda: dg.expand(*tabs, n, noise_key=path_key))
    ref_ms = time_ms(lambda: dg._expand_reference(*tabs, n))
    ref_noisy_ms = time_ms(lambda: dg._expand_reference(
        *tabs, n, noise_key=path_key))
    clock = sm_clock_during(lambda: dg.expand(*tabs, n))
    print(f"  K6 ({label}): noiseless {ms:.4f} ms (reference kernel "
          f"{ref_ms:.4f}), noisy {noisy_ms:.4f} ms (reference kernel "
          f"{ref_noisy_ms:.4f}); SM clock over back-to-back noiseless "
          f"launches {clock}")
    plain_ms = time_ms(lambda: plain(0, n), reps=3)
    nblk = -(-n // b)
    n_bytes = (8 * n + 20 * n_sat * nblk + tabs[0].numel()
               + tabs[2].numel() + 16 * n_sat)
    # per (sample, satellite): chip offset 2, floor and index 2, two
    # floor-mods and a floor-div 6, chip x symbol x amplitude 2, phase 2,
    # sincos 2, accumulate 4
    n_ops = n * n_sat * 20
    row = _row("K6_device_generator", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/device_generator.cu",
               "gnss_sim_receiver_tpu/sim/device_generator.py:32", worst,
               ms, plain_ms, n_bytes, n_ops,
               f"{label}: S={n_sat} satellites, one launch of {n} samples "
               f"(of {n_total}), tables {tuple(tabs[0].shape)} and "
               f"{tuple(tabs[2].shape)} int8, noiseless")
    row.update(noisy_ms=noisy_ms, reference_ms=ref_ms,
               reference_noisy_ms=ref_noisy_ms, sm_clock=clock)
    return row


# K7 at phase 9's time-sharded shape (127 code periods of PRN 7 at 2 Msps,
# L + N = 256000, a smooth cuFFT size, D = 41 bins) and at L = 4 periods
OS_PERIODS = 127
OS_PRN = 7
OS_DELAY, OS_DOPPLER = 777, 1500.0


def check_k7(dev, rng, extra: list) -> dict:
    """K7 (pcps_window_fold) against its plain version on the card: [D, L +
    N] complex64 correlations folded to [D, N], 1e-5 of the plain grid's
    largest value (the windows are summed in order, torch.sum in its own).
    Returns the row of phase 9's shape; the L = 4 N row goes to `extra`."""
    from gnss_sim_receiver_tpu_torch.ops import pcps
    n = 2000
    out = []
    for d, periods in ((41, OS_PERIODS), (4, 4)):
        row_len = (periods + 1) * n
        corr = _cnoise(rng, d * row_len, dev).reshape(d, row_len)
        got = pcps.pcps_window_fold(corr, n)
        want = pcps._window_fold_plain(corr, n)
        err = compare(f"K7 pcps_window_fold (D={d}, L={periods} N)", got,
                      want, 1e-5)
        n_lags = periods * n
        out.append(_row(
            "K7_pcps_window_fold", "triton",
            "gnss_sim_receiver_tpu_torch/ops/pcps.py",
            "gnss_sim_receiver_tpu/parallel/shard_steps.py:226", err,
            time_ms(lambda: pcps.pcps_window_fold(corr, n)),
            time_ms(lambda: pcps._window_fold_plain(corr, n)),
            d * n_lags * 8 + d * n * 4, d * n_lags * 4,
            f"D={d} Doppler bins, L={n_lags} lags of {periods} periods, "
            f"N={n}"))
        del corr, got, want
    extra.append(out[1])
    return out[0]


def check_k3_rows(dev) -> dict:
    """K3's row kernel alone (pcps_rows: per channel and Doppler row the
    max, first argmax and sum of the grid), the Doppler-sharded search's
    reduction, at phase 9's shape: the static scenario's 2 dwells against
    all 32 PRNs' replicas, 41 bins.  Against its plain version: the maxima
    and sums within 1e-5 of the largest; each row's argmax a cell of the
    plain grid holding the row's max within that tolerance (two cells a
    rounding apart may swap)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    x = acq_dwells(dev)
    cfc = torch.from_numpy(code_replicas(AcqConf(fs_in=FS, max_dwells=2),
                                         range(1, 33))).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    spec = torch.fft.fft(pcps.pcps_wipe(x, dops, pcps.time_axis(2000, FS,
                                                                dev)), dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    m, c, d, n = corr.shape
    got, want = pcps.pcps_rows(corr, m), pcps._rows_plain(corr)
    err = compare("K3 pcps_rows (max, sum)", (got[0], got[2]),
                  (want[0], want[2]), 1e-5)
    at = torch.gather(pcps._plain_grid(corr), -1,
                      got[1].long()[..., None])[..., 0]
    compare("K3 pcps_rows, the plain grid at each row's argmax", at,
            want[0], 1e-5)
    print(f"  K3 pcps_rows: {int((got[1] != want[1]).sum())} of {c * d} row "
          "argmaxes differ from the plain version's")
    return _row("K3_pcps_rows", "triton",
                "gnss_sim_receiver_tpu_torch/ops/pcps.py",
                "gnss_sim_receiver_tpu/parallel/shard_steps.py:164", err,
                time_ms(lambda: pcps.pcps_rows(corr, m)),
                time_ms(lambda: pcps._rows_plain(corr)),
                m * c * d * n * 8 + c * d * 12,
                m * c * d * n * 3 + c * d * n * 2,
                f"M={m} dwells, C={c} channels, D={d} Doppler bins, "
                f"N={n} samples")


SIGMA_BATCH = 4096


def _spd(rng, b: int, n: int, dev, scale: float = 1.0):
    import torch
    a = rng.standard_normal((b, n, n))
    m = scale * (a @ np.swapaxes(a, -1, -2) / n + 0.5 * np.eye(n))
    return torch.from_numpy(m.astype(np.float32)).to(dev)


def check_k10(dev, rng, extra: list) -> list:
    """K10a (sigma_points) and K10b (sigma_moments, the time and the
    measurement update) against their plain versions on the card at B =
    SIGMA_BATCH filters, nx = 4, nz = 2 (phase 9b's shape) under both
    rules and at nx = 9 (an 8-state PVT filter plus one), each within 1e-5
    of the largest plain value: the factor, the sums and the solve run in
    other orders (cuSOLVER's and cuBLAS's for the plain versions).  Timed
    beside torch.linalg.cholesky_ex on [B, nx, nx] and
    torch.linalg.solve_ex on [B, nz, nz] (the library reference times; the
    _ex forms skip the host sync of the error check).  Returns the rows of
    the cubature rule at nx = 4; the others go to `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    b = SIGMA_BATCH
    rows = []
    for rule, nx, nz in (("cubature", 4, 2), ("unscented", 4, 2),
                         ("cubature", 9, 2), ("unscented", 9, 2)):
        shape = f"B={b} filters, nx={nx}, nz={nz}, {rule}"
        pre, post, centre = nl._rule(nx, rule, None, torch.float32)
        x = torch.from_numpy(rng.standard_normal((b, nx)).astype(
            np.float32)).to(dev)
        P = _spd(rng, b, nx, dev)
        w = nl.sigma_weights(nx, rule, None, torch.float32, dev)
        n_pts = w.shape[0]
        pts = nl.sigma_points(x, P, rule)
        err = compare(f"K10a sigma_points ({shape})", pts,
                      nl._sigma_points_plain(x, P, pre, post, centre), 1e-5)
        plain_ms = time_ms(
            lambda: nl._sigma_points_plain(x, P, pre, post, centre))
        lib_ms = time_ms(lambda: torch.linalg.cholesky_ex(P))
        # operations: the factor n^3/3 multiply-adds, n square roots and
        # n^2/2 divisions; the points a multiply and an add per element
        ops = b * (2 * nx ** 3 / 3 + nx * nx / 2 + nx + 4 * nx * nx)
        k10a = _row("K10a_sigma_points", "cuda",
                    "gnss_sim_receiver_tpu_torch/csrc/sigma.cu",
                    "gnss_sim_receiver_tpu/ops/nonlinear.py:64", err,
                    time_ms(lambda: nl.sigma_points(x, P, rule)), plain_ms,
                    4 * b * (nx + nx * nx + n_pts * nx), ops, shape, lib_ms)
        F = torch.from_numpy(np.eye(nx, dtype=np.float32) + 0.05 * rng.
                             standard_normal((nx, nx)).astype(np.float32))
        H = torch.from_numpy(rng.standard_normal((nz, nx)).astype(
            np.float32))
        ypts = (pts @ F.to(dev).T).contiguous()
        # a linear measurement: P_zz is H P H^T + R under either rule (the
        # unscented centre weight is negative at nx > 3), so the solve is
        # well conditioned and the check measures the kernel's rounding
        zpts = (pts @ H.to(dev).T).contiguous()
        Q = 0.01 * torch.eye(nx, device=dev)
        R = _spd(rng, b, nz, dev, 0.1)
        z = torch.from_numpy(rng.standard_normal((b, nz)).astype(
            np.float32)).to(dev)
        compare(f"K10b sigma_moments, time update ({shape})",
                nl.sigma_moments(ypts, w, Q),
                nl._sigma_moments_plain(ypts, w, Q), 1e-5)
        upd = dict(z=z, x_pred=x, P_pred=P, pts=pts)
        err = compare(f"K10b sigma_moments, measurement update ({shape})",
                      nl.sigma_moments(zpts, w, R, **upd),
                      nl._sigma_moments_plain(zpts, w, R, **upd), 1e-5)
        plain_ms = time_ms(
            lambda: nl._sigma_moments_plain(zpts, w, R, **upd))
        pzz = _spd(rng, b, nz, dev)
        rhs = torch.from_numpy(rng.standard_normal((b, nz, nx)).astype(
            np.float32)).to(dev)
        lib_ms = time_ms(lambda: torch.linalg.solve_ex(pzz, rhs))
        print("  K10b the time update: "
              f"{time_ms(lambda: nl.sigma_moments(ypts, w, Q)):.4f} ms")
        # the measurement update: the z mean and deviations, P_zz, P_xz,
        # the LU and the substitutions, K P_zz K^T, x, the symmetrisation
        ops = b * (3 * n_pts * nz + n_pts * nx + 3 * n_pts * nz * nz
                   + 3 * n_pts * nx * nz + 2 * nz ** 3 / 3
                   + 2 * nz * nz * nx + 2 * nx * nz * nz + 2 * nx * nx * nz
                   + 2 * nx * nz + 3 * nx * nx)
        n_bytes = 4 * (b * (nz + 2 * nx + 2 * nx * nx + n_pts * (nx + nz)
                            + nz * nz) + n_pts)
        k10b = _row("K10b_sigma_moments", "cuda",
                    "gnss_sim_receiver_tpu_torch/csrc/sigma.cu",
                    "gnss_sim_receiver_tpu/ops/nonlinear.py:80", err,
                    time_ms(lambda: nl.sigma_moments(zpts, w, R, **upd)),
                    plain_ms, n_bytes, ops,
                    shape + ", the measurement update", lib_ms)
        if rows:
            extra += [k10a, k10b]
        else:
            rows = [k10a, k10b]
    return rows


# ---- phases 4, 4b, 4c: the main paths --------------------------------------

def rx_true_ecef():
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    return geodesy.llh_to_ecef(np.radians(RX_LLH[0]), np.radians(RX_LLH[1]),
                               RX_LLH[2])


CONF = """\
GNSS-SDR.internal_fs_sps=2000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=4000000
InputFilter.implementation=Freq_Xlating_Fir_Filter
InputFilter.number_of_taps=31
InputFilter.cutoff=0.45
InputFilter.decimation_factor=2
InputFilter.IF=0
Resampler.implementation=Pass_Through
Channels_1C.count=8
Channels.in_acquisition=8
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.coherent_integration_time_ms=1
Acquisition_1C.pfa=0.01
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Acquisition_1C.max_dwells=2
Acquisition_1C.make_two_steps=true
Acquisition_1C.second_nbins=4
Acquisition_1C.second_doppler_step=125
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


# phase 5: the reference's hybrid operating point (conf/gnss-sdr_Hybrid_
# byte.conf as tests/test_cli.py:78-95 records it: an ibyte file at 20 Msps,
# 10 + 10 channels, E1 Doppler step 125 Hz, PLL 15 Hz, very-early-late 0.6
# chips), with CCCWSR acquisition on the E1 chain; every PRN unpinned
HYBRID_CONF = """\
GNSS-SDR.internal_fs_sps={fs}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs}
Channels_1C.count=10
Channels_1B.count=10
Channels.in_acquisition=20
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Acquisition_1B.implementation=Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition
Acquisition_1B.doppler_step=125
Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking
Tracking_1B.very_early_late_space_chips=0.6
Tracking_1B.pll_bw_hz=15
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
"""


# phase 7: the wideband operating point (BASELINE.json config 4: GPS L5 and
# Galileo E5a on one 20 Msps RF stream, 10 + 10 channels), the E5a chain on
# the non-coherent I/Q search with a 500 Hz CAF window (one 250 Hz Doppler
# bin each side); every PRN unpinned.  Both searches double their FFT
# (bit_transition_flag): the L5I and E5a-I data signals change sign at every
# 1 ms code epoch (NH10, CS20), and a 1 ms dwell cut by such an edge puts
# the Doppler peak up to ~800 Hz off, where the tracking FLL (decision-
# directed, +-250 Hz at 1 ms) locks 500 Hz off
WIDEBAND_CONF = """\
GNSS-SDR.internal_fs_sps={fs}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs}
Channels_L5.count=10
Channels_5X.count=10
Channels.in_acquisition=20
Acquisition_L5.implementation=GPS_L5i_PCPS_Acquisition
Acquisition_L5.bit_transition_flag=true
Tracking_L5.implementation=GPS_L5_DLL_PLL_Tracking
Acquisition_5X.implementation=Galileo_E5a_Noncoherent_IQ_Acquisition_CAF
Acquisition_5X.CAF_window_hz=500
Acquisition_5X.bit_transition_flag=true
Tracking_5X.implementation=Galileo_E5a_DLL_PLL_Tracking
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
"""


# phase 4d: phase 4's conf with QuickSync acquisition.  Folding the 1 ms
# dwell by 4 folds the noise of four segments into each lag; at the
# scenario's 47 dB-Hz two dwells leave most satellites under the threshold
# (the JAX engine's statistics are the same), so the search takes 8.
QUICKSYNC_CONF = CONF.replace(
    "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition",
    "Acquisition_1C.implementation=GPS_L1_CA_PCPS_QuickSync_Acquisition\n"
    "Acquisition_1C.folding_factor=4").replace(
    "Acquisition_1C.max_dwells=2", "Acquisition_1C.max_dwells=8")


def conf_properties(text: str) -> dict:
    """key -> value of a conf text's `key=value` lines."""
    return dict(line.split("=", 1) for line in text.splitlines()
                if "=" in line)


def synthesize(fs: float, dur: float, n_samples=None) -> np.ndarray:
    """The static scenario (6 satellites, 47 dB-Hz) at rate `fs`: all
    `dur` seconds of it, or its first `n_samples` samples."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        generate_baseband
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in SCENARIO_PRNS]
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, dur,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    return generate_baseband(
        sats, fs, int(fs * dur) if n_samples is None else n_samples,
        noise=True, seed=42, bandlimit_oversample=4)


def hybrid_sats():
    """The hybrid scenario's satellites: GPS PRNs 1, 3, 4, 5 (LNAV) and
    Galileo PRNs 11-15 (E1-B, I/NAV pages), 48 dB-Hz, the 26 s geometry
    (tests/test_hybrid_position.py:25-58)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    base = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    gps = [e for e in base if e.prn in HYB_GPS_PRNS]
    toe60 = round((T0 + 600) / 60.0) * 60.0   # INAV toe LSB is 60 s
    gal = [dataclasses.replace(e, system="Galileo", prn=prn, toe=toe60,
                               toc=toe60, iod_nav=137, bgd_e1e5b=0.0)
           for prn, e in zip(HYB_GAL_PRNS, (e for e in base
                                            if e.prn not in HYB_GPS_PRNS))]
    return build_static_scenario(gps + gal, rx_true_ecef(), T0, DUR,
                                 cn0_db_hz=48.0, subframe_cycle=(1, 2, 3))


def pilot_sats():
    """Phase 8's satellites: phase 5's scenario with both E1 components on
    every Galileo satellite, E1-B (its I/NAV pages) and E1-C (CS25 tiled,
    one chip per 4 ms code period), each at -3 dB, as
    tests/test_track_pilot.py:24-53 builds them."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch import signals
    split = 10.0 * np.log10(0.5)
    chips = np.tile(signals.e1c_secondary_code().astype(np.int8),
                    int(np.ceil(DUR * 250 / 25)) + 2)
    out = []
    for s in hybrid_sats():
        if s.system == "Galileo":
            s = dataclasses.replace(s, cn0_db_hz=s.cn0_db_hz + split)
            out += [s, dataclasses.replace(s, signal="1P", nav_bits=chips)]
        else:
            out.append(s)
    return out


def synthesize_hybrid(fs: float, n_samples: int) -> np.ndarray:
    """The first `n_samples` of the hybrid scenario at rate `fs`, by the
    host simulator (band-limited, seed 17)."""
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        generate_baseband
    return generate_baseband(hybrid_sats(), fs, n_samples, noise=True,
                             seed=17, bandlimit_oversample=4)


def e5a_satellites(ephs, rx_ecef, t0: float, dur: float, cn0: float):
    """Galileo E5a-I signals for Galileo ephemerides, as the scenario's L5
    branch builds GPS L5 ones (the scenario builder has no E5a band):
    the light-time delay fitted by a quadratic over `dur`, Doppler, code
    Doppler and carrier phase on the 1176.45 MHz carrier, F/NAV pages from
    `t0` spread by CS20 as per-epoch signs."""
    from gnss_sim_receiver_tpu_torch.nav import fnav
    from gnss_sim_receiver_tpu_torch.sim import scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    ts = np.array([0.0, dur / 2.0, dur])
    out = []
    for eph in ephs:
        d = np.array([scenario._light_time_delay(eph, rx_ecef, t0 + t)
                      for t in ts])
        d0 = d[0]
        d2 = (d[2] - 2.0 * d[1] + d[0]) / (dur / 2.0) ** 2
        d1 = (d[2] - d[0]) / dur - d2 * dur / 2.0
        pages = fnav.pages_for_ephemeris(
            eph, t0, n_repeats=int(np.ceil((dur + 20.0) / 40.0)))
        out.append(SatelliteSignalParams(
            prn=eph.prn, system="Galileo", signal="5X", cn0_db_hz=cn0,
            doppler_hz=-F_L5 * d1, doppler_rate_hz_s=-F_L5 * d2,
            delay_sec=d0, delay_chips=0.0,
            carrier_phase_rad=float(np.mod(-2.0 * np.pi * F_L5 * d0,
                                           2.0 * np.pi)),
            code_doppler_hz=-F_L5 * d1, carrier_ref_hz=F_L5,
            nav_bits=fnav.e5a_epoch_signs(pages, eph.prn)))
    return out


def wideband_sats():
    """Phase 7's satellites: phase 5's geometry with toe = toc = WB_TOE,
    GPS PRNs 1, 3, 4, 5 on L5 (CNAV at 50 bps, NH10) and Galileo PRNs 11-15
    on E5a-I (F/NAV, CS20), 48 dB-Hz."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    base = [dataclasses.replace(e, toe=WB_TOE, toc=WB_TOE)
            for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                            toe=WB_TOE)]
    gps = [e for e in base if e.prn in HYB_GPS_PRNS]
    gal = [dataclasses.replace(e, system="Galileo", prn=prn, iod_nav=137,
                               bgd_e1e5a=0.0)
           for prn, e in zip(HYB_GAL_PRNS, (e for e in base
                                            if e.prn not in HYB_GPS_PRNS))]
    sats = build_static_scenario(gps, rx_true_ecef(), T0, WB_DUR,
                                 cn0_db_hz=48.0, band="L5")
    sats += e5a_satellites(gal, rx_true_ecef(), T0, WB_DUR, 48.0)
    if [(s.signal, s.prn) for s in sats] != (
            [("L5", p) for p in HYB_GPS_PRNS]
            + [("5X", p) for p in HYB_GAL_PRNS]):
        fail(f"wideband scenario: {[(s.signal, s.prn) for s in sats]}")
    return sats


# (M, table form, N) of every wipeoff phase 3 held to its reference
WIPE_CHECKED: set = set()


def wipe_key(shape: tuple) -> tuple:
    """(M, "grid" or "table", N) of a wipeoff launch's (M, *table, N): the
    kernel's code paths and grid depend on M and N, its rows only repeat
    (the narrow tables' channel counts follow the acquisitions pending)."""
    return shape[0], "table" if len(shape) == 4 else "grid", shape[-1]


def max_ulps(got, ref) -> int:
    """The largest difference in units in the last place between two
    float32 (or complex64) tensors of the same signs."""
    import torch
    a, b = bits(got).to(torch.int64), bits(ref).to(torch.int64)
    return int((a - b).abs().max())


def k3_search(cfc, m: int):
    """The search after the wipeoff: cuFFT, the product with the code
    replicas [C, N] (one family, or the [C, D2] table's channel's own),
    cuFFT, K3's peak -> (stat, Doppler index, delay index)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps

    def search(wiped):
        spec = torch.fft.fft(wiped, dim=-1)
        if wiped.dim() == 3:
            spec = spec[:, None]
        return pcps.pcps_peak(torch.fft.ifft(
            spec * cfc[None, :, None], dim=-1), m)
    return search


def wipe_case(x, dops, t, label: str, search=None, plain_reps: int = 20):
    """The wipeoff (pcps_wipe, csrc/pcps_wipe.cu) at one shape its paths
    launch it at: within 1e-5 of the plain version's scale; bit for bit
    the Triton kernel it replaced (_wipe_reference), or else the largest
    difference in ulps printed; with `search` (wiped dwells -> stat,
    Doppler index, delay index), the search's outputs from both kernels'
    dwells: cells exact, the statistic within 1e-4 of its scale.  The
    kernel, the reference and the plain version timed in the same call;
    returns the row (reference_ms beside ms)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    per_channel = dops.dim() == 2
    name = "K3b_pcps_wipe_per_channel" if per_channel else "K3_pcps_wipe"
    plain = (pcps._wipe_per_channel_plain if per_channel
             else pcps._wipe_plain)
    m, n = x.shape
    got = pcps.pcps_wipe(x, dops, t)
    ref = pcps._wipe_reference(x, dops, t)
    want = plain(x, dops, t)
    torch.cuda.synchronize()
    err = compare(f"{name} ({label})", got, want, 1e-5)
    del want
    same = torch.equal(bits(got), bits(ref))
    ulps = 0 if same else max_ulps(got, ref)
    print(f"  {name} ({label}): "
          + ("bit for bit the Triton reference" if same else
             f"differs from the Triton reference by up to {ulps} ulps"))
    if search is not None:
        a, b = search(got), search(ref)
        torch.cuda.synchronize()
        compare(f"{name} ({label}) search statistic against the "
                "reference's", a[0], b[0], 1e-4)
        compare(f"{name} ({label}) search cells against the reference's",
                a[1:], b[1:], 0.0)
        del a, b
    del got, ref
    torch.cuda.empty_cache()
    WIPE_CHECKED.add(wipe_key((m, *dops.shape, n)))
    rows = dops.numel()
    ms = time_ms(lambda: pcps.pcps_wipe(x, dops, t))
    ref_ms = time_ms(lambda: pcps._wipe_reference(x, dops, t))
    plain_ms = time_ms(lambda: plain(x, dops, t), reps=plain_reps)
    table = (f"C={dops.shape[0]} channels, D2={dops.shape[1]} Doppler rows "
             "each" if per_channel else f"D={rows} Doppler bins")
    out_mb = m * rows * n * 8 / 1e6
    row = _row(name, "cuda", "gnss_sim_receiver_tpu_torch/csrc/pcps_wipe.cu",
               "gnss_sim_receiver_tpu/ops/pcps.py:"
               + ("65" if per_channel else "33"), err, ms, plain_ms,
               m * n * 8 + rows * 4 + n * 4 + m * rows * n * 8,
               m * rows * n * 10,        # phase 2, sincos 2, product 6
               f"{label}: M={m} dwells, {table}, N={n} samples "
               f"({out_mb:.1f} MB out)")
    print(f"  {name} ({label}): reference {ref_ms:.4f} ms")
    if out_mb >= 10 and ms > 2 * row["bound_ms"]:
        fail(f"{name} ({label}): {ms:.4f} ms, above twice its bound "
             f"{row['bound_ms']:.4f} ms")
    row.update(reference_ms=ref_ms, bit_for_bit=same, max_ulps=ulps)
    return row


def wideband_dwells(dev, n: int):
    """The first `n` samples of phase 7's scenario on the card, by the
    device generator (seed 17), for the phase 3 checks."""
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    return generate_baseband_device_resident(wideband_sats(), FS_WIDEBAND, n,
                                             noise=True, seed=17, device=dev)


def wideband_chains(fs: float = FS_WIDEBAND):
    """The (L5, E5a) chains that the factory builds from phase 7's conf."""
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    props = conf_properties(WIDEBAND_CONF.format(capture="", fs=int(fs)))
    return receiver_conf_from_config(InMemoryConfiguration(props)).chains


def full_chain_sats():
    """bench.py:_bench_full_chain's scenario (bench.py:128-155): 12
    satellites for a 12-channel receiver, 47 dB-Hz, LNAV subframes 1-3,
    120 s."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600,
                                  offsets_deg=FULL_OFFSETS)
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, FULL_DUR,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    if tuple(s.prn for s in sats) != FULL_PRNS:
        fail(f"full-chain scenario: satellites {[s.prn for s in sats]}")
    return sats


def capture_paths(root: str) -> dict:
    build = os.path.join(root, "build")
    return {"file": os.path.join(build, "static_scenario_26s_4msps_v1.ishort"),
            "direct": os.path.join(build, "static_scenario_8s_2msps_v1.npy"),
            "hybrid": os.path.join(build,
                                   "hybrid_scenario_26s_20msps_v1.ibyte"),
            "wideband": os.path.join(build,
                                     "wideband_scenario_60s_20msps_v1.ibyte")}


SYNTHESIZED = ("file", "direct")        # by the child processes


def make_capture(root: str, which: str) -> None:
    """Synthesize one capture into ``build/`` unless it is there: "file",
    the 26 s scenario at 4 Msps as interleaved int16 (104 M samples,
    416 MB), or "direct", its first 8 s at 2 Msps as complex64."""
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = capture_paths(root)[which]
    if os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    if which == "file":
        write_samples(tmp, synthesize(FS_FILE, DUR), "ishort", scale=200.0)
    else:
        with open(tmp, "wb") as fh:
            np.save(fh, synthesize(FS, DIRECT_DUR))
    os.replace(tmp, path)


def start_synthesis(root: str) -> dict:
    """One child process per host-synthesized capture, so that the
    synthesis runs beside phases 2 and 3."""
    return {which: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--synthesize", which],
        cwd=root) for which in SYNTHESIZED}


def wait_for(procs: dict, which: str) -> None:
    t0 = time.perf_counter()
    rc = procs[which].wait()
    if rc != 0:
        fail(f"synthesis of the {which!r} capture exited with {rc}")
    print(f"  waited {time.perf_counter() - t0:.1f} s for the {which!r} "
          "capture (synthesis, not timed)", flush=True)


def reset(wrappers) -> None:
    """Set every launch counter to 0; `wrappers` maps a kernel's name to
    its wrapper and the wrapper's counter attribute."""
    for fn, attr in wrappers.values():
        setattr(fn, attr, 0)


def read_launches(wrappers, needed) -> dict:
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in wrappers.items()}
    print(f"  launches: {launches}")
    for name in needed:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on this path")
    return launches


def check_run(run, min_fixes: int) -> None:
    """The tracked set and, with `min_fixes`, the fixes and the mean
    position error against the scenario."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    tracked = sorted(p for p, s in zip(run.channel_prns, run.channel_states)
                     if s == ChannelState.TRACKING)
    print(f"  tracked PRNs {tracked}, {len(run.ephemerides)} ephemerides, "
          f"{len(run.solutions)} fixes")
    if tracked != list(SCENARIO_PRNS):
        fail(f"tracked PRNs {tracked}, expected {list(SCENARIO_PRNS)}")
    if not min_fixes:
        return
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    rx_true = rx_true_ecef()
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                    for s in run.solutions]).reshape(-1, 3)
    if not np.isfinite(enu).all():
        fail("non-finite position")
    if len(run.solutions) < min_fixes:
        fail(f"only {len(run.solutions)} fixes")
    err_2d = float(np.linalg.norm(enu.mean(0)[:2]))
    err_3d = float(np.linalg.norm(enu.mean(0)))
    print(f"  mean error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


def check_block_chunk(root: str) -> None:
    """Phase 3, continued, once phase 4's capture is written: one chunk of
    50 blocks (1 s) of phase 4's GPS path, through the kernel path (K8a
    once, then per block the cuFFT and K1 with K8b and the next block's
    prologue), through the three-launch chunk (K8a, cuFFT, K1 with K8b per
    block) and through the plain block body (K1 through its kernel in
    each) on the card, from the same state: channels armed on the first
    1.5 s of the capture, conditioned by phase 4's conf, by that conf's
    own acquisition (PRNs 1-10, 8 channels).  The kernel path must equal
    the three-launch chunk bit for bit; against the plain body it prints
    whether the bits are equal and holds the active sets identical, the
    code boundary of every epoch (sample counter at the epoch end minus
    the replica's code phase, as the observables read it) within 1e-3
    chip, the Doppler within 0.5 Hz and the prompts within 1e-3 of their
    largest modulus."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.conditioner import \
        SignalConditioner
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.tracking import TrackingEngine
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    capture = capture_paths(root)["file"]
    config = InMemoryConfiguration(conf_properties(CONF.format(
        capture=capture)))
    rconf = receiver_conf_from_config(config)
    x = SignalConditioner(config, fs_in=FS_FILE).process(
        read_samples(capture, "ishort", count=int(1.5 * FS_FILE)))
    prns = tuple(range(1, 11))
    res = PcpsAcquisitionEngine(rconf.acq, prns).acquire_from(x, 0)
    found = [(p, float(d), int(res.samplestamp + dl))
             for p, ok, d, dl in zip(prns, res.detected, res.doppler_hz,
                                     res.delay_samples) if ok][:8]
    if [p for p, _, _ in found] != list(SCENARIO_PRNS):
        fail(f"50-block chunk: acquisition found {found}")
    conf = rconf.trk
    eng = TrackingEngine(conf, [p for p, _, _ in found] + [0, 0])
    for ch, (_, dop, start) in enumerate(found):
        eng.start_tracking(ch, dop, start)
    st = eng.state._replace(pos=torch.tensor(
        eng.abs_start.astype(np.int32), device=x.device))
    eng._ensure_block_tables()
    e_blk, n_blk = eng.block_epochs, 50
    args = (conf, n_blk, e_blk, eng._codes_rep, eng.taps)
    xf_all = tb._window_spectra(x, conf.nominal_epoch_samples,
                                tb.block_fft_size(conf))
    tb.track_chunk_blocks(*args, x, st)          # builds, plans the FFTs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_st, got = tb.track_chunk_blocks(*args, x, st)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_st, want = tb._chunk_plain(*args, xf_all, st)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    three_st, three = tb._chunk_cuda(*args, xf_all, st, fold=False)
    torch.cuda.synchronize()
    diff = differing(got_st, three_st, got, three)
    if diff:
        fail(f"50-block chunk: {diff} differ in bits from the three-launch "
             "chunk")
    plain_diff = differing(got_st, want_st, got, want)

    def boundary(o):
        end = (o["pos_start"] + o["n_samples"]).double()
        return ((end - o["code_phase_samples"].double())
                * o["code_freq_cps"].double() / conf.fs)     # chips
    valid = want["valid"]
    d_code = (boundary(got) - boundary(want))[valid].abs().max().item()
    d_dop = (got["carrier_doppler_hz"] - want["carrier_doppler_hz"]
             ).abs().max().item()
    d_prompt = ((got["prompt"] - want["prompt"]).abs().max()
                / want["prompt"].abs().max()).item()
    same = (torch.equal(got_st.active, want_st.active)
            and torch.equal(got["valid"], valid))
    print(f"  50-block chunk of phase 4's path (PRNs {list(SCENARIO_PRNS)} "
          f"armed by acquisition, 2 idle channels): active sets "
          f"{'identical' if same else 'DIFFERENT'}; code boundary within "
          f"{d_code:.2e} chip (tolerance 1e-3), Doppler within {d_dop:.3e} "
          f"Hz (0.5), prompts within {d_prompt:.2e} of the largest (1e-3); "
          "bit for bit the three-launch chunk's; against the plain body "
          + ("bit for bit" if not plain_diff else f"{plain_diff} differ"))
    print(f"  host time: kernel path {1e3 * t_k / n_blk:.3f} ms per block, "
          f"plain block body {1e3 * t_p / n_blk:.3f} ms per block")
    if not (same and d_code < 1e-3 and d_dop < 0.5 and d_prompt < 1e-3):
        fail("50-block chunk: the kernel path departs from the plain path")


BLOCK_STEP_KERNELS = ("K8a_block_prologue", "K1_K8b_block_correlate_close",
                      "K1_K8b_K8a_block_step")
# the standalone kernels that the fused ones replace on every path
STANDALONE_KERNELS = ("K2_multicorrelate", "K9_epoch_closure",
                      "K8b_block_closure")
EPOCH_KERNELS = ("K9_epoch_chunk",)


def check_block_launches(launches: dict, receiver_s: float) -> None:
    """K1 with K8b's closure fused ran once per block of the path (= K1's
    launches); K8a once per chunk (its first block) and the fold for every
    other block; the standalone K2, K9 and K8b never ran; the chunk tails
    ran the chunk kernel (its epochs counted beside its launches); the
    receiver's milliseconds per block."""
    k1 = launches["K1_block_correlate"]
    fused, k8a, folds = (launches[n] for n in (
        "K1_K8b_block_correlate_close", "K8a_block_prologue",
        "K1_K8b_K8a_block_step"))
    chunks = launches["block_chunks"]
    if (not k1 or fused != k1 or k8a != chunks or k8a + folds != k1
            or not chunks):
        fail(f"K1 with K8b fused ran {fused} times, K1 {k1}, K8a {k8a}, the "
             f"fold {folds}, in {chunks} chunks")
    if any(launches[n] for n in STANDALONE_KERNELS):
        fail(f"standalone kernels launched on a block path: {launches}")
    epochs = launches["K9_epoch_chunk_epochs"]
    ep_chunks = launches["K9_epoch_chunk"]
    if epochs < ep_chunks or (ep_chunks == 0) != (epochs == 0):
        fail(f"the chunk tails ran {ep_chunks} chunk launches of {epochs} "
             "epochs")
    print(f"  block step: {k1} blocks in {chunks} chunks: K1 with K8b fused "
          f"{fused} (= K1 launches), with the next prologue folded {folds}, "
          f"K8a {k8a} (= chunks); standalone K2, K9, K8b "
          f"0; receiver {1e3 * receiver_s / k1:.3f} ms per block; chunk "
          f"tails {epochs} epochs in {ep_chunks} launches of the chunk "
          "kernel")


BLOCK_PATH_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step",
                      "K9_epoch_chunk")
ACQUISITION_KERNELS = ("K3_pcps_wipe", "K3_pcps_peak")
MAIN_PATH_KERNELS = (BLOCK_PATH_KERNELS + ACQUISITION_KERNELS
                     + ("K3b_pcps_wipe_per_channel", "K5a_fir_decim"))


def main_path(root: str, wrappers) -> dict:
    """Phase 4: conf file -> ishort capture -> conditioner -> receiver ->
    position, through the port's CLI called in process."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["file"]
    conf = os.path.join(root, "build", "chip_smoke_rx.conf")
    with open(conf, "w") as fh:
        fh.write(CONF.format(capture=capture))
    print(f"  capture: {os.path.getsize(capture) / 1e6:.0f} MB ishort at "
          f"{FS_FILE / 1e6:.0f} Msps; conf: {conf}")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, MAIN_PATH_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f} ({100 * sec['condition'] / wall:.1f} % of "
          f"the wall time), receiver {sec['receiver']:.3f}")
    check_block_launches(launches, sec["receiver"])
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f}")
    return launches


COND_KERNELS = ("K5a_fir_decim", "K5b_notch_filter", "K5c_pulse_blanking",
                "K5d_direct_resampler", "K5d_linear_resampler")


def conditioner_path(root: str, wrappers, notch_case) -> dict:
    """Phase 4b: SignalConditioner.process alone, once per configuration,
    on the first 4 M samples of the capture file (the notch: on the
    `notch_case` input of phase 3, whose sequential plain output is at
    hand).  Every K5 kernel must be launched through it, and every output
    is held against the plain versions composed on the same input."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.conditioner import \
        SignalConditioner
    from gnss_sim_receiver_tpu_torch.ops import filters, resampler
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    x = read_samples(capture_paths(root)["file"], "ishort",
                     count=COND_SAMPLES)
    xd = torch.from_numpy(x).cuda()
    x_notch, want_notch = notch_case
    taps = torch.from_numpy(filters.design_lowpass(31, 0.45)).cuda()
    # the output lengths as the conditioner computes them
    n_half = resampler.output_length(COND_SAMPLES, 1.0, 1.0 / (4e6 / 2e6))
    n_3m = resampler.output_length(COND_SAMPLES, 1.0, 1.0 / (4e6 / 3e6))
    # name: (conf keys, input, plain version of the chain, tolerance as in
    # phase 3; 0 means identical)
    configs = {
        "Notch_Filter": (
            {"InputFilter.implementation": "Notch_Filter",
             "InputFilter.f0_norm": str(NOTCH_F0),
             "InputFilter.bw_norm": str(NOTCH_BW)},
            x_notch.cpu().numpy(), lambda: want_notch, 1e-4),
        "Pulse_Blanking_Filter": (
            {"InputFilter.implementation": "Pulse_Blanking_Filter"},
            x, lambda: filters._blank_plain(xd, 4.0, 64), 0.0),
        "Fir_Filter + Direct_Resampler": (
            {"InputFilter.implementation": "Fir_Filter",
             "InputFilter.number_of_taps": "31",
             "Resampler.implementation": "Direct_Resampler",
             "Resampler.sample_freq_out": "2000000"},
            x, lambda: resampler._direct_plain(
                filters._fir_plain(xd, taps, 1), 2.0, n_half), 1e-5),
        "Mmse_Resampler": (
            {"Resampler.implementation": "Mmse_Resampler",
             "Resampler.sample_freq_out": "3000000"},
            x, lambda: resampler._linear_plain(
                xd, float(np.float32(4e6 / 3e6)), n_3m), 1e-6),
    }
    reset(wrappers)
    outputs = {}
    for name, (props, x_in, _, _) in configs.items():
        cond = SignalConditioner(InMemoryConfiguration(props), fs_in=FS_FILE)
        t0 = time.perf_counter()
        y = cond.process(x_in)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (y.is_cuda and y.dtype == torch.complex64):
            fail(f"conditioner {name}: output {y.device} {y.dtype}")
        print(f"  {name}: {len(x_in)} -> {len(y)} samples at "
              f"{cond.fs_out / 1e6:.3f} Msps, {dt:.3f} s with the upload")
        outputs[name] = y
    launches = read_launches(wrappers, COND_KERNELS)
    for name, (_, _, plain, rtol) in configs.items():
        want = plain()
        if rtol:
            compare(f"conditioner {name} against the plain chain",
                    outputs[name], want, rtol)
        elif not torch.equal(outputs[name], want):
            fail(f"conditioner {name}: differs from the plain chain")
        else:
            print(f"  conditioner {name} against the plain chain: identical "
                  f"({int((want == 0).sum())} samples blanked)")
    return launches


def direct_path(root: str, wrappers) -> dict:
    """Phase 4c: the array entry point, Receiver.process_array on a
    complex64 array at 2 Msps, 8 s of the scenario: long enough to acquire
    and track, too short for a fix."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    x = np.load(capture_paths(root)["direct"])
    rx = Receiver(ReceiverConf(fs=FS, prns=tuple(range(1, 11)),
                               max_channels=8))
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = rx.process_array(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, BLOCK_PATH_KERNELS
                             + ACQUISITION_KERNELS)
    check_run(run, min_fixes=0)
    print(f"  wall {wall:.3f} s for {DIRECT_DUR:.0f} s of signal: real-time "
          f"factor {DIRECT_DUR / wall:.3f}")
    check_block_launches(launches, wall)
    return launches


HYBRID_KERNELS = ("K1_block_correlate", "K9_epoch_chunk", "K3_pcps_wipe",
                  "K3_pcps_peak", "K4a_pcps_dual_peak")


def mean_error(run) -> tuple[float, float]:
    """The 2D and 3D norms of the mean ENU error of a run's fixes."""
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true_ecef(), ref)
                    for s in run.solutions])
    if not np.isfinite(enu).all():
        fail("non-finite position")
    return (float(np.linalg.norm(enu.mean(0)[:2])),
            float(np.linalg.norm(enu.mean(0))))


# phase 8's GPS floor: the JAX receiver on a 4 Msps CPU cut of phase 8's
# scenario (GPS at extend_correlation_symbols=20, its default 15 Hz narrow
# PLL) loses GPS PRN 4 six times and ends with 3 of the 4 satellites tracked
# and decoded, and the port there does the same (ROADMAP.md queue 3); the
# phase holds the port to that result
PILOT_GPS_MIN = 3


def check_hybrid_run(run, gps_min: int = len(HYB_GPS_PRNS)) -> None:
    """Phase 5's checks (tests/test_hybrid_position.py:67-97): the tracked
    set of each system, the ephemerides decoded, the fixes and the mean
    position error.  With `gps_min` below 4, that many of the GPS
    satellites (tracked and decoded) will do."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    tracked = {"GPS": [], "Galileo": []}
    for p, st, sy in zip(run.channel_prns, run.channel_states,
                         run.channel_systems):
        if st == ChannelState.TRACKING:
            tracked[sy].append(p)
    gps_eph = sorted(k for k in run.ephemerides if isinstance(k, int))
    gal_eph = sorted(k[1] for k in run.ephemerides if isinstance(k, tuple))
    n_last = run.solutions[-1].n_sats if run.solutions else 0
    print(f"  tracked GPS {sorted(tracked['GPS'])}, Galileo "
          f"{sorted(tracked['Galileo'])}; ephemerides GPS {gps_eph}, "
          f"Galileo {gal_eph}; {len(run.solutions)} fixes, the last with "
          f"{n_last} satellites")
    def gps_ok(prns):
        return set(prns) <= set(HYB_GPS_PRNS) and len(prns) >= gps_min
    if not gps_ok(tracked["GPS"]) \
            or sorted(tracked["Galileo"]) != list(HYB_GAL_PRNS):
        fail(f"tracked {tracked}")
    if not gps_ok(gps_eph) or gal_eph != list(HYB_GAL_PRNS):
        fail(f"ephemerides GPS {gps_eph}, Galileo {gal_eph}")
    if len(run.solutions) < 5 or n_last < 7:
        fail(f"{len(run.solutions)} fixes, the last with {n_last} "
             "satellites")
    err_2d, err_3d = mean_error(run)
    print(f"  mean error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


def make_hybrid_capture(root: str, wrappers) -> dict:
    """Phase 5's capture: the 26 s hybrid scenario at 20 Msps (520 M
    samples) made on the card by the device generator (K6, seed 17 for the
    noise), quantized there and written as an ibyte file (1.04 GB), outside
    every timed window.  Returns K6's launches."""
    import torch
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = capture_paths(root)["hybrid"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = int(FS_REF_HYBRID * DUR)
    sats = hybrid_sats()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_REF_HYBRID, n, noise=True,
                                          seed=17)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    launches = read_launches(wrappers, ("K6_device_generator",))
    t0 = time.perf_counter()
    tmp = path + f".{os.getpid()}.tmp"
    write_samples(tmp, x, "ibyte", scale=HYB_BYTE_SCALE)
    os.replace(tmp, path)
    wrote = time.perf_counter() - t0
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} satellites, "
          f"{8 * n / 1e9:.2f} GB on the card) in {gen:.3f} s; quantized on "
          f"the card and written as ibyte ({os.path.getsize(path) / 1e9:.2f} "
          f"GB) in {wrote:.3f} s (not timed)")
    del x
    torch.cuda.empty_cache()
    return launches


def hybrid_path(root: str, wrappers, card: str) -> dict:
    """Phase 5: the hybrid conf (GPS L1 C/A + Galileo E1-B, 10 + 10
    channels, CCCWSR on E1) at 20 Msps -> the 26 s ibyte capture ->
    receiver -> a joint position, through the port's CLI called in
    process."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["hybrid"]
    conf = os.path.join(root, "build", "chip_smoke_hybrid.conf")
    with open(conf, "w") as fh:
        fh.write(HYBRID_CONF.format(capture=capture, fs=int(FS_REF_HYBRID)))
    print(f"  capture: {os.path.getsize(capture) / 1e6:.0f} MB ibyte at "
          f"{FS_REF_HYBRID / 1e6:.0f} Msps; conf: {conf}")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, HYBRID_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_hybrid_run(res.run)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f} "
          f"({card})")
    check_block_launches(launches, sec["receiver"])
    return launches


def hybrid_acquisition(root: str, wrappers, impl: str = "8ms",
                       keys: dict | None = None) -> dict:
    """Phases 5b and 5c: the E1 chain's acquisition engine of phase 5's conf
    with Galileo_E1_PCPS_<impl>_Ambiguous_Acquisition and the conf `keys`,
    on the first second of the hybrid capture resident on the card (a
    window that starts off the 128-sample grid), PRNs 11-20.  PRNs 11-15
    must be detected, the detections must equal those of the plain
    version (the JAX-form grid materialised, then its statistic: CFAR, or
    first-vs-second with use_CFAR_algorithm=false) and each channel's
    (Doppler, delay) must equal its, the statistic to 1e-4 of it."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    chain = hybrid_chain(FS_REF_HYBRID, impl, keys)
    acq = chain.acq
    x = torch.from_numpy(read_samples(capture_paths(root)["hybrid"],
                                      "ibyte",
                                      count=int(FS_REF_HYBRID))).cuda()
    prns = tuple(range(11, 21))
    eng = PcpsAcquisitionEngine(
        acq, prns, code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, code_provider2=chain.data_code_provider)
    start = 100_003
    stat_kernel = ("K4a_pcps_dual_peak" if acq.use_cfar_algorithm
                   else "K3c_pcps_second_peak_dual")
    reset(wrappers)
    torch.cuda.synchronize()
    res = eng.acquire_from(x, start)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, (stat_kernel,))
    found = [p for p, d in zip(prns, res.detected) if d]
    print(f"  {impl} acquisition at sample {start}: detected PRNs {found} "
          f"(threshold {res.threshold:.2f}), statistic "
          f"{np.round(res.test_stat, 3).tolist()}, Doppler "
          f"{res.doppler_hz[:5].tolist()} Hz, delay "
          f"{res.delay_samples[:5].tolist()}")
    if not set(HYB_GAL_PRNS) <= set(found):
        fail(f"{impl} acquisition detected {found}")
    m, n = acq.max_dwells, eng.fft_size
    x_dw = x[start:start + eng.n_samples_needed].reshape(m, -1)
    if acq.variant == "8ms":
        grid = pcps.pcps_8ms_grid(x_dw, eng.code_fft_conj, eng.dopplers,
                                  FS_REF_HYBRID)
    else:
        grid = pcps.pcps_cccwsr_grid(x_dw, eng.code2_fft_conj,
                                     eng.code_fft_conj, eng.dopplers,
                                     FS_REF_HYBRID)
    if acq.use_cfar_algorithm:
        stat, di, de = pcps.max_to_input_power_stat(grid, float(2 * m))
    else:
        stat, di, de = pcps.first_vs_second_peak_stat(grid,
                                                      eng.samples_per_chip)
    del grid
    want_dop = eng.dopplers[di.long()].double().cpu().numpy()
    want_del = np.mod(de.double().cpu().numpy(), eng.n_coherent)
    want_stat = stat.double().cpu().numpy()
    if not (np.array_equal(res.detected, want_stat > res.threshold)
            and np.array_equal(res.doppler_hz, want_dop)
            and np.array_equal(res.delay_samples, want_del)):
        fail(f"{impl} acquisition against its plain version: Doppler "
             f"{res.doppler_hz} vs {want_dop}, delay {res.delay_samples} vs "
             f"{want_del}, statistic {res.test_stat} vs {want_stat}")
    rel = np.abs(res.test_stat - want_stat) / np.abs(want_stat)
    print(f"  against the plain version: detections, Doppler and delay "
          f"identical, statistic within {rel.max():.2e} (tolerance 1e-4)")
    if rel.max() > 1e-4:
        fail(f"{impl} acquisition statistic differs from the plain version")
    torch.cuda.empty_cache()
    return launches


QUICKSYNC_KERNELS = ("K4b_quicksync_fold", "K4b_quicksync_resolve",
                     "K3_pcps_peak", "K1_block_correlate", "K5a_fir_decim")


def quicksync_path(root: str, wrappers) -> dict:
    """Phase 4d, first half: phase 4's conf with
    GPS_L1_CA_PCPS_QuickSync_Acquisition (folding_factor=4) and phase 4's
    capture through the CLI to a position; the same checks as phase 4."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    conf = os.path.join(root, "build", "chip_smoke_quicksync.conf")
    with open(conf, "w") as fh:
        fh.write(QUICKSYNC_CONF.format(capture=capture_paths(root)["file"]))
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, QUICKSYNC_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}; "
          f"real-time factor {DUR / wall:.3f}")
    check_block_launches(launches, sec["receiver"])
    return launches


# the acquisition tail's conf keys (phases 4e and 5c): the first-vs-second-
# peak statistic against a fixed threshold, at which the JAX receiver
# acquires exactly the static scenario's PRNs (tests/test_torch_acq_tail.py
# THRESHOLD); and the doubled FFT of bit_transition_flag
RATIO_THRESHOLD = 2.5


def ratio_props(sig: str) -> dict:
    return {f"Acquisition_{sig}.use_CFAR_algorithm": "false",
            f"Acquisition_{sig}.pfa": "0",
            f"Acquisition_{sig}.threshold": str(RATIO_THRESHOLD)}


BIT_PROPS = {"Acquisition_1C.bit_transition_flag": "true"}
# phase 4d's engines under the CFAR statistic, and phase 4e's: the ratio,
# the doubled FFT, both; (label, conf keys, what Tong and Fine Doppler
# detect: "exact" the scenario's PRNs, "any" whatever the plain run
# detects).  The fixed threshold is sized for two-dwell searches: Tong's
# single 1 ms dwells can put a present satellite's ratio under it (PRN 3
# on phase 4's capture, in the kernel run and the plain run alike).  That
# JAX does the same is inferred from tests/test_torch_acq_tail.py, which
# holds the port's Tong to JAX's under the ratio on its own capture; JAX
# is not run on this one.  With
# the ratio and the doubled FFT the peak repeats one code period later and
# the ratio stays near 1 (acquisition.py:45-48) unless a bit edge cuts one
# of the two periods
CFAR_CASES = (("CFAR", {}, dict(tong="exact", fine_doppler="exact")),)
TAIL_CASES = (("first vs second", ratio_props("1C"),
               dict(tong="any", fine_doppler="exact")),
              ("CFAR, bit_transition_flag", BIT_PROPS,
               dict(tong="exact", fine_doppler="exact")),
              ("first vs second, bit_transition_flag",
               {**ratio_props("1C"), **BIT_PROPS},
               dict(tong="any", fine_doppler="any")))


def tong_fine_doppler(root: str, wrappers, cases=CFAR_CASES) -> None:
    """Phase 4d, second half (and phase 4e's with TAIL_CASES): the
    acquisition engines that the factory builds from phase 4's conf with
    GPS_L1_CA_PCPS_Tong_Acquisition and
    GPS_L1_CA_PCPS_Acquisition_Fine_Doppler and each case's keys, PRNs
    1-10, on the 2 Msps capture resident on the card (a window off the
    128-sample grid).  The scenario's PRNs must be detected as the case
    says; every result must equal the same engine's plain run on the same
    samples (detections identical, Doppler and delay identical where
    detected and on the scenario's PRNs, the statistic to 1e-4 on every
    channel)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    x = torch.from_numpy(np.load(capture_paths(root)["direct"])[: int(FS)]
                         ).cuda()
    prns = tuple(range(1, 11))
    start = 100_003
    for label, keys, expect in cases:
        for impl in ("GPS_L1_CA_PCPS_Tong_Acquisition",
                     "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler"):
            props = conf_properties(CONF.format(capture=""))
            props["Acquisition_1C.implementation"] = impl
            props.update(keys)
            acq = receiver_conf_from_config(InMemoryConfiguration(props)).acq
            eng = PcpsAcquisitionEngine(acq, prns)
            stat_kernel = ("K3_pcps_peak" if acq.use_cfar_algorithm
                           else "K3c_pcps_second_peak")
            needed = ("K3_pcps_wipe", stat_kernel) + (
                ("K3b_pcps_wipe_per_channel", "K3_pcps_peak")
                if acq.variant == "fine_doppler" else ())
            reset(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.acquire_from(x, start)
            dt = time.perf_counter() - t0
            print(f"  {impl} ({label}; threshold {res.threshold:.3f}):")
            read_launches(wrappers, needed)
            want = PcpsAcquisitionEngine(acq, prns, device="cpu"
                                         ).acquire_from(x.cpu(), start)
            found = [p for p, d in zip(prns, res.detected) if d]
            print(f"  detected PRNs {found} in {dt * 1e3:.1f} ms (one pull);"
                  f" statistic {np.round(res.test_stat, 3).tolist()}")
            if expect[acq.variant] == "exact" \
                    and found != list(SCENARIO_PRNS):
                fail(f"{impl} ({label}) detected {found}")
            det = want.detected | np.isin(prns, SCENARIO_PRNS)
            if not (np.array_equal(res.detected, want.detected)
                    and np.array_equal(res.doppler_hz[det],
                                       want.doppler_hz[det])
                    and np.array_equal(res.delay_samples[det],
                                       want.delay_samples[det])):
                fail(f"{impl} ({label}) against its plain run: {res} vs "
                     f"{want}")
            rel = np.abs(res.test_stat - want.test_stat) / want.test_stat
            print(f"  against the plain run: detections, Doppler and delay "
                  f"identical, statistic within {rel.max():.2e} (tolerance "
                  f"1e-4)")
            if rel.max() > 1e-4:
                fail(f"{impl} ({label}): statistic differs from the plain "
                     "run")


RATIO_CONF = CONF.replace(
    "Acquisition_1C.pfa=0.01\n",
    "".join(f"{k}={v}\n" for k, v in ratio_props("1C").items()))
RATIO_KERNELS = ("K3c_pcps_second_peak", "K3_pcps_wipe", "K3_pcps_peak",
                 "K3b_pcps_wipe_per_channel", "K1_block_correlate",
                 "K5a_fir_decim")


def ratio_path(root: str, wrappers) -> dict:
    """Phase 4e, first part: phase 4's conf with use_CFAR_algorithm=false,
    pfa=0 and threshold=RATIO_THRESHOLD and phase 4's capture through the
    CLI to a position; phase 4's checks.  Every coarse search takes K3c
    (its launches = the coarse wipeoffs), every narrow grid K3's peak
    kernel (= the narrow wipeoffs)."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    conf = os.path.join(root, "build", "chip_smoke_ratio.conf")
    with open(conf, "w") as fh:
        fh.write(RATIO_CONF.format(capture=capture_paths(root)["file"]))
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, RATIO_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    k3c, coarse = launches["K3c_pcps_second_peak"], launches["K3_pcps_wipe"]
    peak = launches["K3_pcps_peak"]
    narrow = launches["K3b_pcps_wipe_per_channel"]
    print(f"  acquisition: {coarse} coarse searches through K3c ({k3c}), "
          f"{narrow} narrow grids through K3's peak kernel ({peak})")
    if k3c != coarse or peak != narrow:
        fail("K3c and K3's peak kernel do not take the coarse and the narrow "
             "searches one each")
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}; "
          f"real-time factor {DUR / wall:.3f}")
    check_block_launches(launches, sec["receiver"])
    return launches


ROC_KERNELS = ("K3_pcps_wipe", "K3_pcps_peak", "K3c_pcps_second_peak")


def roc_path(wrappers) -> dict:
    """Phase 4f: the ROC harness (models/acq_performance.py) at
    tests/test_acq_performance.py's size and seeds, its bounds asserted:
    sweep over 30, 40, 45 dB-Hz (Pfa 0.05, 384 trials), the dwell-gain
    pair at 38 dB-Hz (1 and 2 dwells), then one _trial_stats of 384 trials
    under the first-vs-second-peak statistic, held against the plain
    statistic of the same trials.  Each sweep's seconds printed."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import acq_performance as perf
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    reset(wrappers)
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out
    pfa_hat, pd, thr = timed("roc", lambda: perf.sweep(
        cn0_db_hz=(30.0, 40.0, 45.0), pfa=0.05, n_trials=384, seed=2))
    print(f"  ROC sweep (384 trials, Pfa 0.05, threshold {thr:.3f}): "
          f"pfa_hat {pfa_hat:.4f}, pd {pd} in {secs['roc']:.3f} s")
    if not (0.002 <= pfa_hat <= 0.075 and pd[30.0] <= 0.2
            and pd[45.0] >= 0.95 and pd[30.0] <= pd[40.0] <= pd[45.0]):
        fail(f"ROC sweep outside tests/test_acq_performance.py's bounds: "
             f"{pfa_hat}, {pd}")
    _, pd1, _ = timed("dwells 1", lambda: perf.sweep(
        cn0_db_hz=(38.0,), pfa=0.01, n_trials=384, max_dwells=1, seed=5))
    _, pd2, _ = timed("dwells 2", lambda: perf.sweep(
        cn0_db_hz=(38.0,), pfa=0.01, n_trials=384, max_dwells=2, seed=5))
    print(f"  dwell gain at 38 dB-Hz: pd {pd1[38.0]:.4f} (1 dwell, "
          f"{secs['dwells 1']:.3f} s), {pd2[38.0]:.4f} (2 dwells, "
          f"{secs['dwells 2']:.3f} s)")
    if not (pd2[38.0] >= pd1[38.0]
            and (pd2[38.0] - pd1[38.0] > 0.05 or pd1[38.0] > 0.9)):
        fail(f"dwell gain outside tests/test_acq_performance.py's bounds: "
             f"{pd1}, {pd2}")
    dev = torch.device("cuda")
    n, t_n = 2000, 384
    code = prn_codes.sample_code(prn_codes.gps_l1_ca_code(1), FS, 1.023e6, n)
    code_t = torch.from_numpy(code.astype(np.float32)).to(dev)
    cfc = torch.from_numpy(np.conj(np.fft.fft(code))[None].astype(
        np.complex64)).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    amp = float(np.sqrt(2.0 * 10.0 ** 4.0 / FS))            # 40 dB-Hz
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    stat = timed("ratio trials", lambda: perf._trial_stats(
        gen, code_t, cfc, dops, amp, 1375.0, 700, n, t_n, FS, False, 2, 1))
    launches = read_launches(wrappers, ROC_KERNELS)

    def plain(x):
        """The same statistic through the plain versions: the wipeoff, the
        grid materialised, first_vs_second_peak_stat."""
        corr = torch.fft.ifft(torch.fft.fft(pcps._wipe_plain(
            x.reshape(t_n, n), dops, pcps.time_axis(n, FS, dev)), dim=-1)
            * cfc[0], dim=-1).reshape(1, t_n, len(dops), n)
        return pcps.first_vs_second_peak_stat(pcps._plain_grid(corr), 2)[0]
    gen.manual_seed(7)
    x = perf.trial_signal(gen, code_t, amp, 1375.0, 700, n, t_n, FS, 1)
    compare("4f _trial_stats (first vs second, 384 trials) against the "
            "plain statistic", stat, plain(x), 1e-4)
    # warm, host-timed to the synchronize: one batch through the kernels
    # (the noise drawn too) and the plain statistic of the same batch
    timed("ratio trials warm", lambda: perf._trial_stats(
        gen, code_t, cfc, dops, amp, 1375.0, 700, n, t_n, FS, False, 2, 1))
    timed("ratio trials plain", lambda: plain(x))
    print(f"  _trial_stats (first vs second, 40 dB-Hz, 384 trials) in "
          f"{secs['ratio trials'] * 1e3:.1f} ms (first at its shape), "
          f"{secs['ratio trials warm'] * 1e3:.3f} ms warm, the plain "
          f"statistic of the batch {secs['ratio trials plain'] * 1e3:.3f} "
          f"ms: median ratio {float(stat.median()):.3f}, "
          f"{int((stat > RATIO_THRESHOLD).sum())} of {t_n} above "
          f"{RATIO_THRESHOLD}")
    print(f"  seconds: {json.dumps(secs)}")
    return dict(launches=launches, seconds=secs)


def hybrid_witness() -> None:
    """--witness: what moves phase 5's position error.  The hybrid conf's
    receiver (`Receiver.process_array` on a card tensor, as the CLI runs
    it after its pass-through conditioner) on variants of phase 5's
    capture that differ in one thing each: the same K6 capture (seed 17)
    quantized as ibyte (phase 5's samples) or left in float32; other noise
    seeds; the rate (4 Msps); and the host simulator's band-limited chips
    (seed 17, 4 Msps, the capture of the earlier 4 Msps phase 5).  Prints
    the tracked count, fixes and mean 2D/3D error of each; checks nothing."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.factory import make_receiver
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import \
        quantize_interleaved

    def k6(fs, seed):
        return generate_baseband_device_resident(
            hybrid_sats(), fs, int(fs * DUR), noise=True, seed=seed)

    def ibyte(x):
        q = quantize_interleaved(x, "ibyte", HYB_BYTE_SCALE)
        return torch.view_as_complex(q.view(-1, 2).float())

    def host4():
        return torch.from_numpy(
            synthesize_hybrid(FS_FILE, int(FS_FILE * DUR))).cuda()
    hi, lo = FS_REF_HYBRID, FS_FILE
    cases = [("K6, ibyte", hi, 17, lambda: ibyte(k6(hi, 17))),
             ("K6, float32", hi, 17, lambda: k6(hi, 17)),
             ("K6, float32", hi, 18, lambda: k6(hi, 18)),
             ("K6, float32", hi, 19, lambda: k6(hi, 19)),
             ("K6, float32", lo, 17, lambda: k6(lo, 17)),
             ("K6, float32", lo, 18, lambda: k6(lo, 18)),
             ("host band-limited, float32", lo, 17, host4)]
    for what, fs, seed, make in cases:
        props = conf_properties(HYBRID_CONF.format(capture="", fs=int(fs)))
        rx = make_receiver(InMemoryConfiguration(props))
        x = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = rx.process_array(x)
        wall = time.perf_counter() - t0
        n_trk = sum(1 for st in run.channel_states
                    if st == ChannelState.TRACKING)
        e2, e3 = mean_error(run) if run.solutions else (float("nan"),) * 2
        print(f"  witness {what} at {fs / 1e6:g} Msps, seed {seed}: "
              f"{n_trk} tracked, {len(run.solutions)} fixes, mean error 2D "
              f"{e2:.3f} m, 3D {e3:.3f} m (receiver {wall:.1f} s)",
              flush=True)
        del x, rx, run
        torch.cuda.empty_cache()


FULL_CHAIN_KERNELS = ("K1_block_correlate", "K9_epoch_chunk",
                      "K3_pcps_wipe", "K3_pcps_peak")


def full_chain(wrappers, card: str) -> dict:
    """Phase 6: bench.py:_bench_full_chain's scenario made on the card by
    the device generator (K6) and kept there, through
    Receiver.process_array once.  All 12 PRNs tracked, >= 5 fixes, 3D < 5 m
    (the mean over the fixes from the 6th on, as bench.py reports it)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    sats = full_chain_sats()
    n = int(FS * FULL_DUR)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS, n, noise=True, seed=3)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} satellites) on "
          f"the card in {gen:.3f} s")
    rx = Receiver(ReceiverConf(fs=FS, prns=FULL_PRNS, max_channels=12,
                               max_acq_channels=12, pvt_rate_ms=500))
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = rx.process_array(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, FULL_CHAIN_KERNELS)
    tracked = sorted(p for p, st in zip(run.channel_prns, run.channel_states)
                     if st == ChannelState.TRACKING)
    rx_true = rx_true_ecef()
    n_fix = len(run.solutions)
    err = float("nan")
    if n_fix > 5:
        pos = np.mean([s.rx_ecef_m for s in run.solutions[5:]], axis=0)
        err = float(np.linalg.norm(pos - rx_true))
    print(f"  tracked PRNs {tracked}, {len(run.ephemerides)} ephemerides, "
          f"{n_fix} fixes; mean position error (fixes 6 on) {err:.3f} m")
    print(f"  receiver wall {wall:.3f} s for {FULL_DUR:.0f} s of signal: "
          f"real-time factor {FULL_DUR / wall:.3f} ({card})")
    check_block_launches(launches, wall)
    if tracked != list(FULL_PRNS):
        fail(f"tracked PRNs {tracked}, expected {list(FULL_PRNS)}")
    if n_fix < 5 or not err < 5.0:
        fail(f"{n_fix} fixes, mean position error {err:.3f} m")
    if "--profile" in sys.argv[1:]:
        print("== profile of the full chain", flush=True)

        def again():
            t0 = time.perf_counter()
            rx.process_array(x)
            torch.cuda.synchronize()
            return f"receiver wall {time.perf_counter() - t0:.3f} s"
        profile_path(again)
    del x
    torch.cuda.empty_cache()
    launches["K6_device_generator"] = k6["K6_device_generator"]
    return launches


WIDEBAND_KERNELS = ("K1_block_correlate", "K9_epoch_chunk",
                    "K3_pcps_wipe", "K3_pcps_peak",
                    "K3b_pcps_wipe_per_channel", "K4c_pcps_caf_peak")


def make_wideband_capture(root: str, wrappers) -> dict:
    """Phase 7's capture: the 60 s wideband scenario at 20 Msps (1.2 G
    samples, 9.6 GB on the card) made by the device generator (K6, seed 17
    for the noise), quantized there and written as an ibyte file (2.4 GB),
    outside every timed window.  Returns K6's launches."""
    import torch
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = capture_paths(root)["wideband"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = int(FS_WIDEBAND * WB_DUR)
    sats = wideband_sats()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_WIDEBAND, n, noise=True,
                                          seed=17)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    launches = read_launches(wrappers, ("K6_device_generator",))
    t0 = time.perf_counter()
    tmp = path + f".{os.getpid()}.tmp"
    write_samples(tmp, x, "ibyte", scale=HYB_BYTE_SCALE)
    os.replace(tmp, path)
    wrote = time.perf_counter() - t0
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} satellites, "
          f"{8 * n / 1e9:.2f} GB on the card) in {gen:.3f} s; quantized on "
          f"the card and written as ibyte ({os.path.getsize(path) / 1e9:.2f} "
          f"GB) in {wrote:.3f} s (not timed)")
    del x
    torch.cuda.empty_cache()
    return launches


def check_wideband_run(run) -> None:
    """Phase 7's checks: the tracked set of each system, 4 CNAV and 5 F/NAV
    ephemerides, >= 5 fixes with the last on >= 7 satellites, and the mean
    position error (2D < 2 m, 3D < 5 m, the thresholds of phase 5)."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    tracked = {"GPS": [], "Galileo": []}
    for p, st, sy in zip(run.channel_prns, run.channel_states,
                         run.channel_systems):
        if st == ChannelState.TRACKING:
            tracked[sy].append(p)
    gps_eph = sorted(k for k in run.ephemerides if isinstance(k, int))
    gal_eph = sorted(k[1] for k in run.ephemerides if isinstance(k, tuple))
    n_last = run.solutions[-1].n_sats if run.solutions else 0
    print(f"  tracked GPS L5 {sorted(tracked['GPS'])}, Galileo E5a "
          f"{sorted(tracked['Galileo'])}; CNAV ephemerides {gps_eph}, F/NAV "
          f"ephemerides {gal_eph}; {len(run.solutions)} fixes, the last with "
          f"{n_last} satellites")
    if sorted(tracked["GPS"]) != list(HYB_GPS_PRNS) \
            or sorted(tracked["Galileo"]) != list(HYB_GAL_PRNS):
        fail(f"tracked {tracked}")
    if gps_eph != list(HYB_GPS_PRNS) or gal_eph != list(HYB_GAL_PRNS):
        fail(f"ephemerides GPS {gps_eph}, Galileo {gal_eph}")
    if len(run.solutions) < 5 or n_last < 7:
        fail(f"{len(run.solutions)} fixes, the last with {n_last} "
             "satellites")
    err_2d, err_3d = mean_error(run)
    print(f"  mean error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


def wideband_path(root: str, wrappers, card: str) -> dict:
    """Phase 7: the wideband conf (GPS L5I + Galileo E5a, 10 + 10
    channels, the E5a I/Q search with its CAF boxcar) at 20 Msps -> the
    60 s ibyte capture -> receiver -> a joint position, through the port's
    CLI called in process."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["wideband"]
    conf = os.path.join(root, "build", "chip_smoke_wideband.conf")
    with open(conf, "w") as fh:
        fh.write(WIDEBAND_CONF.format(capture=capture, fs=int(FS_WIDEBAND)))
    print(f"  capture: {os.path.getsize(capture) / 1e6:.0f} MB ibyte at "
          f"{FS_WIDEBAND / 1e6:.0f} Msps; conf: {conf}")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, WIDEBAND_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_wideband_run(res.run)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{WB_DUR:.0f} s of signal: real-time factor {WB_DUR / wall:.3f} "
          f"({card})")
    check_block_launches(launches, sec["receiver"])
    if "--profile" in sys.argv[1:]:
        argv = [f"--config_file={conf}"]
        print("== profile of the wideband path", flush=True)
        profile_path(lambda: f"seconds {run_cli(argv).seconds}")
    return launches


def pilot_receiver_conf(fs: float = FS_REF_HYBRID):
    """Phase 8's receiver: phase 5's conf (GPS acquisition, observables,
    PVT.output_rate_ms=20) with GPS tracking at extend_correlation_symbols
    20 and, in place of its E1-B chain, galileo_e1b_chain(fs,
    n_channels=10, track_pilot=True, extend_correlation_symbols=5) with
    phase 5's E1 tracking keys (very-early-late 0.6 chips, PLL 15 Hz) and
    the chain's own two-step PCPS acquisition."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e1b_chain
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    rconf = receiver_conf_from_config(InMemoryConfiguration(conf_properties(
        HYBRID_CONF.format(capture="", fs=int(fs)))))
    (e1,) = rconf.chains
    pilot = galileo_e1b_chain(
        fs, n_channels=e1.n_channels, track_pilot=True,
        extend_correlation_symbols=5,
        very_early_late_space_chips=e1.trk.very_early_late_space_chips,
        pll_bw_hz=e1.trk.pll_bw_hz)
    return dataclasses.replace(
        rconf, trk=dataclasses.replace(rconf.trk,
                                       extend_correlation_symbols=20),
        chains=(pilot,))


def check_epoch_chunk(dev) -> None:
    """Phase 3, continued: one 50-epoch chunk of phase 8's E1 pilot chain
    (10 channels, PRNs 11-20) through the chunk kernel and through the
    plain loop (K2 through its kernel) on the card, from the same state: the
    channels that the chain's own acquisition finds on the first 0.3 s of
    phase 8's scenario (made by K6) armed there.  Planes and states must
    be identical; if not, the code boundary of every epoch within 1e-3
    chip, the Doppler within 0.5 Hz and the prompts within 1e-3 of their
    largest modulus.  Prints the host time per epoch of both."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    chain = pilot_receiver_conf().chains[0]
    conf = chain.trk
    x = generate_baseband_device_resident(
        pilot_sats(), FS_REF_HYBRID, int(0.3 * FS_REF_HYBRID), noise=True,
        seed=17, device=dev)
    prns = tuple(range(11, 21))
    res = PcpsAcquisitionEngine(
        chain.acq, prns, code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, device=dev).acquire_from(x, 0)
    found = [p for p, ok in zip(prns, res.detected) if ok]
    if found != list(HYB_GAL_PRNS):
        fail(f"50-epoch chunk: acquisition found {found}")
    eng = trk.TrackingEngine(conf, prns, code_provider=chain.code_provider,
                             data_code_provider=chain.data_code_provider,
                             device=dev)
    for ch, ok in enumerate(res.detected):
        if ok:
            eng.start_tracking(ch, float(res.doppler_hz[ch]),
                               int(res.samplestamp + res.delay_samples[ch]))
    st = eng.state._replace(pos=torch.tensor(
        eng.abs_start.astype(np.int32), device=dev))
    n_ep = 50
    args = (conf, n_ep, eng.codes, eng.taps, x, st, eng.data_codes)
    trk.track_chunk(*args)                    # builds the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_st, got = trk.track_chunk(*args)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_st, want = trk._chunk_plain(*args)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    gs = interop.track_state_to_numpy(got_st)
    ws = interop.track_state_to_numpy(want_st)
    same = (all(torch.equal(got[k], want[k]) for k in want)
            and all(np.array_equal(gs[k], ws[k]) for k in ws))
    valid = want["valid"]

    def boundary(o):
        end = (o["pos_start"] + o["n_samples"]).double()
        return ((end - o["code_phase_samples"].double())
                * o["code_freq_cps"].double() / conf.fs)
    d_code = (boundary(got) - boundary(want))[valid].abs().max().item()
    d_dop = (got["carrier_doppler_hz"] - want["carrier_doppler_hz"]
             ).abs().max().item()
    d_prompt = ((got["prompt"] - want["prompt"]).abs().max()
                / want["prompt"].abs().max()).item()
    print(f"  50-epoch chunk of phase 8's E1 pilot chain (PRNs {found} armed "
          f"by acquisition, {len(prns) - len(found)} idle channels): planes "
          f"and states {'identical' if same else 'NOT identical'}; code "
          f"boundary within {d_code:.2e} chip (1e-3), Doppler within "
          f"{d_dop:.3e} Hz (0.5), prompts within {d_prompt:.2e} (1e-3); "
          f"sec_synced {gs['sec_synced'].tolist()}")
    print(f"  host time: the chunk kernel {1e3 * t_k / n_ep:.4f} ms per "
          f"epoch, plain loop {1e3 * t_p / n_ep:.3f} ms per epoch")
    if not (same or (torch.equal(got["valid"], valid) and d_code < 1e-3
                     and d_dop < 0.5 and d_prompt < 1e-3)):
        fail("50-epoch chunk: the kernel path departs from the plain loop")


UNUSED_ON_EPOCH_PATHS = ("K1_block_correlate", *BLOCK_STEP_KERNELS,
                         *STANDALONE_KERNELS)


def check_epoch_launches(launches: dict, epochs: int, receiver_s: float):
    """The chunk kernel ran the path's epochs (`epochs`, when not None),
    one launch per chunk; the standalone K2, K9 and K8b and the block
    kernels never."""
    chunks, ran = launches["K9_epoch_chunk"], launches["K9_epoch_chunk_epochs"]
    if not chunks or ran < chunks or (epochs is not None and ran != epochs):
        fail(f"the chunk kernel ran {chunks} launches of {ran} epochs, "
             f"{epochs} epochs run")
    if any(launches[n] for n in UNUSED_ON_EPOCH_PATHS):
        fail(f"other tracking kernels launched on a per-epoch path: "
             f"{launches}")
    print(f"  per-epoch path: {ran} epochs in {chunks} launches of the chunk "
          f"kernel ({ran / chunks:.1f} epochs a launch; K2, K9, K1, K8a, "
          f"K8b 0), receiver {1e3 * receiver_s / ran:.4f} ms per epoch")


def check_pilot_states(session) -> None:
    """Every tracking GPS channel bit-synced and every tracking Galileo
    channel secondary-synced, each in extended mode with its symbol count
    inside the group and the counts cycling (not all equal) per chain."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    for rt in session.chains:
        st = rt.trk.state
        k = rt.spec.trk.extend_correlation_symbols
        chans = [c for c in range(rt.spec.n_channels)
                 if rt.mgr.channels[c].state == ChannelState.TRACKING]
        flag = "sec_synced" if rt.spec.trk.secondary_code else "bit_synced"
        synced = getattr(st, flag).cpu().numpy()[chans]
        ext_n = st.ext_n.cpu().numpy()[chans]
        print(f"  {rt.spec.signal} chain: {flag} {synced.tolist()}, ext_n "
              f"{ext_n.tolist()} (groups of {k})")
        if not synced.all() or not ((0 <= ext_n) & (ext_n < k)).all() \
                or len(set(ext_n.tolist())) < 2:
            fail(f"{rt.spec.signal} chain: {flag} {synced}, ext_n {ext_n}")


def pilot_path(wrappers, card: str) -> dict:
    """Phase 8: phase 8's scenario (phase 5's, each Galileo satellite with
    E1-B and E1-C) made on the card by K6 for 26 s at 20 Msps and kept
    there, through the array entry point's session (ReceiverSession,
    attach_array, run_to_end, result: Receiver.process_array's body, kept
    to read the engines' states after) with pilot_receiver_conf: the
    tracked sets, ephemerides (I/NAV from the data prompt), fixes and mean
    position error as phase 5 (GPS held to PILOT_GPS_MIN), every tracking
    channel synced, and K2 and K9 once per epoch of the two chains."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.receiver import ReceiverSession
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    sats = pilot_sats()
    n = int(FS_REF_HYBRID * DUR)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_REF_HYBRID, n, noise=True,
                                          seed=17)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} signals) on the "
          f"card in {gen:.3f} s (not timed)")
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = ReceiverSession(pilot_receiver_conf())
    session.attach_array(x)
    session.run_to_end()
    run = session.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, EPOCH_KERNELS + (
        "K3_pcps_wipe", "K3_pcps_peak", "K3b_pcps_wipe_per_channel"))
    check_hybrid_run(run, gps_min=PILOT_GPS_MIN)
    check_pilot_states(session)
    epochs = {rt.spec.signal: rt.trk.epochs_dispatched
              for rt in session.chains}
    chunks = {rt.spec.signal: rt.trk._dispatch_seq for rt in session.chains}
    print(f"  epochs run: {epochs}; chunks dispatched: {chunks}")
    check_epoch_launches(launches, sum(epochs.values()), wall)
    if sum(chunks.values()) != launches["K9_epoch_chunk"]:
        fail(f"{chunks} chunks dispatched, the chunk kernel launched "
             f"{launches['K9_epoch_chunk']} times")
    print(f"  receiver wall {wall:.3f} s for {DUR:.0f} s of signal: "
          f"real-time factor {DUR / wall:.3f} ({card})")
    if "--profile" in sys.argv[1:]:
        print("== profile of the pilot path", flush=True)

        def again():
            t0 = time.perf_counter()
            s = ReceiverSession(pilot_receiver_conf())
            s.attach_array(x)
            s.run_to_end()
            torch.cuda.synchronize()
            return f"receiver wall {time.perf_counter() - t0:.3f} s"
        profile_path(again)
    del x, session
    torch.cuda.empty_cache()
    launches["K9_epoch_chunk"] = chunks["1C"]
    launches["K9_epoch_chunk_E1"] = chunks["1B"]
    launches["K9_epoch_closure_E1"] = launches["K9_epoch_closure"]
    launches["K2_multicorrelate_E1_data"] = launches["K2_multicorrelate"]
    launches["K6_device_generator"] = k6["K6_device_generator"]
    return launches


def pilot_conf_path(root: str, wrappers, card: str) -> None:
    """Phase 8b: phase 4's conf with Tracking_1C.extend_correlation_symbols
    =20 and phase 4's ishort capture through the CLI: the conditioner
    (K5a), acquisition (K3, K3b), then per-epoch tracking (K2 + K9) to a
    position; phase 4's checks."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["file"]
    conf = os.path.join(root, "build", "chip_smoke_rx_ext20.conf")
    with open(conf, "w") as fh:
        fh.write(CONF.format(capture=capture)
                 + "Tracking_1C.extend_correlation_symbols=20\n")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, EPOCH_KERNELS + MAIN_PATH_KERNELS[3:])
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    check_epoch_launches(launches, None, sec["receiver"])
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f} "
          f"({card})")


# ---- phases 9 and 9b: the sharded steps and the sigma-point filters -------

# phase 9's operating point: bench.py's largest block row (192 channels of
# GPS L1 C/A at 2 Msps), a cold start over all 32 PRNs (2 dwells of 1 ms,
# 41 bins of 250 Hz), 127 code periods of PRN 7 time-sharded
SHARD_CHANNELS = 192
SHARD_EPOCHS = 50
SHARD_BLOCKS, SHARD_E = 50, 20
SHARD_KERNELS = {
    "per-epoch tracking": ("K9_epoch_chunk",),
    "block tracking": ("K8a_block_prologue", "K1_K8b_block_correlate_close",
                       "K1_K8b_K8a_block_step"),
    "Doppler-sharded acquisition": ("K3_pcps_wipe", "K3_pcps_rows"),
    "time-sharded acquisition": ("K3_pcps_wipe", "K7_pcps_window_fold")}


def shard_inputs(dev, rng):
    """Phase 9's inputs: the 192 channels' tables (PRNs 1-32 six times),
    states armed on a Doppler ramp, noise captures for both scans; the
    static scenario's first 2 ms with all 32 PRNs' replicas; 127 periods
    of PRN 7 (delay OS_DELAY, OS_DOPPLER Hz) in noise."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    conf = trk.TrackingConf(fs=FS)
    c, s0 = SHARD_CHANNELS, conf.nominal_epoch_samples
    prns = [(i % 32) + 1 for i in range(c)]
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        prn_codes.gps_l1_ca_code(p), FS, conf.code_rate_cps, s0, 8)
        for p in prns])
    st = trk._init_state(c, dev)._replace(
        active=torch.ones(c, dtype=torch.bool, device=dev),
        carrier_doppler=torch.linspace(-4500.0, 4500.0, c, device=dev))
    n = 2000
    n_os = OS_PERIODS * n
    code7 = prn_codes.sample_code(prn_codes.gps_l1_ca_code(OS_PRN), FS,
                                  conf.code_rate_cps, n)
    t = np.arange(n_os) / FS
    sig = np.roll(np.tile(code7, OS_PERIODS + 1)[:n_os], OS_DELAY)
    os_x = (0.4 * sig * np.exp(2j * np.pi * OS_DOPPLER * t)
            + 0.5 * (rng.standard_normal(n_os)
                     + 1j * rng.standard_normal(n_os))).astype(np.complex64)
    return dict(
        conf=conf, codes=torch.from_numpy(tables).to(dev),
        codes_rep=tb.code_spectra(conf, tables, dev),
        taps=torch.tensor([0.25, 0.0, -0.25], device=dev), state=st,
        x_epoch=_cnoise(rng, (SHARD_EPOCHS + 1) * s0 + conf.block_size, dev),
        x_block=_cnoise(rng, (SHARD_BLOCKS * SHARD_E + 2 * SHARD_E + 4) * s0
                        + tb.block_fft_size(conf), dev),
        acq_x=acq_dwells(dev),
        acq_cfc=torch.from_numpy(code_replicas(
            AcqConf(fs_in=FS, max_dwells=2), range(1, 33))).to(dev),
        dops=torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev),
        os_x=torch.from_numpy(os_x).to(dev),
        os_code=torch.from_numpy(np.asarray(code7, np.float32)).to(dev))


def _sharded_step(name, wrappers, ss, run, unsharded, same) -> dict:
    """One sharded step: its counters at 0 just before, read just after
    (its kernels and at least one collective launched), its seconds on the
    host; then the unsharded call of the same port functions, which `same`
    holds it to, and the seconds of both a second time (warm: the first
    call includes NCCL's communicator, plans and compiles).  Returns the
    step's launches."""
    import torch
    reset(wrappers)
    for k in ss.collectives:
        ss.collectives[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers, SHARD_KERNELS[name])
    calls = dict(ss.collectives)
    if calls["all_gather"] + calls["all_reduce"] < 1:
        fail(f"{name}: no NCCL collective was called")
    same(got, unsharded())
    torch.cuda.synchronize()
    warm = []
    for fn in (run, unsharded):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"  {name}: {secs:.4f} s sharded, {warm[0]:.4f} s a second time, "
          f"the unsharded call {warm[1]:.4f} s (host, one rank); NCCL calls "
          f"{calls}; equal to the unsharded call")
    return launches


def sharded_path(wrappers) -> dict:
    """Phase 9: the four sharded steps on one rank over NCCL.  One process
    on one card is a world of one (NCCL refuses two ranks on one card):
    every collective is a copy, so each step equals the unsharded call bit
    for bit, and nothing here shows scaling.  The overlap-save grid is also
    held to its plain version (the plain wipe and fold around the same
    cuFFT calls) within 2e-4 of its largest value (tests/test_shard_map.py's
    tolerance) and must peak at the injected delay and Doppler.  Returns
    the launches of K3's row kernel alone and of K7."""
    import torch
    import torch.distributed as dist
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.parallel import (make_mesh, replicate,
                                                      shard_channel_axis)
    from gnss_sim_receiver_tpu_torch.parallel import shard_steps as ss
    from gnss_sim_receiver_tpu_torch.parallel.mesh import backend_for
    # one rank on this host's loopback: NCCL needs no other interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    mesh = make_mesh()
    print(f"  mesh: rank {mesh.rank} of {mesh.world} on {mesh.device}, "
          f"backend {mesh.backend} ({time.perf_counter() - t0:.2f} s); a "
          "world of one card: every collective is a copy, no scaling is "
          "shown")
    if mesh.world != 1 or mesh.backend != backend_for(mesh.device):
        fail("phase 9 needs one rank, NCCL on a card")
    inp = shard_inputs(mesh.device, np.random.default_rng(99))
    conf, taps = inp["conf"], replicate(inp["taps"], mesh)

    def same_tracking(got, want):
        diff = differing(got[0], want[0], got[1], want[1])
        if diff:
            fail(f"sharded tracking: {diff} differ from the unsharded call")

    def same_tensors(got, want):
        for g, w in zip(got, want):
            if not torch.equal(bits(g), bits(w)):
                fail("sharded acquisition differs from the unsharded call")
    codes = shard_channel_axis(inp["codes"], mesh)
    st = shard_channel_axis(inp["state"], mesh)
    x = replicate(inp["x_epoch"], mesh)
    _sharded_step(
        "per-epoch tracking", wrappers, ss,
        lambda: ss.tracking_step_sharded(mesh, conf, SHARD_EPOCHS, codes,
                                         taps, x, st),
        lambda: trk.track_chunk(conf, SHARD_EPOCHS, codes, taps, x, st),
        same_tracking)
    rep = shard_channel_axis(inp["codes_rep"], mesh)
    xb = replicate(inp["x_block"], mesh)
    _sharded_step(
        "block tracking", wrappers, ss,
        lambda: ss.tracking_block_step_sharded(mesh, conf, SHARD_BLOCKS,
                                               SHARD_E, rep, taps, xb, st),
        lambda: tb.track_chunk_blocks(conf, SHARD_BLOCKS, SHARD_E, rep, taps,
                                      xb, st), same_tracking)
    dops_l = shard_channel_axis(inp["dops"], mesh)
    acq_x, cfc = replicate((inp["acq_x"], inp["acq_cfc"]), mesh)
    rows = _sharded_step(
        "Doppler-sharded acquisition", wrappers, ss,
        lambda: ss.acquisition_doppler_sharded(mesh, acq_x, cfc, dops_l, FS),
        lambda: ss.acquisition_doppler(acq_x, cfc, inp["dops"], FS),
        same_tensors)["K3_pcps_rows"]
    peak, dop_hz, delay, noise = ss.acquisition_doppler_sharded(
        mesh, acq_x, cfc, dops_l, FS)
    grid = pcps.pcps_grid(acq_x, cfc, inp["dops"], FS)
    want = pcps.grid_peak(grid)
    sats = [p - 1 for p in SCENARIO_PRNS]
    if not (torch.equal(delay[sats], want[2][sats]) and torch.equal(
            dop_hz[sats], inp["dops"][want[1].long()][sats])):
        fail("Doppler-sharded acquisition: the scenario's cells differ from "
             "the plain grid's peaks")
    compare("Doppler-sharded acquisition, peak (scenario PRNs)", peak[sats],
            want[0][sats], 1e-4)
    compare("Doppler-sharded acquisition, noise floor", noise,
            grid.mean(dim=(1, 2)), 1e-4)
    del grid
    os_x = shard_channel_axis(inp["os_x"], mesh)
    os_code, dops = replicate((inp["os_code"], inp["dops"]), mesh)
    k7 = _sharded_step(
        "time-sharded acquisition", wrappers, ss,
        lambda: (ss.overlap_save_acq_grid(mesh, os_x, os_code, dops, FS),),
        lambda: (ss.overlap_save_grid(os_x, os_code, dops, FS),),
        same_tensors)["K7_pcps_window_fold"]
    grid = ss.overlap_save_acq_grid(mesh, os_x, os_code, dops, FS)
    n = os_code.shape[0]
    ext = torch.cat([os_x, os_x[:n]])
    t = ((torch.arange(ext.shape[0], dtype=torch.float32, device=ext.device))
         / float(np.float32(FS)))
    corr = torch.fft.ifft(torch.fft.fft(pcps._wipe_plain(ext[None], dops, t)[0],
                                        dim=-1)
                          * ss._code_fft_padded(os_code, os_x.shape[0])[None],
                          dim=-1)
    compare("time-sharded acquisition grid against its plain version", grid,
            pcps._window_fold_plain(corr, n), 2e-4)
    di, li = divmod(int(torch.argmax(grid)), n)
    print(f"  time-sharded acquisition: [{grid.shape[0]}, {n}] grid over "
          f"{OS_PERIODS} periods, peak at {float(dops[di]):g} Hz, delay "
          f"{li} (injected {OS_DOPPLER:g} Hz, {OS_DELAY})")
    if float(dops[di]) != OS_DOPPLER or li != OS_DELAY:
        fail("time-sharded acquisition: the peak is not at the injected "
             "delay and Doppler")
    del corr, grid, ext
    dist.destroy_process_group()
    return {"K3_pcps_rows": rows, "K7_pcps_window_fold": k7}


def _linear_filters(rng, b: int, nx: int = 4, nz: int = 2, steps: int = 40):
    """tests/test_nonlinear.py's linear-Gaussian system, B independent
    trajectories of it: (F, H, Q, R, zs [steps, B, nz])."""
    F = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    H = rng.standard_normal((nz, nx))
    Q, R = 0.01 * np.eye(nx), 0.1 * np.eye(nz)
    x = rng.standard_normal((b, nx))
    zs = []
    for _ in range(steps):
        x = x @ F.T + rng.multivariate_normal(np.zeros(nx), Q, b)
        zs.append(x @ H.T + rng.multivariate_normal(np.zeros(nz), R, b))
    return F, H, Q, R, np.array(zs)


def _kalman(F, H, Q, R, zs, x0, P0):
    """The exact Kalman filter over the batch (its covariance is the same
    for every filter)."""
    x, P = x0.copy(), P0.copy()
    for z in zs:
        x = x @ F.T
        P = F @ P @ F.T + Q
        S = H @ P @ H.T + R
        K = np.linalg.solve(S.T, H @ P).T
        x = x + (z - x @ H.T) @ K.T
        P = P - K @ S @ K.T
    return x, P


def filters_path(wrappers, dev) -> dict:
    """Phase 9b: SIGMA_BATCH independent filters on the card through K10a,
    torch.func.vmap of the model and K10b: 40 steps of
    tests/test_nonlinear.py's linear system under both rules, each within
    1e-2 of the exact Kalman filter (that test's bound) and within 1e-4 of
    the largest value of the plain versions' run on the CPU; then the tanh
    measurement of test_cubature_converges_nonlinear_measurement, 150 steps
    of SIGMA_BATCH random walks, converging as that test demands (on the
    mean error over the filters).  Returns K10a's and K10b's launches."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    rng = np.random.default_rng(3)
    b = SIGMA_BATCH
    F, H, Q, R, zs = _linear_filters(rng, b)
    x_kf, P_kf = _kalman(F, H, Q, R, zs, np.zeros((b, 4)), np.eye(4))
    Ft, Ht = (torch.from_numpy(m.astype(np.float32)) for m in (F, H))
    zt = torch.from_numpy(zs.astype(np.float32))

    def run(rule, device):
        f, h = Ft.to(device), Ht.to(device)
        q, r = (torch.from_numpy(m.astype(np.float32)).to(device)
                for m in (Q, R))
        x = torch.zeros(b, 4, device=device)
        P = torch.eye(4, device=device).repeat(b, 1, 1)
        z_all = zt.to(device)
        for k in range(zs.shape[0]):
            x, P = nl.sigma_predict(x, P, lambda s: f @ s, q, rule=rule)
            x, P = nl.sigma_update(z_all[k], x, P, lambda s: h @ s, r,
                                   rule=rule)
        return x, P
    reset(wrappers)
    for rule in ("cubature", "unscented"):
        run(rule, dev)                              # builds, warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, P = run(rule, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # the largest norm over the filters, as the test's per filter
        ex = float(np.linalg.norm(x.cpu().numpy() - x_kf, axis=1).max())
        ep = float(np.linalg.norm(P.cpu().numpy() - P_kf, axis=(1, 2)).max())
        print(f"  {rule}: {zs.shape[0]} steps of {b} filters in {secs:.4f} s "
              f"({1e3 * secs / zs.shape[0]:.3f} ms a step, host); against "
              f"the Kalman filter: x {ex:.2e}, P {ep:.2e}")
        if ex > 1e-2 or ep > 1e-2:
            fail(f"phase 9b ({rule}): off the Kalman filter")
        x_cpu, P_cpu = run(rule, "cpu")
        compare(f"phase 9b ({rule}) against the plain versions",
                (x.cpu(), P.cpu()), (x_cpu, P_cpu), 1e-4)
    # the tanh measurement: scalar random walks
    steps = 150
    truth = np.cumsum(0.05 * rng.standard_normal((steps, b)), axis=0) + 1.0
    zs = np.tanh(truth) + rng.normal(0, 0.1, (steps, b))
    q = torch.tensor([[0.05 ** 2]], device=dev)
    r = torch.tensor([[0.01]], device=dev)
    x = torch.zeros(b, 1, device=dev)
    P = torch.full((b, 1, 1), 4.0, device=dev)
    z_all = torch.from_numpy(zs.astype(np.float32)).to(dev)
    est = []
    for k in range(steps):
        x, P = nl.sigma_predict(x, P, lambda s: s, q)
        x, P = nl.sigma_update(z_all[k], x, P, torch.tanh, r)
        est.append(x[:, 0])
    errs = np.abs(torch.stack(est).cpu().numpy() - truth).mean(axis=1)
    print(f"  tanh measurement, {b} filters: mean error {errs[:10].mean():.4f}"
          f" over the first 10 steps, {errs[-30:].mean():.4f} over the last "
          "30")
    if not (errs[-30:].mean() < 0.5 * errs[:10].mean()
            and errs[-30:].mean() < 0.4):
        fail("phase 9b: the tanh filters did not converge")
    launches = read_launches(wrappers, ("K10a_sigma_points",
                                        "K10b_sigma_moments"))
    return {k: launches[k] for k in ("K10a_sigma_points",
                                     "K10b_sigma_moments")}


def profile_path(run) -> None:
    """`--profile`: `run()` (one run of a path, returning a line to print)
    twice more, plain and under torch.profiler: wall time, device busy
    share (kernel time over wall), device time by kernel and host time by
    operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    print(f"  unprofiled second run: {run()}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device events only (kernels and copies): an operator's entry carries
    # its kernels' device time as well and would count it twice
    from torch.autograd import DeviceType
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    n_ops = sum(e.count for e in avgs if e.key.startswith("aten::"))
    launch_calls = {e.key: e.count for e in avgs
                    if e.key.startswith(("cudaLaunch", "cuLaunch"))}
    print(f"  profiled run: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f} %) in {sum(e.count for e in kernels)} "
          f"kernels and copies, {n_ops} aten operator calls; launch calls "
          f"{launch_calls}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"    {dev_us(e) / 1e3:10.1f} ms  {e.count:8d}x  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"    host {e.self_cpu_time_total / 1e3:10.1f} ms  "
              f"{e.count:8d}x  {e.key[:80]}")


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:2] == ["--synthesize"]:
        make_capture(root, sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    print("== phase 1: card", flush=True)
    card = card_line()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels_only = "--kernels-only" in sys.argv[1:]
    procs = {} if kernels_only else start_synthesis(root)
    try:
        return run_phases(root, card, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(root: str, card: str, procs: dict) -> int:
    """Phases 2 to 8b and the result lines; `procs` are the synthesis
    children (none with --kernels-only)."""
    import torch
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import (correlator, cuda_build,
                                                 filters, nonlinear, pcps,
                                                 prn_codes, resampler)
    from gnss_sim_receiver_tpu_torch.sim import device_generator
    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    # the block library a second time with --fmad=false (phase 3 holds its
    # K8a and K8b to the default build's bits), beside the others
    variant = {}

    def build_variant():
        try:
            variant["secs"] = cuda_build.build_all(
                ("block_kernels",), FMAD_FALSE, fmad_false_dir())
        except RuntimeError as err:
            variant["error"] = err
    variant_build = threading.Thread(target=build_variant)
    variant_build.start()
    secs = cuda_build.build_all()
    variant_build.join()
    if "error" in variant:
        raise variant["error"]
    for (name, s), extra, where in (
            *((kv, (), None) for kv in secs.items()),
            (("block_kernels", variant["secs"]["block_kernels"]),
             FMAD_FALSE, fmad_false_dir())):
        log = cuda_build.library_path(name, extra, where).with_suffix(
            ".log").read_text(errors="replace") if s else ""
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}{' ' + ' '.join(extra) if extra else ''}: nvcc "
              f"{s:.1f} s; {'; '.join(regs)}")
    print(f"  CUDA libraries built in {time.perf_counter() - t0:.1f} s "
          "(parallel)", flush=True)

    print("== phase 3: kernels against their plain versions", flush=True)
    rng = np.random.default_rng(1234)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gps = trk.TrackingConf(fs=FS)
    gps_taps = (0.25, 0.0, -0.25)
    gps20 = trk.TrackingConf(fs=FS_REF_HYBRID)
    e1 = hybrid_chain(FS_REF_HYBRID).trk
    e1_taps = conf_taps(e1)
    # the block step first (the newest kernels), at the shapes its paths
    # launch: phase 4 (C=8) and 6 (C=12) at 2 Msps, phase 5's E1 and GPS
    # chains at 20 Msps (phase 7's L5 and E5a chains share the GPS one's
    # E, K and F)
    # the per-epoch closure first (the newest kernel), at phase 8's two
    # chains' shapes, then phase 8b's (GPS at 2 Msps) and the chunk tails'
    rng9 = np.random.default_rng(9)
    gps20_ext = trk.TrackingConf(fs=FS_REF_HYBRID,
                                 extend_correlation_symbols=20)
    e1p = pilot_receiver_conf().chains[0].trk
    rows = [check_k9(dev, rng9, gps20_ext, 10, "K9_epoch_closure",
                     "GPS L1 C/A at 20 Msps"),
            check_k9(dev, rng9, e1p, 10, "K9_epoch_closure_E1",
                     "Galileo E1 pilot at 20 Msps"),
            check_k2(dev, rng9, e1p, 10, conf_taps(e1p),
                     signals.CodeProvider("1B", "C"),
                     "K2_multicorrelate_E1_data",
                     "Galileo E1 pilot at 20 Msps",
                     data_provider=signals.CodeProvider("1B"))]
    extra = [check_k9(dev, rng9, trk.TrackingConf(fs=FS, **kw), 8,
                      "K9_epoch_closure", f"GPS L1 C/A at 2 Msps, {lab}")
             for kw, lab in (({}, "k_ext 1"),
                             ({"extend_correlation_symbols": 20},
                              "k_ext 20"))]
    # the chunk kernel against the two-launch chunk at phase 8's two chains'
    # shapes (1 s chunks: 1000 GPS epochs, 250 E1 epochs), phase 8b's and
    # the 2 Msps chunk tails'
    rows += [check_epoch_chunk_bits(dev, rng9, gps20_ext, 10,
                                    "K9_epoch_chunk",
                                    "GPS L1 C/A at 20 Msps", 1000),
             check_epoch_chunk_bits(dev, rng9, e1p, 10, "K9_epoch_chunk_E1",
                                    "Galileo E1 pilot at 20 Msps", 250,
                                    chain=pilot_receiver_conf().chains[0])]
    extra += [check_epoch_chunk_bits(
        dev, rng9, trk.TrackingConf(fs=FS, **kw), 8, "K9_epoch_chunk",
        f"GPS L1 C/A at 2 Msps, {lab}", n)
        for kw, lab, n in (({}, "k_ext 1", 30),
                           ({"extend_correlation_symbols": 20}, "k_ext 20",
                            1000))]
    extra.append(check_epoch_chunk_waves(dev, rng9))
    check_epoch_chunk_cluster_sizes(dev, np.random.default_rng(11))
    torch.cuda.empty_cache()
    check_epoch_chunk(dev)
    torch.cuda.empty_cache()
    rng8 = np.random.default_rng(8)
    k8 = ("K8a_block_prologue", "K8b_block_closure",
          "K1_K8b_block_correlate_close", "K1_K8b_K8a_block_step")
    k8_e1 = tuple(n + "_E1" for n in k8)
    gps_code = prn_codes.gps_l1_ca_code
    rows += [*check_k8(dev, rng8, gps, 8, gps_taps, gps_code, 1000, k8,
                       "GPS L1 C/A at 2 Msps"),
             *check_k8(dev, rng8, e1, 10, e1_taps,
                       signals.CodeProvider("1B"), 250, k8_e1,
                       "Galileo E1-B at 20 Msps")]
    extra += [*check_k8(dev, rng8, gps, 12, gps_taps, gps_code, 1000, k8,
                        "GPS L1 C/A at 2 Msps, 12 channels"),
              *check_k8(dev, rng8, gps20, 10, gps_taps, gps_code, 250, k8,
                        "GPS L1 C/A at 20 Msps")]
    torch.cuda.empty_cache()
    # the two-launch chunk at the same four shapes
    for conf_, c_, taps_, prov, lab in (
            (gps, 8, gps_taps, gps_code, "GPS L1 C/A at 2 Msps"),
            (gps, 12, gps_taps, gps_code,
             "GPS L1 C/A at 2 Msps, 12 channels"),
            (gps20, 10, gps_taps, gps_code, "GPS L1 C/A at 20 Msps"),
            (e1, 10, e1_taps, signals.CodeProvider("1B"),
             "Galileo E1-B at 20 Msps")):
        extra.append(check_block_chunk_bits(dev, rng8, conf_, c_, taps_,
                                            prov, lab))
        torch.cuda.empty_cache()
    k5b_row, notch_case = check_k5b(dev, rng)
    rows += [check_k1(dev, rng, gps, 8, 20, gps_taps, 1000,
                     "K1_block_correlate", "GPS L1 C/A at 2 Msps"),
            check_k2(dev, rng, gps, 8, gps_taps, prn_codes.gps_l1_ca_code,
                     "K2_multicorrelate", "GPS L1 C/A at 2 Msps")]
    # phase 5's GPS chain: 10 channels at 20 Msps
    label = f"GPS L1 C/A at {FS_REF_HYBRID / 1e6:g} Msps"
    extra += [check_k1(dev, rng, gps20, 10, 20, gps_taps, 250,
                       "K1_block_correlate", label),
              check_k2(dev, rng, gps20, 10, gps_taps,
                       prn_codes.gps_l1_ca_code, "K2_multicorrelate", label)]
    torch.cuda.empty_cache()
    for fs in (FS_REF_HYBRID, FS_FILE):
        e1 = hybrid_chain(fs).trk
        e1_taps = conf_taps(e1)
        label = f"Galileo E1-B at {fs / 1e6:g} Msps"
        k1 = check_k1(dev, rng, e1, 10, 5, e1_taps, 250,
                      "K1_block_correlate_E1", label)
        k2 = check_k2(dev, rng, e1, 10, e1_taps, signals.CodeProvider("1B"),
                      "K2_multicorrelate_E1", label)
        if fs == FS_REF_HYBRID:
            rows += [k1, k2]
        else:
            extra += [k1, k2]
        torch.cuda.empty_cache()
    rows += [*check_k3(dev), check_k3b(dev)]
    k3c = []
    for variant in ("cccwsr", "8ms"):
        for fs in (FS_REF_HYBRID, FS_FILE):
            row = check_k4a(dev, fs, variant, extra, k3c)
            if row is not None:
                rows.append(row)
    rows += check_k4b(dev, extra)
    rows.append(check_k4c(dev, extra, k3c))
    rows += k3c
    check_wideband_shapes(dev, rng, extra)
    check_k3_search_shapes(dev, extra)
    check_wipe_path_shapes(dev, extra)
    rows += [check_k5a(dev, rng), k5b_row, check_k5c(dev, rng),
             *check_k5d(dev, rng)]
    torch.cuda.empty_cache()
    rows.append(check_k6(dev, FS_REF_HYBRID, hybrid_sats(), DUR, 17,
                         f"hybrid at {FS_REF_HYBRID / 1e6:g} Msps"))
    extra.append(check_k6(dev, FS, full_chain_sats(), FULL_DUR, 3,
                          f"full chain at {FS / 1e6:g} Msps"))
    extra.append(check_k6(dev, FS_WIDEBAND, wideband_sats(), WB_DUR, 17,
                          f"wideband at {FS_WIDEBAND / 1e6:g} Msps"))
    torch.cuda.empty_cache()
    rng7 = np.random.default_rng(7)
    rows.append(check_k3_rows(dev))
    rows.append(check_k7(dev, rng7, extra))
    rows += check_k10(dev, rng7, extra)
    torch.cuda.empty_cache()
    print(f"  phase 3 took {time.perf_counter() - t0:.1f} s (includes the "
          "Triton compiles)", flush=True)
    print(json.dumps({"other_shapes": extra}))
    if not procs:
        print(json.dumps({"kernels": rows}))
        return 0

    wrappers = {
        "K1_block_correlate": (tb.block_correlate, "launches"),
        "K8a_block_prologue": (tb.block_prologue, "launches"),
        "K8b_block_closure": (tb.block_closure, "launches"),
        "K1_K8b_block_correlate_close": (tb.block_correlate_close,
                                         "launches"),
        "K1_K8b_K8a_block_step": (tb.block_correlate_close, "folds"),
        "block_chunks": (tb.track_chunk_blocks, "chunks"),
        "K9_epoch_closure": (trk.epoch_closure, "launches"),
        "K2_multicorrelate": (correlator.multicorrelate, "launches"),
        "K9_epoch_chunk": (trk.epoch_chunk, "launches"),
        "K9_epoch_chunk_epochs": (trk.epoch_chunk, "epochs"),
        "K3_pcps_wipe": (pcps.pcps_wipe, "launches"),
        "K3_pcps_peak": (pcps.pcps_peak, "launches"),
        "K3b_pcps_wipe_per_channel": (pcps.pcps_wipe,
                                      "launches_per_channel"),
        "K4a_pcps_dual_peak": (pcps.pcps_dual_peak, "launches"),
        "K4b_quicksync_fold": (pcps.pcps_quicksync_fold, "launches"),
        "K4b_quicksync_resolve": (pcps.pcps_quicksync_resolve, "launches"),
        "K4c_pcps_caf_peak": (pcps.pcps_caf_peak, "launches"),
        "K3c_pcps_second_peak": (pcps.pcps_second_peak, "launches"),
        "K3c_pcps_second_peak_dual": (pcps.pcps_second_peak,
                                      "launches_dual"),
        "K3c_pcps_second_peak_caf": (pcps.pcps_second_peak, "launches_caf"),
        "K5a_fir_decim": (filters.fir_decim, "launches"),
        "K5b_notch_filter": (filters.notch_filter, "launches"),
        "K5c_pulse_blanking": (filters.pulse_blanking, "launches"),
        "K5d_direct_resampler": (resampler.direct_resampler, "launches"),
        "K5d_linear_resampler": (resampler.linear_resampler, "launches"),
        "K6_device_generator": (device_generator.expand, "launches"),
        "K3_pcps_rows": (pcps.pcps_rows, "launches"),
        "K7_pcps_window_fold": (pcps.pcps_window_fold, "launches"),
        "K10a_sigma_points": (nonlinear.sigma_points, "launches"),
        "K10b_sigma_moments": (nonlinear.sigma_moments, "launches")}
    print("== phase 4: main path (conf file -> capture file -> conditioner "
          "-> receiver -> position)", flush=True)
    for which in procs:           # no child may run beside a timed window
        wait_for(procs, which)
    print("== phase 3, continued: a 50-block chunk of phase 4's path on its "
          "capture, kernel path against the plain block body", flush=True)
    check_block_chunk(root)
    torch.cuda.empty_cache()
    pcps.pcps_wipe.shapes.clear()
    launches = main_path(root, wrappers)
    print("== phase 4b: the conditioner alone", flush=True)
    cond = conditioner_path(root, wrappers, notch_case)
    for name in COND_KERNELS[1:]:
        launches[name] = cond[name]
    print("== phase 4c: the array entry point (process_array, "
          f"{DIRECT_DUR:.0f} s at 2 Msps)", flush=True)
    direct_path(root, wrappers)
    print("== phase 4d: QuickSync acquisition through the CLI; Tong and "
          "Fine Doppler on the card", flush=True)
    quick = quicksync_path(root, wrappers)
    for name in QUICKSYNC_KERNELS[:2]:
        launches[name] = quick[name]
    tong_fine_doppler(root, wrappers)
    print("== phase 4e: the first-vs-second-peak statistic and a fixed "
          "threshold through the CLI; Tong and Fine Doppler under it and "
          "with bit_transition_flag", flush=True)
    ratio = ratio_path(root, wrappers)
    launches["K3c_pcps_second_peak"] = ratio["K3c_pcps_second_peak"]
    tong_fine_doppler(root, wrappers, TAIL_CASES)
    print("== phase 4f: the ROC harness (trials as K3's channels)",
          flush=True)
    roc_path(wrappers)
    print("== phase 5: the hybrid path at 20 Msps (device generator -> "
          "ibyte file -> GPS L1 C/A + Galileo E1-B conf -> receiver -> joint "
          "position)", flush=True)
    k6 = make_hybrid_capture(root, wrappers)["K6_device_generator"]
    hybrid = hybrid_path(root, wrappers, card)
    if "--profile" in sys.argv[1:]:
        from gnss_sim_receiver_tpu_torch.__main__ import run_cli
        argv = ["--config_file="
                + os.path.join(root, "build", "chip_smoke_hybrid.conf")]
        print("== profile of the hybrid path", flush=True)
        profile_path(lambda: f"seconds {run_cli(argv).seconds}")
    for name in ("K1_block_correlate", "K2_multicorrelate",
                 "K8b_block_closure", *BLOCK_STEP_KERNELS):
        launches[name + "_E1"] = hybrid[name]
    launches["K4a_pcps_dual_peak"] = hybrid["K4a_pcps_dual_peak"]
    print("== phase 5b: 8 ms acquisition on the hybrid capture", flush=True)
    hybrid_acquisition(root, wrappers)
    print("== phase 5c: CCCWSR and 8 ms acquisition under the "
          "first-vs-second-peak statistic on the hybrid capture",
          flush=True)
    launches["K3c_pcps_second_peak_dual"] = sum(
        hybrid_acquisition(root, wrappers, impl, ratio_props("1B"))[
            "K3c_pcps_second_peak_dual"] for impl in ("CCCWSR", "8ms"))
    print("== phase 6: the full chain (bench.py's 12-satellite, 120 s "
          "scenario made on the card -> process_array)", flush=True)
    full = full_chain(wrappers, card)
    if "--witness" in sys.argv[1:]:
        print("== witness: phase 5's position error by rate, chips, "
              "quantization and noise", flush=True)
        hybrid_witness()
    print("== phase 7: the wideband path at 20 Msps (device generator -> "
          "ibyte file -> GPS L5 + Galileo E5a conf -> receiver -> joint "
          "position)", flush=True)
    k6_wb = make_wideband_capture(root, wrappers)["K6_device_generator"]
    wide = wideband_path(root, wrappers, card)
    os.remove(capture_paths(root)["wideband"])
    launches["K4c_pcps_caf_peak"] = wide["K4c_pcps_caf_peak"]
    print("== phase 8: the hybrid pilot path at 20 Msps (device generator "
          "-> process_array's session -> GPS L1 C/A at 20 ms + Galileo E1-C "
          "pilot with the E1-B data prompt at 20 ms -> joint position)",
          flush=True)
    pilot = pilot_path(wrappers, card)
    for name in ("K9_epoch_closure", "K9_epoch_closure_E1",
                 "K2_multicorrelate_E1_data", "K9_epoch_chunk",
                 "K9_epoch_chunk_E1"):
        launches[name] = pilot[name]
    print("== phase 8b: phase 4's conf with "
          "Tracking_1C.extend_correlation_symbols=20 through the CLI",
          flush=True)
    pilot_conf_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print("== phase 9: the sharded steps on one rank over NCCL (per-epoch "
          "and block tracking of 192 channels, Doppler- and time-sharded "
          "acquisition)", flush=True)
    launches.update(sharded_path(wrappers))
    torch.cuda.empty_cache()
    print("== phase 9b: the sigma-point filters (4096 filters through K10a, "
          "torch.func.vmap and K10b)", flush=True)
    launches.update(filters_path(wrappers, dev))
    # K6's launches: the captures of phases 5, 6, 7 and 8
    launches["K6_device_generator"] = (k6 + full["K6_device_generator"]
                                       + k6_wb + pilot["K6_device_generator"])
    for r in rows:
        r["launches"] = launches[r["name"]]

    wipe_shapes = dict(pcps.pcps_wipe.shapes)
    print(f"  the wipeoff's launches in phases 4 to 9b by (M, Doppler table, "
          f"N): {wipe_shapes}")
    missing = sorted({wipe_key(k) for k in wipe_shapes} - WIPE_CHECKED)
    if missing:
        fail(f"the wipeoff ran at shapes phase 3 did not hold to its "
             f"reference: {missing}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(card)
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, "reference_ms": r.get("reference_ms")}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
