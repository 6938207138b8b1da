"""Probe, on one CUDA card, where the block chunk should fold K8a (the next
block's prologue) into the fused launch of K1 with K8b, and what the
standalone K8a takes.

    python3 tools/probe_fold.py [--root DIR] [--k8a-only]

Prints the card's name and power limit, then:

1. the standalone K8a (`block_prologue`) at GPS L1 C/A 2 Msps (C = 8, E =
   20, K = 3, F = 4096), GPS L1 C/A 20 Msps (C = 10, F = 40500) and Galileo
   E1-B 20 Msps (C = 10, E = 5, K = 5, F = 162000): device ms of one
   launch by CUDA graph replay (chip_smoke.time_ms), the median and range
   of 7;
2. without --k8a-only, the two-launch chunk (K8a for the first block, the
   next prologue folded into every later fused launch) against the
   three-launch chunk (K8a, the cuFFT and the fused launch per block) over
   50 blocks at shapes whose share of the next replica per CTA runs from
   274 to 40500 samples (the channel count sets K1's slabs S, and the
   S - 1 CTAs besides the closure's write the replica; with S = 1 the
   closure's CTA writes all of it): first bit for bit against each other
   and the plain chunk (chip_smoke.check_block_chunk_bits), then device ms
   per block, 7 alternations of the two forms, medians and ranges.

--root runs the package and chip_smoke.py of another tree (a copy of an
older commit, for K8a's parent/change pairs in one call; with
--k8a-only it needs nothing the fold added).  Needs the card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

REPEATS = 7
# (label, chain, channels): GPS at 2 and 20 Msps, E1 at 20 Msps
CHUNK_SHAPES = (("gps2", 8), ("gps2", 140),
                ("gps20", 10), ("gps20", 40), ("gps20", 66), ("gps20", 132),
                ("gps20", 264),
                ("e1", 10), ("e1", 20), ("e1", 40))
K8A_SHAPES = (("gps2", 8), ("gps20", 10), ("e1", 10))


def stats(xs) -> str:
    return (f"{float(np.median(xs)):.5f} [{min(xs):.5f}, {max(xs):.5f}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--k8a-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("probe_fold: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import prn_codes
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"tree: {args.root}")
    dev = torch.device("cuda")
    e1 = cs.hybrid_chain(cs.FS_REF_HYBRID).trk
    gps_taps = (0.25, 0.0, -0.25)

    def gps_code(prn):                    # 32 PRNs for up to 264 channels
        return prn_codes.gps_l1_ca_code((prn - 1) % 32 + 1)
    chains = {
        "gps2": (trk.TrackingConf(fs=cs.FS), gps_taps,
                 gps_code, "GPS L1 C/A at 2 Msps", 1000),
        "gps20": (trk.TrackingConf(fs=cs.FS_REF_HYBRID), gps_taps,
                  gps_code, "GPS L1 C/A at 20 Msps", 250),
        "e1": (e1, cs.conf_taps(e1), signals.CodeProvider("1B"),
               "Galileo E1-B at 20 Msps", 250)}

    for key, c in K8A_SHAPES:
        conf, taps, provider, label, n_wins = chains[key]
        rng = np.random.default_rng(8)
        s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
        e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
        tables = np.stack([prn_codes.bandlimited_table_normalized(
            provider(p), conf.fs, conf.code_rate_cps, s0, 8)
            for p in range(1, c + 1)])
        codes_rep = tb.code_spectra(conf, tables, dev)
        taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
        st = cs.block_state(rng, conf, c, e, n_wins, dev)
        ms = [cs.time_ms(lambda: tb.block_prologue(conf, e, codes_rep, taps_t,
                                                   n_wins, st))
              for _ in range(REPEATS)]
        print(f"K8a standalone ({label}: C={c}, E={e}, K={len(taps)}, "
              f"F={nfft}): {stats(ms)} ms, median [range] of {REPEATS}")
    if args.k8a_only:
        return 0

    n = cs.BLOCK_CHUNK_BLOCKS
    for key, c in CHUNK_SHAPES:
        conf, taps, provider, label, _ = chains[key]
        rng = np.random.default_rng(8)
        row = cs.check_block_chunk_bits(dev, rng, conf, c, taps, provider,
                                        label)
        # the same inputs again for the alternations
        rng = np.random.default_rng(8)
        s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
        e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
        tables = np.stack([prn_codes.bandlimited_table_normalized(
            provider(p), conf.fs, conf.code_rate_cps, s0, 8)
            for p in range(1, c + 1)])
        codes_rep = tb.code_spectra(conf, tables, dev)
        taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
        st = cs.block_state(rng, conf, c, e, 2 * e + 2, dev)
        x = cs._cnoise(rng, (n * e + 2 * e + 4) * s0 + nfft, dev)
        xf_all = tb._window_spectra(x, s0, nfft).contiguous()
        chunk = (conf, n, e, codes_rep, taps_t, xf_all, st)
        slabs = tb.plan_k1(c, e, nfft, tb.sm_count(dev))
        share = -(-nfft // max(slabs - 1, 1))
        two, three = [], []
        for _ in range(REPEATS):
            two.append(cs.time_ms(lambda: tb._chunk_cuda(*chunk, fold=True),
                                  reps=2) / n)
            three.append(cs.time_ms(
                lambda: tb._chunk_cuda(*chunk, fold=False), reps=2) / n)
        print(f"fold ({label}: C={c}, E={e}, F={nfft}, S={slabs}, replica "
              f"share {share} samples a CTA): ms per block, median "
              f"[range] of {REPEATS}: two-launch {stats(two)}, "
              f"three-launch {stats(three)}; two-launch/three-launch "
              f"{float(np.median(two)) / float(np.median(three)):.4f} "
              f"(check_block_chunk_bits: {row['ms_two_launch'] / n:.5f} "
              f"against {row['ms_three_launch'] / n:.5f})", flush=True)
        del chunk, xf_all, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
