"""Probe, on one CUDA card, the per-epoch closure K9 and the chunk kernel
in each of their forms, and the loops' form against another tree's.

    python3 tools/probe_k9_forms.py                   # the forms
    python3 tools/probe_k9_forms.py --tree build/parent --parity

Without --parity: builds the tracking library of this checkout and runs
chip_smoke.py's phase 3 checks of the KF, gaussian and second-order PLL
forms at GPS 2 Msps (C = 8, K = 3): K9 from edge states against its plain
closure, then the chunk kernel against the two-launch chunk bit for bit
over 50 epochs and against the plain loop, each timed; then the rectified
lock test the same way at phase 15(c)'s GEO shape, K9 also against the
coherent form on the same inputs, and the chunk in both forms in turns
(the quick check of a new form, about a minute).

With --parity: imports the package and chip_smoke.py of the tree `--tree`
(default: this checkout) and runs the chunk kernel at the KF, gaussian and
second-order PLL forms' shape (GPS at 2 Msps, 1000-epoch path chunks) and
at phase 3's four DLL/PLL K9 shapes (GPS at 20 Msps with k_ext 20, the
Galileo E1 pilot at 20 Msps, GPS at 2 Msps with k_ext 1 and 20) from the
same seeded states (the Kalman forms' covariances positive definite) and
noise capture, printing per shape one JSON line: a SHA-256 of
every plane and state field after 50 epochs, and the device milliseconds
of a 50-epoch chunk and of the path's chunk by CUDA-graph replay; then the
block step the same way at phase 3's GPS 2 Msps, E1-B 20 Msps and E1
pilot 20 Msps shapes: K8a alone and the two-launch chunk (K8a, then K1
with K8b and the next block's K8a folded) over 50 blocks from
block_state's edge states, a SHA-256 of K8a's outputs and one of the
chunk's planes and final state, and the chunk's device milliseconds.  Run
it on two trees in one call (parent, change, change, parent) to hold the
kernels' bits and times across a change of them.  Prints the card's name
and power limit first.

Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def parity(cs, trk, interop, torch) -> None:
    """The shapes of phase 3's K9_epoch_chunk rows in every form the tree
    has in common with its parent (the DLL/PLL loops of order 3 and 2, the
    KF, the gaussian mode): hashes, times."""
    dev = torch.device("cuda")
    shapes = tuple(
        (f"GPS L1 C/A at 2 Msps, {lab}", trk.TrackingConf(fs=cs.FS, **kw), 8,
         1000, None) for kw, _, lab in cs.KALMAN_FORMS) + (
        ("GPS L1 C/A at 20 Msps, k_ext 20",
         trk.TrackingConf(fs=cs.FS_REF_HYBRID, extend_correlation_symbols=20),
         10, 1000, None),
        ("Galileo E1 pilot at 20 Msps", cs.pilot_receiver_conf().chains[0].trk,
         10, 250, cs.pilot_receiver_conf().chains[0]),
        ("GPS L1 C/A at 2 Msps, k_ext 1", trk.TrackingConf(fs=cs.FS), 8, 30,
         None),
        ("GPS L1 C/A at 2 Msps, k_ext 20",
         trk.TrackingConf(fs=cs.FS, extend_correlation_symbols=20), 8, 1000,
         None))
    for i, (label, conf, c, path_epochs, chain) in enumerate(shapes):
        rng = np.random.default_rng(100 + i)
        if chain is None:
            eng = trk.TrackingEngine(conf, range(1, c + 1), device=dev)
        else:
            eng = trk.TrackingEngine(
                conf, range(11, 11 + c), code_provider=chain.code_provider,
                data_code_provider=chain.data_code_provider, device=dev)
        st = cs.epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev,
                            kalman_edges=False)
        x = cs._cnoise(rng, (1 << 20) + (path_epochs + 2) * conf.block_size,
                       dev)
        t = cs.CHUNK_CHECK_EPOCHS
        new, planes = trk.epoch_chunk(conf, t, eng.codes, eng.taps, x, st,
                                      eng.data_codes)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for k, _ in trk.EPOCH_PLANES:
            h.update(planes[k].cpu().numpy().tobytes())
        for k, v in sorted(interop.track_state_to_numpy(new).items()):
            h.update(k.encode() + np.ascontiguousarray(v).tobytes())

        def fixed(n_ep):
            launch = trk.chunk_launch(conf, n_ep, eng.codes, eng.taps, x, st,
                                      eng.data_codes)
            return lambda: trk.launch_chunk(launch)
        ms = cs.time_ms(fixed(t), reps=5)
        ms_path = cs.time_ms(fixed(path_epochs), reps=2)
        print(json.dumps({"shape": label, "sha256": h.hexdigest(),
                          "ms": ms, "ms_per_epoch": ms / t,
                          "ms_path_chunk": ms_path,
                          "path_epochs": path_epochs}), flush=True)


def block_parity(cs, trk, interop, torch) -> None:
    """The block step at phase 3's K8a and K1 with K8b and K8a rows'
    shapes (check_block_chunk_bits' inputs): hashes, times."""
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import prn_codes
    dev = torch.device("cuda")
    pilot = cs.pilot_receiver_conf(gps_extend=1, e1_extend=1).chains[0].trk
    e1 = cs.hybrid_chain(cs.FS_REF_HYBRID).trk
    shapes = (
        ("GPS L1 C/A at 2 Msps", trk.TrackingConf(fs=cs.FS), 8,
         (0.25, 0.0, -0.25), prn_codes.gps_l1_ca_code, None),
        ("Galileo E1-B at 20 Msps", e1, 10, cs.conf_taps(e1),
         signals.CodeProvider("1B"), None),
        ("Galileo E1 pilot at 20 Msps", pilot, 10, cs.conf_taps(pilot),
         signals.CodeProvider("1B", "C"), signals.CodeProvider("1B")))
    for i, (label, conf, c, taps, provider, data) in enumerate(shapes):
        rng = np.random.default_rng(200 + i)
        s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
        e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
        n = cs.BLOCK_CHUNK_BLOCKS
        codes_rep, sec = cs.pilot_tables(conf, c, provider, data, dev)
        taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
        st = cs.block_state(rng, conf, c, e, 2 * e + 2, dev, sec is not None)
        x = cs._cnoise(rng, (n * e + 2 * e + 4) * s0 + nfft, dev)
        xf_all = tb._window_spectra(x, s0, nfft).contiguous()
        pro = tb.block_prologue(conf, e, codes_rep, taps_t, xf_all.shape[0],
                                st)
        args = (conf, n, e, codes_rep, taps_t, xf_all, st)
        new, planes = tb._chunk_cuda(*args, fold=True, sec_code=sec)
        torch.cuda.synchronize()
        h_pro = hashlib.sha256()
        for k in pro._fields:
            h_pro.update(k.encode() + getattr(pro, k).cpu().numpy().tobytes())
        h = hashlib.sha256()
        for k in sorted(planes):
            h.update(k.encode() + planes[k].cpu().numpy().tobytes())
        for k, v in sorted(interop.track_state_to_numpy(new).items()):
            h.update(k.encode() + np.ascontiguousarray(v).tobytes())
        ms = cs.time_ms(lambda: tb._chunk_cuda(*args, fold=True,
                                               sec_code=sec), reps=2)
        print(json.dumps({"shape": f"{label}, block step", "k8a_sha256":
                          h_pro.hexdigest(), "chunk_sha256": h.hexdigest(),
                          "ms_chunk": ms, "blocks": n}), flush=True)


def forms(cs, trk, torch) -> None:
    """chip_smoke.py's phase 3 checks of the new forms."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    rows = []
    for kw, suffix, lab in cs.KALMAN_FORMS:
        conf = trk.TrackingConf(fs=cs.FS, **kw)
        rows.append(cs.check_k9(dev, rng, conf, 8, "K9_epoch_closure" + suffix,
                                f"GPS L1 C/A at 2 Msps, {lab}"))
        rows.append(cs.check_epoch_chunk_bits(
            dev, rng, conf, 8, "K9_epoch_chunk" + suffix,
            f"GPS L1 C/A at 2 Msps, {lab}", 1000))
    rows.append(cs.check_k9(
        dev, rng, trk.TrackingConf(fs=cs.FS, pll_filter_order=2,
                                   extend_correlation_symbols=20), 8,
        "K9_epoch_closure_pll2", "GPS L1 C/A at 2 Msps, second-order PLL, "
        "k_ext 20"))
    # the rectified lock test, a flag of every form: phase 15(c)'s GEO conf,
    # its chunk in turns with the coherent form's at the same shape
    rows.append(cs.check_rectify_flag(dev, rng))
    gchain = cs.geo_chain()
    coherent = dataclasses.replace(gchain.trk, lock_rectify=False)
    for _ in range(2):
        for conf, name, lab in (
                (gchain.trk, "K9_epoch_chunk_rectify", "rectified lock"),
                (coherent, "K9_epoch_chunk", "coherent lock")):
            rows.append(cs.check_epoch_chunk_bits(
                dev, rng, conf, 8, name,
                f"BeiDou B1I GEO at 8.192 Msps, {lab}", cs.GEO_CHUNK,
                chain=gchain))
    print(json.dumps({"rows": rows}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--parity", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("probe_k9_forms: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    print(f"tree {Path(cs.__file__).parent}; built epoch_kernels in "
          f"{cuda_build.build_all(('epoch_kernels',))['epoch_kernels']:.1f} "
          "s", flush=True)
    if args.parity:
        parity(cs, trk, interop, torch)
        secs = cuda_build.build_all(("block_kernels",))["block_kernels"]
        print(f"built block_kernels in {secs:.1f} s", flush=True)
        block_parity(cs, trk, interop, torch)
    else:
        forms(cs, trk, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
