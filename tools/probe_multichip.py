"""Run the sharded steps (``parallel/shard_steps.py``, K7) across several
cards over NCCL: the four steps of chip_smoke.py's phase 9 with the
channel, Doppler and time axes split over every rank.

    torchrun --standalone --nproc-per-node 4 tools/probe_multichip.py

on four cards of one host (``--device cpu --small`` runs the same over
gloo on the CPU at a small size).  Every rank builds the same inputs from
one seed, takes its block of each sharded argument
(``shard_channel_axis``), runs each step once cold and REPEATS times warm
and holds the result against the unsharded calls of the same port
functions on its own card.  The tracking steps' gathered planes and
state shard, bit for bit, against the unsharded call on each rank's
block of channels, concatenated in rank order: K1's slab count follows
the channel count, so a 192-channel call sums in another order than
four 48-channel ones, and the loops, driven by noise here, carry that
last-bit difference into tens of units within a few hundred epochs.  The
Doppler search's cells exactly and its peak and noise floor at rtol 1e-5
against the call over the whole grid; the overlap-save grid within 2e-4
of its largest value and at the injected delay and Doppler.  Rank 0
prints the card's name and power limit, each step's host
seconds on the S ranks (the ranks start together at a barrier; the
medians of REPEATS warm calls) beside the unsharded call's on one card,
and the collectives.  Exits 1 on a mismatch.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REPEATS = 5
FS = 2_000_000.0
N = 2000                     # one GPS L1 C/A period at FS
# (channels, epochs, blocks, epochs a block, PRNs, Doppler bins, periods)
FULL = (192, 50, 50, 20, 32, 40, 128)
SMALL = (16, 3, 2, 4, 4, 24, 8)
ACQ_DELAY, ACQ_DOPPLER = 333, 2100.0
OS_PRN, OS_DELAY, OS_DOPPLER = 7, 777, 1500.0


def inputs(size, seed: int = 99) -> dict:
    """The host inputs every rank builds alike."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import prn_codes
    c, n_ep, n_blk, e_blk, n_prn, n_bins, periods = size
    rng = np.random.default_rng(seed)
    conf = trk.TrackingConf(fs=FS)
    s0 = conf.nominal_epoch_samples

    def noise(n):
        return torch.from_numpy((rng.standard_normal(n) + 1j
                                 * rng.standard_normal(n)).astype(
                                     np.complex64))
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        prn_codes.gps_l1_ca_code((i % 32) + 1), FS, conf.code_rate_cps, s0,
        8) for i in range(c)])
    state = trk._init_state(c, "cpu")._replace(
        active=torch.ones(c, dtype=torch.bool),
        carrier_doppler=torch.linspace(-4500.0, 4500.0, c))
    code1 = prn_codes.sample_code(prn_codes.gps_l1_ca_code(1), FS,
                                  conf.code_rate_cps, N)
    t = np.arange(2 * N) / FS
    sig = np.roll(np.tile(code1, 2), ACQ_DELAY) * np.exp(
        2j * np.pi * ACQ_DOPPLER * t)
    acq_x = (0.5 * sig + 0.3 * (rng.standard_normal(2 * N) + 1j
                                * rng.standard_normal(2 * N)))
    n_os = periods * N
    code7 = prn_codes.sample_code(prn_codes.gps_l1_ca_code(OS_PRN), FS,
                                  conf.code_rate_cps, N)
    t = np.arange(n_os) / FS
    sig = np.roll(np.tile(code7, periods + 1)[:n_os], OS_DELAY)
    os_x = (0.4 * sig * np.exp(2j * np.pi * OS_DOPPLER * t) + 0.5 * (
        rng.standard_normal(n_os) + 1j * rng.standard_normal(n_os)))
    return dict(
        conf=conf, n_ep=n_ep, n_blk=n_blk, e_blk=e_blk, state=state,
        codes=torch.from_numpy(tables),
        codes_rep=tb.code_spectra(conf, tables, "cpu"),
        taps=torch.tensor([0.25, 0.0, -0.25]),
        x_epoch=noise((n_ep + 1) * s0 + conf.block_size),
        x_block=noise((n_blk * e_blk + 2 * e_blk + 4) * s0
                      + tb.block_fft_size(conf)),
        acq_x=torch.from_numpy(acq_x.astype(np.complex64).reshape(2, N)),
        acq_cfc=torch.from_numpy(code_replicas(
            AcqConf(fs_in=FS, max_dwells=2), range(1, n_prn + 1))),
        dops=(torch.arange(n_bins, dtype=torch.float32) - n_bins // 2)
        * 250.0,
        os_x=torch.from_numpy(os_x.astype(np.complex64)),
        os_code=torch.from_numpy(np.asarray(code7, np.float32)))


def fail(msg: str):
    print(f"probe_multichip: FAILED: {msg}", flush=True)
    sys.exit(1)


def close(what, got, want, rtol: float, atol: float = 0.0) -> None:
    """`got` within rtol * |want| + atol of `want` element by element
    (exactly for integers and bools)."""
    import torch
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not (want.is_floating_point() or want.is_complex()):
        if not torch.equal(got, want):
            fail(f"{what}: differs")
        return
    if not torch.all((got - want).abs() <= rtol * want.abs() + atol):
        fail(f"{what}: off by {float((got - want).abs().max()):.3e}")


def blockwise(call, mesh, *whole):
    """The unsharded `call` on each rank's block of the `whole` arguments'
    channels, in rank order: (each block's new state, the planes
    concatenated along the channel axis)."""
    import torch
    from gnss_sim_receiver_tpu_torch.parallel.mesh import (ChannelMesh,
                                                           shard_channel_axis)
    runs = [call(*shard_channel_axis(whole, ChannelMesh(
        mesh.group, r, mesh.world, mesh.device))) for r in range(mesh.world)]
    return ([st for st, _ in runs],
            {k: torch.cat([o[k] for _, o in runs], dim=1) for k in runs[0][1]})


def hold_tracking(what, mesh, got, want) -> None:
    """The gathered planes, and this rank's state against its block's,
    bit for bit."""
    from gnss_sim_receiver_tpu_torch import interop
    (g_st, g_out), (w_states, w_out) = got, want
    for k in w_out:
        close(f"{what} {k}", g_out[k], w_out[k], 0.0)
    g = interop.track_state_to_numpy(g_st)
    w = interop.track_state_to_numpy(w_states[mesh.rank])
    bad = [k for k in w if g[k].tobytes() != w[k].tobytes()]
    if bad:
        fail(f"{what} state {bad} differ from the block's unsharded call")


def timed(run, mesh, dev) -> float:
    """Host seconds of `run()`, every rank starting at a barrier and the
    card synchronised."""
    import torch
    import torch.distributed as dist
    dist.barrier(group=mesh.group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.parallel import (replicate,
                                                      shard_channel_axis)
    from gnss_sim_receiver_tpu_torch.parallel import shard_steps as ss
    mesh = ss.make_multihost_mesh(device=args.device)
    dev = mesh.device
    lead = mesh.rank == 0
    if lead and dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())
    if lead:
        print(f"{mesh.world} ranks, backend {mesh.backend}, torch "
              f"{torch.__version__}", flush=True)
    inp = inputs(SMALL if args.small else FULL)
    conf, taps = inp["conf"], replicate(inp["taps"], mesh)
    whole = replicate({k: inp[k] for k in ("codes", "codes_rep", "state",
                                           "dops", "os_x")}, mesh)
    codes, rep, st, dops_l, os_l = shard_channel_axis(
        (inp["codes"], inp["codes_rep"], inp["state"], inp["dops"],
         inp["os_x"]), mesh)
    xe, xb, acq_x, cfc, os_code = replicate(
        (inp["x_epoch"], inp["x_block"], inp["acq_x"], inp["acq_cfc"],
         inp["os_code"]), mesh)
    n_ep, n_blk, e_blk = inp["n_ep"], inp["n_blk"], inp["e_blk"]
    c = inp["codes"].shape[0]
    def epoch_call(cd, s):
        return trk.track_chunk(conf, n_ep, cd, taps, xe, s)

    def block_call(cd, s):
        return tb.track_chunk_blocks(conf, n_blk, e_blk, cd, taps, xb, s)
    # (name, the sharded step, the unsharded call timed beside it, the
    # reference, how the step is held to it)
    steps = (
        ("per-epoch tracking",
         lambda: ss.tracking_step_sharded(mesh, conf, n_ep, codes, taps, xe,
                                          st),
         lambda: epoch_call(whole["codes"], whole["state"]),
         lambda: blockwise(epoch_call, mesh, whole["codes"], whole["state"]),
         lambda g, w: hold_tracking("per-epoch", mesh, g, w)),
        ("block tracking",
         lambda: ss.tracking_block_step_sharded(mesh, conf, n_blk, e_blk,
                                                rep, taps, xb, st),
         lambda: block_call(whole["codes_rep"], whole["state"]),
         lambda: blockwise(block_call, mesh, whole["codes_rep"],
                           whole["state"]),
         lambda g, w: hold_tracking("block", mesh, g, w)),
        ("Doppler-sharded acquisition",
         lambda: ss.acquisition_doppler_sharded(mesh, acq_x, cfc, dops_l,
                                                FS),
         lambda: ss.acquisition_doppler(acq_x, cfc, whole["dops"], FS),
         lambda: ss.acquisition_doppler(acq_x, cfc, whole["dops"], FS),
         lambda g, w: [close(f"acquisition {k}", a, b, r) for k, a, b, r in
                       zip(("peak", "doppler", "delay", "noise"), g, w,
                           (1e-5, 0.0, 0.0, 1e-5))]),
        ("time-sharded acquisition",
         lambda: ss.overlap_save_acq_grid(mesh, os_l, os_code,
                                          whole["dops"], FS),
         lambda: ss.overlap_save_grid(whole["os_x"], os_code, whole["dops"],
                                      FS),
         lambda: ss.overlap_save_grid(whole["os_x"], os_code, whole["dops"],
                                      FS),
         lambda g, w: close("overlap-save grid", g, w, 0.0,
                            2e-4 * float(w.abs().max()))))
    for name, sharded, unsharded, reference, hold in steps:
        for k in ss.collectives:
            ss.collectives[k] = 0
        cold = timed(sharded, mesh, dev)
        calls = dict(ss.collectives)
        got = sharded()
        hold(got, reference())
        warm = float(np.median([timed(sharded, mesh, dev)
                                for _ in range(REPEATS)]))
        one = float(np.median([timed(unsharded, mesh, dev)
                               for _ in range(REPEATS)]))
        if lead:
            print(f"  {name}: {mesh.world} ranks {warm:.4f} s warm ({cold:.4f}"
                  f" cold), the unsharded call on one card {one:.4f} s "
                  f"(host, medians of {REPEATS}); collectives {calls}; "
                  "held to the unsharded calls", flush=True)
    peak, dop, delay, _ = ss.acquisition_doppler_sharded(mesh, acq_x, cfc,
                                                         dops_l, FS)
    if int(delay[0]) != ACQ_DELAY or abs(float(dop[0]) - ACQ_DOPPLER) > 250:
        fail("the Doppler-sharded search missed PRN 1")
    grid = ss.overlap_save_acq_grid(mesh, os_l, os_code, whole["dops"], FS)
    di, li = divmod(int(torch.argmax(grid)), N)
    if float(whole["dops"][di]) != OS_DOPPLER or li != OS_DELAY:
        fail("the overlap-save grid does not peak at the injected cell")
    if lead:
        print(f"ok: {c} channels over {mesh.world} ranks", flush=True)
    dist.barrier(group=mesh.group)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
