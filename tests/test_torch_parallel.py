"""The port's sharded steps (``parallel/``, kernel K7) against the JAX
package's ``shard_map`` steps on the CPU.

One group of 4 gloo ranks, started once for the file, runs the four
sharded steps through the plain versions of the kernels: each rank is a
process that imports only the port, joins the group from torchrun-style
variables (its first mesh through ``make_multihost_mesh``, as
tests/test_multihost.py joins two JAX processes), takes its block of every
sharded argument with ``shard_channel_axis`` and writes what it returns to
an ``.npz``.  The parent holds each step against the JAX step on
``make_mesh(4)`` (4 of the 8 virtual CPU devices) and against the port's
unsharded call (whose batch of 16 channels rounds a few sums otherwise
than 4 ranks' batches of 4), on tests/test_shard_map.py's inputs (16
channels, 40 Doppler bins, 4 x 2 x 2000 samples) with its tolerances: rtol 1e-4 / atol
1e-2 on the output planes, rtol 1e-5 on Doppler and code frequency,
delays exactly, the overlap-save grid at rtol 2e-4 / atol 1e-2.  Per-channel
Doppler ramps make a channel put in the wrong place by the gather show.

In-process cases: ``shard_channel_axis`` / ``replicate`` on a TrackState,
the divisibility error, and a world of one rank, bit for bit the
unsharded call (every collective a copy).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.parallel import make_mesh as jmake_mesh
from gnss_sim_receiver_tpu.parallel import \
    shard_channel_axis as jshard_channel_axis
from gnss_sim_receiver_tpu.parallel import shard_steps as jss
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.parallel import mesh as pmesh
from gnss_sim_receiver_tpu_torch.parallel import shard_steps as pss
from tests.test_torch_tracking import _compare_outputs

REPO = Path(__file__).resolve().parents[1]
FS = 2_000_000.0
RANKS = 4
N_EPOCHS = 3
N_BLOCKS, E_BLOCK = 2, 4
MH_EPOCHS = 4
TIMEOUT_S = 120

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import tracking as trk
from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e1b_chain
from gnss_sim_receiver_tpu_torch.parallel import (make_mesh, replicate,
                                                  shard_channel_axis)
from gnss_sim_receiver_tpu_torch.parallel import shard_steps as ss

inp = dict(np.load(sys.argv[1]))
fs = float(inp["fs"])
mh = ss.make_multihost_mesh(device="cpu")      # joins the group first
mesh = make_mesh(device="cpu")
assert (mesh.world, mesh.rank, mesh.backend) == (mh.world, mh.rank, "gloo")


def t(name):
    return torch.from_numpy(inp[name])


def state(prefix):
    return interop.track_state_from_numpy(
        {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)},
        "cpu")


def save(res, prefix, new_state, outs):
    res.update({f"{prefix}.out.{k}": v.numpy() for k, v in outs.items()})
    res.update({f"{prefix}.state.{k}": v for k, v in
                interop.track_state_to_numpy(new_state).items()})


res = {}
taps = replicate(t("taps"), mesh)
conf = trk.TrackingConf(fs=fs)
save(res, "trk", *ss.tracking_step_sharded(
    mesh, conf, int(inp["n_epochs"]), shard_channel_axis(t("trk_codes"), mesh),
    taps, replicate(t("trk_x"), mesh), shard_channel_axis(state("trk_st."),
                                                          mesh)))
save(res, "blk", *ss.tracking_block_step_sharded(
    mesh, conf, int(inp["n_blocks"]), int(inp["e_block"]),
    shard_channel_axis(t("blk_rep"), mesh), taps,
    replicate(t("blk_x"), mesh), shard_channel_axis(state("blk_st."), mesh)))
pconf = galileo_e1b_chain(float(inp["pil_fs"]), track_pilot=True).trk
save(res, "pil", *ss.tracking_block_step_sharded(
    mesh, pconf, int(inp["pil_blocks"]), int(inp["pil_e"]),
    shard_channel_axis(t("pil_rep"), mesh), replicate(t("pil_taps"), mesh),
    replicate(t("pil_x"), mesh), shard_channel_axis(state("pil_st."), mesh),
    sec_code=replicate(t("pil_sec"), mesh),
    data_codes_rep=shard_channel_axis(t("pil_data"), mesh)))
save(res, "mh", *ss.tracking_step_sharded(
    mh, trk.TrackingConf(fs=fs, enable_fll_pullin=False),
    int(inp["mh_epochs"]), shard_channel_axis(t("mh_codes"), mh), taps,
    replicate(t("mh_x"), mh), shard_channel_axis(state("mh_st."), mh)))
acq = ss.acquisition_doppler_sharded(
    mesh, t("acq_x"), t("acq_cfc"), shard_channel_axis(t("acq_dops"), mesh),
    fs)
for k, v in zip(("peak", "doppler_hz", "delay_idx", "noise"), acq):
    res[f"acq.{k}"] = v.numpy()
res["os.grid"] = ss.overlap_save_acq_grid(
    mesh, shard_channel_axis(t("os_x"), mesh), t("os_code"), t("os_dops"),
    fs).numpy()
for k, v in ss.collectives.items():
    res[f"collectives.{k}"] = np.asarray(v)
np.savez(sys.argv[2], **res)
"""


PILOT_FS = 4_000_000.0
PILOT_E = 5
PILOT_BLOCKS = 6


def _pilot_chain():
    from gnss_sim_receiver_tpu.models import receiver as jrx
    return jrx.galileo_e1b_chain(PILOT_FS, track_pilot=True)


def _pilot_conf():
    return _pilot_chain().trk


def _pilot_signal(conf):
    """PRNs 11-14 with both E1 components (E1-C carrying the CS25) at 48
    dB-Hz with noise, PILOT_BLOCKS blocks long, and the state armed on
    truth: the channels sync their secondary code inside the step."""
    from gnss_sim_receiver_tpu import signals as jsig
    from gnss_sim_receiver_tpu.sim import (SatelliteSignalParams,
                                           generate_baseband)
    rng = np.random.default_rng(13)
    s0 = conf.nominal_epoch_samples
    dops, delays = [-2000.0, -700.0, 600.0, 1900.0], [1234, 5021, 9876, 14001]
    cs25 = jsig.e1c_secondary_code().astype(np.int8)
    sats = []
    for p, dop, n in zip(range(11, 15), dops, delays):
        kw = dict(prn=p, system="Galileo", cn0_db_hz=45.0, doppler_hz=dop,
                  delay_chips=n * 1.023e6 / PILOT_FS)
        sats += [SatelliteSignalParams(signal="1B", nav_bits=np.where(
                     rng.random(60) < 0.5, 1, -1).astype(np.int8), **kw),
                 SatelliteSignalParams(signal="1P", nav_bits=np.tile(cs25, 3),
                                       **kw)]
    n = max(delays) + (PILOT_BLOCKS * PILOT_E + 3) * s0 \
        + jtb.block_fft_size(conf)
    x = generate_baseband(sats, PILOT_FS, n, noise=False)
    x = (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         * np.float32(0.3 * np.abs(x).std())).astype(np.complex64)
    st = jtrk._init_state(4)
    for ch, dop in enumerate(dops):
        st = jtrk._arm_channel(st, ch, dop, conf.code_rate_cps
                               * (1.0 + dop / conf.carrier_freq_hz))
    pos = np.asarray(delays, np.int64)
    return x, st._replace(
        pos=jnp.asarray(pos.astype(np.int32)),
        rem_carr_phase=jnp.asarray(np.mod(
            2.0 * np.pi * np.asarray(dops) * pos / PILOT_FS,
            2.0 * np.pi).astype(np.float32)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _armed_state(n_channels, dop_lo, dop_hi):
    """tests/test_shard_map.py's state: every channel active, a Doppler
    ramp over the channels."""
    st = jtrk._init_state(n_channels)._replace(
        active=jnp.ones(n_channels, bool),
        carrier_doppler=jnp.linspace(dop_lo, dop_hi,
                                     n_channels).astype(jnp.float32))
    return st


def _noise(rng, n):
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _inputs():
    """The inputs of tests/test_shard_map.py (and of test_multihost.py's
    scenario for the multihost mesh)."""
    conf = jtrk.TrackingConf(fs=FS)
    inp = {"fs": np.float64(FS), "n_epochs": N_EPOCHS, "n_blocks": N_BLOCKS,
           "e_block": E_BLOCK, "mh_epochs": MH_EPOCHS,
           "taps": np.array([+0.25, 0.0, -0.25], np.float32)}
    prns = [(i % 32) + 1 for i in range(16)]
    codes = np.asarray(jpc.gps_l1_ca_code_table(prns))
    inp["trk_codes"] = codes
    inp["trk_x"] = _noise(np.random.default_rng(3),
                          conf.nominal_epoch_samples * (N_EPOCHS + 1)
                          + conf.block_size)
    inp["blk_rep"] = np.asarray(jtb.code_spectra(conf, codes))
    inp["blk_x"] = _noise(np.random.default_rng(9),
                          conf.nominal_epoch_samples
                          * (N_BLOCKS * E_BLOCK + 2)
                          + jtb.block_fft_size(conf))
    # the pilot form of the block step: the Galileo E1 pilot chain at 4
    # Msps, 4 channels (one a rank), the E1-C and E1-B tables of PRNs 11-14
    pconf = _pilot_conf()
    ptables = [np.stack([jpc.bandlimited_table_normalized(
        np.asarray(prov(p), np.float32), PILOT_FS, pconf.code_rate_cps,
        pconf.nominal_epoch_samples, 8) for p in range(11, 15)])
        for prov in (_pilot_chain().code_provider,
                     _pilot_chain().data_code_provider)]
    inp["pil_fs"] = np.float64(PILOT_FS)
    inp["pil_e"] = PILOT_E
    inp["pil_blocks"] = PILOT_BLOCKS
    inp["pil_rep"] = np.asarray(jtb.code_spectra(pconf, ptables[0]))
    inp["pil_data"] = np.asarray(jtb.code_spectra(pconf, ptables[1]))
    inp["pil_sec"] = (2.0 * np.asarray(pconf.secondary_code, np.float32)
                      - 1.0)
    d, dv = (pconf.early_late_space_chips,
             pconf.very_early_late_space_chips)
    inp["pil_taps"] = np.array([dv, d / 2, 0.0, -d / 2, -dv], np.float32)
    inp["pil_x"], pil_st = _pilot_signal(pconf)
    states = {"trk_st.": _armed_state(16, -3000, 3000),
              "blk_st.": _armed_state(16, -3000, 3000),
              "pil_st.": pil_st,
              "mh_st.": _armed_state(8, -4000, 4000)}
    for prefix, st in states.items():
        inp.update({prefix + k: v for k, v in
                    interop.track_state_to_numpy(st).items()})
    inp["mh_codes"] = np.asarray(jpc.gps_l1_ca_code_table(range(1, 9)))
    inp["mh_x"] = _noise(np.random.default_rng(0), 16384)
    # acquisition: tests/test_shard_map.py:_acq_setup
    fft = 2000
    sampled = np.stack([jpc.sample_code(jpc.gps_l1_ca_code(p), FS, 1.023e6,
                                        fft) for p in range(1, 5)])
    inp["acq_cfc"] = np.conj(np.fft.fft(sampled, axis=-1)).astype(
        np.complex64)
    rng = np.random.default_rng(5)
    code = np.tile(sampled[0], 4)
    t = np.arange(2 * fft) / FS
    sig = np.roll(code[:2 * fft], 333) * np.exp(2j * np.pi * 2100.0 * t)
    inp["acq_x"] = (0.5 * sig.reshape(2, fft) + 0.3 * (
        rng.standard_normal((2, fft))
        + 1j * rng.standard_normal((2, fft)))).astype(np.complex64)
    inp["acq_dops"] = (np.arange(40, dtype=np.float32) - 20) * 250.0
    # overlap-save: 2 code periods per rank
    total = RANKS * 2 * fft
    code7 = jpc.sample_code(jpc.gps_l1_ca_code(7), FS, 1.023e6, fft)
    rng = np.random.default_rng(9)
    t = np.arange(total) / FS
    sig = np.roll(np.tile(code7, RANKS * 2 + 1)[:total], 777)
    inp["os_x"] = (0.4 * sig * np.exp(2j * np.pi * 1500.0 * t)
                   + 0.5 * (rng.standard_normal(total) + 1j
                            * rng.standard_normal(total))).astype(np.complex64)
    inp["os_code"] = np.asarray(code7, np.float32)
    inp["os_dops"] = np.array([-1500.0, 0.0, 1500.0, 3000.0], np.float32)
    return inp, states


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 gloo ranks' results, one dict per rank, and the inputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    inp, states = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    procs = []
    for rank in range(RANKS):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(rank), WORLD_SIZE=str(RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp / "inputs.npz"),
             str(tmp / f"rank{rank}.npz"), str(REPO)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-3000:]}"
    res = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return res, inp, states


def _port_state(inp, prefix):
    return interop.track_state_from_numpy(
        {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)},
        "cpu")


def _gathered_state(res, prefix):
    """Every rank's state shard, concatenated in rank order."""
    keys = [k for k in res[0] if k.startswith(prefix + ".state.")]
    return {k[len(prefix) + 7:]: np.concatenate([r[k] for r in res])
            for k in keys}


def _same_on_every_rank(res, prefix):
    for k in res[0]:
        if k.startswith(prefix):
            for r in res[1:]:
                np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


# The block scan's correlator planes pass through two FFT libraries
# (pocketfft in the port, XLA's in JAX): they are held as
# tests/test_torch_tracking.py holds the port's block scan against JAX's,
# |port - JAX| <= 0.2 % of the plane's mean magnitude (measured here: 2.3e-4
# of the plane's largest, at most 3.0e-4 of an element, above the 1e-4 of
# test_shard_map.py, whose two sides share one FFT).  Every other plane, and
# the per-epoch scan's, at test_shard_map.py's rtol 1e-4 / atol 1e-2.
BLOCK_FFT_PLANES = ("prompt", "early_mag", "late_mag")


def _hold_planes(got: dict, want: dict, prefix: str, fft_planes=()):
    assert set(want) <= {k[len(prefix):] for k in got if
                         k.startswith(prefix)}
    for k, v in want.items():
        v = np.asarray(v)
        if k in fft_planes:
            err = np.abs(got[prefix + k] - v).max()
            assert err <= 2e-3 * np.abs(v).mean(), (k, err)
        else:
            np.testing.assert_allclose(got[prefix + k], v, rtol=1e-4,
                                       atol=1e-2, err_msg=k)


def _hold_state(got: dict, want: dict):
    np.testing.assert_allclose(got["carrier_doppler"],
                               np.asarray(want["carrier_doppler"]),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got["code_freq"], np.asarray(want["code_freq"]),
                               rtol=1e-5, atol=1e-3)
    for k in ("active", "pos", "epoch", "lock_lost"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_tracking_step_sharded_matches_jax_and_unsharded(ranks):
    res, inp, states = ranks
    _same_on_every_rank(res, "trk.out.")
    conf = jtrk.TrackingConf(fs=FS)
    jst, jouts = jss.tracking_step_sharded(
        jmake_mesh(RANKS), conf, N_EPOCHS, inp["trk_codes"], inp["taps"],
        inp["trk_x"], jshard_channel_axis(states["trk_st."],
                                          jmake_mesh(RANKS)))
    _hold_planes(res[0], jouts, "trk.out.")
    assert res[0]["trk.out.prompt"].shape == (N_EPOCHS, 16)
    _hold_state(_gathered_state(res, "trk"),
                interop.track_state_to_numpy(jst))
    pst, pouts = ptrk.track_chunk(
        ptrk.TrackingConf(fs=FS), N_EPOCHS, torch.from_numpy(inp["trk_codes"]),
        torch.from_numpy(inp["taps"]), torch.from_numpy(inp["trk_x"]),
        _port_state(inp, "trk_st."))
    _hold_planes(res[0], {k: v.numpy() for k, v in pouts.items()},
                 "trk.out.")
    _hold_state(_gathered_state(res, "trk"),
                interop.track_state_to_numpy(pst))


def test_tracking_block_step_sharded_matches_jax_and_unsharded(ranks):
    res, inp, states = ranks
    _same_on_every_rank(res, "blk.out.")
    conf = jtrk.TrackingConf(fs=FS, enable_fll_pullin=True)
    mesh = jmake_mesh(RANKS)
    jst, jouts = jss.tracking_block_step_sharded(
        mesh, conf, N_BLOCKS, E_BLOCK, inp["blk_rep"], inp["taps"],
        inp["blk_x"], jshard_channel_axis(states["blk_st."], mesh))
    _hold_planes(res[0], jouts, "blk.out.", BLOCK_FFT_PLANES)
    assert res[0]["blk.out.prompt"].shape == (N_BLOCKS * E_BLOCK, 16)
    _hold_state(_gathered_state(res, "blk"),
                interop.track_state_to_numpy(jst))
    pst, pouts = ptb.track_chunk_blocks(
        ptrk.TrackingConf(fs=FS), N_BLOCKS, E_BLOCK,
        torch.from_numpy(inp["blk_rep"]), torch.from_numpy(inp["taps"]),
        torch.from_numpy(inp["blk_x"]), _port_state(inp, "blk_st."))
    _hold_planes(res[0], {k: v.numpy() for k, v in pouts.items()},
                 "blk.out.")
    _hold_state(_gathered_state(res, "blk"),
                interop.track_state_to_numpy(pst))


def test_tracking_block_step_sharded_pilot_matches_jax_and_unsharded(ranks):
    """The pilot form of the sharded block step (a track_pilot chain's:
    the data replica sharded with the code replica, the CS25 whole) on 4
    gloo ranks, 6 blocks in which every channel syncs its secondary code,
    against the JAX step on make_mesh(4) and the port's unsharded call:
    the prompt plane (the data prompt) with the block planes' tolerance,
    the sec_* fields equal."""
    res, inp, states = ranks
    _same_on_every_rank(res, "pil.out.")
    mesh = jmake_mesh(RANKS)
    jst, jouts = jss.tracking_block_step_sharded(
        mesh, _pilot_conf(), PILOT_BLOCKS, PILOT_E, inp["pil_rep"],
        inp["pil_taps"], inp["pil_x"],
        jshard_channel_axis(states["pil_st."], mesh),
        sec_code=jnp.asarray(inp["pil_sec"]),
        data_codes_rep=inp["pil_data"])
    # on planted signals the loops move: a last-bit flip of the float32
    # code rate (0.25 chip/s) between the two FFT libraries' correlations
    # rounds an epoch length the other way now and then, which moves the
    # epoch's end by a sample, its code phase with it, and reads the
    # early and late taps a sample off the triangle (measured: 2 of 120
    # ends, 0.96 sample of code phase, 3.8 % of an early magnitude).  So
    # the planes are held as test_torch_tracking.py holds the scans: the
    # data prompt within 2 % of the mean prompt (median 0.2 %), the ends
    # within a sample, the code boundary the observables read (end minus
    # code phase) within 0.1 sample (a flipped rate walks it up to 0.25
    # chip/s x 120 ms, 0.06 sample; measured 0.037), the Doppler within
    # 0.05 Hz (measured 0.022); the early and late magnitudes within 5 %
    # (median 0.1 %) of the mean; the C/N0, sig / (total - sig) over a
    # block's 5 prompts, which the planted per-epoch SNR (~100) makes ~200
    # times as sensitive as the prompts, within 0.5 dB (measured 0.18);
    # the other planes as the block step's
    got = {k: torch.from_numpy(res[0]["pil.out." + k]) for k in jouts}
    _compare_outputs(jouts, got, prompt_max=0.02, prompt_med=0.002,
                     pos_tol=1, dop_tol=0.05, boundary_tol=0.1)
    for k in ("early_mag", "late_mag"):
        rel = np.abs(got[k].numpy() - np.asarray(jouts[k])) \
            / np.abs(np.asarray(jouts[k])).mean()
        assert rel.max() < 0.05 and np.median(rel) < 1e-3, k
    assert np.abs(got["cn0_db_hz"].numpy()
                  - np.asarray(jouts["cn0_db_hz"])).max() < 0.5
    _hold_planes(res[0], {k: v for k, v in jouts.items() if k in (
        "acc_phase_cycles", "valid")}, "pil.out.")
    assert res[0]["pil.out.prompt"].shape == (PILOT_BLOCKS * PILOT_E, 4)
    got = _gathered_state(res, "pil")
    assert got["sec_synced"].all(), got["sec_synced"]
    _hold_state(got, interop.track_state_to_numpy(jst))
    for k in ("sec_synced", "sec_off", "sec_polarity", "sec_buf"):
        np.testing.assert_array_equal(
            got[k], interop.track_state_to_numpy(jst)[k], err_msg=k)
    from gnss_sim_receiver_tpu_torch.models import receiver as prx
    pst, pouts = ptb.track_chunk_blocks(
        prx.galileo_e1b_chain(PILOT_FS, track_pilot=True).trk,
        PILOT_BLOCKS, PILOT_E, torch.from_numpy(inp["pil_rep"]),
        torch.from_numpy(inp["pil_taps"]), torch.from_numpy(inp["pil_x"]),
        _port_state(inp, "pil_st."),
        sec_code=torch.from_numpy(inp["pil_sec"]),
        data_codes_rep=torch.from_numpy(inp["pil_data"]))
    _hold_planes(res[0], {k: v.numpy() for k, v in pouts.items()},
                 "pil.out.")
    _hold_state(got, interop.track_state_to_numpy(pst))


def test_multihost_mesh_tracking_matches_single_process(ranks):
    """tests/test_multihost.py's scenario (8 channels, FLL off, 4 epochs)
    through ``make_multihost_mesh`` from torchrun's variables: every rank
    holds the same gathered planes, equal to one process's track_chunk
    (JAX's and the port's, within the planes' tolerance)."""
    res, inp, states = ranks
    _same_on_every_rank(res, "mh.out.")
    assert res[0]["mh.out.prompt"].shape == (MH_EPOCHS, 8)
    conf = jtrk.TrackingConf(fs=FS, enable_fll_pullin=False)
    _, jouts = jtrk.track_chunk(conf, MH_EPOCHS, jnp.asarray(inp["mh_codes"]),
                                jnp.asarray(inp["taps"]),
                                jnp.asarray(inp["mh_x"]), states["mh_st."])
    _hold_planes(res[0], jouts, "mh.out.")
    _, pouts = ptrk.track_chunk(
        ptrk.TrackingConf(fs=FS, enable_fll_pullin=False), MH_EPOCHS,
        torch.from_numpy(inp["mh_codes"]), torch.from_numpy(inp["taps"]),
        torch.from_numpy(inp["mh_x"]), _port_state(inp, "mh_st."))
    _hold_planes(res[0], {k: v.numpy() for k, v in pouts.items()},
                 "mh.out.")


def test_acquisition_doppler_sharded_matches_jax_and_unsharded(ranks):
    res, inp, _ = ranks
    _same_on_every_rank(res, "acq.")
    r = res[0]
    peak, dop_hz, del_i, noise = jss.acquisition_doppler_sharded(
        jmake_mesh(RANKS), inp["acq_x"], inp["acq_cfc"], inp["acq_dops"], FS)
    np.testing.assert_allclose(r["acq.peak"], np.asarray(peak), rtol=1e-5)
    np.testing.assert_array_equal(r["acq.delay_idx"], np.asarray(del_i))
    np.testing.assert_allclose(r["acq.doppler_hz"], np.asarray(dop_hz),
                               rtol=1e-5)
    np.testing.assert_allclose(r["acq.noise"], np.asarray(noise), rtol=1e-5)
    assert r["acq.delay_idx"].dtype == np.int32
    assert int(r["acq.delay_idx"][0]) == 333
    assert abs(float(r["acq.doppler_hz"][0]) - 2100.0) <= 250.0
    # the unsharded call: the same cells, the sums in another order
    un = pss.acquisition_doppler(*(torch.from_numpy(inp[k]) for k in (
        "acq_x", "acq_cfc", "acq_dops")), FS)
    un = dict(zip(("peak", "doppler_hz", "delay_idx", "noise"), un))
    for k in ("doppler_hz", "delay_idx"):
        np.testing.assert_array_equal(r[f"acq.{k}"], un[k].numpy())
    for k in ("peak", "noise"):
        np.testing.assert_allclose(r[f"acq.{k}"], un[k].numpy(), rtol=1e-5,
                                   err_msg=k)
    # the plain grid's first peak, cell for cell
    grid = jpcps.pcps_grid(jnp.asarray(inp["acq_x"]),
                           jnp.asarray(inp["acq_cfc"]),
                           jnp.asarray(inp["acq_dops"]), FS)
    _, ref_dop_i, ref_del_i = jpcps.grid_peak(grid)
    np.testing.assert_array_equal(r["acq.delay_idx"], np.asarray(ref_del_i))
    np.testing.assert_array_equal(r["acq.doppler_hz"],
                                  inp["acq_dops"][np.asarray(ref_dop_i)])


def test_overlap_save_sharded_matches_jax_and_unsharded(ranks):
    res, inp, _ = ranks
    _same_on_every_rank(res, "os.")
    grid = res[0]["os.grid"]
    assert grid.shape == (4, 2000) and grid.dtype == np.float32
    want = jss.overlap_save_acq_grid(jmake_mesh(RANKS), inp["os_x"],
                                     inp["os_code"], inp["os_dops"], FS)
    np.testing.assert_allclose(grid, np.asarray(want), rtol=2e-4, atol=1e-2)
    un = pss.overlap_save_grid(*(torch.from_numpy(inp[k]) for k in (
        "os_x", "os_code", "os_dops")), FS)
    np.testing.assert_allclose(grid, un.numpy(), rtol=2e-4, atol=1e-2)
    di, li = np.unravel_index(np.argmax(grid), grid.shape)
    assert inp["os_dops"][di] == 1500.0 and li == 777
    # one halo exchange, one all-reduce; the Doppler search one gather and
    # one all-reduce; each tracking step one gather per output plane
    c = res[0]
    assert int(c["collectives.p2p"]) == 1
    assert int(c["collectives.all_reduce"]) == 2
    n_planes = sum(1 for k in c if k.startswith(("trk.out.", "blk.out.",
                                                 "pil.out.", "mh.out.")))
    assert int(c["collectives.all_gather"]) == n_planes + 1


# ---- in process -----------------------------------------------------------

def _fake_mesh(rank, world):
    return pmesh.ChannelMesh(None, rank, world, torch.device("cpu"))


def test_shard_channel_axis_and_replicate_on_a_trackstate():
    st = _port_state({f"s.{k}": v for k, v in interop.track_state_to_numpy(
        _armed_state(16, -3000, 3000)).items()}, "s.")
    mesh = _fake_mesh(1, 4)
    sh = pmesh.shard_channel_axis(st, mesh)
    assert type(sh) is type(st) and type(sh.dll) is type(st.dll)
    np.testing.assert_array_equal(sh.carrier_doppler.numpy(),
                                  st.carrier_doppler[4:8].numpy())
    assert sh.kf_p.shape == (4, 4, 4) and sh.bit_hist.shape == (4, 20)
    assert sh.dll.vel.shape == (4,) and sh.cn0_acc.sum_m2.shape == (4,)
    whole = pmesh.shard_channel_axis({"n": torch.tensor(3.0),
                                      "a": np.arange(8)}, mesh)
    assert whole["n"].dim() == 0 and whole["a"].tolist() == [2, 3]
    rep = pmesh.replicate(st, mesh)
    np.testing.assert_array_equal(rep.carrier_doppler.numpy(),
                                  st.carrier_doppler.numpy())
    assert rep.carrier_doppler.device == torch.device("cpu")


def test_shard_channel_axis_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        pmesh.shard_channel_axis(torch.zeros(10), _fake_mesh(0, 4))


def test_block_step_refuses_the_pilot_arguments():
    """The sharded block step takes a pilot chain's arguments now; it
    refuses a data replica that is not this rank's block of the code
    replica's shape, and a secondary code longer than the sign history."""
    rep = torch.zeros(4, 4096)
    with pytest.raises(ValueError, match="data replica"):
        pss.tracking_block_step_sharded(
            _fake_mesh(0, 1), ptrk.TrackingConf(fs=FS), 1, 20, rep,
            torch.zeros(3), torch.zeros(50000, dtype=torch.complex64),
            ptrk._init_state(4, "cpu"), sec_code=torch.ones(25),
            data_codes_rep=torch.zeros(8, 4096))
    with pytest.raises(ValueError, match="secondary code"):
        pss.tracking_block_step_sharded(
            _fake_mesh(0, 1), ptrk.TrackingConf(fs=FS), 1, 20, rep,
            torch.zeros(3), torch.zeros(50000, dtype=torch.complex64),
            ptrk._init_state(4, "cpu"), sec_code=torch.ones(40),
            data_codes_rep=torch.zeros(4, 4096))


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo process group of one rank in this process (a free local
    port), destroyed after the module's tests."""
    import torch.distributed as dist
    for k in pmesh.TORCHRUN_VARS:
        assert k not in os.environ, k
    mesh = pmesh.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_world_of_one_equals_the_unsharded_call(world_of_one):
    mesh = world_of_one
    assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
    with pytest.raises(RuntimeError, match="torchrun"):
        pss.make_multihost_mesh(device="cpu")
    inp, _ = _inputs()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()
         if isinstance(v, np.ndarray) and v.ndim}
    conf = ptrk.TrackingConf(fs=FS)
    before = dict(pss.collectives)
    st, outs = pss.tracking_step_sharded(
        mesh, conf, N_EPOCHS, t["trk_codes"], t["taps"], t["trk_x"],
        _port_state(inp, "trk_st."))
    want_st, want = ptrk.track_chunk(conf, N_EPOCHS, t["trk_codes"],
                                     t["taps"], t["trk_x"],
                                     _port_state(inp, "trk_st."))
    for k in want:
        assert torch.equal(outs[k], want[k]), k
    assert torch.equal(st.carrier_doppler, want_st.carrier_doppler)
    acq = pss.acquisition_doppler_sharded(mesh, t["acq_x"], t["acq_cfc"],
                                          t["acq_dops"], FS)
    want = pss.acquisition_doppler(t["acq_x"], t["acq_cfc"], t["acq_dops"],
                                   FS)
    for a, b in zip(acq, want):
        assert torch.equal(a, b)
    grid = pss.overlap_save_acq_grid(mesh, t["os_x"], t["os_code"],
                                     t["os_dops"], FS)
    assert torch.equal(grid, pss.overlap_save_grid(t["os_x"], t["os_code"],
                                                   t["os_dops"], FS))
    # at one rank the halo is the segment's own head: no send to itself
    assert pss.collectives["p2p"] == before["p2p"]
    assert pss.collectives["all_reduce"] == before["all_reduce"] + 2
    assert (pss.collectives["all_gather"]
            == before["all_gather"] + len(outs) + 1)
