"""Every epoch's planes (the full transfer, collect_track_outputs) and the
.mat dumps of the port against the JAX package on the CPU.

- pack_full against JAX's track_chunk_packed on the same outputs and
  state (JAX's packing fed the port's chunk): the int32 buffers equal,
  byte for byte, with full_outputs on and off.
- The engines' full handle (process, full_outputs on): the same keys,
  shapes and dtypes, the lean set without it; the planes within
  tests/test_torch_tracking.py's per-epoch bounds (an epoch end one
  sample apart in under 2 % of the epochs, prompts within 2 % of the
  mean prompt, median 0.2 %, Doppler within 0.2 Hz).
- A receiver run with collect_track_outputs=True in both packages on the
  first 2 s of tests/fixtures.py's static capture: track_outputs' keys,
  shapes and validity equal, the sample counters and the float planes
  within the bounds below.
- The dumps: the .mat files each package writes from the same outputs load
  to equal arrays; tests/test_pvt_extras.py's two round trips on the port's
  models/dumps.py.

Tolerances of the receiver run: its channels start on the same
acquisition results and run the same chunks, and lose lock at the same
epochs (PRN 1 does, in both: the per-epoch third-order loops on this
capture); the loops carry the correlations' rounding as in
tests/test_torch_tracking.py: an epoch end one sample apart where an
epoch length rounds the other way, in under 0.5 % of the valid entries
(measured 7 of 5,250, each taken back by the next epoch). On the
channels that keep lock: prompts within 5 % of the mean prompt, median
0.5 % (measured 1.8 %, 0.16 %), the code boundary (sample counter less
code phase) within 0.05 sample, Doppler within 1 Hz (measured 0.48), C/N0
within 0.5 dB (0.21), the code rate within 0.25 chip/s (0.0625, one
float32 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import dumps as jdumps
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import dumps
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from tests.fixtures import static_scenario_capture
from tests.test_torch_block_step import _jax_state
from tests.test_torch_tracking import _clean_scenario

T = 40
FULL_KEYS = ("prompt", "valid", "carrier_doppler_hz", "acc_phase_cycles",
             "code_phase_samples", "cn0_db_hz", "early_mag", "late_mag",
             "code_freq_cps", "rem_code_phase_chips", "pos_start",
             "n_samples", "sample_counter", "stale_channels")
LEAN_ONLY = ("early_mag", "late_mag", "code_freq_cps",
             "rem_code_phase_chips")


@pytest.fixture(scope="module")
def clean():
    return _clean_scenario()


@pytest.mark.parametrize("full", [True, False])
def test_pack_full_matches_jax_packing(clean, full, monkeypatch):
    c = clean
    sp, op = ptrk.track_chunk(c["pconf"], T, torch.from_numpy(c["tables"]),
                              torch.from_numpy(c["taps"]),
                              torch.from_numpy(c["x"]), c["pst"])
    got = ptrk.pack_full(op, sp, full)
    outs = {k: jnp.asarray(v.numpy()) for k, v in op.items()}
    new_state = _jax_state(interop.track_state_to_numpy(sp))
    monkeypatch.setattr(jtrk, "track_chunk", lambda *a: (new_state, outs))
    with jax.disable_jit():
        _, want = jtrk.track_chunk_packed(
            c["jconf"], T, jnp.asarray(c["tables"]), jnp.asarray(c["taps"]),
            jnp.asarray(c["x"]), c["jst"], full_outputs=full)
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numel() == (11 if full else 6) * T * 3 + 2 * T * 3 + 3 * 3


def test_engine_full_handle_matches_jax(clean):
    """process() of both engines from the clean scenario's armed channels:
    every epoch's planes, the full set by default (JAX's default), the
    lean set with full_outputs off; the sample counter is pos_start +
    the window's start + n_samples."""
    c = clean
    got = {}
    for pkg, trk, kw in (("jax", jtrk, {}), ("port", ptrk, {"device": "cpu"})):
        for full in (True, False):
            eng = trk.TrackingEngine(c[pkg[0] + "conf"], [5, 13, 27], **kw)
            assert eng.full_outputs
            for ch, (d, n) in enumerate(zip([-2400.0, 0.0, 3100.0],
                                            [587, 980, 1520])):
                eng.start_tracking(ch, d, n)
            eng.full_outputs = full
            got[pkg, full] = {k: np.asarray(v) for k, v in
                              eng.process(c["x"], 0, T).items()}
    for full in (True, False):
        oj, op = got["jax", full], got["port", full]
        keys = set(FULL_KEYS) - (set() if full else set(LEAN_ONLY))
        assert set(oj) == set(op) == keys
        for k in oj:
            assert oj[k].shape == op[k].shape and oj[k].dtype == op[k].dtype, k
        # tests/test_torch_tracking.py's per-epoch bounds
        d = np.abs(op["sample_counter"] - oj["sample_counter"])
        assert d.max() <= 1 and np.mean(d > 0) < 0.02
        rel = np.abs(op["prompt"] - oj["prompt"]) / np.abs(oj["prompt"]).mean()
        assert rel.max() < 0.02 and np.median(rel) < 0.002
        assert np.abs(op["carrier_doppler_hz"]
                      - oj["carrier_doppler_hz"]).max() < 0.2
        assert np.array_equal(op["valid"], oj["valid"])
        assert np.array_equal(op["sample_counter"],
                              op["pos_start"] + op["n_samples"])
    assert not got["port", False]["prompt"].imag.any()
    for k in ("prompt", "carrier_doppler_hz", "sample_counter"):
        assert np.array_equal(got["port", True][k].real,
                              got["port", False][k].real), k


def test_receiver_collect_track_outputs_matches_jax():
    x, _ = static_scenario_capture()
    x = np.ascontiguousarray(x[: int(2e6 * 2.0)])
    kw = dict(fs=2e6, prns=(1, 3, 4), max_channels=3)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = prx.Receiver(prx.ReceiverConf(**kw), device="cpu"
                            ).process_array(x, collect_track_outputs=True)
    finally:
        torch.set_num_threads(threads)
    ref = jrx.Receiver(jrx.ReceiverConf(**kw)).process_array(
        x, collect_track_outputs=True)
    oj, op = ref.track_outputs, port.track_outputs
    assert op is not None and sorted(op) == sorted(oj)
    assert len(op) == 13 and "stale_channels" not in op
    for k in op:
        assert op[k].shape == oj[k].shape and op[k].dtype == oj[k].dtype, k
    v = op["valid"]
    assert v.sum() > 1000 and np.array_equal(v, oj["valid"])
    # an epoch length rounded the other way moves an epoch end by one
    # sample, and the next epoch takes it back
    for k in ("sample_counter", "pos_start"):
        d = np.abs(op[k] - oj[k])[v]
        assert d.max() <= 1 and np.mean(d > 0) < 0.005, (k, d.max(),
                                                          np.mean(d > 0))
    # the float planes of the channels that kept lock in both packages (a
    # channel that loses lock follows the noise, and the two runs part)
    lost = {c for c, ev in ref.events if ev.name == "TRK_LOST"}
    assert lost == {c for c, ev in port.events if ev.name == "TRK_LOST"}
    keep = [c for c in range(3) if c not in lost]
    assert len(keep) >= 2
    v = v[:, keep]
    op = {k: op[k][:, keep] for k in op}
    oj = {k: oj[k][:, keep] for k in oj}
    rel = np.abs(op["prompt"] - oj["prompt"])[v] / np.abs(oj["prompt"][v]).mean()
    assert rel.max() < 0.05 and np.median(rel) < 0.005, (rel.max(),
                                                        np.median(rel))
    boundary = [(o["sample_counter"] - o["code_phase_samples"].astype(
        np.float64))[v] for o in (op, oj)]
    assert np.abs(boundary[0] - boundary[1]).max() < 0.05
    for k, tol in (("carrier_doppler_hz", 1.0), ("cn0_db_hz", 0.5),
                   ("code_freq_cps", 0.25)):
        d = np.abs(op[k] - oj[k])[v]
        assert d.max() < tol, (k, d.max())


def _outs(rng, t=50, c=2):
    return {
        "prompt": (rng.standard_normal((t, c)) + 1j * rng.standard_normal(
            (t, c))).astype(np.complex64),
        "early_mag": np.abs(rng.standard_normal((t, c))).astype(np.float32),
        "late_mag": np.abs(rng.standard_normal((t, c))).astype(np.float32),
        "sample_counter": np.arange(t * c).reshape(t, c),
        "acc_phase_cycles": rng.standard_normal((t, c)),
        "carrier_doppler_hz": rng.standard_normal((t, c)),
        "code_freq_cps": np.full((t, c), 1.023e6),
        "code_phase_samples": rng.standard_normal((t, c)),
        "cn0_db_hz": np.full((t, c), 44.0),
    }


def _epochs(mod, n=4):
    return [mod.ObservationEpoch(
        rx_time_s=100.0 + 0.02 * i, tick_sample=i,
        valid=np.array([True, False]),
        pseudorange_m=np.array([2.1e7, 0.0]),
        interp_tow_ms=np.array([1e8, 0.0]),
        carrier_doppler_hz=np.array([100.0, 0.0]),
        carrier_phase_cycles=np.array([5.0, 0.0]),
        cn0_db_hz=np.array([45.0, 0.0])) for i in range(n)]


def test_dumps_match_jax(tmp_path):
    """The same outputs, grid and observable epochs through both packages'
    dump writers: the files load to the same variables, equal."""
    from gnss_sim_receiver_tpu.models import observables as jobs
    from gnss_sim_receiver_tpu_torch.models import observables as pobs
    outs = _outs(np.random.default_rng(3))
    grid = np.random.default_rng(4).random((41, 2000)).astype(np.float32)
    acq = (grid, 5000.0, 250.0, 3.1, 2.5, 512.0, 1250.0, 7, 2)
    pairs = []
    for mod, obs, tag in ((jdumps, jobs, "j"), (dumps, pobs, "p")):
        mod.dump_tracking_mat(tmp_path / f"trk_{tag}.mat", outs, channel=1)
        mod.dump_acquisition_mat(tmp_path / f"acq_{tag}.mat", *acq)
        mod.dump_observables_mat(tmp_path / f"obs_{tag}.mat", _epochs(obs),
                                 n_channels=2)
    for name in ("trk", "acq", "obs"):
        mj = jdumps.load_mat(tmp_path / f"{name}_j.mat")
        mp = dumps.load_mat(tmp_path / f"{name}_p.mat")
        keys = [k for k in mj if not k.startswith("__")]
        assert keys == [k for k in mp if not k.startswith("__")]
        for k in keys:
            assert mj[k].dtype == mp[k].dtype and np.array_equal(mj[k],
                                                                 mp[k]), k
        pairs.append(len(keys))
    assert pairs == [11, 9, 6]


def test_tracking_mat_dump_roundtrip(tmp_path):
    """tests/test_pvt_extras.py:test_tracking_mat_dump_roundtrip on the
    port's dumps."""
    outs = _outs(np.random.default_rng(5))
    dumps.dump_tracking_mat(tmp_path / "trk.mat", outs, channel=1)
    m = dumps.load_mat(tmp_path / "trk.mat")
    np.testing.assert_allclose(m["Prompt_I"].ravel(),
                               outs["prompt"][:, 1].real, rtol=1e-6)
    assert "CN0_SNV_dB_Hz" in m and "abs_E" in m


def test_observables_mat_dump(tmp_path):
    """tests/test_pvt_extras.py:test_observables_mat_dump on the port's
    dumps and ObservationEpoch."""
    from gnss_sim_receiver_tpu_torch.models import observables as pobs
    dumps.dump_observables_mat(tmp_path / "obs.mat", _epochs(pobs),
                               n_channels=2)
    m = dumps.load_mat(tmp_path / "obs.mat")
    assert m["Pseudorange_m"].shape == (2, 4)
    assert m["valid_pseudoranges"][0].all()
    assert not m["valid_pseudoranges"][1].any()
