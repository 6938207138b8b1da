"""One block of the block scan from edge states: the JAX program op by op
(jax.disable_jit) against the port's split plain path, the plain versions
of kernels K8a (block prologue) and K8b (block closure) around the
replica FFT and K1's plain version; the chunk's preallocated [T, C]
output planes against the per-block concatenation they replace; the
folded order of the card's two-launch chunk (the next block's prologue
from the state a closure returns) against the plain chunk; the launch
plan the fold's waits rely on; and the block library's build layout.

The edge states are built with a NumPy seed on states armed on truth:
an inactive channel, ext_n at 49 and 50 (the DLL's wide-to-narrow
switch), an epoch one short of the FLL pull-in window's end, lock_fail at
max_lock_fail (on a channel that fails and is lost, and on one that
holds), a bit-sync histogram one transition short of sync, negative
carrier phases into the remainder, a channel whose replica is zero (a
zero prompt, the sign of I at 0), and the two block shapes: E = 20 with
K = 3 (GPS L1 C/A, four-quadrant FLL) and E = 5 with K = 5 (Galileo E1-B,
decision-directed FLL).

Tolerances: the code NCO (pos, rem_code_phase, code_freq) and every
integer and bool field (integer-valued float fields included) bit for
bit; the float fields as test_torch_tracking.py:
test_block_matches_jax_op_by_op holds them: the DLL velocity to 1e-5 of
itself (and 1e-7 chip/s absolute, as there at 20 Msps and in
test_torch_galileo_e1.py for E1), the Doppler and the PLL velocity
within 1e-3 Hz.
"""

import ctypes
import dataclasses
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e1b_chain
from gnss_sim_receiver_tpu_torch.ops import cuda_build

GPS = dict(fs=2_000_000.0, rate=1.023e6, s0=2000, e=20, prns=[5, 13, 27],
           dops=[-2400.0, 650.0, 3100.0], delays=[587, 980, 1520])
E1 = dict(fs=4_000_000.0, rate=2.046e6, s0=16000, e=5, prns=[11, 14],
          dops=[1625.0, -2125.0], delays=[5021, 11790])
START = 7           # epochs into the signal: a GPS bit edge at epoch 13


def _scenario(sig, seed):
    """The satellites of `sig` (plus one channel with a zero replica) at
    48 dB-Hz with noise: GPS with nav bits alternating every 20 ms, E1-B
    with random symbols; the conf its chain tracks with, FLL pull-in on."""
    rng = np.random.default_rng(seed)
    fs, s0 = sig["fs"], sig["s0"]
    if sig is GPS:
        kw = {f.name: getattr(ptrk.TrackingConf(fs=fs), f.name)
              for f in dataclasses.fields(ptrk.TrackingConf)}
        sats = [SatelliteSignalParams(
            prn=p, cn0_db_hz=48.0, doppler_hz=d,
            delay_chips=n * sig["rate"] / fs,
            nav_bits=np.tile(np.array([1, -1], np.int8), 8))
            for p, d, n in zip(sig["prns"], sig["dops"], sig["delays"])]
        codes = [jpc.gps_l1_ca_code(p) for p in sig["prns"]]
        taps = np.array([0.25, 0.0, -0.25], np.float32)
    else:
        trk = galileo_e1b_chain(fs, very_early_late_space_chips=1.2).trk
        kw = {f.name: getattr(trk, f.name) for f in dataclasses.fields(trk)}
        sats = [SatelliteSignalParams(
            prn=p, system="Galileo", signal="1B", cn0_db_hz=48.0,
            doppler_hz=d, delay_chips=n * 1.023e6 / fs,
            nav_bits=np.where(rng.random(40) < 0.5, 1, -1).astype(np.int8))
            for p, d, n in zip(sig["prns"], sig["dops"], sig["delays"])]
        codes = [jsig.subchip_table(jsig.GALILEO_E1B, p) for p in sig["prns"]]
        d, dv = kw["early_late_space_chips"], kw["very_early_late_space_chips"]
        taps = np.array([dv, d / 2, 0.0, -d / 2, -dv], np.float32)
    n = max(sig["delays"]) + (START + 2 * sig["e"] + 4) * s0 + 40000
    x = generate_baseband(sats, fs, n, noise=False)
    x = (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         * np.float32(0.3 * np.abs(x).std())).astype(np.complex64)
    tables = np.stack([jpc.bandlimited_table_normalized(
        c, fs, sig["rate"], s0) for c in codes])
    tables = np.concatenate([tables, np.zeros_like(tables[:1])])
    return dict(x=x, tables=tables, taps=taps, jconf=jtrk.TrackingConf(**kw),
                pconf=ptrk.TrackingConf(**kw))


def _armed(sig, conf):
    """Every channel armed on truth START epochs into the signal (the
    zero-replica channel on the first satellite's), as a flat dict."""
    dops = sig["dops"] + sig["dops"][:1]
    st = jtrk._init_state(len(dops))
    for ch, d in enumerate(dops):
        st = jtrk._arm_channel(st, ch, d, conf.code_rate_cps
                               * (1.0 + d / conf.carrier_freq_hz))
    pos = np.asarray(sig["delays"] + sig["delays"][:1], np.int64) \
        + START * sig["s0"]
    a = {k: np.array(v) for k, v in interop.track_state_to_numpy(st).items()}
    a["pos"] = pos.astype(np.int32)
    a["rem_carr_phase"] = np.mod(2.0 * np.pi * np.asarray(dops) * pos
                                 / conf.fs, 2.0 * np.pi).astype(np.float32)
    return a


def _jax_state(a):
    """The JAX package's TrackState from a flat dict (dotted keys)."""
    fields = {}
    for name, v in jtrk._init_state(len(a["active"]))._asdict().items():
        if isinstance(v, tuple):
            fields[name] = type(v)(*(jnp.asarray(a[f"{name}.{sub}"])
                                     for sub in v._fields))
        else:
            fields[name] = jnp.asarray(a[name])
    return jtrk.TrackState(**fields)


def _edge(name, a, conf, rng):
    """Put the state `a` (flat dict) on case `name`'s edges; returns what
    the block must show that the edges were reached."""
    ep, mlf = conf.fll_pullin_epochs, float(conf.max_lock_fail)
    z = len(a["active"]) - 1                      # the zero-replica channel
    a["rem_carr_phase"][0] = np.float32(-rng.uniform(0.1, 3.0))
    if name == "gps_loops":
        a["ext_n"][:] = [49, 50, 0, 10000]
        a["epoch"][:] = [ep + 40, ep - 1, ep + 400, ep + 400]
        a["active"][2] = False
        a["lock_fail"][z] = mlf
        a["carrier_lock"][z] = 0.5
        return {"lost": z, "inactive": 2}
    if name == "gps_bits":
        a["epoch"][:] = [ep + 40, ep + 40, ep - 1, ep + 40]
        a["bit_hist"][0, rng.integers(0, 20)] = \
            conf.bit_sync_min_transitions - 1
        a["lock_fail"][1] = mlf
        a["prev_sign"][:] = [0.0, -1.0, 1.0, 1.0]
        return {"synced": 0, "holds": 1}
    a["ext_n"][:2] = [49, 50]                     # "e1"
    a["epoch"][:] = [ep - 1, ep + 40, ep + 40]
    a["lock_fail"][z] = mlf
    return {"lost": z}


CASES = {"gps_loops": (GPS, 1), "gps_bits": (GPS, 2), "e1": (E1, 3)}
EXACT = ("pos", "rem_code_phase", "code_freq", "epoch", "ext_n", "active",
         "lock_fail", "lock_lost", "bit_hist", "prev_sign", "bit_synced",
         "bit_phase")


def _port_block(conf, e, codes_rep, taps, x, st):
    """The port's split plain path, one block: K8a's plain version, the
    replica FFT and its conjugate, K1's plain version, K8b's plain
    version."""
    xf_all = ptb._window_spectra(x, conf.nominal_epoch_samples,
                                 ptb.block_fft_size(conf))
    pro = ptb._block_prologue_plain(conf, e, codes_rep, taps,
                                    xf_all.shape[0], st)
    rf = torch.conj_physical(torch.fft.fft(pro.rep_t, dim=-1))
    corr = ptb._block_correlate_plain(xf_all, rf, pro.w0, pro.lag_int,
                                      pro.lag_frac, pro.ph_sc, pro.tap_samps,
                                      pro.omega)
    return ptb._block_closure_plain(conf, e, corr, pro, st)


@pytest.mark.parametrize("case", list(CASES))
def test_block_step_edges_match_jax_op_by_op(case):
    sig, seed = CASES[case]
    rng = np.random.default_rng(seed)
    c = _scenario(sig, seed)
    a = _armed(sig, c["pconf"])
    reached = _edge(case, a, c["pconf"], rng)
    e = sig["e"]
    with jax.disable_jit():
        sj, _ = jtb.track_chunk_blocks(
            c["jconf"], 1, e, jtb.code_spectra(c["jconf"], c["tables"]),
            jnp.asarray(c["taps"]), jnp.asarray(c["x"]), _jax_state(a))
    sp, _ = _port_block(c["pconf"], e,
                        ptb.code_spectra(c["pconf"], c["tables"], "cpu"),
                        torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]),
                        interop.track_state_from_numpy(a, "cpu"))
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in EXACT:
        assert np.array_equal(dj[k], dp[k]), (k, dj[k], dp[k])
    assert np.allclose(dj["dll.vel"], dp["dll.vel"], rtol=1e-5, atol=1e-7)
    for k in ("carrier_doppler", "pll.vel"):
        assert np.abs(dj[k] - dp[k]).max() < 1e-3, k
    # the edges were reached
    if "lost" in reached:
        assert dp["lock_lost"][reached["lost"]]
        assert not dp["active"][reached["lost"]]
    if "inactive" in reached:
        ch = reached["inactive"]
        assert dp["pos"][ch] == a["pos"][ch] + e * sig["s0"]
        assert dp["epoch"][ch] == a["epoch"][ch]
    if "synced" in reached:
        assert dp["bit_synced"][reached["synced"]]
    if "holds" in reached:
        assert dp["lock_fail"][reached["holds"]] == \
            c["pconf"].max_lock_fail - 1
        assert dp["active"][reached["holds"]]


def test_block_planes_equal_per_block_concatenation():
    """track_chunk_blocks writes each block's E rows into [T, C] planes
    allocated once; over 3 blocks they equal the per-block outputs of the
    split plain path concatenated (the form they replace), and the state
    is the same."""
    c = _scenario(GPS, 4)
    a = _armed(GPS, c["pconf"])
    a["active"][2] = False
    conf, e = c["pconf"], GPS["e"]
    codes_rep = ptb.code_spectra(conf, c["tables"], "cpu")
    taps, x = torch.from_numpy(c["taps"]), torch.from_numpy(c["x"])
    st0 = interop.track_state_from_numpy(a, "cpu")
    sp, planes = ptb.track_chunk_blocks(conf, 3, e, codes_rep, taps, x, st0)
    st, outs = st0, []
    for _ in range(3):
        st, o = _port_block(conf, e, codes_rep, taps, x, st)
        outs.append(o)
    assert list(planes) == list(outs[0])
    for k in planes:
        want = torch.cat([o[k] for o in outs])
        assert planes[k].dtype == want.dtype and planes[k].shape == want.shape
        assert torch.equal(planes[k], want), k
    ds, dw = interop.track_state_to_numpy(sp), interop.track_state_to_numpy(st)
    for k in ds:
        assert np.array_equal(ds[k], dw[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_fused_block_step_on_cpu_is_k1_then_k8b(case, monkeypatch):
    """K1 with K8b's closure fused (block_correlate_close, on the replica
    spectrum as the FFT leaves it) takes, on CPU tensors, K1's plain
    version on the conjugated spectrum and then K8b's plain version on its
    output, from each case's edge state: the correlations land in `corr`,
    the closure's rows in the block's rows of the planes (the other rows
    untouched), its state is returned, and no launch counter moves."""
    sig, seed = CASES[case]
    rng = np.random.default_rng(seed)
    c = _scenario(sig, seed)
    a = _armed(sig, c["pconf"])
    _edge(case, a, c["pconf"], rng)
    conf, e = c["pconf"], sig["e"]
    codes_rep = ptb.code_spectra(conf, c["tables"], "cpu")
    taps, x = torch.from_numpy(c["taps"]), torch.from_numpy(c["x"])
    st = interop.track_state_from_numpy(a, "cpu")
    xf_all = ptb._window_spectra(x, conf.nominal_epoch_samples,
                                 ptb.block_fft_size(conf))
    pro = ptb._block_prologue_plain(conf, e, codes_rep, taps,
                                    xf_all.shape[0], st)
    rf = torch.fft.fft(pro.rep_t, dim=-1)
    n_ch = len(a["active"])
    planes = ptb._empty_planes(3 * e, n_ch, "cpu")
    for v in planes.values():
        v.zero_()
    corr = torch.empty((n_ch, e, len(c["taps"])), dtype=torch.complex64)
    seen = {}

    def k1(*args, _f=ptb._block_correlate_plain):
        seen["k1"] = (args, _f(*args))
        return seen["k1"][1]

    def k8b(*args, _f=ptb._block_closure_plain):
        seen["k8b"] = (args, _f(*args))
        return seen["k8b"][1]
    monkeypatch.setattr(ptb, "_block_correlate_plain", k1)
    monkeypatch.setattr(ptb, "_block_closure_plain", k8b)
    counters = (ptb.block_correlate.launches,
                ptb.block_correlate_close.launches,
                ptb.block_closure.launches)
    new = ptb.block_correlate_close(conf, e, xf_all, rf, pro, st, planes, 1,
                                    corr=corr)
    assert counters == (ptb.block_correlate.launches,
                        ptb.block_correlate_close.launches,
                        ptb.block_closure.launches)
    (k1_args, k1_out), (k8b_args, (k8b_st, outs)) = seen["k1"], seen["k8b"]
    assert k1_args[0] is xf_all and torch.equal(k1_args[1],
                                                torch.conj_physical(rf))
    assert all(t is u for t, u in zip(k1_args[2:], (
        pro.w0, pro.lag_int, pro.lag_frac, pro.ph_sc, pro.tap_samps,
        pro.omega)))
    assert torch.equal(corr, k1_out)
    assert k8b_args[:2] == (conf, e) and k8b_args[2] is k1_out
    assert k8b_args[3] is pro and k8b_args[4] is st and new is k8b_st
    for k in outs:
        assert torch.equal(planes[k][e:2 * e], outs[k]), k
        assert not planes[k][:e].any() and not planes[k][2 * e:].any(), k


def _c_struct_fields(src: str, name: str):
    """(type, is_pointer, field) of each member of `struct name { ... };`
    in a CUDA source."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        t, star, field = re.match(r"(?:const )?(\w+)\s*(\**)\s*(\w+)$",
                                  decl).groups()
        fields.append((t, bool(star), field))
    return fields


@pytest.mark.parametrize("name", ["StatePtrs", "ProloguePtrs", "PlanePtrs",
                                  "PrologueArgs", "ClosureArgs"])
def test_launch_structs_match_the_cuda_source(name):
    """K8a's and K8b's launch arguments (K8b's also those of K1's fused
    form) go to the kernels by value as ctypes Structures: field for
    field, the names, order and types of csrc/block_step.cuh's structs (a
    pointer for every pointer, a nested Structure for every struct,
    c_float and c_int for float and int32_t)."""
    src = (Path(ptb.__file__).parents[1] / "csrc" / "block_step.cuh"
           ).read_text()
    want = _c_struct_fields(src, name)
    got = getattr(ptb, f"_{name}")._fields_
    assert [n for n, _ in got] == [n for _, _, n in want]
    scalars = {"float": ctypes.c_float, "int32_t": ctypes.c_int}
    for (n, ct), (t, pointer, _) in zip(got, want):
        if pointer:
            assert ct is ctypes.c_void_p, n
        elif t in scalars:
            assert ct is scalars[t], n
        else:
            assert ct is getattr(ptb, f"_{t}"), n


def test_block_library_is_one_whole_program_unit(monkeypatch, tmp_path):
    """The block library is one translation unit, block_correlator.cu,
    which includes block_step.cu (K8a, K8b) and block_step.cuh: built with
    the default flags (no -rdc=true, no --fmad=false; block_step.cu rounds
    explicitly), so K1 with the closure and the fold is a whole program.
    The per-epoch library keeps its layout: relocatable units, epoch_step
    with --fmad=false and the register cap.  No source is built with fast
    math; every flag, and every file a unit includes, is part of its
    library's hash."""
    assert cuda_build.LIBRARIES["block_kernels"] == ("block_correlator",)
    assert "block_step" not in cuda_build.SOURCES
    assert cuda_build.included("block_correlator") == ["block_step.cu",
                                                       "block_step.cuh"]
    flags = cuda_build.nvcc_flags("block_correlator")
    assert flags == cuda_build.NVCC_FLAGS
    assert "-rdc=true" not in flags and "--fmad=false" not in flags
    for unit in cuda_build.LIBRARIES["epoch_kernels"]:
        flags = cuda_build.nvcc_flags(unit)
        assert "-rdc=true" in flags
        assert ("--fmad=false" in flags) == (unit == "epoch_step")
        assert set(cuda_build.EPOCH_REGS) <= set(flags)
    for unit in cuda_build.SOURCES:
        assert "--use_fast_math" not in cuda_build.nvcc_flags(unit)
    built = cuda_build.library_path("block_kernels")
    variant = cuda_build.library_path("block_kernels", ("--fmad=false",),
                                      tmp_path)
    assert variant.parent == tmp_path and variant.name != built.name
    monkeypatch.setitem(cuda_build.SOURCE_FLAGS, "block_correlator",
                        ("--fmad=false",))
    assert cuda_build.library_path("block_kernels").name == variant.name
    monkeypatch.delitem(cuda_build.SOURCE_FLAGS, "block_correlator")
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    assert cuda_build.library_path("block_kernels") == built
    (csrc / "block_step.cu").write_text(
        (csrc / "block_step.cu").read_text() + "\n")
    assert cuda_build.library_path("block_kernels") != built


@pytest.mark.parametrize("case", list(CASES))
def test_folded_prologue_is_the_prologue_of_the_closed_state(case):
    """The fused launch's plain version with a fold (_step_plain given the
    replica table and the taps) returns, beside K1's and K8b's results,
    block b+1's prologue: bit for bit K8a's plain version on the state that
    block b's closure returned, field by field; and the fused wrapper on
    CPU tensors writes it into the next prologue buffer it is given."""
    sig, seed = CASES[case]
    rng = np.random.default_rng(seed)
    c = _scenario(sig, seed)
    a = _armed(sig, c["pconf"])
    _edge(case, a, c["pconf"], rng)
    conf, e = c["pconf"], sig["e"]
    codes_rep = ptb.code_spectra(conf, c["tables"], "cpu")
    taps, x = torch.from_numpy(c["taps"]), torch.from_numpy(c["x"])
    st = interop.track_state_from_numpy(a, "cpu")
    xf_all = ptb._window_spectra(x, conf.nominal_epoch_samples,
                                 ptb.block_fft_size(conf))
    n_wins = xf_all.shape[0]
    pro = ptb._block_prologue_plain(conf, e, codes_rep, taps, n_wins, st)
    rf = torch.fft.fft(pro.rep_t, dim=-1)
    corr, new, outs, nxt = ptb._step_plain(conf, e, xf_all, rf, pro, st,
                                           codes_rep, taps)
    want_st, want_outs = ptb._block_closure_plain(conf, e, corr, pro, st)
    want = ptb._block_prologue_plain(conf, e, codes_rep, taps, n_wins,
                                     want_st)
    ds, dw = (interop.track_state_to_numpy(t) for t in (new, want_st))
    assert all(np.array_equal(ds[k], dw[k]) for k in dw)
    for k in outs:
        assert torch.equal(outs[k], want_outs[k]), k
    for name, got, ref in zip(ptb.BlockPrologue._fields, nxt, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref), name
    # the next block moved on: its boundaries start from the new state
    assert not torch.equal(nxt.ph_sc, pro.ph_sc)
    next_pro = ptb._empty_prologue(len(a["active"]), e, codes_rep.shape[1],
                                   len(c["taps"]), "cpu")
    planes = ptb._empty_planes(e, len(a["active"]), "cpu")
    got_st = ptb.block_correlate_close(conf, e, xf_all, rf, pro, st, planes,
                                       0, fold=(codes_rep, taps, next_pro))
    dg = interop.track_state_to_numpy(got_st)
    assert all(np.array_equal(dg[k], dw[k]) for k in dw)
    for name, got, ref in zip(ptb.BlockPrologue._fields, next_pro, want):
        assert torch.equal(got, ref), name


@pytest.mark.parametrize("case", list(CASES))
def test_folded_plain_chunk_equals_the_plain_chunk(case):
    """The plain versions in the two-launch chunk's order
    (_chunk_plain_folded: K8a for block 0, then per block the FFT and the
    fused step with the next block's prologue, none after the last) give
    _chunk_plain's final state and planes bit for bit over 3 blocks from
    each case's edge state."""
    sig, seed = CASES[case]
    rng = np.random.default_rng(seed)
    c = _scenario(sig, seed)
    a = _armed(sig, c["pconf"])
    _edge(case, a, c["pconf"], rng)
    conf, e = c["pconf"], sig["e"]
    codes_rep = ptb.code_spectra(conf, c["tables"], "cpu")
    taps, x = torch.from_numpy(c["taps"]), torch.from_numpy(c["x"])
    st = interop.track_state_from_numpy(a, "cpu")
    xf_all = ptb._window_spectra(x, conf.nominal_epoch_samples,
                                 ptb.block_fft_size(conf))
    args = (conf, 3, e, codes_rep, taps, xf_all, st)
    got_st, got = ptb._chunk_plain_folded(*args)
    want_st, want = ptb._chunk_plain(*args)
    ds, dw = (interop.track_state_to_numpy(t) for t in (got_st, want_st))
    for k in dw:
        assert np.array_equal(ds[k], dw[k]), k
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# the block shapes of chip_smoke.py's phase 3 (check_k8): GPS L1 C/A at 2
# Msps with 8 and 12 channels, at 20 Msps (L5I and E5a-I share its E, K, F)
# with 10, Galileo E1-B at 20 Msps with 10; and those tools/probe_fold.py
# times the fold at, S from 1 to 13: (C, F)
BLOCK_SHAPES = {"gps_2msps_c8": (8, 4096), "gps_2msps_c12": (12, 4096),
                "gps_20msps": (10, 40500), "e1_20msps": (10, 162000),
                "gps_2msps_c140": (140, 4096), "gps_20msps_c40": (40, 40500),
                "gps_20msps_c66": (66, 40500),
                "gps_20msps_c132": (132, 40500),
                "gps_20msps_c264": (264, 40500),
                "e1_20msps_c20": (20, 162000), "e1_20msps_c40": (40, 162000),
                "gps_2msps_c300": (300, 4096)}


@pytest.mark.parametrize("shape", list(BLOCK_SHAPES))
def test_fold_waits_only_where_the_grid_is_resident(shape):
    """The chunk folds K8a into the fused launch at every shape, where a
    channel's S > 1 CTAs wait for its closure's flag: so plan_k1, on the
    H100's 132 SMs, gives every grid of S > 1 one wave (C * S CTAs, at
    most K1_CTAS_PER_SM per SM), and only a grid of S = 1, where nothing
    waits, takes more (C = 300)."""
    c, nfft = BLOCK_SHAPES[shape]
    slabs = ptb.plan_k1(c, 20, nfft, 132)
    assert 1 <= slabs <= nfft // ptb.K1_MIN_SLAB
    assert slabs == 1 or c * slabs <= ptb.K1_CTAS_PER_SM * 132
    assert (slabs == 1) == (c > ptb.K1_CTAS_PER_SM * 132 // 2)
