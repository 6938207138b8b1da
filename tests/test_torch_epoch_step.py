"""One epoch of the per-epoch scan from edge states: the JAX body
(tracking._epoch_step) op by op under jax.disable_jit against the port's
split plain path, K2's plain version and then the plain version of kernel
K9 (tracking._epoch_closure_plain); and the chunk's [T, C] planes of the
CPU loop against the per-epoch outputs they collect.

Five cases: GPS L1 C/A with 3 taps at extend_correlation_symbols 1 and 20
(bit sync), a GPS-rate pilot with the NH20 secondary at 20, the Galileo E1
pilot (E1-C with CS25, 5 VEML taps) with the E1-B data-prompt tap at 5,
and GPS at 20 with the second-order PLL (Tracking.order=2) on the wide
and the narrow closure.  (tests/test_torch_kf_tracking.py holds the
Kalman forms.)
The channels are armed on truth START epochs into a noisy capture and put
on edges with a NumPy seed: secondary sync about to hit, synced with
polarity -1, a bit-sync histogram one transition short of dominance, a
coherent group that restarts and one that closes, the C/N0 window's last
epoch, a lock loss, an inactive channel.  The prompt signs that the edges
depend on come from the port's K2 on the same state first.

Tolerances: every integer and bool field, the sign buffer and histogram,
and the NCO carry (pos, rem_code_phase, rem_carr_phase, the Kahan pair)
bit for bit; they read only the state and the prompt signs.  The loop
outputs take the correlations, whose sums run in another order in the two
packages (a few 1e-7 of the prompt): the Doppler and the PLL velocity
within 1e-3 Hz, the code rate within 1e-3 chip/s (a few float32 ulps at
2 Mchip/s), the DLL velocity to 1e-5 of itself and 1e-7 chip/s, the
coherent sums, the C/N0 accumulators, the lock value and the prompt
outputs to 1e-5 of their largest modulus, C/N0 within 1e-3 dB.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.ops import correlator as pcorr
from gnss_sim_receiver_tpu_torch.ops import cuda_build
from tests.test_torch_block_step import _c_struct_fields, _jax_state

START = 7
GPS = dict(fs=2_000_000.0, rate=1.023e6, s0=2000, prns=[5, 13, 27, 9],
           dops=[-2400.0, 650.0, 3100.0, 1200.0], delays=[587, 980, 1520, 333])
E1 = dict(fs=4_000_000.0, rate=2.046e6, s0=16000, prns=[11, 14, 12, 19],
          dops=[1625.0, -2125.0, 900.0, -300.0],
          delays=[5021, 11790, 3000, 8800])
NH20 = tuple(constants.GPS_L5Q_NH_CODE)


def _confs(case, fs):
    """(JAX conf, port conf) of a case, built by the same constructors."""
    if case == "e1_pilot":
        kw = dict(track_pilot=True, extend_correlation_symbols=5,
                  very_early_late_space_chips=1.2)
        return (jrx.galileo_e1b_chain(fs, **kw).trk,
                prx.galileo_e1b_chain(fs, **kw).trk)
    kw = dict(fs=fs)
    if case == "gps_ext20":
        kw.update(extend_correlation_symbols=20)
    if case == "gps_pll2_ext20":
        kw.update(extend_correlation_symbols=20, pll_filter_order=2)
    if case == "nh20_pilot":   # tests/test_secondary_code.py's pilot conf
        kw.update(secondary_code=NH20, extend_correlation_symbols=20,
                  enable_fll_pullin=False, pll_bw_hz=20.0,
                  fll_pullin_epochs=300, pll_bw_narrow_hz=8.0)
    return jtrk.TrackingConf(**kw), ptrk.TrackingConf(**kw)


def _scenario(case, seed):
    """The capture, tables and taps of a case (48 dB-Hz plus noise)."""
    rng = np.random.default_rng(seed)
    sig = E1 if case == "e1_pilot" else GPS
    fs, s0 = sig["fs"], sig["s0"]
    jconf, pconf = _confs(case, fs)
    sats, data = [], None
    for p, d, n in zip(sig["prns"], sig["dops"], sig["delays"]):
        if sig is GPS:
            sats.append(SatelliteSignalParams(
                prn=p, cn0_db_hz=48.0, doppler_hz=d,
                delay_chips=n * sig["rate"] / fs,
                nav_bits=np.where(rng.random(8) < 0.5, 1, -1
                                  ).astype(np.int8)))
            continue
        common = dict(prn=p, system="Galileo", cn0_db_hz=45.0, doppler_hz=d,
                      delay_chips=n * 1.023e6 / fs)
        sats.append(SatelliteSignalParams(
            signal="1B", nav_bits=np.where(rng.random(40) < 0.5, 1, -1
                                           ).astype(np.int8), **common))
        sats.append(SatelliteSignalParams(
            signal="1P", nav_bits=np.tile(
                jsig.e1c_secondary_code().astype(np.int8), 2), **common))
    n = max(sig["delays"]) + (START + 3) * s0 + 20000
    x = generate_baseband(sats, fs, n, noise=False)
    x = (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         * np.float32(0.3 * np.abs(x).std())).astype(np.complex64)

    def table(code):
        return jpc.bandlimited_table_normalized(code, fs, sig["rate"], s0)
    if sig is GPS:
        codes = np.stack([table(jpc.gps_l1_ca_code(p)) for p in sig["prns"]])
        taps = np.array([0.25, 0.0, -0.25], np.float32)
    else:
        codes = np.stack([table(jsig.boc11_expand(jsig.galileo_e1_code(p, "C")))
                          for p in sig["prns"]])
        data = np.stack([table(jsig.subchip_table(jsig.GALILEO_E1B, p))
                         for p in sig["prns"]])
        d, dv = pconf.early_late_space_chips, pconf.very_early_late_space_chips
        taps = np.array([dv, d / 2, 0.0, -d / 2, -dv], np.float32)
    return dict(sig=sig, x=x, codes=codes, data=data, taps=taps, jconf=jconf,
                pconf=pconf)


def _armed(sig, conf):
    """Every channel armed on truth START epochs in, as a flat dict."""
    st = jtrk._init_state(len(sig["dops"]))
    for ch, d in enumerate(sig["dops"]):
        st = jtrk._arm_channel(st, ch, d, conf.code_rate_cps
                               * (1.0 + d / conf.carrier_freq_hz))
    pos = np.asarray(sig["delays"], np.int64) + START * sig["s0"]
    a = {k: np.array(v) for k, v in interop.track_state_to_numpy(st).items()}
    a["pos"] = pos.astype(np.int32)
    a["rem_carr_phase"] = np.mod(2.0 * np.pi * np.asarray(sig["dops"]) * pos
                                 / conf.fs, 2.0 * np.pi).astype(np.float32)
    return a


def _port_correlate(c, a):
    """The port's K2 (plain) on the state `a`: the correlations [C, K]."""
    st = interop.track_state_from_numpy(a, "cpu")
    corr, _ = ptrk._correlate(
        c["pconf"], torch.from_numpy(c["codes"]), torch.from_numpy(c["taps"]),
        torch.from_numpy(c["x"]), st, ptrk._epoch_length(c["pconf"], st),
        None if c["data"] is None else torch.from_numpy(c["data"]))
    return corr.numpy()


def _edge(case, c, a, rng):
    """Put the state `a` (flat dict) on case `case`'s edges; returns what
    the epoch must show that the edges were reached."""
    conf = c["pconf"]
    ep, mlf = conf.fll_pullin_epochs, float(conf.max_lock_fail)
    w = conf.cn0_window_epochs
    k = conf.extend_correlation_symbols

    def window_end(i):             # the C/N0 window's last epoch, >= ep
        return (ep // w + i) * w - 1
    a["rem_carr_phase"][0] = np.float32(-rng.uniform(0.1, 3.0))
    a["cn0_acc.count"][:] = w - 1
    for key, v in (("sum_m2", 4e6), ("sum_m4", 2e13), ("sum_i", 3e4),
                   ("sum_q", 4e2), ("sum_abs_i", 3e4), ("sum_abs_q", 5e3)):
        a[f"cn0_acc.{key}"][:] = np.float32(v)
    a["cn0_db_hz"][:] = 44.0
    a["lock_fail"][:] = rng.integers(0, 5, 4)
    if case == "gps_ext1":
        # 0: the window's last epoch and a lock loss, 1: inactive, 2: in the
        # FLL pull-in, 3: mid-window
        a["epoch"][:] = [window_end(6), ep + 40, 5, ep + 45]
        a["lock_fail"][0] = mlf
        a["carrier_lock"][0] = 0.2
        a["cn0_acc.sum_i"][0] = 10.0
        a["active"][1] = False
        return {"lost": 0, "window": 0, "inactive": 1}
    prompt = _port_correlate(c, a)[:, 2 if conf.very_early_late_space_chips
                                   else 1]
    sign = np.where(prompt.real >= 0, 1.0, -1.0).astype(np.float32)
    if case in ("gps_ext20", "gps_pll2_ext20"):
        # 0: one transition short of bit sync, 1: a group restarts at the bit
        # start, 2: a group closes (and the window's last epoch), 3: inactive
        a["epoch"][:] = [ep + 23, ep + 61, window_end(2), ep + 30]
        idx0 = a["epoch"][0] % 20
        a["bit_hist"][0] = rng.integers(0, 4, 20)
        a["bit_hist"][0, idx0] = conf.bit_sync_min_transitions - 1
        a["prev_sign"][:] = -sign
        a["bit_synced"][1:3] = True
        a["bit_phase"][1] = a["epoch"][1] % 20
        a["bit_phase"][2] = (a["epoch"][2] + 7) % 20
        a["ext_n"][1:3] = [13, k - 1]
        a["ext_p"][1:3] = prompt[1:3] * np.float32(k - 1)
        a["ext_e"][1:3] = prompt[1:3] * np.float32(0.6 * (k - 1))
        a["ext_l"][1:3] = prompt[1:3] * np.float32(0.5 * (k - 1))
        a["active"][3] = False
        return {"bit_sync": (0, idx0), "restart": 1, "close": 2, "window": 2,
                "inactive": 3}
    # pilots: 0 hits the secondary sync, 1 is synced with polarity -1 and
    # closes a group, 2 restarts a group at the code boundary on the
    # window's last epoch, 3 loses lock (E1: inactive)
    n = len(conf.secondary_code)
    sec = ptrk.secondary_pm1(conf)
    a["epoch"][:] = [ep + 31, ep + 47, window_end(3), window_end(4)]
    off0 = int(rng.integers(0, n))
    pol0 = sign[0] * sec[(a["epoch"][0] % n + off0) % n]
    a["sec_buf"][0, :n] = pol0 * sec[(np.arange(n) + off0) % n]
    a["sec_synced"][1:] = True
    a["sec_polarity"][1:] = [-1.0, 1.0, 1.0]
    a["sec_off"][1] = (3 - a["epoch"][1]) % n
    a["sec_off"][2] = (-a["epoch"][2]) % n
    a["sec_off"][3] = 5
    a["sec_buf"][1:, :n] = np.where(rng.random((3, n)) < 0.5, 1.0, -1.0)
    a["ext_n"][1:3] = [k - 1, 2]
    for key, f in (("ext_p", 1.0), ("ext_e", 0.6), ("ext_l", 0.5)):
        a[key][1:3] = prompt[1:3] * np.float32(f * (k - 1))
    if case == "nh20_pilot":
        a["lock_fail"][3] = mlf
        a["carrier_lock"][3] = 0.1
        return {"sec_hit": (0, off0, pol0), "close": 1, "restart": 2,
                "window": 2, "lost": 3}
    a["active"][3] = False
    return {"sec_hit": (0, off0, pol0), "close": 1, "restart": 2,
            "window": 2, "inactive": 3}


EXACT = ("active", "pos", "rem_code_phase", "rem_carr_phase",
         "acc_phase_cycles", "acc_phase_comp", "epoch", "lock_fail",
         "lock_lost", "bit_hist", "prev_sign", "bit_synced", "bit_phase",
         "ext_n", "sec_buf", "sec_synced", "sec_off", "sec_polarity",
         "cn0_acc.count")
CASES = {"gps_ext1": 1, "gps_ext20": 2, "nh20_pilot": 3, "e1_pilot": 4,
         "gps_pll2_ext20": 5}


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_epoch_step_edges_match_jax_op_by_op(case):
    seed = CASES[case]
    rng = np.random.default_rng(seed)
    c = _scenario(case, seed)
    assert dataclasses.asdict(c["pconf"]) == {
        f.name: getattr(c["jconf"], f.name)
        for f in dataclasses.fields(c["pconf"])}
    a = _armed(c["sig"], c["pconf"])
    reached = _edge(case, c, a, rng)
    data = c["data"]
    with jax.disable_jit():
        sj, oj = jtrk._epoch_step(
            c["jconf"], jnp.asarray(c["codes"]), jnp.asarray(c["taps"]),
            jnp.asarray(c["x"]), _jax_state(a),
            None if data is None else jnp.asarray(data))
    sp, op = ptrk._epoch_step(
        c["pconf"], torch.from_numpy(c["codes"]), torch.from_numpy(c["taps"]),
        torch.from_numpy(c["x"]), interop.track_state_from_numpy(a, "cpu"),
        None if data is None else torch.from_numpy(data))
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in EXACT:
        assert dj[k].dtype == dp[k].dtype, k
        assert np.array_equal(dj[k], dp[k]), (k, dj[k], dp[k])
    for k in ("carrier_doppler", "pll.vel"):
        assert np.abs(dj[k] - dp[k]).max() < 1e-3, k
    assert np.abs(dj["code_freq"] - dp["code_freq"]).max() < 1e-3
    assert np.allclose(dj["dll.vel"], dp["dll.vel"], rtol=1e-5, atol=1e-7)
    assert np.abs(dj["cn0_db_hz"] - dp["cn0_db_hz"]).max() < 1e-3
    for k in ("ext_p", "ext_e", "ext_l", "prompt_prev", "carrier_lock",
              "pll.acc", "cn0_acc.sum_m2", "cn0_acc.sum_m4",
              "cn0_acc.sum_i", "cn0_acc.sum_q"):
        assert _rel(dp[k], dj[k]) < 1e-5, k
    for k in ("prompt", "pilot_prompt"):
        assert _rel(op[k].numpy(), np.asarray(oj[k])) < 1e-5, k
    for k in ("pos_start", "n_samples", "valid", "code_phase_samples",
              "acc_phase_cycles", "rem_code_phase_chips"):
        assert np.array_equal(op[k].numpy(), np.asarray(oj[k])), k
    if data is not None:      # the data prompt is not the pilot prompt
        assert not np.allclose(op["prompt"].numpy(),
                               op["pilot_prompt"].numpy())
    # the edges were reached
    if "lost" in reached:
        ch = reached["lost"]
        assert dp["lock_lost"][ch] and not dp["active"][ch]
    if "window" in reached:
        ch = reached["window"]
        assert dp["cn0_acc.count"][ch] == 0 and a["cn0_acc.count"][ch] > 0
    if "inactive" in reached:
        ch = reached["inactive"]
        assert dp["pos"][ch] == a["pos"][ch] + c["pconf"].nominal_epoch_samples
        assert dp["epoch"][ch] == a["epoch"][ch]
    if "bit_sync" in reached:
        ch, phase = reached["bit_sync"]
        assert dp["bit_synced"][ch] and dp["bit_phase"][ch] == phase
    if "sec_hit" in reached:
        ch, off, pol = reached["sec_hit"]
        assert dp["sec_synced"][ch] and not a["sec_synced"][ch]
        assert dp["sec_off"][ch] == off and dp["sec_polarity"][ch] == pol
    if "close" in reached:
        ch = reached["close"]
        assert dp["ext_n"][ch] == 0 and dp["ext_p"][ch] == 0
        assert dp["carrier_doppler"][ch] != a["carrier_doppler"][ch]
    if "restart" in reached:
        assert dp["ext_n"][reached["restart"]] == 1


def test_epoch_planes_equal_per_epoch_outputs():
    """The CPU loop writes each epoch's outputs into [T, C] planes allocated
    once (EPOCH_PLANES): over 6 epochs of the E1 pilot case they equal the
    outputs of _epoch_step stacked, and the state is the same; through
    epoch_closure's plain branch the next epoch's lengths land in n_c."""
    c = _scenario("e1_pilot", 5)
    a = _armed(c["sig"], c["pconf"])
    conf = c["pconf"]
    codes, taps = torch.from_numpy(c["codes"]), torch.from_numpy(c["taps"])
    x, data = torch.from_numpy(c["x"]), torch.from_numpy(c["data"])
    st0 = interop.track_state_from_numpy(a, "cpu")
    sp, planes = ptrk.track_chunk(conf, 6, codes, taps, x, st0, data)
    assert list(planes) == [k for k, _ in ptrk.EPOCH_PLANES]
    st, outs = st0, []
    for _ in range(6):
        st, o = ptrk._epoch_step(conf, codes, taps, x, st, data)
        outs.append(o)
    for k in planes:
        want = torch.stack([o[k] for o in outs])
        assert planes[k].dtype == want.dtype and torch.equal(planes[k], want)
    ds, dw = interop.track_state_to_numpy(sp), interop.track_state_to_numpy(st)
    for k in ds:
        assert np.array_equal(ds[k], dw[k]), k
    n_c = ptrk._epoch_length(conf, st0)
    corr, dprompt = ptrk._correlate(conf, codes, taps, x, st0, n_c, data)
    rows = ptrk._empty_planes(1, 4, "cpu", ptrk.EPOCH_PLANES)
    nxt = ptrk.epoch_closure(conf, torch.cat([corr, dprompt[:, None]], 1),
                             n_c, st0, rows, 0)
    assert torch.equal(n_c, ptrk._epoch_length(conf, nxt))
    assert torch.equal(rows["prompt"][0], planes["prompt"][0])


@pytest.mark.parametrize("case", ["gps_ext20", "e1_pilot"])
def test_epoch_chunk_on_cpu_runs_the_plain_loop(case, monkeypatch):
    """track_chunk goes through the chunk kernel's wrapper (epoch_chunk),
    which on CPU tensors runs K2's and K9's plain versions epoch by epoch
    (_chunk_plain, once, on the same inputs) and returns its result
    unchanged; no kernel's launch counter moves."""
    c = _scenario(case, 6)
    a = _armed(c["sig"], c["pconf"])
    conf = c["pconf"]
    codes, taps = torch.from_numpy(c["codes"]), torch.from_numpy(c["taps"])
    x = torch.from_numpy(c["x"])
    data = None if c["data"] is None else torch.from_numpy(c["data"])
    st0 = interop.track_state_from_numpy(a, "cpu")
    calls = []

    def spy(*args, _plain=ptrk._chunk_plain):
        calls.append((args, _plain(*args)))
        return calls[-1][1]
    monkeypatch.setattr(ptrk, "_chunk_plain", spy)
    counters = (ptrk.epoch_chunk.launches, ptrk.epoch_chunk.epochs,
                ptrk.epoch_closure.launches, pcorr.multicorrelate.launches)
    got = ptrk.track_chunk(conf, 4, codes, taps, x, st0, data)
    assert counters == (ptrk.epoch_chunk.launches, ptrk.epoch_chunk.epochs,
                        ptrk.epoch_closure.launches,
                        pcorr.multicorrelate.launches)
    assert len(calls) == 1
    args, result = calls[0]
    assert args[:2] == (conf, 4) and args[5] is st0
    assert all(t is u for t, u in zip(args[2:5], (codes, taps, x)))
    assert args[6] is data and got is result
    assert len(result[1]["prompt"]) == 4


def test_epoch_conf_checks_raise_value_errors():
    """The JAX body's asserts are ValueErrors in the port."""
    conf = ptrk.TrackingConf(extend_correlation_symbols=3)
    with pytest.raises(ValueError, match="divide 20"):
        ptrk._check_epoch_conf(conf)
    conf = ptrk.TrackingConf(secondary_code=NH20,
                             extend_correlation_symbols=8)
    with pytest.raises(ValueError, match="secondary length"):
        ptrk._check_epoch_conf(conf)
    with pytest.raises(ValueError, match="N_SEC_MAX"):
        ptrk._check_epoch_conf(ptrk.TrackingConf(secondary_code=(1,) * 33))
    ptrk._check_epoch_conf(ptrk.TrackingConf(secondary_code=NH20,
                                             extend_correlation_symbols=10))


# each launch struct of the per-epoch kernels: its source and the module
# holding its ctypes mirror
_EPOCH_STRUCTS = {"EpochStatePtrs": ("epoch_step.cuh", ptrk),
                  "EpochPlanePtrs": ("epoch_step.cuh", ptrk),
                  "EpochArgs": ("epoch_step.cuh", ptrk),
                  "K2Args": ("multicorrelator.cuh", pcorr),
                  "EpochChunkArgs": ("epoch_chunk.cu", ptrk)}


@pytest.mark.parametrize("name", list(_EPOCH_STRUCTS))
def test_launch_structs_match_the_cuda_source(name):
    """K2's, K9's and the chunk kernel's launch arguments go to the kernels
    by value as ctypes Structures: field for field, the names, order and
    types of the structs in csrc/ (a pointer for every pointer, a nested
    Structure for every struct, c_float and c_int for float and int32_t)."""
    import ctypes
    from pathlib import Path
    source, module = _EPOCH_STRUCTS[name]
    src = (Path(ptrk.__file__).parents[1] / "csrc" / source).read_text()
    want = _c_struct_fields(src, name)
    got = getattr(module, f"_{name}")._fields_
    assert [n for n, _ in got] == [n for _, _, n in want]
    scalars = {"float": ctypes.c_float, "int32_t": ctypes.c_int}
    for (n, ct), (t, pointer, _) in zip(got, want):
        if pointer:
            assert ct is ctypes.c_void_p, n
        elif t in scalars:
            assert ct is scalars[t], n
        else:
            assert ct is getattr(_EPOCH_STRUCTS[t][1], f"_{t}"), n


def test_epoch_step_builds_without_contraction(monkeypatch):
    """epoch_step.cu (K9's closure) is compiled with --fmad=false, K2's
    multicorrelator.cu and the chunk kernel's epoch_chunk.cu with nvcc's
    default contraction, all three with relocatable device code into one
    library; every unit's flags are part of the library's hash: a build
    without --fmad=false would be another library."""
    units = cuda_build.LIBRARIES["epoch_kernels"]
    assert set(units) == {"multicorrelator", "epoch_step", "epoch_chunk"}
    for unit in units:
        flags = cuda_build.nvcc_flags(unit)
        assert "-rdc=true" in flags and "--use_fast_math" not in flags
        assert ("--fmad=false" in flags) == (unit == "epoch_step")
    built = cuda_build.library_path("epoch_kernels")
    monkeypatch.setitem(cuda_build.SOURCE_FLAGS, "epoch_step", ())
    assert cuda_build.library_path("epoch_kernels") != built
