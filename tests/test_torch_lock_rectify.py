"""The rectified carrier-lock test of the PyTorch port against the JAX
package on the CPU (inputs from a seed with NumPy; tolerances stated per
test):

- ops/cn0.py's carrier_lock_value in both forms on random accumulators;
- the plain per-epoch closure tracking a BeiDou D2 GEO signal (500 bps
  symbols, no NH code, so the coherent sums zero-mean over every window)
  with lock_rectify on and off, window by window against JAX's
  track_chunk: the rectified test holds the lock, the coherent one does
  not;
- the flag through interop and into the chunk kernel's launch arguments
  (csrc/epoch_step.cuh's EpochArgs.lock_rectify).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.nav import dnav as jdnav
from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu.ops import cn0 as jcn0
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.ops import prn_codes_multi as jpcm
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.ops import cn0 as pcn0
from tests.test_torch_tracking import _armed

FS = 4_500_000.0                   # tests/test_dnav.py's B1I rate
S0 = 4500                          # one 1 ms epoch at FS
GEO_PRN = 2
DOP = 1350.0                       # tests/test_d2.py's GEO signal
DELAY = 2345                       # samples
WINDOWS = 8                        # C/N0 windows of 20 epochs


@pytest.mark.parametrize("rectify", [False, True])
def test_carrier_lock_value_like_jax(rectify):
    """Random accumulators (signed and rectified sums, zero sums among
    them): the port's value equals JAX's to 1e-6, and the two forms
    differ."""
    rng = np.random.default_rng(3)
    n = 64
    si, sq = rng.standard_normal((2, n)).astype(np.float32) * 40.0
    ai = np.abs(si) + rng.random(n).astype(np.float32) * 30.0
    aq = np.abs(sq) + rng.random(n).astype(np.float32) * 30.0
    si[:4] = sq[:4] = ai[:2] = aq[:2] = 0.0
    zeros = np.zeros(n, np.float32)
    fields = (ai, aq, zeros, zeros, si, sq, zeros + 20.0)
    got = pcn0.carrier_lock_value(
        pcn0.Cn0AccumState(*map(torch.from_numpy, fields)),
        rectify=rectify).numpy()
    want = np.asarray(jcn0.carrier_lock_value(
        jcn0.Cn0AccumState(*map(jnp.asarray, fields)), rectify=rectify))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    other = pcn0.carrier_lock_value(
        pcn0.Cn0AccumState(*map(torch.from_numpy, fields)),
        rectify=not rectify).numpy()
    assert np.abs(other - got)[4:].min() > 1e-3


@pytest.fixture(scope="module")
def geo():
    """tests/test_d2.py's GEO PRN 2 on B1I (D2 pages at 500 bps, 48 dB-Hz,
    1350 Hz) at tests/test_dnav.py's B1I rate (4.5 Msps: a whole number
    of samples a chip would put every chip edge on the code NCO's rounding
    edge at once), in noise from a seed (without it (sum Q)^2 is 0 and
    both tests read 1), WINDOWS windows deep, and its replica table."""
    eph = make_sky_constellation(30.0, 110.0, toe=7200.0)[0]
    eph.prn, eph.system = GEO_PRN, "BeiDou"
    nav = jdnav.d2_epoch_signs(jdnav.d2_bits_for_ephemeris(
        eph, t0_bdt_s=300.0, n_frames=1))
    sat = JSat(prn=GEO_PRN, system="BeiDou", signal="B1", cn0_db_hz=48.0,
               doppler_hz=DOP, delay_chips=DELAY * 2.046e6 / FS,
               nav_bits=nav)
    x = jgen([sat], FS, DELAY + (20 * WINDOWS + 4) * S0 + 4096,
             noise=True, seed=21)
    table = jpc.bandlimited_table_normalized(
        jpcm.beidou_b1i_code(GEO_PRN), FS, 2.046e6, S0)[None]
    return x, table


@pytest.mark.parametrize("rectify", [False, True])
def test_plain_closure_lock_on_d2_like_jax(geo, rectify):
    """beidou_b1i_chain's loops (FLL pull-in over the first 100 epochs)
    with lock_rectify=`rectify`, armed on the GEO signal, 20 epochs a call
    in both packages: after every window the carrier-lock value within
    0.02 of JAX's, the C/N0 within 0.2 dB, the lock-lost flag, activity
    and epoch count identical.  The noise drives the two packages' float32
    loops apart a little (measured over the 8 windows: prompts within
    1.4 %, Doppler 0.4 Hz, the coherent lock 0.011, the rectified one
    3e-4, C/N0 0.15 dB).  Rectified, the lock holds (> 0.95 in every
    window, no failed window); coherent, the D2 symbols balance out over
    some windows and drive it under the 0.75 threshold after the pull-in,
    in both packages."""
    x, table = geo
    jconf = dataclasses.replace(jrx.beidou_b1i_chain(FS).trk,
                                lock_rectify=rectify)
    pconf = dataclasses.replace(prx.beidou_b1i_chain(FS).trk,
                                lock_rectify=rectify)
    assert pconf == interop._conf_from_fields(
        ptrk.TrackingConf, dataclasses.asdict(jconf), "trk")
    sj = _armed(jconf, [GEO_PRN], [DOP], [DELAY])
    sp = interop.track_state_from_numpy(interop.track_state_to_numpy(sj),
                                        "cpu")
    taps = np.array([0.25, 0.0, -0.25], np.float32)
    args_j = (jnp.asarray(table), jnp.asarray(taps), jnp.asarray(x))
    args_p = (torch.from_numpy(table), torch.from_numpy(taps),
              torch.from_numpy(x))
    locks = []
    for _ in range(WINDOWS):
        sj, _ = jtrk.track_chunk(jconf, 20, *args_j, sj)
        sp, _ = ptrk.track_chunk(pconf, 20, *args_p, sp)
        dj = interop.track_state_to_numpy(sj)
        dp = interop.track_state_to_numpy(sp)
        assert abs(float(dp["carrier_lock"][0])
                   - float(dj["carrier_lock"][0])) < 0.02
        assert abs(float(dp["cn0_db_hz"][0]) - float(dj["cn0_db_hz"][0])) \
            < 0.2
        for k in ("lock_lost", "active", "epoch"):
            assert np.array_equal(dp[k], dj[k]), k
        locks.append((float(dp["carrier_lock"][0]),
                      float(dj["carrier_lock"][0])))
    locks = np.array(locks)
    if rectify:
        assert locks.min() > 0.95, locks
        assert float(dp["lock_fail"][0]) == float(dj["lock_fail"][0]) == 0.0
    else:
        assert (locks[100 // 20:].min(axis=0) < 0.75).all(), locks
    assert not dp["lock_lost"][0]


def test_flag_reaches_the_chunk_kernel_arguments():
    """lock_rectify is a TrackingConf field of the port's (no longer one
    interop drops), and the chunk kernel's launch arguments carry it as
    the last int32 of EpochArgs, 0 or 1."""
    assert "lock_rectify" not in interop._ABSENT[ptrk.TrackingConf]
    names = [n for n, _ in ptrk._EpochArgs._fields_]
    assert names[-1] == "lock_rectify"
    for rectify in (False, True):
        conf = ptrk.TrackingConf(fs=FS, lock_rectify=rectify)
        assert ptrk._epoch_constants(conf)["lock_rectify"] == int(rectify)
