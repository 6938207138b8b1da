"""The bench's full chain (bench.py:_bench_full_chain) through the PyTorch
port and the JAX package on the CPU, at its widths and cut in depth.

The scenario is bench.py:128-155's: 12 satellites at the twelve offsets of
bench.py:136-139, 47 dB-Hz, LNAV subframes 1-3, seed 3, 2 Msps, a
12-channel receiver with PVT every 500 ms.  The capture is made by the
port's device generator (K6's plain version) and cut to its first 4 s
(the bench runs 120 s); the same array goes through both packages'
``Receiver.process_array``.  The first acquisition of the twelve PRNs
(detection, delay bin, Doppler bin) and the tracked set must be equal.
"""

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models.acquisition import AcqConf as JAcqConf
from gnss_sim_receiver_tpu.models.acquisition import \
    PcpsAcquisitionEngine as JEngine
from gnss_sim_receiver_tpu.models.control import ChannelState as JState
from gnss_sim_receiver_tpu.models.receiver import Receiver as JReceiver
from gnss_sim_receiver_tpu.models.receiver import ReceiverConf as JConf
from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf
from gnss_sim_receiver_tpu_torch.models.acquisition import \
    PcpsAcquisitionEngine as PEngine
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.models.receiver import Receiver, ReceiverConf
from gnss_sim_receiver_tpu_torch.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu_torch.sim.device_generator import \
    generate_baseband_device_resident
from gnss_sim_receiver_tpu_torch.sim.scenario import build_static_scenario
from gnss_sim_receiver_tpu_torch.utils import geodesy

FS = 2_000_000.0
DURATION = 120.0            # the bench scenario's length (its nav streams)
DEPTH = 4.0                 # seconds of it that the test runs
T0 = 345600.0
OFFSETS = [(0.0, 0.0), (40.0, 15.0), (-35.0, 20.0), (15.0, 55.0),
           (-20.0, -50.0), (45.0, -25.0), (-45.0, -15.0), (5.0, -60.0),
           (30.0, 40.0), (-10.0, 62.0), (25.0, -42.0), (-28.0, 47.0)]
PRNS = tuple(range(1, 13))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs this file beside other
    workers, and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def capture():
    ephs = make_sky_constellation(40.0, -75.0, toe=T0 + 600,
                                  offsets_deg=OFFSETS)
    rx = geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
    sats = build_static_scenario(ephs, rx, T0, DURATION, cn0_db_hz=47.0,
                                 subframe_cycle=(1, 2, 3))
    assert [s.prn for s in sats] == list(PRNS)
    return generate_baseband_device_resident(
        sats, FS, int(FS * DEPTH), seed=3, chunk_samples=1 << 19,
        device="cpu")


def test_first_acquisition_matches_jax(capture):
    x = capture
    je = JEngine(JAcqConf(fs_in=FS, max_dwells=2), PRNS)
    pe = PEngine(AcqConf(fs_in=FS, max_dwells=2), PRNS, device="cpu")
    want = je.acquire_from(x.numpy(), 0)
    got = pe.acquire_from(x, 0)
    assert list(got.detected) == list(want.detected) == [True] * 12
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)


def test_full_chain_tracks_what_jax_tracks(capture):
    x = capture
    conf = dict(fs=FS, prns=PRNS, max_channels=12, max_acq_channels=12,
                pvt_rate_ms=500)
    got = Receiver(ReceiverConf(**conf), device="cpu").process_array(x)
    want = JReceiver(JConf(**conf)).process_array(x.numpy())

    def tracked(run, state):
        return sorted(p for p, s in zip(run.channel_prns, run.channel_states)
                      if s == state)
    assert tracked(got, ChannelState.TRACKING) == list(PRNS)
    assert tracked(want, JState.TRACKING) == list(PRNS)
    assert len(got.channel_prns) == len(want.channel_prns) == 12
