"""The PyTorch port's hybrid receiver (GPS L1 C/A + Galileo E1-B) on the CPU
against the JAX receiver.

Both receivers run once, at the widths of tests/test_hybrid_position.py
:67-97 (4 GPS channels on PRNs 1, 3, 4, 5 and a 5-channel E1-B chain on
PRNs 11-15), over its cached 26 s capture at 4 Msps.  The port must meet
that test's assertions, track and decode what the JAX receiver does, and
its pseudoranges must agree with the JAX receiver's at the observable
epochs both produce, per system, within the bounds of
tests/test_torch_receiver.py (rms < 1 m, p99 < 3.5 m, max < 6 m).

Measured on this capture: GPS rms 0.63 m, p99 2.3 m, max 4.0 m over 4384
pairs (57 % within a millimetre); Galileo rms 0.21 m, p99 1.2 m, max 1.2 m
over 3880 pairs (80 % within a millimetre); 776 fixes on both sides.  The
gap is the float32 rounding of the jitted JAX program that
tests/test_torch_receiver.py describes (queue 3 of ROADMAP.md).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models.receiver import Receiver as JaxReceiver
from gnss_sim_receiver_tpu.models.receiver import \
    ReceiverConf as JaxReceiverConf
from gnss_sim_receiver_tpu.models.receiver import \
    galileo_e1b_chain as jax_e1b_chain
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                         ReceiverConf,
                                                         galileo_e1b_chain)
from gnss_sim_receiver_tpu_torch.utils import geodesy
from tests.fixtures import RX_LLH
from tests.test_hybrid_position import (FS, GAL_PRNS, GPS_PRNS,  # noqa: F401
                                        hybrid_capture)


@pytest.fixture(scope="module")
def runs(hybrid_capture):
    x, rx_true = hybrid_capture
    # two intra-op threads: the suite runs this file beside five other
    # workers, and more threads only oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = Receiver(ReceiverConf(
            fs=FS, prns=GPS_PRNS, max_channels=4, max_acq_channels=4,
            chains=(galileo_e1b_chain(FS, prns=GAL_PRNS, n_channels=5),)),
            device="cpu").process_array(x)
    finally:
        torch.set_num_threads(threads)
    ref = JaxReceiver(JaxReceiverConf(
        fs=FS, prns=GPS_PRNS, max_channels=4, max_acq_channels=4,
        chains=(jax_e1b_chain(FS, prns=GAL_PRNS, n_channels=5),))
    ).process_array(x)
    return port, ref, rx_true


def test_port_hybrid_position_fix(runs):
    """tests/test_hybrid_position.py:67-97, on the port."""
    run, _, rx_true = runs
    trk = {"GPS": [], "Galileo": []}
    for p, s, sy in zip(run.channel_prns, run.channel_states,
                        run.channel_systems):
        if s == ChannelState.TRACKING:
            trk[sy].append(p)
    assert sorted(trk["GPS"]) == sorted(GPS_PRNS), run.channel_prns
    assert sorted(trk["Galileo"]) == sorted(GAL_PRNS), run.channel_prns
    assert all(p in run.ephemerides for p in GPS_PRNS)
    assert all(("Galileo", p) in run.ephemerides for p in GAL_PRNS)
    assert run.ephemerides[("Galileo", 11)].iod_nav == 137
    assert len(run.solutions) >= 5
    assert run.solutions[-1].n_sats >= 7
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                    for s in run.solutions])
    err_2d = np.linalg.norm(enu.mean(0)[:2])
    err_3d = np.linalg.norm(enu.mean(0))
    assert err_2d < 2.0, f"2D {err_2d:.2f} m"
    assert err_3d < 5.0, f"3D {err_3d:.2f} m"


def test_port_hybrid_tracks_and_decodes_as_jax(runs):
    port, ref, _ = runs
    assert port.channel_prns == ref.channel_prns
    assert port.channel_systems == list(ref.channel_systems)
    assert port.channel_states == ref.channel_states
    assert sorted(port.ephemerides, key=str) == \
        sorted(ref.ephemerides, key=str)
    for key, eph in port.ephemerides.items():
        assert dataclasses.asdict(eph) == \
            dataclasses.asdict(ref.ephemerides[key]), key
    assert len(port.solutions) == len(ref.solutions)
    assert len(port.observation_epochs) == len(ref.observation_epochs)


@pytest.mark.parametrize("system", ["GPS", "Galileo"])
def test_port_hybrid_pseudoranges_match_jax(runs, system):
    port, ref, _ = runs
    cols = [c for c, s in enumerate(port.channel_systems) if s == system]
    ref_epochs = {round(e.rx_time_s, 6): e for e in ref.observation_epochs}
    d = []
    for e in port.observation_epochs:
        r = ref_epochs.get(round(e.rx_time_s, 6))
        if r is None:
            continue
        both = e.valid & r.valid
        d += [e.pseudorange_m[c] - r.pseudorange_m[c] for c in cols
              if both[c]]
    d = np.asarray(d)
    assert len(d) > 3000
    assert np.sqrt(np.mean(d ** 2)) < 1.0
    assert np.percentile(np.abs(d), 99) < 3.5
    assert np.abs(d).max() < 6.0
