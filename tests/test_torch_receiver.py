"""The PyTorch port's whole receiver on the CPU against the JAX receiver.

``Receiver(conf, device="cpu").process_array(x)`` on the static scenario
(26 s, 6 satellites, 2 Msps, 47 dB-Hz) must meet every assertion of the
JAX package's end-to-end test (tests/test_e2e_position.py:34-60), and its
pseudoranges must agree with the JAX receiver's at the observable epochs
both produce.

Pseudorange bound, measured on this capture: rms 0.73 m, 99th percentile
2.8 m, max 4.1 m over 5876 common (epoch, satellite) pairs; half the pairs
agree to the millimetre.  The differences come in steps of 0.59 m: the
block kernel's closed-form epoch boundary e*S - u0 (~40000 samples at the
end of a block) holds 1/256 sample in float32, and a rounding flip there
or in the last bit of the float32 code rate (0.0625 chip/s) walks the
code NCO until the DLL pulls it back.  The port runs the JAX program's
arithmetic as written (bit for bit on the code NCO against the program
run op by op, test_torch_tracking.py::test_block_matches_jax_op_by_op);
the jitted JAX program rounds differently where XLA contracts
multiply-adds and turns divisions by constants into multiplications.
"""

import collections

import numpy as np
import pytest

from gnss_sim_receiver_tpu.models.receiver import Receiver as JaxReceiver
from gnss_sim_receiver_tpu.models.receiver import \
    ReceiverConf as JaxReceiverConf
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.models.receiver import Receiver, ReceiverConf
from gnss_sim_receiver_tpu_torch.utils import geodesy
from tests.fixtures import FS, RX_LLH, static_scenario_capture

PRNS = tuple(range(1, 11))


@pytest.fixture(scope="module")
def runs():
    x, rx_true = static_scenario_capture()
    port = Receiver(ReceiverConf(fs=FS, prns=PRNS, max_channels=8),
                    device="cpu").process_array(x)
    ref = JaxReceiver(JaxReceiverConf(fs=FS, prns=PRNS, max_channels=8)
                      ).process_array(x)
    return port, ref, rx_true


def test_port_static_position_accuracy(runs):
    """tests/test_e2e_position.py:34-60, on the port."""
    run, _, rx_true = runs
    tracked = [p for p, s in zip(run.channel_prns, run.channel_states)
               if s == ChannelState.TRACKING]
    assert sorted(tracked) == [1, 3, 4, 5, 9, 10], run.channel_prns
    assert len(run.ephemerides) >= 5, sorted(run.ephemerides)
    assert len(run.solutions) >= 5
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                    for s in run.solutions])
    err_2d = np.linalg.norm(enu.mean(0)[:2])
    err_3d = np.linalg.norm(enu.mean(0))
    rms_3d = np.sqrt((np.linalg.norm(enu, axis=1) ** 2).mean())
    assert err_2d < 2.0, f"2D {err_2d:.2f} m"
    assert err_3d < 5.0, f"3D {err_3d:.2f} m"
    assert rms_3d < 10.0, f"3D rms {rms_3d:.2f} m"
    v = np.array([s.rx_vel_ecef_ms for s in run.solutions])
    assert np.linalg.norm(v.mean(0)) < 1.0
    last = run.solutions[-1]
    assert last.n_sats >= 5
    assert np.sqrt((last.residuals_m ** 2).mean()) < 5.0
    assert last.gdop < 10.0
    clk = np.array([s.rx_clock_bias_s for s in run.solutions])
    assert np.all(np.abs(clk + 0.06) < 0.005)


def test_port_pseudoranges_match_jax(runs):
    port, ref, _ = runs
    assert port.channel_prns == ref.channel_prns
    assert len(port.solutions) == len(ref.solutions)
    ref_epochs = {round(e.rx_time_s, 6): e for e in ref.observation_epochs}
    diffs = []
    per_prn = collections.Counter()
    for e in port.observation_epochs:
        r = ref_epochs.get(round(e.rx_time_s, 6))
        if r is None:
            continue
        both = e.valid & r.valid
        diffs.append(e.pseudorange_m[both] - r.pseudorange_m[both])
        for c in np.flatnonzero(both):
            per_prn[port.channel_prns[c]] += 1
    d = np.concatenate(diffs)
    # every tracked satellite contributes, over most of the run
    assert sorted(per_prn) == [1, 3, 4, 5, 9, 10]
    assert len(d) > 5000
    assert np.sqrt(np.mean(d ** 2)) < 1.0
    assert np.percentile(np.abs(d), 99) < 3.5
    assert np.abs(d).max() < 6.0
