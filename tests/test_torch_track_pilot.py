"""track_pilot on the port: the loops on the Galileo E1-C pilot (CS25 sync
and wipeoff, groups of 5 epochs coherently integrated), the data-prompt
correlator on E1-B for I/NAV, through the receiver on the CPU (K2 with its
data table and K9, plain versions), on tests/test_track_pilot.py's
capture: one satellite carrying both components at -3 dB each, 4 Msps.

The port runs the pilot chain on the per-epoch kernels only, so both
packages run it at extend_correlation_symbols=5 (at 1 the JAX package
closes it on the block kernel, whose pilot form the port lacks).  On the
whole 16 s capture the port tracks, secondary-syncs and decodes the
satellite's I/NAV ephemeris.  Against the JAX receiver on the first 6 s
(the cut of test_e1_pilot_secondary_sync_engages): the channel states,
sec_synced, sec_off, sec_polarity, bit_synced and the coherent-group
count ext_n equal, the Doppler within 0.5 Hz, the C/N0 within 0.5 dB
(the correlation sums run in another order in the two packages).
"""

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from tests.test_track_pilot import FS, PRN, _e1_dual_component_capture


@pytest.fixture(scope="module")
def pilot_capture():
    return _e1_dual_component_capture()


def _conf(rx):
    return rx.ReceiverConf(
        fs=FS, gps_chain=False,
        chains=(rx.galileo_e1b_chain(FS, prns=(PRN,), n_channels=1,
                                     track_pilot=True,
                                     extend_correlation_symbols=5),))


def _port_session(x):
    # two intra-op threads: the suite runs this file beside other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s = prx.ReceiverSession(_conf(prx), device="cpu")
        s.attach_array(x)
        s.run_to_end()
    finally:
        torch.set_num_threads(threads)
    return s


def test_port_pilot_tracked_synced_inav_decodes(pilot_capture):
    x, _ = pilot_capture
    s = _port_session(x)
    run = s.result()
    assert run.channel_states[0] == ChannelState.TRACKING
    st = s.chains[0].trk.state
    assert bool(st.sec_synced[0]) and bool(st.bit_synced[0])
    # I/NAV ephemeris decoded from the DATA prompt while the loops ran on
    # the pilot
    assert ("Galileo", PRN) in run.ephemerides
    assert run.ephemerides[("Galileo", PRN)].iod_nav == 55


def test_port_pilot_matches_jax_first_6s(pilot_capture):
    x, _ = pilot_capture
    x6 = x[: int(FS * 6)]
    port = _port_session(x6)
    ref = jrx.Receiver(_conf(jrx)).start_session()
    ref.attach_array(x6)
    ref.run_to_end()
    assert port.result().channel_states == ref.result().channel_states
    sp, sj = port.chains[0].trk.state, ref.chains[0].trk.state
    for name in ("sec_synced", "sec_off", "sec_polarity", "bit_synced",
                 "ext_n", "active", "lock_lost"):
        assert np.asarray(getattr(sp, name))[0] == \
            np.asarray(getattr(sj, name))[0], name
    assert bool(sp.sec_synced[0])
    assert abs(float(sp.carrier_doppler[0])
               - float(np.asarray(sj.carrier_doppler)[0])) < 0.5
    assert abs(float(sp.cn0_db_hz[0])
               - float(np.asarray(sj.cn0_db_hz)[0])) < 0.5
