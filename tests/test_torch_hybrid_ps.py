"""The fork's pseudolite hybrid navigation on the port against the JAX
package: models/hybrid.py (the AOWR time-transfer estimator, the ring file
and its two record formats) and the receiver's hybrid mode.

- ``AowrTimeTransfer`` on tests/test_hybrid_ps.py's three feeds
  (convergence, a burst of outliers, a clock jump adopted after
  dev_count_thresh epochs), the same seeded observables into both
  packages' estimators: every state field equal after every update, and
  the clock products equal.  Both are float64 NumPy, so exactly;
- the ring file's bytes after a wrap, and both line formats over values
  that stress the fixed widths, byte for byte;
- hybrid mode on both receivers over the cached static scenario
  (tests.fixtures.static_scenario_capture: 26 s, 6 GPS satellites, 2
  Msps): PRN 10 pinned to channel 7 as the pseudolite channel, rx clock
  propagation after 3 fixes, bias sharing on.  Both runs give the same
  fixes and exclude the same channel; their clock differences and bias
  records agree within 20 ns, the port's pseudorange bound against JAX on
  this capture (tests/test_torch_receiver.py: 6 m max) over c; the bias
  records carry the same GNSS channel's TOW and PRN, never the
  pseudolite's; after propagation starts, every fix holds the clock at
  the last fix's bias plus drift times the interval.
"""

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import hybrid as jhy
from gnss_sim_receiver_tpu.models.receiver import Receiver as JaxReceiver
from gnss_sim_receiver_tpu.models.receiver import \
    ReceiverConf as JaxReceiverConf
from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.models import hybrid as phy
from gnss_sim_receiver_tpu_torch.models.receiver import Receiver, ReceiverConf
from tests.fixtures import FS, static_scenario_capture

C = constants.SPEED_OF_LIGHT_M_S
F_L1 = constants.GPS_L1_FREQ_HZ
_STATE = ("dt_int_s", "_frac_total", "_count", "_dt0_frac_sum", "dt_s",
          "dt0_s", "dt_by_cp_s", "_cp_dev_thresh", "_diff_total",
          "_dev_count", "_new_frac_total", "_new_count", "_new_diff_total",
          "observed")


def _observables(rng, dt_clk_s, n, r_m=0.4, ci0_cycles=12345.678,
                 code_noise_m=0.5):
    """tests/test_hybrid_ps.py:_feed's consistent pseudolite observables:
    code pseudorange with noise, carrier phase on the same clock."""
    out = []
    for _ in range(n):
        dt_true = dt_clk_s + r_m / C
        pr = C * dt_true + rng.standard_normal() * code_noise_m
        out.append((pr, F_L1 * (dt_true - r_m / C) + ci0_cycles))
    return out


# tests/test_hybrid_ps.py's three feeds: (seed, dev_count_thresh, [(clock
# offset s, epochs), ...])
FEEDS = {"convergence": (1, 100, [(0.25, 400)]),
         "outliers": (2, 100, [(0.1, 200), (0.1 + 50.0 / C, 10),
                               (0.1, 50)]),
         "jump": (3, 100, [(0.1, 200), (0.1 + 20.0 / C, 150)])}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_aowr_matches_jax_exactly(feed):
    seed, thresh, segments = FEEDS[feed]
    rng = np.random.default_rng(seed)
    obs = [o for dt, n in segments for o in _observables(rng, dt, n)]
    port = phy.AowrTimeTransfer(phy.AowrConf(r_ps_true_m=0.4,
                                             dev_count_thresh=thresh))
    ref = jhy.AowrTimeTransfer(jhy.AowrConf(r_ps_true_m=0.4,
                                            dev_count_thresh=thresh))
    for pr, ci in obs:
        port.update(pr, ci)
        ref.update(pr, ci)
        for name in _STATE:
            assert getattr(port, name) == getattr(ref, name), name
    assert port.clock_products(1e-3, 345600.0) == \
        ref.clock_products(1e-3, 345600.0)
    # the JAX test's own bound holds on the port
    dt_end = segments[-1][0]
    assert abs(port.dt_s - (dt_end + 0.4 / C)) < 1.0 / C


LINES = [(345600.123, -1.25e-1), (0.0, 0.0), (604799.999999, 1.0 / 3.0),
         (12.5, -7.123456789012345e-9), (123456789.0, 99.9999999999)]
BIAS = [(123456.78, 345600.1, 6.1e-4, 7), (0.004, 1e-3, -2.5e-3, 32),
        (604799.99, 604799.123456789012, 1.0 / 3.0, 1),
        (1e9, 345600.0, 0.0, 10)]


def test_record_formats_match_jax():
    for tow, diff in LINES:
        assert phy.format_clock_difference_line(tow, diff) == \
            jhy.format_clock_difference_line(tow, diff)
    for args in BIAS:
        line = phy.format_rx_clock_bias_line(*args)
        assert line == jhy.format_rx_clock_bias_line(*args)
        assert line.endswith(f",{args[3]:02d}\n")


def test_ring_file_bytes_match_jax(tmp_path):
    line_len = len(phy.format_clock_difference_line(*LINES[0]))
    files = []
    for mod, name in ((phy, "port.csv"), (jhy, "jax.csv")):
        w = mod.RingFileWriter(tmp_path / name, line_len=line_len, n_lines=4)
        for k in range(6):                      # wraps around
            w.write_line(mod.format_clock_difference_line(345600.0 + k,
                                                          0.5 - k))
        with pytest.raises(ValueError, match="bytes"):
            w.write_line("short\n")
        w.close()
        files.append((tmp_path / name).read_bytes())
    assert files[0] == files[1]
    assert len(files[0]) == 4 * line_len and b"345605." in files[0]


# ---- hybrid mode on both receivers ----------------------------------------

PS_CHANNEL, PS_PRN = 7, 10
CLK_AFTER = 3
CLOCK_TOL_S = 20e-9


def _hybrid_kw():
    return dict(fs=FS, prns=tuple(range(1, 11)), max_channels=8,
                pinned_channels={PS_CHANNEL: PS_PRN}, hybrid_mode=True,
                ps_channel=PS_CHANNEL, enable_rx_clock_propagation=True,
                clk_prop_after_n_fixes=CLK_AFTER, share_rx_clock_bias=True)


@pytest.fixture(scope="module")
def hybrid_runs():
    x, _ = static_scenario_capture()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = Receiver(ReceiverConf(**_hybrid_kw()),
                        device="cpu").process_array(x)
    finally:
        torch.set_num_threads(threads)
    ref = JaxReceiver(JaxReceiverConf(**_hybrid_kw())).process_array(x)
    return port, ref


def test_hybrid_fixes_and_exclusion_match_jax(hybrid_runs):
    port, ref = hybrid_runs
    assert port.channel_prns == ref.channel_prns
    assert port.channel_prns[PS_CHANNEL] == PS_PRN
    assert len(port.solutions) == len(ref.solutions) >= 5
    for s, r in zip(port.solutions, ref.solutions):
        assert PS_CHANNEL not in s.used_channels
        assert sorted(s.used_channels) == sorted(r.used_channels)
        assert s.n_sats == r.n_sats


def test_hybrid_clock_products_match_jax(hybrid_runs):
    port, ref = hybrid_runs
    assert len(port.clock_differences) == len(ref.clock_differences) \
        == len(port.solutions)
    d = np.abs(np.array(port.clock_differences)
               - np.array(ref.clock_differences))
    assert d.max() < CLOCK_TOL_S, d.max(axis=0)
    assert len(port.rx_clock_bias_log) == len(ref.rx_clock_bias_log) \
        == len(port.solutions)
    for (t, tow, bias, prn), (tj, towj, biasj, prnj) in zip(
            port.rx_clock_bias_log, ref.rx_clock_bias_log):
        assert prn == prnj != PS_PRN
        assert t == tj
        assert abs(tow - towj) < CLOCK_TOL_S
        assert abs(bias - biasj) < CLOCK_TOL_S


def test_hybrid_clock_propagation_holds_the_clock(hybrid_runs):
    """From fix CLK_AFTER on, each fix's bias is the previous fix's bias
    plus its drift times the interval (both packages)."""
    for run in hybrid_runs:
        sols = run.solutions
        t = [round(s.rx_time_corrected_s + s.rx_clock_bias_s, 6)
             for s in sols]
        held = [sols[k - 1].rx_clock_bias_s
                + sols[k - 1].rx_clock_drift_ss * (t[k] - t[k - 1])
                for k in range(CLK_AFTER, len(sols))]
        got = [s.rx_clock_bias_s for s in sols[CLK_AFTER:]]
        assert len(got) >= 2
        np.testing.assert_allclose(got, held, rtol=0, atol=1e-14)
