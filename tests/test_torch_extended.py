"""Extended coherent integration and secondary-code sync at engine level:
the port's TrackingEngine.process (the per-epoch path, K2 and K9's plain
versions on the CPU) against the JAX engine's on the captures of
tests/test_extended_tracking.py (GPS bit sync, 34 and 45 dB-Hz) and
tests/test_secondary_code.py (a 1 ms pilot carrying only the NH20
secondary), tracked for N = 1500 of the JAX tests' 3000 epochs (the 34
dB-Hz jitter test for all 3000: its extended loops settle late).

Held equal: bit_synced, bit_phase, sec_synced, sec_off, lock_lost.  The
Doppler of each of the last TAIL epochs within DOP_TOL of the JAX
engine's (measured 0.03 to 0.52 Hz).  Before that the two trajectories may
part for a while: the correlation sums run in another order, now and then
the float32 code rate rounds one ulp the other way, and at 34 to 36 dB-Hz
the FLL and PLL pull-in carry that apart (measured up to 38 Hz at epoch
286) before they rejoin.  Each JAX test's own assertions hold on the
port's outputs: not lost, synced, the bit phase and secondary offset of
the signal, the Doppler mean within 3 Hz over the last 500 epochs, the
jitter cut by the extension (at the JAX tests' ratios), the raw prompt
signs following the NH pattern.  The port's prompt is the transfer's int8
symbol plane (its signs are the prompt's).
"""

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from tests.test_secondary_code import NH20, _pilot_scenario

FS = 2_000_000.0
CODE_RATE = 1.023e6
N = 1500
TAIL = 500
DOP_TOL = 1.0


def _run_both(conf_kw, prn, doppler0, start, x, n=N):
    """Both engines armed alike on `x`, n epochs: [(outputs, engine)]."""
    out = []
    # two intra-op threads: the suite runs this file beside other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for trk, kw in ((jtrk, {}), (ptrk, {"device": "cpu"})):
            eng = trk.TrackingEngine(trk.TrackingConf(fs=FS, **conf_kw),
                                     [prn], **kw)
            eng.start_tracking(0, doppler0, start)
            out.append((eng.process(x, 0, n), eng))
    finally:
        torch.set_num_threads(threads)
    return out


def _field(eng, name):
    return np.asarray(getattr(eng.state, name))[0]


def _compare(pair, fields):
    (oj, ej), (op, ep) = pair
    for name in fields + ("lock_lost",):
        assert _field(ej, name) == _field(ep, name), name
    d = np.abs(np.asarray(oj["carrier_doppler_hz"])[-TAIL:, 0]
               - op["carrier_doppler_hz"][-TAIL:, 0])
    assert d.max() < DOP_TOL, d.max()
    return op, ep


def _ext_conf(ext):
    return dict(extend_correlation_symbols=ext, fll_pullin_epochs=400,
                pll_bw_hz=25.0, carrier_lock_threshold=0.80)


def _gps_capture(cn0, dop, delay_chips, seed_bits, seed):
    rng = np.random.default_rng(seed_bits)
    bits = (rng.integers(0, 2, 1500) * 2 - 1).astype(np.int8)
    sat = SatelliteSignalParams(prn=7, cn0_db_hz=cn0, doppler_hz=dop,
                                delay_chips=delay_chips, nav_bits=bits)
    return generate_baseband([sat], FS, int(FS * 3.2), noise=True, seed=seed)


def test_extended_integration_reduces_jitter_like_jax():
    """test_extended_tracking.py:test_extended_integration_reduces_jitter_
    at_low_cn0, both packages."""
    x = _gps_capture(34.0, 800.0, 300.0, 6, 2)
    start = int(round(300.0 * FS / CODE_RATE))
    op1, ep1 = _compare(_run_both(_ext_conf(1), 7, 860.0, start, x, 3000),
                        ())
    op10, ep10 = _compare(_run_both(_ext_conf(10), 7, 860.0, start, x, 3000),
                          ("bit_synced", "bit_phase"))
    assert not _field(ep1, "lock_lost") and not _field(ep10, "lock_lost")
    assert _field(ep10, "bit_synced") and _field(ep10, "bit_phase") == 0
    d1 = op1["carrier_doppler_hz"][-500:, 0]
    d10 = op10["carrier_doppler_hz"][-500:, 0]
    assert abs(d1.mean() - 800.0) < 3.0
    assert abs(d10.mean() - 800.0) < 3.0
    assert d10.std() < 0.5 * d1.std(), (d1.std(), d10.std())


def test_bit_phase_matches_signal_delay_like_jax():
    """test_extended_tracking.py:test_bit_phase_matches_signal_delay: a
    delay of 5.5 code periods puts the bit starts on epoch % 20 == 5."""
    x = _gps_capture(45.0, -500.0, 5.5 * 1023, 9, 3)
    start = int(round(0.5 * 1023 * FS / CODE_RATE))
    _, ep = _compare(_run_both(_ext_conf(10), 7, -440.0, start, x),
                     ("bit_synced", "bit_phase"))
    assert _field(ep, "bit_synced") and _field(ep, "bit_phase") == 5


def _pilot_conf(ext):
    """tests/test_secondary_code.py's pilot conf."""
    return dict(secondary_code=tuple(NH20), extend_correlation_symbols=ext,
                enable_fll_pullin=False, pll_bw_hz=20.0,
                fll_pullin_epochs=300, pll_bw_narrow_hz=8.0)


@pytest.fixture(scope="module")
def nh20_42():
    return _pilot_scenario()


def test_secondary_sync_and_wipeoff_like_jax(nh20_42):
    """test_secondary_code.py:test_secondary_sync_and_wipeoff."""
    start = int(round(250.0 * FS / CODE_RATE))
    op, ep = _compare(_run_both(_pilot_conf(1), 9, 910.0, start, nh20_42),
                      ("sec_synced", "sec_off"))
    assert _field(ep, "sec_synced") and not _field(ep, "lock_lost")
    assert _field(ep, "sec_off") == 0
    signs = np.sign(op["prompt"][-400:, 0])
    pattern = np.tile(2 * np.array(NH20) - 1, 20)[: len(signs)]
    agreement = (signs == pattern).mean()
    assert agreement > 0.99 or agreement < 0.01


def test_secondary_enables_extended_integration_like_jax():
    """test_secondary_code.py:test_secondary_enables_extended_integration
    (36 dB-Hz)."""
    x = _pilot_scenario(cn0=36.0)
    start = int(round(250.0 * FS / CODE_RATE))
    op1, _ = _compare(_run_both(_pilot_conf(1), 9, 910.0, start, x),
                      ("sec_synced", "sec_off"))
    op20, ep20 = _compare(_run_both(_pilot_conf(20), 9, 910.0, start, x),
                          ("sec_synced", "sec_off"))
    assert _field(ep20, "sec_synced") and not _field(ep20, "lock_lost")
    d1 = op1["carrier_doppler_hz"][-600:, 0]
    d20 = op20["carrier_doppler_hz"][-600:, 0]
    assert abs(d20.mean() - 900.0) < 3.0
    assert d20.std() < 0.6 * d1.std(), (d1.std(), d20.std())
