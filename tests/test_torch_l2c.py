"""The GPS L2C (CM) chain of the PyTorch port against the JAX package on the
CPU, at small sizes (inputs from a seed with NumPy; tolerances stated per
test):

- the L2 CM code of PRN 1-37 and the engines' sub-chip table, bit for bit;
- the host simulator and K6's plain version on a 2S satellite;
- the two-step acquisition with the doubled FFT (test_cnav_chain.py's
  AcqConf: 1.6 Msps, one 40 ms dwell, 60 Hz then 15 Hz);
- tracking at the 20 ms epoch: 100 epochs per epoch, and a block chunk at
  E = 2 epochs a block with the decimated transfer at decim 4 (what the
  receiver runs at observable_interval_ms = 100);
- the CNAV decoder in its L2C mode (one symbol per 20 ms epoch);
- tests/test_assisted_acq.py's dual-band receiver run, cut to 3 s: the
  L2C chain acquires around the L1 lock scaled by the carrier ratio; and
  the L2C chain alone cold-starts;
- the factory: tests/test_factory_chains.py's MULTI_CONF without the
  chains the port lacks, the BeiDou B1I and B3I chains built.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import factory as jfactory
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import telemetry as jtlm
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.nav import cnav as jcnav
from gnss_sim_receiver_tpu.nav.ephemeris import GpsEphemeris as JEph
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.ops import prn_codes_multi as jpcm
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams as JSat
from gnss_sim_receiver_tpu.sim import device_generator as jdg
from gnss_sim_receiver_tpu.sim import generate_baseband as jgen
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JConfig
from gnss_sim_receiver_tpu_torch import constants, interop, signals
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import factory
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import telemetry as ptlm
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.nav import cnav as pcnav
from gnss_sim_receiver_tpu_torch.nav.ephemeris import GpsEphemeris as PEph
from gnss_sim_receiver_tpu_torch.ops import prn_codes_multi as ppcm
from gnss_sim_receiver_tpu_torch.sim import device_generator as pdg
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    SatelliteSignalParams as PSat
from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
    generate_baseband as pgen
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
from tests.test_torch_device_generator import _assert_agrees
from tests.test_torch_fnav_cnav import GPS_EPH, T0, _run_decoders, _same_eph
from tests.test_torch_tracking import _armed, _compare_outputs, \
    _compare_packed

FS = 1_600_000.0                  # tests/test_cnav_chain.py's rate
F_L2 = 1227.6e6
S0 = 32_000                       # one 20 ms epoch at FS
PRNS = [7, 24]
DOPS = [900.0, -1650.0]
DELAYS = [4321, 17_003]           # samples


def _sats(cls, n_sym: int = 64, seed: int = 5, cn0: float = 50.0):
    """Two L2C satellites with random CNAV symbols, one per 20 ms epoch,
    and Doppler and code Doppler on the L2 carrier."""
    rng = np.random.default_rng(seed)
    return [cls(prn=p, system="GPS", signal="2S", cn0_db_hz=cn0,
                doppler_hz=d, code_doppler_hz=d, carrier_ref_hz=F_L2,
                delay_chips=n * 511_500.0 / FS,
                nav_bits=np.where(rng.random(n_sym) < 0.5, 1,
                                  -1).astype(np.int8))
            for p, d, n in zip(PRNS, DOPS, DELAYS)]


def test_l2cm_codes_and_tables_equal_jax():
    """PRN 1-37 bit for bit; the SignalDef and the sub-chip table are the
    JAX package's; PRN 0 and 38 raise in both."""
    assert dataclasses.astuple(signals.GPS_L2C_CM) == \
        dataclasses.astuple(jsig.GPS_L2C_CM)
    assert signals.SIGNALS["2S"] is signals.GPS_L2C_CM
    for prn in range(1, 38):
        got = ppcm.gps_l2c_m_code(prn)
        assert got.dtype == np.float32 and got.shape == (10230,)
        assert np.array_equal(got, jpcm.gps_l2c_m_code(prn)), prn
        assert np.array_equal(
            signals.subchip_table(signals.GPS_L2C_CM, prn),
            jsig.subchip_table(jsig.GPS_L2C_CM, prn)), prn
        assert np.array_equal(signals.CodeProvider("2S")(prn), got)
    for prn in (0, 38):
        for gen in (ppcm.gps_l2c_m_code, jpcm.gps_l2c_m_code):
            with pytest.raises(ValueError, match="L2C PRN out of range"):
                gen(prn)
    assert (constants.GPS_L2_FREQ_HZ, constants.GPS_L2C_M_CODE_RATE_CPS,
            constants.GPS_L2C_M_CODE_LENGTH_CHIPS) == (
        jconst.GPS_L2_FREQ_HZ, jconst.GPS_L2C_M_CODE_RATE_CPS,
        jconst.GPS_L2C_M_CODE_LENGTH_CHIPS)


def test_host_generator_equals_jax():
    """0.2 s of the two satellites, noiseless, sample for sample."""
    n = int(0.2 * FS)
    want = jgen(_sats(JSat), FS, n, start_sample=12_345, noise=False)
    got = pgen(_sats(PSat), FS, n, start_sample=12_345, noise=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_generator_plain_matches_jax():
    """K6's plain version against the JAX device generator over 0.2 s
    (tests/test_device_generator.py's criteria), its anchors bit for
    bit."""
    nblk = int(0.2 * FS) // 8192
    want = jdg.generate_baseband_device(_sats(JSat), FS, nblk * 8192,
                                        noise=False)
    got = pdg.generate_baseband_device_resident(
        _sats(PSat), FS, nblk * 8192, noise=False, device="cpu").numpy()
    _assert_agrees(got, want)
    for w, g in zip(jdg._anchors(_sats(JSat), FS, 0, nblk, None),
                    pdg._anchors(_sats(PSat), FS, 0, nblk, None)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_acquisition_matches_jax():
    """The L2C search of tests/test_cnav_chain.py on 45 ms of the two
    satellites at 45 dB-Hz in noise: the same detections, Doppler (15 Hz
    step two) and delay, the statistic to 1e-4; PRN 7 within one step-two
    bin of the truth and two samples of its delay."""
    acq_kw = dict(fs_in=FS, sampled_ms=20, doppler_max=2000.0,
                  doppler_step=60.0, max_dwells=1, make_two_steps=True,
                  doppler_step2=15.0, bit_transition_flag=True)
    x = jgen(_sats(JSat, cn0=45.0), FS, int(0.045 * FS), noise=True,
             seed=3)
    je = jacq.PcpsAcquisitionEngine(
        jacq.AcqConf(**acq_kw), prns=[7, 24, 9],
        code_provider=lambda p: jsig.subchip_table(jsig.GPS_L2C_CM, p),
        sc_rate=jsig.GPS_L2C_CM.chip_rate_cps)
    pe = pacq.PcpsAcquisitionEngine(
        pacq.AcqConf(**acq_kw), prns=[7, 24, 9],
        code_provider=signals.CodeProvider("2S"),
        sc_rate=signals.GPS_L2C_CM.chip_rate_cps, device="cpu")
    assert pe.fft_size == je.fft_size == 2 * S0
    want, got = je.acquire(x), pe.acquire(x)
    assert list(got.detected) == list(want.detected) == [True, True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    assert got.threshold == want.threshold
    assert abs(got.doppler_hz[0] - DOPS[0]) <= 16.0
    err = abs(got.delay_samples[0] - DELAYS[0])
    assert min(err, S0 - err) <= 2.0


@pytest.fixture(scope="module")
def clean():
    """The two satellites noise-free at 50 dB-Hz with a random CNAV symbol
    on every epoch, armed on truth, under gps_l2c_chain's tracking conf
    (FLL pull-in, 8 Hz PLL, 0.75 Hz DLL, 20-epoch C/N0 window)."""
    n_ep = 100
    x = jgen(_sats(JSat, n_sym=n_ep + 8), FS,
             max(DELAYS) + (n_ep + 4) * S0 + 4096, noise=False)
    jconf = jrx.gps_l2c_chain(FS).trk
    pconf = prx.gps_l2c_chain(FS).trk
    for f in dataclasses.fields(pconf):
        assert getattr(pconf, f.name) == getattr(jconf, f.name), f.name
    st = _armed(jconf, PRNS, DOPS, DELAYS)
    tables = np.stack([jpc.bandlimited_table_normalized(
        jpcm.gps_l2c_m_code(p), FS, jconf.code_rate_cps, S0) for p in PRNS])
    return dict(x=x, jconf=jconf, pconf=pconf, jst=st, n_ep=n_ep,
                pst=interop.track_state_from_numpy(
                    interop.track_state_to_numpy(st), "cpu"),
                tables=tables, taps=np.array([0.25, 0.0, -0.25], np.float32))


def test_per_epoch_tracking_matches_jax(clean):
    """100 epochs of 20 ms (2 s) on the per-epoch scan, with
    tests/test_torch_tracking.py's per-epoch tolerances: prompt max 2 %,
    median 0.2 % of the mean prompt; epoch ends within one sample; Doppler
    within 0.2 Hz; code boundary within 0.05 sample."""
    c = clean
    sj, oj = jtrk.track_chunk(c["jconf"], c["n_ep"],
                              jnp.asarray(c["tables"]),
                              jnp.asarray(c["taps"]), jnp.asarray(c["x"]),
                              c["jst"])
    sp, op = ptrk.track_chunk(c["pconf"], c["n_ep"],
                              torch.from_numpy(c["tables"]),
                              torch.from_numpy(c["taps"]),
                              torch.from_numpy(c["x"]), c["pst"])
    _compare_outputs(oj, op, prompt_max=0.02, prompt_med=0.002, pos_tol=1,
                     dop_tol=0.2, boundary_tol=0.05)
    assert op["valid"].all()
    dop = op["carrier_doppler_hz"].numpy()[-1]
    assert np.abs(dop - np.asarray(DOPS)).max() < 2.0
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["pos"] - dp["pos"]).max() <= 1


def test_block_chunk_at_two_epochs_matches_jax(clean):
    """The block step at L2C's shape, E = 2 epochs a block (block_epochs
    of a 20 ms epoch), 20 blocks (0.8 s), with the per-epoch tolerances of
    tests/test_torch_tracking.py (prompt max 2 %, median 0.2 % of the mean
    prompt; epoch ends within one sample; Doppler within 0.2 Hz; code
    boundary within 0.05 sample), and the decimated transfer at decim 4
    (every other block keeps no row) against the JAX package's buffer
    (tests/test_torch_tracking.py's packed comparison).  The block
    tolerances of the 2 Msps L1 case do not hold here: under the FLL
    pull-in the JAX loop itself rings (its Doppler swings to +-3 Hz by the
    36th epoch), which grows the float32 rounding differences.  Measured:
    prompt max 0.37 %, median 0.020 %; one epoch end one sample apart;
    Doppler 0.017 Hz; code boundary 0.016 sample."""
    c = clean
    eng = ptrk.TrackingEngine(c["pconf"], PRNS, device="cpu",
                              code_provider=signals.CodeProvider("2S"))
    assert eng.block_epochs == 2
    n_blk, e_blk, decim = 20, 2, 4
    rep = jtb.code_spectra(c["jconf"], c["tables"])
    prep = ptb.code_spectra(c["pconf"], c["tables"], "cpu")
    assert np.array_equal(np.asarray(rep), prep.numpy())
    args_j = (jnp.asarray(c["taps"]), jnp.asarray(c["x"]), c["jst"])
    args_p = (torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]),
              c["pst"])
    sj, oj = jtb.track_chunk_blocks(c["jconf"], n_blk, e_blk, rep, *args_j)
    sp, op = ptb.track_chunk_blocks(c["pconf"], n_blk, e_blk, prep, *args_p)
    _compare_outputs(oj, op, prompt_max=0.02, prompt_med=0.002, pos_tol=1,
                     dop_tol=0.2, boundary_tol=0.05)
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    for k in ("active", "epoch", "lock_lost"):
        assert np.array_equal(dj[k], dp[k]), k
    assert np.abs(dj["pos"] - dp["pos"]).max() <= 1
    _, bj = jtb.track_chunk_blocks_packed_decim(c["jconf"], n_blk, e_blk,
                                                decim, rep, *args_j)
    _, bp = ptb.track_chunk_blocks_packed_decim(c["pconf"], n_blk, e_blk,
                                                decim, prep, *args_p)
    _compare_packed(np.asarray(bj), bp, n_blk * e_blk, len(PRNS), decim)


def test_cnav_l2c_telemetry_like_jax():
    """GpsCnavTelemetryDecoder(signal="2S") in both packages on 20 ms
    prompts built from a 25 bps CNAV stream (one symbol an epoch, cut
    mid-stream, noise, random chunks): equal TOW stamps, each the epoch's
    end in transmit time to 1e-9 ms, and equal ephemerides, tgd
    included."""
    sym = pcnav.symbols_for_ephemeris(PEph(**GPS_EPH), T0, n_repeats=2,
                                      bps=25.0)
    assert np.array_equal(sym, jcnav.symbols_for_ephemeris(
        JEph(**GPS_EPH), T0, n_repeats=2, bps=25.0))
    off = 11
    epochs = (2.0 * sym - 1.0)[off:]
    rng = np.random.default_rng(17)
    soft = 3.0 * epochs + rng.standard_normal(len(epochs))
    chunks = rng.integers(20, 120, len(soft) // 20 + 1)
    decs = (ptlm.GpsCnavTelemetryDecoder([4]),
            jtlm.GpsCnavTelemetryDecoder([4], signal="2S"))
    assert decs[0].signal == "2S"
    (tow_p, new_p), (tow_j, new_j) = _run_decoders(decs, soft, chunks)
    assert len(new_p) == len(new_j) == 1
    _same_eph(new_j[0][1], new_p[0][1])
    assert new_p[0][1].prn == 4
    assert abs(new_p[0][1].tgd - GPS_EPH["tgd"]) < 2.0 ** -34
    assert np.array_equal(np.isnan(tow_p), np.isnan(tow_j))
    m = ~np.isnan(tow_p)
    assert m.sum() > 500 and np.array_equal(tow_p[m], tow_j[m])
    idx = np.flatnonzero(m)
    np.testing.assert_allclose(tow_p[m],
                               T0 * 1000.0 + (off + idx + 1) * 20.0,
                               atol=1e-9)


FS_RX = 2_500_000.0               # tests/test_assisted_acq.py's rate
RX_DUR = 3.0
DOP_L1 = -2613.0
F_RATIO = constants.GPS_L2_FREQ_HZ / constants.GPS_L1_FREQ_HZ


@pytest.fixture(scope="module")
def dual_band():
    """tests/test_assisted_acq.py's capture cut to 3 s: PRN 7 on L1 C/A and
    on L2C (48 dB-Hz, the L2C Doppler the L1 one scaled by the carrier
    ratio)."""
    rng = np.random.default_rng(4)
    bits = (rng.integers(0, 2, 1500) * 2 - 1).astype(np.int8)
    sats = [JSat(prn=7, cn0_db_hz=48.0, doppler_hz=DOP_L1,
                 delay_chips=317.25, nav_bits=bits),
            JSat(prn=7, system="GPS", signal="2S", cn0_db_hz=48.0,
                 doppler_hz=DOP_L1 * F_RATIO, delay_chips=4123.5,
                 nav_bits=bits.copy())]
    return jgen(sats, FS_RX, int(FS_RX * RX_DUR), noise=True, seed=4)


@pytest.fixture
def two_threads():
    """The port's torch on two threads beside the other pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _dual_session(rx_mod, x, **kw):
    conf = rx_mod.ReceiverConf(
        fs=FS_RX, prns=(7,), max_channels=1, max_acq_channels=1,
        chains=(rx_mod.gps_l2c_chain(FS_RX, prns=(7,), n_channels=1),))
    session = rx_mod.Receiver(conf, **kw).start_session()
    session.attach_array(x)
    session.run_to_end()
    return session


def test_dual_band_assisted_acquisition_like_jax(dual_band, two_threads):
    """tests/test_assisted_acq.py's assertions on the port (both bands
    tracking, the L2C search assisted, its centre within 50 Hz of the L1
    Doppler x f_L2 / f_L1, no cold L2C search), and the port against the
    JAX receiver: the same assist log (signal, PRN, detection) with the
    centres within 1 Hz, and each band's last Doppler within 1 Hz."""
    got = _dual_session(prx, dual_band, device="cpu")
    want = _dual_session(jrx, dual_band)
    run = got.result()
    assert all(st == ChannelState.TRACKING
               for st in run.channel_states), run.channel_states
    assert got.assist_log, "no assisted acquisition happened"
    sig, prn, center, detected = got.assist_log[0]
    assert sig == "2S" and prn == 7 and detected
    assert abs(center - DOP_L1 * F_RATIO) < 50.0, center
    assert got.searches[("2S", "assisted")] >= 1
    assert not got.searches[("2S", "cold")]
    assert [e[:2] + e[3:] for e in got.assist_log] == \
        [e[:2] + e[3:] for e in want.assist_log]
    for g, w in zip(got.assist_log, want.assist_log):
        assert abs(g[2] - w[2]) < 1.0, (g, w)
    dops = []
    for session in (got, want):
        dops.append([float(interop.track_state_to_numpy(rt.trk.state)[
            "carrier_doppler"][0]) for rt in session.chains])
    assert np.abs(np.subtract(*dops)).max() < 1.0, dops
    l1, l2 = dops[0]
    assert abs(l2 - l1 * F_RATIO) < 1.0, dops


def test_lone_l2c_chain_cold_starts(dual_band, two_threads):
    """tests/test_assisted_acq.py: with no primary band the assist gate is
    inactive, so the lone L2C chain searches cold and tracks."""
    conf = prx.ReceiverConf(
        fs=FS_RX, gps_chain=False,
        chains=(prx.gps_l2c_chain(FS_RX, prns=(7,), n_channels=1),))
    session = prx.Receiver(conf, device="cpu").start_session()
    session.attach_array(dual_band)
    session.run_to_end()
    run = session.result()
    assert run.channel_states[0] == ChannelState.TRACKING
    assert session.searches[("2S", "cold")] >= 1
    dop, f = session.doppler_map[("GPS", 7)]
    assert f == F_L2 and abs(dop - DOP_L1 * F_RATIO) < 2.0


# the signal groups the port has taken up since this test began (Galileo
# E6-B, GLONASS L1 and L2 C/A, SBAS L1): the port's factory now lacks none
# of the JAX factory's chains; tests/test_factory_chains.py's MULTI_CONF
# holds the first GLONASS one
NEWLY_PORTED = ("E6", "1G", "2G", "S1")


def _multi_conf(add=()):
    """tests/test_factory_chains.py's MULTI_CONF with two channels of each
    signal in `add`."""
    from tests.test_factory_chains import MULTI_CONF
    props = dict(MULTI_CONF)
    props.update({f"Channels_{s}.count": "2" for s in add})
    return props


def test_factory_builds_the_jax_chains():
    """The port's factory gives the JAX factory's chains, compared through
    interop, in its order (ALL_SIGNALS, which Channel<i>.satellite pinning
    counts in), with Tracking_2S.dll_bw_hz = 0.4 on the L2C chain."""
    props = _multi_conf(add=("E6", "2G"))
    ref = jfactory.receiver_conf_from_config(JConfig(props))
    got = factory.receiver_conf_from_config(InMemoryConfiguration(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    # the GLONASS groups as one chain per slot in sorted slot order:
    # Channels_1G.count=3 fills slot -7 (PRNs 10, 14) and -5 (PRN 20),
    # Channels_2G.count=2 slot -7
    assert [c.signal for c in got.chains] == [c.signal for c in ref.chains] \
        == ["1B", "2S", "L5", "5X", "7X", "E6", "1G", "1G", "2G", "B1", "B3"]
    assert [(c.freq_slot, c.n_channels) for c in got.chains
            if c.signal in ("1G", "2G")] == [(-7, 2), (-5, 1), (-7, 2)]
    by_sig = {c.signal: c for c in got.chains}
    assert by_sig["2S"].trk.dll_bw_hz == 0.4
    for sig in ("2S", "7X", "E6", "1G", "2G", "B1", "B3"):
        assert by_sig[sig].code_provider == signals.CodeProvider(sig)
    assert isinstance(by_sig["E6"].telemetry_decoder([1]),
                      ptlm.GalileoE6bTelemetryDecoder)
    assert isinstance(by_sig["2G"].telemetry_decoder([1]),
                      ptlm.GlonassTelemetryDecoder)
    assert not by_sig["B1"].assist_wait and by_sig["B3"].assist_wait
    assert isinstance(by_sig["2S"].telemetry_decoder([1]),
                      ptlm.GpsCnavTelemetryDecoder)
    assert isinstance(by_sig["7X"].telemetry_decoder([1]),
                      ptlm.GalileoE5bTelemetryDecoder)
    for sig in ("B1", "B3"):
        assert isinstance(by_sig[sig].telemetry_decoder([1]),
                          ptlm.BeidouB1iTelemetryDecoder)


@pytest.mark.parametrize("sig", NEWLY_PORTED)
def test_factory_still_refuses_the_other_chains(sig):
    """SBAS L1, once refused by its key alone and beside each chain ported
    since (E6-B, GLONASS L1, L2), now builds: alone and beside each, the
    JAX factory's chains (compared through interop), the S1 chain last in
    ALL_SIGNALS order with the SBAS decoder."""
    props = _multi_conf(add=tuple(sorted({sig, "S1"})))
    ref = jfactory.receiver_conf_from_config(JConfig(props))
    got = factory.receiver_conf_from_config(InMemoryConfiguration(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    s1 = got.chains[-1]
    assert (s1.signal, s1.system, s1.n_channels) == ("S1", "SBAS", 2)
    assert sum(c.signal == "S1" for c in got.chains) == 1
    assert isinstance(s1.telemetry_decoder([120, 133]),
                      ptlm.SbasL1TelemetryDecoder)
