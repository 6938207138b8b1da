"""The block step's pilot form on the CPU against the JAX package.

A track_pilot chain (galileo_e1b_chain(track_pilot=True), the reference's
default E1 configuration) at extend_correlation_symbols=1 closes its loops
on the block kernel: the loops on the E1-C pilot with the block's CS25
secondary-code sync and wipeoff, the E1-B data prompt at the prompt lag for
I/NAV.  The port's plain versions (K8a's two replica families, K1's data
prompt column, K8b's sync) run against the JAX block scan
(tracking_block.py:148-593 with sec_code and data_codes_rep):

- ``track_chunk_blocks`` at Galileo E1, 4 Msps, 2 channels (PRNs 11 and 14
  carrying both components at -3 dB each, 48 dB-Hz in all, with noise),
  armed on truth, 8 blocks of 5 epochs: the CS25 is planted in the pilot's
  signs and both channels sync inside the chunk.  With the decision-
  directed FLL (the chain's) and with the four-quadrant one, which takes
  the two-quadrant form until the sync (the JAX body's secondary branch);
- its packed-decim entry, byte layout and contents;
- the sync threshold: a planted sign history one and two signs off, block
  by block, syncs at the same blocks as JAX;
- the receiver: tests/test_track_pilot.py's scenario (one satellite, 4 Msps,
  16 s) through both packages at extend 1.

Tolerances, measured on these inputs and set a few times above: the
sec_* fields (sync, offset, polarity, the sign history), the active set,
positions, epochs, bit sync and the block counter equal; the data prompt
within 0.2 % of the mean prompt at most and 0.03 % in the median; sample
bookkeeping identical; Doppler within 0.01 Hz; code boundary within 0.03
sample (test_torch_tracking.py's block bounds: the correlation sums run
in another order in the two packages).  The receivers: the same channel
state, sec_synced and I/NAV ephemeris; the prompts of the common epochs
within 2 % of the mean prompt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu.models import tracking as jtrk
from gnss_sim_receiver_tpu.models import tracking_block as jtb
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.models import tracking_block as ptb
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from tests.test_torch_tracking import _compare_outputs, _compare_packed

FS = 4_000_000.0
PRNS = [11, 14]
DOPS = [1625.0, -2125.0]
DELAYS = [5021, 11790]          # samples
S0 = 16000
E = 5
N_BLOCKS = 8
START = 3                       # epochs into the signal


def _scenario(fll_decision: bool):
    """Both E1 components of PRNs 11 and 14 (E1-B random symbols, E1-C the
    CS25 chips) with noise, the pilot chain's conf and tables, the state
    armed on truth."""
    rng = np.random.default_rng(31)
    kw = dict(prns=PRNS, n_channels=2, track_pilot=True,
              very_early_late_space_chips=1.2,
              fll_decision_directed=fll_decision)
    chain = jrx.galileo_e1b_chain(FS, **kw)
    jconf, pconf = chain.trk, prx.galileo_e1b_chain(FS, **kw).trk
    cs25 = jsig.e1c_secondary_code().astype(np.int8)
    half = 10.0 * np.log10(0.5)
    sats = []
    for p, d, n in zip(PRNS, DOPS, DELAYS):
        kw = dict(prn=p, system="Galileo", cn0_db_hz=48.0 + half,
                  doppler_hz=d, delay_chips=n * 1.023e6 / FS)
        sats += [SatelliteSignalParams(
                     signal="1B", nav_bits=np.where(rng.random(80) < 0.5, 1,
                                                    -1).astype(np.int8), **kw),
                 SatelliteSignalParams(signal="1P", nav_bits=np.tile(cs25, 4),
                                       **kw)]
    n = max(DELAYS) + (START + N_BLOCKS * E + 4) * S0 + 40000
    x = generate_baseband(sats, FS, n, noise=False)
    x = (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         * np.float32(0.3 * np.abs(x).std())).astype(np.complex64)

    def tables(provider):
        return np.stack([jpc.bandlimited_table_normalized(
            np.asarray(provider(p), np.float32), FS, jconf.code_rate_cps, S0,
            8) for p in PRNS])
    d, dv = jconf.early_late_space_chips, jconf.very_early_late_space_chips
    st = jtrk._init_state(len(PRNS))
    for ch, dop in enumerate(DOPS):
        st = jtrk._arm_channel(st, ch, dop, jconf.code_rate_cps
                               * (1.0 + dop / jconf.carrier_freq_hz))
    pos = np.asarray(DELAYS, np.int64) + START * S0
    st = st._replace(pos=jnp.asarray(pos.astype(np.int32)),
                     rem_carr_phase=jnp.asarray(np.mod(
                         2.0 * np.pi * np.asarray(DOPS) * pos / FS,
                         2.0 * np.pi).astype(np.float32)))
    return dict(x=x, jconf=jconf, pconf=pconf, jst=st,
                pst=interop.track_state_from_numpy(
                    interop.track_state_to_numpy(st), "cpu"),
                pilot=tables(chain.code_provider),
                data=tables(chain.data_code_provider),
                sec=ptrk.secondary_pm1(pconf),
                taps=np.array([dv, d / 2, 0.0, -d / 2, -dv], np.float32))


@pytest.fixture(scope="module", params=["decision", "four_quadrant"])
def scenario(request):
    return _scenario(request.param == "decision")


def _jax_args(c):
    return (jtb.code_spectra(c["jconf"], c["pilot"]), jnp.asarray(c["taps"]),
            jnp.asarray(c["x"]), c["jst"])


def _port_args(c):
    return (ptb.code_spectra(c["pconf"], c["pilot"], "cpu"),
            torch.from_numpy(c["taps"]), torch.from_numpy(c["x"]), c["pst"])


def _pilot_kw(c, jax: bool):
    if jax:
        return dict(sec_code=jnp.asarray(c["sec"]),
                    data_codes_rep=jtb.code_spectra(c["jconf"], c["data"]))
    return dict(sec_code=torch.from_numpy(c["sec"]),
                data_codes_rep=ptb.code_spectra(c["pconf"], c["data"], "cpu"))


def test_block_pilot_chunk_matches_jax(scenario):
    """8 blocks of the pilot form: both channels sync in the chunk, at the
    same offset and polarity as JAX, and every plane and state field
    agrees within the stated tolerances."""
    c = scenario
    sj, oj = jtb.track_chunk_blocks(c["jconf"], N_BLOCKS, E, *_jax_args(c),
                                    **_pilot_kw(c, True))
    sp, op = ptb.track_chunk_blocks(c["pconf"], N_BLOCKS, E, *_port_args(c),
                                    **_pilot_kw(c, False))
    dj = interop.track_state_to_numpy(sj)
    dp = interop.track_state_to_numpy(sp)
    assert dp["sec_synced"].all(), dp["sec_synced"]
    for k in ("sec_synced", "sec_off", "sec_polarity", "sec_buf", "active",
              "pos", "epoch", "lock_lost", "ext_n", "bit_synced"):
        assert np.array_equal(dj[k], dp[k]), (k, dj[k], dp[k])
    _compare_outputs(oj, op, prompt_max=0.002, prompt_med=0.0003,
                     pos_tol=0, dop_tol=0.01, boundary_tol=0.03)
    assert np.abs(dj["carrier_doppler"] - dp["carrier_doppler"]).max() < 0.01


def test_block_pilot_prompt_plane_is_the_data_prompt(scenario):
    """The prompt plane of the pilot form is the data prompt (K1's column
    K); the pilot prompt it closes on, wiped, is the prompt_prev it
    commits.  On the card's tensors the split path (plain K8a, FFT, K1's
    wrapper, plain K8b) gives the chunk's planes."""
    c = scenario
    conf = c["pconf"]
    rep, taps, x, st = _port_args(c)
    kw = _pilot_kw(c, False)
    reps, sec = ptb._pilot_tables(rep, kw["sec_code"], kw["data_codes_rep"])
    assert reps.shape == (2, 2, ptb.block_fft_size(conf))
    xf_all = ptb._window_spectra(x, S0, ptb.block_fft_size(conf))
    pro = ptb._block_prologue_plain(conf, E, reps, taps, xf_all.shape[0], st)
    assert pro.rep_t.shape == reps.shape
    rf = torch.conj_physical(torch.fft.fft(pro.rep_t, dim=-1))
    corr = ptb.block_correlate(xf_all, rf, pro.w0, pro.lag_int, pro.lag_frac,
                               pro.ph_sc, pro.tap_samps, pro.omega)
    assert corr.shape == (2, E, 6)
    alone = ptb._block_correlate_plain(xf_all, rf[0], pro.w0, pro.lag_int,
                                       pro.lag_frac, pro.ph_sc, pro.tap_samps,
                                       pro.omega)
    assert torch.equal(corr[:, :, :5], alone)
    new, outs = ptb._block_closure_plain(conf, E, corr, pro, st, sec)
    assert torch.equal(outs["prompt"], corr[:, :, 5].T)
    # no sync in the first block (the history is empty): no wipe
    assert not new.sec_synced.any()
    assert torch.equal(new.prompt_prev, corr[:, -1, 2])
    folded_st, folded = ptb._chunk_plain_folded(conf, 3, E, reps, taps,
                                                xf_all, st, sec)
    plain_st, plain = ptb._chunk_plain(conf, 3, E, reps, taps, xf_all, st,
                                       sec)
    for k in plain:
        assert torch.equal(folded[k], plain[k]), k
    for k, v in interop.track_state_to_numpy(plain_st).items():
        assert np.array_equal(interop.track_state_to_numpy(folded_st)[k], v)


def test_block_pilot_packed_decim_matches_jax(scenario):
    """The single int32 transfer of a pilot chunk, byte layout and
    contents (the symbols are the data prompt's)."""
    c = scenario
    decim = 5
    _, bj = jtb.track_chunk_blocks_packed_decim(
        c["jconf"], N_BLOCKS, E, decim, *_jax_args(c), **_pilot_kw(c, True))
    _, bp = ptb.track_chunk_blocks_packed_decim(
        c["pconf"], N_BLOCKS, E, decim, *_port_args(c),
        **_pilot_kw(c, False))
    _compare_packed(np.asarray(bj), bp, N_BLOCKS * E, len(PRNS), decim)


# channel -> the history epochs (before the arm) whose planted CS25 sign is
# wrong, and the block at which the sync must then hit: one wrong sign keeps
# the best match at n_sec - 2 until it leaves the last n_sec epochs
SYNC_WRONG = {0: (-10,), 1: (-20, -15)}
SYNC_BLOCK = {0: 3, 1: 2}


def planted_history(off, pol, sec, wrong):
    """[C, N_SEC_MAX] sign histories: the 20 epochs before the arm carry
    the CS25 chips at each channel's offset and polarity (where the chunk
    syncs unplanted), with the `wrong` epochs' signs flipped."""
    n = len(sec)
    k = np.arange(-20, 0)
    hist = np.zeros((len(off), ptrk.N_SEC_MAX), np.float32)
    for ch in range(len(off)):
        hist[ch, -20:] = pol[ch] * sec[(k + off[ch]) % n]
        for w in wrong.get(ch, ()):
            hist[ch, w] *= -1.0
    return hist


def test_block_pilot_sync_threshold_matches_jax(scenario):
    """The block's CS25 sync hits when the best cyclic match reaches n_sec
    (25).  A planted sign history, right but for one sign on channel 0 and
    two on channel 1, holds the match at 23 and 21 for the first blocks:
    JAX syncs channel 0 at block 3 and channel 1 at block 2 (unplanted: 4),
    block by block; the port's plain form syncs at the same blocks with the
    same offset and polarity (a threshold of n_sec - 2 would sync them at
    blocks 0 and 1)."""
    c = scenario
    sp, _ = ptb.track_chunk_blocks(c["pconf"], 5, E, *_port_args(c),
                                   **_pilot_kw(c, False))
    assert bool(sp.sec_synced.all())
    off, pol = sp.sec_off.numpy(), sp.sec_polarity.numpy()
    hist = planted_history(off, pol, c["sec"], SYNC_WRONG)
    rep_j, taps_j, x_j, jst = _jax_args(c)
    rep_p, taps_p, x_p, pst = _port_args(c)
    jst = jst._replace(sec_buf=jnp.asarray(hist))
    pst = pst._replace(sec_buf=torch.from_numpy(hist))
    first = {"jax": {}, "port": {}}
    for b in range(5):
        jst, _ = jtb.track_chunk_blocks(c["jconf"], 1, E, rep_j, taps_j, x_j,
                                        jst, **_pilot_kw(c, True))
        pst, _ = ptb.track_chunk_blocks(c["pconf"], 1, E, rep_p, taps_p, x_p,
                                        pst, **_pilot_kw(c, False))
        for name, st in (("jax", jst), ("port", pst)):
            d = interop.track_state_to_numpy(st) if name == "port" else {
                k: np.asarray(getattr(st, k))
                for k in ("sec_synced", "sec_off", "sec_polarity")}
            for ch in np.flatnonzero(d["sec_synced"]):
                first[name].setdefault(int(ch), (b, int(d["sec_off"][ch]),
                                                 float(d["sec_polarity"][ch])))
    assert first["port"] == first["jax"]
    assert {ch: v[0] for ch, v in first["jax"].items()} == SYNC_BLOCK
    assert all(first["jax"][ch][1:] == (int(off[ch]), float(pol[ch]))
               for ch in SYNC_BLOCK)


def test_block_pilot_refuses_half_a_pilot_on_the_card():
    """The card's pilot form takes the data replica and the secondary code
    together; either alone is refused before anything launches."""
    with pytest.raises(NotImplementedError, match="together"):
        ptb._pilot_form(True, None, "track_chunk_blocks")
    with pytest.raises(NotImplementedError, match="together"):
        ptb._pilot_form(False, torch.ones(25), "track_chunk_blocks")
    assert ptb._pilot_form(True, torch.ones(25), "x")
    assert not ptb._pilot_form(False, None, "x")


# ---- the receiver ---------------------------------------------------------

PILOT_PRN = 11


@pytest.fixture(scope="module")
def receiver_runs():
    from tests.test_track_pilot import _e1_dual_component_capture
    x, _ = _e1_dual_component_capture()

    def conf(rx):
        return rx.ReceiverConf(
            fs=FS, gps_chain=False,
            chains=(rx.galileo_e1b_chain(FS, prns=(PILOT_PRN,), n_channels=1,
                                         track_pilot=True),))
    def recording(session):
        """Record the channel's prompt of every epoch each pulled chunk
        hands the telemetry (the engine's process_end)."""
        eng = session.chains[0].trk
        session.prompts = []
        end = eng.process_end

        def process_end(handle):
            outs = end(handle)
            session.prompts.append(np.where(outs["valid_full"][:, 0],
                                            outs["prompt"][:, 0], np.nan))
            return outs
        eng.process_end = process_end
        session.attach_array(x)
        session.run_to_end()
        session.prompts = np.concatenate(session.prompts)
        return session
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = recording(prx.ReceiverSession(conf(prx), device="cpu"))
    finally:
        torch.set_num_threads(threads)
    ref = recording(jrx.Receiver(conf(jrx)).start_session())
    return port, ref


def test_receiver_pilot_at_extend_1_matches_jax(receiver_runs):
    """tests/test_track_pilot.py's scenario at extend 1 on both packages:
    the channel tracks on the block kernel's pilot form, secondary-syncs
    and decodes the I/NAV ephemeris from the data prompt, as in JAX."""
    port, ref = receiver_runs
    run, want = port.result(), ref.result()
    assert run.channel_states == want.channel_states
    assert run.channel_states[0] == ChannelState.TRACKING
    assert ("Galileo", PILOT_PRN) in run.ephemerides
    assert run.ephemerides[("Galileo", PILOT_PRN)].iod_nav == 55
    sp, sj = port.chains[0].trk.state, ref.chains[0].trk.state
    for name in ("sec_synced", "sec_off", "sec_polarity", "bit_synced",
                 "active", "lock_lost"):
        assert np.asarray(getattr(sp, name))[0] == \
            np.asarray(getattr(sj, name))[0], name
    assert bool(sp.sec_synced[0])
    assert port.chains[0].trk.epochs_dispatched > 0


def test_receiver_pilot_prompts_match_jax(receiver_runs):
    """The prompts (the data prompt, as the telemetry reads it: int8
    symbols times the chunk's scale) of every epoch both receivers
    tracked, within 2 % of the mean prompt."""
    port, ref = receiver_runs
    p, j = port.prompts, ref.prompts
    assert p.shape == j.shape
    both = ~np.isnan(p) & ~np.isnan(j)
    assert np.array_equal(np.isnan(p), np.isnan(j))
    assert both.sum() > 3000
    d = np.abs(p[both] - j[both])
    assert d.max() < 0.02 * np.abs(j[both]).mean(), \
        (d.max(), np.abs(j[both]).mean())
