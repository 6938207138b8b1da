"""The PyTorch port's Galileo E5a non-coherent I/Q acquisition (kernel
K4c's path) against the JAX package on the CPU.

- The plain grid ``pcps_e5a_noncoherent_iq_grid`` on tests/test_acq_
  variants.py:96's capture (E5a-I PRN 3, 47 dB-Hz, 12.5 Msps, M=2, D=33)
  with the CAF boxcar of b = 0, 1 and 2 Doppler bins: within 1e-4 of the
  grid's max (two float32 FFT libraries), the same peak cell.
- K4c's plain version on the [M, C, D, 2, N] planes of the port's search
  against the statistic of the port's JAX-form grid: the same cells, the
  statistic to 1e-5 of itself (one FFT batched, the other not).
- The engine's iq_caf search against the JAX ``_acquire_dual`` on the
  capture of tests/test_acq_variants.py:267 (PRN 4 present, PRN 27 not),
  from a host array and from a tensor: the same detections, Doppler, delay
  and threshold, the statistic to 1e-4.
- The factory: Galileo_E5a_Noncoherent_IQ_Acquisition_CAF with
  CAF_window_hz -> iq_caf and caf_bins (tests/test_acq_variants.py:296-
  308), the E5a-Q family attached, the conf equal to the JAX factory's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models.acquisition import AcqConf as JAcqConf
from gnss_sim_receiver_tpu.models.acquisition import \
    PcpsAcquisitionEngine as JEngine
from gnss_sim_receiver_tpu.models.factory import \
    receiver_conf_from_config as jconf_from
from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JConfig
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch import signals as psig
from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf
from gnss_sim_receiver_tpu_torch.models.acquisition import \
    PcpsAcquisitionEngine as PEngine
from gnss_sim_receiver_tpu_torch.models.factory import \
    receiver_conf_from_config
from gnss_sim_receiver_tpu_torch.ops import pcps as ppcps
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration

RATE = 10.23e6


@pytest.fixture(scope="module")
def iq():
    """tests/test_acq_variants.py:96's dwells and the E5a-I and E5a-Q
    replicas of PRN 3 (present) and PRN 27 (absent)."""
    fs = 12_500_000.0
    n = int(fs * 1e-3)
    sat = SatelliteSignalParams(prn=3, system="Galileo", signal="5X",
                                cn0_db_hz=47.0, doppler_hz=-1800.0,
                                delay_chips=5000.25,
                                nav_bits=np.ones(40, np.int8))
    x = generate_baseband([sat], fs, 3 * n, noise=True, seed=5)

    def cfc(component):
        codes = np.stack([jpc.sample_code(
            jsig.galileo_e5a_code(p, component).astype(np.float32), fs,
            RATE, n) for p in (3, 27)])
        return np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)
    return dict(x=x[:2 * n].reshape(2, n), n=n, fs=fs, ci=cfc("I"),
                cq=cfc("Q"),
                dops=jpcps.doppler_grid(4000.0, 250.0))


def _peak_cell(g):
    return np.unravel_index(int(np.argmax(g)), g.shape)


@pytest.mark.parametrize("caf_bins", [0, 1, 2])
def test_iq_grid_matches_jax(iq, caf_bins):
    args = ("x", "ci", "cq", "dops")
    want = np.asarray(jpcps.pcps_e5a_noncoherent_iq_grid(
        *(jnp.asarray(iq[a]) for a in args), iq["fs"], caf_bins=caf_bins))
    got = ppcps.pcps_e5a_noncoherent_iq_grid(
        *(torch.from_numpy(iq[a]) for a in args), iq["fs"],
        caf_bins=caf_bins).numpy()
    assert got.shape == want.shape == (2, 33, iq["n"])
    assert np.abs(got - want).max() < 1e-4 * want.max()
    cell = _peak_cell(want)
    assert _peak_cell(got) == cell and cell[0] == 0          # PRN 3
    assert abs(float(iq["dops"][cell[1]]) + 1800.0) <= 250.0
    assert abs(cell[2] - 5000.25 / RATE * iq["fs"]) <= 3.0
    # the boxcar keeps the Doppler edges zero-padded: the edge row of the
    # smoothed grid is the sum of its in-range neighbours over 2b + 1
    if caf_bins:
        raw = ppcps.pcps_e5a_noncoherent_iq_grid(
            *(torch.from_numpy(iq[a]) for a in args), iq["fs"]).numpy()
        edge = raw[:, :caf_bins + 1].sum(axis=1) / (2 * caf_bins + 1)
        assert np.allclose(got[:, 0], edge, rtol=1e-5, atol=0)


@pytest.mark.parametrize("caf_bins", [0, 1, 2])
def test_k4c_plain_is_the_grid_statistic(iq, caf_bins):
    """K4c's plain version on the port's [M, C, D, 2, N] planes equals
    max_to_input_power_stat of the plain grid with n_eff = 2 M, the
    opposite row taken from the smoothed grid."""
    m, n, fs = 2, iq["n"], iq["fs"]
    x = torch.from_numpy(iq["x"])
    ci, cq = torch.from_numpy(iq["ci"]), torch.from_numpy(iq["cq"])
    dops = torch.from_numpy(iq["dops"])
    t = ppcps.time_axis(n, fs, "cpu")
    corr = ppcps.dual_correlations(x, ci, cq, dops, t, "iq_caf")
    assert corr.shape == (m, 2, 33, 2, n)
    stat, di, de = ppcps.pcps_caf_peak(corr, m, caf_bins)
    grid = ppcps.pcps_e5a_noncoherent_iq_grid(x, ci, cq, dops, fs, caf_bins)
    ws, wd, we = ppcps.max_to_input_power_stat(grid, float(2 * m))
    assert torch.equal(di, wd) and torch.equal(de, we)
    assert torch.allclose(stat, ws, rtol=1e-5)
    # and the JAX package's statistic of its own grid
    jg = jpcps.pcps_e5a_noncoherent_iq_grid(
        jnp.asarray(iq["x"]), jnp.asarray(iq["ci"]), jnp.asarray(iq["cq"]),
        jnp.asarray(iq["dops"]), fs, caf_bins=caf_bins)
    js, jd, je = (np.asarray(v) for v in
                  jpcps.max_to_input_power_stat(jg, jnp.float32(2 * m)))
    assert np.array_equal(di.numpy(), jd) and np.array_equal(de.numpy(), je)
    assert np.allclose(stat[0].item(), js[0], rtol=1e-4)
    buf = ppcps.pcps_search_iq_caf(x, ci, cq, dops, t, caf_bins)
    assert buf.shape == (4, 2) and not buf[3].any()
    assert torch.equal(buf[1], dops[wd.long()])


def _e5a_capture():
    """tests/test_acq_variants.py:267's capture: PRN 4 at 2250 Hz,
    46 dB-Hz, 12 Msps."""
    fs = 12_000_000.0
    sat = SatelliteSignalParams(prn=4, system="Galileo", signal="5X",
                                cn0_db_hz=46.0, doppler_hz=2250.0,
                                delay_chips=5000.0,
                                nav_bits=np.ones(50, np.int8))
    n = int(fs * 1e-3)
    return generate_baseband([sat], fs, 4 * n, noise=True, seed=23), fs


@pytest.mark.parametrize("source", ["host", "tensor"])
def test_acquire_iq_caf_matches_jax(source):
    x, fs = _e5a_capture()
    kw = dict(fs_in=fs, doppler_max=5000.0, doppler_step=250.0,
              max_dwells=2, pfa=0.01, variant="iq_caf", caf_bins=1)
    sig = jsig.GALILEO_E5A_I
    je = JEngine(JAcqConf(**kw), prns=[4, 27],
                 code_provider=lambda p: jsig.subchip_table(sig, p),
                 sc_rate=sig.chip_rate_cps,
                 code_provider2=lambda p: jsig.galileo_e5a_code(p, "Q"))
    pe = PEngine(AcqConf(**kw), prns=[4, 27],
                 code_provider=psig.CodeProvider("5X"),
                 sc_rate=psig.GALILEO_E5A_I.chip_rate_cps,
                 code_provider2=psig.CodeProvider("5X", "Q"), device="cpu")
    assert pe.n_samples_needed == je.n_samples_needed
    start = 301
    want = je.acquire_from(x, start)
    got = pe.acquire_from(x if source == "host" else torch.from_numpy(x),
                          start)
    assert got.samplestamp == want.samplestamp == start
    assert list(got.detected) == list(want.detected) == [True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    # the unsplit Pfa at 2 M correlations per cell
    assert got.threshold == want.threshold == pe.threshold
    assert abs(got.doppler_hz[0] - 2250.0) <= 500.0


@pytest.mark.parametrize("impl,window,variant,bins", [
    ("Galileo_E5a_Noncoherent_IQ_Acquisition_CAF", "1000", "iq_caf", 2),
    ("Galileo_E5a_Noncoherent_IQ_Acquisition_CAF", "500", "iq_caf", 1),
    ("Galileo_E5a_Pcps_Acquisition", "0", "pcps", 0),
])
def test_factory_strings_like_jax(impl, window, variant, bins):
    props = {"GNSS-SDR.internal_fs_sps": "12000000",
             "Channels_5X.count": "2",
             "Acquisition_5X.implementation": impl,
             "Acquisition_5X.CAF_window_hz": window,
             "Acquisition_5X.doppler_step": "250"}
    got = receiver_conf_from_config(InMemoryConfiguration(props))
    (chain,) = got.chains
    assert chain.acq.variant == variant and chain.acq.caf_bins == bins
    assert (chain.data_code_provider == psig.CodeProvider("5X", "Q")) \
        == (variant == "iq_caf")
    ref = jconf_from(JConfig(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))


@pytest.mark.parametrize("props,key", [
    ({"Channels_1C.count": "4", "Channels_L5.count": "4"},
     "Channels_L5"),
    ({"Channels_1B.count": "4", "Channels_5X.count": "4"},
     "Channels_5X"),
    ({"Channels_5X.count": "4", "Channels_5X.RF_channel_ID": "1"},
     "Channels_5X.RF_channel_ID"),
])
def test_wideband_refusals(props, key):
    """The confs these cases once refused (a wideband chain beside another
    band of its own system, where the Doppler-assisted secondary-band gate
    acts, and a second RF channel) now build the JAX factory's
    configuration: the gated chain keeps assist_wait, the RF channel and
    its rate (internal_fs_sps, no sample_rate_rf1) reach the chain and
    ReceiverConf.rf_fs."""
    got = receiver_conf_from_config(InMemoryConfiguration(props))
    ref = jconf_from(JConfig(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    chain = {c.signal: c for c in got.chains}[key.split("_")[1][:2]]
    if "RF" in key:
        assert chain.rf_channel_id == 1 and got.rf_fs == {1: 2_000_000.0}
    else:
        assert chain.assist_wait and len(got.all_chains()) == 2
