"""The PyTorch port's GPS L1 C/A acquisition variants against the JAX
package on the CPU: QuickSync (kernel K4b's path), Tong and Fine Doppler.

- The folded grid ``pcps_quicksync_grid`` on tests/test_acq_variants.py's
  QuickSync dwells (PRN 7 present, 9 absent; D=41, N=2000, fold 4): within
  1e-4 of the grid's max (two float32 FFT libraries), the same peak cell;
  K4b's fold kernel's plain version, cuFFT and the K3 peak give that grid's
  statistic.
- ``quicksync_resolve`` (the resolve kernel's plain version) at the grid's
  peak, fold 2, 4 and 8 and an exact tie of two candidates: the same
  delays, magnitudes within rtol 1e-4.
- The engines (QuickSync, Tong, Fine Doppler) against the JAX engines on
  the captures of tests/test_acq_variants.py and
  tests/test_factory_chains.py: the same detections, Doppler, delay and
  threshold, the statistic within rtol 1e-4, from a host array and from a
  tensor.
- The four 1C acquisition strings of the JAX factory and their keys.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import factory as jfactory
from gnss_sim_receiver_tpu.models.acquisition import AcqConf as JAcqConf
from gnss_sim_receiver_tpu.models.acquisition import \
    PcpsAcquisitionEngine as JEngine
from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JInMemory
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import factory
from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf
from gnss_sim_receiver_tpu_torch.models.acquisition import \
    PcpsAcquisitionEngine as PEngine
from gnss_sim_receiver_tpu_torch.ops import pcps as ppcps
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
from tests.test_acq_variants import _gps_dwells
from tests.test_factory_chains import _sim_l1

FS = 2_000_000.0
N = 2000
FOLD = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs this file beside other
    workers, and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dwells():
    """tests/test_acq_variants.py's QuickSync dwells (PRN 7, 48 dB-Hz,
    1500 Hz, 612.25 chips; M=2) and the sampled codes of PRNs 7 and 9."""
    x, n = _gps_dwells(delay_chips=612.25, cn0=48.0)
    assert n == N
    codes = np.stack([jpc.sample_code(jpc.gps_l1_ca_code(p), FS, 1.023e6, N)
                      for p in (7, 9)]).astype(np.float32)
    dops = jpcps.doppler_grid(5000.0, 250.0)
    return np.array(x), codes, dops


def test_quicksync_grid_matches_jax(dwells):
    x, codes, dops = dwells
    want = np.asarray(jpcps.pcps_quicksync_grid(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(dops), FS, FOLD))
    got = ppcps.pcps_quicksync_grid(
        torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(dops),
        FS, FOLD).numpy()
    assert got.shape == want.shape == (2, 41, N // FOLD)
    assert np.abs(got - want).max() < 1e-4 * want.max()
    cell = np.unravel_index(int(np.argmax(want)), want.shape)
    assert np.unravel_index(int(np.argmax(got)), got.shape) == cell
    assert cell[0] == 0                                     # PRN 7
    # the port's search: K4b's fold (plain), cuFFT, the K3 peak
    xt, dt = torch.from_numpy(x), torch.from_numpy(dops)
    t = ppcps.time_axis(N, FS, "cpu")
    folded = ppcps.pcps_quicksync_fold(xt, dt, t, FOLD)
    assert folded.shape == (2, 41, N // FOLD)
    cffc = torch.from_numpy(ppcps.fold_codes(codes, FOLD))
    corr = torch.fft.ifft(torch.fft.fft(folded, dim=-1)[:, None]
                          * cffc[None, :, None], dim=-1)
    stat, di, lag = ppcps.pcps_peak(corr, 2)
    ws, wd, wl = jpcps.max_to_input_power_stat(jnp.asarray(want),
                                               jnp.float32(2))
    assert np.array_equal(di.numpy(), np.asarray(wd))
    assert np.array_equal(lag.numpy(), np.asarray(wl))
    assert np.allclose(stat.numpy(), np.asarray(ws), rtol=1e-4)


@pytest.mark.parametrize("m,fold", [(10, 8)])
def test_quicksync_fold_matches_jax_grid(m, fold):
    """K4b's fold kernel's plain version on M = 10 dwells at fold 8 (more
    dwells than one CTA of the CUDA kernel takes), then cuFFT's role, the
    folded replica and |.|^2 summed over the dwells, against the JAX
    folded grid: within 1e-4 of its max (two float32 FFT libraries), the
    same peak cell."""
    x, n = _gps_dwells(delay_chips=612.25, cn0=48.0, m=m)
    x = np.array(x)
    codes = np.stack([jpc.sample_code(jpc.gps_l1_ca_code(p), FS, 1.023e6, N)
                      for p in (7, 9)]).astype(np.float32)
    dops = jpcps.doppler_grid(5000.0, 250.0)
    want = np.asarray(jpcps.pcps_quicksync_grid(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(dops), FS, fold))
    folded = ppcps.pcps_quicksync_fold(
        torch.from_numpy(x), torch.from_numpy(dops),
        ppcps.time_axis(n, FS, "cpu"), fold)
    assert folded.shape == (m, 41, n // fold)
    cffc = torch.from_numpy(ppcps.fold_codes(codes, fold))
    corr = torch.fft.ifft(torch.fft.fft(folded, dim=-1)[:, None]
                          * cffc[None, :, None], dim=-1)
    got = (corr.real ** 2 + corr.imag ** 2).sum(dim=0).numpy()
    assert got.shape == want.shape == (2, 41, n // fold)
    assert np.abs(got - want).max() < 1e-4 * want.max()
    assert (np.unravel_index(int(np.argmax(got)), got.shape)
            == np.unravel_index(int(np.argmax(want)), want.shape))


@pytest.mark.parametrize("fold,tie", [(2, False), (4, False), (8, False),
                                      (2, True)])
def test_quicksync_resolve_matches_jax(dwells, fold, tie):
    """At the folded grid's peak of each channel, fold 2, 4 and 8: the
    same delays, magnitudes within rtol 1e-4.  `tie`: PRN 7's code is
    replaced by its first N/2 samples twice, so that its two candidates
    correlate to the same bits and the first one must win in both
    packages."""
    x, codes, dops = dwells
    if tie:
        codes = codes.copy()
        codes[0] = np.tile(codes[0][:N // 2], 2)
    nf = N // fold
    g = np.asarray(jpcps.pcps_quicksync_grid(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(dops), FS, fold))
    flat = g.reshape(2, -1).argmax(axis=1)
    dop = dops[flat // nf].astype(np.float32)
    lag = (flat % nf).astype(np.int32)
    wd, wm = jpcps.quicksync_resolve(jnp.asarray(x[0]), jnp.asarray(codes),
                                     jnp.asarray(dop), jnp.asarray(lag), FS,
                                     fold=fold)
    gd, gm = ppcps.quicksync_resolve(
        torch.from_numpy(x[0]), torch.from_numpy(codes),
        torch.from_numpy(dop), torch.from_numpy(lag), FS, fold=fold)
    assert np.array_equal(gd.numpy(), np.asarray(wd))
    assert np.allclose(gm.numpy(), np.asarray(wm), rtol=1e-4)
    # the wrapper (plain version on the CPU) on the same inputs
    kd, km = ppcps.pcps_quicksync_resolve(
        torch.from_numpy(x[0]), torch.from_numpy(codes),
        torch.from_numpy(dop), torch.from_numpy(lag),
        ppcps.time_axis(N, FS, "cpu"), fold)
    assert torch.equal(kd, gd) and torch.equal(km, gm)
    if tie:
        assert int(gd[0]) == int(wd[0]) == int(lag[0])
        return
    # the winner of PRN 7 is its absolute delay (roll convention: N - delay)
    exp = 612.25 * FS / 1.023e6
    got = int(gd[0])
    assert min(abs(got - exp), abs(N - got - exp)) <= 2.0


def _quicksync_capture():
    """tests/test_acq_variants.py::test_quicksync_engine_variant's capture:
    PRN 9 at 48 dB-Hz, -2250 Hz, 412.75 chips."""
    sat = SatelliteSignalParams(prn=9, cn0_db_hz=48.0, doppler_hz=-2250.0,
                                delay_chips=412.75,
                                nav_bits=np.ones(50, np.int8))
    return np.asarray(generate_baseband([sat], FS, 5 * N, noise=True,
                                        seed=21))


# variant -> (conf fields, PRNs, capture, the present PRN's Doppler)
CASES = {
    "quicksync": (dict(doppler_max=5000.0, doppler_step=250.0, max_dwells=4,
                       pfa=0.01, quicksync_fold=4), [9, 17],
                  _quicksync_capture, -2250.0),
    "fine_doppler": (dict(doppler_step=500.0, max_dwells=2, pfa=0.001),
                     [5, 11], lambda: _sim_l1(doppler=1840.0), 1840.0),
    "tong": (dict(tong_init=1, tong_max=3, tong_max_dwells=8, pfa=0.001),
             [5, 21], lambda: _sim_l1(n_ms=12), 1800.0),
}


@pytest.mark.parametrize("source", ["host", "tensor"])
@pytest.mark.parametrize("variant", list(CASES))
def test_engine_matches_jax(variant, source):
    fields, prns, capture, dop = CASES[variant]
    x = capture()
    je = JEngine(JAcqConf(fs_in=FS, variant=variant, **fields), prns=prns)
    pe = PEngine(AcqConf(fs_in=FS, variant=variant, **fields), prns=prns,
                 device="cpu")
    assert pe.n_samples_needed == je.n_samples_needed
    want = je.acquire(x[:je.n_samples_needed])
    got = pe.acquire_from(x if source == "host" else torch.from_numpy(x), 0)
    assert got.samplestamp == want.samplestamp == 0
    assert list(got.detected) == list(want.detected) == [True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    assert got.threshold == want.threshold
    tol = 20.0 if variant == "fine_doppler" else 250.0
    assert abs(got.doppler_hz[0] - dop) <= tol


IMPLS = {"GPS_L1_CA_PCPS_Acquisition": "pcps",
         "GPS_L1_CA_PCPS_QuickSync_Acquisition": "quicksync",
         "GPS_L1_CA_PCPS_Tong_Acquisition": "tong",
         "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler": "fine_doppler"}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_factory_accepts_1c_strings(impl):
    """Every 1C acquisition string of the JAX factory, with the variants'
    keys, builds the same receiver configuration in both packages."""
    props = {"GNSS-SDR.internal_fs_sps": "2000000",
             "Channels_1C.count": "4",
             "Acquisition_1C.implementation": impl,
             "Acquisition_1C.folding_factor": "2",
             "Acquisition_1C.tong_init_val": "2",
             "Acquisition_1C.tong_max_val": "4",
             "Acquisition_1C.tong_max_dwells": "12"}
    ref = jfactory.receiver_conf_from_config(JInMemory(dict(props)))
    got = factory.receiver_conf_from_config(InMemoryConfiguration(props))
    assert got == interop.receiver_conf_from_fields(dataclasses.asdict(ref))
    assert got.acq.variant == IMPLS[impl]
    assert (got.acq.quicksync_fold, got.acq.tong_init, got.acq.tong_max,
            got.acq.tong_max_dwells) == (2, 2, 4, 12)
    # the JAX factory's defaults when the keys are absent
    del props["Acquisition_1C.folding_factor"]
    acq = factory.receiver_conf_from_config(InMemoryConfiguration(props)).acq
    assert acq.quicksync_fold == 4 and acq.fine_doppler_iters == 3
