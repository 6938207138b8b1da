"""The PyTorch port's sign-recovery acquisition (kernel K4a's path) against
the JAX package on the CPU.

- The plain grids ``pcps_cccwsr_grid`` and ``pcps_8ms_grid`` on one E1
  dwell of tests/test_acq_variants.py's capture (4.5 Msps, C=2, D=9):
  within 1e-4 of the grid's max (two float32 FFT libraries), the same peak
  cell.
- K4a's plain version on the planes of the port's search against the
  statistic of the JAX-form grid.
- The engines' ``_acquire_dual`` path (conf strings
  Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition and ..._8ms_...) on that
  capture: the same detections, Doppler, delay and threshold, from a host
  array and from a tensor sliced where the window starts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.models.acquisition import AcqConf as JAcqConf
from gnss_sim_receiver_tpu.models.acquisition import \
    PcpsAcquisitionEngine as JEngine
from gnss_sim_receiver_tpu.ops import pcps as jpcps
from gnss_sim_receiver_tpu.ops import prn_codes as jpc
from gnss_sim_receiver_tpu_torch import signals as psig
from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf, VARIANTS
from gnss_sim_receiver_tpu_torch.models.acquisition import \
    PcpsAcquisitionEngine as PEngine
from gnss_sim_receiver_tpu_torch.ops import pcps as ppcps
from tests.test_acq_variants import _e1_capture

FS = 4_500_000.0
N = int(FS * 4e-3)                       # one E1 code period


@pytest.fixture(scope="module")
def e1():
    """tests/test_acq_variants.py's E1 capture (PRN 11, data + pilot with
    a negative relative sign, 45 dB-Hz) and the two replica families of
    PRNs 11 and 19."""
    x, n, fs = _e1_capture()
    assert n == N and fs == FS
    sig = jsig.GALILEO_E1B

    def cfc(provider):
        codes = np.stack([jpc.sample_code(provider(p), FS, sig.sc_rate, N)
                          for p in (11, 19)])
        return np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)
    return dict(x=x, data=cfc(lambda p: jsig.subchip_table(sig, p)),
                pilot=cfc(lambda p: jsig.boc11_expand(
                    jsig.galileo_e1_code(p, "C"))),
                dops=(1750.0 + 125.0 * (np.arange(9) - 4)).astype(
                    np.float32))


def _peak_cell(g):
    return np.unravel_index(int(np.argmax(g)), g.shape)


@pytest.mark.parametrize("variant", ["cccwsr", "8ms"])
def test_dual_grids_match_jax(e1, variant):
    dops = e1["dops"]
    if variant == "cccwsr":
        x = e1["x"][:N][None]
        want = np.asarray(jpcps.pcps_cccwsr_grid(
            jnp.asarray(x), jnp.asarray(e1["data"]), jnp.asarray(e1["pilot"]),
            jnp.asarray(dops), FS))
        got = ppcps.pcps_cccwsr_grid(
            torch.from_numpy(x), torch.from_numpy(e1["data"]),
            torch.from_numpy(e1["pilot"]), torch.from_numpy(dops), FS).numpy()
    else:
        x = e1["x"][:2 * N][None]
        want = np.asarray(jpcps.pcps_8ms_grid(
            jnp.asarray(x), jnp.asarray(e1["data"]), jnp.asarray(dops), FS))
        got = ppcps.pcps_8ms_grid(
            torch.from_numpy(x), torch.from_numpy(e1["data"]),
            torch.from_numpy(dops), FS).numpy()
    assert got.shape == want.shape == (2, 9, N)
    assert np.abs(got - want).max() < 1e-4 * want.max()
    assert _peak_cell(got) == _peak_cell(want)
    assert _peak_cell(want)[0] == 0                  # PRN 11


@pytest.mark.parametrize("variant", ["cccwsr", "8ms"])
def test_k4a_plain_is_the_grid_statistic(e1, variant):
    """K4a's plain version on the [M, C, D, 2, N] planes of the port's
    search equals max_to_input_power_stat of the plain grid with
    n_eff = 2 M correlations per cell."""
    m = 2
    n_dw = N if variant == "cccwsr" else 2 * N
    x = torch.from_numpy(e1["x"][:m * n_dw].reshape(m, n_dw))
    data, pilot = torch.from_numpy(e1["data"]), torch.from_numpy(e1["pilot"])
    dops = torch.from_numpy(e1["dops"])
    corr = ppcps.dual_correlations(x, data, pilot, dops,
                                   ppcps.time_axis(n_dw, FS, "cpu"), variant)
    assert corr.shape == (m, 2, 9, 2, N)
    stat, di, de = ppcps.pcps_dual_peak(corr, m)
    if variant == "cccwsr":
        grid = ppcps.pcps_cccwsr_grid(x, pilot, data, dops, FS)
    else:
        grid = ppcps.pcps_8ms_grid(x, data, dops, FS)
    ws, wd, we = ppcps.max_to_input_power_stat(grid, float(2 * m))
    assert torch.equal(di, wd) and torch.equal(de, we)
    assert torch.allclose(stat, ws, rtol=1e-5)
    buf = ppcps.pcps_search_dual(x, data, pilot, dops,
                                 ppcps.time_axis(n_dw, FS, "cpu"), variant)
    assert buf.shape == (4, 2) and not buf[3].any()
    assert torch.equal(buf[1], dops[wd.long()])


def _engines(variant):
    sig = jsig.GALILEO_E1B
    kw = dict(fs_in=FS, doppler_max=5000.0, doppler_step=250.0, max_dwells=2,
              pfa=0.01, sampled_ms=4, variant=variant)
    je = JEngine(JAcqConf(**kw), prns=[11, 19],
                 code_provider=lambda p: jsig.subchip_table(sig, p),
                 sc_rate=sig.sc_rate,
                 code_provider2=lambda p: jsig.boc11_expand(
                     jsig.galileo_e1_code(p, "C")))
    pe = PEngine(AcqConf(**kw), prns=[11, 19],
                 code_provider=psig.CodeProvider("1B"),
                 sc_rate=psig.GALILEO_E1B.sc_rate,
                 code_provider2=psig.CodeProvider("1B", "C"), device="cpu")
    return je, pe


@pytest.mark.parametrize("source", ["host", "tensor"])
@pytest.mark.parametrize("variant", ["cccwsr", "8ms"])
def test_acquire_dual_matches_jax(e1, variant, source):
    je, pe = _engines(variant)
    assert pe.n_samples_needed == je.n_samples_needed
    start = 301                                    # off the 128-sample grid
    want = je.acquire_from(e1["x"], start)
    x = e1["x"] if source == "host" else torch.from_numpy(e1["x"])
    got = pe.acquire_from(x, start)
    assert got.samplestamp == want.samplestamp == start
    assert list(got.detected) == list(want.detected) == [True, False]
    assert np.array_equal(got.doppler_hz, want.doppler_hz)
    assert np.array_equal(got.delay_samples, want.delay_samples)
    assert np.allclose(got.test_stat, want.test_stat, rtol=1e-4)
    # the variant's CFAR threshold: Pfa/2 at 2 M degrees of freedom
    assert got.threshold == want.threshold == pe.threshold
    exp = 1000.0 * FS / jsig.GALILEO_E1B.chip_rate_cps - start
    assert abs(float(got.delay_samples[0]) - exp) <= 3.0


def test_unported_variant_is_refused():
    assert VARIANTS == ("pcps", "cccwsr", "8ms", "iq_caf", "quicksync",
                        "tong", "fine_doppler")
    for variant in ("assisted",):
        with pytest.raises(NotImplementedError, match="not ported"):
            AcqConf(variant=variant)
