"""Parity of the port's signal conditioner (kernels K5a-K5d: LO mix + FIR +
decimation, IIR notch, pulse blanking, resamplers) with the JAX package on
the CPU, where the port's wrappers run their plain versions.

The same inputs, made from a numpy seed, go through the JAX function and
its counterpart in the port.  Each assert states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models.conditioner import \
    SignalConditioner as JaxConditioner
from gnss_sim_receiver_tpu.ops import filters as jfilters
from gnss_sim_receiver_tpu.ops import resampler as jresampler
from gnss_sim_receiver_tpu.utils.config import \
    InMemoryConfiguration as JaxConfig
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models.conditioner import SignalConditioner
from gnss_sim_receiver_tpu_torch.ops import filters, resampler
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration


def _noise(n, seed=0, shape=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if shape is None else shape
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() \
        / np.abs(np.asarray(want)).max()


def test_design_lowpass_is_the_same_table():
    for n_taps, cutoff in ((5, 0.45), (31, 0.45), (63, 0.2)):
        assert np.array_equal(filters.design_lowpass(n_taps, cutoff),
                              jfilters.design_lowpass(n_taps, cutoff))


@pytest.mark.parametrize("n", [4096, 4099])
@pytest.mark.parametrize("n_taps", [5, 31, 63])
@pytest.mark.parametrize("dec", [1, 2, 4])
def test_fir_filter_matches_jax(dec, n_taps, n):
    """Tolerance 1e-5 of the output's scale: XLA's convolution sums the
    taps in its own order (T <= 63 float32 products)."""
    x = _noise(n, seed=n_taps + dec)
    taps = filters.design_lowpass(n_taps, 0.45)
    want = np.asarray(jfilters.fir_filter(jnp.asarray(x), jnp.asarray(taps),
                                          dec))
    got = filters.fir_filter(torch.from_numpy(x), torch.from_numpy(taps),
                             dec).numpy()
    assert got.shape == want.shape == (-(-n // dec),)
    assert got.dtype == np.complex64
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("fc,fs,dec,n", [
    (1.0e6, 4.0e6, 2, 1 << 20),      # quarter-rate IF: the phase step is
    #                                  exact in float32
    (-250e3, 4.0e6, 2, 65536),
    (37.5e3, 2.0e6, 1, 16385),
])
def test_freq_xlating_fir_filter_matches_jax(fc, fs, dec, n):
    """Nonzero IF, N <= 2^20 (float32(n) still holds every integer).  The
    LO phase w*n reaches 1.6e6 rad at the quarter-rate IF.  The port takes
    the phase step w in the form the compiled JAX function has it
    (filters.lo_step: one ulp of w would be 1e-4 of the scale here), both
    sides round the one float32 product w*n the same way, and their float32
    cos/sin agree to a few ulp after argument reduction.  Tolerance 2e-5 of
    the output's scale: the FIR's summation order (1e-5) plus the LO."""
    x = _noise(n, seed=7)
    taps = filters.design_lowpass(31, 0.45)
    want = np.asarray(jfilters.freq_xlating_fir_filter(
        jnp.asarray(x), jnp.asarray(taps), fc, fs, dec))
    got = filters.freq_xlating_fir_filter(
        torch.from_numpy(x), torch.from_numpy(taps), fc, fs, dec).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) < 2e-5


def test_freq_xlating_with_zero_if_is_the_plain_fir():
    x = torch.from_numpy(_noise(5000, seed=3))
    taps = torch.from_numpy(filters.design_lowpass(31, 0.45))
    assert torch.equal(filters.freq_xlating_fir_filter(x, taps, 0.0, 4e6, 2),
                       filters.fir_filter(x, taps, 2))


@pytest.mark.parametrize("f0,bw", [(0.25, 0.01), (0.23, 0.02), (0.05, 0.005)])
def test_notch_filter_matches_jax(f0, bw):
    """N = 4096 through the sequential recurrence on both sides.  Tolerance
    1e-4 of the output's scale: the float32 coefficients may differ by an
    ulp (cos of another library) and XLA contracts the step's
    multiply-adds; with r = 1 - pi*bw < 1 the state forgets, so the error
    does not grow along the stream."""
    x = _noise(4096, seed=11)
    x += (10.0 * np.exp(2j * np.pi * f0 * np.arange(4096))
          ).astype(np.complex64)
    want = np.asarray(jfilters.notch_filter(
        jnp.asarray(x), jnp.float32(f0), jnp.float32(bw)))
    got = filters.notch_filter(torch.from_numpy(x), f0, bw).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    assert _rel_err(got, want) < 1e-4
    # the continuous wave is gone, the noise stays
    assert np.abs(got[2048:]).mean() < 0.3 * np.abs(x[2048:]).mean()


@pytest.mark.parametrize("n", [
    64 * 128,           # even window count
    64 * 127,           # odd window count
    64 * 128 + 37,      # even count and a ragged tail
    64 * 127 + 1,       # odd count and a one-sample tail
])
def test_pulse_blanking_matches_jax(n):
    """Exact agreement: both sides blank the same windows (the median
    averages the two middle values for an even count, as jnp.median does)
    and pass the other samples through untouched."""
    x = _noise(n, seed=n) * np.float32(np.sqrt(0.5))
    if n > 2000:
        x[1000:1100] += 50.0
        x[3000:3010] += 9.0
    want = np.asarray(jfilters.pulse_blanking(jnp.asarray(x), 4.0, 64))
    got = filters.pulse_blanking(torch.from_numpy(x), 4.0, 64).numpy()
    assert np.array_equal(got, want)
    if n > 2000:
        assert np.abs(got[1024:1088]).max() == 0.0
        assert np.array_equal(got[n - n % 64:], x[n - n % 64:])


def test_pulse_blanking_shorter_than_a_window_passes_through():
    """No whole window, so nothing to blank (the JAX function raises on the
    empty median there)."""
    x = torch.from_numpy(_noise(40, seed=1))
    assert torch.equal(filters.pulse_blanking(x, 4.0, 64), x)


def test_median_averages_the_middle_pair():
    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(filters._median(v)) == 2.5 == float(jnp.median(
        jnp.asarray(v.numpy())))
    assert float(filters._median(v[:3])) == 3.0


@pytest.mark.parametrize("n_in", [4000, 4001])
@pytest.mark.parametrize("ratio", [2.0, 4.0 / 3.0])
def test_resamplers_match_jax(ratio, n_in):
    """direct: identical (the same float32 index arithmetic picks the same
    samples).  linear: 1e-6 of the scale (XLA may contract
    x0*(1-f) + x1*f into a multiply-add)."""
    x = _noise(n_in, seed=5)
    n_out = resampler.output_length(n_in, ratio, 1.0)
    assert n_out == jresampler.output_length(n_in, ratio, 1.0)
    want = np.asarray(jresampler.direct_resampler(jnp.asarray(x), ratio,
                                                  n_out))
    got = resampler.direct_resampler(torch.from_numpy(x), ratio, n_out)
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jresampler.linear_resampler(jnp.asarray(x), ratio,
                                                  n_out))
    got = resampler.linear_resampler(torch.from_numpy(x), ratio, n_out)
    assert got.shape == want.shape == (n_out,)
    assert _rel_err(got.numpy(), want) < 1e-6


def _configs(props):
    jc, pc = JaxConfig(), InMemoryConfiguration()
    for k, v in props.items():
        jc.set_property(k, v)
        pc.set_property(k, v)
    return jc, pc


_FIR = {"InputFilter.number_of_taps": "31", "InputFilter.cutoff": "0.4",
        "InputFilter.decimation_factor": "2"}


@pytest.mark.parametrize("impl,extra,rtol", [
    ("Pass_Through", {}, 0.0),
    ("Fir_Filter", _FIR, 1e-5),
    ("Freq_Xlating_Fir_Filter", dict(_FIR, **{"InputFilter.IF": "1000000"}),
     2e-5),
    ("Notch_Filter", {"InputFilter.f0_norm": "0.2"}, 1e-4),
    ("Notch_Filter_Lite", {"InputFilter.bw_norm": "0.02"}, 1e-4),
    ("Pulse_Blanking_Filter", {"InputFilter.pfa_sigmas": "3.0"}, 0.0),
])
@pytest.mark.parametrize("res_impl", ["Pass_Through", "Direct_Resampler",
                                      "Mmse_Resampler"])
def test_signal_conditioner_matches_jax(impl, extra, rtol, res_impl):
    """SignalConditioner.process for every InputFilter and Resampler
    implementation: the same fs_out bookkeeping, the same output length,
    and values within the filter's tolerance (above) of the output's scale,
    plus 1e-6 for the linear resampler."""
    props = {"InputFilter.implementation": impl,
             "Resampler.implementation": res_impl, **extra}
    if res_impl != "Pass_Through":
        props["Resampler.sample_freq_out"] = "1500000"
    jc, pc = _configs(props)
    jcond = JaxConditioner(jc, fs_in=4e6)
    pcond = SignalConditioner(pc, fs_in=4e6, device="cpu")
    assert pcond.fs_out == jcond.fs_out
    x = _noise(4096, seed=21)
    x[500:560] += 30.0
    want = jcond.process(x)
    got = pcond.process(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    assert got.shape == want.shape
    if res_impl == "Mmse_Resampler":
        rtol += 1e-6
    assert _rel_err(got.numpy(), want) <= rtol
    # a tensor goes in as well as an array
    assert torch.equal(pcond.process(torch.from_numpy(x)), got)
    tables = interop.conditioner_tables_to_numpy(pcond)
    if "Fir" in impl:
        assert np.array_equal(tables["taps"],
                              interop.conditioner_tables_to_numpy(
                                  jcond)["taps"])


def test_beamformer_filter_matches_jax():
    """Beamformer_Filter: the weighted sum over array elements, a plain
    einsum on both sides; 1e-6 of the scale (summation order over 4
    elements)."""
    n_el, n = 4, 4096
    x = _noise(0, seed=2, shape=(n_el, n))
    props = {"InputFilter.implementation": "Beamformer_Filter",
             "InputFilter.number_of_channels": str(n_el)}
    for k in range(n_el):
        w = np.exp(-1j * np.radians(30.0) * k)
        props[f"InputFilter.weight_{k}_real"] = f"{w.real:.17g}"
        props[f"InputFilter.weight_{k}_imag"] = f"{w.imag:.17g}"
    jc, pc = _configs(props)
    jcond = JaxConditioner(jc, fs_in=4e6)
    pcond = SignalConditioner(pc, fs_in=4e6, device="cpu")
    tables = interop.conditioner_tables_to_numpy(pcond)
    assert np.array_equal(tables["beam_weights"], jcond._beam_weights)
    want = jcond.process(x)
    got = pcond.process(x).numpy()
    assert got.shape == (n,)
    assert _rel_err(got, want) < 1e-6
    with pytest.raises(ValueError, match="n_elements"):
        pcond.process(x[0])
    # tables set from arrays take effect
    interop.conditioner_tables_from_numpy(
        pcond, {"beam_weights": np.ones(n_el, np.complex64)})
    assert _rel_err(pcond.process(x).numpy(), x.sum(0)) < 1e-6


@pytest.mark.parametrize("key", ["InputFilter.implementation",
                                 "Resampler.implementation"])
def test_unknown_implementation_raises(key):
    _, pc = _configs({key: "No_Such_Block"})
    with pytest.raises(ValueError, match="unknown"):
        SignalConditioner(pc, fs_in=4e6, device="cpu").process(_noise(256))


def test_conditioner_needs_a_card_or_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is the "
                    "CPU machines'")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SignalConditioner(InMemoryConfiguration(), fs_in=4e6)
