"""The PyTorch port's wideband code tables and its convolutional code
against the JAX package on the CPU.

- Galileo E5a-I and E5a-Q primaries of every satellite, the CS20 and the
  per-PRN CS100 secondary codes (the port's own ``galileo_e5a_codes.npz``),
  the GPS L5-I and L5-Q codes and NH10, and the engines' sub-chip tables:
  equal to the JAX package's, chip for chip.
- The NumPy encoder and Viterbi decoder of ``nav/fec.py`` against the JAX
  package's ``native`` helper (the C library, or its own fallback): the
  same symbols and the same bits, exactly, on clean and noisy streams.
"""

import numpy as np
import pytest

from gnss_sim_receiver_tpu import constants as jconst
from gnss_sim_receiver_tpu import native
from gnss_sim_receiver_tpu import signals as jsig
from gnss_sim_receiver_tpu.nav import fnav as jfnav
from gnss_sim_receiver_tpu.nav import inav as jinav
from gnss_sim_receiver_tpu.ops import prn_codes_multi as jpcm
from gnss_sim_receiver_tpu_torch import constants as pconst
from gnss_sim_receiver_tpu_torch import signals as psig
from gnss_sim_receiver_tpu_torch.nav import fec
from gnss_sim_receiver_tpu_torch.ops import prn_codes_multi as ppcm


@pytest.mark.parametrize("component", ["I", "Q"])
def test_e5a_primaries_equal_jax(component):
    for prn in range(1, 51):
        assert np.array_equal(psig.galileo_e5a_code(prn, component),
                              jsig.galileo_e5a_code(prn, component)), prn


def test_e5a_secondary_codes_equal_jax():
    cs20 = psig.e5a_secondary_code(0, "I")
    assert cs20.shape == (20,)
    assert np.array_equal(cs20, jsig.e5a_secondary_code(0, "I"))
    for prn in range(1, 48):
        assert np.array_equal(psig.e5a_secondary_code(prn, "Q"),
                              jsig.e5a_secondary_code(prn, "Q")), prn


@pytest.mark.parametrize("quadrature", [False, True])
def test_l5_codes_equal_jax(quadrature):
    for prn in range(1, 38):
        assert np.array_equal(ppcm.gps_l5_code(prn, quadrature),
                              jpcm.gps_l5_code(prn, quadrature)), prn
    assert pconst.GPS_L5I_NH_CODE == jconst.GPS_L5I_NH_CODE


@pytest.mark.parametrize("sig", ["L5", "5X"])
def test_subchip_tables_and_pilots_equal_jax(sig):
    jdef = {"L5": jsig.GPS_L5I, "5X": jsig.GALILEO_E5A_I}[sig]
    pdef = psig.SIGNALS[sig]
    for f in ("system", "signal", "carrier_freq_hz", "chip_rate_cps",
              "code_length_chips", "sc_per_chip", "symbol_rate_sps"):
        assert getattr(pdef, f) == getattr(jdef, f), f
    for prn in (1, 11, 19, 32):
        assert np.array_equal(psig.CodeProvider(sig)(prn),
                              jsig.subchip_table(jdef, prn))
    if sig == "5X":
        assert np.array_equal(psig.CodeProvider("5X", "Q")(19),
                              jsig.galileo_e5a_code(19, "Q"))


@pytest.mark.parametrize("invert_g2", [False, True])
def test_conv27_encode_matches_jax(invert_g2):
    """Plain (CNAV) against native.conv27_encode; G2-inverted (I/NAV,
    F/NAV) against the JAX package's Galileo encoder."""
    bits = np.random.default_rng(5).integers(0, 2, 1000)
    got = fec.conv27_encode(bits, invert_g2=invert_g2)
    want = (jinav.conv27_encode(bits) if invert_g2
            else native.conv27_encode(bits).astype(np.int64))
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("noise", [0.0, 0.9])
def test_viterbi27_matches_native(noise):
    """Streams of a CNAV window (800 symbols), an F/NAV page (488) and a
    longer one; the noisy streams carry decoding errors, which must be
    the native decoder's too."""
    rng = np.random.default_rng(9)
    for n_bits in (400, 244, 1500):
        sym = fec.conv27_encode(rng.integers(0, 2, n_bits))
        soft = ((2.0 * sym - 1.0)
                + noise * rng.standard_normal(len(sym))).astype(np.float32)
        assert np.array_equal(fec.viterbi27_decode(soft),
                              native.viterbi27_decode(soft)), n_bits
    # the F/NAV page's Galileo form: G2 symbols negated before decoding
    page = jfnav.pack_word(2, {"iod_nav": 5, "wn": 1045, "tow": 10.0})
    coded = fec.conv27_encode(np.concatenate([page, np.zeros(6, int)]),
                              invert_g2=True).astype(np.float32)
    soft = 2.0 * coded - 1.0
    soft[1::2] = -soft[1::2]
    assert np.array_equal(fec.viterbi27_decode(soft)[:len(page)], page)
