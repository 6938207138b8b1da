"""PRN spreading-code generation.

Host-side (NumPy) generation of the GPS L1 C/A and SBAS L1 local replica
codes, a trimmed copy of ``gnss_sim_receiver_tpu.ops.prn_codes``: codes are produced
once at channel setup and live on the device as constant tables afterwards,
so this is not a hot path.  Built from the public ICD definitions
(IS-GPS-200 G1/G2 LFSRs + G2 delay table).

All codes are returned as ``+-1`` float32 arrays with chip bit b mapped to
``2*b - 1`` (a '1' bit -> +1), matching the reference sign convention
(gps_sdr_signal_replica.cc:98-107).
"""

from __future__ import annotations

import functools

import numpy as np

GPS_CA_CODE_LENGTH = 1023

# G2 output delay (chips) per PRN, IS-GPS-200 table 3-I (PRN 1..37; 33..37 are
# reserved/ground).  Same data as reference gps_sdr_signal_replica.cc:42-53.
_GPS_CA_G2_DELAYS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 948, 950,
)


def _lfsr(taps: tuple[int, ...], length: int) -> np.ndarray:
    """Run a 10-stage LFSR (all-ones init) for `length` chips.

    `taps` are the 1-based stage numbers XOR-ed into the feedback
    (IS-GPS-200 convention); output is stage 10.  Returns bits {0,1}.
    """
    reg = np.ones(10, dtype=np.int64)
    out = np.empty(length, dtype=np.int64)
    for i in range(length):
        out[i] = reg[9]
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=64)
def _gps_ca_bits(prn: int) -> np.ndarray:
    """GPS L1 C/A code bits {0,1} for PRN 1..37."""
    if not 1 <= prn <= len(_GPS_CA_G2_DELAYS):
        raise ValueError(f"GPS C/A PRN out of range: {prn}")
    g1 = _lfsr((3, 10), GPS_CA_CODE_LENGTH)
    g2 = _lfsr((2, 3, 6, 8, 9, 10), GPS_CA_CODE_LENGTH)
    delay = _GPS_CA_G2_DELAYS[prn - 1]
    g2_delayed = np.roll(g2, delay)
    return (g1 ^ g2_delayed).astype(np.int8)


# SBAS L1 C/A G2 delays (chips) for PRN 120..138, DO-229 / same family as
# GPS C/A (reference gps_sdr_signal_replica.cc delays[119..137])
_SBAS_G2_DELAYS = (
    145, 175, 52, 21, 237, 235, 886, 657, 634, 762,
    355, 1012, 176, 603, 130, 359, 595, 68, 386,
)


@functools.lru_cache(maxsize=32)
def _sbas_l1_bits(prn: int) -> np.ndarray:
    """SBAS L1 code bits {0,1} for PRN 120..138 (same G1/G2 generators as
    GPS C/A with the DO-229 delay assignments)."""
    if not 120 <= prn <= 138:
        raise ValueError(f"SBAS PRN out of range: {prn}")
    g1 = _lfsr((3, 10), GPS_CA_CODE_LENGTH)
    g2 = _lfsr((2, 3, 6, 8, 9, 10), GPS_CA_CODE_LENGTH)
    g2_delayed = np.roll(g2, _SBAS_G2_DELAYS[prn - 120])
    return (g1 ^ g2_delayed).astype(np.int8)


def sbas_l1_code(prn: int) -> np.ndarray:
    """SBAS L1 C/A code as +-1 float32 for PRN 120..138."""
    return (2.0 * _sbas_l1_bits(prn) - 1.0).astype(np.float32)


def gps_l1_ca_code(prn: int, chip_shift: int = 0) -> np.ndarray:
    """GPS L1 C/A code as +-1 float32 ('1' bit -> +1, matching the reference
    mapping in gps_sdr_signal_replica.cc:98-107)."""
    bits = _gps_ca_bits(prn)
    if chip_shift:
        bits = np.roll(bits, -int(chip_shift) % GPS_CA_CODE_LENGTH)
    return (2.0 * bits - 1.0).astype(np.float32)


def sample_code(code: np.ndarray, fs: float, code_rate: float,
                n_samples: int, chip_shift: float = 0.0) -> np.ndarray:
    """Resample a +-1 chip sequence to `fs` (nearest-chip / zero-order hold),
    equivalent to the sampled-replica generation in the reference adapters
    (gps_sdr_signal_replica.cc gps_l1_ca_code_gen_complex_sampled).
    """
    n = np.arange(n_samples, dtype=np.float64)
    idx = np.floor(n * (code_rate / fs) + chip_shift).astype(np.int64)
    return code[np.mod(idx, len(code))]


def bandlimited_table(code: np.ndarray, fs: float, code_rate: float,
                      oversample: int = 8) -> np.ndarray:
    """Band-limited sub-chip replica table: the +-1 chip sequence filtered
    to the receiver band |f| < fs/2 and tabulated at `oversample` points
    per chip, phase-centered on the grid (entry j = waveform at chip
    (j+0.5)/oversample).

    Why: a zero-order-hold replica sampled at ~2 samples/chip has a
    frozen edge-quantization pattern; correlating it against an incoming
    signal whose sub-sample code phase drifts (code Doppler) puts a
    code-phase-dependent PRN-specific ripple on both the correlation
    amplitude (~14%/sample) and the DLL lock point (decimeters) — the
    "meter-level quantization ripple" noted in sim/signal_generator.py.
    The band-limited table is what an ideal front end would correlate
    with: amplitude and lock point invariant to sub-sample phase.  Both
    tracking kernels (per-epoch gather and block-FFT) build their
    replicas from this one table so their pseudorange conventions agree
    (RTK double differences cancel exactly across kernel handoffs).
    """
    code = np.asarray(code, np.float64)
    l = len(code)
    k = int(oversample)
    hi = np.repeat(code, k)
    spec = np.fft.rfft(hi)
    # bin b = b cycles per code period = b / L cycles/chip;
    # keep |f| < fs/2 <-> cycles/chip < fs / (2*code_rate)
    bmax = int(np.floor(fs / (2.0 * code_rate) * l))
    spec[bmax + 1:] = 0.0
    # no sub-grid phase shift: floor() lookups of this grid against a
    # floor-quantized incoming signal are empirically UNBIASED (mean
    # lock-point offset < 1e-3 chip, spread ~5e-3) — the half-cell delay
    # conventions of replica and signal cancel; adding a half-cell
    # "midpoint" shift re-introduces a 1/(2K)-chip bias (measured)
    return np.fft.irfft(spec, n=l * k).astype(np.float32)


def bandlimited_table_normalized(code: np.ndarray, fs: float,
                                 code_rate: float, n_period_samples: int,
                                 oversample: int = 8) -> np.ndarray:
    """bandlimited_table scaled so the fs-sampled replica's energy over
    one code period equals n_period_samples — the aligned correlation
    amplitude then matches the +-1 zero-order-hold convention
    (prompt ~ n_samples * signal amplitude), keeping C/N0 and prompt
    magnitudes continuous across table conventions."""
    bl = bandlimited_table(code, fs, code_rate, oversample)
    idx = np.floor(np.arange(n_period_samples, dtype=np.float64)
                   * (code_rate / fs) * oversample).astype(np.int64) \
        % len(bl)
    e = float((bl[idx].astype(np.float64) ** 2).sum())
    if e <= 0.0:
        return bl
    return (bl * np.sqrt(n_period_samples / e)).astype(np.float32)
