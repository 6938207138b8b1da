"""Multi-satellite GNSS baseband signal synthesizer.

Test-fixture equivalent of the reference's in-tree ``SignalGenerator`` block
(src/algorithms/signal_generator/gnuradio_blocks/signal_generator_c.cc) and
the external gnss-sim/bladeGPS simulators, with the same per-satellite
parameterization (signal_generator.cc:55-80: PRN / CN0 / doppler / delay).

Numerics note: phase/chip indices are computed in float64 on the host —
sub-meter pseudorange truth over 100+ s requires ~1e-9 s timing fidelity,
beyond float32.  This is a fixture path, not a receiver hot path; generation
is vectorized NumPy and chunked so arbitrarily long captures stream to disk.

Signal model per satellite (constant Doppler + optional rate):
  transmit time   tau(t) = t - delay(t),
  delay(t)        = delay0 - (f_d/f_c) t - (f_dr/f_c) t^2/2
  code chip index = floor(tau * code_rate) mod L        (code Doppler implied)
  nav bit index   = floor(tau / bit_period) mod n_bits
  carrier         = exp(j(2 pi (f_d t + f_dr t^2/2) + phi0))
  amplitude       = sqrt(10^(CN0/10) / fs)   with unit complex noise variance

GPS L1 C/A, GPS L2C CM, GPS L5I, Galileo E1 (E1-B data, E1-C pilot),
Galileo E5a-I, Galileo E5b-I, Galileo E6-B, GLONASS L1/L2 C/A, BeiDou B1I,
BeiDou B3I and SBAS L1 copy of
``gnss_sim_receiver_tpu.sim.signal_generator`` for the PyTorch port:
the same arithmetic, so a capture synthesized here equals the JAX package's
fixture sample for sample.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch import signals as sigdefs
from gnss_sim_receiver_tpu_torch.ops import prn_codes, prn_codes_multi


@dataclasses.dataclass
class SatelliteSignalParams:
    """One simulated satellite signal (reference SignalSource.{PRN_i, CN0_dB_i,
    doppler_Hz_i, delay_chips_i, delay_sec_i} parameter set)."""
    prn: int
    system: str = "GPS"
    # "1C" | "1B" (E1-B) | "1P" (E1-C) | "2S" (L2C CM) | "L5" (L5I) |
    # "5X" (E5a-I) | "7X" (E5b-I) | "B1" (BeiDou B1I) | "B3" (BeiDou B3I)
    # | "S1" (SBAS L1)
    signal: str = "1C"
    cn0_db_hz: float = 44.0
    doppler_hz: float = 0.0
    doppler_rate_hz_s: float = 0.0
    delay_chips: float = 0.0
    delay_sec: float = 0.0
    carrier_phase_rad: float = 0.0
    nav_bits: np.ndarray | None = None   # +-1 at 50 bps; None -> random
    # off-L1 signals: the PHYSICAL Doppler driving the code rate and delay
    # dynamics, and its reference carrier.  None -> doppler_hz over the L1
    # carrier (the L2C / L5 / E5a / E5b scenarios set both to their own
    # carrier)
    code_doppler_hz: float | None = None
    carrier_ref_hz: float | None = None


def cn0_to_amplitude(cn0_db_hz: float, fs: float) -> float:
    """Signal amplitude giving the requested C/N0 against unit-variance
    complex noise sampled at fs (N0 = 1/fs)."""
    return float(np.sqrt(10.0 ** (cn0_db_hz / 10.0) / fs))


def _sig_params(sat: SatelliteSignalParams):
    """(subchip table +-1 int8, sc_rate, subchips_per_symbol) per signal."""
    if sat.signal == "1C":
        code = prn_codes.gps_l1_ca_code(sat.prn).astype(np.int8)
        return (code, constants.GPS_L1_CA_CODE_RATE_CPS,
                constants.GPS_L1_CA_CODE_LENGTH_CHIPS
                * constants.GPS_L1_CA_CODES_PER_BIT)
    if sat.signal == "1B":
        sub = sigdefs.subchip_table(sigdefs.GALILEO_E1B, sat.prn
                                    ).astype(np.int8)
        # E1B: 250 sps, one 4092-chip code period per symbol (BOC sub-chips)
        return sub, sigdefs.GALILEO_E1B.sc_rate, len(sub)
    if sat.signal == "1P":
        # E1-C pilot: BOC(1,1) E1C primary; nav_bits carry the CS25
        # secondary signs (one chip per 4 ms code period)
        sub = sigdefs.boc11_expand(
            sigdefs.galileo_e1_code(sat.prn, "C")).astype(np.int8)
        return sub, sigdefs.GALILEO_E1B.sc_rate, len(sub)
    if sat.signal == "2S":
        # L2C CM: one 50-sps CNAV symbol per 20 ms code period
        return (prn_codes_multi.gps_l2c_m_code(sat.prn).astype(np.int8),
                constants.GPS_L2C_M_CODE_RATE_CPS, 10230)
    if sat.signal == "L5":
        # L5I: nav_bits are per-1 ms-EPOCH signs (symbol x NH10 pre-spread,
        # nav.cnav.l5i_epoch_signs)
        return (prn_codes_multi.gps_l5_code(sat.prn).astype(np.int8),
                constants.GPS_L5_CODE_RATE_CPS, 10230)
    if sat.signal == "5X":
        # E5a-I: nav_bits are per-1 ms-EPOCH signs (F/NAV symbol x CS20
        # secondary pre-spread, nav.fnav.e5a_epoch_signs)
        return (sigdefs.galileo_e5a_code(sat.prn, "I").astype(np.int8),
                constants.GALILEO_E5A_CODE_RATE_CPS, 10230)
    if sat.signal == "7X":
        # E5b-I: nav_bits are per-1 ms-EPOCH signs (I/NAV symbol x CS4
        # secondary pre-spread, nav.inav.e5b_epoch_signs)
        return (sigdefs.galileo_e5b_code(sat.prn).astype(np.int8),
                constants.GALILEO_E5B_CODE_RATE_CPS, 10230)
    if sat.signal in ("1G", "2G"):
        # GLONASS FDMA: the slot offset (562.5 kHz L1 / 437.5 kHz L2 per
        # slot) rides in doppler_hz; nav_bits are 100-sps GNAV symbols
        # (10 code periods each); L2 C/A is the same code
        return (prn_codes_multi.glonass_l1_ca_code().astype(np.int8),
                constants.GLONASS_CA_CODE_RATE_CPS, 5110)
    if sat.signal == "B1":
        # B1I: nav_bits are per-1 ms-EPOCH signs (D1 bit x NH20 pre-spread,
        # nav.dnav.b1i_epoch_signs; D2 GEO: nav.dnav.d2_epoch_signs)
        return (prn_codes_multi.beidou_b1i_code(sat.prn).astype(np.int8),
                constants.BEIDOU_B1I_CODE_RATE_CPS, 2046)
    if sat.signal == "B3":
        # B3I: the same per-epoch-sign convention as B1I at 10.23 Mcps
        return (prn_codes_multi.beidou_b3i_code(sat.prn).astype(np.int8),
                constants.BEIDOU_B3I_CODE_RATE_CPS, 10230)
    if sat.signal == "E6":
        # E6-B: one 1000-sps C/NAV symbol per 5115-chip code period
        # (nav_bits = +-1 symbol signs, nav.cnav_e6.e6b_epoch_signs)
        return (sigdefs.galileo_e6_code(sat.prn).astype(np.int8),
                constants.GALILEO_E6_CODE_RATE_CPS, 5115)
    if sat.signal == "S1":
        code = sigdefs.subchip_table(sigdefs.SBAS_L1, sat.prn).astype(np.int8)
        # SBAS: nav_bits are per 1 ms code epoch (2 epochs per 500 sps
        # symbol, nav.sbas.sbas_epoch_signs)
        return code, sigdefs.SBAS_L1.chip_rate_cps, len(code)
    raise NotImplementedError(
        f"simulator signal {sat.system}/{sat.signal} is not ported")


def _sat_chip_table(sat: SatelliteSignalParams) -> np.ndarray:
    """Pre-expanded sub-chip sequence table[i % L] * bit[i // L_sym] over
    the whole nav-symbol stream, as int8 — one gather per sample instead of
    two gathers + two mods in the hot loop."""
    code, _, sc_per_sym = _sig_params(sat)
    bits = np.asarray(sat.nav_bits, dtype=np.int8)
    reps_per_sym = sc_per_sym // len(code)
    table = np.tile(code, reps_per_sym * len(bits))
    table *= np.repeat(bits, sc_per_sym)
    return table


_ANCHOR_BLOCK = 8192


def _sat_signal_block(sat: SatelliteSignalParams, fs: float,
                      start_sample: int, n: int,
                      amp_fs: float | None = None) -> np.ndarray:
    """Synthesize n samples starting at absolute index start_sample.

    Numerics: float64 is only evaluated at one anchor per 8192-sample block
    (this host's f64 throughput is ~6x worse than f32); per-sample chip
    index and carrier phase are linearized in float32 around the anchors,
    exact to ~6e-5 chips / 2e-6 rad within a block — well below the
    sub-centimeter fidelity the fixtures need.
    """
    f_c = constants.GPS_L1_FREQ_HZ  # L1/E1 band (same carrier)
    _, code_rate, _ = _sig_params(sat)  # sub-chip rate
    if getattr(sat, "_chip_table", None) is None:
        sat._chip_table = _sat_chip_table(sat)
    table = sat._chip_table

    b = _ANCHOR_BLOCK
    nblk = -(-n // b)
    # anchors (f64, one per block)
    s_b = start_sample + b * np.arange(nblk, dtype=np.float64)
    t_b = s_b / fs
    # delay_chips is in ICD chips; code_rate here is the SUB-chip rate
    icd_chip_rate = (code_rate / 2.0 if sat.signal in ("1B", "1P")
                     else code_rate)
    delay0 = sat.delay_sec + sat.delay_chips / icd_chip_rate
    dop_code0 = (sat.code_doppler_hz if sat.code_doppler_hz is not None
                 else sat.doppler_hz)
    f_code = sat.carrier_ref_hz or f_c
    delay_b = delay0 - (dop_code0 / f_code) * t_b \
        - (sat.doppler_rate_hz_s / f_code) * t_b * t_b / 2.0
    tau_b = t_b - delay_b
    chipf_b = tau_b * code_rate
    dop_b = sat.doppler_hz + sat.doppler_rate_hz_s * t_b
    dopc_b = dop_code0 + sat.doppler_rate_hz_s * t_b
    chip_rate_b = code_rate * (1.0 + dopc_b / f_code) / fs  # chips/sample
    phase_b = np.mod(2.0 * np.pi * (sat.doppler_hz * t_b
                                    + sat.doppler_rate_hz_s * t_b * t_b / 2.0)
                     + sat.carrier_phase_rad, 2.0 * np.pi)
    phase_rate_b = 2.0 * np.pi * dop_b / fs                # rad/sample

    base_b = np.floor(chipf_b).astype(np.int64) % len(table)
    frac_b = (chipf_b - np.floor(chipf_b)).astype(np.float32)

    # per-sample (f32, [nblk, b])
    nloc = np.arange(b, dtype=np.float32)
    chip_off = frac_b[:, None] + chip_rate_b.astype(np.float32)[:, None] * nloc
    idx = base_b[:, None] + np.floor(chip_off).astype(np.int64)
    np.mod(idx, len(table), out=idx)
    chip_vals = table.take(idx.ravel()).astype(np.float32)
    ph = phase_b.astype(np.float32)[:, None] \
        + phase_rate_b.astype(np.float32)[:, None] * nloc
    amp = np.float32(cn0_to_amplitude(sat.cn0_db_hz, amp_fs or fs))
    iq = np.empty(nblk * b, dtype=np.complex64)
    phr = ph.ravel()
    iq.real = np.cos(phr)
    iq.imag = np.sin(phr)
    iq *= chip_vals * amp
    return iq[:n]


def generate_baseband(sats: list[SatelliteSignalParams], fs: float,
                      n_samples: int, *, start_sample: int = 0,
                      noise: bool = True, seed: int = 0,
                      bandlimit_oversample: int = 1,
                      _amp_fs: float | None = None) -> np.ndarray:
    """Generate `n_samples` of complex64 baseband starting at sample index
    `start_sample` (deterministic given seed — chunked calls concatenate
    exactly when noise=False; noise streams are chunk-independent).

    bandlimit_oversample > 1 simulates a band-limited RF front end (the
    physical anti-alias filter an SDR applies before sampling): the signal
    is synthesized at `k*fs` with ideal rectangular chips and polyphase-
    decimated to fs.  Without it, infinite-bandwidth chip edges at ~2
    samples/chip give the code discriminator a meter-level quantization
    ripple that no real front end exhibits.
    """
    k = int(bandlimit_oversample)
    rng = np.random.default_rng(seed)
    # materialize nav bits up-front so rng consumption is chunk-invariant
    for sat in sats:
        if sat.nav_bits is None:
            sat.nav_bits = (rng.integers(0, 2, 1500) * 2 - 1).astype(np.int8)
    out = np.zeros(n_samples, dtype=np.complex64)
    if k > 1:
        from scipy import signal as _sps
        pad = 32  # low-rate samples of polyphase-filter warmup per edge
        chunk = 1_000_000
        for s0 in range(0, n_samples, chunk):
            n = min(chunk, n_samples - s0)
            lo0 = start_sample + s0 - pad
            hi = generate_baseband(sats, fs * k, (n + 2 * pad) * k,
                                   start_sample=lo0 * k, noise=False,
                                   seed=seed, bandlimit_oversample=1,
                                   _amp_fs=fs)
            dec = _sps.resample_poly(hi, 1, k, window=("kaiser", 8.0))
            out[s0:s0 + n] = dec[pad:pad + n]
    else:
        chunk = 4_000_000
        for s0 in range(0, n_samples, chunk):
            n = min(chunk, n_samples - s0)
            for sat in sats:
                out[s0:s0 + n] += _sat_signal_block(sat, fs,
                                                    start_sample + s0, n,
                                                    amp_fs=_amp_fs)
    if noise:
        nrng = np.random.default_rng((seed, 0xC0FFEE, start_sample))
        out += (nrng.standard_normal(n_samples)
                + 1j * nrng.standard_normal(n_samples)).astype(np.complex64) \
            * np.float32(np.sqrt(0.5))
    return out
