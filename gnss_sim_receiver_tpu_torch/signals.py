"""Signal definitions: per-signal code tables and rates for the batched
engines, a copy of the GPS L1 C/A, GPS L2C (CM), GPS L5, Galileo E1,
Galileo E5a, Galileo E5b, Galileo E6-B, GLONASS L1/L2 C/A, BeiDou B1I,
BeiDou B3I and SBAS L1 parts of ``gnss_sim_receiver_tpu.signals`` for the
PyTorch port.

The acquisition and tracking engines are signal-agnostic: they consume a
"sub-chip" table (the spreading waveform sampled at sc_rate, one entry per
sub-chip) plus rates.  BPSK signals use the code itself; BOC(1,1) signals
(Galileo E1) use the 2x-rate sub-chip expansion so the same NCO and
correlator handle the square-wave subcarrier (the role of the reference's
sinboc replica generation, galileo_e1_signal_replica.cc).

The Galileo E1-B/E1-C, E5a-I/E5a-Q, E5b-I and E6-B primary codes are ICD
memory codes: the port ships its own copy of their packed-bit rows,
``data/galileo_e1_codes.npz``, ``data/galileo_e5a_codes.npz``,
``data/galileo_e5b_codes.npz`` and ``data/galileo_e6_codes.npz`` (the
public Galileo OS SIS ICD tables, reference Galileo_E1.h:56,760,
Galileo_E5a.h:72,1827, Galileo_E5b.h:57 and Galileo_E6.h:45, with the E5a
secondary codes of Galileo_E5a.h:3581, 3585 and E5b-I's CS4;
tools/port_galileo_e5b_codes.py and tools/port_galileo_e6_codes.py wrote
the E5b and E6 files).  Chip convention of
the reference's hex_to_binary_converter (gnss_signal_replica.cc:43): bit 0
-> +1.0, bit 1 -> -1.0.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.ops import prn_codes, prn_codes_multi


@dataclasses.dataclass(frozen=True)
class SignalDef:
    system: str          # "GPS" | "Galileo" | "GLONASS" | "BeiDou" | "SBAS"
    # "1C" | "1B" | "2S" | "L5" | "5X" | "7X" | "E6" | "1G" | "2G" | "B1"
    # | "B3" | "S1"
    signal: str
    carrier_freq_hz: float
    chip_rate_cps: float        # ICD chip rate
    code_length_chips: int
    sc_per_chip: int            # sub-chips per chip (1 = BPSK, 2 = BOC(1,1))
    symbol_rate_sps: float      # nav symbol rate

    @property
    def sc_rate(self) -> float:
        return self.chip_rate_cps * self.sc_per_chip

    @property
    def sc_length(self) -> int:
        return self.code_length_chips * self.sc_per_chip

    @property
    def code_period_s(self) -> float:
        return self.code_length_chips / self.chip_rate_cps


GPS_L1CA = SignalDef("GPS", "1C", constants.GPS_L1_FREQ_HZ, 1.023e6, 1023,
                     1, 50.0)
GALILEO_E1B = SignalDef("Galileo", "1B", constants.GALILEO_E1_FREQ_HZ,
                        1.023e6, 4092, 2, 250.0)
# L2C CM: 20 ms code period, one 50-sps CNAV symbol per period
GPS_L2C_CM = SignalDef("GPS", "2S", constants.GPS_L2_FREQ_HZ,
                       constants.GPS_L2C_M_CODE_RATE_CPS, 10230, 1, 50.0)
# L5I: 1 ms code epochs; 100-sps CNAV symbols spread by NH10 (the sim's
# nav_bits for "L5" are per-EPOCH signs, nav.cnav.l5i_epoch_signs)
GPS_L5I = SignalDef("GPS", "L5", constants.GPS_L5_FREQ_HZ,
                    constants.GPS_L5_CODE_RATE_CPS, 10230, 1, 1000.0)
# Galileo E5a-I: 1 ms code epochs; 50-sps F/NAV symbols spread by the
# 20-chip secondary code (nav_bits are per-EPOCH signs,
# nav.fnav.e5a_epoch_signs)
GALILEO_E5A_I = SignalDef("Galileo", "5X", constants.GALILEO_E5A_FREQ_HZ,
                          constants.GALILEO_E5A_CODE_RATE_CPS, 10230, 1,
                          1000.0)
# Galileo E5b-I: 1 ms code epochs; 250-sps I/NAV symbols spread by the
# fixed 4-chip CS4 secondary code (nav_bits are per-EPOCH signs,
# nav.inav.e5b_epoch_signs)
GALILEO_E5B_I = SignalDef("Galileo", "7X", constants.GALILEO_E5B_FREQ_HZ,
                          constants.GALILEO_E5B_CODE_RATE_CPS, 10230, 1,
                          1000.0)
# GLONASS L1 C/A: FDMA, all satellites share the 511-chip code; the
# carrier sits at L1 + k*562.5 kHz for frequency slot k (nav_bits are
# 100-sps GNAV meander-half symbols, 10 code epochs each)
GLONASS_L1_CA = SignalDef("GLONASS", "1G", constants.GLONASS_L1_FREQ_HZ,
                          constants.GLONASS_CA_CODE_RATE_CPS, 511, 1, 100.0)
GLONASS_L2_CA = SignalDef("GLONASS", "2G", constants.GLONASS_L2_FREQ_HZ,
                          constants.GLONASS_CA_CODE_RATE_CPS, 511, 1, 100.0)
# BeiDou B1I (MEO/IGSO, D1): 1 ms code epochs; 50-bps D1 bits spread by
# NH20 (nav_bits are per-EPOCH signs, nav.dnav.b1i_epoch_signs)
BEIDOU_B1I = SignalDef("BeiDou", "B1", constants.BEIDOU_B1I_FREQ_HZ,
                       constants.BEIDOU_B1I_CODE_RATE_CPS, 2046, 1, 1000.0)
# BeiDou B3I (MEO/IGSO, D1): the same 1 ms epoch / NH20 / D1 structure as
# B1I, at 10.23 Mcps with its own 10230-chip code family
BEIDOU_B3I = SignalDef("BeiDou", "B3", constants.BEIDOU_B3I_FREQ_HZ,
                       constants.BEIDOU_B3I_CODE_RATE_CPS, 10230, 1, 1000.0)
# Galileo E6-B (data, HAS): 5.115 Mcps, 1 ms code epochs, one 1000-sps
# CNAV symbol per epoch (reference factory signal "E6",
# gnss_block_factory.cc:1012,1150)
GALILEO_E6B = SignalDef("Galileo", "E6", constants.GALILEO_E6_FREQ_HZ,
                        constants.GALILEO_E6_CODE_RATE_CPS, 5115, 1, 1000.0)

# SBAS L1: GPS C/A chip plan (PRN 120-138), 500 sps conv-coded symbols
# spanning two 1 ms code epochs (reference signal "1C"/system SBAS,
# sbas_l1_telemetry_decoder_gs.cc)
SBAS_L1 = SignalDef("SBAS", "S1", constants.GPS_L1_FREQ_HZ,
                    1.023e6, 1023, 1, 500.0)

_DATA = os.path.join(os.path.dirname(__file__), "data")


@functools.lru_cache(maxsize=4)
def _galileo_tables(band: str = "e1") -> dict:
    """Packed-bit Galileo ICD code tables of one band, "e1", "e5a", "e5b"
    or "e6" (see module docstring)."""
    with np.load(os.path.join(_DATA, f"galileo_{band}_codes.npz")) as z:
        return {k: z[k] for k in z.files}


def _unpack_row(packed_row: np.ndarray, n_chips: int) -> np.ndarray:
    bits = np.unpackbits(packed_row, count=n_chips)
    return (1.0 - 2.0 * bits).astype(np.float32)   # bit 0 -> +1


@functools.lru_cache(maxsize=256)
def galileo_e1_code(prn: int, component: str = "B") -> np.ndarray:
    """Galileo E1-B/E1-C 4092-chip primary memory code (+-1),
    Galileo OS SIS ICD Annex C (reference table Galileo_E1.h:56,760)."""
    t = _galileo_tables()
    key = "e1b" if component == "B" else "e1c"
    return _unpack_row(t[key][prn - 1], 4092)


@functools.lru_cache(maxsize=256)
def galileo_e5a_code(prn: int, component: str = "I") -> np.ndarray:
    """Galileo E5a-I/Q 10230-chip primary code (+-1)
    (reference table Galileo_E5a.h:72,1827)."""
    t = _galileo_tables("e5a")
    key = "e5ai" if component == "I" else "e5aq"
    return _unpack_row(t[key][prn - 1], 10230)


@functools.lru_cache(maxsize=256)
def galileo_e5b_code(prn: int) -> np.ndarray:
    """Galileo E5b-I 10230-chip primary code (+-1)
    (reference table Galileo_E5b.h:57)."""
    return _unpack_row(_galileo_tables("e5b")["e5bi"][prn - 1], 10230)


@functools.lru_cache(maxsize=256)
def galileo_e6_code(prn: int) -> np.ndarray:
    """Galileo E6-B 5115-chip primary memory code (+-1)
    (reference table Galileo_E6.h:45, E6-B/C Codes Technical Note)."""
    return _unpack_row(_galileo_tables("e6")["e6b"][prn - 1], 5115)


@functools.lru_cache(maxsize=64)
def e5a_secondary_code(prn: int = 0, component: str = "I") -> np.ndarray:
    """E5a secondary code (+-1): CS20 for E5a-I, the SAME 20-chip code for
    every satellite (Galileo_E5a.h:3581), or the per-PRN 100-chip CS100
    for E5a-Q (Galileo_E5a.h:3585).  `prn` is ignored for "I"."""
    t = _galileo_tables("e5a")
    if component == "I":
        bits = t["e5ai_sec"]
    else:
        bits = np.unpackbits(t["e5aq_sec"][prn - 1], count=100)
    return (1.0 - 2.0 * bits).astype(np.float32)


@functools.lru_cache(maxsize=1)
def e5b_secondary_code() -> np.ndarray:
    """E5b-I 4-chip secondary code CS4 (+-1), the same for every satellite
    (Galileo OS SIS ICD table 37: '1110')."""
    bits = _galileo_tables("e5b")["e5bi_sec"]
    return (1.0 - 2.0 * bits).astype(np.float32)


@functools.lru_cache(maxsize=1)
def e1c_secondary_code() -> np.ndarray:
    """E1-C 25-chip secondary code CS25 (+-1), same for all satellites
    (Galileo_E1.h:52)."""
    bits = _galileo_tables()["e1c_sec"]
    return (1.0 - 2.0 * bits).astype(np.float32)


def boc11_expand(code: np.ndarray) -> np.ndarray:
    """BOC(1,1) sine-phased sub-chip expansion: chip c -> (+c, -c)."""
    out = np.empty(2 * len(code), np.float32)
    out[0::2] = code
    out[1::2] = -code
    return out


def subchip_table(sig: SignalDef, prn: int) -> np.ndarray:
    """The engine-facing spreading table for (signal, prn)."""
    if sig.signal == "1C":
        return prn_codes.gps_l1_ca_code(prn)
    if sig.signal == "1B":
        return boc11_expand(galileo_e1_code(prn, "B"))
    if sig.signal == "2S":
        return prn_codes_multi.gps_l2c_m_code(prn)
    if sig.signal == "L5":
        return prn_codes_multi.gps_l5_code(prn)
    if sig.signal == "5X":
        return galileo_e5a_code(prn, "I")
    if sig.signal == "7X":
        return galileo_e5b_code(prn)
    if sig.signal in ("1G", "2G"):
        # L2 C/A is the SAME 511-chip sequence on the 1246 MHz carrier
        # (GLONASS ICD; glonass_l2_ca_pcps_acquisition.cc)
        return prn_codes_multi.glonass_l1_ca_code()
    if sig.signal == "B1":
        return prn_codes_multi.beidou_b1i_code(prn)
    if sig.signal == "B3":
        return prn_codes_multi.beidou_b3i_code(prn)
    if sig.signal == "E6":
        return galileo_e6_code(prn)
    if sig.signal == "S1":
        return prn_codes.sbas_l1_code(prn)
    raise NotImplementedError(f"signal {sig.signal} is not ported")


@dataclasses.dataclass(frozen=True)
class CodeProvider:
    """prn -> +-1 sub-chip table of one signal component, as the engines'
    `code_provider` takes it.  A value object (unlike a lambda) so that two
    receiver configurations built from the same conf compare equal.

    component "B": the signal's data code (:func:`subchip_table`); the
    pilot primary, the second replica family of the two-family acquisition
    variants (:data:`PILOT_COMPONENT`): "C" the Galileo E1-C primary,
    BOC(1,1)-expanded, "Q" the Galileo E5a-Q primary."""
    signal: str = "1C"
    component: str = "B"

    def __call__(self, prn: int) -> np.ndarray:
        if self.component == "B":
            return subchip_table(SIGNALS[self.signal], prn)
        if PILOT_COMPONENT.get(self.signal) != self.component:
            raise NotImplementedError(
                f"component {self.component} of signal {self.signal} is "
                "not ported")
        if self.signal == "1B":
            return boc11_expand(galileo_e1_code(prn, "C"))
        return galileo_e5a_code(prn, "Q")


SIGNALS = {"1C": GPS_L1CA, "1B": GALILEO_E1B, "2S": GPS_L2C_CM,
           "L5": GPS_L5I, "5X": GALILEO_E5A_I, "7X": GALILEO_E5B_I,
           "1G": GLONASS_L1_CA, "2G": GLONASS_L2_CA, "B1": BEIDOU_B1I,
           "B3": BEIDOU_B3I, "E6": GALILEO_E6B, "S1": SBAS_L1}
# the pilot component of each signal that has one in the port
PILOT_COMPONENT = {"1B": "C", "5X": "Q"}
