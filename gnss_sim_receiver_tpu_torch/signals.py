"""Signal definitions: per-signal code tables and rates for the batched
engines, a copy of the GPS L1 C/A and Galileo E1 parts of
``gnss_sim_receiver_tpu.signals`` for the PyTorch port.

The acquisition and tracking engines are signal-agnostic: they consume a
"sub-chip" table (the spreading waveform sampled at sc_rate, one entry per
sub-chip) plus rates.  BPSK signals use the code itself; BOC(1,1) signals
(Galileo E1) use the 2x-rate sub-chip expansion so the same NCO and
correlator handle the square-wave subcarrier (the role of the reference's
sinboc replica generation, galileo_e1_signal_replica.cc).

The Galileo E1-B/E1-C primary codes are ICD memory codes: the port ships its
own copy of their packed-bit rows, ``data/galileo_e1_codes.npz`` (the public
Galileo OS SIS ICD tables, reference Galileo_E1.h:56,760).  Chip convention
of the reference's hex_to_binary_converter (gnss_signal_replica.cc:43): bit
0 -> +1.0, bit 1 -> -1.0.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.ops import prn_codes


@dataclasses.dataclass(frozen=True)
class SignalDef:
    system: str          # "GPS" | "Galileo"
    signal: str          # "1C" | "1B"
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

_GALILEO_ASSET = os.path.join(os.path.dirname(__file__), "data",
                              "galileo_e1_codes.npz")


@functools.lru_cache(maxsize=1)
def _galileo_tables() -> dict:
    """Packed-bit Galileo E1 ICD code tables (see module docstring)."""
    with np.load(_GALILEO_ASSET) as z:
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
    raise NotImplementedError(f"signal {sig.signal} is not ported")


@dataclasses.dataclass(frozen=True)
class CodeProvider:
    """prn -> +-1 sub-chip table of one signal component, as the engines'
    `code_provider` takes it.  A value object (unlike a lambda) so that two
    receiver configurations built from the same conf compare equal.

    component "B": the signal's data code (:func:`subchip_table`); "C": the
    Galileo E1-C pilot primary, BOC(1,1)-expanded."""
    signal: str = "1C"
    component: str = "B"

    def __call__(self, prn: int) -> np.ndarray:
        if self.component == "C":
            if self.signal != "1B":
                raise NotImplementedError(
                    f"pilot code of signal {self.signal} is not ported")
            return boc11_expand(galileo_e1_code(prn, "C"))
        return subchip_table(SIGNALS[self.signal], prn)


SIGNALS = {"1C": GPS_L1CA, "1B": GALILEO_E1B}
