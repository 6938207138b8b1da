"""The CRC and the convolutional code that Galileo I/NAV and F/NAV and GPS
CNAV share, in NumPy.

- :func:`crc24q`: CRC-24Q (poly per RTCM / IS-GPS-705);
- :func:`conv27_encode`: the K=7 rate-1/2 convolutional encoder (G1=171o,
  G2=133o), with the G2 output inverted for Galileo (ICD figure 13; the
  reference undoes it at galileo_telemetry_decoder_gs.cc:360-368 by
  negating the odd-index symbols) and plain for CNAV;
- :func:`viterbi27_decode`: its soft-decision Viterbi decoder.

The JAX package calls a C helper library for the CNAV encoder and for the
decoder (``gnss_sim_receiver_tpu.native``, native/viterbi27.cc); the port
keeps these NumPy versions, bit-exact with it.
"""

from __future__ import annotations

import numpy as np

_CRC24Q_POLY = 0x1864CFB
_G1, _G2 = 0o171, 0o133


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q over a {0,1} bit array, MSB-first, zero initial value."""
    reg = 0
    for b in np.asarray(bits, dtype=np.int64):
        reg ^= int(b) << 23
        reg <<= 1
        if reg & 0x1000000:
            reg ^= _CRC24Q_POLY
    return reg & 0xFFFFFF


def conv27_encode(bits: np.ndarray, invert_g2: bool = False) -> np.ndarray:
    """Hard bits -> 2n symbols {0,1} (int64): per bit the G1 then the G2
    parity of the 7-bit register, the G2 one inverted with `invert_g2`
    (Galileo)."""
    reg = 0
    out = np.empty(2 * len(bits), dtype=np.int64)
    for i, b in enumerate(np.asarray(bits, dtype=np.int64)):
        reg = ((int(b) << 6) | (reg >> 1)) & 0x7F
        out[2 * i] = bin(reg & _G1).count("1") & 1
        o2 = bin(reg & _G2).count("1") & 1
        out[2 * i + 1] = (o2 ^ 1) if invert_g2 else o2
    return out


def _trellis():
    """For every next state ns of the 64-state K=7 trellis: its input bit,
    its two predecessor states (even, odd) and each branch's (G1, G2)
    output bits."""
    ns = np.arange(64)
    inp = ns >> 5
    pred = np.stack([(ns & 31) << 1, ((ns & 31) << 1) | 1])       # [2, 64]
    reg = (inp[None, :] << 6) | pred

    def parity(v):
        return np.array([bin(int(r)).count("1") & 1 for r in v.ravel()]
                        ).reshape(v.shape)
    return inp, pred, parity(reg & _G1), parity(reg & _G2)


_INP, _PRED, _OUT_G1, _OUT_G2 = _trellis()
# branch signs: +s for an output bit 1, -s for 0 (a product with +-1 is
# exact, so the metrics equal the decoder's negations bit for bit)
_SIGN_G1 = (2 * _OUT_G1 - 1).astype(np.float32)                   # [2, 64]
_SIGN_G2 = (2 * _OUT_G2 - 1).astype(np.float32)


def viterbi27_decode(soft_symbols: np.ndarray) -> np.ndarray:
    """K=7 rate-1/2 (G1=171o, G2=133o) soft-decision Viterbi decoder with
    full traceback: 2n soft symbols (> 0 ~ bit 1) -> n bits {0,1}.

    The add-compare-select of the JAX package's native decoder
    (native/viterbi27.cc), vectorized over the 64 states: float32 path
    metrics summed in the same order, the even predecessor kept on a tie
    (both branches then carry the same metric), the first best end state.
    The branch metrics of every step are formed in one pass before the
    recursion."""
    sym = np.ascontiguousarray(soft_symbols, dtype=np.float32)
    n_bits = len(sym) // 2
    s = sym[:2 * n_bits].reshape(n_bits, 2)
    b0 = s[:, 0, None, None] * _SIGN_G1                         # [T, 2, 64]
    b1 = s[:, 1, None, None] * _SIGN_G2
    pm = np.full(64, -1e30, np.float32)
    pm[0] = 0.0
    odd = np.empty((n_bits, 64), bool)
    for t in range(n_bits):
        nm = (pm[_PRED] + b0[t]) + b1[t]
        np.greater(nm[1], nm[0], out=odd[t])
        pm = np.maximum(nm[0], nm[1])
    decisions = odd.astype(np.uint8) | (_INP << 1).astype(np.uint8)
    bits = np.empty(n_bits, np.uint8)
    state = int(np.argmax(pm))
    for t in range(n_bits - 1, -1, -1):
        d = int(decisions[t, state])
        bits[t] = (d >> 1) & 1
        state = ((state << 1) | (d & 1)) & 63
    return bits
