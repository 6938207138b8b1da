"""Reed-Solomon codec over GF(2^8) for the Galileo E6-B HAS service.

The HAS SIS ICD 1.0 (section 6.2) specifies an RS(255, 32) code: 32
information octets, 223 parity octets, field generator
p(x) = x^8 + x^4 + x^3 + x^2 + 1 (0x11D), code generator roots
alpha^1 .. alpha^223 (fcr = 1, prim = 1).  The receiver mostly performs
ERASURE decoding: every received HAS page is a correct code symbol with a
known position (its PID), missing pages are erasures — any 32 distinct
pages out of 255 recover the message.

Role equivalent of the reference's reed_solomon.cc (ReedSolomon class,
E6B configuration reed_solomon.cc:24-35); implemented from the standard
errors-and-erasures algorithm (syndromes -> erasure-initialized
Berlekamp-Massey -> Chien search -> Forney) with NumPy table arithmetic.

Copy of ``gnss_sim_receiver_tpu.nav.reed_solomon`` for the PyTorch port (the
port imports nothing from the JAX package). Its decoder computes what the
JAX module's computes, symbol for symbol, in fewer NumPy calls: the erasure
locator's factors multiplied in from the left, the Berlekamp-Massey
discrepancy and the Forney magnitudes each in one vector operation (the JAX
module takes about 1.3 s of CPU a column at 223 erasures, 70 s a HAS message
of 53 columns).
"""

from __future__ import annotations

import numpy as np

FIELD_POLY = 0x11D   # x^8 + x^4 + x^3 + x^2 + 1
N = 255              # code length (symbols)
K = 32               # information symbols (HAS E6B)
NROOTS = N - K       # 223 parity symbols
FCR = 1              # first consecutive root exponent

# --- GF(256) log/antilog tables ----------------------------------------------
_EXP = np.zeros(510, np.int64)
_LOG = np.zeros(256, np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= FIELD_POLY
_EXP[255:510] = _EXP[:255]


def gf_mul(a, b):
    """Element-wise GF(256) product (0-safe)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    out = _EXP[(_LOG[a] + _LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_inv(a):
    return _EXP[(255 - _LOG[np.asarray(a, np.int64)]) % 255]


def _poly_eval(poly: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Evaluate poly (ascending powers: poly[i] * x^i) at each xs."""
    acc = np.zeros(len(xs), np.int64)
    for c in poly[::-1]:
        acc = gf_mul(acc, xs) ^ int(c)
    return acc


def _poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + len(b) - 1, np.int64)
    for i, c in enumerate(a):
        if c:
            out[i:i + len(b)] ^= gf_mul(int(c), b)
    return out


def _poly_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(max(len(a), len(b)), np.int64)
    out[:len(a)] ^= a
    out[:len(b)] ^= b
    return out


# generator g(x) = prod_{j=0}^{nroots-1} (x - alpha^{fcr+j}), ascending
_GENPOLY = np.array([1], np.int64)
for _j in range(NROOTS):
    _GENPOLY = _poly_mul(np.array([_EXP[FCR + _j], 1], np.int64), _GENPOLY)
_TAPS = _GENPOLY[:-1][::-1].copy()   # g_{nroots-1} .. g_0 (LFSR taps)


def encode(info: np.ndarray) -> np.ndarray:
    """Systematic RS(255,32) codeword [info(32) | parity(223)] from 32
    information octets (HAS C-matrix column layout: PIDs 1..32 carry the
    information symbols, PIDs 33..255 the parity symbols)."""
    info = np.asarray(info, np.int64)
    if len(info) != K:
        raise ValueError(f"need {K} info octets, got {len(info)}")
    rem = np.zeros(NROOTS, np.int64)
    for sym in info:
        feedback = int(rem[0]) ^ int(sym)
        rem = np.concatenate([rem[1:], [0]])
        if feedback:
            rem ^= gf_mul(feedback, _TAPS)
    return np.concatenate([info, rem])


def _position_exp(pos: np.ndarray) -> np.ndarray:
    """Field exponent of a codeword position: index 0 is the X^{n-1}
    coefficient (first transmitted symbol), index n-1 is X^0."""
    return (N - 1 - np.asarray(pos, np.int64)) % 255


def decode(codeword: np.ndarray, erasure_pos=()) -> np.ndarray | None:
    """Errors-and-erasures decode of a 255-symbol word; erasure_pos are
    0-based positions known missing (their values are ignored).  Returns
    the corrected word or None on decoding failure."""
    r = np.asarray(codeword, np.int64).copy()
    if len(r) != N:
        raise ValueError(f"need {N} symbols, got {len(r)}")
    eras = sorted({int(e) for e in erasure_pos})
    if len(eras) > NROOTS:
        return None
    r[eras] = 0

    xs = _EXP[FCR + np.arange(NROOTS)]
    synd = _poly_eval(r[::-1], xs)
    if not synd.any():
        return r

    # erasure locator Gamma(x) = prod (1 - alpha^{e'} x), each factor
    # multiplied in from the left (two passes over Gamma, not len(Gamma))
    gamma = np.array([1], np.int64)
    for e in eras:
        gamma = _poly_mul(np.array([1, _EXP[_position_exp(e)]], np.int64),
                          gamma)

    # Berlekamp-Massey initialized with the erasure locator
    lam = gamma.copy()
    prev = gamma.copy()
    l_deg = len(eras)
    for n_i in range(len(eras), NROOTS):
        # discrepancy d = sum_i lam_i * S_{n_i - i}, over the i with
        # 0 <= n_i - i < NROOTS (a zero lam_i adds nothing)
        i = np.arange(len(lam))
        m = (n_i - i >= 0) & (n_i - i < NROOTS)
        d = int(np.bitwise_xor.reduce(gf_mul(lam[m], synd[n_i - i[m]]),
                                      initial=0))
        prev = np.concatenate([[0], prev])         # prev *= x
        if d != 0:
            if 2 * l_deg <= n_i + len(eras):
                lam_new = _poly_add(lam, gf_mul(d, prev))
                prev = gf_mul(gf_inv(d), lam)
                lam = lam_new
                l_deg = n_i + 1 - l_deg + len(eras)
            else:
                lam = _poly_add(lam, gf_mul(d, prev))

    # Chien search over all positions
    pe = _position_exp(np.arange(N))
    vals = _poly_eval(lam, gf_inv(_EXP[pe]))
    err_pos = np.flatnonzero(vals == 0)
    deg = int(np.flatnonzero(lam)[-1]) if lam.any() else 0
    if len(err_pos) != deg:
        return None

    # Forney with fcr=1: magnitude = Omega(X^-1) / Lambda'(X^-1), at every
    # error position at once
    omega = _poly_mul(lam, synd.astype(np.int64))[:NROOTS]
    deriv = np.zeros(max(len(lam) - 1, 1), np.int64)
    deriv[0::2] = lam[1::2]                        # formal derivative
    x_inv = gf_inv(_EXP[pe[err_pos]])
    num = _poly_eval(omega, x_inv)
    den = _poly_eval(deriv, x_inv)
    if (den == 0).any():
        return None
    r[err_pos] ^= gf_mul(num, gf_inv(den))

    if _poly_eval(r[::-1], xs).any():
        return None
    return r


def _poly_eval_rows(polys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """_poly_eval of each row of `polys` [n, L] (ascending powers) at `xs`
    -> [n, len(xs)]."""
    acc = np.zeros((len(polys), len(xs)), np.int64)
    for c in polys[:, ::-1].T:
        acc = gf_mul(acc, xs) ^ c[:, None]
    return acc


def decode_columns(words: np.ndarray, erasure_pos=()) -> np.ndarray | None:
    """:func:`decode` of every row of `words` [n, 255] under the same
    erasures: the corrected rows [n, 255], or None where any row fails.
    With exactly NROOTS erasures (what the HAS assembler meets when a
    message's `size` pages are in: every other PID erased but the known
    zero rows) the erasure locator, the Chien search and the Forney
    denominators are the rows' common ones, and the syndromes and
    magnitudes are formed for all rows at once; other erasure counts go
    row by row."""
    words = np.asarray(words, np.int64)
    eras = sorted({int(e) for e in erasure_pos})
    if len(eras) != NROOTS:
        out = [decode(w, eras) for w in words]
        return None if any(o is None for o in out) else np.stack(out)
    r = words.copy()
    r[:, eras] = 0
    xs = _EXP[FCR + np.arange(NROOTS)]
    synd = _poly_eval_rows(r[:, ::-1], xs)
    todo = synd.any(axis=1)              # the rows decode() would correct
    if not todo.any():
        return r
    lam = np.array([1], np.int64)        # Berlekamp-Massey runs no step
    for e in eras:
        lam = _poly_mul(np.array([1, _EXP[_position_exp(e)]], np.int64), lam)
    pe = _position_exp(np.arange(N))
    err_pos = np.flatnonzero(_poly_eval(lam, gf_inv(_EXP[pe])) == 0)
    if len(err_pos) != int(np.flatnonzero(lam)[-1]):
        return None
    omega = np.zeros((len(r), len(lam) + NROOTS - 1), np.int64)
    for i, c in enumerate(lam):
        if c:
            omega[:, i:i + NROOTS] ^= gf_mul(int(c), synd)
    deriv = np.zeros(len(lam) - 1, np.int64)
    deriv[0::2] = lam[1::2]
    x_inv = gf_inv(_EXP[pe[err_pos]])
    den = _poly_eval(deriv, x_inv)
    if (den == 0).any():
        return None
    num = _poly_eval_rows(omega[todo, :NROOTS], x_inv)
    r[np.ix_(todo, err_pos)] ^= gf_mul(num, gf_inv(den)[None, :])
    if _poly_eval_rows(r[todo, ::-1], xs).any():
        return None
    return r

