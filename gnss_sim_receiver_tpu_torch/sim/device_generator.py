"""Device-side batch signal synthesizer (kernel K6), PyTorch port of
``gnss_sim_receiver_tpu.sim.device_generator``.

Same signal model as :mod:`sim.signal_generator` (rectangular chips,
delay and Doppler linearized per 8192-sample anchor block, C/N0-scaled
amplitude, complex AWGN), synthesized for all satellites at once on the
card:

- the per-(satellite, block) anchors are computed on the host in float64
  (:func:`_anchors`, a copy of the JAX package's, bit for bit);
- the per-sample float32 expansion (the code-chip and nav-symbol gathers,
  the carrier rotation, the sum over satellites and the noise) is one
  launch of ``csrc/device_generator.cu`` per chunk (:func:`expand`), which
  writes the interleaved complex64 samples once: a thread makes 8 samples
  of one anchor block, the chip and symbol indices advanced from one to
  the next without a division.  :func:`_expand_reference` launches the
  one-thread-per-sample kernel that this one replaced, whose bits it
  repeats (checked on the card only).

The noise is counter-based (Philox4x32-10 keyed by a seed drawn from a
``torch.Generator``, counted by the absolute sample index), so the card's
capture does not depend on the chunking or on the launch layout.  The plain
version (:func:`_expand_plain`, CPU tensors only) draws its noise with
``torch.randn`` chunk by chunk, so a noisy CPU capture does change with
`chunk_samples` (its noiseless samples do not).  The two noise realizations
differ, as the JAX package's already differ from the host generator's,
while the noiseless samples agree.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import (check_kernel_device, require,
                                                resolve_device, upload)
from gnss_sim_receiver_tpu_torch.ops import cuda_build
from gnss_sim_receiver_tpu_torch.sim import signal_generator as sg

_B = 8192               # anchor block (matches sg._ANCHOR_BLOCK semantics)
_NOISE_SCALE = float(np.float32(np.sqrt(0.5)))


def _sat_tables(sats):
    """Padded code/bit tables + geometry params for the batch."""
    codes, bit_arrs, sps, lcs = [], [], [], []
    for sat in sats:
        code, _, sc_per_sym = sg._sig_params(sat)
        codes.append(np.asarray(code, np.float32))
        bit_arrs.append(np.asarray(sat.nav_bits, np.float32))
        sps.append(sc_per_sym)
        lcs.append(len(code))
    lc_max = max(lcs)
    nb_max = max(len(b) for b in bit_arrs)
    code_pad = np.zeros((len(sats), lc_max), np.float32)
    bits_pad = np.zeros((len(sats), nb_max), np.float32)
    for i, (c, b) in enumerate(zip(codes, bit_arrs)):
        code_pad[i, :len(c)] = c
        bits_pad[i, :len(b)] = b
    return (code_pad, np.asarray(lcs, np.int32), bits_pad,
            np.asarray([len(b) for b in bit_arrs], np.int32),
            np.asarray(sps, np.int32))


def _anchors(sats, fs, start_sample, nblk, amp_fs):
    """Host-side float64 per-(sat, block) linearization (the anchor math of
    sg._sat_signal_block, vectorized over sats x blocks)."""
    S = len(sats)
    f_c = constants.GPS_L1_FREQ_HZ
    base = np.zeros((S, nblk), np.int64)
    frac = np.zeros((S, nblk), np.float32)
    crate = np.zeros((S, nblk), np.float32)
    ph0 = np.zeros((S, nblk), np.float32)
    phr = np.zeros((S, nblk), np.float32)
    amp = np.zeros(S, np.float32)
    s_b = start_sample + _B * np.arange(nblk, dtype=np.float64)
    t_b = s_b / fs
    for i, sat in enumerate(sats):
        _, code_rate, _ = sg._sig_params(sat)
        icd_chip_rate = (code_rate / 2.0 if sat.signal in ("1B", "1P")
                         else code_rate)
        delay0 = sat.delay_sec + sat.delay_chips / icd_chip_rate
        dop_code0 = (sat.code_doppler_hz if sat.code_doppler_hz is not None
                     else sat.doppler_hz)
        f_code = sat.carrier_ref_hz or f_c
        delay_b = delay0 - (dop_code0 / f_code) * t_b \
            - (sat.doppler_rate_hz_s / f_code) * t_b * t_b / 2.0
        chipf_b = (t_b - delay_b) * code_rate
        dop_b = sat.doppler_hz + sat.doppler_rate_hz_s * t_b
        dopc_b = dop_code0 + sat.doppler_rate_hz_s * t_b
        base[i] = np.floor(chipf_b).astype(np.int64)
        frac[i] = (chipf_b - np.floor(chipf_b)).astype(np.float32)
        crate[i] = (code_rate * (1.0 + dopc_b / f_code)
                    / fs).astype(np.float32)
        ph0[i] = np.mod(2.0 * np.pi * (sat.doppler_hz * t_b
                                       + sat.doppler_rate_hz_s
                                       * t_b * t_b / 2.0)
                        + sat.carrier_phase_rad,
                        2.0 * np.pi).astype(np.float32)
        phr[i] = (2.0 * np.pi * dop_b / fs).astype(np.float32)
        amp[i] = sg.cn0_to_amplitude(sat.cn0_db_hz, amp_fs or fs)
    return base, frac, crate, ph0, phr, amp


# ---- K6: the per-sample expansion ------------------------------------------

def _plain_indices(code_len, bits_len, sc_per_sym, base, frac, crate):
    """The plain version's table indices of every sample of [S, nblk]
    anchors, [S, nblk * 8192] int64 each: k = base + floor(frac + crate *
    nloc), the chip k mod Lc and the symbol (k div sps) mod Nb (floor
    operations)."""
    nloc = torch.arange(_B, dtype=torch.float32, device=frac.device)
    chip_off = frac[..., None] + crate[..., None] * nloc      # [S, nblk, b]
    k = (base[..., None].to(torch.int64)
         + torch.floor(chip_off).to(torch.int32)).reshape(len(base), -1)
    lc = code_len.to(torch.int64)[:, None]
    nb = bits_len.to(torch.int64)[:, None]
    sps = sc_per_sym.to(torch.int64)[:, None]
    return torch.remainder(k, lc), torch.remainder(
        torch.div(k, sps, rounding_mode="floor"), nb)


def _expand_plain(codes, code_len, bits, bits_len, sc_per_sym, base, frac,
                  crate, ph0, phr, amp, n: int) -> torch.Tensor:
    """Plain version of K6 without noise, line for line with the JAX
    package's ``_expand_chunk``: [S, nblk] anchors -> complex64 [n]."""
    chip_i, sym_i = _plain_indices(code_len, bits_len, sc_per_sym, base,
                                   frac, crate)
    chip = torch.gather(codes.to(torch.float32), 1, chip_i)
    sym = torch.gather(bits.to(torch.float32), 1, sym_i)
    cv = chip * sym
    nloc = torch.arange(_B, dtype=torch.float32, device=frac.device)
    ph = (ph0[..., None] + phr[..., None] * nloc).reshape(cv.shape)
    av = amp[:, None]
    re = (cv * av * torch.cos(ph)).sum(dim=0)
    im = (cv * av * torch.sin(ph)).sum(dim=0)
    return torch.complex(re, im)[:n]


def expand(codes: torch.Tensor, code_len: torch.Tensor, bits: torch.Tensor,
           bits_len: torch.Tensor, sc_per_sym: torch.Tensor,
           base: torch.Tensor, frac: torch.Tensor, crate: torch.Tensor,
           ph0: torch.Tensor, phr: torch.Tensor, amp: torch.Tensor,
           n: int, *, blk0: int = 0, noise_key: int | None = None,
           sample0: int = 0, generator: torch.Generator | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """K6 wrapper: `n` samples of every satellite summed, from anchor block
    `blk0` of the [S, NBLK] anchor tensors (int32 `base`, float32 `frac`,
    `crate`, `ph0`, `phr`), with the int8 +-1 tables `codes` [S, Lc] and
    `bits` [S, Nb] (int32 `code_len`, `bits_len`, `sc_per_sym` [S]) and
    float32 `amp` [S].  Writes complex64 [n] into `out` when given.

    Noise (unit complex variance) is added when `noise_key` is not None:
    on the card Philox4x32-10 keyed by `noise_key` and counted by the
    absolute sample index `sample0 + i`; on the CPU ``torch.randn`` drawn
    from `generator` for this call's `n` samples (so it depends on how a
    capture is cut into calls).  Launches ``csrc/device_generator.cu`` for CUDA
    tensors (counted in ``expand.launches``) and runs the plain version for
    CPU tensors."""
    nblk = -(-n // _B)
    if not check_kernel_device(frac, "expand"):
        sl = slice(blk0, blk0 + nblk)
        y = _expand_plain(codes, code_len, bits, bits_len, sc_per_sym,
                          base[:, sl], frac[:, sl], crate[:, sl],
                          ph0[:, sl], phr[:, sl], amp, n)
        if noise_key is not None:
            z = torch.randn((2, n), dtype=torch.float32, generator=generator)
            y = torch.complex(y.real + _NOISE_SCALE * z[0],
                              y.imag + _NOISE_SCALE * z[1])
        if out is None:
            return y
        out.copy_(y)
        return out
    out = _launch("device_generator", codes, code_len, bits, bits_len,
                  sc_per_sym, base, frac, crate, ph0, phr, amp, n, blk0,
                  noise_key, sample0, out)
    expand.launches += 1
    return out


expand.launches = 0


def _expand_reference(codes, code_len, bits, bits_len, sc_per_sym, base,
                      frac, crate, ph0, phr, amp, n: int, *, blk0: int = 0,
                      noise_key: int | None = None, sample0: int = 0,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """K6 before its redesign (one thread per sample, every index by floor
    division): the bit-for-bit reference of :func:`expand` on the card,
    CUDA tensors only; on no path, not counted."""
    return _launch("device_generator_reference", codes, code_len, bits,
                   bits_len, sc_per_sym, base, frac, crate, ph0, phr, amp, n,
                   blk0, noise_key, sample0, out)


def _launch(symbol, codes, code_len, bits, bits_len, sc_per_sym, base, frac,
            crate, ph0, phr, amp, n, blk0, noise_key, sample0, out):
    """Check the CUDA tensors and launch the library's `symbol`."""
    dev = frac.device
    n_sat, n_blocks = frac.shape
    for name, t, dt in (("codes", codes, torch.int8),
                        ("bits", bits, torch.int8),
                        ("code_len", code_len, torch.int32),
                        ("bits_len", bits_len, torch.int32),
                        ("sc_per_sym", sc_per_sym, torch.int32),
                        ("base", base, torch.int32),
                        ("frac", frac, torch.float32),
                        ("crate", crate, torch.float32),
                        ("ph0", ph0, torch.float32),
                        ("phr", phr, torch.float32),
                        ("amp", amp, torch.float32)):
        require(t, dt, dev, f"expand: {name}")
    if not (codes.shape[0] == bits.shape[0] == n_sat
            and base.shape == frac.shape == crate.shape == ph0.shape
            == phr.shape and amp.shape == (n_sat,)):
        raise ValueError("expand: tables and anchors disagree on S")
    if n < 1 or blk0 < 0 or blk0 + -(-n // _B) > n_blocks:
        raise ValueError("expand: samples beyond the anchors")
    if out is None:
        out = torch.empty(n, dtype=torch.complex64, device=dev)
    require(out, torch.complex64, dev, "expand: out")
    if out.shape != (n,):
        raise ValueError("expand: out must be complex64 [n]")
    err = getattr(_lib(), symbol)(
        codes.data_ptr(), code_len.data_ptr(), codes.shape[1],
        bits.data_ptr(), bits_len.data_ptr(), bits.shape[1],
        sc_per_sym.data_ptr(), base.data_ptr(), frac.data_ptr(),
        crate.data_ptr(), ph0.data_ptr(), phr.data_ptr(), amp.data_ptr(),
        n_sat, n_blocks, blk0, n, 0 if noise_key is None else 1,
        0 if noise_key is None else int(noise_key), sample0, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, symbol)
    return out


def _lib():
    lib = cuda_build.load("device_generator")
    p, i, ll, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)
    for fn in (lib.device_generator, lib.device_generator_reference):
        if fn.restype is not ctypes.c_int or fn.argtypes is None:
            fn.argtypes = [p, p, i, p, p, i, p, p, p, p, p, p, p, i, ll, ll,
                           ll, i, ull, ll, p, p]
            fn.restype = ctypes.c_int
    return lib


# ---- the generator's entry points ------------------------------------------

def _fill_nav_bits(sats, seed: int) -> None:
    """Random nav bits for the satellites without any, drawn as the JAX
    package draws them, so both packages synthesize the same bits."""
    rng = np.random.default_rng(seed)
    for sat in sats:
        if sat.nav_bits is None:
            sat.nav_bits = (rng.integers(0, 2, 1500) * 2 - 1).astype(np.int8)


def _prepare(sats, fs, n_samples, start_sample, device):
    """The tables and the anchors of the whole capture on `device`: one
    float64 anchor computation on the host (the anchors of every chunk of
    the JAX package's chunked run, since a chunk is a whole number of
    blocks), checked against the int32 range of the sub-chip index."""
    codes, lcs, bits, nbs, sps = _sat_tables(sats)
    nblk = -(-n_samples // _B)
    base, frac, crate, ph0, phr, amp = _anchors(sats, fs, start_sample, nblk,
                                                None)
    if (base + int(np.ceil(crate.max() * _B)) + 1).max() >= 2 ** 31:
        raise OverflowError("scenario too long for int32 chip indices")
    host = (codes.astype(np.int8), lcs, bits.astype(np.int8), nbs, sps,
            base.astype(np.int32), frac, crate, ph0, phr, amp)
    return [upload(a, device) for a in host]


def _noise_key(noise: bool, seed: int, generator):
    """The Philox key drawn from `generator` (or a CPU generator seeded
    with `seed`), and that generator for the plain version's noise."""
    if not noise:
        return None, None
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    key = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                            device=generator.device))
    return key, generator


def _check_chunk(chunk_samples: int) -> int:
    if chunk_samples < _B or chunk_samples % _B:
        raise ValueError("chunk_samples must be a positive multiple of the "
                         f"{_B}-sample anchor block")
    return int(chunk_samples)


def generate_baseband_device_resident(sats, fs: float, n_samples: int, *,
                                      start_sample: int = 0,
                                      noise: bool = True, seed: int = 0,
                                      generator: torch.Generator | None = None,
                                      chunk_samples: int = 4_194_304,
                                      device=None) -> torch.Tensor:
    """`n_samples` of complex64 baseband from absolute sample
    `start_sample`, kept on `device` as one tensor (the zero-transfer input
    of ``Receiver.process_array``).  `device=None` means the CUDA card and
    raises without one.  Nav bits that are None are drawn from
    ``np.random.default_rng(seed)``; the noise from `generator` (a CPU
    ``torch.Generator``; default: one seeded with `seed`).  One K6 launch
    per `chunk_samples` (a multiple of 8192)."""
    device = resolve_device(device)
    chunk = _check_chunk(chunk_samples)
    _fill_nav_bits(sats, seed)
    tabs = _prepare(sats, fs, n_samples, start_sample, device)
    key, gen = _noise_key(noise, seed, generator)
    out = torch.empty(n_samples, dtype=torch.complex64, device=device)
    for pos in range(0, n_samples, chunk):
        n = min(chunk, n_samples - pos)
        expand(*tabs, n, blk0=pos // _B, noise_key=key,
               sample0=start_sample + pos, generator=gen,
               out=out[pos:pos + n])
    return out


def generate_baseband_device(sats, fs: float, n_samples: int, *,
                             start_sample: int = 0, noise: bool = True,
                             seed: int = 0,
                             generator: torch.Generator | None = None,
                             chunk_samples: int = 2_097_152,
                             device=None) -> np.ndarray:
    """generate_baseband_device_resident, chunk by chunk, into a host
    complex64 array (a drop-in for ``sim.generate_baseband``: the noise
    streams differ, the statistics match)."""
    device = resolve_device(device)
    chunk = _check_chunk(chunk_samples)
    _fill_nav_bits(sats, seed)
    tabs = _prepare(sats, fs, n_samples, start_sample, device)
    key, gen = _noise_key(noise, seed, generator)
    out = np.empty(n_samples, np.complex64)
    buf = torch.empty(min(chunk, n_samples), dtype=torch.complex64,
                      device=device)
    for pos in range(0, n_samples, chunk):
        n = min(chunk, n_samples - pos)
        y = expand(*tabs, n, blk0=pos // _B, noise_key=key,
                   sample0=start_sample + pos, generator=gen, out=buf[:n])
        out[pos:pos + n] = y.cpu().numpy()
    return out
