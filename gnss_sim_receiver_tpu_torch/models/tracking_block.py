"""Block-processing tracking, PyTorch port of
``gnss_sim_receiver_tpu.models.tracking_block`` (dll_pll: GPS L1 C/A, and
Galileo E1 with 5 taps, on E1-B data or on the E1-C pilot).

One step per BLOCK of `e_block` epochs (~20 ms: 20 GPS epochs, 5 E1
epochs), with the loops closing at block cadence:

- the chunk is cut into a fixed grid of overlapping windows (length
  :func:`block_fft_size`, stride one code period) and FFT'd ONCE for all
  channels: ``torch.fft`` over an ``as_strided`` view of the padded chunk;
- the carrier wipeoff lives in the replica: each channel's band-limited
  code times its Doppler ramp exp(+j w n) is FFT'd per block ([C, F]);
- kernel K1 (:func:`block_correlate`, ``csrc/block_correlator.cu``)
  contracts window spectrum x replica spectrum x exact DTFT fractional-lag
  phasor x tap phasor over the F bins into the E/P/L correlations
  [C, E, K], building both phasors in registers — the [C, E, F] phasor and
  product tensors of the JAX program never reach device memory; each
  channel's bins are split over S CTAs (:func:`plan_k1`) whose partial
  sums the launch adds in slab order (scratch :class:`K1Scratch`);
- the DLL closes on the taps next to the prompt, E - L, whatever the tap
  count: with the 5 VEML taps [VE, E, P, L, VL] of E1 the block closure
  reads taps 1 and 3, as the JAX block closure does (tracking_block.py
  :296-299,360-363; the per-epoch path closes the VEMLP discriminator);
- the rest of the scan body is two kernels (``csrc/block_step.cu``): K8a
  (:func:`block_prologue`: epoch boundaries, K1's inputs, the ramped
  replica) before the replica FFT and K8b (:func:`block_closure`: the
  loop closure, the commit and the block's rows of the [T, C] output
  planes) after K1.  Their plain versions, :func:`_block_prologue_plain`
  and :func:`_block_closure_plain`, are the JAX body's operations in its
  order; the CPU runs them.  On the card K8b runs in K1's epilogue
  (:func:`block_correlate_close`), which also conjugates the replica
  spectrum on load, and then writes the next block's prologue from the
  state it committed (the fold): a chunk of n blocks is K8a once, then
  per block the cuFFT and the fused launch, 1 + 2n launches; the standalone K8a and K8b, and the three-launch chunk
  (``_chunk_cuda(..., fold=False)``: K8a, cuFFT, K1 with K8b per block),
  are what the fused forms are held against.

The pilot form (a track_pilot chain: ``sec_code`` and ``data_codes_rep``
given) carries a second replica family, the data code's, through the same
steps: K8a ramps both families into one [2, C, F] tensor, one batched FFT
transforms both, K1 adds the data prompt at the prompt lag as one more
column of its output, and K8b runs the block's secondary-code sync (a
cyclic-shift hard match over the last n_sec prompt signs) and wipes the
prompt and the taps beside it before the discriminators; the output
``prompt`` plane is then the data prompt.  The pilot form is its own
instantiation of each kernel: the forms every other chain launches compile
from the same code as before.

Epoch boundaries are closed-form within a block (the code NCO rate is
constant there): the cumulative sample count of epoch e is exactly
round(e*S - u0).  The kernel consumes and produces the same TrackState as
the per-epoch scan, so chunks can alternate between the two.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import (H100_SMS, check_kernel_device,
                                                require, sm_count)
from gnss_sim_receiver_tpu_torch.models.tracking import (
    F32, I32, N_SEC_MAX, PLANES, TrackState, TrackingConf, _empty_planes,
    _fl, _recip, code_rate_from_doppler, f32, pack_decim)
from gnss_sim_receiver_tpu_torch.ops import cuda_build, discriminators
from gnss_sim_receiver_tpu_torch.ops import loop_filters as lf

# window grid lead: windows start LEAD samples before their s0-grid point
# so small negative epoch-start excursions stay inside the window
_LEAD = 16


def good_size(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n (fast FFT sizes)."""
    best = 1 << int(np.ceil(np.log2(max(n, 1))))
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < n:
                p2 *= 2
            best = min(best, p2)
            p3 *= 3
        p5 *= 5
    return best


def block_fft_size(conf: TrackingConf) -> int:
    """Shared-window FFT length: any epoch that STARTS inside window w's
    first period (plus the LEAD margin and rounding drift) must fit — one
    period for the start offset + one period of replica + tap margin."""
    s0 = conf.nominal_epoch_samples
    return good_size(2 * s0 + 2 * _LEAD + 32)


def code_spectra(conf: TrackingConf, code_tables: np.ndarray,
                 device) -> torch.Tensor:
    """fs-sampled band-limited replica over one code period, zero-padded to
    the window FFT length -> [C, F] float32 on `device` (time domain: each
    block applies its Doppler ramp and FFTs it).  `code_tables` are the
    band-limited tables [C, L*K] of TrackingEngine."""
    nfft = block_fft_size(conf)
    s0 = conf.nominal_epoch_samples
    tables = np.asarray(code_tables, np.float32)
    k = tables.shape[1] // conf.code_length_chips
    idx = (np.floor(np.arange(s0, dtype=np.float64)
                    * (conf.code_rate_cps / conf.fs) * k).astype(np.int64)
           % tables.shape[1])
    z = np.zeros((tables.shape[0], nfft), np.float32)
    z[:, :s0] = tables[:, idx]
    return torch.from_numpy(z).to(device)


def _window_spectra(x_chunk: torch.Tensor, s0: int, nfft: int):
    """Overlapping fixed-grid windows (start w*s0 - LEAD, length nfft) over
    the whole chunk, FFT'd in one batch -> [W, F] complex64."""
    lead = _LEAD
    n = x_chunk.shape[0] + lead
    w = max(1, (n - nfft) // s0 + 1)
    k = (nfft + s0 - 1) // s0
    pad_to = (w + k) * s0
    xp = torch.cat([
        torch.zeros(lead, dtype=x_chunk.dtype, device=x_chunk.device),
        x_chunk,
        torch.zeros(max(0, pad_to - n), dtype=x_chunk.dtype,
                    device=x_chunk.device)])[:pad_to]
    wins = xp.as_strided((w, nfft), (s0, 1))
    return torch.fft.fft(wins, dim=-1)


# ---- kernel K1 -------------------------------------------------------------

# K1's launch plan: one wave of CTAs, K1_CTAS_PER_SM on each SM (two CTAs
# of 256 threads at ~90 registers fill an SM's register file; a second,
# ragged wave measured slower on the H100), each CTA at least K1_MIN_SLAB
# bins (one per thread)
K1_CTAS_PER_SM = 2
K1_MIN_SLAB = 256


def plan_k1(n_ch: int, n_epochs: int, nfft: int, sms: int = H100_SMS) -> int:
    """K1's slabs per channel (S) for C channels, E epochs and F bins: at
    most K1_CTAS_PER_SM CTAs per SM of a card of `sms` SMs in all, no slab
    under K1_MIN_SLAB bins.  Raises if no plan fits."""
    if not (1 <= n_ch <= 65535 and n_epochs >= 1 and 2 <= nfft < 1 << 30):
        raise ValueError(f"plan_k1: no plan for C={n_ch}, E={n_epochs}, "
                         f"F={nfft}")
    return max(1, min(K1_CTAS_PER_SM * sms // n_ch,
                      nfft // K1_MIN_SLAB))


class K1Scratch(NamedTuple):
    """K1's scratch on the card: the slabs' partial sums [C, S, E, K], one
    arrival counter per channel (0 between launches: the last CTA of a
    channel resets its own) and one fold flag per channel (the count of
    the channel's folded launches, never reset: the channel's CTAs wait
    for it to move past the value they read when they started)."""
    partials: torch.Tensor
    arrivals: torch.Tensor
    flags: torch.Tensor


def k1_scratch(n_ch: int, n_epochs: int, n_taps: int, nfft: int,
               device) -> K1Scratch:
    """K1's scratch for C channels, E epochs, K taps and F bins, planned by
    :func:`plan_k1`: allocate once, launch often."""
    slabs = plan_k1(n_ch, n_epochs, nfft, sm_count(torch.device(device)))
    return K1Scratch(
        torch.empty((n_ch, slabs, n_epochs, n_taps), dtype=torch.complex64,
                    device=device),
        torch.zeros(n_ch, dtype=torch.int32, device=device),
        torch.zeros(n_ch, dtype=torch.int32, device=device))


def _block_correlate_plain(xf_all, rf, w0, lag_int, lag_frac, ph_sc,
                           tap_samps, omega):
    """Plain version of K1, the JAX program's [C, E, F] form.  With `rf`
    [2, C, F] (the pilot's and the data code's spectra) the data prompt at
    the prompt lag is one more column: [C, E, K + 1]."""
    rfd = None
    if rf.dim() == 3:
        rf, rfd = rf[0], rf[1]
    c, e = lag_int.shape
    nfft = xf_all.shape[1]
    n_wins = xf_all.shape[0]
    two_pi = f32(2.0 * np.pi)
    f_raw = torch.arange(nfft, dtype=F32, device=xf_all.device)
    f_bins = torch.where(f_raw >= nfft // 2, f_raw - nfft, f_raw)
    rows = torch.clamp(w0.long(), 0, max(n_wins - e, 0))[:, None] \
        + torch.arange(e, device=xf_all.device)[None, :]
    xf = xf_all[rows]                                          # [C, E, F]
    f_int = f_bins.to(I32)
    prod_mod = torch.remainder(f_int[None, None, :] * lag_int[..., None],
                               nfft).to(F32)
    ang_l = (two_pi * (prod_mod + f_bins[None, None, :] * lag_frac[..., None])
             / f32(nfft) - ph_sc[..., None])                  # [C, E, F]
    pl = torch.complex(torch.cos(ang_l), torch.sin(ang_l))
    ang_t = (two_pi * f_bins[None, None, :] * tap_samps[..., None]
             / f32(nfft) - (omega[:, None] * tap_samps)[..., None])
    pt = torch.complex(torch.cos(ang_t), torch.sin(ang_t))    # [C, K, F]
    z = xf * rf[:, None, :] * pl
    corr = torch.einsum("cef,ckf->cek", z, pt) / f32(nfft)
    if rfd is None:
        return corr
    # the data prompt: the data spectrum at the PROMPT lag only (the
    # centred prompt tap's phasor is 1; the lag phasor places the replica)
    yd = xf * rfd[:, None, :]
    data = torch.sum(yd * pl, dim=-1) / f32(nfft)
    return torch.cat([corr, data[..., None]], dim=2)


def block_correlate(xf_all: torch.Tensor, rf: torch.Tensor,
                    w0: torch.Tensor, lag_int: torch.Tensor,
                    lag_frac: torch.Tensor, ph_sc: torch.Tensor,
                    tap_samps: torch.Tensor, omega: torch.Tensor,
                    out: torch.Tensor | None = None,
                    scratch: K1Scratch | None = None) -> torch.Tensor:
    """K1 wrapper: E/P/L correlations [C, E, K] complex64 of one block.

    corr[c,e,k] = 1/F sum_f xf_all[w0[c]+e, f] rf[c,f] e^{j ang_l[c,e,f]}
    e^{j ang_t[c,k,f]}, with ang_l = 2 pi ((f lag_int mod F) + f lag_frac)/F
    - ph_sc[c,e] (the int32 product reduced exactly) and ang_t = 2 pi f
    tap_samps[c,k]/F - omega[c] tap_samps[c,k]; f runs over the signed bins;
    rows clamp the start, clamp(w0, 0, W - E) + e.  With `rf` [2, C, F]
    (the pilot form: the data code's spectrum second) the data prompt
    1/F sum_f xf rfd e^{j ang_l} is column K of [C, E, K + 1].  Launches
    ``csrc/block_correlator.cu`` for CUDA tensors, with `scratch` from
    :func:`k1_scratch` (or its own), runs the plain version for CPU
    tensors; the result goes into `out` when it is given."""
    if not check_kernel_device(xf_all, "block_correlate"):
        res = _block_correlate_plain(xf_all, rf, w0, lag_int, lag_frac,
                                     ph_sc, tap_samps, omega)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((lag_int.shape[0], lag_int.shape[1],
                           tap_samps.shape[1] + (rf.dim() == 3)),
                          dtype=torch.complex64, device=xf_all.device)
    _launch_k1(_k1_args(xf_all, rf, w0, lag_int, lag_frac, ph_sc, tap_samps,
                        omega, out, scratch))
    return out


block_correlate.launches = 0


def _k1_args(xf_all, rf, w0, lag_int, lag_frac, ph_sc, tap_samps, omega,
             out, scratch: K1Scratch | None) -> tuple:
    """K1's checked launch arguments on CUDA tensors (the stream last; the
    data spectrum's pointer third, 0 but in the pilot form)."""
    dev = xf_all.device
    c, e = lag_int.shape
    k = tap_samps.shape[1]
    n_wins, nfft = xf_all.shape
    for name, t, dt in (("xf_all", xf_all, torch.complex64),
                        ("rf", rf, torch.complex64), ("w0", w0, I32),
                        ("lag_int", lag_int, I32), ("lag_frac", lag_frac, F32),
                        ("ph_sc", ph_sc, F32), ("tap_samps", tap_samps, F32),
                        ("omega", omega, F32), ("out", out, torch.complex64)):
        require(t, dt, dev, f"block_correlate: {name}")
    pilot = rf.dim() == 3
    if rf.shape[-2:] != (c, nfft) or rf.shape[:-2] not in ((), (2,)) \
            or n_wins < e:
        raise ValueError("block_correlate: shape mismatch")
    cols = k + pilot                        # the data prompt's column
    if out.shape != (c, e, cols):
        raise ValueError("block_correlate: out shape mismatch")
    if scratch is None:
        scratch = k1_scratch(c, e, cols, nfft, dev)
    slabs = scratch.partials.shape[1]
    require(scratch.partials, torch.complex64, dev,
            "block_correlate: scratch partials")
    require(scratch.arrivals, I32, dev, "block_correlate: scratch arrivals")
    require(scratch.flags, I32, dev, "block_correlate: scratch flags")
    if (scratch.partials.shape != (c, slabs, e, cols)
            or scratch.arrivals.shape != (c,) or scratch.flags.shape != (c,)
            or not 1 <= slabs <= nfft):
        raise ValueError("block_correlate: scratch shape mismatch")
    return (xf_all.data_ptr(), rf.data_ptr(),
            rf[1].data_ptr() if pilot else None, w0.data_ptr(),
            lag_int.data_ptr(), lag_frac.data_ptr(), ph_sc.data_ptr(),
            tap_samps.data_ptr(), omega.data_ptr(), out.data_ptr(), c, e, k,
            n_wins, nfft, slabs, scratch.partials.data_ptr(),
            scratch.arrivals.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)


def _launch_k1(args: tuple, close: tuple | None = None) -> None:
    """Launch K1 with :func:`_k1_args`' arguments; with `close` =
    (closure arguments, block, next block's prologue arguments as a ctypes
    pointer or None, fold flags' pointer) its fused form, which reads the
    replica spectrum unconjugated, runs K8b's closure in its epilogue and,
    given the next block's arguments, writes that block's prologue.  Counts
    every launch in ``block_correlate.launches``, the fused ones also in
    ``block_correlate_close.launches`` and those with a fold in
    ``block_correlate_close.folds`` (and in ``.fold_shapes`` by (C, E,
    F)); the fused pilot form's (a data spectrum given) also in
    ``block_correlate_close.launches_pilot`` and ``.folds_pilot``, and
    those with an FDMA bias in ``.launches_bias`` and ``.folds_bias``."""
    lib = _lib()
    pilot = args[2] is not None
    if close is None:
        cuda_build.check(lib.block_correlate(*args), "block_correlate")
    else:
        cuda_build.check(lib.block_correlate_close(*args[:-1], *close,
                                                   args[-1]),
                         "block_correlate_close")
        block_correlate_close.launches += 1
        block_correlate_close.folds += close[2] is not None
        if close[2] is not None:
            block_correlate_close.fold_shapes[args[10], args[11],
                                              args[14]] += 1
        block_correlate_close.launches_pilot += pilot
        bias = close[0].dop_bias != 0.0
        block_correlate_close.launches_bias += bias
        block_correlate_close.folds_bias += bias and close[2] is not None
        block_correlate_close.folds_pilot += pilot and close[2] is not None
    block_correlate.launches += 1


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a block library's entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    k1 = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
    for fn, types in (
            (lib.block_correlate, k1 + [p]),
            (lib.block_correlate_close,
             k1 + [_ClosureArgs, i, ctypes.POINTER(_PrologueArgs), p, p]),
            (lib.block_prologue, [_PrologueArgs, i, p]),
            (lib.block_closure, [_ClosureArgs, i, p])):
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = cuda_build.load("block_kernels")
    if lib.block_correlate.argtypes is None:
        bind(lib)
    return lib


# ---- one block of the scan: the plain versions -----------------------------

class BlockPrologue(NamedTuple):
    """One block's epoch boundaries and K1 inputs (kernel K8a's outputs)."""
    rep_t: torch.Tensor       # [C, F] complex64 Doppler-ramped replica;
    #                           [2, C, F] in the pilot form (pilot, data)
    n_cum: torch.Tensor       # [C, E] samples from pos to epoch e's start
    n_next: torch.Tensor      # [C, E] ... to epoch e's end
    n_len: torch.Tensor       # [C, E] epoch lengths, samples
    rem_end: torch.Tensor     # [C, E] code phase at epoch end, chips
    n_total: torch.Tensor     # [C] block length, samples
    rem_new: torch.Tensor     # [C] code phase after the block, chips
    w0: torch.Tensor          # [C] int32 window of epoch 0
    lag_int: torch.Tensor     # [C, E] int32 replica lag in the window
    lag_frac: torch.Tensor    # [C, E]
    ph_sc: torch.Tensor       # [C, E] carrier phase at the epoch start, rad
    tap_samps: torch.Tensor   # [C, K] tap offsets, samples
    omega: torch.Tensor       # [C] rad/sample


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values for an
    even count (jnp.median's midpoint rule; torch.median takes the lower)."""
    v = torch.sort(x, dim=-1).values
    n = v.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


def _block_prologue_plain(conf: TrackingConf, e_block: int, codes_rep,
                          taps, n_wins: int, st: TrackState) -> BlockPrologue:
    """Plain version of K8a: the closed-form epoch boundaries of the block,
    the Doppler-ramped replica and K1's window, lag and phase inputs.
    `codes_rep` [2, C, F] (the pilot's and the data code's tables) ramps
    both families with the same phasor: rep_t [2, C, F]."""
    fs = conf.fs
    dev = codes_rep.device
    s0 = conf.nominal_epoch_samples
    nfft = block_fft_size(conf)
    l_chips = f32(conf.code_length_chips)
    e_idx = torch.arange(e_block, dtype=F32, device=dev)          # [E]
    two_pi = f32(2.0 * np.pi)
    m_axis = torch.arange(nfft, dtype=F32, device=dev)[None, :]   # [1, F]
    fs32 = f32(fs)

    rate = st.code_freq                                        # [C] chips/s
    dop = st.carrier_doppler                                   # [C]
    s_per = l_chips / rate * fs32                              # [C] samples
    u0 = st.rem_code_phase / rate * fs32                       # [C] samples
    # closed-form epoch boundaries: cumulative samples of epoch e
    ecs = e_idx[None, :] * s_per[:, None] - u0[:, None]        # [C, E]
    n_cum = torch.round(ecs)
    n_next = torch.round((e_idx[None, :] + 1.0) * s_per[:, None]
                         - u0[:, None])
    n_len = n_next - n_cum
    # residual code phase at each epoch END (the per-epoch output convention)
    rem_end = (n_next - ((e_idx[None, :] + 1.0) * s_per[:, None]
                         - u0[:, None])) * rate[:, None] / fs32
    n_total = torch.round(f32(e_block) * s_per - u0)           # [C]
    rem_new = (n_total - (f32(e_block) * s_per - u0)) * rate / fs32

    # ---- the replica with the Doppler ramp (the caller FFTs it) --------
    omega = two_pi * dop / fs32                                # rad/sample
    ramp = omega[:, None] * m_axis                             # [C, F]
    rep_t = torch.complex(codes_rep * torch.cos(ramp),
                          codes_rep * torch.sin(ramp))         # [(2,) C, F]

    # ---- window selection: epoch e of channel c reads window w0_c + e --
    w0 = torch.clamp(torch.div(st.pos, s0, rounding_mode="floor"), 0,
                     max(n_wins - e_block, 0)).to(I32)

    # ---- fractional replica lag within the window ---------------------
    d_int = (st.pos - w0 * s0).to(F32)                         # [C]
    lag = (d_int[:, None] + (ecs - e_idx[None, :] * f32(s0))
           + f32(_LEAD))                                       # [C, E]
    # half-stretch correction (code Doppler within one epoch)
    stretch = (l_chips * (dop - f32(conf.doppler_bias_hz))
               / f32(conf.carrier_freq_hz))                    # chips
    lag = lag - 0.5 * stretch[:, None] / rate[:, None] * fs32
    # a POSITIVE tap advances the replica: NEGATIVE lag
    tap_samps = (-taps[None, :] / rate[:, None] * fs32)        # [C, K]
    ph_sc = st.rem_carr_phase[:, None] + omega[:, None] * (
        ecs - 0.5 * stretch[:, None] / rate[:, None] * fs32)
    lag_int = torch.round(lag)
    lag_frac = lag - lag_int
    return BlockPrologue(
        rep_t=rep_t, n_cum=n_cum, n_next=n_next, n_len=n_len,
        rem_end=rem_end, n_total=n_total, rem_new=rem_new, w0=w0,
        lag_int=lag_int.to(I32).contiguous(),
        lag_frac=lag_frac.contiguous(), ph_sc=ph_sc.contiguous(),
        tap_samps=tap_samps.contiguous(), omega=omega.contiguous())


def _sec_sync_plain(e_block: int, prompt, sec_code, st: TrackState):
    """The block's secondary-code sync (the JAX block body's, not the
    per-epoch one's): the prompt signs rolled into the sign history, a
    hard match of its last n_sec slots against every cyclic shift of the
    code, the first largest |match| a hit when it reaches n_sec; a newly
    synced active channel takes that offset and polarity.  -> (the wipe
    [C, E], sec_buf, sec_synced, sec_off, sec_polarity)."""
    dev = prompt.device
    n_sec = sec_code.shape[0]
    sign_e = torch.where(prompt.real >= 0, 1.0, -1.0)          # [C, E]
    buf = torch.cat([st.sec_buf[:, e_block % N_SEC_MAX:],
                     sign_e[:, -min(e_block, N_SEC_MAX):]],
                    dim=1)[:, -N_SEC_MAX:]
    last = buf[:, N_SEC_MAX - n_sec:]                          # [C, n_sec]
    e_last = st.epoch + e_block - 1
    j = torch.arange(n_sec, device=dev)
    # chip expected at slot j for offset o:
    # sec[(e_last - (n_sec-1-j) + o) mod n_sec]
    idx = torch.remainder(e_last[:, None, None] - (n_sec - 1 - j)[None, None, :]
                          + j[None, :, None], n_sec)
    m = torch.einsum("cj,coj->co", last, sec_code[idx])        # [C, O]
    best = torch.argmax(torch.abs(m), dim=1)
    best_val = torch.gather(m, 1, best[:, None])[:, 0]
    hit = torch.abs(best_val) >= f32(n_sec)
    newly = hit & ~st.sec_synced & st.active
    synced = st.sec_synced | newly
    off = torch.where(newly, best.to(I32), st.sec_off)
    pol = torch.where(newly, torch.sign(best_val), st.sec_polarity)
    epoch_g = st.epoch[:, None] + torch.arange(e_block, device=dev)[None, :]
    chip = sec_code[torch.remainder(epoch_g + off[:, None], n_sec)] \
        * pol[:, None]
    wipe = torch.where(synced[:, None], chip, 1.0)
    return wipe, buf, synced, off, pol


def _block_closure_plain(conf: TrackingConf, e_block: int, corr,
                         pro: BlockPrologue, st: TrackState, sec_code=None):
    """Plain version of K8b: the loop closure of one block from its
    correlations [C, E, K] -> (the next TrackState, the block's [E, C]
    output planes).  A K + 1-th column of `corr` is the data prompt (the
    pilot form), which becomes the ``prompt`` plane; with `sec_code` (the
    +-1 secondary code [n_sec]) the block's secondary-code sync wipes the
    prompt and its neighbours before the discriminators."""
    fs = conf.fs
    dev = corr.device
    s0 = conf.nominal_epoch_samples
    c_ch = corr.shape[0]
    two_pi = f32(2.0 * np.pi)
    fs32 = f32(fs)
    n_taps = pro.tap_samps.shape[1]
    prompt_i = n_taps // 2
    act = st.active
    rate = st.code_freq
    dop = st.carrier_doppler
    n_cum, n_next, n_len = pro.n_cum, pro.n_next, pro.n_len
    rem_end, n_total, rem_new = pro.rem_end, pro.n_total, pro.rem_new

    prompt = corr[:, :, prompt_i]                              # [C, E]
    early = corr[:, :, prompt_i - 1]
    late = corr[:, :, prompt_i + 1]
    data_prompt = corr[:, :, n_taps] if corr.shape[2] > n_taps else None
    epoch_g = st.epoch[:, None] + torch.arange(e_block, device=dev)[None, :]
    sec = (st.sec_buf, st.sec_synced, st.sec_off, st.sec_polarity)
    if sec_code is not None:
        wipe, *sec = _sec_sync_plain(e_block, prompt, sec_code, st)
        prompt, early, late = prompt * wipe, early * wipe, late * wipe

    # ---- per-epoch discriminators, block-averaged closure -------------
    carr_err = discriminators.pll_costas(prompt) / two_pi       # [C, E]
    code_err = discriminators.dll_nc_e_minus_l_normalized(
        torch.abs(early), torch.abs(late), f32(conf.early_late_space_chips))
    carr_err_m = torch.mean(carr_err, dim=1)
    code_err_m = torch.mean(code_err, dim=1)
    t_blk = n_total / fs32                                      # [C]
    # two-stage loops: WIDE DLL for the first 50 blocks, then narrow;
    # ext_n doubles as the blocks-in-mode counter
    settle = st.ext_n < 50
    dll_bw_eff = torch.where(settle, float(np.float32(conf.dll_bw_hz)),
                             float(np.float32(conf.dll_bw_narrow_hz)))
    # the PLL stays at the NARROW bandwidth (BL*T stability at ~20 ms)
    pll_new, pll_out = lf.third_order_step(
        st.pll, carr_err_m, f32(conf.pll_bw_narrow_hz), t_blk)
    dll_new, dll_out = lf.second_order_step(
        st.dll, code_err_m, dll_bw_eff, t_blk)
    doppler_new = pll_out
    # FLL-assisted pull-in at block cadence: the MEDIAN of the block's
    # per-epoch-pair cross-dot errors (a nav-bit flip rails one pair)
    if conf.enable_fll_pullin:
        prev_prompts = torch.cat([st.prompt_prev[:, None], prompt[:, :-1]],
                                 dim=1)
        t_pair = n_len / fs32                                   # [C, E]
        # data chains whose symbols flip every epoch (E1-B) take the
        # two-quadrant decision-directed form
        fll_fn = (discriminators.fll_cross_dot_decision
                  if conf.fll_decision_directed
                  else discriminators.fll_cross_dot)
        f_err_m = _median(fll_fn(prev_prompts, prompt, t_pair))
        if sec_code is not None and not conf.fll_decision_directed:
            # before its sync a secondary-code chain's chips flip between
            # arbitrary epochs: the two-quadrant form until then
            f_err_m = torch.where(sec[1], f_err_m, _median(
                discriminators.fll_cross_dot_decision(prev_prompts, prompt,
                                                      t_pair)))
        # engaged during pull-in AND whenever carrier lock is missing
        in_pullin = ((st.epoch < conf.fll_pullin_epochs)
                     | (st.carrier_lock < f32(conf.carrier_lock_threshold)))
        g_fll = torch.clamp(4.0 * f32(conf.fll_bw_hz) * t_blk,
                            max=float(np.float32(0.5)))
        g_eff = torch.where(st.epoch < conf.fll_pullin_epochs,
                            g_fll, 0.3 * g_fll)
        fll_nudge = torch.where(in_pullin, g_eff * f_err_m,
                                torch.zeros_like(f_err_m))
        doppler_new = doppler_new + fll_nudge
        pll_new = lf.LoopFilterState(vel=pll_new.vel + fll_nudge,
                                     acc=pll_new.acc)
    code_freq_new = code_rate_from_doppler(conf, doppler_new) + dll_out

    # ---- lock / C/N0 over the block (sign-insensitive per-prompt forms)
    pi_ = prompt.real
    pq_ = prompt.imag
    p2 = pi_ * pi_ + pq_ * pq_
    carrier_lock = torch.mean((pi_ * pi_ - pq_ * pq_)
                              / torch.clamp(p2, min=1e-12), dim=1)
    mean_abs_i = torch.mean(torch.abs(pi_), dim=1)
    total = torch.mean(p2, dim=1)
    sig = mean_abs_i * mean_abs_i
    noise = torch.clamp(total - sig, min=1e-12)
    t_sym = t_blk / f32(e_block)
    cn0_lin = torch.clamp(sig / noise, min=1e-6) / t_sym
    cn0_db = 10.0 * torch.log10(cn0_lin)
    in_transitory = st.epoch < conf.fll_pullin_epochs
    bad = (((carrier_lock < f32(conf.carrier_lock_threshold))
            | (cn0_db < f32(conf.cn0_min_db_hz))) & ~in_transitory)
    fail = torch.where(bad, st.lock_fail + 1.0,
                       torch.clamp(st.lock_fail - 1.0, min=0.0))
    lost = fail > f32(conf.max_lock_fail)

    # ---- bit-sync histogram (data channels) ----------------------------
    sign_e = torch.where(pi_ >= 0, 1.0, -1.0)
    prev = torch.cat([st.prev_sign[:, None], sign_e[:, :-1]], dim=1)
    tr = (prev != 0.0) & (sign_e != prev)                      # [C, E]
    phase_mod = torch.remainder(epoch_g, 20)
    hist_inc = torch.sum(
        tr.to(F32)[:, :, None]
        * (phase_mod[:, :, None]
           == torch.arange(20, device=dev)[None, None, :]).to(F32), dim=1)
    hist = st.bit_hist + hist_inc
    total = torch.sum(hist, dim=1)
    top = torch.argmax(hist, dim=1)
    peak = torch.amax(hist, dim=1)
    sync_ok = ((total >= f32(conf.bit_sync_min_transitions))
               & (peak >= 0.8 * total))
    newly_bit = sync_ok & ~st.bit_synced & act
    bit_synced = st.bit_synced | newly_bit
    bit_phase = torch.where(newly_bit, top.to(I32), st.bit_phase)

    # ---- carrier phase bookkeeping (Kahan over blocks, not re-associated)
    cyc_blk = dop * t_blk
    y_k = cyc_blk - st.acc_phase_comp
    t_sum = st.acc_phase_cycles + y_k
    comp = (t_sum - st.acc_phase_cycles) - y_k
    rem_carr_new = torch.remainder(st.rem_carr_phase + two_pi * dop * t_blk,
                                   two_pi)
    # per-epoch acc phase at epoch END (affine within the block)
    acc_e = ((st.acc_phase_cycles - st.acc_phase_comp)[:, None]
             + dop[:, None] * (n_next / fs32))                 # [C, E]

    def sel(new, old):
        return torch.where(act, new, old)

    pos_new = torch.where(act, st.pos + n_total.to(I32),
                          st.pos + e_block * s0)
    new_state = st._replace(
        active=act & ~lost,
        pos=pos_new,
        rem_code_phase=sel(rem_new, st.rem_code_phase),
        code_freq=sel(code_freq_new, st.code_freq),
        carrier_doppler=sel(doppler_new, st.carrier_doppler),
        rem_carr_phase=sel(rem_carr_new, st.rem_carr_phase),
        acc_phase_cycles=sel(t_sum, st.acc_phase_cycles),
        acc_phase_comp=sel(comp, st.acc_phase_comp),
        dll=lf.LoopFilterState(*map(sel, dll_new, st.dll)),
        pll=lf.LoopFilterState(*map(sel, pll_new, st.pll)),
        prompt_prev=sel(prompt[:, -1], st.prompt_prev),
        epoch=torch.where(act, st.epoch + e_block, st.epoch),
        cn0_db_hz=sel(cn0_db, st.cn0_db_hz),
        carrier_lock=sel(carrier_lock, st.carrier_lock),
        lock_fail=sel(fail, st.lock_fail),
        lock_lost=sel(lost, st.lock_lost),
        bit_hist=torch.where(act[:, None], hist, st.bit_hist),
        prev_sign=sel(sign_e[:, -1], st.prev_sign),
        bit_synced=sel(bit_synced, st.bit_synced),
        bit_phase=sel(bit_phase, st.bit_phase),
        ext_n=torch.where(act, torch.clamp(st.ext_n + 1, max=10000),
                          st.ext_n),
    )
    if sec_code is not None:
        new_state = new_state._replace(
            sec_buf=torch.where(act[:, None], sec[0], st.sec_buf),
            sec_synced=sel(sec[1], st.sec_synced),
            sec_off=sel(sec[2], st.sec_off),
            sec_polarity=sel(sec[3], st.sec_polarity))
    outs = {
        "prompt": (prompt if data_prompt is None
                   else data_prompt).T,                        # [E, C]
        "early_mag": torch.abs(early).T,
        "late_mag": torch.abs(late).T,
        "carrier_doppler_hz": dop[None, :].expand(e_block, c_ch),
        "code_freq_cps": rate[None, :].expand(e_block, c_ch),
        "rem_code_phase_chips": rem_end.T,
        "acc_phase_cycles": acc_e.T,
        "code_phase_samples": (rem_end / rate[:, None] * fs32).T,
        "pos_start": (st.pos[:, None] + n_cum.to(I32)).T,
        "n_samples": n_len.to(I32).T,
        "cn0_db_hz": cn0_db[None, :].expand(e_block, c_ch),
        "valid": act[None, :].expand(e_block, c_ch),
    }
    return new_state, outs


def _write_rows(planes: dict, outs: dict, block: int, e_block: int) -> None:
    """Block `block`'s [E, C] outputs into rows block*E.. of the planes."""
    rows = slice(block * e_block, (block + 1) * e_block)
    for k, _ in PLANES:
        planes[k][rows] = outs[k]


# ---- kernels K8a and K8b ---------------------------------------------------

# the TrackState fields that the block step reads or writes, in the order
# of csrc/block_step.cu's StatePtrs ("dll_vel" is st.dll.vel); the others
# (cn0_acc, kf_*, ext_p/e/l, bayes_*) pass through unchanged, and so do the
# sec_* fields but in the pilot form
_STATE_FIELDS = (
    ("active", torch.bool), ("pos", I32), ("rem_code_phase", F32),
    ("code_freq", F32), ("carrier_doppler", F32), ("rem_carr_phase", F32),
    ("acc_phase_cycles", F32), ("acc_phase_comp", F32), ("dll_vel", F32),
    ("dll_acc", F32), ("pll_vel", F32), ("pll_acc", F32),
    ("prompt_prev", torch.complex64), ("epoch", I32), ("cn0_db_hz", F32),
    ("carrier_lock", F32), ("lock_fail", F32), ("lock_lost", torch.bool),
    ("bit_hist", F32), ("prev_sign", F32), ("bit_synced", torch.bool),
    ("bit_phase", I32), ("ext_n", I32), ("sec_buf", F32),
    ("sec_synced", torch.bool), ("sec_off", I32), ("sec_polarity", F32))
_SEC_FIELDS = ("sec_buf", "sec_synced", "sec_off", "sec_polarity")
_WIDE = {"bit_hist": 20, "sec_buf": N_SEC_MAX}
_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _state_field(st: TrackState, name: str) -> torch.Tensor:
    if name[:4] in ("dll_", "pll_"):
        return getattr(getattr(st, name[:3]), name[4:])
    return getattr(st, name)


class _StatePtrs(ctypes.Structure):
    _fields_ = [(name, _P) for name, _ in _STATE_FIELDS]


class _ProloguePtrs(ctypes.Structure):
    _fields_ = [(name, _P) for name in BlockPrologue._fields]


class _PlanePtrs(ctypes.Structure):
    _fields_ = [(name, _P) for name, _ in PLANES]


class _PrologueArgs(ctypes.Structure):
    _fields_ = [("st", _StatePtrs), ("out", _ProloguePtrs),
                ("codes_rep", _P), ("taps", _P),
                *((n, _F) for n in ("fs", "l_chips", "inv_fs", "two_pi",
                                    "inv_fc", "dop_bias", "lead")),
                *((n, _I) for n in ("s0", "n_epochs", "nfft", "n_taps",
                                    "w_max", "families", "n_ch"))]


class _ClosureArgs(ctypes.Structure):
    _fields_ = [("src", _StatePtrs), ("dst", _StatePtrs),
                ("pro", _ProloguePtrs), ("planes", _PlanePtrs),
                ("corr", _P),
                *((n, _F) for n in (
                    "fs", "inv_fs", "two_pi", "inv_two_pi", "inv_e",
                    "el_gain", "dll_bw_wide", "dll_bw_narrow", "inv_053",
                    "pll_k3", "pll_k11", "pll_k24", "fll_k4",
                    "lock_threshold", "cn0_min", "max_lock_fail",
                    "code_rate", "inv_fc", "dop_bias", "bit_sync_min")),
                *((n, _I) for n in (
                    "s0", "n_epochs", "n_taps", "n_ch", "n_rows",
                    "fll_pullin_epochs", "enable_fll", "fll_decision")),
                ("sec_code", _P), ("n_sec", _I)]


@functools.lru_cache(maxsize=None)
def _constants(conf: TrackingConf, e_block: int) -> dict:
    """The scalars of one conf's block step, each rounded as the plain
    version rounds it: the loop-filter gains are products of 0-d float32
    CPU tensors there, computed here by the same torch expressions."""
    wn = f32(conf.pll_bw_narrow_hz) / 0.7845
    return dict(
        fs=_fl(conf.fs), l_chips=_fl(conf.code_length_chips),
        inv_fs=_recip(conf.fs), two_pi=_fl(2.0 * np.pi),
        inv_two_pi=_recip(np.float32(2.0 * np.pi)),
        inv_fc=_recip(conf.carrier_freq_hz), lead=_fl(_LEAD),
        inv_e=_recip(e_block),
        el_gain=float(0.5 * (2.0 - f32(conf.early_late_space_chips))),
        dll_bw_wide=_fl(conf.dll_bw_hz),
        dll_bw_narrow=_fl(conf.dll_bw_narrow_hz),
        # the DLL divides a card tensor by the Python float 0.53: ATen on
        # the card multiplies by float(1 / 0.53) taken in double
        # (tools/probe_torch_rounding.py)
        inv_053=float(np.float32(1.0 / 0.53)),
        pll_k3=float(wn * wn * wn), pll_k11=float(1.1 * wn * wn),
        pll_k24=float(2.4 * wn), fll_k4=float(4.0 * f32(conf.fll_bw_hz)),
        lock_threshold=_fl(conf.carrier_lock_threshold),
        cn0_min=_fl(conf.cn0_min_db_hz), max_lock_fail=_fl(conf.max_lock_fail),
        code_rate=_fl(conf.code_rate_cps),
        bit_sync_min=_fl(conf.bit_sync_min_transitions),
        dop_bias=_fl(conf.doppler_bias_hz),
        s0=conf.nominal_epoch_samples,
        fll_pullin_epochs=conf.fll_pullin_epochs,
        enable_fll=int(conf.enable_fll_pullin),
        fll_decision=int(conf.fll_decision_directed))


def _state_ptrs(st: TrackState, dev, what: str) -> _StatePtrs:
    c = st.active.shape[0]
    ptrs = _StatePtrs()
    for name, dt in _STATE_FIELDS:
        t = _state_field(st, name)
        require(t, dt, dev, f"{what}: state field {name}")
        if t.shape != ((c, _WIDE[name]) if name in _WIDE else (c,)):
            raise ValueError(f"{what}: state field {name} has shape "
                             f"{tuple(t.shape)}")
        setattr(ptrs, name, t.data_ptr())
    return ptrs


def _prologue_ptrs(pro: BlockPrologue, c: int, e: int, nfft: int, k: int,
                   dev, families: int = 1) -> _ProloguePtrs:
    ptrs = _ProloguePtrs()
    rep = (c, nfft) if families == 1 else (families, c, nfft)
    for name, t in zip(BlockPrologue._fields, pro):
        dt = (torch.complex64 if name == "rep_t"
              else I32 if name in ("w0", "lag_int") else F32)
        shape = {"rep_t": rep, "tap_samps": (c, k)}.get(
            name, (c,) if name in ("n_total", "rem_new", "w0", "omega")
            else (c, e))
        require(t, dt, dev, f"block step: {name}")
        if t.shape != shape:
            raise ValueError(f"block step: {name} has shape "
                             f"{tuple(t.shape)}, not {shape}")
        setattr(ptrs, name, t.data_ptr())
    return ptrs


def _empty_prologue(c: int, e: int, nfft: int, k: int, dev,
                    families: int = 1) -> BlockPrologue:
    """Prologue buffers; `families` 2 for the pilot form's [2, C, F]
    replica."""
    def t(*shape, dt=F32):
        return torch.empty(shape, dtype=dt, device=dev)
    rep = (c, nfft) if families == 1 else (families, c, nfft)
    return BlockPrologue(
        rep_t=t(*rep, dt=torch.complex64), n_cum=t(c, e), n_next=t(c, e),
        n_len=t(c, e), rem_end=t(c, e), n_total=t(c), rem_new=t(c),
        w0=t(c, dt=I32), lag_int=t(c, e, dt=I32), lag_frac=t(c, e),
        ph_sc=t(c, e), tap_samps=t(c, k), omega=t(c))


def _empty_state(st: TrackState, pilot: bool = False) -> TrackState:
    """A TrackState with fresh tensors for the fields the block step
    writes and `st`'s own tensors for the rest (the sec_* fields but in the
    pilot form)."""
    def fresh(t):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)
    new = {name: fresh(getattr(st, name)) for name, _ in _STATE_FIELDS
           if name[:4] not in ("dll_", "pll_")
           and (pilot or name not in _SEC_FIELDS)}
    new["dll"] = lf.LoopFilterState(*map(fresh, st.dll))
    new["pll"] = lf.LoopFilterState(*map(fresh, st.pll))
    return st._replace(**new)


def _prologue_args(conf, e_block, codes_rep, taps, n_wins, st,
                   out) -> _PrologueArgs:
    """K8a's launch arguments; `codes_rep` [C, F], or [2, C, F] in the
    pilot form (then `out`'s replica is [2, C, F] too)."""
    dev = codes_rep.device
    c, nfft = codes_rep.shape[-2:]
    families = 1 if codes_rep.dim() == 2 else codes_rep.shape[0]
    k = taps.shape[0]
    require(codes_rep, F32, dev, "block_prologue: codes_rep")
    require(taps, F32, dev, "block_prologue: taps")
    if nfft != block_fft_size(conf) or st.active.shape != (c,) \
            or families not in (1, 2):
        raise ValueError("block_prologue: shape mismatch")
    consts = _constants(conf, e_block)
    return _PrologueArgs(
        st=_state_ptrs(st, dev, "block_prologue"),
        out=_prologue_ptrs(out, c, e_block, nfft, k, dev, families),
        codes_rep=codes_rep.data_ptr(), taps=taps.data_ptr(),
        **{n: consts[n] for n, _ in _PrologueArgs._fields_ if n in consts},
        n_epochs=e_block, nfft=nfft, n_taps=k,
        w_max=max(n_wins - e_block, 0), families=families, n_ch=c)


def _pilot_form(data: bool, sec_code, what: str) -> bool:
    """Whether the card runs the pilot form: the data replica and the
    secondary code come together there (a track_pilot chain's block
    step); either alone runs on the plain versions only."""
    if data != (sec_code is not None):
        raise NotImplementedError(
            f"{what}: the block kernels' pilot form takes the data replica "
            "and the secondary code together; either alone is not ported "
            "to the card")
    return data


def _closure_args(conf, e_block, corr, pro, src, dst, planes,
                  sec_code=None) -> _ClosureArgs:
    """K8b's launch arguments; in the pilot form (`sec_code`, the +-1
    secondary code on the card) `corr` carries the data prompt as column
    K, the replica is [2, C, F] and both states carry the sec_* fields."""
    dev = corr.device
    c, e, n_cols = corr.shape
    k = pro.tap_samps.shape[1]
    pilot = _pilot_form(n_cols == k + 1, sec_code, "block_closure")
    require(corr, torch.complex64, dev, "block_closure: corr")
    if e != e_block or not 1 <= e_block <= 32:
        raise ValueError("block_closure: E must match the block and be "
                         "at most 32 (one warp lane per epoch)")
    if n_cols != k + pilot:
        raise ValueError("block_closure: corr shape mismatch")
    n_sec = 0
    if pilot:
        require(sec_code, F32, dev, "block_closure: sec_code")
        n_sec = sec_code.shape[0]
        if sec_code.dim() != 1 or not 1 <= n_sec <= N_SEC_MAX:
            raise ValueError("block_closure: the secondary code must be "
                             f"1 to {N_SEC_MAX} chips")
    n_rows = planes["prompt"].shape[0]
    pp = _PlanePtrs()
    for name, dt in PLANES:
        require(planes[name], dt, dev, f"block_closure: plane {name}")
        if planes[name].shape != (n_rows, c):
            raise ValueError(f"block_closure: plane {name} shape")
        setattr(pp, name, planes[name].data_ptr())
    consts = _constants(conf, e_block)
    return _ClosureArgs(
        src=_state_ptrs(src, dev, "block_closure"),
        dst=_state_ptrs(dst, dev, "block_closure"),
        pro=_prologue_ptrs(pro, c, e, pro.rep_t.shape[-1], k, dev,
                           1 + pilot),
        planes=pp, corr=corr.data_ptr(),
        **{n: consts[n] for n, _ in _ClosureArgs._fields_ if n in consts},
        n_epochs=e, n_taps=k, n_ch=c, n_rows=n_rows,
        sec_code=sec_code.data_ptr() if pilot else None, n_sec=n_sec)


def _launch_prologue(args: _PrologueArgs, n_ch: int, stream: int) -> None:
    cuda_build.check(_lib().block_prologue(args, n_ch, stream),
                     "block_prologue")
    block_prologue.launches += 1
    block_prologue.launches_pilot += args.families == 2
    block_prologue.launches_bias += args.dop_bias != 0.0
    block_prologue.shapes[n_ch, args.n_epochs, args.nfft] += 1


def _launch_closure(args: _ClosureArgs, block: int, stream: int) -> None:
    cuda_build.check(_lib().block_closure(args, block, stream),
                     "block_closure")
    block_closure.launches += 1


def block_prologue(conf: TrackingConf, e_block: int, codes_rep: torch.Tensor,
                   taps: torch.Tensor, n_wins: int,
                   st: TrackState) -> BlockPrologue:
    """K8a wrapper: one block's epoch boundaries, K1's inputs and the
    Doppler-ramped replica from the state (see BlockPrologue); with
    `codes_rep` [2, C, F] (the pilot form) both families' replicas.
    Launches ``csrc/block_step.cu``'s block_prologue for CUDA tensors, runs
    :func:`_block_prologue_plain` for CPU tensors; counts its launches in
    ``block_prologue.launches`` (and in ``.shapes`` by (C, E, F)), the
    pilot form's also in ``block_prologue.launches_pilot`` and those with
    an FDMA bias in ``block_prologue.launches_bias``."""
    if not check_kernel_device(codes_rep, "block_prologue"):
        return _block_prologue_plain(conf, e_block, codes_rep, taps, n_wins,
                                     st)
    c, nfft = codes_rep.shape[-2:]
    out = _empty_prologue(c, e_block, nfft, taps.shape[0], codes_rep.device,
                          1 if codes_rep.dim() == 2 else codes_rep.shape[0])
    _launch_prologue(
        _prologue_args(conf, e_block, codes_rep, taps, n_wins, st, out), c,
        torch.cuda.current_stream(codes_rep.device).cuda_stream)
    return out


block_prologue.launches = 0
block_prologue.launches_pilot = 0
block_prologue.launches_bias = 0
block_prologue.shapes = collections.Counter()


def block_closure(conf: TrackingConf, e_block: int, corr: torch.Tensor,
                  pro: BlockPrologue, st: TrackState, planes: dict,
                  block: int, sec_code: torch.Tensor | None = None
                  ) -> TrackState:
    """K8b wrapper: the loop closure of one block from its correlations
    [C, E, K] ([C, E, K + 1] with the data prompt, and `sec_code`, in the
    pilot form); returns the next TrackState and writes the block's rows
    block*E.. of the chunk's [T, C] `planes`.  Launches
    ``csrc/block_step.cu``'s block_closure for CUDA tensors, runs
    :func:`_block_closure_plain` for CPU tensors."""
    if not check_kernel_device(corr, "block_closure"):
        new, outs = _block_closure_plain(conf, e_block, corr, pro, st,
                                         sec_code)
        _write_rows(planes, outs, block, e_block)
        return new
    out = _empty_state(st, sec_code is not None)
    _launch_closure(_closure_args(conf, e_block, corr, pro, st, out, planes,
                                  sec_code),
                    block, torch.cuda.current_stream(corr.device).cuda_stream)
    return out


block_closure.launches = 0


def _step_plain(conf: TrackingConf, e_block: int, xf_all, rf,
                pro: BlockPrologue, st: TrackState, codes_rep=None,
                taps=None, sec_code=None):
    """Plain version of the fused launch: K1's plain version on conj(rf),
    K8b's closure on its correlations and, given `codes_rep` and `taps` (a
    fold), the next block's prologue from the state the closure returned
    -> (the correlations, the next TrackState, the block's [E, C] output
    planes, the next block's BlockPrologue or None)."""
    corr = _block_correlate_plain(xf_all, torch.conj_physical(rf), pro.w0,
                                  pro.lag_int, pro.lag_frac, pro.ph_sc,
                                  pro.tap_samps, pro.omega)
    new, outs = _block_closure_plain(conf, e_block, corr, pro, st, sec_code)
    nxt = None if codes_rep is None else _block_prologue_plain(
        conf, e_block, codes_rep, taps, xf_all.shape[0], new)
    return corr, new, outs, nxt


def block_correlate_close(conf: TrackingConf, e_block: int,
                          xf_all: torch.Tensor, rf: torch.Tensor,
                          pro: BlockPrologue, st: TrackState, planes: dict,
                          block: int, corr: torch.Tensor | None = None,
                          scratch: K1Scratch | None = None,
                          fold: tuple | None = None,
                          sec_code: torch.Tensor | None = None) -> TrackState:
    """K1 and K8b fused: K1 on the replica spectrum `rf` as the FFT leaves
    it (the kernel conjugates it on load), then K8b's closure of block
    `block` in the same launch; returns the next TrackState, writes the
    block's rows of `planes` and the correlations into `corr` when given.
    With `fold` = (codes_rep, taps, next_pro) the launch also writes the
    next block's prologue (K8a's outputs) from the next state into the
    BlockPrologue `next_pro` (which must not be `pro`).  The pilot form:
    `rf` [2, C, F] with the data spectrum second, `sec_code` the +-1
    secondary code (the codes_rep of a fold [2, C, F]).  Launches
    ``csrc/block_correlator.cu``'s fused form for CUDA tensors; for CPU
    tensors :func:`_step_plain`."""
    if not check_kernel_device(xf_all, "block_correlate_close"):
        res, new, outs, nxt = _step_plain(conf, e_block, xf_all, rf, pro, st,
                                          *(fold or (None, None))[:2],
                                          sec_code=sec_code)
        if corr is not None:
            corr.copy_(res)
        _write_rows(planes, outs, block, e_block)
        if fold:
            for dst, src in zip(fold[2], nxt):
                dst.copy_(src)
        return new
    c, nfft = rf.shape[-2:]
    pilot = _pilot_form(rf.dim() == 3, sec_code, "block_correlate_close")
    if corr is None:
        corr = torch.empty((c, e_block, pro.tap_samps.shape[1] + pilot),
                           dtype=torch.complex64, device=rf.device)
    if scratch is None:
        scratch = k1_scratch(*corr.shape, nfft, rf.device)
    out = _empty_state(st, pilot)
    nxt = None
    if fold:
        codes_rep, taps, next_pro = fold
        if next_pro.rep_t.data_ptr() == pro.rep_t.data_ptr():
            raise ValueError("block_correlate_close: the next block's "
                             "prologue must not be this block's")
        nxt = ctypes.pointer(_prologue_args(
            conf, e_block, codes_rep, taps, xf_all.shape[0], out, next_pro))
    _launch_k1(_k1_args(xf_all, rf, pro.w0, pro.lag_int, pro.lag_frac,
                        pro.ph_sc, pro.tap_samps, pro.omega, corr, scratch),
               (_closure_args(conf, e_block, corr, pro, st, out, planes,
                              sec_code),
                block, nxt, scratch.flags.data_ptr()))
    return out


block_correlate_close.launches = 0
block_correlate_close.folds = 0
block_correlate_close.launches_pilot = 0
block_correlate_close.folds_pilot = 0
block_correlate_close.launches_bias = 0
block_correlate_close.folds_bias = 0
block_correlate_close.fold_shapes = collections.Counter()


# ---- the chunk -------------------------------------------------------------

def _chunk_plain(conf: TrackingConf, n_blocks: int, e_block: int,
                 codes_rep, taps, xf_all, state: TrackState, sec_code=None):
    """The block loop through the plain versions (on any device; K1
    through its wrapper): the form the CPU runs and the card's K8a and
    K8b are held against.  `codes_rep` [2, C, F] and `sec_code` in the
    pilot form."""
    planes = _empty_planes(n_blocks * e_block, codes_rep.shape[-2],
                           xf_all.device)
    for b in range(n_blocks):
        pro = _block_prologue_plain(conf, e_block, codes_rep, taps,
                                    xf_all.shape[0], state)
        rf = torch.conj_physical(torch.fft.fft(pro.rep_t, dim=-1))
        corr = block_correlate(xf_all, rf, pro.w0, pro.lag_int, pro.lag_frac,
                               pro.ph_sc, pro.tap_samps, pro.omega)
        state, outs = _block_closure_plain(conf, e_block, corr, pro, state,
                                           sec_code)
        _write_rows(planes, outs, b, e_block)
    return state, planes


def _chunk_plain_folded(conf: TrackingConf, n_blocks: int, e_block: int,
                        codes_rep, taps, xf_all, state: TrackState,
                        sec_code=None):
    """The plain versions in the order of the card's two-launch chunk: K8a
    for the first block, then per block the replica FFT and the fused
    step, whose closure's state gives the next block's prologue
    (:func:`_step_plain`; the last block writes none)."""
    planes = _empty_planes(n_blocks * e_block, codes_rep.shape[-2],
                           xf_all.device)
    pro = _block_prologue_plain(conf, e_block, codes_rep, taps,
                                xf_all.shape[0], state)
    for b in range(n_blocks):
        rf = torch.fft.fft(pro.rep_t, dim=-1)
        fold = (codes_rep, taps) if b + 1 < n_blocks else (None, None)
        _, state, outs, pro = _step_plain(conf, e_block, xf_all, rf, pro,
                                          state, *fold, sec_code=sec_code)
        _write_rows(planes, outs, b, e_block)
    return state, planes


def _chunk_cuda(conf: TrackingConf, n_blocks: int, e_block: int,
                codes_rep, taps, xf_all, state: TrackState,
                fold: bool = True, k1: K1Scratch | None = None,
                sec_code=None):
    """The block loop on the card into buffers allocated once per chunk
    (K1's scratch among them), with no host sync.  With the fold (the
    receiver's form, at every shape): K8a for the first block, then per
    block the cuFFT and K1 with K8b's closure and the next block's
    prologue in one launch (two prologue buffers, ping-ponged); without,
    the fold's reference: per block K8a, the cuFFT and K1 with K8b (three
    launches).  The state ping-pongs between two buffers; every launch's
    arguments for the three (source, destination) pairs are built once,
    K1's with the first spectrum's pointers, which each block's FFT output
    replaces.  In the pilot form (`codes_rep` [2, C, F], `sec_code`) the
    replica buffers hold both families and one cuFFT transforms both.
    `k1` is K1's scratch (by default its own).  Counts the chunks in
    ``track_chunk_blocks.chunks``."""
    dev = xf_all.device
    c, nfft = codes_rep.shape[-2:]
    families = 1 if codes_rep.dim() == 2 else codes_rep.shape[0]
    pilot = _pilot_form(families == 2, sec_code, "track_chunk_blocks")
    k = taps.shape[0]
    n_wins = xf_all.shape[0]
    if k1 is None:
        k1 = k1_scratch(c, e_block, k + pilot, nfft, dev)
    track_chunk_blocks.chunks += 1
    planes = _empty_planes(n_blocks * e_block, c, dev)
    pros = [_empty_prologue(c, e_block, nfft, k, dev, families)
            for _ in range(2 if fold else 1)]
    bufs = (_empty_state(state, pilot), _empty_state(state, pilot))
    corr = torch.empty((c, e_block, k + pilot), dtype=torch.complex64,
                       device=dev)
    pairs = ((state, bufs[0]), (bufs[0], bufs[1]), (bufs[1], bufs[0]))
    # the prologue buffer each pair's block reads: block 0 and the even
    # blocks pair 0 and 2, the odd ones pair 1
    ipro = (0, 1, 0) if fold else (0, 0, 0)
    p_args = [_prologue_args(conf, e_block, codes_rep, taps, n_wins, src,
                             pros[j]) for (src, _), j in zip(pairs, ipro)]
    c_args = [_closure_args(conf, e_block, corr, pros[j], src, dst, planes,
                            sec_code)
              for (src, dst), j in zip(pairs, ipro)]
    # with the fold, the prologue that pair i's block writes is the one the
    # pair of the next block reads: 0 -> 1, 1 -> 2, 2 -> 1
    n_args = ([ctypes.pointer(p_args[j]) for j in (1, 2, 1)] if fold
              else [None] * 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    k1_args = []
    flags = k1.flags.data_ptr()
    for b in range(n_blocks):
        i = 0 if b == 0 else 1 + (b - 1) % 2
        pro = pros[ipro[i]]
        if b == 0 or not fold:
            _launch_prologue(p_args[i], c, stream)
        # no out= for the FFT: ATen would add a kernel that applies the
        # (unit) normalization into it; K1 conjugates the spectrum on load.
        # One call over both families in the pilot form
        rf = torch.fft.fft(pro.rep_t, dim=-1)
        if not k1_args:
            k1_args = [_k1_args(xf_all, rf, q.w0, q.lag_int, q.lag_frac,
                                q.ph_sc, q.tap_samps, q.omega, corr, k1)
                       for q in pros]
        a = k1_args[ipro[i]]
        _launch_k1((a[0], rf.data_ptr(),
                    rf[1].data_ptr() if pilot else None) + a[3:],
                   (c_args[i], b, n_args[i] if b + 1 < n_blocks else None,
                    flags))
    return bufs[(n_blocks - 1) % 2], planes


def _pilot_tables(codes_rep, sec_code, data_codes_rep):
    """The replica tables of the block step: [C, F], or [2, C, F] with the
    data code's second (the pilot form); the secondary code as a float32
    tensor on the tables' device, or None.  Raises where the data table is
    not the code table's shape or the secondary code is not a vector of 1
    to N_SEC_MAX chips."""
    if data_codes_rep is not None:
        if tuple(data_codes_rep.shape) != tuple(codes_rep.shape):
            raise ValueError(
                f"track_chunk_blocks: data replica of shape "
                f"{tuple(data_codes_rep.shape)}, the code replica's is "
                f"{tuple(codes_rep.shape)}")
        codes_rep = torch.stack([codes_rep, data_codes_rep.to(codes_rep)])
    if sec_code is not None:
        sec_code = torch.as_tensor(sec_code, dtype=F32).to(codes_rep.device)
        if sec_code.dim() != 1 or not 1 <= sec_code.shape[0] <= N_SEC_MAX:
            raise ValueError(f"track_chunk_blocks: the secondary code must "
                             f"be 1 to {N_SEC_MAX} chips")
    return codes_rep, sec_code


def track_chunk_blocks(conf: TrackingConf, n_blocks: int, e_block: int,
                       codes_rep: torch.Tensor, taps: torch.Tensor,
                       x_chunk: torch.Tensor, state: TrackState,
                       sec_code: torch.Tensor | None = None,
                       data_codes_rep: torch.Tensor | None = None):
    """Run n_blocks blocks of e_block epochs each.  Returns (new_state,
    outs) with the same per-epoch [T, C] output planes as track_chunk
    (T = n_blocks*e_block).  `codes_rep` / `data_codes_rep` are the [C, F]
    time-domain block replicas of code_spectra() (the data code's for a
    track_pilot chain, whose data prompt becomes the ``prompt`` plane);
    `sec_code` the +-1 secondary code.  On the card K8a for the first
    block, then per block the cuFFT and K1 with K8b's closure and the next
    block's prologue fused (:func:`_chunk_cuda`); on the CPU the plain
    versions."""
    if n_blocks < 1:
        raise ValueError("track_chunk_blocks: n_blocks must be >= 1")
    codes_rep, sec_code = _pilot_tables(codes_rep, sec_code, data_codes_rep)
    xf_all = _window_spectra(x_chunk, conf.nominal_epoch_samples,
                             block_fft_size(conf))
    if check_kernel_device(xf_all, "track_chunk_blocks"):
        return _chunk_cuda(conf, n_blocks, e_block, codes_rep, taps, xf_all,
                           state, sec_code=sec_code)
    return _chunk_plain(conf, n_blocks, e_block, codes_rep, taps, xf_all,
                        state, sec_code)


track_chunk_blocks.chunks = 0


def track_chunk_blocks_packed_decim(conf: TrackingConf, n_blocks: int,
                                    e_block: int, decim: int,
                                    codes_rep: torch.Tensor,
                                    taps: torch.Tensor,
                                    x_chunk: torch.Tensor,
                                    state: TrackState,
                                    sec_code: torch.Tensor | None = None,
                                    data_codes_rep: torch.Tensor | None = None):
    """Block kernel + the same rate-split single-buffer transfer format as
    tracking.track_chunk_packed_decim."""
    new_state, outs = track_chunk_blocks(conf, n_blocks, e_block, codes_rep,
                                         taps, x_chunk, state, sec_code,
                                         data_codes_rep)
    return new_state, pack_decim(outs, new_state, n_blocks * e_block, decim)
