"""Batched Parallel Code Phase Search (PCPS) acquisition (kernels K3 and K3b).

PyTorch port of ``gnss_sim_receiver_tpu.ops.pcps``, GPS L1 C/A path: the
whole (channels x Doppler bins x code delay) grid of one acquisition is
searched in one batch.

The search is cut into two hand-written Triton kernels with cuFFT
(``torch.fft``) between them:

- :func:`pcps_wipe` writes the cuFFT input, the [M, D, N] Doppler-wiped
  dwells;
- ``torch.fft.fft``, the product with conj(code FFT) on the way into
  ``torch.fft.ifft``;
- :func:`pcps_peak` reads the [M, C, D, N] correlations once and
  returns (test statistic, Doppler index, delay index) per channel: |.|^2
  summed over the dwells, the first-index argmax over D x N and the mean
  power of the Doppler row opposite the peak (the CFAR statistic of
  ``max_to_input_power_stat``).  The [C, D, N] grid never reaches device
  memory.

The two-step refinement (kernel K3b) searches a narrow Doppler row set per
channel around each coarse hit: :func:`pcps_wipe_per_channel` writes the
[M, C, D2, N] wiped dwells from a [C, D2] Doppler table built on the device,
and the same cuFFT and peak stages follow.  :func:`pcps_search_two_steps`
chains both steps and packs (stat, doppler_hz, delay_idx, stat2) as [4, C],
with no host pull between the steps.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors.  :func:`pcps_grid`, :func:`pcps_grid_per_channel`,
:func:`grid_peak` and :func:`max_to_input_power_stat` are the plain
versions, line for line with the JAX functions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import special as _sp_special

from gnss_sim_receiver_tpu_torch.device import check_kernel_device, require


def doppler_grid(doppler_max: float, doppler_step: float,
                 doppler_center: float = 0.0) -> np.ndarray:
    """Doppler bin centers [-max, +max] + center (reference
    pcps_acquisition.cc:261 num_doppler_bins, inclusive of +max)."""
    n = int(np.ceil(2.0 * doppler_max / doppler_step)) + 1
    return (doppler_center - doppler_max
            + doppler_step * np.arange(n)).astype(np.float32)


def cfar_threshold(pfa: float, n_cells: int, n_dwells: int = 1,
                   bit_transition: bool = False) -> float:
    """Detection threshold from target Pfa via the inverse regularized lower
    incomplete gamma — same formula as pcps_acquisition.cc:884-900
    calculate_threshold()."""
    if pfa <= 0.0:
        return 0.0
    dof = 2.0 * (1 if bit_transition else n_dwells)
    return float(2.0 * _sp_special.gammaincinv(
        dof, (1.0 - pfa) ** (1.0 / float(n_cells))))


def time_axis(n: int, fs: float, device) -> torch.Tensor:
    """[N] float32 sample times arange(N) / fs (the wipeoff's t axis)."""
    return (torch.arange(n, dtype=torch.float32, device=device)
            / float(np.float32(fs)))


# ---- plain versions --------------------------------------------------------

def _wipe_plain(x_dwells, dopplers, t):
    phase = -2.0 * math.pi * dopplers[:, None] * t[None, :]
    carrier = torch.complex(torch.cos(phase), torch.sin(phase))   # [D, N]
    return x_dwells[:, None, :] * carrier[None, :, :]             # [M, D, N]


def pcps_grid(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
              dopplers: torch.Tensor, fs: float) -> torch.Tensor:
    """Non-coherently accumulated PCPS magnitude grid [C, D, N] float32
    (plain version of the whole search up to the grid)."""
    m, n = x_dwells.shape
    wiped = _wipe_plain(x_dwells, dopplers, time_axis(n, fs, x_dwells.device))
    spec = torch.fft.fft(wiped, dim=-1)
    prod = spec[:, None, :, :] * code_fft_conj[None, :, None, :]
    corr = torch.fft.ifft(prod, dim=-1)
    mag = corr.real ** 2 + corr.imag ** 2
    return torch.sum(mag, dim=0)


def _wipe_per_channel_plain(x_dwells, dopplers, t):
    phase = -2.0 * math.pi * dopplers[:, :, None] * t[None, None, :]
    carrier = torch.complex(torch.cos(phase), torch.sin(phase))   # [C, D, N]
    return x_dwells[:, None, None, :] * carrier[None]             # [M,C,D,N]


def pcps_grid_per_channel(x_dwells: torch.Tensor,
                          code_fft_conj: torch.Tensor,
                          dopplers: torch.Tensor, fs: float) -> torch.Tensor:
    """PCPS grid [C, D, N] float32 where every channel searches its OWN
    Doppler bin set, `dopplers` [C, D] (plain version of the two-step
    refinement up to the grid; pcps_acquisition.cc:698-758 make_2_steps)."""
    m, n = x_dwells.shape
    wiped = _wipe_per_channel_plain(x_dwells, dopplers,
                                    time_axis(n, fs, x_dwells.device))
    spec = torch.fft.fft(wiped, dim=-1)
    prod = spec * code_fft_conj[None, :, None, :]
    corr = torch.fft.ifft(prod, dim=-1)
    mag = corr.real ** 2 + corr.imag ** 2
    return torch.sum(mag, dim=0)


def grid_peak(grid: torch.Tensor):
    """Argmax over each channel's (Doppler, delay) grid: (peak [C],
    doppler_idx [C] int32, delay_idx [C] int32); the first index on ties."""
    c, d, n = grid.shape
    flat = grid.reshape(c, d * n)
    idx = torch.argmax(flat, dim=-1)
    peak = torch.gather(flat, 1, idx[:, None])[:, 0]
    return (peak, torch.div(idx, n, rounding_mode="floor").to(torch.int32),
            torch.remainder(idx, n).to(torch.int32))


def max_to_input_power_stat(grid: torch.Tensor, n_dwells):
    """CFAR test statistic: grid peak over the mean power of the Doppler row
    'opposite' the peak (pcps_acquisition.cc:496-528).  Returns
    (test_stat [C], doppler_idx [C], delay_idx [C])."""
    c, d, n = grid.shape
    peak, dop_idx, del_idx = grid_peak(grid)
    opp = torch.remainder(dop_idx + d // 2, d).long()
    opp_rows = torch.gather(grid, 1, opp[:, None, None].expand(c, 1, n))[:, 0]
    input_power = torch.mean(opp_rows, dim=-1) / 2.0 / n_dwells
    return peak / torch.clamp(input_power, min=1e-30), dop_idx, del_idx


def _peak_plain(corr, n_dwells):
    mag = corr.real ** 2 + corr.imag ** 2                         # [M,C,D,N]
    return max_to_input_power_stat(torch.sum(mag, dim=0), float(n_dwells))


# ---- Triton kernels --------------------------------------------------------

@functools.cache
def _kernels():
    """Define the Triton kernels (imported here, never at module import:
    the CPU machines that run the tests have no triton)."""
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def wipe_kernel(x_ptr, t_ptr, dop_ptr, out_ptr, n, n_dop,
                    neg_two_pi, BLOCK: tl.constexpr):
        # x [M, N] and out [M, D, N] complex64 as interleaved float32
        pid_n = tl.program_id(0)
        d = tl.program_id(1)
        m = tl.program_id(2)
        offs = pid_n * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        t = tl.load(t_ptr + offs, mask=mask, other=0.0)
        w = neg_two_pi * tl.load(dop_ptr + d)
        phase = w * t
        c = libdevice.cos(phase)
        s = libdevice.sin(phase)
        src = x_ptr + (m * n + offs) * 2
        xr = tl.load(src, mask=mask, other=0.0)
        xi = tl.load(src + 1, mask=mask, other=0.0)
        dst = out_ptr + ((m * n_dop + d) * n + offs) * 2
        tl.store(dst, xr * c - xi * s, mask=mask)
        tl.store(dst + 1, xr * s + xi * c, mask=mask)

    @triton.jit
    def row_kernel(corr_ptr, rmax_ptr, rarg_ptr, rsum_ptr, n_dwells, n_ch,
                   n_dop, n, BLOCK: tl.constexpr):
        # one (Doppler row, channel): |corr|^2 summed over the dwells, then
        # the row's max, first argmax and sum
        d = tl.program_id(0)
        c = tl.program_id(1)
        offs = tl.arange(0, BLOCK)
        mask = offs < n
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for m in range(n_dwells):
            src = corr_ptr + (((m * n_ch + c) * n_dop + d) * n + offs) * 2
            re = tl.load(src, mask=mask, other=0.0)
            im = tl.load(src + 1, mask=mask, other=0.0)
            acc += re * re + im * im
        vals = tl.where(mask, acc, float("-inf"))
        rmax, rarg = tl.max(vals, axis=0, return_indices=True,
                            return_indices_tie_break_left=True)
        o = c * n_dop + d
        tl.store(rmax_ptr + o, rmax)
        tl.store(rarg_ptr + o, rarg.to(tl.int32))
        tl.store(rsum_ptr + o, tl.sum(acc, axis=0))

    @triton.jit
    def stat_kernel(rmax_ptr, rarg_ptr, rsum_ptr, stat_ptr, dop_ptr,
                    del_ptr, n_dop, half_d, inv_n, n_dwells_f,
                    BLOCK_D: tl.constexpr):
        # first Doppler row holding the channel's peak, its delay, and the
        # CFAR statistic against the opposite row's mean power
        c = tl.program_id(0)
        dd = tl.arange(0, BLOCK_D)
        dmask = dd < n_dop
        rmax = tl.load(rmax_ptr + c * n_dop + dd, mask=dmask,
                       other=float("-inf"))
        peak = tl.max(rmax, axis=0)
        d_best = tl.min(tl.where((rmax == peak) & dmask, dd, BLOCK_D), axis=0)
        delay = tl.load(rarg_ptr + c * n_dop + d_best)
        opp = (d_best + half_d) % n_dop
        mean = tl.load(rsum_ptr + c * n_dop + opp) * inv_n
        power = mean / 2.0 / n_dwells_f
        tl.store(stat_ptr + c, peak / tl.maximum(power, 1e-30))
        tl.store(dop_ptr + c, d_best.to(tl.int32))
        tl.store(del_ptr + c, delay)

    return wipe_kernel, row_kernel, stat_kernel


# ---- wrappers --------------------------------------------------------------

def pcps_wipe(x_dwells: torch.Tensor, dopplers: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """K3 wipeoff kernel: [M, N] dwells x [D] Doppler bins -> [M, D, N]
    complex64 wiped dwells x * exp(-j 2 pi f_d t) (the cuFFT input)."""
    if not check_kernel_device(x_dwells, "pcps_wipe"):
        return _wipe_plain(x_dwells, dopplers, t)
    dev = x_dwells.device
    require(x_dwells, torch.complex64, dev, "pcps_wipe: x_dwells")
    require(dopplers, torch.float32, dev, "pcps_wipe: dopplers")
    require(t, torch.float32, dev, "pcps_wipe: t")
    m, n = x_dwells.shape
    d = dopplers.shape[0]
    out = torch.empty((m, d, n), dtype=torch.complex64, device=dev)
    _launch_wipe(x_dwells, dopplers, t, out)
    pcps_wipe.launches += 1
    return out


pcps_wipe.launches = 0


def _launch_wipe(x_dwells, dopplers, t, out):
    """The wipeoff kernel over `dopplers.numel()` Doppler rows: row r of
    every dwell of `out` is x * exp(-j 2 pi dopplers.flat[r] t)."""
    m, n = x_dwells.shape
    rows = dopplers.numel()
    wipe_kernel, _, _ = _kernels()
    block = 1024
    wipe_kernel[((n + block - 1) // block, rows, m)](
        torch.view_as_real(x_dwells), t, dopplers, torch.view_as_real(out),
        n, rows, float(np.float32(-2.0 * math.pi)), BLOCK=block, num_warps=4)


def pcps_wipe_per_channel(x_dwells: torch.Tensor, dopplers: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """K3b wipeoff kernel: [M, N] dwells x [C, D2] per-channel Doppler table
    -> [M, C, D2, N] complex64 wiped dwells (the cuFFT input of the
    two-step refinement).  The wipeoff kernel runs with the table's C * D2
    rows as its Doppler axis."""
    if not check_kernel_device(x_dwells, "pcps_wipe_per_channel"):
        return _wipe_per_channel_plain(x_dwells, dopplers, t)
    dev = x_dwells.device
    require(x_dwells, torch.complex64, dev, "pcps_wipe_per_channel: x_dwells")
    require(dopplers, torch.float32, dev, "pcps_wipe_per_channel: dopplers")
    require(t, torch.float32, dev, "pcps_wipe_per_channel: t")
    if dopplers.dim() != 2:
        raise ValueError("pcps_wipe_per_channel: dopplers must be [C, D2]")
    m, n = x_dwells.shape
    c, d2 = dopplers.shape
    out = torch.empty((m, c, d2, n), dtype=torch.complex64, device=dev)
    _launch_wipe(x_dwells, dopplers, t, out)
    pcps_wipe_per_channel.launches += 1
    return out


pcps_wipe_per_channel.launches = 0


def pcps_peak(corr: torch.Tensor, n_dwells: int):
    """K3 peak kernel: [M, C, D, N] complex64 correlations -> (stat [C],
    doppler_idx [C] int32, delay_idx [C] int32): the CFAR statistic of
    max_to_input_power_stat over the dwell-summed |corr|^2 grid."""
    if not check_kernel_device(corr, "pcps_peak"):
        return _peak_plain(corr, n_dwells)
    dev = corr.device
    require(corr, torch.complex64, dev, "pcps_peak: corr")
    m, c, d, n = corr.shape
    if m != n_dwells:
        raise ValueError("pcps_peak: n_dwells must match corr.shape[0]")
    import triton
    _, row_kernel, stat_kernel = _kernels()
    rmax = torch.empty((c, d), dtype=torch.float32, device=dev)
    rarg = torch.empty((c, d), dtype=torch.int32, device=dev)
    rsum = torch.empty((c, d), dtype=torch.float32, device=dev)
    row_kernel[(d, c)](torch.view_as_real(corr), rmax, rarg, rsum, m, c, d,
                       n, BLOCK=triton.next_power_of_2(n), num_warps=8)
    stat = torch.empty(c, dtype=torch.float32, device=dev)
    dop_idx = torch.empty(c, dtype=torch.int32, device=dev)
    del_idx = torch.empty(c, dtype=torch.int32, device=dev)
    stat_kernel[(c,)](rmax, rarg, rsum, stat, dop_idx, del_idx, d, d // 2,
                      float(np.float32(1.0) / np.float32(n)), float(m),
                      BLOCK_D=triton.next_power_of_2(d), num_warps=1)
    pcps_peak.launches += 1
    return stat, dop_idx, del_idx


pcps_peak.launches = 0


def pcps_search(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
                dopplers: torch.Tensor, t: torch.Tensor):
    """The whole CFAR search: (stat [C], doppler_idx [C], delay_idx [C]).
    The wipeoff kernel, cuFFT forward, the product with conj(code FFT)
    into cuFFT inverse, the peak kernel."""
    m = x_dwells.shape[0]
    wiped = pcps_wipe(x_dwells, dopplers, t)
    spec = torch.fft.fft(wiped, dim=-1)
    corr = torch.fft.ifft(spec[:, None, :, :]
                          * code_fft_conj[None, :, None, :], dim=-1)
    return pcps_peak(corr, m)


def pcps_search_two_steps(x_dwells: torch.Tensor,
                          code_fft_conj: torch.Tensor,
                          dopplers: torch.Tensor, t: torch.Tensor,
                          two_steps: bool, n_side: int,
                          step2: float) -> torch.Tensor:
    """The fused search of the JAX engine: the coarse CFAR search, then
    (with `two_steps`) every channel's narrow grid of 2 * n_side + 1 bins
    `step2` Hz apart around its coarse Doppler.  Returns the packed [4, C]
    float32 buffer (stat, doppler_hz, delay_idx, stat2); stat2 is 0 without
    the second step.  Nothing is pulled to the host in between."""
    m = x_dwells.shape[0]
    stat, dop_idx, del_idx = pcps_search(x_dwells, code_fft_conj, dopplers, t)
    dop_hz = dopplers[dop_idx.long()]
    stat2 = torch.zeros_like(stat)
    if two_steps:
        offs = ((torch.arange(2 * n_side + 1, device=dopplers.device)
                 - n_side) * float(np.float32(step2))).to(torch.float32)
        dops2 = (dop_hz[:, None] + offs[None, :]).contiguous()    # [C, D2]
        wiped = pcps_wipe_per_channel(x_dwells, dops2, t)
        spec = torch.fft.fft(wiped, dim=-1)
        corr = torch.fft.ifft(spec * code_fft_conj[None, :, None, :], dim=-1)
        stat2, dop2_idx, _ = pcps_peak(corr, m)
        dop_hz = torch.gather(dops2, 1, dop2_idx.long()[:, None])[:, 0]
    return torch.stack([stat.to(torch.float32), dop_hz.to(torch.float32),
                        del_idx.to(torch.float32), stat2.to(torch.float32)])
