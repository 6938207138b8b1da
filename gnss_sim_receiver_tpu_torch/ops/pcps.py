"""Batched Parallel Code Phase Search acquisition (kernels K3, K3b, K3c, K4a,
K4b, K4c and K7's fold).

PyTorch port of ``gnss_sim_receiver_tpu.ops.pcps`` (the PCPS grid, its
two-step refinement, the CCCWSR and 8 ms grids of Galileo E1, the
QuickSync folded grid of GPS L1 C/A and the Galileo E5a non-coherent I/Q
grid with its CAF Doppler smoothing): the
whole (channels x Doppler bins x code delay) grid of one acquisition is
searched in one batch.

The search is cut into two hand-written kernels with cuFFT
(``torch.fft``) between them:

- :func:`pcps_wipe` (CUDA, ``csrc/pcps_wipe.cu``; the Triton
  kernel it replaced stays as :func:`_wipe_reference`) writes the cuFFT
  input, the [M, D, N] Doppler-wiped dwells;
- ``torch.fft.fft``, the product with conj(code FFT) on the way into
  ``torch.fft.ifft``;
- :func:`pcps_peak` reads the [M, C, D, N] correlations once and
  returns (test statistic, Doppler index, delay index) per channel: |.|^2
  summed over the dwells, the first-index argmax over D x N and the mean
  power of the Doppler row opposite the peak (the CFAR statistic of
  ``max_to_input_power_stat``).  The [C, D, N] grid never reaches device
  memory.

The two-step refinement (kernel K3b) searches a narrow Doppler row set per
channel around each coarse hit: :func:`pcps_wipe` given a [C, D2] Doppler
table built on the device writes the [M, C, D2, N] wiped dwells, and the
same cuFFT and peak stages follow.  :func:`pcps_search_two_steps`
chains both steps and packs (stat, doppler_hz, delay_idx, stat2) as [4, C],
with no host pull between the steps.

The Galileo E1 sign-recovery variants (kernel K4a) correlate each dwell
twice — CCCWSR with the data and the pilot replica, 8 ms its two code
periods with the one replica — into one [M, C, D, 2, N] tensor
(:func:`dual_correlations`: the wipeoff kernel, cuFFT), and
:func:`pcps_dual_peak` reads both planes once, forming sum_m max(|a+b|^2,
|a-b|^2) per cell and the same statistic with 2 M correlations per cell;
:func:`pcps_search_dual` packs the [4, C] buffer of the two-step search.

The Galileo E5a non-coherent I/Q search (kernel K4c) correlates each dwell
with the E5a-I and the E5a-Q primaries into the same [M, C, D, 2, N] form
(:func:`dual_correlations` with "iq_caf"), and :func:`pcps_caf_peak` reads
both planes of every Doppler row once per row of its boxcar, forming
sum_m |ci|^2 + |cq|^2, the (2b+1)-row Doppler boxcar of the CAF filter
(zero-padded at the two Doppler edges, divided by 2b+1 everywhere, as
``jnp.convolve(..., mode="same")``) and the CFAR statistic of the smoothed
grid with 2 M correlations per cell; :func:`pcps_search_iq_caf` packs the
[4, C] buffer.

The first-vs-second-peak statistic of ``use_CFAR_algorithm=false``
(kernel K3c, :func:`pcps_second_peak`) takes the peak from the row kernel
of the search that found it (K3's, K4a's or K4c's: the grid form
"plain", "dual" or "caf"), forms only the peak's Doppler row again from
the correlations, tiled over programs, zeroes the cells within
samples_per_chip of the peak delay (circularly), and a second launch
combines the tiles' maxima into the ratio; :func:`detect` picks K3c or
the CFAR kernel for every search function.

QuickSync (kernel K4b) folds the dwell by `fold` before the FFT: the fold
kernel (:func:`pcps_quicksync_fold`) wipes the carrier and sums the `fold`
equal segments in one pass, writing [M, D, N/fold] (the [M, D, N] wiped
dwells never reach device memory); cuFFT, the product with the folded
code's conjugate spectrum and the K3 peak kernel follow on the
[M, C, D, N/fold] planes; the resolve kernel (:func:`pcps_quicksync_resolve`)
then takes the full-length correlation of dwell 0 at the `fold` candidate
delays of each channel and keeps the largest, on the card.
:func:`pcps_search_quicksync` packs the [4, C] buffer.  The Fine Doppler
(:func:`pcps_search_fine_doppler`) and Tong (:func:`pcps_search_dwells`)
searches reuse K3 and K3b.

The sharded searches of ``parallel.shard_steps`` take two more: K3's row
kernel alone (:func:`pcps_rows`, the per-row max, first argmax and sum a
Doppler-sharded search reduces across ranks) and K7's fold
(:func:`pcps_window_fold`, the time-sharded overlap-save search's |corr|^2
folded modulo the code period over its valid lags).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors.  :func:`pcps_grid`, :func:`pcps_grid_per_channel`,
:func:`pcps_cccwsr_grid`, :func:`pcps_8ms_grid`,
:func:`pcps_quicksync_grid`, :func:`quicksync_resolve`,
:func:`pcps_e5a_noncoherent_iq_grid`, :func:`grid_peak`,
:func:`max_to_input_power_stat` and :func:`first_vs_second_peak_stat` are
the plain versions, line for line with the JAX functions.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch
from scipy import special as _sp_special

from gnss_sim_receiver_tpu_torch.device import check_kernel_device, require
from gnss_sim_receiver_tpu_torch.ops import cuda_build


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

def _wipe_phase(dopplers, t):
    """The wipeoff's float32 phase [..., N] of a [D] grid or a [C, D2]
    table: (-2 pi f) rounded first, then times t, as the kernels order it."""
    return -2.0 * math.pi * dopplers[..., None] * t


def _wipe_plain(x_dwells, dopplers, t):
    phase = _wipe_phase(dopplers, t)
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
    phase = _wipe_phase(dopplers, t)
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


def first_vs_second_peak_stat(grid: torch.Tensor, samples_per_chip: int):
    """First/second-peak ratio with a +-1 chip circular exclusion zone
    around the main peak (pcps_acquisition.cc:531-597): the peak's Doppler
    row with the cells within `samples_per_chip` of the peak delay
    (circularly) set to 0, its max the second peak.  Returns (test_stat
    [C], doppler_idx [C], delay_idx [C])."""
    c, d, n = grid.shape
    peak, dop_idx, del_idx = grid_peak(grid)
    rows = torch.gather(grid, 1, dop_idx.long()[:, None, None].expand(
        c, 1, n))[:, 0]
    pos = torch.arange(n, dtype=torch.int32, device=grid.device)[None, :]
    dist = torch.abs(torch.remainder(pos - del_idx[:, None] + n // 2, n)
                     - n // 2)
    masked = torch.where(dist <= samples_per_chip,
                         torch.zeros((), dtype=grid.dtype,
                                     device=grid.device), rows)
    second = torch.max(masked, dim=-1).values
    return peak / torch.clamp(second, min=1e-30), dop_idx, del_idx


def _plain_grid(corr):
    """The PCPS grid of [M, C, D, N] correlations: sum_m |corr|^2."""
    return torch.sum(corr.real ** 2 + corr.imag ** 2, dim=0)


def _peak_plain(corr, n_dwells):
    return max_to_input_power_stat(_plain_grid(corr), float(n_dwells))


def pcps_8ms_grid(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
                  dopplers: torch.Tensor, fs: float) -> torch.Tensor:
    """Galileo E1 8 ms grid [C, D, N] (galileo_pcps_8ms_acquisition_cc.cc):
    each dwell spans TWO code periods, both halves correlated separately
    (carrier wiped over the full dwell so their relative phase is kept) and
    combined under both symbol-sign hypotheses, max(|c1+c2|^2, |c1-c2|^2),
    summed over dwells.  x_dwells [M, 2N], code_fft_conj [C, N]."""
    m, n2 = x_dwells.shape
    n = n2 // 2
    wiped = _wipe_plain(x_dwells, dopplers,
                        time_axis(n2, fs, x_dwells.device))  # [M, D, 2N]
    halves = wiped.reshape(m, -1, 2, n)                      # [M, D, 2, N]
    spec = torch.fft.fft(halves, dim=-1)
    corr = torch.fft.ifft(spec[:, None] * code_fft_conj[None, :, None,
                                                        None, :],
                          dim=-1)                            # [M,C,D,2,N]
    c1 = corr[..., 0, :]
    c2 = corr[..., 1, :]
    plus = torch.abs(c1 + c2) ** 2
    minus = torch.abs(c1 - c2) ** 2
    return torch.sum(torch.maximum(plus, minus), dim=0)


def pcps_cccwsr_grid(x_dwells: torch.Tensor,
                     code_data_fft_conj: torch.Tensor,
                     code_pilot_fft_conj: torch.Tensor,
                     dopplers: torch.Tensor, fs: float) -> torch.Tensor:
    """Coherent Channel Combining With Sign Recovery grid [C, D, N] (E1
    data + pilot, pcps_cccwsr_acquisition_cc.cc): the dwell correlated with
    the data and the pilot codes separately, combined under both relative
    signs, max(|d+p|^2, |d-p|^2), summed over dwells."""
    m, n = x_dwells.shape
    wiped = _wipe_plain(x_dwells, dopplers,
                        time_axis(n, fs, x_dwells.device))   # [M, D, N]
    spec = torch.fft.fft(wiped, dim=-1)
    cd = torch.fft.ifft(spec[:, None, :, :]
                        * code_data_fft_conj[None, :, None, :], dim=-1)
    cp = torch.fft.ifft(spec[:, None, :, :]
                        * code_pilot_fft_conj[None, :, None, :], dim=-1)
    plus = torch.abs(cd + cp) ** 2
    minus = torch.abs(cd - cp) ** 2
    return torch.sum(torch.maximum(plus, minus), dim=0)


def _dual_grid(corr):
    """The sign-recovery grid of [M, C, D, 2, N] correlation planes
    a = [..., 0, :], b = [..., 1, :]: sum_m max(|a+b|^2, |a-b|^2)."""
    a, b = corr[..., 0, :], corr[..., 1, :]
    return torch.sum(torch.maximum(torch.abs(a + b) ** 2,
                                   torch.abs(a - b) ** 2), dim=0)


def _dual_peak_plain(corr, n_dwells):
    """Plain version of K4a: corr [M, C, D, 2, N] holds the two correlation
    planes a = [..., 0, :] and b = [..., 1, :]; the CFAR statistic of the
    sign-recovery grid sum_m max(|a+b|^2, |a-b|^2) against 2 * n_dwells
    correlations per cell (acquisition.py:_acquire_dual's n_eff)."""
    return max_to_input_power_stat(_dual_grid(corr), float(2 * n_dwells))


def pcps_e5a_noncoherent_iq_grid(x_dwells: torch.Tensor,
                                 code_i_fft_conj: torch.Tensor,
                                 code_q_fft_conj: torch.Tensor,
                                 dopplers: torch.Tensor, fs: float,
                                 caf_bins: int = 0) -> torch.Tensor:
    """Galileo E5a non-coherent I/Q grid [C, D, N] float32
    (galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc): |corr_I|^2 +
    |corr_Q|^2 summed over the dwells; with caf_bins > 0 smoothed along
    Doppler by a (2 caf_bins + 1)-bin boxcar (:func:`caf_smooth`)."""
    m, n = x_dwells.shape
    wiped = _wipe_plain(x_dwells, dopplers,
                        time_axis(n, fs, x_dwells.device))   # [M, D, N]
    spec = torch.fft.fft(wiped, dim=-1)
    ci = torch.fft.ifft(spec[:, None, :, :]
                        * code_i_fft_conj[None, :, None, :], dim=-1)
    cq = torch.fft.ifft(spec[:, None, :, :]
                        * code_q_fft_conj[None, :, None, :], dim=-1)
    grid = torch.sum(torch.abs(ci) ** 2 + torch.abs(cq) ** 2, dim=0)
    return caf_smooth(grid, caf_bins)


def caf_smooth(grid: torch.Tensor, caf_bins: int) -> torch.Tensor:
    """The CAF filter's Doppler boxcar over a [C, D, N] grid: per (channel,
    delay) column, jnp.convolve(col, ones(k) / k, mode="same") with
    k = 2 caf_bins + 1 — the column zero-padded by caf_bins rows at each
    edge, every output the sum of its k neighbours times float32(1/k), in
    order of the row.  caf_bins = 0 returns the grid unchanged."""
    if caf_bins <= 0:
        return grid
    k = 2 * caf_bins + 1
    kern = float(np.float32(1.0) / np.float32(k))
    c, d, n = grid.shape
    pad = torch.zeros((c, caf_bins, n), dtype=grid.dtype, device=grid.device)
    padded = torch.cat([pad, grid, pad], dim=1)
    out = padded[:, 0:d] * kern
    for s in range(1, k):
        out = out + padded[:, s:s + d] * kern
    return out


def _caf_grid(corr, caf_bins: int):
    """The CAF-smoothed grid of [M, C, D, 2, N] E5a-I and E5a-Q planes:
    sum_m |ci|^2 + |cq|^2 through :func:`caf_smooth`."""
    ci, cq = corr[..., 0, :], corr[..., 1, :]
    grid = torch.sum(torch.abs(ci) ** 2 + torch.abs(cq) ** 2, dim=0)
    return caf_smooth(grid, caf_bins)


def _caf_peak_plain(corr, n_dwells, caf_bins: int):
    """Plain version of K4c: corr [M, C, D, 2, N] holds the E5a-I and E5a-Q
    correlation planes; the CFAR statistic of the CAF-smoothed grid
    sum_m |ci|^2 + |cq|^2 against 2 * n_dwells correlations per cell
    (acquisition.py:_acquire_dual's n_eff)."""
    return max_to_input_power_stat(_caf_grid(corr, caf_bins),
                                   float(2 * n_dwells))


# the grid forms of K3c, one per search that finds the peak (K3, K4a, K4c)
FORMS = ("plain", "dual", "caf")


def _second_peak_plain(corr, samples_per_chip: int, form: str,
                       caf_bins: int = 0):
    """Plain version of K3c: the first-vs-second-peak statistic of the grid
    of `form` (:data:`FORMS`) over the correlations, materialised."""
    if form == "plain":
        grid = _plain_grid(corr)
    elif form == "dual":
        grid = _dual_grid(corr)
    else:
        grid = _caf_grid(corr, caf_bins)
    return first_vs_second_peak_stat(grid, samples_per_chip)


def _fold_plain(x_dwells, dopplers, t, fold: int):
    """Plain version of the K4b fold kernel: the [M, D, N] wiped dwells
    summed over `fold` equal segments -> [M, D, N // fold]."""
    m, n = x_dwells.shape
    nf = n // fold
    wiped = _wipe_plain(x_dwells, dopplers, t)                 # [M, D, N]
    return wiped[..., : nf * fold].reshape(m, -1, fold, nf).sum(dim=2)


def fold_codes(codes_sampled: np.ndarray, fold: int) -> np.ndarray:
    """[C, N // fold] complex64 conj(FFT(code folded by `fold`)), the
    QuickSync replica, on the host (the JAX function folds the code inside
    its program; here once per acquisition engine)."""
    c, n = codes_sampled.shape
    nf = n // fold
    code_f = np.asarray(codes_sampled, np.float32)[:, : nf * fold].reshape(
        c, fold, nf).sum(axis=1)
    return np.conj(np.fft.fft(code_f.astype(np.complex64),
                              axis=-1)).astype(np.complex64)


def pcps_quicksync_grid(x_dwells: torch.Tensor, codes_sampled: torch.Tensor,
                        dopplers: torch.Tensor, fs: float,
                        fold: int) -> torch.Tensor:
    """QuickSync folded grid [C, D, N // fold] float32
    (pcps_quicksync_acquisition_cc.cc): the dwell and the local code both
    folded by summing `fold` equal segments, so the grid resolves the code
    phase modulo N / fold.  codes_sampled [C, N] float32 +-1."""
    m, n = x_dwells.shape
    folded = _fold_plain(x_dwells, dopplers,
                         time_axis(n, fs, x_dwells.device), fold)
    cfc = torch.from_numpy(fold_codes(codes_sampled.cpu().numpy(), fold)
                           ).to(x_dwells.device)
    spec = torch.fft.fft(folded, dim=-1)                        # [M, D, NF]
    corr = torch.fft.ifft(spec[:, None, :, :] * cfc[None, :, None, :],
                          dim=-1)
    mag = corr.real ** 2 + corr.imag ** 2
    return torch.sum(mag, dim=0)


def _resolve_plain(x_dwell, codes_sampled, doppler_hz, delay_mod, t,
                   fold: int):
    """Plain version of the K4b resolve kernel: |sum wiped * roll(code, d)|
    at the `fold` candidates d = delay_mod + k * N // fold -> ([C] int32
    delays, [C] float32 magnitudes), the first k on ties."""
    c, n = codes_sampled.shape
    nf = n // fold
    ph = -2.0 * math.pi * doppler_hz[:, None] * t[None, :]
    wiped = x_dwell[None, :] * torch.complex(torch.cos(ph), torch.sin(ph))
    cand = (delay_mod.to(torch.int64)[:, None]
            + nf * torch.arange(fold, device=t.device)[None, :])   # [C, K]
    # jnp.roll(code, d)[i] = code[(i - d) mod N]
    idx = torch.remainder(torch.arange(n, device=t.device)[None, None, :]
                          - cand[:, :, None], n)
    rolled = torch.gather(codes_sampled[:, None, :].expand(c, fold, n), 2,
                          idx)
    mags = torch.abs(torch.sum(wiped[:, None, :] * rolled, dim=-1))
    k = torch.argmax(mags, dim=1)
    return (torch.gather(cand, 1, k[:, None])[:, 0].to(torch.int32),
            torch.gather(mags, 1, k[:, None])[:, 0])


def quicksync_resolve(x_dwell: torch.Tensor, codes_sampled: torch.Tensor,
                      doppler_hz: torch.Tensor, delay_mod: torch.Tensor,
                      fs: float, fold: int = 4):
    """Resolve the QuickSync fold ambiguity (the JAX function's form): the
    full-length correlation at the `fold` candidate delays
    delay_mod + k * N / fold for each channel's detected Doppler; returns
    ([C] delays, [C] magnitudes) of the winning candidates."""
    return _resolve_plain(x_dwell, codes_sampled, doppler_hz, delay_mod,
                          time_axis(codes_sampled.shape[1], fs,
                                    x_dwell.device), fold)


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
        # x [M, N] and out [M, D, N] complex64 as interleaved float32; the
        # reference of csrc/pcps_wipe.cu (_wipe_reference), on no path
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

    # The grid's cells of one Doppler row, tile by tile.  K3's peak reads
    # the [M, C, D, N] correlations (FORM 0: sum_m |c|^2); K4a the [M, C,
    # D, 2, N] planes a, b (FORM 1: sum_m max(|a+b|^2, |a-b|^2)); K4c the
    # E5a-I and E5a-Q planes (FORM 2: the (2b+1)-row Doppler boxcar of sum_m
    # |ci|^2 + |cq|^2, rows outside [0, D) the boxcar's zero padding).
    #
    # K4c replaces gnss_sim_receiver_tpu/ops/pcps.py:269
    # pcps_e5a_noncoherent_iq_grid with the statistic the JAX engine takes
    # of its grid (max_to_input_power_stat, :107).  Bound on the H100 by
    # bytes: the two [M, C, D, N] complex64 planes read once (525 MB at
    # the wideband path's M=2, C=10, D=41, N=40000), under one float32
    # operation per byte.  The [C, D, N] grid of the JAX program, and its
    # smoothed copy, never reach device memory: each program re-reads the
    # 2b neighbouring rows of its boxcar, which the programs of rows
    # d - b .. d + b (launched side by side) have just brought into L2.
    @triton.jit
    def _cells(corr_ptr, offs, mask, c, d, n_dwells, n_ch, n_dop, n, inv_k,
               FORM: tl.constexpr, CAF_BINS: tl.constexpr,
               BLOCK: tl.constexpr):
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        if FORM == 0:
            for m in range(n_dwells):
                src = corr_ptr + (((m * n_ch + c) * n_dop + d) * n + offs) * 2
                re = tl.load(src, mask=mask, other=0.0)
                im = tl.load(src + 1, mask=mask, other=0.0)
                acc += re * re + im * im
        elif FORM == 1:
            for m in range(n_dwells):
                row = ((m * n_ch + c) * n_dop + d) * 2
                pa = corr_ptr + (row * n + offs) * 2
                pb = corr_ptr + ((row + 1) * n + offs) * 2
                ar = tl.load(pa, mask=mask, other=0.0)
                ai = tl.load(pa + 1, mask=mask, other=0.0)
                br = tl.load(pb, mask=mask, other=0.0)
                bi = tl.load(pb + 1, mask=mask, other=0.0)
                sr = ar + br
                si = ai + bi
                dr = ar - br
                di = ai - bi
                acc += tl.maximum(sr * sr + si * si, dr * dr + di * di)
        else:
            for s in tl.static_range(2 * CAF_BINS + 1):
                j = d - CAF_BINS + s
                lm = mask & (j >= 0) & (j < n_dop)
                raw = tl.zeros([BLOCK], dtype=tl.float32)
                for m in range(n_dwells):
                    row = ((m * n_ch + c) * n_dop + j) * 2
                    pa = corr_ptr + (row * n + offs) * 2
                    pb = corr_ptr + ((row + 1) * n + offs) * 2
                    ar = tl.load(pa, mask=lm, other=0.0)
                    ai = tl.load(pa + 1, mask=lm, other=0.0)
                    br = tl.load(pb, mask=lm, other=0.0)
                    bi = tl.load(pb + 1, mask=lm, other=0.0)
                    raw += (ar * ar + ai * ai) + (br * br + bi * bi)
                if CAF_BINS == 0:
                    acc = raw
                else:
                    acc += raw * inv_k
        return acc

    # The row kernel of K3 (FORM 0), K4a (1) and K4c (2), one program per
    # (Doppler row, channel): the row's planes read once, tile by tile
    # (BLOCK lanes, ROW_TILE at most); per lane the running max (strict >,
    # so a lane keeps its first index) and the running sum, reduced once
    # at the end: the row's max, its first index (the least index among
    # the lanes at the max) and its sum.  A fixed tile bounds a long row's
    # registers: a whole power-of-two row in one program (65536 lanes at
    # N = 40000) spills, and 39 % of its lanes are masked off.
    @triton.jit
    def row_kernel(corr_ptr, rmax_ptr, rarg_ptr, rsum_ptr, n_dwells, n_ch,
                   n_dop, n, inv_k, FORM: tl.constexpr,
                   CAF_BINS: tl.constexpr, BLOCK: tl.constexpr):
        d = tl.program_id(0)
        c = tl.program_id(1)
        lanes = tl.arange(0, BLOCK)
        best = tl.full([BLOCK], float("-inf"), tl.float32)
        best_i = tl.zeros([BLOCK], dtype=tl.int32)
        total = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, n, BLOCK):
            offs = start + lanes
            mask = offs < n
            acc = _cells(corr_ptr, offs, mask, c, d, n_dwells, n_ch, n_dop,
                         n, inv_k, FORM, CAF_BINS, BLOCK)
            vals = tl.where(mask, acc, float("-inf"))
            better = vals > best
            best = tl.where(better, vals, best)
            best_i = tl.where(better, offs, best_i)
            total += acc
        rmax = tl.max(best, axis=0)
        rarg = tl.min(tl.where(best == rmax, best_i, n), axis=0)
        o = c * n_dop + d
        tl.store(rmax_ptr + o, rmax)
        tl.store(rarg_ptr + o, rarg.to(tl.int32))
        tl.store(rsum_ptr + o, tl.sum(total, axis=0))

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

    # K3c replaces gnss_sim_receiver_tpu/ops/pcps.py:123
    # first_vs_second_peak_stat.  The peak (row d_best, delay) comes from
    # the row buffers of the search's own row kernel (K3, K4a or K4c); only
    # the peak row of each channel is formed again from the correlations,
    # in the grid form FORM of that search (0: sum_m |c|^2; 1: sum_m
    # max(|a+b|^2, |a-b|^2); 2: the (2b+1)-row boxcar of sum_m |ci|^2 +
    # |cq|^2), tiled over programs.  Bound by bytes: the row's planes read
    # once more, M C N 8 bytes (plain form), beside the row kernel's read
    # of the whole grid.
    @triton.jit
    def _peak_cell(rmax_ptr, rarg_ptr, c, n_dop, BLOCK_D: tl.constexpr):
        # the first Doppler row holding the channel's peak, the peak and
        # its delay (the stat kernel's choice)
        dd = tl.arange(0, BLOCK_D)
        dmask = dd < n_dop
        rmax = tl.load(rmax_ptr + c * n_dop + dd, mask=dmask,
                       other=float("-inf"))
        peak = tl.max(rmax, axis=0)
        d_best = tl.min(tl.where((rmax == peak) & dmask, dd, BLOCK_D), axis=0)
        return peak, d_best, tl.load(rarg_ptr + c * n_dop + d_best)

    @triton.jit
    def second_tile_kernel(corr_ptr, rmax_ptr, rarg_ptr, tmax_ptr, n_dwells,
                           n_ch, n_dop, n, spc, inv_k, n_tiles,
                           FORM: tl.constexpr, CAF_BINS: tl.constexpr,
                           BLOCK: tl.constexpr, BLOCK_D: tl.constexpr):
        # K3c, one (channel, tile of the peak row): the tile's cells of the
        # row, those within spc of the peak delay (circularly) set to 0,
        # and their max; the values are >= 0, so the 0s and the masked
        # lanes past N leave the row's max unchanged
        c = tl.program_id(0)
        tile = tl.program_id(1)
        _, d, delay = _peak_cell(rmax_ptr, rarg_ptr, c, n_dop, BLOCK_D)
        offs = tile * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        acc = _cells(corr_ptr, offs, mask, c, d, n_dwells, n_ch, n_dop, n,
                     inv_k, FORM, CAF_BINS, BLOCK)
        half = n // 2
        dist = tl.abs((offs - delay + half + n) % n - half)
        vals = tl.where(mask & (dist > spc), acc, 0.0)
        tl.store(tmax_ptr + c * n_tiles + tile, tl.max(vals, axis=0))

    @triton.jit
    def second_stat_kernel(rmax_ptr, rarg_ptr, tmax_ptr, stat_ptr, dop_ptr,
                           del_ptr, n_dop, n_tiles, BLOCK_D: tl.constexpr,
                           BLOCK_T: tl.constexpr):
        # K3c's second launch, one channel: the tiles' maxima combined (a
        # max, so in any order), the ratio of the peak to the second peak
        c = tl.program_id(0)
        peak, d_best, delay = _peak_cell(rmax_ptr, rarg_ptr, c, n_dop,
                                         BLOCK_D)
        tt = tl.arange(0, BLOCK_T)
        tmax = tl.load(tmax_ptr + c * n_tiles + tt, mask=tt < n_tiles,
                       other=0.0)
        second = tl.max(tmax, axis=0)
        tl.store(stat_ptr + c, peak / tl.maximum(second, 1e-30))
        tl.store(dop_ptr + c, d_best.to(tl.int32))
        tl.store(del_ptr + c, delay)

    @triton.jit
    def fold_kernel(x_ptr, t_ptr, dop_ptr, out_ptr, n, nf, n_dop, fold,
                    neg_two_pi, BLOCK: tl.constexpr):
        # K4b fold: x [M, N] -> out [M, D, NF] complex64 (interleaved
        # float32), out[m, d, j] = sum_f x[m, f NF + j] exp(-j w_d t)
        pid_j = tl.program_id(0)
        d = tl.program_id(1)
        m = tl.program_id(2)
        j = pid_j * BLOCK + tl.arange(0, BLOCK)
        mask = j < nf
        w = neg_two_pi * tl.load(dop_ptr + d)
        acc_r = tl.zeros([BLOCK], dtype=tl.float32)
        acc_i = tl.zeros([BLOCK], dtype=tl.float32)
        for f in range(fold):
            idx = f * nf + j
            phase = w * tl.load(t_ptr + idx, mask=mask, other=0.0)
            c = libdevice.cos(phase)
            s = libdevice.sin(phase)
            src = x_ptr + (m * n + idx) * 2
            xr = tl.load(src, mask=mask, other=0.0)
            xi = tl.load(src + 1, mask=mask, other=0.0)
            acc_r += xr * c - xi * s
            acc_i += xr * s + xi * c
        dst = out_ptr + ((m * n_dop + d) * nf + j) * 2
        tl.store(dst, acc_r, mask=mask)
        tl.store(dst + 1, acc_i, mask=mask)

    @triton.jit
    def resolve_kernel(x_ptr, t_ptr, code_ptr, dop_ptr, lag_ptr, mag_ptr,
                       n, nf, fold, neg_two_pi, BLOCK: tl.constexpr):
        # K4b resolve, one (channel, candidate k): |sum_i x[i] exp(-j w t_i)
        # code[c, (i - d) mod N]| at d = lag[c] + k NF
        c = tl.program_id(0)
        k = tl.program_id(1)
        dly = tl.load(lag_ptr + c) + k * nf
        w = neg_two_pi * tl.load(dop_ptr + c)
        lanes = tl.arange(0, BLOCK)
        acc_r = tl.zeros([BLOCK], dtype=tl.float32)
        acc_i = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, n, BLOCK):
            offs = start + lanes
            mask = offs < n
            phase = w * tl.load(t_ptr + offs, mask=mask, other=0.0)
            cs = libdevice.cos(phase)
            sn = libdevice.sin(phase)
            xr = tl.load(x_ptr + offs * 2, mask=mask, other=0.0)
            xi = tl.load(x_ptr + offs * 2 + 1, mask=mask, other=0.0)
            ci = offs - dly
            ci = tl.where(ci < 0, ci + n, ci)
            code = tl.load(code_ptr + c * n + ci, mask=mask, other=0.0)
            acc_r += (xr * cs - xi * sn) * code
            acc_i += (xr * sn + xi * cs) * code
        vr = tl.sum(acc_r, axis=0)
        vi = tl.sum(acc_i, axis=0)
        tl.store(mag_ptr + c * fold + k, tl.sqrt(vr * vr + vi * vi))

    # K7 replaces the fold of gnss_sim_receiver_tpu/parallel/
    # shard_steps.py:224-227 (overlap_save_acq_grid, :184): |corr|^2 of the
    # first L lags of each Doppler row folded modulo the code period N.  Bound
    # by bytes: D L 8 read once, D N 4 written once (84 MB at D = 41, L =
    # 254000), under one float32 operation per byte.  One program per
    # (tile of N lags, row); the windows are summed in order in registers.
    # Simple first: that is D ceil(N / 1024) programs (82 at D = 41), each
    # a chain of L / N window loads, too few to keep the card's memory busy
    # (PERF.md's table).
    @triton.jit
    def window_fold_kernel(corr_ptr, out_ptr, row_len, n, n_win,
                           BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        d = tl.program_id(1)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for w in range(n_win):
            src = corr_ptr + (d * row_len + w * n + offs) * 2
            re = tl.load(src, mask=mask, other=0.0)
            im = tl.load(src + 1, mask=mask, other=0.0)
            acc += re * re + im * im
        tl.store(out_ptr + d * n + offs, acc, mask=mask)

    return dict(wipe=wipe_kernel, row=row_kernel, stat=stat_kernel,
                second_tile=second_tile_kernel,
                second_stat=second_stat_kernel,
                fold=fold_kernel,
                resolve=resolve_kernel,
                window_fold=window_fold_kernel)


# ---- wrappers --------------------------------------------------------------

def pcps_wipe(x_dwells: torch.Tensor, dopplers: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """The wipeoff kernel (``csrc/pcps_wipe.cu``): [M, N] dwells x
    exp(-j 2 pi f_d t) (the cuFFT input).  A [D] Doppler grid gives
    [M, D, N] (K3; counted in ``pcps_wipe.launches``); a [C, D2]
    per-channel table gives [M, C, D2, N] (K3b, the two-step refinement;
    counted in ``pcps_wipe.launches_per_channel``), the kernel running over
    the table's C * D2 rows as its Doppler axis.  ``pcps_wipe.shapes``
    counts the launches by (M, the table's shape, N)."""
    if dopplers.dim() not in (1, 2):
        raise ValueError("pcps_wipe: dopplers must be [D] or [C, D2]")
    if not check_kernel_device(x_dwells, "pcps_wipe"):
        if dopplers.dim() == 2:
            return _wipe_per_channel_plain(x_dwells, dopplers, t)
        return _wipe_plain(x_dwells, dopplers, t)
    out = _wipe_out(x_dwells, dopplers, t)
    m, n = x_dwells.shape
    err = _wipe_lib().pcps_wipe(
        x_dwells.data_ptr(), t.data_ptr(), dopplers.data_ptr(),
        out.data_ptr(), m, dopplers.numel(), n, NEG_TWO_PI,
        torch.cuda.current_stream(x_dwells.device).cuda_stream)
    cuda_build.check(err, "pcps_wipe")
    if dopplers.dim() == 2:
        pcps_wipe.launches_per_channel += 1
    else:
        pcps_wipe.launches += 1
    pcps_wipe.shapes[(m, *dopplers.shape, n)] += 1
    return out


pcps_wipe.launches = 0
pcps_wipe.launches_per_channel = 0
pcps_wipe.shapes = collections.Counter()

# float32(-2 pi), the factor of the wipeoff's phase
NEG_TWO_PI = float(np.float32(-2.0 * math.pi))


def _wipe_out(x_dwells, dopplers, t):
    """Check the wipeoff's CUDA inputs; its [M, *dopplers.shape, N]
    output."""
    dev = x_dwells.device
    require(x_dwells, torch.complex64, dev, "pcps_wipe: x_dwells")
    require(dopplers, torch.float32, dev, "pcps_wipe: dopplers")
    require(t, torch.float32, dev, "pcps_wipe: t")
    if x_dwells.dim() != 2 or t.shape != (x_dwells.shape[1],):
        raise ValueError("pcps_wipe: x_dwells [M, N] and t [N]")
    m, n = x_dwells.shape
    return torch.empty((m, *dopplers.shape, n), dtype=torch.complex64,
                       device=dev)


def _wipe_reference(x_dwells: torch.Tensor, dopplers: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """The wipeoff before its redesign, the Triton ``wipe_kernel`` (one
    program per tile, row and dwell): the reference of :func:`pcps_wipe`
    on the card, CUDA tensors only; on no path, not counted."""
    out = _wipe_out(x_dwells, dopplers, t)
    m, n = x_dwells.shape
    rows = dopplers.numel()
    block = 1024
    _kernels()["wipe"][((n + block - 1) // block, rows, m)](
        torch.view_as_real(x_dwells), t, dopplers, torch.view_as_real(out),
        n, rows, NEG_TWO_PI, BLOCK=block, num_warps=4)
    return out


def _wipe_lib():
    lib = cuda_build.load("pcps_wipe")
    fn = lib.pcps_wipe
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def pcps_peak(corr: torch.Tensor, n_dwells: int):
    """K3 peak kernel: [M, C, D, N] complex64 correlations -> (stat [C],
    doppler_idx [C] int32, delay_idx [C] int32): the CFAR statistic of
    max_to_input_power_stat over the dwell-summed |corr|^2 grid."""
    if not check_kernel_device(corr, "pcps_peak"):
        return _peak_plain(corr, n_dwells)
    rows = _row_pass(corr, n_dwells, "plain", 0, "pcps_peak")
    out = _stat(rows, corr.shape[-1], n_dwells)
    pcps_peak.launches += 1
    return out


pcps_peak.launches = 0


def _row_buffers(c, d, dev):
    """Per (channel, Doppler row): max, first argmax and sum of the grid."""
    return (torch.empty((c, d), dtype=torch.float32, device=dev),
            torch.empty((c, d), dtype=torch.int32, device=dev),
            torch.empty((c, d), dtype=torch.float32, device=dev))


def _stat(rows, n: int, n_sums: int):
    """The stat kernel over the row buffers: (stat [C], doppler_idx [C],
    delay_idx [C]), the noise power taken as the opposite row's mean / 2 /
    `n_sums`, the correlations summed per cell (max_to_input_power_stat)."""
    import triton
    stat_kernel = _kernels()["stat"]
    rmax = rows[0]
    c, d = rmax.shape
    dev = rmax.device
    stat = torch.empty(c, dtype=torch.float32, device=dev)
    dop_idx = torch.empty(c, dtype=torch.int32, device=dev)
    del_idx = torch.empty(c, dtype=torch.int32, device=dev)
    stat_kernel[(c,)](*rows, stat, dop_idx, del_idx, d, d // 2,
                      float(np.float32(1.0) / np.float32(n)),
                      float(n_sums),
                      BLOCK_D=triton.next_power_of_2(d), num_warps=1)
    return stat, dop_idx, del_idx


# K3c's row tile: 1024 lanes, grid (C, ceil(N / 1024))
SECOND_BLOCK = 1024
# the row kernel's tile: at most this many lanes, looped over the row
ROW_TILE = 2048


def row_plan(n: int, form: str) -> tuple[int, int]:
    """The row kernel's (tile lanes, warps) for rows of `n` cells of the
    grid form `form`: K3's plain rows the power of two that holds them, at
    most ROW_TILE lanes; a full tile in 4 warps, a shorter one in 8 (on
    the H100, 8 warps made K3's peak at N = 2000 slower and 4 warps
    QuickSync's 512-lane rows: ``chip_smoke.py``); the two-plane forms
    (K4a, K4c) 1024 lanes in 4 warps."""
    if form != "plain":
        return 1024, 4
    tile = min(ROW_TILE, 1 << max(n - 1, 1).bit_length())
    return tile, 4 if tile == ROW_TILE else 8


def _row_pass(corr, n_dwells: int, form: str, caf_bins: int, who: str):
    """The row kernel of the search that finds the peak (K3's for "plain",
    K4a's for "dual", K4c's for "caf") into fresh row buffers: per
    (channel, Doppler row) the max, its first index and the sum."""
    dev = corr.device
    require(corr, torch.complex64, dev, f"{who}: corr")
    if form == "plain":
        m, c, d, n = corr.shape
    else:
        m, c, d, two, n = corr.shape
        if two != 2:
            raise ValueError(f"{who}: corr must be [n_dwells, C, D, 2, N]")
    if m != n_dwells or caf_bins < 0:
        raise ValueError(f"{who}: n_dwells must match corr.shape[0] and "
                         "caf_bins >= 0")
    rows = _row_buffers(c, d, dev)
    block, warps = row_plan(n, form)
    _kernels()["row"][(d, c)](
        torch.view_as_real(corr), *rows, m, c, d, n,
        float(np.float32(1.0) / np.float32(2 * caf_bins + 1)),
        FORM=FORMS.index(form), CAF_BINS=caf_bins if form == "caf" else 0,
        BLOCK=block, num_warps=warps)
    return rows


def _rows_plain(corr):
    """Per (channel, Doppler row) of the dwell-summed |corr|^2 grid: the
    max, its first index (int32) and the sum."""
    grid = _plain_grid(corr)
    rarg = torch.argmax(grid, dim=-1, keepdim=True)
    return (torch.gather(grid, -1, rarg)[..., 0], rarg[..., 0].to(torch.int32),
            torch.sum(grid, dim=-1))


def pcps_rows(corr: torch.Tensor, n_dwells: int):
    """K3's row kernel alone: [M, C, D, N] complex64 correlations ->
    (max [C, D], first argmax [C, D] int32, sum [C, D]) of each Doppler
    row of the dwell-summed |corr|^2 grid, the rows a Doppler-sharded
    search reduces across ranks (``parallel.shard_steps``).  The [C, D, N]
    grid never reaches device memory.  Counted in ``pcps_rows.launches``."""
    if not check_kernel_device(corr, "pcps_rows"):
        return _rows_plain(corr)
    rows = _row_pass(corr, n_dwells, "plain", 0, "pcps_rows")
    pcps_rows.launches += 1
    return rows


pcps_rows.launches = 0


def _window_fold_plain(corr, n: int):
    d, row_len = corr.shape
    lags = corr[:, :row_len - n]
    mag = lags.real ** 2 + lags.imag ** 2
    return mag.reshape(d, -1, n).sum(dim=1)


WINDOW_FOLD_BLOCK = 1024


def pcps_window_fold(corr: torch.Tensor, n: int) -> torch.Tensor:
    """K7, the overlap-save fold: [D, L + N] complex64 linear correlations
    of an extended segment -> [D, N] float32, grid[d, k] = sum_w
    |corr[d, w N + k]|^2 over the L / N code-period windows of the first L
    lags (the valid ones; the last N are the halo's).  Counted in
    ``pcps_window_fold.launches``."""
    if corr.dim() != 2 or n < 1:
        raise ValueError("pcps_window_fold: corr must be [D, L + N]")
    d, row_len = corr.shape
    n_lags = row_len - n
    if n_lags < n or n_lags % n:
        raise ValueError(f"pcps_window_fold: L = {n_lags} lags must be a "
                         f"positive multiple of N = {n}")
    if not check_kernel_device(corr, "pcps_window_fold"):
        return _window_fold_plain(corr, n)
    require(corr, torch.complex64, corr.device, "pcps_window_fold: corr")
    out = torch.empty((d, n), dtype=torch.float32, device=corr.device)
    _kernels()["window_fold"][(-(-n // WINDOW_FOLD_BLOCK), d)](
        torch.view_as_real(corr), out, row_len, n, n_lags // n,
        BLOCK=WINDOW_FOLD_BLOCK, num_warps=4)
    pcps_window_fold.launches += 1
    return out


pcps_window_fold.launches = 0


def pcps_dual_peak(corr: torch.Tensor, n_dwells: int):
    """K4a, the sign-recovery kernel: [M, C, D, 2, N] complex64, the two
    correlation planes a = [..., 0, :] and b = [..., 1, :] of the CCCWSR
    (data, pilot) or 8 ms (first half, second half) search -> (stat [C],
    doppler_idx [C] int32, delay_idx [C] int32): the CFAR statistic of the
    grid sum_m max(|a+b|^2, |a-b|^2) with 2 * n_dwells correlations per
    cell.  Each plane is read once; the [C, D, N] grid never reaches
    device memory."""
    if not check_kernel_device(corr, "pcps_dual_peak"):
        return _dual_peak_plain(corr, n_dwells)
    rows = _row_pass(corr, n_dwells, "dual", 0, "pcps_dual_peak")
    out = _stat(rows, corr.shape[-1], 2 * n_dwells)
    pcps_dual_peak.launches += 1
    return out


pcps_dual_peak.launches = 0


def pcps_caf_peak(corr: torch.Tensor, n_dwells: int, caf_bins: int):
    """K4c, the E5a non-coherent I/Q kernel: [M, C, D, 2, N] complex64, the
    E5a-I plane [..., 0, :] and the E5a-Q plane [..., 1, :] -> (stat [C],
    doppler_idx [C] int32, delay_idx [C] int32): the CFAR statistic of the
    grid sum_m |ci|^2 + |cq|^2 smoothed along Doppler by the
    (2 caf_bins + 1)-row boxcar (:func:`caf_smooth`), with 2 * n_dwells
    correlations per cell.  The [C, D, N] grid never reaches device
    memory."""
    if not check_kernel_device(corr, "pcps_caf_peak"):
        return _caf_peak_plain(corr, n_dwells, caf_bins)
    rows = _row_pass(corr, n_dwells, "caf", caf_bins, "pcps_caf_peak")
    out = _stat(rows, corr.shape[-1], 2 * n_dwells)
    pcps_caf_peak.launches += 1
    return out


pcps_caf_peak.launches = 0


def pcps_second_peak(corr: torch.Tensor, n_dwells: int, samples_per_chip: int,
                     form: str = "plain", caf_bins: int = 0):
    """K3c, the first-vs-second-peak statistic (``use_CFAR_algorithm=
    false``; first_vs_second_peak_stat): the correlations of a search in
    the grid form `form` of :data:`FORMS` ("plain": K3's [M, C, D, N];
    "dual": K4a's [M, C, D, 2, N] sign-recovery planes; "caf": K4c's E5a
    I and Q planes with the (2 caf_bins + 1)-row boxcar) -> (stat [C],
    doppler_idx [C] int32, delay_idx [C] int32): the grid's peak over the
    max of its Doppler row with the cells within `samples_per_chip` of the
    peak delay (circularly) zeroed.  Three launches: the form's row kernel
    (the peak), the row tiles of the peak row, the ratio, counted once in
    ``pcps_second_peak.launches`` (plain form), ``.launches_dual`` or
    ``.launches_caf``.  The [C, D, N] grid never reaches device memory."""
    if form not in FORMS:
        raise ValueError(f"pcps_second_peak: form {form!r}")
    if not check_kernel_device(corr, "pcps_second_peak"):
        return _second_peak_plain(corr, samples_per_chip, form, caf_bins)
    import triton
    rows = _row_pass(corr, n_dwells, form, caf_bins, "pcps_second_peak")
    c, d = rows[0].shape
    n = corr.shape[-1]
    dev = corr.device
    n_tiles = -(-n // SECOND_BLOCK)
    tmax = torch.empty((c, n_tiles), dtype=torch.float32, device=dev)
    block_d = triton.next_power_of_2(d)
    _kernels()["second_tile"][(c, n_tiles)](
        torch.view_as_real(corr), rows[0], rows[1], tmax, n_dwells, c, d, n,
        int(samples_per_chip),
        float(np.float32(1.0) / np.float32(2 * caf_bins + 1)), n_tiles,
        FORM=FORMS.index(form), CAF_BINS=caf_bins if form == "caf" else 0,
        BLOCK=SECOND_BLOCK, BLOCK_D=block_d, num_warps=4)
    stat = torch.empty(c, dtype=torch.float32, device=dev)
    dop_idx = torch.empty(c, dtype=torch.int32, device=dev)
    del_idx = torch.empty(c, dtype=torch.int32, device=dev)
    _kernels()["second_stat"][(c,)](
        rows[0], rows[1], tmax, stat, dop_idx, del_idx, d, n_tiles,
        BLOCK_D=block_d, BLOCK_T=triton.next_power_of_2(n_tiles),
        num_warps=1)
    counter = "launches" if form == "plain" else f"launches_{form}"
    setattr(pcps_second_peak, counter,
            getattr(pcps_second_peak, counter) + 1)
    return stat, dop_idx, del_idx


pcps_second_peak.launches = 0
pcps_second_peak.launches_dual = 0
pcps_second_peak.launches_caf = 0


def detect(corr: torch.Tensor, n_dwells: int, use_cfar: bool = True,
           samples_per_chip: int = 1, form: str = "plain",
           caf_bins: int = 0):
    """The detection statistic of a search's correlations: the CFAR
    statistic of the form's kernel (K3 peak, K4a, K4c) with `use_cfar`,
    else K3c's first-vs-second-peak ratio.  (stat [C], doppler_idx [C],
    delay_idx [C])."""
    if not use_cfar:
        return pcps_second_peak(corr, n_dwells, samples_per_chip, form,
                                caf_bins)
    if form == "plain":
        return pcps_peak(corr, n_dwells)
    if form == "dual":
        return pcps_dual_peak(corr, n_dwells)
    return pcps_caf_peak(corr, n_dwells, caf_bins)


def pcps_search(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
                dopplers: torch.Tensor, t: torch.Tensor,
                use_cfar: bool = True, samples_per_chip: int = 1):
    """The whole search: (stat [C], doppler_idx [C], delay_idx [C]).
    The wipeoff kernel, cuFFT forward, the product with conj(code FFT)
    into cuFFT inverse, then the CFAR statistic (K3's peak kernel) or,
    without `use_cfar`, the first-vs-second-peak ratio (K3c) with a
    `samples_per_chip` exclusion zone."""
    m = x_dwells.shape[0]
    wiped = pcps_wipe(x_dwells, dopplers, t)
    spec = torch.fft.fft(wiped, dim=-1)
    corr = torch.fft.ifft(spec[:, None, :, :]
                          * code_fft_conj[None, :, None, :], dim=-1)
    return detect(corr, m, use_cfar, samples_per_chip)


def _narrow_search(x_dwells, code_fft_conj, dops2, t):
    """One narrow per-channel grid (K3b wipe, cuFFT, K3 peak) over the
    [C, D2] Doppler table -> (stat2 [C], the winning Doppler [C])."""
    m = x_dwells.shape[0]
    wiped = pcps_wipe(x_dwells, dops2, t)
    spec = torch.fft.fft(wiped, dim=-1)
    corr = torch.fft.ifft(spec * code_fft_conj[None, :, None, :], dim=-1)
    stat2, dop2_idx, _ = pcps_peak(corr, m)
    return stat2, torch.gather(dops2, 1, dop2_idx.long()[:, None])[:, 0]


def pcps_search_two_steps(x_dwells: torch.Tensor,
                          code_fft_conj: torch.Tensor,
                          dopplers: torch.Tensor, t: torch.Tensor,
                          two_steps: bool, n_side: int,
                          step2: float, use_cfar: bool = True,
                          samples_per_chip: int = 1) -> torch.Tensor:
    """The fused search of the JAX engine: the coarse search (the CFAR
    statistic, or the first-vs-second-peak ratio without `use_cfar`), then
    (with `two_steps`) every channel's narrow grid of 2 * n_side + 1 bins
    `step2` Hz apart around its coarse Doppler, always under the CFAR
    statistic (acquisition.py:94).  Returns the packed [4, C] float32
    buffer (stat, doppler_hz, delay_idx, stat2); stat2 is 0 without the
    second step.  Nothing is pulled to the host in between."""
    stat, dop_idx, del_idx = pcps_search(x_dwells, code_fft_conj, dopplers, t,
                                         use_cfar, samples_per_chip)
    dop_hz = dopplers[dop_idx.long()]
    stat2 = torch.zeros_like(stat)
    if two_steps:
        offs = ((torch.arange(2 * n_side + 1, device=dopplers.device)
                 - n_side) * float(np.float32(step2))).to(torch.float32)
        dops2 = (dop_hz[:, None] + offs[None, :]).contiguous()    # [C, D2]
        stat2, dop_hz = _narrow_search(x_dwells, code_fft_conj, dops2, t)
    return torch.stack([stat.to(torch.float32), dop_hz.to(torch.float32),
                        del_idx.to(torch.float32), stat2.to(torch.float32)])


def dual_correlations(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
                      code2_fft_conj: torch.Tensor | None,
                      dopplers: torch.Tensor, t: torch.Tensor,
                      variant: str) -> torch.Tensor:
    """The two correlation planes of a sign-recovery search as one
    [M, C, D, 2, N] complex64 tensor (K4a's input), through the wipeoff
    kernel and cuFFT:

    - "cccwsr": x_dwells [M, N] wiped, one forward FFT, then one inverse
      FFT of the products with the two replica families, plane 0 with
      `code2_fft_conj` (the acquisition engine's second family), plane 1
      with `code_fft_conj`, as acquisition.py:_acquire_dual orders them;
    - "8ms": x_dwells [M, 2N] wiped over the whole 2N (the halves keep their
      relative phase, pcps.py:226-230), each half FFT'd and multiplied by
      the one replica; plane 0 the first half, plane 1 the second;
    - "iq_caf": as "cccwsr", plane 0 with `code_fft_conj` (E5a-I), plane 1
      with `code2_fft_conj` (E5a-Q).
    `t` is the wipeoff's time axis over the dwell ([N] or [2N])."""
    return dual_from_wiped(pcps_wipe(x_dwells, dopplers, t), code_fft_conj,
                           code2_fft_conj, variant)


def dual_from_wiped(wiped: torch.Tensor, code_fft_conj: torch.Tensor,
                    code2_fft_conj: torch.Tensor | None,
                    variant: str) -> torch.Tensor:
    """:func:`dual_correlations` from the wiped dwells [M, D, n] on: the
    forward cuFFT, the products with the replicas, the inverse cuFFT."""
    m = wiped.shape[0]
    if variant in ("cccwsr", "iq_caf"):
        spec = torch.fft.fft(wiped, dim=-1)[:, None, :, None, :]
        pair = ((code2_fft_conj, code_fft_conj) if variant == "cccwsr"
                else (code_fft_conj, code2_fft_conj))
        codes = torch.stack(pair, dim=1)
    elif variant == "8ms":
        n = wiped.shape[-1] // 2
        spec = torch.fft.fft(wiped.reshape(m, -1, 2, n), dim=-1)[:, None]
        codes = code_fft_conj[:, None, :]
    else:
        raise ValueError(f"dual_correlations: variant {variant!r}")
    return torch.fft.ifft(spec * codes[None, :, None, :, :], dim=-1)


def pcps_search_dual(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
                     code2_fft_conj: torch.Tensor | None,
                     dopplers: torch.Tensor, t: torch.Tensor,
                     variant: str, use_cfar: bool = True,
                     samples_per_chip: int = 1) -> torch.Tensor:
    """The sign-recovery search of acquisition.py:_acquire_dual
    ("cccwsr" or "8ms", see :func:`dual_correlations`), then K4a (K3c's
    dual form without `use_cfar`).  Returns the packed [4, C] float32
    buffer of :func:`pcps_search_two_steps` (stat, doppler_hz, delay_idx,
    stat2) with stat2 = 0: the dual variants search one grid, whatever
    make_two_steps says."""
    corr = dual_correlations(x_dwells, code_fft_conj, code2_fft_conj,
                             dopplers, t, variant)
    stat, dop_idx, del_idx = detect(corr, x_dwells.shape[0], use_cfar,
                                    samples_per_chip, "dual")
    return torch.stack([stat.to(torch.float32),
                        dopplers[dop_idx.long()].to(torch.float32),
                        del_idx.to(torch.float32), torch.zeros_like(stat)])


def pcps_search_iq_caf(x_dwells: torch.Tensor, code_i_fft_conj: torch.Tensor,
                       code_q_fft_conj: torch.Tensor,
                       dopplers: torch.Tensor, t: torch.Tensor,
                       caf_bins: int, use_cfar: bool = True,
                       samples_per_chip: int = 1) -> torch.Tensor:
    """The E5a non-coherent I/Q search of acquisition.py:_acquire_dual
    ("iq_caf"): the wipeoff kernel, one cuFFT forward, the products with
    the E5a-I and E5a-Q replicas into one cuFFT inverse, then K4c (K3c's
    CAF form without `use_cfar`).  Returns the packed [4, C] float32
    buffer (stat, doppler_hz, delay_idx, 0): one grid, whatever
    make_two_steps says."""
    corr = dual_correlations(x_dwells, code_i_fft_conj, code_q_fft_conj,
                             dopplers, t, "iq_caf")
    stat, dop_idx, del_idx = detect(corr, x_dwells.shape[0], use_cfar,
                                    samples_per_chip, "caf", caf_bins)
    return torch.stack([stat.to(torch.float32),
                        dopplers[dop_idx.long()].to(torch.float32),
                        del_idx.to(torch.float32), torch.zeros_like(stat)])


def pcps_quicksync_fold(x_dwells: torch.Tensor, dopplers: torch.Tensor,
                        t: torch.Tensor, fold: int) -> torch.Tensor:
    """K4b fold kernel: [M, N] dwells x exp(-j 2 pi f_d t) over a [D]
    Doppler grid, summed over `fold` equal segments -> [M, D, N // fold]
    complex64 (the QuickSync cuFFT input); the [M, D, N] wiped dwells are
    never written."""
    if not check_kernel_device(x_dwells, "pcps_quicksync_fold"):
        return _fold_plain(x_dwells, dopplers, t, fold)
    dev = x_dwells.device
    require(x_dwells, torch.complex64, dev, "pcps_quicksync_fold: x_dwells")
    require(dopplers, torch.float32, dev, "pcps_quicksync_fold: dopplers")
    require(t, torch.float32, dev, "pcps_quicksync_fold: t")
    m, n = x_dwells.shape
    nf = n // fold
    d = dopplers.shape[0]
    if dopplers.dim() != 1 or fold < 1 or nf < 1 or t.shape[0] < nf * fold:
        raise ValueError("pcps_quicksync_fold: bad shapes")
    out = torch.empty((m, d, nf), dtype=torch.complex64, device=dev)
    block = 512
    _kernels()["fold"][((nf + block - 1) // block, d, m)](
        torch.view_as_real(x_dwells), t, dopplers, torch.view_as_real(out),
        n, nf, d, fold, float(np.float32(-2.0 * math.pi)), BLOCK=block,
        num_warps=4)
    pcps_quicksync_fold.launches += 1
    return out


pcps_quicksync_fold.launches = 0


def pcps_quicksync_resolve(x_dwell: torch.Tensor,
                           codes_sampled: torch.Tensor,
                           doppler_hz: torch.Tensor,
                           delay_mod: torch.Tensor, t: torch.Tensor,
                           fold: int):
    """K4b resolve kernel: for each channel c, the full-length correlation
    |sum_i x[i] exp(-j 2 pi f_c t_i) code[c, (i - d) mod N]| at the `fold`
    candidates d = delay_mod[c] + k * N // fold (one program per (channel,
    candidate)), then the largest candidate, first on ties, on the card ->
    ([C] int32 delays, [C] float32 magnitudes).  x_dwell [N] complex64,
    codes_sampled [C, N] float32, doppler_hz [C] float32, delay_mod [C]
    int32."""
    if not check_kernel_device(x_dwell, "pcps_quicksync_resolve"):
        return _resolve_plain(x_dwell, codes_sampled, doppler_hz, delay_mod,
                              t, fold)
    dev = x_dwell.device
    require(x_dwell, torch.complex64, dev, "pcps_quicksync_resolve: x_dwell")
    require(codes_sampled, torch.float32, dev,
            "pcps_quicksync_resolve: codes_sampled")
    require(doppler_hz, torch.float32, dev,
            "pcps_quicksync_resolve: doppler_hz")
    require(delay_mod, torch.int32, dev, "pcps_quicksync_resolve: delay_mod")
    require(t, torch.float32, dev, "pcps_quicksync_resolve: t")
    c, n = codes_sampled.shape
    nf = n // fold
    if x_dwell.shape != (n,) or t.shape[0] < n or doppler_hz.shape != (c,) \
            or delay_mod.shape != (c,) or nf < 1:
        raise ValueError("pcps_quicksync_resolve: bad shapes")
    mags = torch.empty((c, fold), dtype=torch.float32, device=dev)
    _kernels()["resolve"][(c, fold)](
        torch.view_as_real(x_dwell), t, codes_sampled, doppler_hz, delay_mod,
        mags, n, nf, fold, float(np.float32(-2.0 * math.pi)), BLOCK=1024,
        num_warps=4)
    pcps_quicksync_resolve.launches += 1
    k = torch.argmax(mags, dim=1)
    delays = delay_mod + nf * k.to(torch.int32)
    return delays, torch.gather(mags, 1, k[:, None])[:, 0]


pcps_quicksync_resolve.launches = 0


def pcps_search_quicksync(x_dwells: torch.Tensor, codes_sampled: torch.Tensor,
                          code_fold_fft_conj: torch.Tensor,
                          dopplers: torch.Tensor, t: torch.Tensor,
                          fold: int) -> torch.Tensor:
    """The QuickSync search of acquisition.py:_acquire_quicksync: the fold
    kernel, cuFFT, the product with the folded replica's conjugate
    spectrum `code_fold_fft_conj` [C, N // fold] into cuFFT inverse, the K3
    peak kernel on the [M, C, D, N // fold] planes (the folded lag), then
    the resolve kernel on dwell 0 at each channel's Doppler.  Returns the
    packed [4, C] float32 buffer (stat, doppler_hz, delay mod N, 0); the
    Doppler index and the folded lag never leave the card."""
    m, n = x_dwells.shape
    folded = pcps_quicksync_fold(x_dwells, dopplers, t, fold)
    spec = torch.fft.fft(folded, dim=-1)
    corr = torch.fft.ifft(spec[:, None, :, :]
                          * code_fold_fft_conj[None, :, None, :], dim=-1)
    stat, dop_idx, lag = pcps_peak(corr, m)
    dop_hz = dopplers[dop_idx.long()].contiguous()
    delays, _ = pcps_quicksync_resolve(x_dwells[0], codes_sampled, dop_hz,
                                       lag, t, fold)
    return torch.stack([stat.to(torch.float32), dop_hz,
                        torch.remainder(delays, n).to(torch.float32),
                        torch.zeros_like(stat)])


def pcps_search_fine_doppler(x_dwells: torch.Tensor,
                             code_fft_conj: torch.Tensor,
                             dopplers: torch.Tensor, t: torch.Tensor,
                             step_hz: float, iters: int,
                             use_cfar: bool = True,
                             samples_per_chip: int = 1) -> torch.Tensor:
    """The Fine Doppler search of acquisition.py:_fine_doppler: the coarse
    search (CFAR, or K3c without `use_cfar`), then `iters` (at least 1)
    narrow CFAR grids of 9 bins around each channel's current Doppler, the
    step starting at `step_hz` and divided by 4 each time (the table
    formed in float64 and rounded to float32, as the JAX engine forms it
    on the host).  Returns the packed [4, C] buffer (stat, doppler_hz,
    delay_idx, stat2 of the last iteration) with no host pull in
    between."""
    stat, dop_idx, del_idx = pcps_search(x_dwells, code_fft_conj, dopplers, t,
                                         use_cfar, samples_per_chip)
    dop = dopplers[dop_idx.long()]
    stat2 = torch.zeros_like(stat)
    step = float(step_hz)
    for _ in range(max(int(iters), 1)):
        offs = (torch.arange(9, dtype=torch.float64, device=dop.device)
                - 4) * step
        dops2 = (dop.to(torch.float64)[:, None] + offs[None, :]).to(
            torch.float32).contiguous()
        stat2, dop = _narrow_search(x_dwells, code_fft_conj, dops2, t)
        step /= 4.0
    return torch.stack([stat.to(torch.float32), dop.to(torch.float32),
                        del_idx.to(torch.float32), stat2.to(torch.float32)])


def pcps_search_dwells(x_dwells: torch.Tensor, code_fft_conj: torch.Tensor,
                       dopplers: torch.Tensor, t: torch.Tensor,
                       use_cfar: bool = True,
                       samples_per_chip: int = 1) -> torch.Tensor:
    """One single-dwell search per row of x_dwells [T, N] (the Tong
    detector's successive dwells, acquisition.py:_acquire_tong), all in one
    wipeoff and one statistic launch: the [T, C, D, N] correlations are
    read by the K3 peak kernel (K3c without `use_cfar`) as T * C channels
    of one dwell.  Returns [3, T, C] float32 (stat, doppler_hz,
    delay_idx)."""
    n_dw, n = x_dwells.shape
    c = code_fft_conj.shape[0]
    d = dopplers.shape[0]
    wiped = pcps_wipe(x_dwells, dopplers, t)                  # [T, D, N]
    spec = torch.fft.fft(wiped, dim=-1)
    corr = torch.fft.ifft(spec[:, None, :, :]
                          * code_fft_conj[None, :, None, :], dim=-1)
    stat, dop_idx, del_idx = detect(corr.reshape(1, n_dw * c, d, n), 1,
                                    use_cfar, samples_per_chip)
    return torch.stack([stat.to(torch.float32),
                        dopplers[dop_idx.long()].to(torch.float32),
                        del_idx.to(torch.float32)]).reshape(3, n_dw, c)
