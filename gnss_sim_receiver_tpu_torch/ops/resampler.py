"""Sample-rate conversion kernel (K5d).

PyTorch port of ``gnss_sim_receiver_tpu.ops.resampler``, the conditioner's
resampler stage (reference src/algorithms/resampler/):

  - direct_resampler: nearest-sample pick
    (direct_resampler_conditioner_cc.cc), a gather;
  - linear_resampler: first-order MMSE (the role of Mmse_Resampler;
    fractional-delay linear interpolation).

One hand-written Triton gather kernel with a mode flag serves both.  The
source position is the float32 product float32(k) * float32(ratio), formed
by one rounded multiply that nothing is contracted into: one ulp there moves
the floor to another sample.  (Above 2^24 output samples float32(k) no
longer holds every integer, as in the JAX functions.)  Each wrapper launches
the kernel for a CUDA tensor and runs its plain version for a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import check_kernel_device, require


def output_length(n_in: int, fs_in: float, fs_out: float) -> int:
    return int(np.floor(n_in * fs_out / fs_in))


# ---- plain versions --------------------------------------------------------

def _direct_plain(x, ratio: float, n_out: int):
    k = torch.arange(n_out, dtype=torch.float32, device=x.device)
    idx = torch.floor(k * ratio).to(torch.int32)
    idx = torch.clamp(idx, 0, x.shape[0] - 1)
    return x[idx.long()]


def _linear_plain(x, ratio: float, n_out: int):
    k = torch.arange(n_out, dtype=torch.float32, device=x.device)
    pos = k * ratio
    i0 = torch.floor(pos).to(torch.int32)
    frac = pos - i0.to(torch.float32)
    i0 = torch.clamp(i0, 0, x.shape[0] - 2).long()
    return x[i0] * (1.0 - frac) + x[i0 + 1] * frac


# ---- Triton kernel ---------------------------------------------------------

@functools.cache
def _kernel():
    """Define the Triton kernel (imported here, never at module import)."""
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def resample_kernel(x_ptr, out_ptr, n_in, n_out, ratio,
                        LINEAR: tl.constexpr, BLOCK: tl.constexpr):
        # x [n_in] and out [n_out] complex64 as interleaved float32
        k = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = k < n_out
        pos = libdevice.mul_rn(k.to(tl.float32), ratio)   # never an FMA
        i0f = libdevice.floor(pos)
        i0 = i0f.to(tl.int32)
        if LINEAR:
            frac = pos - i0f
            i0 = tl.minimum(tl.maximum(i0, 0), n_in - 2)
            ar = tl.load(x_ptr + i0 * 2, mask=mask, other=0.0)
            ai = tl.load(x_ptr + i0 * 2 + 1, mask=mask, other=0.0)
            br = tl.load(x_ptr + i0 * 2 + 2, mask=mask, other=0.0)
            bi = tl.load(x_ptr + i0 * 2 + 3, mask=mask, other=0.0)
            wa = 1.0 - frac
            tl.store(out_ptr + k * 2, ar * wa + br * frac, mask=mask)
            tl.store(out_ptr + k * 2 + 1, ai * wa + bi * frac, mask=mask)
        else:
            i0 = tl.minimum(tl.maximum(i0, 0), n_in - 1)
            tl.store(out_ptr + k * 2,
                     tl.load(x_ptr + i0 * 2, mask=mask, other=0.0),
                     mask=mask)
            tl.store(out_ptr + k * 2 + 1,
                     tl.load(x_ptr + i0 * 2 + 1, mask=mask, other=0.0),
                     mask=mask)

    return resample_kernel


def _resample(x, ratio: float, n_out: int, linear: bool, name: str):
    require(x, torch.complex64, x.device, f"{name}: x")
    n_in = x.shape[0]
    if x.dim() != 1 or n_in < 2 or 2 * max(n_in, n_out) >= 2 ** 31:
        raise ValueError(f"{name}: x must be [N], 2 <= N, and both lengths "
                         "below 2^30")
    import triton
    out = torch.empty(n_out, dtype=torch.complex64, device=x.device)
    if n_out == 0:
        return out
    block = 1024
    _kernel()[(triton.cdiv(n_out, block),)](
        torch.view_as_real(x), torch.view_as_real(out), n_in, n_out,
        float(np.float32(ratio)), LINEAR=linear, BLOCK=block, num_warps=4)
    return out


def direct_resampler(x: torch.Tensor, ratio_in_over_out: float,
                     n_out: int) -> torch.Tensor:
    """K5d wrapper, nearest-sample decimation/interpolation:
    out[k] = x[floor(k*r)]."""
    ratio = float(np.float32(ratio_in_over_out))
    if not check_kernel_device(x, "direct_resampler"):
        return _direct_plain(x, ratio, n_out)
    out = _resample(x, ratio, n_out, False, "direct_resampler")
    direct_resampler.launches += 1
    return out


direct_resampler.launches = 0


def linear_resampler(x: torch.Tensor, ratio_in_over_out: float,
                     n_out: int) -> torch.Tensor:
    """K5d wrapper, fractional resampling with linear interpolation."""
    ratio = float(np.float32(ratio_in_over_out))
    if not check_kernel_device(x, "linear_resampler"):
        return _linear_plain(x, ratio, n_out)
    out = _resample(x, ratio, n_out, True, "linear_resampler")
    linear_resampler.launches += 1
    return out


linear_resampler.launches = 0
