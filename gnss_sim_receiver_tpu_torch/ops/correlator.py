"""Batched carrier-wipeoff + multi-tap code correlator (kernel K2).

PyTorch port of ``gnss_sim_receiver_tpu.ops.correlator``: every tracking
channel correlates a fixed-size sample block, taken from a shared chunk at
a per-channel offset, against K shifted copies of its code.

:func:`multicorrelate` is the wrapper the tracking loop calls.  On a CUDA
tensor it launches the hand-written kernel ``csrc/multicorrelator.cu``
(gather, carrier NCO, wipeoff, code NCO, K dot products in one launch, and
on a track_pilot chain the data prompt from a second table in the same
pass); on a CPU tensor it runs the plain version, :func:`gather_blocks`
followed by :func:`correlate_multitap` (once more on the data table with a
zero tap), which mirror the JAX functions line by line.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gnss_sim_receiver_tpu_torch.device import check_kernel_device, require
from gnss_sim_receiver_tpu_torch.ops import cuda_build


def gather_blocks(x: torch.Tensor, positions: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """[C] start positions -> [C, B] sample blocks from the shared chunk.
    Positions are clamped to the valid range (callers guarantee a halo)."""
    max_start = x.shape[0] - block_size
    pos = torch.clamp(positions.long(), 0, max_start)
    idx = pos[:, None] + torch.arange(block_size, device=x.device)[None, :]
    return x[idx]


def correlate_multitap(blocks: torch.Tensor, codes: torch.Tensor,
                       tap_offsets_chips: torch.Tensor,
                       rem_code_phase_chips: torch.Tensor,
                       code_freq_chips: torch.Tensor,
                       rem_carrier_phase_rad: torch.Tensor,
                       carrier_doppler_hz: torch.Tensor,
                       n_samples: torch.Tensor, fs: float,
                       table_oversample: int = 1) -> torch.Tensor:
    """Plain version: NCO + wipeoff + K-tap correlation -> [C, K] complex64.

    `table_oversample` > 1 selects band-limited sub-chip replica tables
    (`table_oversample` entries per chip): the lookup index becomes
    floor(chips * oversample)."""
    c, b = blocks.shape
    n = torch.arange(b, dtype=torch.float32, device=blocks.device)[None, :]
    inv_fs = float(torch.tensor(1.0 / fs, dtype=torch.float32))
    phase = (rem_carrier_phase_rad[:, None]
             + 2.0 * math.pi * carrier_doppler_hz[:, None] * n * inv_fs)
    rot = torch.complex(torch.cos(phase), -torch.sin(phase))
    mask = n < n_samples[:, None].to(torch.float32)
    xr = blocks * rot * mask
    chips = (rem_code_phase_chips[:, None]
             + code_freq_chips[:, None] * n * inv_fs)
    l = codes.shape[1]
    idx = torch.floor((chips[:, None, :] + tap_offsets_chips[None, :, None])
                      * float(table_oversample)).to(torch.int32)
    idx = torch.remainder(idx, l).long()                      # [C, K, B]
    code_vals = torch.gather(codes[:, None, :].expand(-1, idx.shape[1], -1),
                             2, idx)                          # [C, K, B]
    return torch.einsum("ckb,cb->ck", code_vals.to(torch.complex64), xr)


def multicorrelate(x: torch.Tensor, positions: torch.Tensor,
                   block_size: int, codes: torch.Tensor,
                   taps: torch.Tensor, rem_code_phase_chips: torch.Tensor,
                   code_freq_chips: torch.Tensor,
                   rem_carrier_phase_rad: torch.Tensor,
                   carrier_doppler_hz: torch.Tensor,
                   n_samples: torch.Tensor, fs: float,
                   table_oversample: int = 1,
                   data_codes: torch.Tensor | None = None,
                   data_oversample: int = 1) -> torch.Tensor:
    """K2 wrapper: gather_blocks + correlate_multitap -> [C, K] complex64.
    With `data_codes` ([C, L'] tables, `data_oversample` entries per chip)
    one more zero-offset tap on them comes out of the same pass: [C, K+1],
    the last column the data prompt of a track_pilot chain.  Launches
    ``csrc/multicorrelator.cu`` for CUDA tensors and runs the plain version
    for CPU tensors."""
    if not check_kernel_device(x, "multicorrelate"):
        blocks = gather_blocks(x, positions, block_size)
        nco = (rem_code_phase_chips, code_freq_chips, rem_carrier_phase_rad,
               carrier_doppler_hz, n_samples, fs)
        corr = correlate_multitap(blocks, codes, taps, *nco,
                                  table_oversample)
        if data_codes is None:
            return corr
        zero_tap = torch.zeros(1, dtype=torch.float32, device=x.device)
        return torch.cat([corr, correlate_multitap(
            blocks, data_codes, zero_tap, *nco, data_oversample)], dim=1)
    out = torch.empty((codes.shape[0], taps.shape[0]
                       + (data_codes is not None)),
                      dtype=torch.complex64, device=x.device)
    launch(launch_args(x, positions, block_size, codes, taps,
                       rem_code_phase_chips, code_freq_chips,
                       rem_carrier_phase_rad, carrier_doppler_hz, n_samples,
                       fs, table_oversample, out, data_codes,
                       data_oversample))
    return out


multicorrelate.launches = 0


def launch_args(x, positions, block_size, codes, taps, rem_code_phase_chips,
                code_freq_chips, rem_carrier_phase_rad, carrier_doppler_hz,
                n_samples, fs, table_oversample, out, data_codes=None,
                data_oversample=1) -> tuple:
    """K2's checked launch arguments on CUDA tensors, writing into `out`
    ([C, K], or [C, K+1] with `data_codes`): build once, launch with
    :func:`launch` as often as the tensors hold the next inputs."""
    c, table_len = codes.shape
    k = taps.shape[0]
    f32 = torch.float32
    args = dict(codes=(codes, f32), taps=(taps, f32),
                rem_code=(rem_code_phase_chips, f32),
                code_freq=(code_freq_chips, f32),
                rem_carr=(rem_carrier_phase_rad, f32),
                dop=(carrier_doppler_hz, f32), pos=(positions, torch.int32),
                n_samples=(n_samples, torch.int32),
                out=(out, torch.complex64))
    if data_codes is not None:
        args["data_codes"] = (data_codes, f32)
    for name, (t, dt) in args.items():
        require(t, dt, x.device, f"multicorrelate: {name}")
    require(x, torch.complex64, x.device, "multicorrelate: x")
    if x.dim() != 1:
        raise ValueError("multicorrelate: x must be one-dimensional")
    if x.shape[0] < block_size:
        raise ValueError("multicorrelate: chunk shorter than one block")
    n_out = k + (data_codes is not None)
    if out.shape != (c, n_out) or (data_codes is not None
                                   and data_codes.shape[0] != c):
        raise ValueError("multicorrelate: shape mismatch")
    inv_fs = float(torch.tensor(1.0 / fs, dtype=f32))
    return (x.data_ptr(), x.shape[0], codes.data_ptr(), table_len,
            taps.data_ptr(), k, positions.data_ptr(),
            rem_code_phase_chips.data_ptr(), code_freq_chips.data_ptr(),
            rem_carrier_phase_rad.data_ptr(), carrier_doppler_hz.data_ptr(),
            n_samples.data_ptr(), inv_fs, float(table_oversample),
            block_size,
            None if data_codes is None else data_codes.data_ptr(),
            0 if data_codes is None else data_codes.shape[1],
            float(data_oversample), out.data_ptr(), c,
            torch.cuda.current_stream(x.device).cuda_stream)


def launch(args: tuple) -> None:
    """Launch K2 with :func:`launch_args`' arguments; counts the launch."""
    cuda_build.check(_lib().multicorrelate(*args), "multicorrelate")
    multicorrelate.launches += 1


def _lib():
    lib = cuda_build.load("multicorrelator")
    fn = lib.multicorrelate
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, f, f, i, p, i, f,
                       p, i, p]
        fn.restype = ctypes.c_int
    return lib
