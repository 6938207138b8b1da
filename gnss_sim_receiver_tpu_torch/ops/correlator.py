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

The kernel splits each channel's block over S CTAs (:func:`plan_k2`) and
sums the slabs' partial correlations in slab order inside the same
launch; its scratch (:class:`K2Scratch`) holds the partials, one arrival
counter per channel and the count of table reads that missed the staged
span.  The slab body is a device function that the per-epoch chunk kernel
(``csrc/epoch_chunk.cu``, ``models/tracking.py:epoch_chunk``) runs too, on
the same plan and with the same :class:`_K2Args`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from gnss_sim_receiver_tpu_torch.device import (H100_SMS, check_kernel_device,
                                                require, sm_count)
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


# ---- the launch plan ----------------------------------------------------------

# blocks up to this many samples run one CTA per channel (GPS L1 C/A at
# 2 Msps: B = 2048, a launch bound by its latency); longer ones are split
# into slabs of at least K2_MIN_SLAB samples, two per thread
K2_SMALL_BLOCK = 4096
K2_MIN_SLAB = 512
# staged floats per CTA: beside the kernel's ~0.6 KB of static shared
# memory (its reduction) a CTA stays under the 48 KB a launch may take
# without an opt-in; a larger stage would fail the launch
K2_MAX_STAGE = 12032


class K2Plan(NamedTuple):
    """K2's launch shape: `slabs` CTAs per channel, and the entries of the
    code table (`stage`) and of the data table (`data_stage`) each CTA
    stages in shared memory."""
    slabs: int
    stage: int
    data_stage: int


def plan_k2(n_ch: int, block_size: int, table_len: int,
            table_oversample: float, data_table_len: int = 0,
            data_oversample: float = 1, sms: int = H100_SMS) -> K2Plan:
    """K2's plan for C channels of B-sample blocks: about two CTAs per SM
    of a card of `sms` SMs for long blocks, one CTA per channel
    for short ones; the staged span of each table covers a slab's share of
    one code period (the table's length over about B samples) with 6 %
    and 4 chips of taps to spare.  A gather outside the span still reads
    the right entry, from global memory.  Raises if no plan fits."""
    if not (1 <= n_ch <= 65535 and block_size >= 1 and table_len >= 1
            and data_table_len >= 0):
        raise ValueError(f"plan_k2: no plan for C={n_ch}, B={block_size}, "
                         f"table {table_len}, data table {data_table_len}")
    if block_size <= K2_SMALL_BLOCK:
        slabs = 1
    else:
        slabs = max(1, min(2 * sms // n_ch,
                           block_size // K2_MIN_SLAB))
    slab = -(-block_size // slabs)

    def span(length: int, ovs: float) -> int:
        if length == 0:
            return 0
        return min(length, math.ceil(slab * length / block_size * 1.0625)
                   + 4 * math.ceil(ovs) + 8)
    stage = span(table_len, table_oversample)
    data_stage = span(data_table_len, data_oversample)
    if stage + data_stage > K2_MAX_STAGE:
        share = K2_MAX_STAGE // (2 if data_stage else 1)
        stage = min(stage, share)
        data_stage = min(data_stage, share)
    return K2Plan(slabs, stage, data_stage)


class K2Scratch(NamedTuple):
    """K2's scratch on the card: the slabs' partial sums [C, S, K(+1)],
    one arrival counter per channel (0 between launches: the last CTA of a
    channel resets its own) and the count of code-table reads that missed
    the staged span (a debug counter, int64 [1])."""
    plan: K2Plan
    partials: torch.Tensor
    arrivals: torch.Tensor
    misses: torch.Tensor


def k2_scratch(codes: torch.Tensor, n_taps: int, block_size: int,
               table_oversample: float,
               data_codes: torch.Tensor | None = None,
               data_oversample: float = 1) -> K2Scratch:
    """The plan and scratch of K2 launches on `codes` ([C, L] tables) and,
    with `data_codes`, the data tables: allocate once, launch often."""
    c, table_len = codes.shape
    data_len = 0 if data_codes is None else data_codes.shape[1]
    dev = codes.device
    plan = plan_k2(c, block_size, table_len, table_oversample, data_len,
                   data_oversample, sm_count(dev))
    n_out = n_taps + (data_codes is not None)
    return K2Scratch(
        plan, torch.empty((c, plan.slabs, n_out), dtype=torch.complex64,
                          device=dev),
        torch.zeros(c, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev))


def multicorrelate(x: torch.Tensor, positions: torch.Tensor,
                   block_size: int, codes: torch.Tensor,
                   taps: torch.Tensor, rem_code_phase_chips: torch.Tensor,
                   code_freq_chips: torch.Tensor,
                   rem_carrier_phase_rad: torch.Tensor,
                   carrier_doppler_hz: torch.Tensor,
                   n_samples: torch.Tensor, fs: float,
                   table_oversample: int = 1,
                   data_codes: torch.Tensor | None = None,
                   data_oversample: int = 1,
                   scratch: K2Scratch | None = None) -> torch.Tensor:
    """K2 wrapper: gather_blocks + correlate_multitap -> [C, K] complex64.
    With `data_codes` ([C, L'] tables, `data_oversample` entries per chip)
    one more zero-offset tap on them comes out of the same pass: [C, K+1],
    the last column the data prompt of a track_pilot chain.  Launches
    ``csrc/multicorrelator.cu`` for CUDA tensors, with `scratch` from
    :func:`k2_scratch` (or its own), and runs the plain version for CPU
    tensors."""
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
                       data_oversample, scratch))
    return out


multicorrelate.launches = 0


class _K2Args(ctypes.Structure):
    """csrc/multicorrelator.cuh's K2Args: the inputs of a K2 correlation
    that do not change between epochs."""
    _fields_ = [*((n, ctypes.c_void_p) for n in (
                    "x", "codes", "taps", "data", "misses")),
                *((n, ctypes.c_int) for n in (
                    "n_x", "table_len", "n_taps", "block_size",
                    "data_table_len", "n_slabs", "stage_cap",
                    "data_stage_cap")),
                *((n, ctypes.c_float) for n in (
                    "inv_fs", "k_ovs", "data_ovs"))]


def k2_args(x, block_size, codes, taps, fs, table_oversample, plan: K2Plan,
            misses, data_codes=None, data_oversample=1) -> _K2Args:
    """K2's checked epoch-invariant arguments on CUDA tensors, for `plan`,
    counting staged-table misses into `misses` (int64 [1])."""
    c, table_len = codes.shape
    f32 = torch.float32
    for name, t, dt in (("x", x, torch.complex64), ("codes", codes, f32),
                        ("taps", taps, f32), ("misses", misses, torch.int64)):
        require(t, dt, x.device, f"multicorrelate: {name}")
    if data_codes is not None:
        require(data_codes, f32, x.device, "multicorrelate: data_codes")
        if data_codes.shape[0] != c:
            raise ValueError("multicorrelate: shape mismatch")
    if x.dim() != 1:
        raise ValueError("multicorrelate: x must be one-dimensional")
    if x.shape[0] < block_size:
        raise ValueError("multicorrelate: chunk shorter than one block")
    if misses.shape != (1,):
        raise ValueError("multicorrelate: misses shape")
    return _K2Args(
        x=x.data_ptr(), codes=codes.data_ptr(), taps=taps.data_ptr(),
        data=None if data_codes is None else data_codes.data_ptr(),
        misses=misses.data_ptr(), n_x=x.shape[0], table_len=table_len,
        n_taps=taps.shape[0], block_size=block_size,
        data_table_len=0 if data_codes is None else data_codes.shape[1],
        n_slabs=plan.slabs, stage_cap=plan.stage,
        data_stage_cap=plan.data_stage,
        inv_fs=float(torch.tensor(1.0 / fs, dtype=f32)),
        k_ovs=float(table_oversample), data_ovs=float(data_oversample))


def launch_args(x, positions, block_size, codes, taps, rem_code_phase_chips,
                code_freq_chips, rem_carrier_phase_rad, carrier_doppler_hz,
                n_samples, fs, table_oversample, out, data_codes=None,
                data_oversample=1, scratch: K2Scratch | None = None
                ) -> tuple:
    """K2's checked launch arguments on CUDA tensors, writing into `out`
    ([C, K], or [C, K+1] with `data_codes`) through `scratch` (allocated
    here when not given): build once, launch with :func:`launch` as often
    as the tensors hold the next inputs."""
    c = codes.shape[0]
    k = taps.shape[0]
    f32 = torch.float32
    for name, t, dt in (("rem_code", rem_code_phase_chips, f32),
                        ("code_freq", code_freq_chips, f32),
                        ("rem_carr", rem_carrier_phase_rad, f32),
                        ("dop", carrier_doppler_hz, f32),
                        ("pos", positions, torch.int32),
                        ("n_samples", n_samples, torch.int32),
                        ("out", out, torch.complex64)):
        require(t, dt, x.device, f"multicorrelate: {name}")
        if t.shape[0] != c:
            raise ValueError("multicorrelate: shape mismatch")
    n_out = k + (data_codes is not None)
    if out.shape != (c, n_out):
        raise ValueError("multicorrelate: shape mismatch")
    if scratch is None:
        scratch = k2_scratch(codes, k, block_size, table_oversample,
                             data_codes, data_oversample)
    plan = scratch.plan
    for name, t, dt, shape in (
            ("partials", scratch.partials, torch.complex64,
             (c, plan.slabs, n_out)),
            ("arrivals", scratch.arrivals, torch.int32, (c,))):
        require(t, dt, x.device, f"multicorrelate: scratch {name}")
        if t.shape != shape:
            raise ValueError(f"multicorrelate: scratch {name} shape")
    a = k2_args(x, block_size, codes, taps, fs, table_oversample, plan,
                scratch.misses, data_codes, data_oversample)
    return (a, positions.data_ptr(), rem_code_phase_chips.data_ptr(),
            code_freq_chips.data_ptr(), rem_carrier_phase_rad.data_ptr(),
            carrier_doppler_hz.data_ptr(), n_samples.data_ptr(),
            out.data_ptr(), c, scratch.partials.data_ptr(),
            scratch.arrivals.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)


def launch(args: tuple) -> None:
    """Launch K2 with :func:`launch_args`' arguments; counts the launch."""
    cuda_build.check(_lib().multicorrelate(*args), "multicorrelate")
    multicorrelate.launches += 1


def _lib():
    lib = cuda_build.load("epoch_kernels")
    fn = lib.multicorrelate
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [_K2Args, p, p, p, p, p, p, p, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib
