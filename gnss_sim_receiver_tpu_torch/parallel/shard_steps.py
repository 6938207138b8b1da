"""Sharded device steps over ``torch.distributed`` (kernel K7).

PyTorch port of ``gnss_sim_receiver_tpu.parallel.shard_steps``, whose four
``shard_map`` programs cover the receiver's scale axes.  Each rank is one
process (SPMD): it takes its **local** block of every argument the JAX
program shards over the mesh (``mesh.shard_channel_axis`` cuts it) and the
whole of every replicated one, and returns its local block of the carried
state beside the **gathered**, full outputs.  The collectives are NCCL's
between CUDA cards and gloo's between CPU processes, counted in the
module's :data:`collectives`:

* :func:`tracking_step_sharded` and :func:`tracking_block_step_sharded` -
  the CHANNEL axis: each rank runs its channel group through the port's
  per-epoch chunk (one launch of the chunk kernel on a card) or block scan
  (K8a once, then cuFFT and the fused K1 K8b K8a launch per block), then
  every [T, C/S] output plane is all-gathered into a rank-major buffer
  [S, T, C/S] and reordered once to [T, C] ([C/S] fields to [C]);
* :func:`acquisition_doppler_sharded` - the DOPPLER axis of a cold start:
  each rank searches its Doppler sub-band (K3's wipe, cuFFT, the code
  product, the inverse cuFFT, then K3's row kernel) and reduces it to a
  (peak, Doppler Hz, delay) candidate per channel; the candidates are
  all-gathered and the first rank with the largest peak wins, as
  ``jnp.argmax`` picks; the grid sums are all-reduced into the noise
  floor.  The [C, D, N] grid is never written;
* :func:`overlap_save_acq_grid` - the TIME axis of a long acquisition:
  each rank receives the first N samples of its right-hand neighbour (the
  overlap-save halo, ``batch_isend_irecv``; at one rank its own head,
  copied), wipes the extended segment with absolute sample times (K3's
  wipe), correlates it by cuFFT with the zero-padded code, folds |corr|^2
  of the L valid lags modulo the code period (K7's
  ``pcps.pcps_window_fold``) and all-reduces the [D, N] grid.

:func:`acquisition_doppler` and :func:`overlap_save_grid` are the
unsharded calls of the same port functions (one device, no collective):
at world size 1 the sharded steps equal them bit for bit, every
collective being a copy.

Multi-host: :func:`make_multihost_mesh` joins every rank torchrun started,
ordered rank-major, so the ranks of one host hold neighbouring channel
blocks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gnss_sim_receiver_tpu_torch.models import tracking as trk
from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
from gnss_sim_receiver_tpu_torch.ops import pcps
from gnss_sim_receiver_tpu_torch.parallel import mesh as mesh_mod
from gnss_sim_receiver_tpu_torch.parallel.mesh import ChannelMesh, make_mesh

# collective calls made by the sharded steps, by kind
collectives = {"all_gather": 0, "all_reduce": 0, "p2p": 0}


def make_multihost_mesh(device=None) -> ChannelMesh:
    """The mesh over every rank that torchrun started, on any number of
    hosts, ordered rank-major (``RANK``; a host's ranks are neighbours):
    the process group from torchrun's variables, which must be set."""
    if mesh_mod._torchrun_env() is None:
        raise RuntimeError("make_multihost_mesh needs torchrun's variables "
                           f"{mesh_mod.TORCHRUN_VARS}")
    return make_mesh(device=device)


def _check(mesh: ChannelMesh, t: torch.Tensor, what: str) -> None:
    """`t` lies on the rank's device, and the group's backend is the one
    for it: NCCL for a card."""
    if t.device != mesh.device:
        raise ValueError(f"{what} is on {t.device}, the rank's device is "
                         f"{mesh.device}")
    if mesh.backend != mesh_mod.backend_for(t.device):
        raise RuntimeError(f"{what}: a {t.device.type} tensor needs the "
                           f"{mesh_mod.backend_for(t.device)} backend, the "
                           f"group runs {mesh.backend}")


def _all_gather(t: torch.Tensor, mesh: ChannelMesh) -> torch.Tensor:
    """Every rank's `t` [n, ...] concatenated rank-major along the leading
    axis, [S n, ...] (complex as its float pairs, bool as bytes)."""
    _check(mesh, t, "all_gather")
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = (torch.view_as_real(src) if src.is_complex() else src).contiguous()
    out = torch.empty((mesh.world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    gather = getattr(dist, "all_gather_single", None)
    (gather or dist.all_gather_into_tensor)(out, src, group=mesh.group)
    collectives["all_gather"] += 1
    if t.is_complex():
        out = torch.view_as_complex(out)
    return out.bool() if t.dtype == torch.bool else out


def _all_reduce(t: torch.Tensor, mesh: ChannelMesh) -> torch.Tensor:
    """The sum of every rank's `t`, in place."""
    _check(mesh, t, "all_reduce")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    collectives["all_reduce"] += 1
    return t


def _gather_channels(v: torch.Tensor, mesh: ChannelMesh) -> torch.Tensor:
    """A [T, C/S] plane gathered along axis 1 to [T, C], a [C/S] field
    along axis 0 to [C]: channel s C/S + c is rank s's channel c."""
    g = _all_gather(v, mesh)
    if v.dim() < 2:
        return g
    t, c = v.shape[:2]
    return (g.reshape(mesh.world, t, c, *v.shape[2:]).transpose(0, 1)
            .reshape(t, mesh.world * c, *v.shape[2:]))


def _gather_outs(outs: dict, mesh: ChannelMesh) -> dict:
    return {k: _gather_channels(v, mesh) for k, v in outs.items()}


def tracking_step_sharded(mesh: ChannelMesh, conf, n_epochs: int, codes,
                          taps, x, state):
    """One per-epoch tracking chunk with the channels sharded over `mesh`
    (``tracking.track_chunk``: one launch of the chunk kernel on a card).
    `codes` and `state` are this rank's channel block, `taps` and `x`
    whole.  Returns (this rank's new state, the [T, C] output planes
    gathered on every rank)."""
    new_state, outs = trk.track_chunk(conf, n_epochs, codes, taps, x, state)
    return new_state, _gather_outs(outs, mesh)


def tracking_block_step_sharded(mesh: ChannelMesh, conf, n_blocks: int,
                                e_block: int, codes_rep, taps, x, state,
                                sec_code=None, data_codes_rep=None):
    """The block-FFT tracking scan (``tracking_block.track_chunk_blocks``)
    with the channels sharded over `mesh`.  `codes_rep` ([C/S, F] replica
    tables) and `state` are this rank's channel block, `taps` and `x`
    whole; on a pilot chain `data_codes_rep` ([C/S, F], this rank's block)
    and `sec_code` (the chain's secondary code, whole) too.  Returns (this
    rank's new state, the outputs gathered on every rank: [T, C] planes
    along axis 1, [C] fields along axis 0)."""
    new_state, outs = tb.track_chunk_blocks(conf, n_blocks, e_block,
                                            codes_rep, taps, x, state,
                                            sec_code, data_codes_rep)
    return new_state, _gather_outs(outs, mesh)


def _doppler_candidates(x_dwells, code_fft_conj, dopplers, fs: float):
    """One device's sub-band search: ([3, C] candidates, the grid's sum
    [C]).  A candidate is the (peak, Doppler Hz, delay) of the first cell
    holding the channel's largest power, in row-major (Doppler, delay)
    order."""
    m, n = x_dwells.shape
    t = pcps.time_axis(n, fs, x_dwells.device)
    spec = torch.fft.fft(pcps.pcps_wipe(x_dwells, dopplers, t), dim=-1)
    corr = torch.fft.ifft(spec[:, None, :, :]
                          * code_fft_conj[None, :, None, :], dim=-1)
    rmax, rarg, rsum = pcps.pcps_rows(corr, m)                   # [C, D]
    d_best = torch.argmax(rmax, dim=1, keepdim=True)
    cand = torch.stack([torch.gather(rmax, 1, d_best)[:, 0],
                        dopplers[d_best[:, 0]].to(torch.float32),
                        torch.gather(rarg, 1, d_best)[:, 0].to(torch.float32)])
    return cand, torch.sum(rsum, dim=1)


def _pick(allc: torch.Tensor, total: torch.Tensor, n: int, n_bins: int):
    """The winner of [S, 3, C] candidates (the first shard with the largest
    peak) and the noise floor, the mean cell power of the whole grid."""
    win = torch.argmax(allc[:, 0, :], dim=0)                     # [C]
    sel = torch.gather(allc, 0, win[None, None, :].expand(1, 3, -1))[0]
    cells = torch.tensor(np.float32(n) * np.float32(n_bins),
                         device=total.device)
    return sel[0], sel[1], sel[2].to(torch.int32), total / cells


def acquisition_doppler(x_dwells, code_fft_conj, dopplers, fs: float):
    """The unsharded search of :func:`acquisition_doppler_sharded` on one
    device over the whole [D] grid: (peak [C], doppler_hz [C], delay_idx
    [C] int32, noise [C])."""
    cand, total = _doppler_candidates(x_dwells, code_fft_conj, dopplers, fs)
    return _pick(cand[None], total, x_dwells.shape[1], dopplers.shape[0])


def acquisition_doppler_sharded(mesh: ChannelMesh, x_dwells, code_fft_conj,
                                dopplers, fs: float):
    """PCPS with the DOPPLER axis sharded.  `dopplers` is this rank's
    sub-band [D/S] of the grid; `x_dwells` [M, N] and `code_fft_conj`
    [C, N] are whole.  Returns (peak [C], doppler_hz [C], delay_idx [C]
    int32, noise [C]) on every rank; `noise` is the mean grid power over
    the whole grid (the input-power reference of the non-CFAR path)."""
    cand, total = _doppler_candidates(x_dwells, code_fft_conj, dopplers, fs)
    allc = _all_gather(cand[None], mesh)                         # [S, 3, C]
    total = _all_reduce(total, mesh)
    return _pick(allc, total, x_dwells.shape[1],
                 dopplers.shape[0] * mesh.world)


def _code_fft_padded(code_samples, l_seg: int) -> torch.Tensor:
    """conj FFT of one code period zero-padded to L + N."""
    code = code_samples.to(torch.complex64)
    return torch.conj_physical(torch.fft.fft(torch.cat(
        [code, torch.zeros(l_seg, dtype=torch.complex64,
                           device=code.device)])))


def _overlap_save_local(x_seg, halo, code_fft_c, dopplers, fs: float,
                        seg_index: int) -> torch.Tensor:
    """One segment's [D, N] grid: the segment extended by the halo, wiped
    at absolute sample times (the carrier stays coherent across
    segments), correlated by cuFFT, |corr|^2 of the L valid lags folded
    modulo the code period (K7)."""
    l_seg, n = x_seg.shape[0], halo.shape[0]
    ext = torch.cat([x_seg, halo])                               # [L + N]
    dev = ext.device
    t = ((torch.arange(l_seg + n, dtype=torch.float32, device=dev)
          + float(np.float32(l_seg) * np.float32(seg_index)))
         / float(np.float32(fs)))
    wiped = pcps.pcps_wipe(ext[None], dopplers, t)[0]            # [D, L + N]
    corr = torch.fft.ifft(torch.fft.fft(wiped, dim=-1) * code_fft_c[None],
                          dim=-1)
    return pcps.pcps_window_fold(corr, n)


def _segment_checks(x_seg, code_samples) -> tuple[int, int]:
    n, l_seg = int(code_samples.shape[0]), int(x_seg.shape[0])
    if l_seg < n or l_seg % n:
        raise ValueError(f"need a segment of k*N samples, got {l_seg} "
                         f"(N={n})")
    return n, l_seg


def overlap_save_grid(x, code_samples, dopplers, fs: float) -> torch.Tensor:
    """The unsharded grid of :func:`overlap_save_acq_grid` on one device:
    the whole capture [L] as one segment, its own head as the halo (the
    last window wraps around, as the sharded program's does)."""
    n, l_seg = _segment_checks(x, code_samples)
    return _overlap_save_local(x, x[:n], _code_fft_padded(code_samples,
                                                          l_seg),
                               dopplers, fs, 0)


def _halo(head: torch.Tensor, mesh: ChannelMesh) -> torch.Tensor:
    """The right-hand neighbour's head: rank j receives from j + 1 mod S
    and sends its own to j - 1 mod S.  At one rank its own head, copied
    (no send to itself)."""
    if mesh.world == 1:
        return head.clone()
    _check(mesh, head, "halo exchange")
    halo = torch.empty_like(head)
    r, s = mesh.rank, mesh.world
    ops = [dist.P2POp(dist.isend, head, (r - 1) % s, mesh.group),
           dist.P2POp(dist.irecv, halo, (r + 1) % s, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    collectives["p2p"] += 1
    return halo


def overlap_save_acq_grid(mesh: ChannelMesh, x, code_samples, dopplers,
                          fs: float):
    """Time-sharded long-integration PCPS grid with a halo exchange.

    Args:
      x: this rank's segment [L] complex64 of the [S L] capture (L % N ==
        0), rank i holding samples [i L, (i + 1) L).
      code_samples: [N] float32 sampled +-1 replica (one code period).
      dopplers: [D] float32, whole.

    Returns the [D, N] float32 non-coherent grid on every rank: the sum
    over all S L / N code-period windows of |linear correlation|^2.  Each
    rank correlates its segment extended by the N-sample head of its
    right-hand neighbour, so every window is a true linear correlation
    (the last rank's wraps to rank 0's head); the grids are summed by
    all-reduce.
    """
    n, l_seg = _segment_checks(x, code_samples)
    halo = _halo(x[:n].contiguous(), mesh)
    local = _overlap_save_local(x, halo, _code_fft_padded(code_samples,
                                                          l_seg),
                                dopplers, fs, mesh.rank)
    return _all_reduce(local, mesh)
