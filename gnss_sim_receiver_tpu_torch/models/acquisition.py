"""Batched PCPS acquisition engine, PyTorch port of
``gnss_sim_receiver_tpu.models.acquisition`` (the ``pcps`` variant with the
CFAR statistic, GPS L1 C/A).

Given a window of samples, every searching channel's (Doppler x code delay)
grid is searched in one batch (kernel K3), optionally refined on a narrow
per-channel Doppler grid (kernel K3b, ``make_two_steps``), through
:func:`ops.pcps.pcps_search_two_steps`, and one packed [4, C] buffer comes
back to the host per acquisition.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import resolve_device, upload
from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes


@dataclasses.dataclass
class AcqConf:
    """Reference Acq_Conf (acquisition/libs/acq_conf.h:33-81) subset: the
    CFAR PCPS search with the optional two-step Doppler refinement."""
    fs_in: float = 2_000_000.0
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    doppler_center: float = 0.0
    sampled_ms: int = 1
    max_dwells: int = 1
    pfa: float = 0.01
    make_two_steps: bool = False
    doppler_step2: float = 125.0
    num_doppler_bins_step2: int = 4


@dataclasses.dataclass
class AcqResults:
    """Per-channel acquisition outcome (the Gnss_Synchro Acq_* fields)."""
    detected: np.ndarray            # [C] bool
    test_stat: np.ndarray           # [C] float
    delay_samples: np.ndarray       # [C] float
    doppler_hz: np.ndarray          # [C] float
    threshold: float
    samplestamp: int                # sample index of block start


def code_replicas(conf: AcqConf, prns) -> np.ndarray:
    """[C, N] complex64 conj(FFT(sampled code)) per PRN (the adapter-side
    precompute of the reference), computed on the host in NumPy."""
    n = int(round(conf.fs_in * 1e-3 * conf.sampled_ms))
    codes = np.stack([
        prn_codes.sample_code(prn_codes.gps_l1_ca_code(int(p)), conf.fs_in,
                              constants.GPS_L1_CA_CODE_RATE_CPS, n)
        for p in prns])
    return np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)


class PcpsAcquisitionEngine:
    """Batched PCPS acquisition over a fixed GPS L1 C/A PRN set.
    `device=None` means the CUDA card and raises without one; pass
    device="cpu" for the plain versions of the kernels."""

    def __init__(self, conf: AcqConf, prns, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.prns = [int(p) for p in prns]
        fs = conf.fs_in
        self.fft_size = int(round(fs * 1e-3 * conf.sampled_ms))
        self.code_fft_conj = upload(code_replicas(conf, self.prns),
                                    self.device)
        self.dopplers = upload(pcps.doppler_grid(conf.doppler_max,
                                                 conf.doppler_step,
                                                 conf.doppler_center),
                               self.device)
        self._t = pcps.time_axis(self.fft_size, fs, self.device)
        n_cells = self.fft_size * len(self.dopplers)
        self.threshold = pcps.cfar_threshold(conf.pfa, n_cells,
                                             conf.max_dwells)

    @property
    def n_samples_needed(self) -> int:
        return self.fft_size * self.conf.max_dwells

    def acquire_from(self, x, start: int) -> AcqResults:
        """Acquisition over the capture window that starts near `start`:
        the coarse grid and, with `make_two_steps`, the narrow-grid Doppler
        refinement (pcps_acquisition.cc:698-758) in one fused search with
        one packed pull.  The step-two statistic is folded into the
        detection as max(stat, stat2), both being the same CFAR statistic.

        A host capture (NumPy) has the window [start, start + need) sliced
        on the host and uploaded.  A device-resident capture (a tensor) is
        searched at the window start the JAX engine uses for its device
        path: `start` rounded down to the 128-aligned row grid of `need`
        samples, the row index clamped to [0, len // row - 2] — a slice
        view, no copy."""
        m, n = self.conf.max_dwells, self.fft_size
        need = m * n
        if isinstance(x, torch.Tensor):
            g = -(-need // 128) * 128
            w = len(x) // g
            if w < 2:
                raise ValueError("device capture shorter than one "
                                 "acquisition window pair")
            row = min(max(int(start) // g, 0), w - 2)
            samplestamp = row * g
            x_dwells = x[samplestamp:samplestamp + need].to(self.device)
        else:
            samplestamp = int(start)
            seg = np.asarray(x[start:start + need], np.complex64)
            if len(seg) < need:
                raise ValueError(f"need {need} samples, got {len(seg)}")
            x_dwells = upload(seg, self.device)
        x_dwells = x_dwells.to(torch.complex64).reshape(m, n)
        conf = self.conf
        buf = pcps.pcps_search_two_steps(
            x_dwells, self.code_fft_conj, self.dopplers, self._t,
            two_steps=bool(conf.make_two_steps),
            n_side=int(conf.num_doppler_bins_step2),
            step2=float(conf.doppler_step2)).cpu().numpy()
        stat = np.maximum(buf[0], buf[3]).astype(np.float64)
        return AcqResults(
            detected=stat > self.threshold, test_stat=stat,
            delay_samples=buf[2].astype(np.float64),
            doppler_hz=buf[1].astype(np.float64),
            threshold=self.threshold, samplestamp=samplestamp)
