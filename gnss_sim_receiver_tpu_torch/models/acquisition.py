"""Batched PCPS acquisition engine, PyTorch port of
``gnss_sim_receiver_tpu.models.acquisition``: the ``pcps`` variant with the
CFAR statistic (GPS L1 C/A, Galileo E1) and the Galileo E1 sign-recovery
variants ``cccwsr`` and ``8ms``.

Given a window of samples, every searching channel's (Doppler x code delay)
grid is searched in one batch and one packed [4, C] buffer comes back to the
host per acquisition:

- ``pcps``: kernel K3, optionally refined on a narrow per-channel Doppler
  grid (kernel K3b, ``make_two_steps``), through
  :func:`ops.pcps.pcps_search_two_steps`;
- ``cccwsr`` / ``8ms``: two correlation planes per cell combined under both
  sign hypotheses by kernel K4a, through :func:`ops.pcps.pcps_search_dual`
  (acquisition.py:_acquire_dual: one grid, no second step).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import resolve_device, upload
from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes

VARIANTS = ("pcps", "cccwsr", "8ms")


@dataclasses.dataclass
class AcqConf:
    """Reference Acq_Conf (acquisition/libs/acq_conf.h:33-81) subset: the
    CFAR PCPS search with the optional two-step Doppler refinement, and the
    engine variant ("pcps", "cccwsr": coherent data + pilot combining with
    sign recovery, pcps_cccwsr_acquisition_cc; "8ms": two code periods per
    dwell under both symbol signs, galileo_pcps_8ms_acquisition_cc)."""
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
    variant: str = "pcps"

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise NotImplementedError(
                f"acquisition variant {self.variant!r} is not ported")


@dataclasses.dataclass
class AcqResults:
    """Per-channel acquisition outcome (the Gnss_Synchro Acq_* fields)."""
    detected: np.ndarray            # [C] bool
    test_stat: np.ndarray           # [C] float
    delay_samples: np.ndarray       # [C] float
    doppler_hz: np.ndarray          # [C] float
    threshold: float
    samplestamp: int                # sample index of block start


def code_replicas(conf: AcqConf, prns, code_provider=None,
                  sc_rate: float | None = None) -> np.ndarray:
    """[C, N] complex64 conj(FFT(sampled code)) per PRN (the adapter-side
    precompute of the reference), computed on the host in NumPy.
    `code_provider(prn)` gives the +-1 sub-chip table at `sc_rate` (default
    GPS L1 C/A)."""
    code_provider = code_provider or prn_codes.gps_l1_ca_code
    sc_rate = sc_rate or constants.GPS_L1_CA_CODE_RATE_CPS
    n = int(round(conf.fs_in * 1e-3 * conf.sampled_ms))
    codes = np.stack([
        prn_codes.sample_code(np.asarray(code_provider(int(p)), np.float32),
                              conf.fs_in, sc_rate, n)
        for p in prns])
    return np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)


class PcpsAcquisitionEngine:
    """Batched PCPS acquisition over a fixed PRN set.  Signal-agnostic: pass
    code_provider(prn) -> +-1 sub-chip table and sc_rate for Galileo E1
    (defaults: GPS L1 C/A); `code_provider2` is the second replica family of
    the cccwsr variant.  `device=None` means the CUDA card and raises
    without one; pass device="cpu" for the plain versions of the kernels."""

    def __init__(self, conf: AcqConf, prns, code_provider=None,
                 sc_rate: float | None = None, code_provider2=None,
                 device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.prns = [int(p) for p in prns]
        fs = conf.fs_in
        self.fft_size = int(round(fs * 1e-3 * conf.sampled_ms))
        self.code_fft_conj = upload(
            code_replicas(conf, self.prns, code_provider, sc_rate),
            self.device)
        # the second replica family (cccwsr: data + pilot)
        self.code2_fft_conj = None
        if code_provider2 is not None and conf.variant == "cccwsr":
            self.code2_fft_conj = upload(
                code_replicas(conf, self.prns, code_provider2, sc_rate),
                self.device)
        self.dopplers = upload(pcps.doppler_grid(conf.doppler_max,
                                                 conf.doppler_step,
                                                 conf.doppler_center),
                               self.device)
        dwell = self.fft_size * (2 if conf.variant == "8ms" else 1)
        self._t = pcps.time_axis(dwell, fs, self.device)
        n_cells = self.fft_size * len(self.dopplers)
        if conf.variant == "pcps":
            self.threshold = pcps.cfar_threshold(conf.pfa, n_cells,
                                                 conf.max_dwells)
        else:
            # every cell sums TWO correlations per dwell, and the sign
            # recovery takes a max over two hypotheses per cell: the
            # per-cell Pfa is union-bounded at pfa/2 (acquisition.py:368-377)
            self.threshold = pcps.cfar_threshold(conf.pfa / 2.0, n_cells,
                                                 2 * conf.max_dwells)

    @property
    def n_samples_needed(self) -> int:
        if self.conf.variant == "8ms":
            return 2 * self.fft_size * self.conf.max_dwells
        return self.fft_size * self.conf.max_dwells

    def acquire_from(self, x, start: int) -> AcqResults:
        """Acquisition over the capture window that starts near `start`, in
        one search with one packed pull.

        pcps: the coarse grid and, with `make_two_steps`, the narrow-grid
        Doppler refinement (pcps_acquisition.cc:698-758), the step-two
        statistic folded into the detection as max(stat, stat2).  A host
        capture (NumPy) has the window [start, start + need) sliced on the
        host and uploaded.  A device-resident capture (a tensor) is
        searched at the window start the JAX engine uses for its device
        path: `start` rounded down to the 128-aligned row grid of `need`
        samples, the row index clamped to [0, len // row - 2] — a slice
        view, no copy.

        cccwsr / 8ms: the window [start, start + need) exactly, as the JAX
        engine's `acquire` on a slice; a device capture is sliced on the
        device (a view, no host round trip)."""
        conf = self.conf
        m = conf.max_dwells
        need = self.n_samples_needed
        if conf.variant != "pcps":
            samplestamp = int(start)
            if isinstance(x, torch.Tensor):
                seg = x[samplestamp:samplestamp + need].to(self.device)
            else:
                seg = upload(np.asarray(x[start:start + need], np.complex64),
                             self.device)
            if len(seg) < need:
                raise ValueError(f"need {need} samples, got {len(seg)}")
            x_dwells = seg.to(torch.complex64).reshape(m, need // m)
            buf = pcps.pcps_search_dual(
                x_dwells, self.code_fft_conj, self.code2_fft_conj
                if self.code2_fft_conj is not None else self.code_fft_conj,
                self.dopplers, self._t, conf.variant).cpu().numpy()
            delay = buf[2].astype(np.float64)
            if conf.variant == "8ms":
                delay = np.mod(delay, self.fft_size)
            return self._results(buf[0].astype(np.float64), delay, buf[1],
                                 samplestamp)
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
        x_dwells = x_dwells.to(torch.complex64).reshape(m, self.fft_size)
        buf = pcps.pcps_search_two_steps(
            x_dwells, self.code_fft_conj, self.dopplers, self._t,
            two_steps=bool(conf.make_two_steps),
            n_side=int(conf.num_doppler_bins_step2),
            step2=float(conf.doppler_step2)).cpu().numpy()
        stat = np.maximum(buf[0], buf[3]).astype(np.float64)
        return self._results(stat, buf[2].astype(np.float64), buf[1],
                             samplestamp)

    def _results(self, stat, delay, doppler_hz, samplestamp) -> AcqResults:
        return AcqResults(
            detected=stat > self.threshold, test_stat=stat,
            delay_samples=delay, doppler_hz=doppler_hz.astype(np.float64),
            threshold=self.threshold, samplestamp=samplestamp)
