"""Batched PCPS acquisition engine, PyTorch port of
``gnss_sim_receiver_tpu.models.acquisition``: the ``pcps`` variant with the
CFAR statistic (GPS L1 C/A, GPS L5, Galileo E1, Galileo E5a), the Galileo
E1 sign-recovery variants ``cccwsr`` and ``8ms``, the Galileo E5a
non-coherent I/Q variant ``iq_caf`` and the GPS L1 C/A variants
``quicksync``, ``tong`` and ``fine_doppler``.

Given a window of samples, every searching channel's (Doppler x code delay)
grid is searched in one batch and one packed [4, C] buffer comes back to the
host per acquisition:

- ``pcps``: kernel K3, optionally refined on a narrow per-channel Doppler
  grid (kernel K3b, ``make_two_steps``), through
  :func:`ops.pcps.pcps_search_two_steps`;
- ``cccwsr`` / ``8ms``: two correlation planes per cell combined under both
  sign hypotheses by kernel K4a, through :func:`ops.pcps.pcps_search_dual`
  (acquisition.py:_acquire_dual: one grid, no second step);
- ``iq_caf``: the E5a-I and E5a-Q correlations of every cell summed
  non-coherently and smoothed along Doppler by the CAF boxcar, kernel K4c,
  through :func:`ops.pcps.pcps_search_iq_caf` (the same `_acquire_dual`
  branch: one grid, no second step);
- ``quicksync``: the dwell folded by `quicksync_fold` before the FFT and
  the fold ambiguity resolved on the card (kernel K4b,
  :func:`ops.pcps.pcps_search_quicksync`);
- ``fine_doppler``: the coarse search, then narrow per-channel grids with
  the step divided by 4 each iteration (K3, K3b,
  :func:`ops.pcps.pcps_search_fine_doppler`);
- ``tong``: the Tong sequential detector over `tong_max_dwells` successive
  single-dwell searches (K3, :func:`ops.pcps.pcps_search_dwells`), its
  counters run on the host after the one pull.

``acquire(x, samplestamp)`` searches the first window of `x` exactly (the
acquisition-only resampler's decimated window); ``acquire_assisted(x,
start, centers_hz)`` searches each channel's +-250 Hz grid around its own
predicted Doppler in one dwell (K3b on a [C, 9] table, K3's peak,
:func:`ops.pcps.pcps_search_assisted`).

With ``use_cfar_algorithm=False`` every variant but QuickSync (which keeps
the CFAR statistic, as the JAX engine does) takes the first-vs-second-peak
ratio of its coarse grid (kernel K3c, in the grid form of the search); the
narrow grids of the two-step and Fine Doppler searches keep the CFAR
statistic, which then refines the Doppler only.  With ``pfa <= 0`` the
threshold is ``threshold``, on every variant.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import resolve_device, upload
from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes

VARIANTS = ("pcps", "cccwsr", "8ms", "iq_caf", "quicksync", "tong",
            "fine_doppler")


@dataclasses.dataclass
class AcqConf:
    """Reference Acq_Conf (acquisition/libs/acq_conf.h:33-81) subset: the
    PCPS search (the CFAR statistic, or the first-vs-second-peak ratio
    against a fixed threshold) with the optional two-step Doppler
    refinement, and the engine variant ("pcps"; "cccwsr": coherent data +
    pilot combining with sign recovery, pcps_cccwsr_acquisition_cc; "8ms":
    two code periods per dwell under both symbol signs,
    galileo_pcps_8ms_acquisition_cc;
    "iq_caf": E5a non-coherent I/Q with CAF Doppler smoothing,
    galileo_e5a_noncoherent_iq_acquisition_caf_cc; "quicksync": folded
    FFT, pcps_quicksync_acquisition_cc; "tong": the Tong sequential
    detector, pcps_tong_acquisition_cc; "fine_doppler": iterative Doppler
    zoom, pcps_acquisition_fine_doppler_cc)."""
    fs_in: float = 2_000_000.0
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    doppler_center: float = 0.0
    sampled_ms: int = 1
    max_dwells: int = 1
    pfa: float = 0.01
    threshold: float = 0.0          # used when pfa <= 0
    use_cfar_algorithm: bool = True
    make_two_steps: bool = False
    doppler_step2: float = 125.0
    num_doppler_bins_step2: int = 4
    variant: str = "pcps"
    caf_bins: int = 0                # iq_caf: Doppler boxcar half-width
    # double the FFT so one full clean code period always exists even when
    # a symbol edge falls inside the dwell (pcps_acquisition.cc:607,656;
    # QuickSync keeps its one code period)
    bit_transition_flag: bool = False
    fine_doppler_iters: int = 3      # zoom iterations (step /4 each)
    quicksync_fold: int = 4          # QuickSync folding factor
    tong_init: int = 1               # Tong counter init (tong_init_val)
    tong_max: int = 2                # declare at this count (tong_max_val)
    tong_max_dwells: int = 10        # dismissal dwell cap (tong_max_dwells)

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


def sampled_codes(conf: AcqConf, prns, code_provider=None,
                  sc_rate: float | None = None) -> np.ndarray:
    """[C, N] float32 +-1 codes sampled at fs_in over one coherent
    integration, per PRN, on the host.  `code_provider(prn)` gives the +-1
    sub-chip table at `sc_rate` (default GPS L1 C/A)."""
    code_provider = code_provider or prn_codes.gps_l1_ca_code
    sc_rate = sc_rate or constants.GPS_L1_CA_CODE_RATE_CPS
    n = int(round(conf.fs_in * 1e-3 * conf.sampled_ms))
    return np.stack([
        prn_codes.sample_code(np.asarray(code_provider(int(p)), np.float32),
                              conf.fs_in, sc_rate, n)
        for p in prns])


def replica_fft(codes: np.ndarray) -> np.ndarray:
    """[C, N] complex64 conj(FFT(code)) of sampled codes, on the host."""
    return np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)


def code_replicas(conf: AcqConf, prns, code_provider=None,
                  sc_rate: float | None = None) -> np.ndarray:
    """[C, N] complex64 conj(FFT(sampled code)) per PRN (the adapter-side
    precompute of the reference), computed on the host in NumPy."""
    return replica_fft(sampled_codes(conf, prns, code_provider, sc_rate))


class PcpsAcquisitionEngine:
    """Batched PCPS acquisition over a fixed PRN set.  Signal-agnostic: pass
    code_provider(prn) -> +-1 sub-chip table and sc_rate for the other
    signals (defaults: GPS L1 C/A); `code_provider2` is the second replica
    family of the cccwsr (E1-C pilot) and iq_caf (E5a-Q) variants.
    `device=None` means the CUDA card and raises without one; pass
    device="cpu" for the plain versions of the kernels."""

    def __init__(self, conf: AcqConf, prns, code_provider=None,
                 sc_rate: float | None = None, code_provider2=None,
                 device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.prns = [int(p) for p in prns]
        fs = conf.fs_in
        self.n_coherent = int(round(fs * 1e-3 * conf.sampled_ms))
        # the first-vs-second-peak statistic's exclusion zone, +-1 chip
        self.samples_per_chip = max(1, int(round(
            fs / (sc_rate or constants.GPS_L1_CA_CODE_RATE_CPS))))
        # bit-transition mode: one code period + zero padding, so each lag
        # correlates N samples out of the 2N buffer
        self.fft_size = (2 * self.n_coherent if conf.bit_transition_flag
                         else self.n_coherent)
        codes = sampled_codes(conf, self.prns, code_provider, sc_rate)
        self.code_fft_conj = upload(replica_fft(self._padded(codes)),
                                    self.device)
        if conf.variant == "quicksync":
            # the time-domain codes (the resolve) and the folded replica
            self.codes_time = upload(codes, self.device)
            self.code_fold_fft_conj = upload(
                pcps.fold_codes(codes, int(conf.quicksync_fold)),
                self.device)
        # the second replica family (cccwsr: data + pilot; iq_caf: E5a-I +
        # E5a-Q)
        self.code2_fft_conj = None
        if code_provider2 is not None and conf.variant in ("cccwsr",
                                                           "iq_caf"):
            self.code2_fft_conj = upload(replica_fft(self._padded(
                sampled_codes(conf, self.prns, code_provider2, sc_rate))),
                self.device)
        self.dopplers = upload(pcps.doppler_grid(conf.doppler_max,
                                                 conf.doppler_step,
                                                 conf.doppler_center),
                               self.device)
        dwell = self.fft_size * (2 if conf.variant == "8ms" else 1)
        self._t = pcps.time_axis(dwell, fs, self.device)
        n_cells = self.fft_size * len(self.dopplers)
        if conf.pfa <= 0:
            self.threshold = conf.threshold
        elif conf.variant == "quicksync":
            # the Gamma-inverse threshold sized for the folded cell count
            # of one code period
            self.threshold = pcps.cfar_threshold(
                conf.pfa, (self.n_coherent // int(conf.quicksync_fold))
                * len(self.dopplers), conf.max_dwells)
        elif conf.variant == "iq_caf":
            # every cell sums TWO correlations per dwell (the I and Q
            # planes); no sign hypotheses, so the Pfa is not split
            self.threshold = pcps.cfar_threshold(conf.pfa, n_cells,
                                                 2 * conf.max_dwells)
        elif conf.variant not in ("cccwsr", "8ms"):
            self.threshold = pcps.cfar_threshold(conf.pfa, n_cells,
                                                 conf.max_dwells)
        else:
            # every cell sums TWO correlations per dwell, and the sign
            # recovery takes a max over two hypotheses per cell: the
            # per-cell Pfa is union-bounded at pfa/2 (acquisition.py:368-377)
            self.threshold = pcps.cfar_threshold(conf.pfa / 2.0, n_cells,
                                                 2 * conf.max_dwells)

    def _padded(self, codes: np.ndarray) -> np.ndarray:
        """The sampled codes, zero-padded to the FFT size."""
        if self.fft_size == codes.shape[1]:
            return codes
        return np.concatenate([codes, np.zeros_like(codes)], axis=-1)

    @property
    def n_samples_needed(self) -> int:
        if self.conf.variant == "tong":
            return self.fft_size * self.conf.tong_max_dwells
        if self.conf.variant == "8ms":
            return 2 * self.fft_size * self.conf.max_dwells
        return self.fft_size * self.conf.max_dwells

    def acquire_from(self, x, start: int) -> AcqResults:
        """Acquisition over the capture window that starts near `start`,
        with one packed pull.

        pcps: the coarse grid and, with `make_two_steps`, the narrow-grid
        Doppler refinement (pcps_acquisition.cc:698-758), the step-two
        statistic folded into the detection as max(stat, stat2) under the
        CFAR statistic (with the first-vs-second-peak statistic the step
        refines the Doppler only).  A host
        capture (NumPy) has the window [start, start + need) sliced on the
        host and uploaded.  A device-resident capture (a tensor) is
        searched at the window start the JAX engine uses for its device
        path: `start` rounded down to the 128-aligned row grid of `need`
        samples, the row index clamped to [0, len // row - 2] — a slice
        view, no copy.

        Every other variant: the window [start, start + need) exactly, as
        the JAX engine's `acquire` on a slice; a device capture is sliced on
        the device (a view, no host round trip)."""
        start = int(start)
        if self.conf.variant != "pcps":
            return self._acquire_variant(x, start)
        if isinstance(x, torch.Tensor):
            g = -(-self.n_samples_needed // 128) * 128
            w = len(x) // g
            if w < 2:
                raise ValueError("device capture shorter than one "
                                 "acquisition window pair")
            start = min(max(start // g, 0), w - 2) * g
        return self.acquire(x[start:], start)

    def acquire(self, x, samplestamp: int = 0) -> AcqResults:
        """Search every channel's grid over the first n_samples_needed
        samples of `x` exactly (acquisition.py:acquire; no row rounding):
        the acquisition-only resampler's decimated window, stamped
        `samplestamp`."""
        conf = self.conf
        if conf.variant != "pcps":
            return self._acquire_variant(x, 0, int(samplestamp))
        x_dwells = self._window(x, 0, self.n_samples_needed).reshape(
            conf.max_dwells, self.fft_size)
        buf = pcps.pcps_search_two_steps(
            x_dwells, self.code_fft_conj, self.dopplers, self._t,
            two_steps=bool(conf.make_two_steps),
            n_side=int(conf.num_doppler_bins_step2),
            step2=float(conf.doppler_step2),
            **self._statistic()).cpu().numpy()
        return self._finish(buf, int(samplestamp))

    def acquire_assisted(self, x, start: int, centers_hz,
                         span_hz: float = 250.0,
                         step_hz: float = 62.5) -> AcqResults:
        """Doppler-assisted acquisition (acquisition.py:acquire_assisted):
        each channel searches a +-span_hz grid step_hz apart around its own
        predicted Doppler (the other band's lock scaled by the carrier
        ratio) over the window x[start : start + need] exactly, one K3b
        wipe on the [C, 2 n_side + 1] table, cuFFT and K3's peak.  The
        table is formed in float64 and rounded to float32, the threshold
        sized for the narrow grid's cells."""
        conf = self.conf
        m, n = conf.max_dwells, self.fft_size
        x_dwells = self._window(x, int(start), m * n).reshape(m, n)
        n_side = max(1, int(round(span_hz / step_hz)))
        offsets = (np.arange(2 * n_side + 1) - n_side) * step_hz
        dops = (np.asarray(centers_hz, np.float64)[:, None]
                + offsets[None, :]).astype(np.float32)
        buf = pcps.pcps_search_assisted(
            x_dwells, self.code_fft_conj, upload(dops, self.device),
            self._t).cpu().numpy()
        thr = (pcps.cfar_threshold(conf.pfa, n * (2 * n_side + 1),
                                   conf.max_dwells)
               if conf.pfa > 0 else conf.threshold)
        stat = buf[0].astype(np.float64)
        delay = buf[2].astype(np.float64)
        if conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)
        return AcqResults(
            detected=stat > thr, test_stat=stat, delay_samples=delay,
            doppler_hz=buf[1].astype(np.float64), threshold=thr,
            samplestamp=int(start))

    def _statistic(self) -> dict:
        """The searches' statistic arguments: CFAR or first-vs-second."""
        return dict(use_cfar=bool(self.conf.use_cfar_algorithm),
                    samples_per_chip=self.samples_per_chip)

    def _finish(self, buf: np.ndarray, samplestamp: int) -> AcqResults:
        """The detections of a packed [4, C] buffer: the step-two or last
        zoom statistic (CFAR) folded in only under the CFAR statistic
        (acquisition.py:_finish_fused; the two statistics are not
        comparable), the delay modulo one code period where the dwell
        holds two (the peak repeats at +N)."""
        conf = self.conf
        stat = (np.maximum(buf[0], buf[3]) if conf.use_cfar_algorithm
                else buf[0]).astype(np.float64)
        delay = buf[2].astype(np.float64)
        if conf.variant == "8ms" or conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)
        return self._results(stat, delay, buf[1], samplestamp)

    def _window(self, x, start: int, need: int) -> torch.Tensor:
        """The capture's samples [start, start + need) on the engine's
        device: a view of a tensor, or the host slice uploaded."""
        if isinstance(x, torch.Tensor):
            seg = x[start:start + need].to(self.device)
        else:
            seg = upload(np.asarray(x[start:start + need], np.complex64),
                         self.device)
        if len(seg) < need:
            raise ValueError(f"need {need} samples, got {len(seg)}")
        return seg.to(torch.complex64)

    def _acquire_variant(self, x, start: int,
                         samplestamp: int | None = None) -> AcqResults:
        """The variants' searches on the window [start, start + need),
        stamped `samplestamp` (default `start`)."""
        conf = self.conf
        if samplestamp is not None:
            res = self._acquire_variant(x, start)
            return dataclasses.replace(res, samplestamp=int(samplestamp))
        m, n = conf.max_dwells, self.fft_size
        seg = self._window(x, start, self.n_samples_needed)
        if conf.variant == "tong":
            return self._tong(seg.reshape(conf.tong_max_dwells, n), start)
        if conf.variant == "quicksync":
            # one code period per dwell, whatever bit_transition_flag says
            # (acquisition.py:468), under the CFAR statistic
            nc = self.n_coherent
            buf = pcps.pcps_search_quicksync(
                seg[:m * nc].reshape(m, nc), self.codes_time,
                self.code_fold_fft_conj, self.dopplers, self._t[:nc],
                int(conf.quicksync_fold)).cpu().numpy()
            return self._results(buf[0].astype(np.float64),
                                 buf[2].astype(np.float64), buf[1], start)
        if conf.variant == "fine_doppler":
            buf = pcps.pcps_search_fine_doppler(
                seg.reshape(m, n), self.code_fft_conj, self.dopplers,
                self._t, conf.doppler_step / 2.0,
                int(conf.fine_doppler_iters), **self._statistic())
        else:
            code2 = (self.code2_fft_conj if self.code2_fft_conj is not None
                     else self.code_fft_conj)
            if conf.variant == "iq_caf":
                buf = pcps.pcps_search_iq_caf(
                    seg.reshape(m, n), self.code_fft_conj, code2,
                    self.dopplers, self._t, int(conf.caf_bins),
                    **self._statistic())
            else:
                buf = pcps.pcps_search_dual(
                    seg.reshape(m, -1), self.code_fft_conj, code2,
                    self.dopplers, self._t, conf.variant,
                    **self._statistic())
        return self._finish(buf.cpu().numpy(), start)

    def _tong(self, x_dwells: torch.Tensor, start: int) -> AcqResults:
        """Tong sequential detector (acquisition.py:_acquire_tong): per
        channel a counter starts at tong_init; each dwell above the
        threshold adds 1, each below subtracts 1; detection at tong_max,
        dismissal at 0 or after the last dwell.  Every dwell's search runs
        on the card before the one pull; the counters then run on the host
        in the JAX engine's order (once no channel is alive the later
        dwells change nothing)."""
        conf = self.conf
        c = len(self.prns)
        buf = pcps.pcps_search_dwells(x_dwells, self.code_fft_conj,
                                      self.dopplers, self._t,
                                      **self._statistic()).cpu().numpy()
        k_counter = np.full(c, conf.tong_init, np.int32)
        alive = np.ones(c, bool)
        detected = np.zeros(c, bool)
        best = dict(stat=np.zeros(c), delay=np.zeros(c), dop=np.zeros(c))
        for d in range(x_dwells.shape[0]):
            if not alive.any():
                break
            stat = buf[0, d].astype(np.float64)
            up = stat > self.threshold
            k_counter = np.where(alive & up, k_counter + 1,
                                 np.where(alive, k_counter - 1, k_counter))
            better = alive & (stat > best["stat"])
            best["stat"] = np.where(better, stat, best["stat"])
            best["delay"] = np.where(better, buf[2, d], best["delay"])
            best["dop"] = np.where(better, buf[1, d], best["dop"])
            newly = alive & (k_counter >= conf.tong_max)
            detected |= newly
            alive &= ~newly & (k_counter > 0)
        delay = best["delay"].astype(np.float64)
        if conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)   # the peak repeats at +N
        return AcqResults(
            detected=detected, test_stat=best["stat"], delay_samples=delay,
            doppler_hz=best["dop"].astype(np.float64),
            threshold=self.threshold, samplestamp=int(start))

    def _results(self, stat, delay, doppler_hz, samplestamp) -> AcqResults:
        return AcqResults(
            detected=stat > self.threshold, test_stat=stat,
            delay_samples=delay, doppler_hz=doppler_hz.astype(np.float64),
            threshold=self.threshold, samplestamp=samplestamp)
