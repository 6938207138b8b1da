"""Acquisition detection-performance harness (ROC / Pd-Pfa sweeps).

PyTorch port of ``gnss_sim_receiver_tpu.models.acq_performance``, the
batched counterpart of the reference's acq_performance_test
(src/tests/unit-tests/signal-processing-blocks/acquisition/
acq_performance_test.cc:283-376): the PCPS detector's false-alarm rate on
noise and its detection probability versus C/N0, over many independent
trials at once.

The trials are the PCPS search's channel axis.  T trials of M dwells are
laid out dwell-major, [M, T, N]: the wipeoff kernel (K3) wipes them as
M * T dwells over the [D] Doppler grid, one cuFFT forward, the product with
the replica's conjugate spectrum into one cuFFT inverse, and the
correlations are K3's [M, C, D, N] with the T trials as its C channels, no
copy.  K3's peak kernel (the CFAR statistic) or K3c (the first-vs-second-
peak ratio) then reads them once.  The noise is drawn on the device from an
explicit ``torch.Generator``: ``jax.random``'s bits cannot be reproduced,
so the sweep agrees with the JAX one statistically, not draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch import constants
from gnss_sim_receiver_tpu_torch.device import resolve_device, upload
from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes


def trial_signal(gen: torch.Generator, code_sig: torch.Tensor, amp: float,
                 dop_true_hz: float, delay_samples: int, n: int,
                 n_trials: int, fs: float, m: int) -> torch.Tensor:
    """[M, T, N] complex64 trials, dwell-major: unit-power complex Gaussian
    noise from `gen` on `code_sig`'s device plus `amp` times the replica,
    the code rolled by `delay_samples` at `dop_true_hz` (the same in every
    trial; 0 amplitude for noise-only trials)."""
    dev = code_sig.device
    re = torch.randn((m, n_trials, n), generator=gen, device=dev)
    im = torch.randn((m, n_trials, n), generator=gen, device=dev)
    noise = torch.complex(re, im) * float(np.sqrt(0.5))
    t = (torch.arange(m * n, dtype=torch.float32, device=dev)
         / float(fs)).reshape(m, n)
    phase = 2.0 * np.pi * float(dop_true_hz) * t
    sig = (torch.roll(code_sig, int(delay_samples))[None, :]
           * torch.complex(torch.cos(phase), torch.sin(phase)))
    return noise + float(amp) * sig[:, None, :]


def trial_stats_of(x: torch.Tensor, code_fft_conj: torch.Tensor,
                   dopplers: torch.Tensor, fs: float, use_cfar: bool,
                   spc: int) -> torch.Tensor:
    """[T] float32 detection statistics of the [M, T, N] trials `x` against
    one replica, `code_fft_conj` [1, N]: the trials as the channel axis of
    one PCPS search (K3's wipeoff, cuFFT, then K3's peak kernel with
    `use_cfar`, else K3c with a `spc`-sample exclusion zone)."""
    m, n_trials, n = x.shape
    d = dopplers.shape[0]
    wiped = pcps.pcps_wipe(x.reshape(m * n_trials, n), dopplers,
                           pcps.time_axis(n, fs, x.device))   # [M T, D, N]
    spec = torch.fft.fft(wiped, dim=-1)
    del wiped
    spec.mul_(code_fft_conj[0])
    corr = torch.fft.ifft(spec, dim=-1).reshape(m, n_trials, d, n)
    del spec
    stat, _, _ = pcps.detect(corr, m, use_cfar, spc)
    return stat


def _trial_stats(gen: torch.Generator, code_sig: torch.Tensor,
                 code_fft_conj: torch.Tensor, dopplers: torch.Tensor,
                 amp: float, dop_true_hz: float, delay_samples: int, n: int,
                 n_trials: int, fs: float, use_cfar: bool, spc: int,
                 m: int) -> torch.Tensor:
    """[n_trials] detection statistics for the signal at amplitude `amp`
    (0: noise-only trials), the true Doppler and delay fixed; the tensors'
    device is the search's."""
    x = trial_signal(gen, code_sig, amp, dop_true_hz, delay_samples, n,
                     n_trials, fs, m)
    return trial_stats_of(x, code_fft_conj, dopplers, fs, use_cfar, spc)


def sweep(prn: int = 1, fs: float = 2_000_000.0,
          cn0_db_hz=(38.0, 42.0, 46.0), pfa: float = 0.01,
          n_trials: int = 256, doppler_max=5000.0, doppler_step=250.0,
          max_dwells: int = 1, seed: int = 0, dop_true_hz: float = 1375.0,
          delay_samples: int = 700, device=None):
    """Measured (pfa_hat, {cn0: pd_hat}, threshold) for the GPS L1 C/A
    PCPS detector under the CFAR statistic.  Noise power is unit per
    complex sample; the amplitude for a C/N0 follows the simulator's
    convention amp = sqrt(2 C/N0 / fs).  `device=None` means the CUDA card;
    the noise comes from a generator on the device seeded with `seed`."""
    dev = resolve_device(device)
    n = int(round(fs * 1e-3))
    code = prn_codes.sample_code(prn_codes.gps_l1_ca_code(prn), fs,
                                 constants.GPS_L1_CA_CODE_RATE_CPS, n)
    cfc = upload(np.conj(np.fft.fft(code))[None].astype(np.complex64), dev)
    dops = upload(pcps.doppler_grid(doppler_max, doppler_step), dev)
    thr = pcps.cfar_threshold(pfa, n * len(dops), max_dwells)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    code_t = upload(code.astype(np.float32), dev)

    def rate(amp: float) -> float:
        s = _trial_stats(gen, code_t, cfc, dops, amp, dop_true_hz,
                         delay_samples, n, n_trials, float(fs), True, 2,
                         max_dwells)
        return float((s > thr).float().mean())

    pfa_hat = rate(0.0)
    pd = {float(cn0): rate(float(np.sqrt(2.0 * 10.0 ** (cn0 / 10.0) / fs)))
          for cn0 in cn0_db_hz}
    return pfa_hat, pd, float(thr)
