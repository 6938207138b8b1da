"""C/N0 estimation and lock detection (vectorized over channels), PyTorch
port of ``gnss_sim_receiver_tpu.ops.cn0``.

[C]-shaped moment accumulators are carried through the epoch loop and
folded into estimates every `window` epochs (reference lock_detectors.h:
cn0_m2m4_estimator, carrier_lock_detector).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Cn0AccumState(NamedTuple):
    sum_abs_i: torch.Tensor   # [C] sum |I_p|
    sum_abs_q: torch.Tensor   # [C] sum |Q_p|
    sum_m2: torch.Tensor      # [C] sum |P|^2
    sum_m4: torch.Tensor      # [C] sum |P|^4
    sum_i: torch.Tensor       # [C] sum I (signed, for the lock detector)
    sum_q: torch.Tensor       # [C] sum Q
    count: torch.Tensor       # [C] epochs accumulated


def init_accum(n_channels: int, device) -> Cn0AccumState:
    return Cn0AccumState(*(torch.zeros(n_channels, dtype=torch.float32,
                                       device=device) for _ in range(7)))


def accumulate(acc: Cn0AccumState, prompt: torch.Tensor) -> Cn0AccumState:
    i = prompt.real
    q = prompt.imag
    p2 = i * i + q * q
    return Cn0AccumState(
        sum_abs_i=acc.sum_abs_i + torch.abs(i),
        sum_abs_q=acc.sum_abs_q + torch.abs(q),
        sum_m2=acc.sum_m2 + p2,
        sum_m4=acc.sum_m4 + p2 * p2,
        sum_i=acc.sum_i + i,
        sum_q=acc.sum_q + q,
        count=acc.count + 1.0,
    )


def cn0_m2m4_estimate(acc: Cn0AccumState, t_int_s) -> torch.Tensor:
    """Second/fourth-moment C/N0 estimate [dB-Hz] (reference
    cn0_m2m4_estimator)."""
    n = torch.clamp(acc.count, min=1.0)
    m2 = acc.sum_m2 / n
    m4 = acc.sum_m4 / n
    pd2 = torch.clamp(2.0 * m2 * m2 - m4, min=0.0)
    p_d = torch.sqrt(pd2)
    p_n = torch.clamp(m2 - p_d, min=1e-20)
    return 10.0 * torch.log10(torch.clamp(p_d / p_n / t_int_s, min=1e-10))


def carrier_lock_value(acc: Cn0AccumState,
                       rectify: bool = False) -> torch.Tensor:
    """Carrier lock test ~= cos(2 phase_err): NBD/NBP with the coherent
    sums ((sum I)^2 -/+ (sum Q)^2), exactly the reference
    carrier_lock_detector (lock_detectors.cc:133-148).

    rectify=True uses the per-epoch |I| / |Q| sums instead: the form for
    signals whose data is zero-mean over every window (BeiDou D2's 500 bps
    symbols with no NH code, GLONASS GNAV's meander), where the coherent
    sum I goes to zero and the classic test reads -1 in perfect lock."""
    if rectify:
        i2 = acc.sum_abs_i * acc.sum_abs_i
        q2 = acc.sum_abs_q * acc.sum_abs_q
    else:
        i2 = acc.sum_i * acc.sum_i
        q2 = acc.sum_q * acc.sum_q
    return (i2 - q2) / torch.clamp(i2 + q2, min=1e-20)


def update_lock_counters(fail_count, locked, max_fail):
    """Hysteretic lock management (dll_pll_veml_tracking.cc:972-1029)."""
    count = torch.where(locked, torch.clamp(fail_count - 1, min=0),
                        fail_count + 1)
    lost = count > max_fail
    return count, lost
