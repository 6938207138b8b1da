"""Tracking discriminators (vectorized over channels), PyTorch port of
``gnss_sim_receiver_tpu.ops.discriminators``: the subset of the GPS L1 C/A
and Galileo E1-B (5-tap VEML) chains.

Batched equivalents of the reference's scalar discriminator library
(src/algorithms/tracking/libs/tracking_discriminators.h:46-195).  Inputs
are [C]-shaped tensors (or any common shape); outputs share that shape.
Units follow the reference: PLL errors in radians, FLL in Hz, DLL in chips.
"""

from __future__ import annotations

import math

import torch


def pll_costas(prompt: torch.Tensor) -> torch.Tensor:
    """Costas-loop two-quadrant atan discriminator [rad] — insensitive to
    nav-bit sign flips (reference pll_cloop_two_quadrant_atan)."""
    i = prompt.real
    q = prompt.imag
    return torch.atan2(q * torch.sign(i), torch.abs(i))


def fll_cross_dot(prompt_prev: torch.Tensor, prompt: torch.Tensor,
                  t_sep_s) -> torch.Tensor:
    """Four-quadrant cross/dot frequency discriminator [Hz] between two
    consecutive prompts separated by t_sep_s (reference fll_diff_atan /
    fll_four_quadrant_atan family)."""
    i1, q1 = prompt_prev.real, prompt_prev.imag
    i2, q2 = prompt.real, prompt.imag
    cross = i1 * q2 - i2 * q1
    dot = i1 * i2 + q1 * q2
    return torch.atan2(cross, dot) / (2.0 * math.pi * t_sep_s)


def fll_cross_dot_decision(prompt_prev: torch.Tensor, prompt: torch.Tensor,
                           t_sep_s) -> torch.Tensor:
    """Two-quadrant (decision-directed) cross/dot frequency discriminator
    [Hz] (reference fll_diff_atan with atan): half the pull range of the
    four-quadrant form, but insensitive to a symbol flip BETWEEN the
    prompts, which negates cross and dot together."""
    i1, q1 = prompt_prev.real, prompt_prev.imag
    i2, q2 = prompt.real, prompt.imag
    cross = i1 * q2 - i2 * q1
    dot = i1 * i2 + q1 * q2
    sgn = torch.where(dot >= 0, 1.0, -1.0)
    return torch.atan2(cross * sgn, torch.abs(dot)) / (2.0 * math.pi
                                                       * t_sep_s)


def dll_nc_e_minus_l_normalized(early_mag: torch.Tensor,
                                late_mag: torch.Tensor,
                                spacing_chips: float) -> torch.Tensor:
    """Normalized non-coherent early-minus-late envelope discriminator
    [chips] (reference dll_nc_e_minus_l_normalized with BPSK slope):
    eps = (E-L)/(E+L) * (2-d)/2 — unit slope for an ideal triangle."""
    denom = early_mag + late_mag
    raw = torch.where(denom > 0,
                      (early_mag - late_mag) / torch.clamp(denom, min=1e-20),
                      torch.zeros_like(denom))
    return 0.5 * (2.0 - spacing_chips) * raw


def dll_nc_vemlp_normalized(ve: torch.Tensor, e: torch.Tensor,
                            l: torch.Tensor, vl: torch.Tensor,
                            spacing_chips) -> torch.Tensor:
    """Very-early/early/late/very-late power discriminator [chips] for BOC
    signals (reference dll_nc_vemlp_normalized)."""
    p_early = torch.sqrt(ve * ve + e * e)
    p_late = torch.sqrt(vl * vl + l * l)
    denom = p_early + p_late
    raw = torch.where(denom > 0,
                      (p_early - p_late) / torch.clamp(denom, min=1e-20),
                      torch.zeros_like(denom))
    return 0.5 * spacing_chips * raw
