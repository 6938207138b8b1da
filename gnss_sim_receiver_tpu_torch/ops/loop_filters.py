"""Tracking loop filters (vectorized over channels), PyTorch port of
``gnss_sim_receiver_tpu.ops.loop_filters``.

The filter state is a NamedTuple of [C] float32 tensors; one call advances
every channel.  Kaplan/Hegarty natural-frequency scalings:
  2nd order: w_n = Bn / 0.53   (zeta = 0.707)
  3rd order: w_n = Bn / 0.7845 (a3 = 1.1, b3 = 2.4)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LoopFilterState(NamedTuple):
    vel: torch.Tensor   # [C] first integrator
    acc: torch.Tensor   # [C] second integrator (3rd order only)


def init_state(n_channels: int, device) -> LoopFilterState:
    z = torch.zeros(n_channels, dtype=torch.float32, device=device)
    return LoopFilterState(vel=z, acc=z.clone())


def second_order_step(state: LoopFilterState, error, bn_hz, t_s):
    """One update of a 2nd-order loop: returns (new_state, output)."""
    wn = bn_hz / 0.53
    vel = state.vel + wn * wn * t_s * error
    out = vel + 1.414213562 * wn * error
    return LoopFilterState(vel=vel, acc=state.acc), out


def third_order_step(state: LoopFilterState, error, bn_hz, t_s):
    """One update of a 3rd-order loop (reference pll_3rd order path)."""
    wn = bn_hz / 0.7845
    acc = state.acc + wn * wn * wn * t_s * error
    vel = state.vel + t_s * (acc + 1.1 * wn * wn * error)
    out = vel + 2.4 * wn * error
    return LoopFilterState(vel=vel, acc=acc), out
