"""Carry tracking state and replica tables across as NumPy arrays.

A :class:`~gnss_sim_receiver_tpu_torch.models.tracking.TrackState` travels
as a flat dict of NumPy arrays, nested loop-filter and C/N0 accumulator
fields under dotted keys (``"dll.vel"``, ``"cn0_acc.sum_m2"``), which is the
layout of the JAX package's TrackState too; the acquisition replica tables
(conj code FFTs and Doppler bins) travel as a dict of arrays.  Feeding the
same arrays to the JAX functions and to the port makes their state and
tables identical, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.models.tracking import TrackState
from gnss_sim_receiver_tpu_torch.ops import cn0 as cn0_ops
from gnss_sim_receiver_tpu_torch.ops import loop_filters as lf

_NESTED = {"dll": lf.LoopFilterState, "pll": lf.LoopFilterState,
           "cn0_acc": cn0_ops.Cn0AccumState}


def _to_tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def track_state_from_numpy(arrays: dict, device) -> TrackState:
    """TrackState on `device` from a flat dict of arrays (dotted keys)."""
    fields = {}
    for name in TrackState._fields:
        cls = _NESTED.get(name)
        if cls is None:
            fields[name] = _to_tensor(arrays[name], device)
        else:
            fields[name] = cls(*(_to_tensor(arrays[f"{name}.{sub}"], device)
                                 for sub in cls._fields))
    return TrackState(**fields)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def track_state_to_numpy(state) -> dict:
    """Flat dict of NumPy arrays (dotted keys) from a TrackState, or from
    any NamedTuple of the same layout whose leaves convert to arrays (the
    JAX package's TrackState)."""
    out = {}
    for name in TrackState._fields:
        value = getattr(state, name)
        if name in _NESTED:
            for sub in _NESTED[name]._fields:
                out[f"{name}.{sub}"] = _to_numpy(getattr(value, sub))
        else:
            out[name] = _to_numpy(value)
    return out


def acq_tables_from_numpy(arrays: dict, device) -> dict:
    """Acquisition replica tables on `device`: ``code_fft_conj`` [C, N]
    complex64 and ``dopplers`` [D] float32."""
    return {"code_fft_conj": _to_tensor(
                np.asarray(arrays["code_fft_conj"], np.complex64), device),
            "dopplers": _to_tensor(
                np.asarray(arrays["dopplers"], np.float32), device)}


def acq_tables_to_numpy(tables: dict) -> dict:
    """NumPy copies of the acquisition replica tables."""
    return {k: v.detach().cpu().numpy() for k, v in tables.items()}
