"""Carry tracking state and replica tables across as NumPy arrays.

A :class:`~gnss_sim_receiver_tpu_torch.models.tracking.TrackState` travels
as a flat dict of NumPy arrays, nested loop-filter and C/N0 accumulator
fields under dotted keys (``"dll.vel"``, ``"cn0_acc.sum_m2"``), which is the
layout of the JAX package's TrackState too; the acquisition replica tables
(conj code FFTs and Doppler bins) travel as a dict of arrays.  Feeding the
same arrays to the JAX functions and to the port makes their state and
tables identical, bit for bit.  The conditioner's tables (FIR taps, beam
weights) travel the same way, and :func:`receiver_conf_from_fields` turns a
receiver configuration given as a plain dict of dataclass fields (the JAX
package's ``dataclasses.asdict(ReceiverConf)``, signal chains, the
orbital EKF's and the RTK engine's confs included) into the port's.
:func:`base_observations_from` carries an RTK base stream (its
ObservationEpoch list, channel maps and position) across, so that both
packages' engines are fed the same epochs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf, VARIANTS
from gnss_sim_receiver_tpu_torch.models.observables import (ObsConf,
                                                            ObservationEpoch)
from gnss_sim_receiver_tpu_torch.models.pvt import PvtConf
from gnss_sim_receiver_tpu_torch.models.pvt_ekf_orbital import PvtEkfConf
from gnss_sim_receiver_tpu_torch import signals
from gnss_sim_receiver_tpu_torch.models.receiver import (ReceiverConf,
                                                         SignalChainConf)
from gnss_sim_receiver_tpu_torch.models.rtk import BaseObservations, RtkConf
from gnss_sim_receiver_tpu_torch.models.tracking import (TrackingConf,
                                                         TrackState)
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


def conditioner_tables_to_numpy(cond) -> dict:
    """NumPy copies of a SignalConditioner's tables: ``taps`` [T] float32
    (FIR implementations) and ``beam_weights`` [E] complex64
    (Beamformer_Filter).  Takes the port's conditioner or any object with
    the same ``_taps`` / ``_beam_weights`` attributes (the JAX package's)."""
    out = {}
    taps = getattr(cond, "_taps", None)
    if taps is not None:
        out["taps"] = _to_numpy(taps).astype(np.float32)
    weights = getattr(cond, "_beam_weights", None)
    if weights is not None:
        out["beam_weights"] = _to_numpy(weights).astype(np.complex64)
    return out


def conditioner_tables_from_numpy(cond, arrays: dict) -> None:
    """Set the port conditioner's tables from NumPy arrays, on its device."""
    if "taps" in arrays:
        cond._taps = _to_tensor(np.asarray(arrays["taps"], np.float32),
                                cond.device)
    if "beam_weights" in arrays:
        cond._beam_weights = _to_tensor(
            np.asarray(arrays["beam_weights"], np.complex64), cond.device)


def _conf_from_fields(cls, fields: dict, where: str):
    """`cls(**fields)` for the fields the port's dataclass has.  A field it
    lacks must hold its default on the other side, given in `_ABSENT`, and
    a field of `_SUPPORTED` one of the values listed there: anything else
    selects a feature the port does not carry."""
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, value in fields.items():
        if name in known and value in _SUPPORTED.get((cls, name), (value,)):
            kwargs[name] = value
        elif name in _ABSENT[cls] and _ABSENT[cls][name] == value:
            continue
        else:
            raise NotImplementedError(
                f"{where}.{name}={value!r} is not ported")
    return cls(**kwargs)


# fields the port has for some of the values the JAX package takes
_SUPPORTED = {(AcqConf, "variant"): VARIANTS}

# fields of the JAX package's confs that the port lacks, with the one value
# (the default) under which the port computes the same thing
_ABSENT = {
    AcqConf: {},
    TrackingConf: dict(dll_filter_order=2, bayes_nu0=30.0),
    ObsConf: {},
    PvtConf: {},
    SignalChainConf: {},
    ReceiverConf: {},
    PvtEkfConf: {},
    RtkConf: {},
}


def _nested(fields: dict, where: str) -> dict:
    """`fields` with its acq / trk / obs / pvt dicts (and a receiver's
    pvt_ekf and rtk dicts) turned into the port's confs."""
    fields = dict(fields)
    for name, cls in (("acq", AcqConf), ("trk", TrackingConf),
                      ("obs", ObsConf), ("pvt", PvtConf),
                      ("pvt_ekf", PvtEkfConf), ("rtk", RtkConf)):
        if fields.get(name) is not None:
            fields[name] = _conf_from_fields(cls, fields[name],
                                             f"{where}.{name}")
    return fields


def _chain_from_fields(fields: dict, where: str) -> SignalChainConf:
    """A signal chain from its fields.  The code providers (functions of the
    other package) become the port's own for the chain's signal: the data
    code, and the pilot (E1-C, E5a-Q) as the second replica family; on a
    track_pilot chain (galileo_e1b_chain's) the pilot code tracks and the
    data code feeds the data-prompt correlator."""
    fields = _nested(fields, where)
    sig = fields["signal"]
    pilot = fields.get("trk") is not None and fields["trk"].track_pilot
    if pilot and sig != "1B":
        raise NotImplementedError(
            f"{where}.trk.track_pilot of signal {sig} is not ported")
    data, second = signals.CodeProvider(sig), None
    if sig in signals.PILOT_COMPONENT:
        second = signals.CodeProvider(sig, signals.PILOT_COMPONENT[sig])
    if pilot:
        data, second = second, data
    if fields.get("code_provider") is not None:
        fields["code_provider"] = data
    if fields.get("data_code_provider") is not None:
        if second is None:
            raise NotImplementedError(
                f"{where}.data_code_provider of signal {sig} is not ported")
        fields["data_code_provider"] = second
    return _conf_from_fields(SignalChainConf, fields, where)


def receiver_conf_from_fields(fields: dict) -> ReceiverConf:
    """The port's ReceiverConf from a plain dict of a ReceiverConf's
    dataclass fields, the nested acq / trk / obs / pvt confs and the signal
    chains as dicts too (``dataclasses.asdict`` of the JAX package's conf).
    Raises NotImplementedError for a field that selects what the port
    lacks."""
    fields = _nested(fields, "receiver")
    fields["chains"] = tuple(
        _chain_from_fields(c, f"receiver.chains[{i}]")
        for i, c in enumerate(fields.get("chains", ())))
    return _conf_from_fields(ReceiverConf, fields, "receiver")


def observation_epoch_from(epoch) -> ObservationEpoch:
    """The port's ObservationEpoch from any object of the same fields (the
    JAX package's), its arrays copied."""
    return ObservationEpoch(**{
        f.name: (np.array(getattr(epoch, f.name), copy=True)
                 if isinstance(getattr(epoch, f.name), np.ndarray)
                 else getattr(epoch, f.name))
        for f in dataclasses.fields(ObservationEpoch)})


def base_observations_from(base) -> BaseObservations:
    """The port's BaseObservations from the JAX package's (or any object
    with `epochs`, `prns`, `systems` and `base_ecef_m`): the RTK base
    stream carried across, its epochs copied."""
    return BaseObservations(
        epochs=[observation_epoch_from(e) for e in base.epochs],
        prns=list(base.prns), systems=list(base.systems),
        base_ecef_m=np.array(base.base_ecef_m, np.float64, copy=True))
