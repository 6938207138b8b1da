"""The device mesh of the sharded steps, over ``torch.distributed``.

PyTorch port of ``gnss_sim_receiver_tpu.parallel.mesh``.  The JAX package
lays one global array over a ``jax.sharding.Mesh`` and lets ``shard_map``
cut it; the port runs one process per rank (SPMD, as ``torchrun`` starts
them), each on its own device, joined by a process group: NCCL between CUDA
cards, gloo between CPU processes.  So where JAX passes a sharded global
array, the port passes each rank's **local** block of it:

- :func:`shard_channel_axis` cuts this rank's contiguous block of the
  leading axis of every tensor of a pytree (the tracking state, the code
  tables, a Doppler grid, a capture's time segments); 0-d tensors stay
  whole;
- :func:`replicate` puts a whole pytree on this rank's device (the shared
  sample chunk);
- the sharded steps (``parallel.shard_steps``) take and return the local
  shard of every sharded argument and the gathered, full outputs.

Rank r of S holds rows [r C/S, (r + 1) C/S) of a C-row table, as
``NamedSharding(mesh, P("ch"))`` lays them over the mesh's devices.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from gnss_sim_receiver_tpu_torch.device import resolve_device

CHANNEL_AXIS = "ch"
# the environment torchrun gives every rank
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class ChannelMesh:
    """One rank's view of a one-axis mesh: the process group, this rank,
    the world size and the rank's device."""
    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device
    axis: str = CHANNEL_AXIS

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def backend_for(device: torch.device) -> str:
    """NCCL between CUDA cards, gloo between CPU processes."""
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env() -> dict | None:
    """torchrun's variables, or None when none is set; raises when only
    some are."""
    got = {k: os.environ.get(k) for k in TORCHRUN_VARS}
    if all(v is None for v in got.values()):
        return None
    missing = [k for k, v in got.items() if v is None]
    if missing:
        raise RuntimeError(f"torchrun variables missing: {missing}")
    return got


def _rank_device(device, env: dict | None) -> torch.device:
    """The rank's device: `device` resolved (None means the CUDA card), a
    card numbered by LOCAL_RANK where torchrun started the rank."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(env["LOCAL_RANK"]) if env else 0)
    return dev


def _init_group(backend: str, env: dict | None) -> None:
    """The default process group from torchrun's variables, else one rank
    on a free local port."""
    if env is None:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                                 f"{env['MASTER_PORT']}",
            world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]))


def make_mesh(n_devices: int | None = None, device=None) -> ChannelMesh:
    """This rank's mesh over every rank of the default process group,
    which it initialises if there is none: from torchrun's variables
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``), else as one rank on a free local port.  The backend
    follows the device: NCCL for ``cuda`` (the rank's card is
    ``cuda:{LOCAL_RANK}``), gloo for ``device="cpu"``.  If that backend
    cannot start, or an existing group runs another one, it raises: it
    never swaps backends.  `n_devices`, when given, must be the world
    size."""
    env = _torchrun_env()
    dev = _rank_device(device, env)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        _init_group(backend, env)
    group = dist.group.WORLD
    got = dist.get_backend(group)
    if got != backend:
        raise RuntimeError(f"the process group runs {got}; {dev} needs "
                           f"{backend}")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"has {world} ranks")
    return ChannelMesh(group, dist.get_rank(group), world, dev)


def _map(fn, tree):
    """`fn` over every tensor or array leaf of a pytree of NamedTuples,
    tuples, lists and dicts."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_channel_axis(tree, mesh: ChannelMesh):
    """This rank's contiguous block of the LEADING axis of every tensor of
    the pytree (per-channel state and codes), on the rank's device; 0-d
    tensors stay whole.  Raises when a leading axis does not divide by the
    world size."""
    def place(x):
        x = _as_tensor(x, mesh.device)
        if x.dim() == 0:
            return x
        n = x.shape[0]
        if n % mesh.world:
            raise ValueError(f"leading axis ({n}) must divide the mesh "
                             f"axis '{mesh.axis}' ({mesh.world})")
        k = n // mesh.world
        return x[mesh.rank * k:(mesh.rank + 1) * k].contiguous()
    return _map(place, tree)


def replicate(tree, mesh: ChannelMesh):
    """The whole pytree on this rank's device (the shared sample chunk)."""
    return _map(lambda x: _as_tensor(x, mesh.device), tree)
