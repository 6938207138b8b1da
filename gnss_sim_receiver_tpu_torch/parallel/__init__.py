"""Multi-device scale-out: the mesh of ranks and channel sharding.

The JAX package shards the channel axis of its batched programs over a
``jax.sharding.Mesh``; the port runs one process per rank over a
``torch.distributed`` process group (NCCL between cards, gloo on the CPU),
each rank holding its block of the channel axis."""

from gnss_sim_receiver_tpu_torch.parallel.mesh import (  # noqa: F401
    CHANNEL_AXIS, make_mesh, shard_channel_axis, replicate)
