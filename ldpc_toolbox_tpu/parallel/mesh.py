"""Device mesh helpers for data-parallel Monte-Carlo decoding.

The scaling axes of this framework are (batch of codewords) x (Eb/N0 sweep
points) — see SURVEY.md §2. The reference parallelizes frames with OS
threads and mpsc channels (ber.rs:303-310); here the codeword batch shards
over a 1-D `jax.sharding.Mesh` axis ``"batch"``, H's index tensors are
replicated, and the per-step error counters reduce to scalars with one XLA
all-reduce (NVLink between the cards of one host). Multi-host extends the same mesh over all
processes' devices.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["default_mesh", "shard_batch"]


def default_mesh(devices=None) -> Mesh:
    """A 1-D mesh named ``batch`` over all (or the given) devices."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("batch",))


def shard_batch(x, mesh: Mesh):
    """Constrain the leading axis of ``x`` to shard over the mesh."""
    spec = P("batch", *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
