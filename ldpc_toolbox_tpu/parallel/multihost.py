"""Multi-host initialization helpers.

The BER harness scales across hosts the same way it scales across chips:
the codeword batch shards over one global mesh axis, H stays replicated,
and the per-step counter reduction is the only cross-host communication —
nine scalars in one all-reduce per batch (SURVEY.md §5's distributed-backend note).

Usage on each host::

    from ldpc_toolbox_tpu.parallel.multihost import initialize, global_mesh
    initialize(coordinator_address="host0:1234", num_processes=2,
               process_id=i)    # jax.distributed over TCP
    mesh = global_mesh()             # 1-D "batch" mesh over ALL devices
    BerTestBuilder(..., mesh=mesh, batch_size=global_batch).build().run()

Every host runs the identical program; `jax.random` keys are derived from
the (seed, point, step) triple, so the Monte-Carlo stream is a pure
function of the parameters regardless of topology.
"""

from __future__ import annotations

import jax

from .mesh import default_mesh

__all__ = ["initialize", "global_mesh"]


def initialize(**kwargs) -> None:
    """Initialize jax.distributed (no-op on a single process).

    kwargs pass through to ``jax.distributed.initialize``: give the
    coordinator_address, num_processes and process_id explicitly (GPU
    hosts have no cluster auto-detection here); they run multi-process
    over plain TCP, as the CPU hosts in tests do. Without kwargs a
    failed auto-detection means a single process.
    """
    state = getattr(jax.distributed, "global_state", None)
    if state is not None and state.client is not None:
        return  # already initialized
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        if kwargs:
            raise  # an explicit multi-process setup failing is an error
        # single-process environment (tests, one host): nothing to do


def global_mesh():
    """A 1-D ``batch`` mesh over every device of every process."""
    return default_mesh(jax.devices())
