"""Rolled plane gather — the data-movement op of the lifted flooding path.

``plane_gather(src, planes, shifts)`` with ``src (P, Z, B)``,
``planes/shifts (G, d)`` returns ``out (G, d, Z, B)`` where

    out[g, t, l, :] = src[planes[g, t], (l - shifts[g, t]) % Z, :]

i.e. each output plane is a whole contiguous ``(Z, B)`` block of ``src``,
cyclically rolled along the lane axis. For lifted LDPC codes this is the
entire message permutation between variable and check coordinates.

Lowered as one flat XLA gather of contiguous ``(B,)`` rows.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["plane_gather", "plane_gather_reference"]


def plane_gather(src, planes, shifts):
    """Gather rolled planes as one flat XLA gather."""
    P, Z, B = src.shape
    G, d = planes.shape
    lanes = (np.arange(Z)[None, None, :] - shifts[:, :, None]) % Z
    flat = planes[:, :, None] * Z + lanes  # (G, d, Z)
    out = src.reshape(P * Z, B)[jnp.asarray(flat.reshape(-1))]
    return out.reshape(G, d, Z, B)


# kept as an alias: tests and docs refer to the reference semantics by name
plane_gather_reference = plane_gather
