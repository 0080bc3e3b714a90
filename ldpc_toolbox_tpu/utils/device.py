"""The GPU a measurement runs on, and how to name it.

A measurement path never falls back to the CPU: ``require_gpu`` exits
non-zero when JAX's default backend is not a GPU. ``card_identity`` asks
``nvidia-smi`` (a child process that stays off JAX) for each card's name
and power limit, which stand beside every number a measurement prints.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["require_gpu", "card_identity", "device_summary"]


def require_gpu():
    """The first device, after checking that JAX's default backend is a
    GPU; raises SystemExit (status 1) otherwise."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"error: no GPU: JAX's default backend is {backend!r}"
        )
    return jax.devices()[0]


def card_identity() -> str:
    """``name, power.limit`` per card, one line each, as nvidia-smi
    prints them."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


def device_summary() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
    }
