"""Decoder registry keyed by the reference's implementation names.

All 36 strings of the reference's ``DecoderImplementation`` enum
(factory.rs:240-277) resolve here: 24 flooding variants (prefix-less) and
12 ``HL*`` horizontal-layered variants, spanning the Phi / Tanh /
Minstarapprox / Aminstar families in f64, f32 and 8-bit quantized forms.

Framework extensions (not in the reference): ``Minsumf32`` /
``HLMinsumf32`` — plain normalized min-sum, the cheapest rule per edge.

``*f64`` names use float64 only when JAX x64 mode (``jax_enable_x64``) is
on; with it off, the default, they compute in float32 on every backend.
The names are kept for CLI/API parity.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
from jax import config as jax_config

from .arithmetic import (
    AminstarArithmetic,
    AminstarI8Arithmetic,
    Arithmetic,
    MinstarApproxArithmetic,
    MinstarApproxI8Arithmetic,
    MinSumArithmetic,
    PhiArithmetic,
    TanhArithmetic,
)

__all__ = ["DECODER_IMPLEMENTATIONS", "make_arithmetic", "parse_implementation"]


def _f64():
    return jnp.float64 if jax_config.jax_enable_x64 else jnp.float32


def _i8_combos(prefix: str, ctor) -> dict:
    """The 8 jones/hard-limit/deg1-clip combinations of an i8 family
    (arithmetic.rs:850-897, 1262-1304)."""
    out = {}
    for jones in (False, True):
        for hl in (False, True):
            for d1 in (False, True):
                name = prefix
                if jones:
                    name += "Jones"
                if hl:
                    name += "PartialHardLimit"
                if d1:
                    name += "Deg1Clip"
                out[name] = (
                    lambda jones=jones, hl=hl, d1=d1: ctor(
                        jones=jones, hard_limit=hl, deg1_clip=d1
                    )
                )
    return out


_FLOODING_ARITHS: dict[str, Callable[[], Arithmetic]] = {
    "Phif64": lambda: PhiArithmetic(_f64()),
    "Phif32": lambda: PhiArithmetic(jnp.float32),
    "Tanhf64": lambda: TanhArithmetic(_f64(), clamp=18.0),
    "Tanhf32": lambda: TanhArithmetic(jnp.float32, clamp=9.0),
    "Minstarapproxf64": lambda: MinstarApproxArithmetic(_f64()),
    "Minstarapproxf32": lambda: MinstarApproxArithmetic(jnp.float32),
    "Aminstarf64": lambda: AminstarArithmetic(_f64()),
    "Aminstarf32": lambda: AminstarArithmetic(jnp.float32),
    # framework extensions: plain and normalized (scale 0.75) min-sum,
    # with f32 or bf16 message storage
    "Minsumf32": lambda: MinSumArithmetic(jnp.float32),
    "Minsumbf16": lambda: MinSumArithmetic(
        jnp.float32, storage=jnp.bfloat16
    ),
    "Normminsumf32": lambda: MinSumArithmetic(jnp.float32, scale=0.75),
    "Normminsumbf16": lambda: MinSumArithmetic(
        jnp.float32, scale=0.75, storage=jnp.bfloat16
    ),
    **_i8_combos("Minstarapproxi8", MinstarApproxI8Arithmetic),
    **_i8_combos("Aminstari8", AminstarI8Arithmetic),
}

# the HL (horizontal layered) subset exposed by the reference
_HL_NAMES = [
    "Phif64",
    "Phif32",
    "Tanhf64",
    "Tanhf32",
    "Minstarapproxf64",
    "Minstarapproxf32",
    "Minstarapproxi8",
    "Minstarapproxi8PartialHardLimit",
    "Aminstarf64",
    "Aminstarf32",
    "Aminstari8",
    "Aminstari8PartialHardLimit",
    # framework extensions (bf16 variants included for C-ABI name parity)
    "Minsumf32",
    "Minsumbf16",
    "Normminsumf32",
    "Normminsumbf16",
]

#: name -> (schedule, arithmetic factory); schedule in {"flooding", "layered"}
DECODER_IMPLEMENTATIONS: dict[str, tuple[str, Callable[[], Arithmetic]]] = {
    **{name: ("flooding", f) for name, f in _FLOODING_ARITHS.items()},
    **{f"HL{name}": ("layered", _FLOODING_ARITHS[name]) for name in _HL_NAMES},
}


def parse_implementation(name: str) -> tuple[str, Callable[[], Arithmetic]]:
    try:
        return DECODER_IMPLEMENTATIONS[name]
    except KeyError:
        raise ValueError(f"invalid decoder implementation {name!r}") from None


_warned_f64: set[str] = set()


def make_arithmetic(name: str) -> tuple[str, Arithmetic]:
    """Returns (schedule, arithmetic instance) for an implementation name."""
    schedule, factory = parse_implementation(name)
    if "f64" in name and not jax_config.jax_enable_x64 and name not in _warned_f64:
        # with x64 off JAX has no float64 arrays; be explicit that the
        # f64 name runs in f32 (BER parity vs the f64 reference is
        # validated statistically in tests/test_ber_parity.py)
        import warnings

        _warned_f64.add(name)
        warnings.warn(
            f"decoder {name!r}: float64 needs jax_enable_x64, which is "
            "off; computing in float32",
            stacklevel=2,
        )
    return schedule, factory()
