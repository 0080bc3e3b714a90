"""Belief-propagation LDPC decoders (flooding + horizontal layered).

Public API::

    dec = Decoder(h, "HLMinstarapproxf32")
    out = dec.decode_batch(llrs, max_iterations=100)   # (B, n) LLRs
    single = dec.decode(llrs_1d, max_iterations=100)   # one frame

``decode`` mirrors the reference's ``LdpcDecoder::decode`` contract
(decoder.rs:19-35): the returned ``DecoderOutput`` carries the hard
decision, the iteration count (0 if the input already satisfied H,
``max_iterations`` on failure) and a success flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse import SparseMatrix
from .factory import DECODER_IMPLEMENTATIONS, make_arithmetic  # noqa: F401
from .flooding import flooding_decode
from .layered import layered_decode
from .layout import DecodeGraph

__all__ = [
    "Decoder",
    "DecoderOutput",
    "DecodeGraph",
    "DECODER_IMPLEMENTATIONS",
    "flooding_decode",
    "layered_decode",
]


@dataclass
class DecoderOutput:
    codeword: np.ndarray  # (n,) uint8 hard decisions
    iterations: int
    success: bool


class Decoder:
    """A batched LDPC decoder for a fixed parity-check matrix."""

    def __init__(self, h, implementation: str = "Phif64"):
        """``h``: a SparseMatrix / DecodeGraph (generic dual-gather
        decode), a standards code object (``codes.dvbs2.Code``,
        ``AR4JACode``, ``C2Code``), or a ``(BaseGraph, Z)`` pair for
        5G-NR.  Code objects route to the block-circulant lifted decode
        (decoder/lifted_flooding.py, decoder/lifted_layered.py)."""
        self.lifted = None
        if not isinstance(h, (SparseMatrix, DecodeGraph)):
            from .lifted import LiftedGraph, lifted_graph_for, nr5g_maps

            if isinstance(h, tuple):  # (BaseGraph, lifting size Z)
                bg, z = h
                self.lifted = LiftedGraph.from_sparse(
                    bg.h(z), *nr5g_maps(bg, z)
                )
            else:
                self.lifted = lifted_graph_for(h)
                if self.lifted is None:
                    raise TypeError(
                        f"unsupported code object {type(h).__name__}"
                    )
        self.implementation = implementation
        self.schedule, self.arithmetic = make_arithmetic(implementation)
        if self.lifted is not None:
            from .lifted_flooding import lifted_flooding_decode
            from .lifted_layered import lifted_layered_decode

            # the lifted decode takes the LiftedGraph where the generic
            # one takes its DecodeGraph
            self.graph = self.lifted
            self._decode_fn = (
                lifted_flooding_decode
                if self.schedule == "flooding"
                else lifted_layered_decode
            )
        else:
            self.graph = (
                h if isinstance(h, DecodeGraph) else DecodeGraph.from_sparse(h)
            )
            self._decode_fn = (
                flooding_decode
                if self.schedule == "flooding"
                else layered_decode
            )
        self._jitted: dict = {}

    def _get_jitted(self, max_iterations: int):
        key = max_iterations
        if key not in self._jitted:
            fn = partial(
                self._decode_fn, self.graph, self.arithmetic,
                max_iterations=max_iterations,
            )
            self._jitted[key] = jax.jit(fn)
        return self._jitted[key]

    def decode_batch(self, llrs, max_iterations: int = 100):
        """Decode a (B, n) batch of channel LLR frames.

        Returns a dict of device arrays: ``codeword`` (B, n) uint8,
        ``iterations`` (B,) int32, ``success`` (B,) bool.
        """
        llrs = jnp.asarray(llrs)
        assert llrs.ndim == 2 and llrs.shape[1] == self.graph.n, llrs.shape
        return self._get_jitted(max_iterations)(llrs)

    def decode(self, llrs, max_iterations: int = 100) -> DecoderOutput:
        """Decode a single (n,) frame (convenience wrapper)."""
        out = self.decode_batch(jnp.asarray(llrs)[None, :], max_iterations)
        return DecoderOutput(
            codeword=np.asarray(out["codeword"][0]),
            iterations=int(out["iterations"][0]),
            success=bool(out["success"][0]),
        )
