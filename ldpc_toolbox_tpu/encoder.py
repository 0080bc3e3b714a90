"""Systematic LDPC encoder.

Rebuild of the reference's ``src/encoder.rs``: for H = [H0 H1] with H1
square invertible, the codeword is [message ‖ parity]. Two strategies are
selected automatically (encoder.rs:63-94):

* **staircase** (DVB-S2-style repeat-accumulate, detected by the
  2n-1-ones double-diagonal test of encoder/staircase.rs:3-24): parity =
  running XOR prefix of the sparse product H0·m — O(n). On the device this
  is a masked gather-XOR followed by a cumulative-sum-mod-2 along the
  parity axis, batched over messages.
* **dense generator**: Gauss-reduce [H1 H0] to obtain G0 = H1^{-1}H0
  (host-side, once per code); parity = G0·m — a single GF(2) matmul run
  as an f32 matrix product followed by mod 2. It asks for full f32
  precision: 0/1 operands and row sums < 2^24 are exact in f32, while a
  reduced-precision product (TF32 on the GPU, bf16 passes elsewhere) is
  not something the exactness argument should depend on.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .gf2 import NotInvertibleError, gauss_reduction
from .sparse import SparseMatrix

__all__ = ["Encoder", "EncoderError", "is_staircase"]


class EncoderError(ValueError):
    """The trailing square submatrix of H is not invertible."""


def is_staircase(h: SparseMatrix) -> bool:
    """True iff the parity part of H is exactly the staircase double
    diagonal (encoder/staircase.rs:3-24)."""
    n = h.num_rows
    m = h.num_cols
    num_checked = 0
    for j, k in h.iter_all():
        if k >= m - n:
            if j == 0 and k != m - n:
                return False
            if j != 0 and k != m - n + j - 1 and k != m - n + j:
                return False
            num_checked += 1
    return num_checked == 2 * n - 1


class Encoder:
    """Systematic encoder for a parity-check matrix."""

    def __init__(self, h: SparseMatrix):
        n = h.num_rows
        m = h.num_cols
        self.n_rows = n
        self.n_cols = m
        self.k = m - n
        self.staircase = is_staircase(h)

        if self.staircase:
            # H0 rows as a padded gather table; padding points at a sentinel
            # zero message bit appended at index k
            rows = [[c for c in h.row_list(r) if c < self.k] for r in range(n)]
            d = max((len(r) for r in rows), default=1) or 1
            idx = np.full((n, d), self.k, dtype=np.int32)
            for r, row in enumerate(rows):
                idx[r, : len(row)] = row
            self._h0_idx = idx
        else:
            # A = [H1 H0]; after Gauss-Jordan the right block is G0 = H1^-1 H0
            a = np.zeros((n, m), dtype=np.uint8)
            for j, kk in h.iter_all():
                t = kk + n if kk < m - n else kk - (m - n)
                a[j, t] = 1
            try:
                gauss_reduction(a)
            except NotInvertibleError:
                raise EncoderError(
                    "the square matrix formed by the last columns of the "
                    "parity check is not invertible"
                ) from None
            self._g0 = a[:, n:]  # (n, k) uint8

        self._jit_encode = jax.jit(self._encode_batch)

    # -- batched JAX encode ------------------------------------------------

    def _encode_batch(self, messages):
        """(B, k) 0/1 -> (B, n_cols) 0/1 uint8."""
        msg = messages.astype(jnp.uint8)
        if self.staircase:
            bits_ext = jnp.concatenate(
                [msg, jnp.zeros((msg.shape[0], 1), jnp.uint8)], axis=1
            )
            g = bits_ext[:, self._h0_idx.reshape(-1)].reshape(
                msg.shape[0], *self._h0_idx.shape
            )
            pre = jnp.sum(g, axis=2, dtype=jnp.int32) & 1  # (B, n_rows)
            parity = (jnp.cumsum(pre, axis=1, dtype=jnp.int32) & 1).astype(
                jnp.uint8
            )
        else:
            prod = jnp.dot(
                msg.astype(jnp.float32),
                jnp.asarray(self._g0.T, jnp.float32),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            parity = (prod.astype(jnp.int32) & 1).astype(jnp.uint8)
        return jnp.concatenate([msg, parity], axis=1)

    def encode_batch(self, messages):
        """Encode a (B, k) batch of messages into (B, n_cols) codewords."""
        messages = jnp.asarray(messages)
        assert messages.ndim == 2 and messages.shape[1] == self.k
        return self._jit_encode(messages)

    def encode(self, message) -> np.ndarray:
        """Encode a single (k,) message (host convenience, numpy in/out)."""
        message = np.asarray(message)
        if self.staircase:
            # direct numpy path (cheap, avoids device round-trip)
            bits = np.concatenate([message.astype(np.uint8), [0]])
            pre = bits[self._h0_idx].sum(axis=1) & 1
            parity = np.bitwise_and(np.cumsum(pre), 1).astype(np.uint8)
        else:
            parity = (self._g0.astype(np.uint32) @ message.astype(np.uint32)) & 1
        return np.concatenate([message.astype(np.uint8), parity.astype(np.uint8)])
