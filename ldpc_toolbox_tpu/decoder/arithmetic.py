"""Decoder arithmetic rules as batched masked tensor ops.

The numeric heart of the framework — the 18 rules of the reference's
``src/decoder/arithmetic.rs`` re-expressed as pure functions over dense
gathered blocks:

* ``check_messages(x, mask)`` maps the incoming variable messages of every
  check node — a ``(rows, dc_max, batch)`` block with a validity mask —
  to the leave-one-out outgoing messages of the same shape. This is the
  reference's ``send_check_messages`` (arithmetic.rs:100-102) vectorized
  over all checks and a codeword batch at once.
* ``var_update(input_llr, c2v, mask)`` is the shared variable rule
  "sum minus own contribution" (arithmetic.rs:140-156), with the i8
  variants' Jones clipping / degree-1 clipping folded in
  (arithmetic.rs:806-842).

Families (names match the reference factory strings, factory.rs:240-277):

* Phi (f64/f32): ``phi(x) = -ln tanh(x/2)`` involution with the
  sum-of-phis trick, input clamped >= 1e-30 (arithmetic.rs:158-298).
* Tanh (f64/f32): ``2 atanh(prod tanh(x/2))`` with arg clamp +-18/+-9
  (arithmetic.rs:300-435); leave-one-out via exclusive prefix/suffix
  products.
* Minstarapprox (f64/f32/i8 x 8): pairwise
  ``min*(x,y) ~= min - ln(1+e^-|x-y|)`` clamped >= 0, folded in the exact
  adjacency order of the reference (arithmetic.rs:437-580, 656-804); the
  i8 variants use the C=8 quantizer and a <=127-entry lookup table
  (arithmetic.rs:585-602).
* Aminstar (f64/f32/i8 x 8): A-Min*-BP — exact min* against the
  minimum-|x| edge only, one shared value for all other edges
  (arithmetic.rs:899-1304, Jones et al. MILCOM 2003).

Everything here is shape-polymorphic over the leading axes, so the same
functions serve the flooding schedule (all m checks at once) and the
horizontal-layered schedule (one variable-disjoint layer at a time).

Note on f64: the ``*f64`` rules use float64 when JAX x64 mode
(``jax_enable_x64``) is on, else float32 — the factory handles the
mapping and keeps the reference's names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Arithmetic",
    "PhiArithmetic",
    "TanhArithmetic",
    "MinstarApproxArithmetic",
    "AminstarArithmetic",
    "MinstarApproxI8Arithmetic",
    "AminstarI8Arithmetic",
    "MinSumArithmetic",
    "I8_QUANTIZER_C",
    "i8_correction_table",
]

I8_QUANTIZER_C = 8.0


def i8_correction_table() -> np.ndarray:
    """Quantized ``C*ln(1+e^(-t/C))`` correction lookup (arithmetic.rs:589-602).

    Entry t holds round(8*ln(1+e^(-t/8))) for as long as that rounds
    positive; beyond, zero (the reference's out-of-table lookup returns 0).
    Rounding is half-away-from-zero like Rust's f64::round.
    """
    table = np.zeros(128, dtype=np.int32)
    for t in range(128):
        x = math.floor(I8_QUANTIZER_C * math.log1p(math.exp(-t / I8_QUANTIZER_C)) + 0.5)
        if x <= 0:
            break
        table[t] = x
    return table


def _loo_sign(x, mask_e):
    """Leave-one-out sign parity: for each slot, XOR of the signs of all
    *other* valid slots (mask_e=None means all slots valid). Returns +-1
    int32."""
    neg = x < 0
    if mask_e is not None:
        neg = neg & mask_e
    total_par = (
        jnp.sum(neg, axis=-2, keepdims=True, dtype=jnp.int32) & 1
    )
    loo_par = total_par ^ neg.astype(jnp.int32)
    return 1 - 2 * loo_par  # (rows, d, batch) int32 in {-1, +1}


def _round_half_away(x):
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


class Arithmetic:
    """Base: float LLRs, identity quantization, shared variable rule."""

    is_int8 = False

    def __init__(self, dtype=jnp.float32):
        self.dtype = dtype

    # dtype the message arrays are *stored* in (HBM traffic); computation
    # may widen after each gather (int8 storage / int32 compute for the i8
    # family)
    @property
    def storage_dtype(self):
        return self.dtype

    @property
    def compute_dtype(self):
        return self.dtype

    # storage dtype of the layered schedule's variable posteriors Qv
    @property
    def var_llr_storage_dtype(self):
        return self.dtype

    # -- LLR domain --------------------------------------------------------

    def quantize(self, llr):
        """Channel LLR -> internal Llr (input_llr_quantize)."""
        return llr.astype(self.dtype)

    def hard_decision(self, llr):
        """llr <= 0 -> bit 1 (the reference's sign convention)."""
        return llr <= 0

    def llr_to_var_llr(self, llr):
        return llr

    def var_llr_to_llr(self, var_llr):
        return var_llr

    # -- variable rule (arithmetic.rs:140-156) -----------------------------

    def var_update(self, input_llr, c2v, mask=None):
        """input_llr (n, B); c2v (n, d, B). mask=None means every slot is a
        real edge (compact layout). Returns (v2c, new_llr)."""
        inc = c2v if mask is None else jnp.where(mask[..., None], c2v, 0)
        total = input_llr + jnp.sum(inc, axis=1)
        v2c = total[:, None, :] - c2v
        return v2c, total

    # -- layered-schedule helpers ------------------------------------------

    def layered_x(self, qv, rold):
        """Extrinsic input for the layered check update: Qv - Rcv."""
        return qv - rold

    def layered_qv_delta(self, rnew, rold):
        """Amount added to Qv after the check update: Rnew - Rold."""
        return rnew - rold


class PhiArithmetic(Arithmetic):
    """phi involution sum-product (arithmetic.rs:158-298)."""

    MIN_X = 1e-30

    def _phi(self, x):
        # phi(x) = -ln(tanh(x/2)) = ln(1+e^-x) - ln(1-e^-x), computed via
        # log1p/expm1. The textbook tanh form collapses to 0 once tanh
        # rounds to 1 (XLA's f32 on the H100: x >= 16; exact f32: x >= 17),
        # zeroing the magnitude of every strong message and raising the
        # error floor ~25x; the stable form keeps phi = 2e^-x down to the
        # f32 underflow at x ~ 103.
        x = jnp.maximum(x, jnp.asarray(self.MIN_X, self.dtype))
        t = jnp.exp(-x)
        # ln(1-t): log1p(-t) is exact for small t (log(-expm1(-x)) would
        # round 1-t to 1 and drop the -t term — a factor-2 error in phi);
        # log(-expm1(-x)) is exact for t near 1 (log1p(-t) would suffer
        # the 1-e^-x cancellation). Split at t = 0.5 (x = ln 2).
        ln_1mt = jnp.where(
            t < 0.5,
            jnp.log1p(-t),
            jnp.log(-jnp.expm1(-jnp.maximum(x, self.MIN_X))),
        )
        return jnp.log1p(t) - ln_1mt

    def check_messages(self, x, mask=None):
        mask_e = None if mask is None else mask[..., None]
        phi_x = self._phi(jnp.abs(x))
        inc = phi_x if mask_e is None else jnp.where(mask_e, phi_x, 0)
        phi_sum = jnp.sum(inc, axis=1, keepdims=True)
        y = self._phi(phi_sum - phi_x)
        return (_loo_sign(x, mask_e).astype(self.dtype)) * y


class TanhArithmetic(Arithmetic):
    """tanh product rule (arithmetic.rs:300-435)."""

    def __init__(self, dtype=jnp.float32, clamp=None):
        super().__init__(dtype)
        if clamp is None:
            # reference: 18.0 for f64 (tanh(19)=1.0), 9.0 for f32
            clamp = 18.0 if dtype == jnp.float64 else 9.0
        self.clamp = clamp
        # The reference's input clamp keeps tanh(clamp) < 1 only under
        # exact round-to-nearest libm (tanh(9) = 1 - 3.0e-8 rounds to
        # 0.99999994f). XLA's tanh is a polynomial approximation, not
        # libm's: measured on the H100 (and on XLA's CPU backend), f32
        # tanh(x) == 1.0 exactly for x >= 8, so atanh(prod) would be inf
        # and the NaN posteriors hard-decide to the all-zero word — every
        # frame a false decode. Clamp the
        # product to the largest representable value below one, bounding
        # messages at 2*atanh(1-2^-24) = 17.3 (f32) / 37.4 (f64); a no-op
        # wherever the reference arithmetic is finite.
        one = np.asarray(1, np.dtype(jnp.dtype(dtype).name))
        self.prod_max = float(np.nextafter(one, one * 0))

    def check_messages(self, x, mask=None):
        c = jnp.asarray(self.clamp, self.dtype)
        t = jnp.tanh(jnp.clip(0.5 * x, -c, c))
        if mask is not None:
            t = jnp.where(mask[..., None], t, jnp.asarray(1.0, self.dtype))
        # exclusive prefix/suffix products give the product over all other
        # slots without dividing (tanh can be 0)
        ones = jnp.ones_like(t[:, :1])
        prefix = jnp.concatenate(
            [ones, jnp.cumprod(t, axis=1)[:, :-1]], axis=1
        )
        rev = jnp.flip(t, axis=1)
        suffix = jnp.flip(
            jnp.concatenate([ones, jnp.cumprod(rev, axis=1)[:, :-1]], axis=1),
            axis=1,
        )
        prod = prefix * suffix
        pm = jnp.asarray(self.prod_max, self.dtype)
        return 2.0 * jnp.arctanh(jnp.clip(prod, -pm, pm))


class MinstarApproxArithmetic(Arithmetic):
    """Pairwise min* approximation, exact reference fold order
    (arithmetic.rs:487-521): for each excluded slot, left-fold the other
    valid slots in adjacency order with
    ``min*(acc, v) = max(min(acc, v) - ln(1+e^-|acc-v|), 0)``."""

    def _fold_op(self, acc, v):
        return jnp.maximum(
            jnp.minimum(acc, v) - jnp.log1p(jnp.exp(-jnp.abs(acc - v))), 0.0
        )

    def check_messages(self, x, mask=None):
        rows, d, batch = x.shape
        mask_e = None if mask is None else mask[..., None]
        mag = jnp.abs(x)
        acc = jnp.zeros_like(x)
        notk = ~np.eye(d, dtype=bool)  # (k, j): j != k
        if mask is None:
            # compact layout: fold order is static — slot j's fold starts
            # with the first k != j and continues in adjacency order
            started = np.zeros((d,), dtype=bool)
            for k in range(d):
                vk = mag[:, k : k + 1, :]
                sel = jnp.asarray(notk[k])[None, :, None]
                first = jnp.asarray(notk[k] & ~started)[None, :, None]
                folded = self._fold_op(acc, vk)
                acc = jnp.where(first, vk, jnp.where(sel, folded, acc))
                started |= notk[k]
        else:
            cnt = jnp.zeros((rows, d, 1), dtype=jnp.int32)
            for k in range(d):
                vk = mag[:, k : k + 1, :]
                elig = (mask[:, k : k + 1] & jnp.asarray(notk[k])[None, :])[
                    ..., None
                ]
                first = elig & (cnt == 0)
                folded = self._fold_op(acc, vk)
                acc = jnp.where(first, vk, jnp.where(elig, folded, acc))
                cnt = cnt + elig.astype(jnp.int32)
        return (_loo_sign(x, mask_e).astype(self.dtype)) * acc


class MinSumArithmetic(Arithmetic):
    """Plain normalized min-sum (framework extension, not in the reference's
    18 rules): leave-one-out minimum magnitude via the two-minima trick —
    the cheapest rule per edge.
    """

    def __init__(self, dtype=jnp.float32, scale=1.0, storage=None):
        super().__init__(dtype)
        self.scale = scale
        self._storage = storage

    @property
    def storage_dtype(self):
        # optionally store messages in bfloat16 (half the HBM traffic);
        # computation stays in self.dtype
        return self._storage if self._storage is not None else self.dtype

    def check_messages(self, x, mask=None):
        d = x.shape[1]
        if mask is None and d >= 2:
            # fused two-pass fold over the (static, small) degree axis:
            # pass 1 accumulates (min1, min2, argmin, sign parity) on
            # (rows, batch) slices; pass 2 emits each slot's output. XLA
            # fuses the whole thing into ~3 passes over the block, vs the
            # reduce-op formulation which materializes several.
            mags = [jnp.abs(x[:, k]) for k in range(d)]
            negs = [x[:, k] < 0 for k in range(d)]
            m1 = mags[0]
            m2 = jnp.full_like(m1, jnp.asarray(jnp.finfo(self.dtype).max))
            arg = jnp.zeros(m1.shape, jnp.int32)
            par = negs[0]
            for k in range(1, d):
                mk = mags[k]
                m2 = jnp.minimum(m2, jnp.maximum(m1, mk))
                take = mk < m1
                m1 = jnp.where(take, mk, m1)
                arg = jnp.where(take, k, arg)
                par = par ^ negs[k]
            scale = None
            if self.scale != 1.0:
                scale = jnp.asarray(self.scale, self.dtype)
            outs = []
            for j in range(d):
                loo = jnp.where(arg == j, m2, m1)
                if scale is not None:
                    loo = loo * scale
                sign_neg = par ^ negs[j]
                outs.append(jnp.where(sign_neg, -loo, loo))
            return jnp.stack(outs, axis=1)

        mask_e = None if mask is None else mask[..., None]
        big = jnp.asarray(jnp.finfo(self.dtype).max, self.dtype)
        mag = jnp.abs(x)
        if mask_e is not None:
            mag = jnp.where(mask_e, mag, big)
        min1 = jnp.min(mag, axis=1, keepdims=True)
        idx1 = jnp.argmin(mag, axis=1, keepdims=True)
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (1, d, 1), 1) == idx1
        )
        min2 = jnp.min(jnp.where(onehot, big, mag), axis=1, keepdims=True)
        loo_min = jnp.where(onehot, min2, min1)
        out = (_loo_sign(x, mask_e).astype(self.dtype)) * loo_min
        if self.scale != 1.0:
            out = out * jnp.asarray(self.scale, self.dtype)
        return out


class AminstarArithmetic(Arithmetic):
    """A-Min*-BP (arithmetic.rs:899-1072): exact min* of all non-minimum
    edges (in fold order) gives ``delta`` for the argmin edge; all other
    edges share ``min*(delta, |x_min|)``."""

    def _minstar_full(self, a, b):
        return (
            jnp.minimum(a, b)
            - jnp.log1p(jnp.exp(-jnp.abs(a - b)))
            + jnp.log1p(jnp.exp(-(a + b)))
        )

    def check_messages(self, x, mask=None):
        rows, d, batch = x.shape
        mask_e = None if mask is None else mask[..., None]
        big = jnp.asarray(jnp.finfo(self.dtype).max, self.dtype)
        mag = jnp.abs(x)
        masked_mag = mag if mask_e is None else jnp.where(mask_e, mag, big)
        argmin = jnp.argmin(masked_mag, axis=1)  # (rows, B) first-min
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (1, d, 1), 1)
            == argmin[:, None, :]
        )  # (rows, d, B)

        # fold delta over valid slots j != argmin, in adjacency order
        acc = jnp.zeros((rows, 1, batch), dtype=self.dtype)
        cnt = jnp.zeros((rows, 1, batch), dtype=jnp.int32)
        for k in range(d):
            vk = mag[:, k : k + 1, :]
            elig = ~onehot[:, k : k + 1, :]
            if mask is not None:
                elig = mask[:, k : k + 1, None] & elig
            first = elig & (cnt == 0)
            folded = self._minstar_full(acc, vk)
            acc = jnp.where(first, vk, jnp.where(elig, folded, acc))
            cnt = cnt + elig.astype(jnp.int32)
        delta = acc  # (rows, 1, B)

        vmin = jnp.min(masked_mag, axis=1, keepdims=True)
        delta_others = self._minstar_full(delta, vmin)
        magnitude = jnp.where(onehot, delta, delta_others)
        return (_loo_sign(x, mask_e).astype(self.dtype)) * magnitude


# --------------------------------------------------------------------------
# 8-bit quantized families.
#
# Messages are int8-valued but computed in int32 lanes (identical results:
# every reference step clips into i8/i16 range before use). The variable
# LLR domain is int16-valued (VarLlr = i16, arithmetic.rs:684-688).
# --------------------------------------------------------------------------


def _clip127(x):
    return jnp.clip(x, -127, 127)


def _partial_hard_limit(x):
    # arithmetic.rs:812-824
    return jnp.where(x <= -100, -127, jnp.where(x >= 100, 127, x))


class _I8Base(Arithmetic):
    is_int8 = True

    def __init__(self, jones: bool = False, hard_limit: bool = False, deg1_clip: bool = False):
        super().__init__(jnp.int8)
        self.jones = jones
        self.hard_limit = hard_limit
        self.deg1_clip = deg1_clip
        table = i8_correction_table()
        self.table = jnp.asarray(table)
        # The table is monotone non-increasing with a handful of distinct
        # values (0..6), so table[t] == sum_v 1[t < thr_v] where thr_v is
        # the number of entries >= v. The sum-of-comparisons form avoids a
        # (rows, degree, batch)-shaped gather per fold step: six
        # elementwise compares fuse with the fold, a gather does not.
        assert np.all(np.diff(table) <= 0), "correction table not monotone"
        self._thresholds = tuple(
            int(np.sum(table >= v)) for v in range(1, int(table.max()) + 1)
        )

    # messages are int8-valued: store them as int8 (4x less HBM traffic),
    # widen to int32 lanes after each gather
    @property
    def storage_dtype(self):
        return jnp.int8

    @property
    def compute_dtype(self):
        return jnp.int32

    # VarLlr = i16 (arithmetic.rs:684-688)
    @property
    def var_llr_storage_dtype(self):
        return jnp.int16

    # -- LLR domain --------------------------------------------------------

    def quantize(self, llr):
        """C=8 quantizer with +-127 saturation and half-away rounding
        (arithmetic.rs:690-699). Input is the float channel LLR."""
        x = I8_QUANTIZER_C * llr.astype(jnp.float32)
        q = jnp.where(
            x >= 127.0,
            127,
            jnp.where(x <= -127.0, -127, _round_half_away(x).astype(jnp.int32)),
        )
        return q.astype(jnp.int32)  # int8-valued, int32 lanes

    def llr_to_var_llr(self, llr):
        return llr  # i8 -> i16 widening is a no-op in int32 lanes

    def var_llr_to_llr(self, var_llr):
        return _clip127(var_llr)

    def hard_decision(self, llr):
        return llr <= 0

    def _lookup(self, t):
        """table[t] for t in [0, 127], 0 beyond (arithmetic.rs:604-607),
        computed as a sum of compares against the table's step boundaries
        (bit-exact; see __init__)."""
        out = jnp.zeros_like(t)
        for thr in self._thresholds:
            out = out + (t < thr).astype(t.dtype)
        return out

    # -- variable rule with optional clips (arithmetic.rs:622-654) ---------

    def var_update(self, input_llr, c2v, mask=None):
        inp = input_llr
        if self.deg1_clip:
            if mask is None:
                # compact layout: degree is the static slot count
                if c2v.shape[1] == 1:
                    inp = jnp.clip(input_llr, -116, 116)
            else:
                deg = jnp.sum(mask, axis=1, dtype=jnp.int32)  # (n,)
                clipped = jnp.clip(input_llr, -116, 116)
                inp = jnp.where((deg == 1)[:, None], clipped, input_llr)
        inc = c2v if mask is None else jnp.where(mask[..., None], c2v, 0)
        total = inp + jnp.sum(inc, axis=1, dtype=jnp.int32)
        if self.jones:
            total = _clip127(total)
        v2c = _clip127(total[:, None, :] - c2v)
        return v2c, _clip127(total)

    # -- layered helpers ---------------------------------------------------

    def layered_x(self, qv, rold):
        # reference computes x = clip(vars[dest] - i16(rcv))
        return _clip127(qv - rold)

    def layered_qv_delta(self, rnew, rold):
        return rnew - rold


class MinstarApproxI8Arithmetic(_I8Base):
    """Quantized pairwise min* with table-lookup correction
    (arithmetic.rs:718-754): fold over the other valid slots in order with
    ``max(min(acc,v) - table[|acc-v|], 0)``; optional partial hard limit on
    the signed output."""

    def check_messages(self, x, mask=None):
        rows, d, batch = x.shape
        mask_e = None if mask is None else mask[..., None]
        mag = jnp.abs(x)
        acc = jnp.zeros_like(x)
        notk = ~np.eye(d, dtype=bool)

        def fold(acc, vk):
            return jnp.maximum(
                jnp.minimum(acc, vk) - self._lookup(jnp.abs(acc - vk)), 0
            )

        if mask is None:
            started = np.zeros((d,), dtype=bool)
            for k in range(d):
                vk = mag[:, k : k + 1, :]
                sel = jnp.asarray(notk[k])[None, :, None]
                first = jnp.asarray(notk[k] & ~started)[None, :, None]
                acc = jnp.where(first, vk, jnp.where(sel, fold(acc, vk), acc))
                started |= notk[k]
        else:
            cnt = jnp.zeros((rows, d, 1), dtype=jnp.int32)
            for k in range(d):
                vk = mag[:, k : k + 1, :]
                elig = (mask[:, k : k + 1] & jnp.asarray(notk[k])[None, :])[
                    ..., None
                ]
                first = elig & (cnt == 0)
                acc = jnp.where(first, vk, jnp.where(elig, fold(acc, vk), acc))
                cnt = cnt + elig.astype(jnp.int32)
        out = _loo_sign(x, mask_e) * acc
        if self.hard_limit:
            out = _partial_hard_limit(out)
        return out


class AminstarI8Arithmetic(_I8Base):
    """Quantized A-Min*-BP (arithmetic.rs:1129-1192): full min* fold (both
    correction lookups, saturating add) against non-minimum edges."""

    def _minstar_full(self, a, b):
        return jnp.maximum(
            jnp.minimum(a, b)
            - self._lookup(jnp.abs(a - b))
            + self._lookup(jnp.minimum(a + b, 127)),
            0,
        )

    def check_messages(self, x, mask=None):
        rows, d, batch = x.shape
        mask_e = None if mask is None else mask[..., None]
        mag = jnp.abs(x)
        masked_mag = mag if mask_e is None else jnp.where(mask_e, mag, 128)
        argmin = jnp.argmin(masked_mag, axis=1)
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (1, d, 1), 1)
            == argmin[:, None, :]
        )
        acc = jnp.zeros((rows, 1, batch), dtype=x.dtype)
        cnt = jnp.zeros((rows, 1, batch), dtype=jnp.int32)
        for k in range(d):
            vk = mag[:, k : k + 1, :]
            elig = ~onehot[:, k : k + 1, :]
            if mask is not None:
                elig = mask[:, k : k + 1, None] & elig
            first = elig & (cnt == 0)
            folded = self._minstar_full(acc, vk)
            acc = jnp.where(first, vk, jnp.where(elig, folded, acc))
            cnt = cnt + elig.astype(jnp.int32)
        delta = acc
        if self.hard_limit:
            delta_min_edge = _partial_hard_limit(delta)
        else:
            delta_min_edge = delta
        vmin = jnp.min(masked_mag, axis=1, keepdims=True)
        delta_others = self._minstar_full(delta, vmin)
        if self.hard_limit:
            delta_others = _partial_hard_limit(delta_others)
        magnitude = jnp.where(onehot, delta_min_edge, delta_others)
        return _loo_sign(x, mask_e) * magnitude
