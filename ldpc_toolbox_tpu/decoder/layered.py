"""Horizontal-layered belief propagation, batched over codewords.

Rebuild of the reference's serial per-check schedule
(``decoder/horizontal_layered.rs``; Sharon/Litsyn/Goldberg): state is the
variable posteriors Qv and per-edge check messages Rcv; each check node
subtracts its old message, recomputes, and updates Qv in place
(horizontal_layered.rs:105-110).

Here the serial sweep becomes a ``lax.scan`` over *layers* — groups of
variable-disjoint checks extracted by order-preserving layering
(decoder/layout.extract_layers): every conflicting row pair executes in
increasing row index, so the schedule is serial-equivalent to the
reference's 0..m sweep — bit-identical messages, iteration counts and
codewords for the integer arithmetics (cross-validated against the scalar
C++ shim in tests/test_capi.py).

The whole sweep is scatter-free, so its result never depends on the
order in which a scatter applies its updates: Rcv is stored layer-major ``(L, R, dc, B)`` and *flows
through* the scan (xs -> ys), and the Qv update is a **gather** — each
layer's masked deltas flatten to ``(R*dc + 1, B)`` and a host-precomputed
``(L, n+1)`` source table maps every variable to its updating slot (or the
zero sentinel), exploiting that a variable is touched at most once per
layer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .flooding import _check_satisfied
from .layout import DecodeGraph

__all__ = ["layered_decode"]


def layered_decode(graph: DecodeGraph, arithmetic, llrs, max_iterations: int):
    """Decode a batch of LLR frames with the horizontal-layered schedule.

    Same contract as :func:`flooding_decode`.
    """
    assert graph.layers is not None, "DecodeGraph built without layers"
    m, n, dc = graph.m, graph.n, graph.dc_max

    layers = np.asarray(graph.layers)  # (L, R) padded with m
    L, R = layers.shape

    # host-side: layer-major check tables (sentinel row m -> var n, mask 0)
    chk_vars_ext = np.concatenate(
        [np.asarray(graph.chk_vars), np.full((1, dc), n, np.int32)]
    )
    chk_mask_ext = np.concatenate(
        [np.asarray(graph.chk_mask), np.zeros((1, dc), bool)]
    )
    vars_lm = chk_vars_ext[layers]  # (L, R, dc)
    mask_lm = chk_mask_ext[layers]  # (L, R, dc)

    # host-side: per-layer gather source for the Qv update. Variables in a
    # layer are check-disjoint, so each var has at most one updating slot;
    # unmentioned vars (and the sentinel var n) read the zero row R*dc.
    src_lm = np.full((L, n + 1), R * dc, np.int32)
    flat_vars = vars_lm.reshape(L, R * dc)
    flat_mask = mask_lm.reshape(L, R * dc)
    for li in range(L):
        v = flat_vars[li][flat_mask[li]]
        src_lm[li, v] = np.nonzero(flat_mask[li])[0]

    vars_lm = jnp.asarray(vars_lm)
    mask_lm = jnp.asarray(mask_lm)
    src_lm = jnp.asarray(src_lm)
    chk_vars = jnp.asarray(graph.chk_vars)

    llr_t = llrs.T  # (n, B)
    B = llr_t.shape[1]

    hard0 = llr_t <= 0
    ok0 = _check_satisfied(graph, hard0, chk_vars)

    store = arithmetic.storage_dtype
    compute = arithmetic.compute_dtype
    qv_store = arithmetic.var_llr_storage_dtype

    q = arithmetic.quantize(llr_t)
    qv0 = arithmetic.llr_to_var_llr(q).astype(qv_store)
    # Qv with a sentinel variable row (read by padded slots, never written)
    qv0 = jnp.concatenate([qv0, jnp.zeros((1, B), qv0.dtype)])
    rcv0 = jnp.zeros((L, R, dc, B), store)

    def layer_step(qv, xs):
        rold_s, vars_rd, mask_rd, src = xs
        qv_g = (
            qv[vars_rd.reshape(-1)]
            .reshape(R, dc, B)
            .astype(compute)
        )
        rold = rold_s.astype(compute)
        x = arithmetic.layered_x(qv_g, rold)
        rnew = arithmetic.check_messages(x, mask_rd)
        rnew = jnp.where(mask_rd[..., None], rnew, rold)
        delta = arithmetic.layered_qv_delta(rnew, rold)
        delta = jnp.where(mask_rd[..., None], delta, 0)
        delta_flat = jnp.concatenate(
            [delta.reshape(R * dc, B), jnp.zeros((1, B), delta.dtype)]
        )
        qv = qv + delta_flat[src].astype(qv.dtype)
        return qv, rnew.astype(store)

    def sweep(qv, rcv):
        qv, rcv = jax.lax.scan(
            layer_step, qv, (rcv, vars_lm, mask_lm, src_lm)
        )
        return qv, rcv

    def body(state):
        it, qv, rcv, _hard, converged, iters, frozen = state
        qv, rcv = sweep(qv, rcv)
        out_llr = arithmetic.var_llr_to_llr(qv[:n].astype(compute))
        hard = arithmetic.hard_decision(out_llr)
        ok = _check_satisfied(graph, hard, chk_vars)
        newly = ok & ~converged
        it = it + 1
        iters = jnp.where(newly, it, iters)
        frozen = jnp.where(newly[None, :], hard, frozen)
        return (it, qv, rcv, hard, converged | ok, iters, frozen)

    def cond(state):
        it = state[0]
        converged = state[4]
        return (it < max_iterations) & ~jnp.all(converged)

    init = (
        jnp.int32(0),
        qv0,
        rcv0,
        hard0,
        ok0,
        jnp.zeros(B, jnp.int32),
        hard0,
    )
    it, _qv, _rcv, hard_final, converged, iters, frozen = jax.lax.while_loop(
        cond, body, init
    )

    codeword = jnp.where(converged[None, :], frozen, hard_final)
    iters = jnp.where(converged, iters, max_iterations)
    return {
        "codeword": codeword.T.astype(jnp.uint8),
        "iterations": iters,
        "success": converged,
    }
