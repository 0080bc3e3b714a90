"""Flooding-schedule belief propagation, batched over codewords.

Batched rebuild of the reference's ``decoder/flooding.rs``: one
iteration = all check nodes then all variable nodes, with per-frame early
exit. A whole batch decodes in one ``lax.while_loop``; converged frames
freeze their output and iteration count the first time their hard decision
satisfies H (flooding.rs:57-79), matching the reference's per-frame
semantics while the batch keeps running until every frame converges or
``max_iterations`` is reached.

Data movement uses the *compact bucketed layout* (decoder/layout.py):
variables and checks are reordered by degree, messages live in exact
``(num_edges, batch)`` arrays (v2c variable-major, c2v check-major), and
one iteration is one static gather + unmasked arithmetic per degree
bucket in each direction — no padding slots, no masks, no sentinel rows.
Per-iteration HBM traffic is within ~2x of the 4*E*batch*sizeof(dtype)
lower bound for message passing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .layout import DecodeGraph

__all__ = ["flooding_decode"]


def _check_satisfied(graph: DecodeGraph, hard, chk_vars):
    """(B,) bool via the padded tables (layered schedule's path)."""
    bits = jnp.concatenate(
        [hard.astype(jnp.int32), jnp.zeros((1, hard.shape[1]), jnp.int32)]
    )
    g = bits[chk_vars.reshape(-1)].reshape(graph.m, graph.dc_max, -1)
    syndrome = jnp.sum(g, axis=1, dtype=jnp.int32) & 1  # (m, B)
    return ~jnp.any(syndrome.astype(bool), axis=0)


def _check_satisfied_buckets(chk_buckets, hard):
    """(B,) bool: hard (n, B) in bucket-reordered variable order."""
    bits = hard.astype(jnp.int32)
    bad = None
    for b in chk_buckets:
        if b.degree == 0 or len(b.ids) == 0:
            continue
        g = bits[b.vars.reshape(-1)].reshape(*b.vars.shape, -1)
        syndrome = (jnp.sum(g, axis=1, dtype=jnp.int32) & 1).astype(bool)
        any_bad = jnp.any(syndrome, axis=0)
        bad = any_bad if bad is None else (bad | any_bad)
    if bad is None:
        return jnp.ones(hard.shape[1], bool)
    return ~bad


def flooding_decode(graph: DecodeGraph, arithmetic, llrs, max_iterations: int):
    """Decode a batch of LLR frames.

    Args:
      graph: static decode layout.
      arithmetic: an ``Arithmetic`` instance.
      llrs: (B, n) float channel LLRs (positive -> bit 0).
      max_iterations: iteration cap.

    Returns:
      dict with ``codeword`` (B, n) uint8, ``iterations`` (B,) int32,
      ``success`` (B,) bool.
    """
    vb = graph.var_buckets
    cb = graph.chk_buckets
    var_order = jnp.asarray(graph.var_order)
    inv_var_order = jnp.asarray(graph.inv_var_order)

    # bucket-reordered channel LLRs
    llr_t = llrs.T[var_order]  # (n, B)
    B = llr_t.shape[1]

    # per-bucket row ranges of the reordered variable axis
    var_starts = np.cumsum([0] + [len(b.ids) for b in vb])
    # per-bucket row ranges of the v2c edge array
    v2c_starts = np.cumsum([0] + [len(b.ids) * b.degree for b in vb])

    # iteration-0 early exit on the raw channel LLRs (flooding.rs:56-64)
    hard0 = llr_t <= 0
    ok0 = _check_satisfied_buckets(cb, hard0)

    q = arithmetic.quantize(llr_t)  # (n, B) Llr, reordered
    q_parts = [
        q[var_starts[i] : var_starts[i + 1]] for i in range(len(vb))
    ]

    store = arithmetic.storage_dtype
    compute = arithmetic.compute_dtype

    # first variable messages are the channel LLRs (flooding.rs:93-99)
    v2c0 = jnp.concatenate(
        [
            jnp.repeat(q_parts[i], b.degree, axis=0)
            for i, b in enumerate(vb)
            if b.degree > 0 and len(b.ids)
        ]
    ).astype(store)

    chk_edge_idx = [jnp.asarray(b.edges.reshape(-1)) for b in cb]
    var_edge_idx = [jnp.asarray(b.edges.reshape(-1)) for b in vb]

    def iterate(v2c):
        # check phase: per-degree-bucket gather + unmasked arithmetic;
        # outputs concatenate straight into the check-major c2v array
        c2v_parts = []
        for i, b in enumerate(cb):
            if b.degree == 0 or len(b.ids) == 0:
                continue
            x = (
                v2c[chk_edge_idx[i]]
                .reshape(len(b.ids), b.degree, B)
                .astype(compute)
            )
            out = arithmetic.check_messages(x)
            c2v_parts.append(
                out.reshape(len(b.ids) * b.degree, B).astype(store)
            )
        c2v = jnp.concatenate(c2v_parts)

        # variable phase
        v2c_parts = []
        llr_parts = []
        for i, b in enumerate(vb):
            if len(b.ids) == 0:
                continue
            if b.degree == 0:
                llr_parts.append(q_parts[i])
                continue
            y = (
                c2v[var_edge_idx[i]]
                .reshape(len(b.ids), b.degree, B)
                .astype(compute)
            )
            v2c_b, llr_b = arithmetic.var_update(q_parts[i], y)
            v2c_parts.append(
                v2c_b.reshape(len(b.ids) * b.degree, B).astype(store)
            )
            llr_parts.append(llr_b)
        v2c_new = jnp.concatenate(v2c_parts)
        out_llr = jnp.concatenate(llr_parts)
        return v2c_new, out_llr

    def body(state):
        it, v2c, _hard, converged, iters, frozen = state
        v2c_new, out_llr = iterate(v2c)
        hard = arithmetic.hard_decision(out_llr)
        ok = _check_satisfied_buckets(cb, hard)
        newly = ok & ~converged
        it = it + 1
        iters = jnp.where(newly, it, iters)
        frozen = jnp.where(newly[None, :], hard, frozen)
        return (it, v2c_new, hard, converged | ok, iters, frozen)

    def cond(state):
        it, _v2c, _hard, converged, _iters, _frozen = state
        return (it < max_iterations) & ~jnp.all(converged)

    init = (
        jnp.int32(0),
        v2c0,
        hard0,
        ok0,
        jnp.zeros(B, jnp.int32),
        hard0,
    )
    it, _v2c, hard_final, converged, iters, frozen = jax.lax.while_loop(
        cond, body, init
    )

    codeword = jnp.where(converged[None, :], frozen, hard_final)
    # undo the degree-bucket variable reordering
    codeword = codeword[inv_var_order]
    iters = jnp.where(converged, iters, max_iterations)
    return {
        "codeword": codeword.T.astype(jnp.uint8),
        "iterations": iters,
        "success": converged,
    }
