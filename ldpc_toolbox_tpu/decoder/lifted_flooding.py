"""Flooding BP on the block-circulant (lifted) layout.

Same per-frame semantics as decoder/flooding.py, but messages are whole
``(Z, batch)`` planes per base edge and the inter-phase permutation is the
rolled plane gather of ops/plane_gather.py, which moves whole contiguous
``(batch,)`` rows. This is the flooding path for DVB-S2 (Z=360), 5G NR
(Z-lift), CCSDS AR4JA (Z=M/4) and C2 (Z=511).

Incomplete circulants (e.g. the missing corner of the DVB-S2 staircase at
row 0, codes/dvbs2.py) are neutralized per lane: +inf into the check-side
fold (exact for the float rules; 127 for i8, a one-lane approximation) and
0 into the variable-side sum (exact).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.plane_gather import plane_gather
from .lifted import LiftedGraph

__all__ = ["lifted_flooding_decode"]


def _neutral_big(arithmetic):
    if arithmetic.is_int8:
        return jnp.asarray(127, arithmetic.compute_dtype)
    return jnp.asarray(jnp.inf, arithmetic.compute_dtype)


def _bucket_offsets(buckets):
    sizes = [len(b.groups) * b.degree for b in buckets]
    return np.cumsum([0] + sizes)


def _locate(buckets, position):
    """Map a flat edge position to (bucket index, row, slot)."""
    offs = _bucket_offsets(buckets)
    for i, b in enumerate(buckets):
        if offs[i] <= position < offs[i + 1]:
            rel = position - offs[i]
            return i, rel // b.degree, rel % b.degree
    raise ValueError(position)


def lifted_flooding_decode(
    lg: LiftedGraph,
    arithmetic,
    llrs,
    max_iterations: int,
):
    """Decode a (B, n) batch of channel LLRs on a lifted graph.

    Returns a dict of device arrays: ``codeword`` (B, n) uint8,
    ``iterations`` (B,) int32 (0 when the input already satisfies H,
    ``max_iterations`` on failure) and ``success`` (B,) bool.
    """
    Z = lg.Z
    B = llrs.shape[0]
    vb, cb = lg.var_buckets, lg.chk_buckets

    def gather(src, side):
        return plane_gather(src, side.planes, side.shifts)

    # channel LLRs as planes (VG, Z, B) in var-bucket group order
    col_of = lg.var_cols[lg.var_group_order]  # (VG, Z) original column
    llr_planes = llrs.T[jnp.asarray(col_of.reshape(-1))].reshape(
        lg.num_var_groups, Z, B
    )

    # missing-lane fixups, located per side
    chk_fix = []  # (bucket, row, slot, lanes)
    var_fix = []
    for vm_posn, cm_posn, lanes_c, lanes_v in lg.missing:
        ib, row, slot = _locate(cb, cm_posn)
        chk_fix.append((ib, row, slot, np.asarray(lanes_c)))
        ibv, rowv, slotv = _locate(vb, vm_posn)
        var_fix.append((ibv, rowv, slotv, np.asarray(lanes_v)))

    # group-plane row ranges per var bucket
    vg_starts = np.cumsum([0] + [len(b.groups) for b in vb])

    q_planes = arithmetic.quantize(llr_planes)  # (VG, Z, B)
    q_parts = [
        q_planes[vg_starts[i] : vg_starts[i + 1]] for i in range(len(vb))
    ]

    store = arithmetic.storage_dtype
    compute = arithmetic.compute_dtype
    big = _neutral_big(arithmetic)

    def check_satisfied(hard):
        """hard: (VG, Z, B) bool planes -> (B,) all-checks-satisfied."""
        bits = hard.astype(jnp.int8)
        bad = None
        for i, b in enumerate(cb):
            if b.degree == 0 or len(b.groups) == 0:
                continue
            g = plane_gather(
                bits, b.var_group_pos, b.shifts
            )  # (G, d, Z, B)
            for ib, row, slot, lanes in chk_fix:
                if ib == i:
                    g = g.at[row, slot, jnp.asarray(lanes)].set(0)
            syn = (jnp.sum(g, axis=1, dtype=jnp.int32) & 1).astype(bool)
            any_bad = jnp.any(syn, axis=(0, 1))
            bad = any_bad if bad is None else (bad | any_bad)
        if bad is None:
            return jnp.ones(B, bool)
        return ~bad

    hard0 = llr_planes <= 0
    ok0 = check_satisfied(hard0)

    # v2c0: each edge's plane starts as its variable group's channel LLRs
    v2c0 = jnp.concatenate(
        [
            jnp.repeat(q_parts[i], b.degree, axis=0)
            for i, b in enumerate(vb)
            if b.degree > 0 and len(b.groups)
        ]
    ).astype(store)

    def iterate(v2c):
        c2v_parts = []
        for i, b in enumerate(cb):
            if b.degree == 0 or len(b.groups) == 0:
                continue
            x = gather(v2c, b).astype(compute)  # (G, d, Z, B)
            for ib, row, slot, lanes in chk_fix:
                if ib == i:
                    x = x.at[row, slot, jnp.asarray(lanes)].set(big)
            G, d = len(b.groups), b.degree
            out = arithmetic.check_messages(x.reshape(G, d, Z * B))
            c2v_parts.append(out.reshape(G * d, Z, B).astype(store))
        c2v = jnp.concatenate(c2v_parts)

        v2c_parts = []
        llr_parts = []
        for i, b in enumerate(vb):
            if len(b.groups) == 0:
                continue
            if b.degree == 0:
                llr_parts.append(q_parts[i])
                continue
            y = gather(c2v, b).astype(compute)
            for ib, row, slot, lanes in var_fix:
                if ib == i:
                    y = y.at[row, slot, jnp.asarray(lanes)].set(0)
            G, d = len(b.groups), b.degree
            v2c_b, llr_b = arithmetic.var_update(
                q_parts[i].reshape(G, Z * B), y.reshape(G, d, Z * B)
            )
            v2c_parts.append(v2c_b.reshape(G * d, Z, B).astype(store))
            llr_parts.append(llr_b.reshape(G, Z, B))
        v2c_new = jnp.concatenate(v2c_parts)
        out_llr = jnp.concatenate(llr_parts)
        return v2c_new, out_llr

    def body(state):
        it, v2c, _hard, converged, iters, frozen = state
        v2c_new, out_llr = iterate(v2c)
        hard = arithmetic.hard_decision(out_llr)
        ok = check_satisfied(hard)
        newly = ok & ~converged
        it = it + 1
        iters = jnp.where(newly, it, iters)
        frozen = jnp.where(newly[None, None, :], hard, frozen)
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

    hard_planes = jnp.where(converged[None, None, :], frozen, hard_final)
    # map (VG, Z) planes back to original column order
    inv = np.empty(lg.n, np.int64)
    inv[col_of.reshape(-1)] = np.arange(lg.num_var_groups * Z)
    codeword = hard_planes.reshape(lg.num_var_groups * Z, B)[
        jnp.asarray(inv)
    ]
    iters = jnp.where(converged, iters, max_iterations)
    return {
        "codeword": codeword.T.astype(jnp.uint8),
        "iterations": iters,
        "success": converged,
    }
