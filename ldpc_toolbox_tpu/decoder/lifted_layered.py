"""Horizontal-layered BP on the block-circulant (lifted) layout.

The reference's fast-convergence schedule (horizontal_layered.rs:49-110)
sweeps check nodes serially: x = Qv - Rcv, recompute Rcv, update Qv in
place. On the lifted layout a *layer* is one check group — Z structurally
parallel checks (one circulant row block): within a layer every check
touches a distinct lane of each incident variable group, so the parallel
update matches the serial one except when a layer contains two base edges
into the same variable group (possible in DVB-S2); those deltas sum
against the layer-entry Qv (added to each other first, in slot order, so
the result does not depend on the order a scatter applies them), which
changes the bit pattern but not the convergence class (the same caveat
as the generic greedy-colored schedule, ARCHITECTURE.md "Known
divergences").

Layer order is check-bucket-major (the layout's flat group order,
decoder/lifted_layout.py), not the reference's 0..m row sweep — the
reference's row r = a + b*q ordering interleaves groups and cannot be
parallelized as written. Each bucket's layers run as one `lax.scan`:
plane gathers, lane rolls, the check rule, and the Qv update.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .lifted import LiftedGraph
from .lifted_layout import build_lifted_layout

__all__ = ["lifted_layered_decode"]


def _planes_of(lg, llrs, dtype):
    """Channel LLRs as (VG, Z, B) planes in var-bucket group order."""
    Z = lg.Z
    col_of = lg.var_cols[lg.var_group_order]
    VG = lg.num_var_groups
    B = llrs.shape[0]
    planes = (
        llrs.astype(dtype)
        .T[jnp.asarray(col_of.reshape(-1))]
        .reshape(VG, Z, B)
    )
    return planes, col_of


def _codeword_from_planes(lg, col_of, hard_planes):
    Z = lg.Z
    VG = lg.num_var_groups
    inv = np.empty(lg.n, np.int64)
    inv[col_of.reshape(-1)] = np.arange(VG * Z)
    B = hard_planes.shape[-1]
    return hard_planes.reshape(VG * Z, B)[jnp.asarray(inv)].T.astype(
        jnp.uint8
    )


def _duplicate_merge(layout, m):
    """Static tables that merge a layer's edges into one variable group.

    Returns None when no layer of bucket ``m`` meets a variable group
    twice; else ``(partners, first)``: ``partners[j, k, t]`` is the slot of
    layer ``j`` whose delta slot ``t`` adds k-th (``m.d``, a zero pad, when
    there is none) and ``first[j, t]`` is whether slot ``t`` is the first
    of its group in the layer.
    """
    layers = m.g1 - m.g0
    vgs = layout.syn_vg[m.ebase : m.ebase + layers * m.d].reshape(layers, m.d)
    later = [
        [[s for s in range(t + 1, m.d) if row[s] == row[t]] for t in range(m.d)]
        for row in vgs
    ]
    first = np.array(
        [[row[t] not in row[:t] for t in range(m.d)] for row in vgs.tolist()]
    )
    if first.all():
        return None
    K = max(len(p) for lay in later for p in lay)
    partners = np.full((layers, K, m.d), m.d, np.int32)
    for j, lay in enumerate(later):
        for t, p in enumerate(lay):
            if first[j, t]:
                partners[j, : len(p), t] = p
    return jnp.asarray(partners), jnp.asarray(first)


def lifted_layered_decode(lg: LiftedGraph, arithmetic, llrs,
                          max_iterations: int):
    """Decode a (B, n) batch of channel LLRs, layered schedule, lifted
    layout. Same output contract as lifted_flooding_decode."""
    Z = lg.Z
    B = llrs.shape[0]
    layout = build_lifted_layout(lg)
    E, VG = layout.E, layout.VG
    compute = arithmetic.compute_dtype
    store = arithmetic.storage_dtype
    qv_store = arithmetic.var_llr_storage_dtype
    big = 127 if arithmetic.is_int8 else jnp.asarray(jnp.inf, compute)

    llr_planes, col_of = _planes_of(lg, llrs, jnp.float32)
    q = arithmetic.quantize(llr_planes)
    qv0 = arithmetic.llr_to_var_llr(q).astype(qv_store)
    rcv0 = jnp.zeros((E, Z, B), store)

    vg_arr = jnp.asarray(layout.syn_vg)
    rot_arr = jnp.asarray(layout.syn_rot)  # +s (var -> check coords)
    mask_arr = jnp.asarray(layout.syn_mask)
    lane = jnp.arange(Z)[None, :, None]

    def check_ok(bits):
        """(VG, Z, B) int8 -> (B,) all checks satisfied."""
        g = bits[vg_arr].astype(jnp.int8)  # (E, Z, B)
        idx = (jnp.arange(Z)[None, :] - rot_arr[:, None]) % Z
        rolled = jnp.take_along_axis(g, idx[..., None], axis=1)
        rolled = jnp.where(lane == mask_arr[:, None, None], 0, rolled)
        bad = None
        for m in layout.chk_meta:
            blk = rolled[m.ebase : m.ebase + (m.g1 - m.g0) * m.d]
            syn = (
                jnp.sum(
                    blk.reshape(m.g1 - m.g0, m.d, Z, B),
                    axis=1,
                    dtype=jnp.int32,
                )
                & 1
            )
            any_bad = jnp.any(syn.astype(bool), axis=(0, 1))
            bad = any_bad if bad is None else bad | any_bad
        return jnp.ones(B, bool) if bad is None else ~bad

    hard0 = llr_planes <= 0
    ok0 = check_ok(hard0.astype(jnp.int8))

    def sweep(qv, rcv):
        for m in layout.chk_meta:
            d = m.d
            merge = _duplicate_merge(layout, m)

            def step(carry, j, m=m, d=d, merge=merge):
                qv, rcv = carry
                e0 = m.ebase + j * d
                vgs = jax.lax.dynamic_slice(vg_arr, (e0,), (d,))
                rots = jax.lax.dynamic_slice(rot_arr, (e0,), (d,))
                masks = jax.lax.dynamic_slice(mask_arr, (e0,), (d,))
                qv_g = qv[vgs].astype(compute)  # (d, Z, B)
                idx_vc = (jnp.arange(Z)[None, :] - rots[:, None]) % Z
                qv_c = jnp.take_along_axis(qv_g, idx_vc[..., None], axis=1)
                rold = jax.lax.dynamic_slice(
                    rcv, (e0, 0, 0), (d, Z, B)
                ).astype(compute)
                x = arithmetic.layered_x(qv_c, rold)
                x = jnp.where(lane == masks[:, None, None], big, x)
                rnew = arithmetic.check_messages(
                    x.reshape(1, d, Z * B)
                ).reshape(d, Z, B)
                rnew = jnp.where(lane == masks[:, None, None], 0, rnew)
                delta = arithmetic.layered_qv_delta(rnew, rold)
                idx_cv = (jnp.arange(Z)[None, :] + rots[:, None]) % Z
                delta_v = jnp.take_along_axis(
                    delta, idx_cv[..., None], axis=1
                )
                if merge is not None:
                    # a variable group met twice in this layer: its later
                    # slots' deltas join the first slot's, in slot order,
                    # and leave zeros behind, so the scatter-add below
                    # adds one nonzero plane per group — the same result
                    # in whatever order it applies its updates
                    # (atomically on the GPU)
                    partners, first = merge[0][j], merge[1][j]
                    padded = jnp.concatenate(
                        [delta_v, jnp.zeros_like(delta_v[:1])]
                    )
                    for k in range(partners.shape[0]):
                        delta_v = delta_v + padded[partners[k]]
                    delta_v = jnp.where(first[:, None, None], delta_v, 0)
                qv = qv.at[vgs].add(delta_v.astype(qv.dtype))
                rcv = jax.lax.dynamic_update_slice(
                    rcv, rnew.astype(store), (e0, 0, 0)
                )
                return (qv, rcv), None

            (qv, rcv), _ = jax.lax.scan(
                step, (qv, rcv), jnp.arange(m.g1 - m.g0)
            )
        return qv, rcv

    def body(state):
        it, qv, rcv, _hard, converged, iters, frozen = state
        qv, rcv = sweep(qv, rcv)
        out_llr = arithmetic.var_llr_to_llr(qv.astype(compute))
        hard = arithmetic.hard_decision(out_llr)
        ok = check_ok(hard.astype(jnp.int8))
        newly = ok & ~converged
        it = it + 1
        iters = jnp.where(newly, it, iters)
        frozen = jnp.where(newly[None, None, :], hard, frozen)
        return (it, qv, rcv, hard, converged | ok, iters, frozen)

    def cond(state):
        return (state[0] < max_iterations) & ~jnp.all(state[4])

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
    hard_planes = jnp.where(converged[None, None, :], frozen, hard_final)
    iters = jnp.where(converged, iters, max_iterations)
    return {
        "codeword": _codeword_from_planes(lg, col_of, hard_planes),
        "iterations": iters,
        "success": converged,
    }
