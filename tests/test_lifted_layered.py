"""Lifted horizontal-layered schedule: scalar serial oracle in layer
order, the convergence-speed property, and i8 decoding on C2."""

import numpy as np
import pytest

import jax.numpy as jnp

from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
from ldpc_toolbox_tpu.decoder.factory import make_arithmetic
from ldpc_toolbox_tpu.decoder.lifted import (
    LiftedGraph,
    lifted_graph_for,
    nr5g_maps,
)
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode
from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode


def _llrs(n, batch, sigma, seed):
    rng = np.random.default_rng(seed)
    x = -1.0 + sigma * rng.standard_normal((batch, n))
    return jnp.asarray((-2.0 / sigma**2) * x, jnp.float32)


def _scalar_layered_minsum(h_dense, llr, layer_rows, max_iter):
    """Serial per-check horizontal-layered min-sum oracle
    (horizontal_layered.rs:49-110) processing checks in the given row
    order; float32 scalar arithmetic (matches the jnp path bitwise on a
    duplicate-free code), min-sum check rule."""
    m, n = h_dense.shape
    qv = llr.astype(np.float32).copy()
    rcv = {}
    rows_vars = [np.nonzero(h_dense[r])[0] for r in range(m)]

    def check_ok(hard):
        return not ((h_dense @ hard) % 2).any()

    hard = (qv <= 0).astype(np.uint8)
    if check_ok(hard):
        return hard, 0, True
    for it in range(1, max_iter + 1):
        for r in layer_rows:
            vs = rows_vars[r]
            x = np.array(
                [qv[v] - rcv.get((r, v), np.float32(0)) for v in vs],
                np.float32,
            )
            mags = np.abs(x)
            signs = np.sign(x) + (x == 0)  # zero counts as +
            par = np.prod(signs)
            order = np.argsort(mags, kind="stable")
            m1, m2 = mags[order[0]], mags[order[1]]
            for i, v in enumerate(vs):
                loo = m2 if i == order[0] else m1
                rnew = (par * signs[i]) * loo
                qv[v] += rnew - rcv.get((r, v), np.float32(0))
                rcv[(r, v)] = rnew
        hard = (qv <= 0).astype(np.uint8)
        if check_ok(hard):
            return hard, it, True
    return hard, max_iter, False


def test_jnp_layered_matches_scalar_oracle():
    """On a code with complete circulants and no duplicate (vg, cg)
    pairs, the lifted layer-parallel sweep equals the serial per-check
    sweep in layer order: validate against a scalar min-sum oracle."""
    bg = BaseGraph.BG2
    z = 16
    vm, cm, Z, nvg, ncg = nr5g_maps(bg, z)
    h = bg.h(z)
    lg = LiftedGraph.from_sparse(h, vm, cm, Z, nvg, ncg)
    pairs = list(zip(lg.edge_vg.tolist(), lg.edge_cg.tolist()))
    assert len(pairs) == len(set(pairs)), "oracle needs no duplicates"
    assert not lg.missing

    # map flat group index -> original check group id (bucket order)
    group_ids = np.concatenate(
        [b.groups for b in lg.chk_buckets if len(b.groups)]
    )
    layer_rows = [
        cg * Z + lane for cg in group_ids for lane in range(Z)
    ]

    dense = np.zeros((h.num_rows, h.num_cols), np.int64)
    for r, c in h.iter_all():
        dense[r, c] = 1

    batch = 6
    llr = _llrs(h.num_cols, batch, 0.62, seed=9)
    _, a = make_arithmetic("Minsumf32")
    out = lifted_layered_decode(lg, a, llr, 8)

    llr_np = np.asarray(llr, np.float32)
    for b in range(batch):
        hard, iters, ok = _scalar_layered_minsum(
            dense, llr_np[b], layer_rows, 8
        )
        assert ok == bool(np.asarray(out["success"])[b])
        assert iters == int(np.asarray(out["iterations"])[b])
        np.testing.assert_array_equal(
            hard, np.asarray(out["codeword"])[b]
        )


def test_layered_converges_faster_than_flooding():
    """The reference's motivation for the layered schedule: ~2x fewer
    iterations at the same quality (horizontal_layered.rs docs)."""
    code = DvbCode.R1_4short
    lg = lifted_graph_for(code)
    llr = _llrs(code.n, 64, 0.9, seed=7)
    _, a = make_arithmetic("Minsumf32")
    ol = lifted_layered_decode(lg, a, llr, 20)
    of = lifted_flooding_decode(lg, a, llr, 20)
    sl = np.asarray(ol["success"])
    sf = np.asarray(of["success"])
    assert sl.sum() >= sf.sum()
    both = sl & sf
    il = np.asarray(ol["iterations"])[both].mean()
    if_ = np.asarray(of["iterations"])[both].mean()
    assert il <= 0.65 * if_, (il, if_)


def test_layered_i8_recovers_c2_codewords():
    """The plain lifted layered decode with an i8 rule on CCSDS C2 (the
    only unaligned lift, Z = 511, with two circulants per block) recovers
    the sent codewords at high SNR. C2's trailing square is singular, so
    messages encode on the full-rank rows of H with a systematic column
    permutation, as the ber harness does."""
    from ldpc_toolbox_tpu.codes.ccsds import C2Code
    from ldpc_toolbox_tpu.encoder import Encoder
    from ldpc_toolbox_tpu.systematic import (
        full_rank_rows,
        permute_columns,
        systematic_permutation,
    )

    code = C2Code()
    lg = lifted_graph_for(code)
    assert lg.Z == 511
    h_enc = full_rank_rows(code.h())
    perm = np.asarray(systematic_permutation(h_enc))
    enc = Encoder(permute_columns(h_enc, perm))
    rng = np.random.default_rng(12)
    msgs = rng.integers(0, 2, size=(8, enc.k), dtype=np.uint8)
    cw = np.asarray(enc.encode_batch(msgs))[:, np.argsort(perm)]
    sigma = 0.45
    x = np.where(cw == 0, -1.0, 1.0) + sigma * rng.standard_normal(cw.shape)
    llr = jnp.asarray((-2.0 / sigma**2) * x, jnp.float32)
    _, a = make_arithmetic("HLMinstarapproxi8")
    out = lifted_layered_decode(lg, a, llr, 20)
    assert np.asarray(out["success"]).all()
    np.testing.assert_array_equal(np.asarray(out["codeword"]), cw)
    assert (np.asarray(out["iterations"]) > 0).all()


@pytest.mark.parametrize("code", ["R1_2", "R1_4short", "R9_10"])
def test_duplicate_merge_gives_one_addend_per_group(code):
    """DVB-S2 layers can meet a variable group twice. The merge tables
    fold those deltas into the group's first slot and zero the rest, so
    the layered Qv scatter-add sees one nonzero addend per group — the
    same per-group sums, in whatever order the device applies them."""
    from ldpc_toolbox_tpu.decoder.lifted_layered import _duplicate_merge
    from ldpc_toolbox_tpu.decoder.lifted_layout import build_lifted_layout

    layout = build_lifted_layout(lifted_graph_for(DvbCode[code]))
    rng = np.random.default_rng(2)
    merged_any = False
    for m in layout.chk_meta:
        merge = _duplicate_merge(layout, m)
        if merge is None:
            continue
        merged_any = True
        partners, first = (np.asarray(t) for t in merge)
        for j in range(m.g1 - m.g0):
            vgs = layout.syn_vg[m.ebase + j * m.d : m.ebase + (j + 1) * m.d]
            delta = rng.integers(-50, 50, size=m.d)
            padded = np.append(delta, 0)
            out = delta.copy()
            for k in range(partners.shape[1]):
                out = out + padded[partners[j, k]]
            out = np.where(first[j], out, 0)
            want, got = np.zeros(layout.VG, int), np.zeros(layout.VG, int)
            np.add.at(want, vgs, delta)
            np.add.at(got, vgs, out)
            np.testing.assert_array_equal(got, want)
            for g in np.unique(vgs):
                assert np.count_nonzero(first[j][vgs == g]) == 1
    assert merged_any
