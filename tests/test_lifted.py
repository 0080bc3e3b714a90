"""Block-circulant (lifted) decode path tests.

Validates structure detection on all four standards families, equivalence
of the lifted flooding decoder with the generic bucketed one, and correct
handling of incomplete circulants (the DVB-S2 staircase corner).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ldpc_toolbox_tpu.codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate, C2Code
from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
from ldpc_toolbox_tpu.decoder import DecodeGraph
from ldpc_toolbox_tpu.decoder.factory import make_arithmetic
from ldpc_toolbox_tpu.decoder.flooding import flooding_decode
from ldpc_toolbox_tpu.decoder.lifted import (
    LiftedGraph,
    ar4ja_maps,
    c2_maps,
    dvbs2_maps,
    nr5g_maps,
)
from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode
from ldpc_toolbox_tpu.decoder.lifted_layout import build_lifted_layout
from ldpc_toolbox_tpu.encoder import Encoder
from ldpc_toolbox_tpu.ops.plane_gather import plane_gather_reference
from ldpc_toolbox_tpu.sparse import SparseMatrix


def test_plane_gather_reference_semantics():
    rng = np.random.default_rng(0)
    P, Z, B = 5, 12, 4
    src = jnp.asarray(rng.standard_normal((P, Z, B)), jnp.float32)
    planes = np.array([[0, 3], [4, 2]], np.int32)
    shifts = np.array([[0, 5], [11, 1]], np.int32)
    out = np.asarray(plane_gather_reference(src, planes, shifts))
    srcn = np.asarray(src)
    for g in range(2):
        for t in range(2):
            for l in range(Z):
                np.testing.assert_array_equal(
                    out[g, t, l], srcn[planes[g, t], (l - shifts[g, t]) % Z]
                )


def _lifted_for(code):
    if isinstance(code, DvbCode):
        vm, cm, Z, nvg, ncg = dvbs2_maps(code)
    elif isinstance(code, AR4JACode):
        vm, cm, Z, nvg, ncg = ar4ja_maps(code)
    elif isinstance(code, C2Code):
        vm, cm, Z, nvg, ncg = c2_maps()
    else:
        bg, z = code
        vm, cm, Z, nvg, ncg = nr5g_maps(bg, z)
        return LiftedGraph.from_sparse(bg.h(z), vm, cm, Z, nvg, ncg), bg.h(z)
    h = code.h()
    return LiftedGraph.from_sparse(h, vm, cm, Z, nvg, ncg), h


def test_structure_detection_all_families():
    lg, _ = _lifted_for(DvbCode.R8_9short)
    assert lg.Z == 360
    assert len(lg.missing) == 1  # the staircase corner at row 0
    # every edge is accounted for: planes of all check buckets = BE
    assert sum(len(b.groups) * b.degree for b in lg.chk_buckets) == (
        lg.num_base_edges
    )

    lg, h = _lifted_for((BaseGraph.BG2, 16))
    assert lg.num_base_edges == 197 and not lg.missing

    lg, _ = _lifted_for(AR4JACode(AR4JARate.R1_2, AR4JAInfoSize.K1024))
    assert lg.Z == 128 and not lg.missing

    lg, _ = _lifted_for(C2Code())
    assert lg.Z == 511 and lg.num_base_edges == 64 and not lg.missing


def _noisy_codeword_llrs(h, batch, sigma, seed):
    enc = Encoder(h)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, size=(batch, enc.k))
    cw = np.asarray(enc.encode_batch(msgs))
    x = np.where(cw == 0, -1.0, 1.0) + sigma * rng.standard_normal(cw.shape)
    return msgs, jnp.asarray((-2.0 / sigma**2) * x, jnp.float32)


@pytest.mark.parametrize("impl", ["Minsumf32", "Phif32"])
def test_lifted_matches_generic_dvbs2(impl):
    code = DvbCode.R8_9short
    h = code.h()
    graph = DecodeGraph.from_sparse(h, build_layers=False)
    lg, _ = _lifted_for(code)
    # sigma chosen so most frames converge in a few iterations (r=8/9
    # needs ~4 dB); on non-converged frames min-sum magnitude *ties* are
    # broken by slot order, which legitimately differs between layouts
    msgs, llr = _noisy_codeword_llrs(h, 6, 0.47, seed=1)
    _, a1 = make_arithmetic(impl)
    _, a2 = make_arithmetic(impl)
    o1 = flooding_decode(graph, a1, llr, 30)
    o2 = lifted_flooding_decode(lg, a2, llr, 30)
    np.testing.assert_array_equal(
        np.asarray(o1["success"]), np.asarray(o2["success"])
    )
    np.testing.assert_array_equal(
        np.asarray(o1["iterations"]), np.asarray(o2["iterations"])
    )
    ok = np.asarray(o1["success"])
    assert ok.sum() >= 4
    np.testing.assert_array_equal(
        np.asarray(o1["codeword"])[ok], np.asarray(o2["codeword"])[ok]
    )


def test_lifted_corrects_errors_near_staircase_corner():
    """The incomplete circulant (row 0) must behave exactly like the true
    H: flip bits incident to check row 0 and decode."""
    code = DvbCode.R8_9short
    h = code.h()
    lg, _ = _lifted_for(code)
    enc = Encoder(h)
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, size=(1, enc.k))
    cw = np.asarray(enc.encode_batch(msg))[0]
    llr0 = np.where(cw == 0, 4.0, -4.0)
    row0 = list(h.iter_row(0))
    for flip in row0[:3] + [enc.k, h.num_cols - 1]:
        llr = llr0.copy()
        llr[flip] = -llr[flip] * 0.5
        _, a = make_arithmetic("Minstarapproxf32")
        out = lifted_flooding_decode(
            lg, a, jnp.asarray(llr[None, :], jnp.float32), 30,
            
        )
        assert bool(out["success"][0]), flip
        np.testing.assert_array_equal(np.asarray(out["codeword"][0]), cw)


@pytest.mark.parametrize(
    "family",
    ["nr5g", "ar4ja", "c2"],
)
def test_lifted_decodes_other_families(family):
    if family == "nr5g":
        lg, h = _lifted_for((BaseGraph.BG2, 16))
        # 5G NR H is not systematic-encodable as-is (first 2Z columns are
        # punctured high-degree); just check zero codeword + noise decode
        rng = np.random.default_rng(0)
        sigma = 0.5
        x = -1.0 + sigma * rng.standard_normal((4, h.num_cols))
        llr = jnp.asarray((-2.0 / sigma**2) * x, jnp.float32)
        _, a = make_arithmetic("Minsumf32")
        out = lifted_flooding_decode(lg, a, llr, 30)
        assert np.asarray(out["success"]).sum() >= 3
        assert not np.asarray(out["codeword"])[
            np.asarray(out["success"])
        ].any()
        return
    if family == "ar4ja":
        code = AR4JACode(AR4JARate.R4_5, AR4JAInfoSize.K1024)
    else:
        code = C2Code()
    lg, h = _lifted_for(code)
    rng = np.random.default_rng(0)
    # C2 is rate 7/8: needs low noise to converge reliably
    sigma = 0.42 if family == "ar4ja" else 0.45
    x = -1.0 + sigma * rng.standard_normal((4, h.num_cols))
    llr = jnp.asarray((-2.0 / sigma**2) * x, jnp.float32)
    _, a = make_arithmetic("Minsumf32")
    out = lifted_flooding_decode(lg, a, llr, 40)
    assert np.asarray(out["success"]).sum() >= 3
    decoded = np.asarray(out["codeword"])[np.asarray(out["success"])]
    assert not decoded.any()  # all-zero codeword recovered


_LAYOUT_FAMILIES = {
    "dvbs2_short": lambda: DvbCode.R1_4short,  # staircase corner
    "nr5g_bg1": lambda: (BaseGraph.BG1, 16),
    "nr5g_bg2": lambda: (BaseGraph.BG2, 16),
    "ar4ja": lambda: AR4JACode(AR4JARate.R1_2, AR4JAInfoSize.K1024),
    "c2": lambda: C2Code(),  # Z = 511, two circulants per block
}


def _maps_for(code):
    if isinstance(code, DvbCode):
        return dvbs2_maps(code), code.h()
    if isinstance(code, AR4JACode):
        return ar4ja_maps(code), code.h()
    if isinstance(code, C2Code):
        return c2_maps(), code.h()
    bg, z = code
    return nr5g_maps(bg, z), bg.h(z)


def _h_from_layout(lg, layout, chk_map):
    """Rebuild H from the layout's check-major edge tables alone, each row
    listing its columns in the layout's slot order (the check rule's fold
    order)."""
    group_ids = np.concatenate(
        [b.groups for b in lg.chk_buckets if len(b.groups)]
    )
    row_of = {chk_map(r): r for r in range(lg.m)}
    h = SparseMatrix(lg.m, lg.n)
    Z = layout.Z
    for m in layout.chk_meta:
        for g in range(m.g0, m.g1):
            for lane in range(Z):
                r = row_of[(int(group_ids[g]), lane)]
                for t in range(m.d):
                    e = m.ebase + (g - m.g0) * m.d + t
                    if layout.syn_mask[e] == lane:
                        continue
                    vg = lg.var_group_order[layout.syn_vg[e]]
                    col = lg.var_cols[vg, (lane - layout.syn_rot[e]) % Z]
                    h.insert(r, int(col))
    return h


@pytest.mark.parametrize("family", sorted(_LAYOUT_FAMILIES))
def test_lifted_layout_rebuilds_h(family):
    """The layered decode reads H only through the layout's chk_meta /
    syn_vg / syn_rot / syn_mask tables: they must describe H exactly,
    incomplete circulants included."""
    (vm, cm, Z, nvg, ncg), h = _maps_for(_LAYOUT_FAMILIES[family]())
    lg = LiftedGraph.from_sparse(h, vm, cm, Z, nvg, ncg)
    layout = build_lifted_layout(lg)
    assert layout.E == lg.num_base_edges and layout.VG == nvg
    assert (layout.syn_mask >= 0).sum() == len(lg.missing)
    rebuilt = _h_from_layout(lg, layout, cm)
    assert sorted(rebuilt.iter_all()) == sorted(h.iter_all())


@pytest.mark.parametrize("decoder", ["Minstarapproxi8", "Aminstari8"])
@pytest.mark.parametrize(
    "family,sigma", [("c2", 0.5), ("dvbs2_short", 0.95)]
)
def test_lifted_flooding_i8_bit_identical_to_generic(family, sigma, decoder):
    """The plain lifted flooding decode equals the generic flooding decode
    bit for bit on every frame, converged or not, for the i8 rules — on
    an H whose rows list their columns in the lifted slot order, since
    the i8 min* fold is order-dependent. C2 has the only unaligned lift
    (Z = 511); DVB-S2 has the incomplete staircase circulant."""
    (vm, cm, Z, nvg, ncg), h = _maps_for(_LAYOUT_FAMILIES[family]())
    lg = LiftedGraph.from_sparse(h, vm, cm, Z, nvg, ncg)
    graph = DecodeGraph.from_sparse(
        _h_from_layout(lg, build_lifted_layout(lg), cm), build_layers=False
    )
    rng = np.random.default_rng(6)
    x = -1.0 + sigma * rng.standard_normal((16, h.num_cols))
    llr = jnp.asarray((-2.0 / sigma**2) * x, jnp.float32)
    _, a = make_arithmetic(decoder)
    o1 = flooding_decode(graph, a, llr, 8)
    o2 = lifted_flooding_decode(lg, a, llr, 8)
    for k in ("success", "iterations", "codeword"):
        np.testing.assert_array_equal(np.asarray(o1[k]), np.asarray(o2[k]))
    # a mix: some frames converge, some run the whole budget
    assert 0 < np.asarray(o1["success"]).sum() < 16
