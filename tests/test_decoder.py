"""Decoder tests: textbook fixtures + scalar-oracle cross-validation.

The oracle below is a literal scalar transcription of the reference
decoder's semantics (flooding.rs / horizontal_layered.rs / arithmetic.rs)
in pure Python. Running it against the batched JAX implementations on
random codes and LLRs validates the gather/mask vectorization:

* i8 families must match the oracle *exactly* (integer arithmetic with the
  reference's fold order);
* float families must agree on hard decisions and iteration counts
  (summation order differs at the ulp level).
"""

import math

import numpy as np
import pytest

from ldpc_toolbox_tpu.decoder import Decoder
from ldpc_toolbox_tpu.decoder.arithmetic import i8_correction_table
from ldpc_toolbox_tpu.decoder.factory import DECODER_IMPLEMENTATIONS
from ldpc_toolbox_tpu.mackay_neal import Config as MNConfig
from ldpc_toolbox_tpu.sparse import SparseMatrix


# ---------------------------------------------------------------------------
# Johnson worked example (flooding.rs:138-190)
# ---------------------------------------------------------------------------


def johnson_h():
    h = SparseMatrix(4, 6)
    h.insert_row(0, [0, 1, 3])
    h.insert_row(1, [1, 2, 4])
    h.insert_row(2, [0, 4, 5])
    h.insert_row(3, [2, 3, 5])
    return h


def to_llrs(bits):
    return np.where(np.asarray(bits) == 0, 1.3863, -1.3863)


def test_flooding_no_errors():
    dec = Decoder(johnson_h(), "Phif64")
    cw = np.array([0, 0, 1, 0, 1, 1], np.uint8)
    out = dec.decode(to_llrs(cw), 100)
    assert (out.codeword == cw).all()
    assert out.iterations == 0 and out.success


def test_flooding_single_error():
    dec = Decoder(johnson_h(), "Phif64")
    cw = np.array([0, 0, 1, 0, 1, 1], np.uint8)
    for j in range(6):
        bad = cw.copy()
        bad[j] ^= 1
        out = dec.decode(to_llrs(bad), 100)
        assert (out.codeword == cw).all(), j
        assert out.iterations == 1 and out.success


@pytest.mark.parametrize("impl", sorted(DECODER_IMPLEMENTATIONS))
def test_all_impls_correct_single_error(impl):
    dec = Decoder(johnson_h(), impl)
    cw = np.array([0, 0, 1, 0, 1, 1], np.uint8)
    out0 = dec.decode(to_llrs(cw), 100)
    assert (out0.codeword == cw).all() and out0.iterations == 0
    for j in range(6):
        bad = cw.copy()
        bad[j] ^= 1
        out = dec.decode(to_llrs(bad), 100)
        assert (out.codeword == cw).all() and out.success, (impl, j)


def test_batch_matches_single():
    dec = Decoder(johnson_h(), "Minstarapproxf32")
    cw = np.array([0, 0, 1, 0, 1, 1], np.uint8)
    frames = [to_llrs(cw)]
    for j in range(6):
        bad = cw.copy()
        bad[j] ^= 1
        frames.append(to_llrs(bad))
    batch = np.stack(frames)
    out = dec.decode_batch(batch, 100)
    for i, f in enumerate(frames):
        single = dec.decode(f, 100)
        assert (np.asarray(out["codeword"][i]) == single.codeword).all()
        assert int(out["iterations"][i]) == single.iterations
        assert bool(out["success"][i]) == single.success


def test_failure_reports_max_iters():
    # an unsatisfiable all-erasure input on a code with a degree-2 cycle
    h = SparseMatrix(2, 2)
    for j in range(2):
        for k in range(2):
            h.insert(j, k)
    dec = Decoder(h, "Phif64")
    out = dec.decode(np.array([-0.1, 0.1]), 7)
    assert not out.success
    assert out.iterations == 7


# ---------------------------------------------------------------------------
# Scalar oracle (reference-faithful)
# ---------------------------------------------------------------------------


class OraclePhi:
    MIN_X = 1e-30

    def quantize(self, llr):
        return float(llr)

    def phi(self, x):
        x = max(x, self.MIN_X)
        return -math.log(math.tanh(0.5 * x))

    def check_messages(self, msgs):
        sign = 0
        s = 0.0
        phis = []
        for x in msgs:
            p = self.phi(abs(x))
            phis.append(p)
            s += p
            if x < 0:
                sign ^= 1
        out = []
        for x, p in zip(msgs, phis):
            y = self.phi(s - p)
            sj = sign ^ 1 if x < 0 else sign
            out.append(y if sj == 0 else -y)
        return out

    def var_messages(self, input_llr, msgs):
        llr = input_llr + sum(msgs)
        return llr, [llr - m for m in msgs]

    def hard(self, llr):
        return llr <= 0


class OracleMinstarApprox(OraclePhi):
    def check_messages(self, msgs):
        out = []
        for j in range(len(msgs)):
            sign = 0
            acc = None
            for k, x in enumerate(msgs):
                if k == j:
                    continue
                if x < 0:
                    sign ^= 1
                x = abs(x)
                if acc is None:
                    acc = x
                else:
                    acc = max(min(x, acc) - math.log1p(math.exp(-abs(x - acc))), 0.0)
            out.append(acc if sign == 0 else -acc)
        return out


class OracleAminstar(OraclePhi):
    def _mstar(self, a, b):
        return (
            min(a, b)
            - math.log1p(math.exp(-abs(a - b)))
            + math.log1p(math.exp(-(a + b)))
        )

    def check_messages(self, msgs):
        mags = [abs(x) for x in msgs]
        argmin = mags.index(min(mags))
        sign = 0
        delta = None
        for j, x in enumerate(msgs):
            if x < 0:
                sign ^= 1
            if j != argmin:
                a = abs(x)
                delta = a if delta is None else self._mstar(delta, a)
        out = [None] * len(msgs)
        out[argmin] = -delta if (sign != 0) ^ (msgs[argmin] < 0) else delta
        vmin = mags[argmin]
        d2 = self._mstar(delta, vmin)
        for j, x in enumerate(msgs):
            if j != argmin:
                out[j] = -d2 if (sign != 0) ^ (x < 0) else d2
        return out


class OracleMinstarI8:
    def __init__(self, jones=False, hard_limit=False, deg1_clip=False):
        self.jones = jones
        self.hard_limit = hard_limit
        self.deg1_clip = deg1_clip
        self.table = i8_correction_table()

    def quantize(self, llr):
        x = 8.0 * llr
        if x >= 127.0:
            return 127
        if x <= -127.0:
            return -127
        return int(math.floor(abs(x) + 0.5) * (1 if x >= 0 else -1))

    @staticmethod
    def clip(x):
        return max(-127, min(127, x))

    def lookup(self, t):
        return int(self.table[t]) if t < 128 else 0

    def _phl(self, x):
        if not self.hard_limit:
            return x
        if x <= -100:
            return -127
        if x >= 100:
            return 127
        return x

    def check_messages(self, msgs):
        out = []
        for j in range(len(msgs)):
            sign = 0
            acc = None
            for k, x in enumerate(msgs):
                if k == j:
                    continue
                if x < 0:
                    sign ^= 1
                x = abs(x)
                if acc is None:
                    acc = x
                else:
                    acc = max(min(x, acc) - self.lookup(abs(x - acc)), 0)
            v = acc if sign == 0 else -acc
            out.append(self._phl(v))
        return out

    def var_messages(self, input_llr, msgs):
        if self.deg1_clip and len(msgs) == 1:
            input_llr = max(-116, min(116, input_llr))
        llr = input_llr + sum(msgs)
        if self.jones:
            llr = self.clip(llr)
        return self.clip(llr), [self.clip(llr - m) for m in msgs]

    def hard(self, llr):
        return llr <= 0


class OracleAminstarI8(OracleMinstarI8):
    def _mstar(self, a, b):
        return max(
            min(a, b) - self.lookup(abs(a - b)) + self.lookup(min(a + b, 127)), 0
        )

    def check_messages(self, msgs):
        mags = [abs(x) for x in msgs]
        argmin = mags.index(min(mags))
        sign = 0
        delta = None
        for j, x in enumerate(msgs):
            if x < 0:
                sign ^= 1
            if j != argmin:
                a = abs(x)
                delta = a if delta is None else self._mstar(delta, a)
        delta_hl = self._phl(delta)
        out = [None] * len(msgs)
        out[argmin] = (
            -delta_hl if (sign != 0) ^ (msgs[argmin] < 0) else delta_hl
        )
        d2 = self._phl(self._mstar(delta, mags[argmin]))
        for j, x in enumerate(msgs):
            if j != argmin:
                out[j] = -d2 if (sign != 0) ^ (x < 0) else d2
        return out


def oracle_flooding(h, llrs, max_iter, arith):
    """Literal scalar flooding decode (flooding.rs:51-126)."""
    n = h.num_cols
    rows = [h.row_list(r) for r in range(h.num_rows)]
    cols = [h.col_list(c) for c in range(n)]

    def check(llr_vec, hard):
        return all(sum(hard(llr_vec[v]) for v in row) % 2 == 0 for row in rows)

    if check(llrs, lambda x: x <= 0):
        return np.array([x <= 0 for x in llrs], np.uint8), 0, True
    sr = getattr(arith, "store_round", lambda x: x)
    q = [arith.quantize(x) for x in llrs]
    v2c = {(c, v): sr(q[v]) for v in range(n) for c in cols[v]}
    out_llr = list(q)
    for it in range(1, max_iter + 1):
        c2v = {}
        for c, row in enumerate(rows):
            outs = arith.check_messages([v2c[(c, v)] for v in row])
            for v, val in zip(row, outs):
                c2v[(c, v)] = sr(val)
        for v in range(n):
            llr, outs = arith.var_messages(q[v], [c2v[(c, v)] for c in cols[v]])
            out_llr[v] = llr
            for c, val in zip(cols[v], outs):
                v2c[(c, v)] = sr(val)
        if check(out_llr, arith.hard):
            return (
                np.array([arith.hard(x) for x in out_llr], np.uint8),
                it,
                True,
            )
    return np.array([arith.hard(x) for x in out_llr], np.uint8), max_iter, False


class OracleMinSum(OraclePhi):
    """Scalar (normalized) min-sum in float32, with optional bfloat16
    message-storage rounding — the framework's Minsum*/Normminsum*
    extensions (factory.py:74-81). Storage rounding applies wherever the
    batched path casts to storage_dtype (flooding.py:95-145): the initial
    v2c copy of the quantized LLRs and both message directions."""

    def __init__(self, scale=1.0, bf16=False):
        self.scale = np.float32(scale)
        self.bf16 = bf16

    def quantize(self, llr):
        return np.float32(llr)

    def store_round(self, x):
        if not self.bf16:
            return np.float32(x)
        import ml_dtypes

        return np.float32(np.asarray(x, ml_dtypes.bfloat16))

    def check_messages(self, msgs):
        mags = [abs(np.float32(x)) for x in msgs]
        order = sorted(range(len(msgs)), key=lambda i: (mags[i], i))
        m1, m2 = mags[order[0]], mags[order[1]]
        par = 0
        for x in msgs:
            if x < 0:
                par ^= 1
        out = []
        for i, x in enumerate(msgs):
            loo = np.float32((m2 if i == order[0] else m1) * self.scale)
            neg = par ^ (1 if x < 0 else 0)
            out.append(np.float32(-loo) if neg else loo)
        return out

    def var_messages(self, input_llr, msgs):
        llr = np.float32(input_llr)
        for m in msgs:
            llr = np.float32(llr + np.float32(m))
        return llr, [np.float32(llr - m) for m in msgs]


ORACLES = {
    "Phif64": OraclePhi(),
    "Minsumf32": OracleMinSum(),
    "Minsumbf16": OracleMinSum(bf16=True),
    "Normminsumf32": OracleMinSum(scale=0.75),
    "Normminsumbf16": OracleMinSum(scale=0.75, bf16=True),
    "Minstarapproxf64": OracleMinstarApprox(),
    "Aminstarf64": OracleAminstar(),
    "Minstarapproxi8": OracleMinstarI8(),
    "Minstarapproxi8Jones": OracleMinstarI8(jones=True),
    "Minstarapproxi8PartialHardLimit": OracleMinstarI8(hard_limit=True),
    "Minstarapproxi8JonesPartialHardLimitDeg1Clip": OracleMinstarI8(
        jones=True, hard_limit=True, deg1_clip=True
    ),
    "Aminstari8": OracleAminstarI8(),
    "Aminstari8PartialHardLimit": OracleAminstarI8(hard_limit=True),
}


@pytest.mark.parametrize("impl", sorted(ORACLES))
def test_flooding_matches_scalar_oracle(impl):
    rng = np.random.default_rng(12345)
    h = MNConfig(nrows=15, ncols=30, wr=6, wc=3).run(3)
    dec = Decoder(h, impl)
    oracle = ORACLES[impl]
    n = h.num_cols
    max_iter = 25
    # moderately noisy BPSK-like LLRs
    bits = rng.integers(0, 2, size=(8, n))
    noise = rng.normal(0, 0.9, size=(8, n))
    llrs = np.where(bits == 0, 1.0, -1.0) * 2.2 + noise
    out = dec.decode_batch(llrs, max_iter)
    for i in range(llrs.shape[0]):
        cw, iters, success = oracle_flooding(h, llrs[i], max_iter, oracle)
        assert int(out["iterations"][i]) == iters, (impl, i)
        assert bool(out["success"][i]) == success, (impl, i)
        np.testing.assert_array_equal(
            np.asarray(out["codeword"][i]), cw, err_msg=f"{impl} frame {i}"
        )


def oracle_layered(h, llrs, max_iter, arith, layers, is_int8):
    """Literal scalar horizontal-layered decode in layer row order
    (horizontal_layered.rs:49-110)."""
    n = h.num_cols
    rows = [h.row_list(r) for r in range(h.num_rows)]
    row_order = [int(r) for layer in layers for r in layer if r < h.num_rows]

    def check(vec, hard):
        return all(sum(hard(vec[v]) for v in row) % 2 == 0 for row in rows)

    if check(llrs, lambda x: x <= 0):
        return np.array([x <= 0 for x in llrs], np.uint8), 0, True
    sr = getattr(arith, "store_round", lambda x: x)
    qv = [arith.quantize(x) for x in llrs]
    rcv = {(c, v): 0 for c, row in enumerate(rows) for v in row}

    def out_hard(x):
        return arith.hard(arith.clip(x) if is_int8 else x)

    for it in range(1, max_iter + 1):
        for c in row_order:
            row = rows[c]
            if is_int8:
                x = [arith.clip(qv[v] - rcv[(c, v)]) for v in row]
            else:
                x = [qv[v] - rcv[(c, v)] for v in row]
            rnew = arith.check_messages(x)
            for v, rv in zip(row, rnew):
                # Qv deltas use the unstored Rnew; Rcv is re-read next
                # iteration in storage precision (lifted_layered.py)
                qv[v] += rv - rcv[(c, v)]
                rcv[(c, v)] = sr(rv)
        if check(qv, out_hard):
            return np.array([out_hard(x) for x in qv], np.uint8), it, True
    return np.array([out_hard(x) for x in qv], np.uint8), max_iter, False


@pytest.mark.parametrize(
    "impl", ["HLMinstarapproxi8", "HLMinstarapproxi8PartialHardLimit", "HLAminstari8"]
)
def test_layered_matches_scalar_oracle_i8(impl):
    rng = np.random.default_rng(999)
    h = MNConfig(nrows=12, ncols=24, wr=6, wc=3).run(1)
    dec = Decoder(h, impl)
    oracle = ORACLES[impl[2:]]
    n = h.num_cols
    max_iter = 20
    bits = rng.integers(0, 2, size=(6, n))
    noise = rng.normal(0, 0.9, size=(6, n))
    llrs = np.where(bits == 0, 1.0, -1.0) * 2.2 + noise
    out = dec.decode_batch(llrs, max_iter)
    layers = dec.graph.layers
    for i in range(llrs.shape[0]):
        cw, iters, success = oracle_layered(
            h, llrs[i], max_iter, oracle, layers, is_int8=True
        )
        assert int(out["iterations"][i]) == iters, (impl, i)
        assert bool(out["success"][i]) == success, (impl, i)
        np.testing.assert_array_equal(np.asarray(out["codeword"][i]), cw)


@pytest.mark.parametrize(
    "impl", ["HLMinsumbf16", "HLNormminsumf32", "HLNormminsumbf16"]
)
def test_layered_matches_scalar_oracle_minsum(impl):
    """Layered min-sum extensions (incl. bf16 message storage and the
    0.75-normalized variants) vs the scalar layered oracle in row order —
    bit-exact, covering the HL(Norm)minsum* names the C++ shim lacks."""
    rng = np.random.default_rng(999)
    h = MNConfig(nrows=12, ncols=24, wr=6, wc=3).run(1)
    dec = Decoder(h, impl)
    oracle = ORACLES[impl[2:]]
    n = h.num_cols
    max_iter = 20
    bits = rng.integers(0, 2, size=(6, n))
    noise = rng.normal(0, 0.9, size=(6, n))
    llrs = np.where(bits == 0, 1.0, -1.0) * 2.2 + noise
    out = dec.decode_batch(llrs, max_iter)
    layers = dec.graph.layers
    for i in range(llrs.shape[0]):
        cw, iters, success = oracle_layered(
            h, llrs[i], max_iter, oracle, layers, is_int8=False
        )
        assert int(out["iterations"][i]) == iters, (impl, i)
        assert bool(out["success"][i]) == success, (impl, i)
        np.testing.assert_array_equal(np.asarray(out["codeword"][i]), cw)


def test_layers_are_variable_disjoint():
    h = MNConfig(nrows=20, ncols=40, wr=6, wc=3).run(9)
    from ldpc_toolbox_tpu.decoder.layout import DecodeGraph

    g = DecodeGraph.from_sparse(h)
    for layer in g.layers:
        seen = set()
        for r in layer:
            if r >= g.m:
                continue
            for v in h.row_list(int(r)):
                assert v not in seen
                seen.add(v)
    # every row appears exactly once
    all_rows = sorted(int(r) for layer in g.layers for r in layer if r < g.m)
    assert all_rows == list(range(g.m))


def test_layers_serial_equivalent_to_row_order():
    """Conflicting rows must execute in increasing row index, making the
    layer schedule serial-equivalent to the reference's 0..m sweep
    (horizontal_layered.rs:49-110)."""
    h = MNConfig(nrows=20, ncols=40, wr=6, wc=3).run(9)
    from ldpc_toolbox_tpu.decoder.layout import DecodeGraph

    g = DecodeGraph.from_sparse(h)
    layer_of = {}
    for li, layer in enumerate(g.layers):
        for r in layer:
            if r < g.m:
                layer_of[int(r)] = li
    for v in range(h.num_cols):
        rows = sorted(h.col_list(v))
        for a, b in zip(rows, rows[1:]):
            assert layer_of[a] < layer_of[b], (v, a, b)


def test_tanh_check_messages_finite_under_saturation():
    """XLA's f32 tanh(x) returns exactly 1.0 for x >= 8 (polynomial
    approximation; measured on the H100 and the CPU backend), so without the product clamp atanh(prod) is inf and
    posteriors go NaN — every frame hard-decides to the all-zero word and
    counts as a false decode. The product clamp bounds messages at
    2*atanh(nextafter(1, 0))."""
    import jax.numpy as jnp

    from ldpc_toolbox_tpu.decoder.arithmetic import TanhArithmetic

    for dtype in (jnp.float32, jnp.float64):
        a = TanhArithmetic(dtype)
        cap = 2.0 * math.atanh(a.prod_max)
        x = jnp.full((3, 7, 2), 1e30, dtype)
        out = a.check_messages(x)
        assert bool(jnp.all(jnp.isfinite(out)))
        assert float(jnp.max(jnp.abs(out))) <= cap * (1 + 1e-6)


def test_i8_correction_table_values():
    t = i8_correction_table()
    # first entry: round(8*ln 2) = 6 (arithmetic.rs:589-602)
    assert t[0] == 6
    assert t[1] == 5  # 8*ln(1+e^-0.125) = 5.06
    # table is non-increasing and ends in zeros
    assert all(t[i] >= t[i + 1] for i in range(127))
    assert t[-1] == 0


def test_decoder_routes_code_objects_to_lifted_path():
    """Decoder() accepts standards code objects and a (BaseGraph, Z)
    pair, routing them to the block-circulant lifted decode; outputs
    must match the generic dual-gather decode on the same H exactly
    (min-sum is fold-order-free)."""
    from ldpc_toolbox_tpu.codes.ccsds import (
        AR4JACode,
        AR4JAInfoSize,
        AR4JARate,
    )
    from ldpc_toolbox_tpu.codes.nr5g import BaseGraph

    code = AR4JACode(AR4JARate.R1_2, AR4JAInfoSize.K1024)
    h = code.h()
    rng = np.random.default_rng(0)
    sigma = 0.9
    x = -1.0 + sigma * rng.standard_normal((8, h.num_cols)).astype(
        np.float32
    )
    llr = (-2.0 / sigma**2) * x
    d_code = Decoder(code, "Minsumf32")
    assert d_code.lifted is not None
    d_generic = Decoder(h, "Minsumf32")
    o1 = d_code.decode_batch(llr, 10)
    o2 = d_generic.decode_batch(llr, 10)
    for k in ("success", "iterations", "codeword"):
        np.testing.assert_array_equal(np.asarray(o1[k]), np.asarray(o2[k]))

    # 5G: (BaseGraph, Z) pair
    d_5g = Decoder((BaseGraph.BG2, 16), "Minsumf32")
    assert d_5g.lifted is not None and d_5g.graph.n == BaseGraph.BG2.h(16).num_cols

    with pytest.raises(TypeError):
        Decoder(object())


@pytest.mark.parametrize("option", ["fused", "compact", "resident"])
def test_decode_path_options_are_gone(option):
    """One decode path per schedule: neither the user-facing entry points
    nor the lifted decoders take a path-selecting option any more."""
    from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
    from ldpc_toolbox_tpu.decoder.factory import make_arithmetic
    from ldpc_toolbox_tpu.decoder.lifted import LiftedGraph, nr5g_maps
    from ldpc_toolbox_tpu.decoder.lifted_flooding import (
        lifted_flooding_decode,
    )
    from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode
    from ldpc_toolbox_tpu.simulation import BerTestBuilder

    kw = {option: True}
    with pytest.raises(TypeError):
        Decoder((BaseGraph.BG2, 8), "HLMinsumf32", **kw)
    with pytest.raises(TypeError):
        BerTestBuilder(h=johnson_h(), **kw)
    bg, z = BaseGraph.BG2, 8
    lg = LiftedGraph.from_sparse(bg.h(z), *nr5g_maps(bg, z))
    _, a = make_arithmetic("Minsumf32")
    llr = np.ones((2, lg.n), np.float32)
    for decode in (lifted_flooding_decode, lifted_layered_decode):
        with pytest.raises(TypeError):
            decode(lg, a, llr, 2, **kw)
