"""Encoder tests (fixtures from encoder.rs:128-197)."""

import numpy as np

from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_tpu.encoder import Encoder, is_staircase
from ldpc_toolbox_tpu.mackay_neal import Config as MNConfig
from ldpc_toolbox_tpu.sparse import SparseMatrix
from ldpc_toolbox_tpu.systematic import parity_to_systematic

DENSE_ALIST = """12 4
3 9
3 3 3 3 3 3 3 3 3 3 3 3
9 9 9 9
1 2 3
1 3 4
2 3 4
2 3 4
1 2 4
1 2 3
1 3 4
1 2 4
1 2 3
2 3 4
1 2 4
1 3 4
1 2 5 6 7 8 9 11 12
1 3 4 5 6 8 9 10 11
1 2 3 4 6 7 9 10 12
2 3 4 5 7 8 10 11 12
"""

STAIRCASE_ALIST = """5 3
2 4
2 2 2 2 1
2 4 4
1 3
2 3
1 2
2 3
3
1 3
2 3 4
1 2 4 5
"""


def test_encode_dense_fixture():
    h = SparseMatrix.from_alist(DENSE_ALIST)
    enc = Encoder(h)
    assert not enc.staircase
    out = enc.encode([1, 0, 1, 1, 0, 0, 1, 0])
    np.testing.assert_array_equal(out, [1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0, 1])
    out = enc.encode([0, 1, 0, 0, 1, 1, 1, 0])
    np.testing.assert_array_equal(out, [0, 1, 0, 0, 1, 1, 1, 0, 1, 0, 1, 0])


def test_encode_staircase_fixture():
    h = SparseMatrix.from_alist(STAIRCASE_ALIST)
    enc = Encoder(h)
    assert enc.staircase
    np.testing.assert_array_equal(enc.encode([1, 0]), [1, 0, 1, 1, 0])
    np.testing.assert_array_equal(enc.encode([0, 1]), [0, 1, 0, 1, 0])


def test_is_staircase_incremental():
    # staircase.rs:31-46
    h = SparseMatrix(3, 5)
    assert not is_staircase(h)
    h.insert(0, 2)
    assert not is_staircase(h)
    h.insert(1, 2)
    assert not is_staircase(h)
    h.insert(1, 3)
    assert not is_staircase(h)
    h.insert(2, 3)
    assert not is_staircase(h)
    h.insert(2, 4)
    assert is_staircase(h)
    h.insert(0, 3)
    assert not is_staircase(h)


def _assert_valid_codewords(h, cw):
    hd = h.to_dense().astype(np.int64)
    syndrome = (cw.astype(np.int64) @ hd.T) & 1
    assert not syndrome.any()


def test_batch_encode_satisfies_h_dense():
    h = parity_to_systematic(MNConfig(nrows=12, ncols=24, wr=6, wc=3).run(2))
    enc = Encoder(h)
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 2, size=(16, enc.k))
    cw = np.asarray(enc.encode_batch(msgs))
    np.testing.assert_array_equal(cw[:, : enc.k], msgs)
    _assert_valid_codewords(h, cw)
    # batch matches single
    for i in range(4):
        np.testing.assert_array_equal(enc.encode(msgs[i]), cw[i])


def test_batch_encode_satisfies_h_dvbs2_staircase():
    code = DvbCode.R8_9short  # smallest DVB-S2 code, m=1800
    h = code.h()
    enc = Encoder(h)
    assert enc.staircase  # DVB-S2 must take the O(n) path
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 2, size=(4, enc.k))
    cw = np.asarray(enc.encode_batch(msgs))
    np.testing.assert_array_equal(cw[:, : enc.k], msgs)
    _assert_valid_codewords(h, cw)
    np.testing.assert_array_equal(enc.encode(msgs[0]), cw[0])


def test_dense_encoder_matches_gf2_matmul():
    """The dense encoder's f32 matrix product (full precision) equals the
    integer GF(2) product G0·m, at the size of CCSDS C2's generator
    (1020 x 7156), the largest dense encoder the harness builds."""
    from ldpc_toolbox_tpu.codes.ccsds import C2Code
    from ldpc_toolbox_tpu.gf2 import gf2_matmul
    from ldpc_toolbox_tpu.systematic import (
        full_rank_rows,
        permute_columns,
        systematic_permutation,
    )

    h_enc = full_rank_rows(C2Code().h())
    enc = Encoder(permute_columns(h_enc, systematic_permutation(h_enc)))
    assert not enc.staircase
    rng = np.random.default_rng(4)
    msgs = rng.integers(0, 2, size=(32, enc.k), dtype=np.uint8)
    cw = np.asarray(enc.encode_batch(msgs))
    np.testing.assert_array_equal(cw[:, : enc.k], msgs)
    np.testing.assert_array_equal(cw[:, enc.k :], gf2_matmul(msgs, enc._g0.T))
