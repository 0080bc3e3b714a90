"""BER harness auxiliary subsystems: checkpoint/resume, lifted fast path,
multi-device sharding (on the virtual 8-device CPU mesh)."""

import numpy as np
import pytest

import jax

from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
from ldpc_toolbox_tpu.decoder.lifted import lifted_graph_for
from ldpc_toolbox_tpu.mackay_neal import Config as MNConfig
from ldpc_toolbox_tpu.parallel import default_mesh
from ldpc_toolbox_tpu.simulation import BerTestBuilder
from ldpc_toolbox_tpu.systematic import parity_to_systematic


@pytest.fixture(scope="module")
def small_code():
    return parity_to_systematic(MNConfig(nrows=32, ncols=64, wr=6, wc=3).run(11))


def _builder(h, **kw):
    defaults = dict(
        h=h,
        decoder_implementation="Phif32",
        ebn0s_db=[3.0, 4.0],
        max_frame_errors=6,
        max_iterations=20,
        batch_size=64,
        seed=5,
    )
    defaults.update(kw)
    return BerTestBuilder(**defaults)


def test_checkpoint_resume(small_code, tmp_path):
    ckpt = str(tmp_path / "sweep.json")
    full = _builder(small_code, checkpoint_path=ckpt).build().run()
    # run again: everything restores from the checkpoint, no new work
    resumed = _builder(small_code, checkpoint_path=ckpt).build().run()
    assert len(resumed) == len(full) == 2
    for a, b in zip(full, resumed):
        assert a.num_frames == b.num_frames
        assert a.ldpc.bit_errors == b.ldpc.bit_errors
        assert a.ldpc.frame_errors == b.ldpc.frame_errors


def test_checkpoint_partial_resume(small_code, tmp_path):
    ckpt = str(tmp_path / "sweep.json")
    # complete only the first point, then simulate a crash before point 2
    t1 = _builder(small_code, ebn0s_db=[3.0], checkpoint_path=ckpt).build()
    s1 = t1.run()
    # patch the checkpoint to pretend the full sweep was requested
    import json

    state = json.load(open(ckpt))
    state["ebn0s_db"] = [3.0, 4.0]
    json.dump(state, open(ckpt, "w"))
    t2 = _builder(small_code, checkpoint_path=ckpt).build()
    s2 = t2.run()
    assert len(s2) == 2
    # point 1 restored verbatim from the checkpoint
    assert s2[0].num_frames == s1[0].num_frames
    assert s2[0].ldpc.bit_errors == s1[0].ldpc.bit_errors


def test_checkpoint_invalidated_by_params(small_code, tmp_path):
    ckpt = str(tmp_path / "sweep.json")
    _builder(small_code, checkpoint_path=ckpt).build().run()
    # different seed: checkpoint must be ignored, sweep reruns fully
    out = _builder(small_code, checkpoint_path=ckpt, seed=6).build().run()
    assert len(out) == 2 and out[0].num_frames > 0


@pytest.mark.slow
def test_ber_lifted_fast_path_matches_generic():
    code = DvbCode.R8_9short
    h = code.h()
    lifted = lifted_graph_for(code)
    # near the r=8/9 waterfall: errors arrive within the first steps even
    # at CPU throughput
    kw = dict(
        decoder_implementation="Minsumf32",
        ebn0s_db=[4.0],
        max_frame_errors=50,
        max_iterations=20,
        batch_size=128,
        seed=3,
        max_run_time=60.0,
    )
    generic = BerTestBuilder(h=h, **kw).build().run()
    fast = BerTestBuilder(h=h, lifted_graph=lifted, **kw).build().run()
    # min-sum magnitude ties break by slot order, which differs between
    # layouts, so individual marginal frames can flip: compare statistics
    assert fast[0].num_frames > 0
    f_fer = fast[0].ldpc.fer
    g_fer = generic[0].ldpc.fer
    assert 0 < f_fer < 1 and 0 < g_fer < 1
    assert 0.4 < f_fer / g_fer < 2.5
    assert (
        abs(fast[0].average_iterations - generic[0].average_iterations)
        < 0.2 * generic[0].average_iterations + 0.5
    )


@pytest.mark.parametrize("decoder", ["Minsumf32", "HLMinsumf32"])
def test_ber_lifted_sharded_matches_unsharded(decoder):
    """The lifted decode under a sharded mesh runs per shard via
    shard_map (simulation/ber.py _shard_decode) and must reproduce the
    unsharded step's counters exactly, for both schedules; its compiled
    step must not all-gather the batch."""
    from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
    from ldpc_toolbox_tpu.decoder.lifted import LiftedGraph, nr5g_maps

    bg, z = BaseGraph.BG2, 16
    h = bg.h(z)
    vm, cm, Z, nvg, ncg = nr5g_maps(bg, z)
    lg = LiftedGraph.from_sparse(h, vm, cm, Z, nvg, ncg)
    mesh = default_mesh(jax.devices()[:8])
    kw = dict(
        h=h,
        decoder_implementation=decoder,
        lifted_graph=lg,
        ebn0s_db=[5.0],
        max_frame_errors=1,
        max_iterations=6,
        batch_size=16,
        seed=3,
    )
    key = jax.random.key(3)
    plain = jax.device_get(BerTestBuilder(**kw).build()._step(key, 0.55))
    sharded = BerTestBuilder(**kw, mesh=mesh).build()
    hlo = sharded._step.lower(key, 0.55).compile().as_text()
    assert "all-gather" not in hlo
    shard = jax.device_get(sharded._step(key, 0.55))
    for name, v in plain.items():
        assert int(shard[name]) == int(v), (name, int(shard[name]), int(v))
    assert 0 < int(plain["total_iterations"])


def test_ber_sharded_matches_unsharded(small_code):
    mesh = default_mesh(jax.devices()[:8])
    kw = dict(
        h=small_code,
        decoder_implementation="Minstarapproxf32",
        ebn0s_db=[3.5],
        max_frame_errors=8,
        max_iterations=20,
        batch_size=64,
        seed=9,
        max_run_time=60.0,
    )
    plain = BerTestBuilder(**kw).build().run()
    sharded = BerTestBuilder(**kw, mesh=mesh).build().run()
    # sharding must not change the Monte-Carlo stream or the results
    assert sharded[0].num_frames == plain[0].num_frames
    assert sharded[0].ldpc.bit_errors == plain[0].ldpc.bit_errors
    assert sharded[0].ldpc.frame_errors == plain[0].ldpc.frame_errors


def test_ber_systematic_permutation_end_to_end():
    """Codes whose trailing square is singular (CCSDS C2,
    codes/ccsds.py) can't build a direct systematic encoder; the harness
    accepts a `systematic_permutation` (systematic.py), encodes on
    h[:, perm], maps the codeword back to original column order for the
    channel/decoder, and counts bit errors at perm[:k]. At high SNR a
    small sweep must produce zero errors with every frame decoded —
    which fails loudly if any of the three mappings is off by even one
    column."""
    from ldpc_toolbox_tpu.encoder import Encoder, EncoderError
    from ldpc_toolbox_tpu.systematic import systematic_permutation

    # a small MacKay-Neal code with a singular trailing square
    conf = MNConfig(nrows=12, ncols=24, wr=6, wc=3)
    h = None
    for seed in range(40):
        cand = conf.run(seed)
        if cand is None:
            continue
        try:
            Encoder(cand)
        except EncoderError:
            h = cand
            break
    assert h is not None, "no seed produced a singular trailing square"
    perm = systematic_permutation(h)
    assert sorted(perm) == list(range(24))

    stats = []
    test = BerTestBuilder(
        h=h,
        decoder_implementation="Phif32",
        max_frame_errors=1,
        max_iterations=30,
        ebn0s_db=[12.0],
        batch_size=64,
        max_run_time=5.0,
        seed=7,
        reporter=lambda s, final: stats.append(s) if final else None,
        systematic_permutation=perm,
    ).build()
    test.run()
    assert stats and stats[0].ldpc.frame_errors == 0
    assert stats[0].ldpc.bit_errors == 0
    assert stats[0].num_frames >= 64
