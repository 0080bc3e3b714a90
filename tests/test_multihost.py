"""Multi-host (multi-process) BER step over jax.distributed.

SURVEY.md §5 names multi-host sweeps as a framework target: the batch
shards over one global mesh, H is replicated, and the per-step counter
reduction is the only cross-host traffic. This test runs TWO separate
processes (each a fresh JAX runtime with 2 virtual CPU devices), boots
``jax.distributed`` over localhost through ``multihost.initialize()``,
builds the 4-device ``global_mesh()``, and drives one jitted BER step —
asserting both processes observe identical (replicated) counters.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

_REPO_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)

_WORKER = r"""
import json, os, sys

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

from ldpc_toolbox_tpu.parallel.multihost import global_mesh, initialize

initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=2,
    process_id=pid,
)
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == pid
assert len(jax.devices()) == 4, jax.devices()  # global view
assert len(jax.local_devices()) == 2

from ldpc_toolbox_tpu.mackay_neal import Config
from ldpc_toolbox_tpu.simulation import BerTestBuilder
from ldpc_toolbox_tpu.systematic import parity_to_systematic

mesh = global_mesh()
assert mesh.devices.size == 4
h = parity_to_systematic(Config(nrows=16, ncols=32, wr=6, wc=3).run(4))
test = BerTestBuilder(
    h=h,
    decoder_implementation="Phif32",
    ebn0s_db=[4.0],
    max_frame_errors=1,
    max_iterations=5,
    batch_size=8,
    mesh=mesh,
    seed=0,
).build()
key = jax.random.key(0)
counters = {k: int(v) for k, v in jax.device_get(test._step(key, 0.7)).items()}
print("COUNTERS " + json.dumps(counters, sort_keys=True), flush=True)

if os.environ.get("MH_LIFTED"):
    # scenario 2: the lifted layered decode per shard via shard_map
    # across BOTH processes' devices; counters must be replicated AND
    # equal to this process's local unsharded run.
    from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
    from ldpc_toolbox_tpu.decoder.lifted import LiftedGraph, nr5g_maps

    bg, z = BaseGraph.BG2, 16
    h5g = bg.h(z)
    lg = LiftedGraph.from_sparse(h5g, *nr5g_maps(bg, z))
    kw = dict(
        h=h5g,
        decoder_implementation="HLMinsumf32",
        lifted_graph=lg,
        ebn0s_db=[6.0],
        max_frame_errors=1,
        max_iterations=4,
        batch_size=8,
        seed=1,
    )
    key = jax.random.key(1)
    sharded = {
        k: int(v)
        for k, v in jax.device_get(
            BerTestBuilder(**kw, mesh=mesh).build()._step(key, 0.5)
        ).items()
    }
    local = {
        k: int(v)
        for k, v in jax.device_get(
            BerTestBuilder(**kw).build()._step(key, 0.5)
        ).items()
    }
    assert sharded == local, (sharded, local)
    print("LIFTED " + json.dumps(sharded, sort_keys=True), flush=True)

if os.environ.get("MH_SWEEP"):
    # scenario 3 (VERDICT r4 #6): the FULL sweep loop under
    # jax.distributed — a 2-point Eb/N0 sweep with the error-count stop
    # rule, a checkpoint written at the end of point 0 that kills the
    # run (simulated crash), and a fresh BerTest resuming from it;
    # process-0-only reporter. Final statistics must be identical
    # across processes (printed for the host to compare) and to a
    # single-process unsharded run (compared host-side).
    ckpt = os.environ["MH_CKPT_DIR"] + f"/sweep.{pid}.ckpt"
    reports = []

    def reporter(stats, final):
        if final:
            reports.append(stats.ebn0_db)

    kw = dict(
        h=h,
        decoder_implementation="Phif32",
        ebn0s_db=[3.0, 5.0],
        max_frame_errors=8,
        max_iterations=5,
        batch_size=8,
        seed=3,
        checkpoint_path=ckpt,
        mesh=mesh,
    )

    def build(kw):
        t = BerTestBuilder(
            **kw, reporter=reporter if pid == 0 else None
        ).build()
        t.p.report_interval = 1e9  # only end-of-point checkpoints
        return t

    t1 = build(kw)
    orig_save = t1._save_checkpoint

    def crash_after_point0(state):
        orig_save(state)
        if state["point"] == 1:
            raise KeyboardInterrupt

    t1._save_checkpoint = crash_after_point0
    try:
        t1.run()
        raise SystemExit("expected simulated crash")
    except KeyboardInterrupt:
        pass
    assert os.path.exists(ckpt)

    t2 = build(kw)
    stats = t2.run()
    assert len(stats) == 2, stats
    assert [s.ebn0_db for s in stats] == [3.0, 5.0]
    # the stop rule must have been honored at both points
    assert all(s.ldpc.frame_errors >= 8 for s in stats), stats
    if pid == 0:
        # point 0 reported final by t1 before the crash; point 1 by t2
        # (the restored point is not re-reported)
        assert reports == [3.0, 5.0], reports
    def det_fields(stats):
        return [
            {
                "ebn0_db": s.ebn0_db,
                "num_frames": s.num_frames,
                "false_decodes": s.false_decodes,
                "total_iterations": s.total_iterations,
                "bit_errors": s.ldpc.bit_errors,
                "frame_errors": s.ldpc.frame_errors,
                "correct_iterations": s.ldpc.correct_iterations,
            }
            for s in stats
        ]

    print("SWEEP " + json.dumps(det_fields(stats), sort_keys=True),
          flush=True)

    # unsharded single-process reference in the same runtime: the
    # sharded sweep must produce identical deterministic statistics
    kw_local = dict(kw, mesh=None, checkpoint_path=None)
    local_stats = BerTestBuilder(**kw_local).build().run()
    assert det_fields(local_stats) == det_fields(stats), (
        det_fields(local_stats), det_fields(stats))
    print("SWEEPLOCAL ok", flush=True)
"""


def _run_workers(tmp_path, extra_env=None, timeout=420):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env={**os.environ, "PYTHONPATH": _REPO_ROOT, **(extra_env or {})},
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def _grab(outs, tag):
    vals = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        assert line, out
        vals.append(json.loads(line[-1][len(tag) + 1 :]))
    return vals


def test_two_process_ber_step(tmp_path):
    outs = _run_workers(tmp_path)
    counters = _grab(outs, "COUNTERS")
    # replicated scalar counters must agree across processes
    assert counters[0] == counters[1]
    assert counters[0]["num_frames"] == 8


@pytest.mark.slow
def test_two_process_lifted_ber_step(tmp_path):
    """The lifted layered decode under jax.distributed: 2 processes x 2
    devices, batch sharded via shard_map over the global mesh. Each worker asserts its sharded
    counters equal its local unsharded run; here we assert the two
    processes also agree with each other (mechanism parity target:
    reference ber.rs:303-359 worker threads)."""
    outs = _run_workers(tmp_path, extra_env={"MH_LIFTED": "1"})
    counters = _grab(outs, "COUNTERS")
    assert counters[0] == counters[1]
    lifted = _grab(outs, "LIFTED")
    assert lifted[0] == lifted[1]
    assert lifted[0]["num_frames"] == 8


@pytest.mark.slow
def test_two_process_full_sweep_checkpoint_resume(tmp_path):
    """The complete sweep mechanism under jax.distributed (mechanism
    parity: reference ber.rs:303-359): 2 processes x 2 devices drive a
    2-point Eb/N0 sweep with the stop rule, a checkpoint is written and
    the run killed at the end of point 0, a fresh BerTest resumes from
    it, and only process 0 reports. Final per-point statistics must be
    identical across both processes and equal to a single-process
    unsharded run."""
    outs = _run_workers(
        tmp_path,
        extra_env={"MH_SWEEP": "1", "MH_CKPT_DIR": str(tmp_path)},
        timeout=600,
    )
    sweep = _grab(outs, "SWEEP")
    assert sweep[0] == sweep[1]
    # each worker additionally asserted its sharded sweep equals an
    # unsharded run in the same runtime (SWEEPLOCAL)
    for out in outs:
        assert "SWEEPLOCAL ok" in out
