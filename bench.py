"""Benchmark: decoded info throughput on the flagship workload, on a GPU.

Measures the batched lifted belief-propagation decode of the DVB-S2
rate-1/2 n=64800 code (the BASELINE.json headline metric) on the default
JAX device and prints ONE JSON line::

    {"metric": ..., "value": N, "unit": "Mbit/s", "vs_baseline": N,
     "device": {...}, "card": "<name>, <power limit>", ...}

The flagship decoder is ``HLMinsumbf16`` — the horizontal-layered
schedule (decoder/lifted_layered.py), which converges in ~half the
iterations of flooding at identical quality (reference
horizontal_layered.rs:49-110). Override with ``BENCH_DECODER`` (any of
the 44 names), ``BENCH_CODE``, ``BENCH_EBN0``, ``BENCH_MAX_ITERS`` and
``BENCH_BATCH``. At the default 1.0 dB every frame runs the whole
iteration budget.

Timing: one AOT compile (reported as ``compile_s``, set-up), one warm-up
call, then ``REPS`` calls each ended by ``block_until_ready``; the
value is the median. Without a GPU the script exits non-zero and prints
no number.

``vs_baseline`` divides by the CPU floor of the repo's C++ C-ABI shim
(capi/), read from ``results/cpu_floors.json`` (written by
``tools/measure_floors.py`` on another host).
"""

import json
import os
import pathlib
import statistics
import time
from functools import partial

FLOORS = pathlib.Path(__file__).parent / "results" / "cpu_floors.json"

CODE_NAME = os.environ.get("BENCH_CODE", "R1_2")
EBN0_DB = float(os.environ.get("BENCH_EBN0", "1.0"))
MAX_ITERS = int(os.environ.get("BENCH_MAX_ITERS", "30"))
BATCH = int(os.environ.get("BENCH_BATCH", "1024"))
DECODER = os.environ.get("BENCH_DECODER", "HLMinsumbf16")
REPS = 10


def build(code_name: str):
    from ldpc_toolbox_tpu.codes.dvbs2 import Code
    from ldpc_toolbox_tpu.decoder.lifted import lifted_graph_for

    code = Code[code_name]
    return code, lifted_graph_for(code)


def make_llrs(code, batch: int):
    import numpy as np

    rng = np.random.default_rng(0)
    ebn0 = 10 ** (0.1 * EBN0_DB)
    rate = code.k / code.n
    sigma = float(np.sqrt(0.5 / (rate * ebn0)))
    # all-zero codeword BPSK (+noise); valid for any linear code's BER
    x = -1.0 + sigma * rng.standard_normal((batch, code.n), dtype=np.float32)
    return (-2.0 / sigma**2) * x


def measure(code, graph, batch: int, reps: int):
    import jax
    import numpy as np

    from ldpc_toolbox_tpu.decoder.factory import make_arithmetic
    from ldpc_toolbox_tpu.decoder.lifted_flooding import lifted_flooding_decode
    from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode

    schedule, arith = make_arithmetic(DECODER)
    decode = (
        lifted_layered_decode if schedule == "layered" else lifted_flooding_decode
    )
    step = jax.jit(partial(decode, graph, arith, max_iterations=MAX_ITERS))
    llrs = jax.device_put(make_llrs(code, batch))

    t0 = time.perf_counter()
    compiled = step.lower(llrs).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(llrs))  # warm-up

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = jax.block_until_ready(compiled(llrs))
        times.append(time.perf_counter() - t0)
    iters = np.asarray(r["iterations"])
    dt = statistics.median(times)
    return {
        "mbps": 1e-6 * code.k * batch / dt,
        "median_ms": 1e3 * dt,
        "min_ms": 1e3 * min(times),
        "max_ms": 1e3 * max(times),
        "compile_s": compile_s,
        "iterations_executed": int(iters.max()),
        "avg_iterations": float(iters.mean()),
        "successes": int(np.asarray(r["success"]).sum()),
        "schedule": schedule,
        "peak_bytes_in_use": jax.devices()[0].memory_stats()[
            "peak_bytes_in_use"
        ],
    }


def cpu_floor(code_name: str):
    """Pinned CPU floor from results/cpu_floors.json (bf16 decoder names
    map to their f32 sibling: the scalar shim implements the reference's
    dtypes)."""
    if not FLOORS.exists():
        return None
    floors = json.loads(FLOORS.read_text())
    row = floors.get(f"dvbs2:{code_name}")
    if not isinstance(row, dict):
        return None
    for name in (DECODER, DECODER.replace("bf16", "f32")):
        if name in row:
            return row[name]
    return None


def main():
    from ldpc_toolbox_tpu.utils.device import (
        card_identity,
        device_summary,
        require_gpu,
    )

    require_gpu()
    from ldpc_toolbox_tpu.cli import _enable_compile_cache

    _enable_compile_cache()
    code, graph = build(CODE_NAME)
    m = measure(code, graph, batch=BATCH, reps=REPS)
    floor = cpu_floor(CODE_NAME)
    result = {
        "metric": (
            f"decoded info throughput, DVB-S2 {CODE_NAME} n={code.n} "
            f"{DECODER} {m['schedule']} B={BATCH} "
            f"@ {EBN0_DB} dB (max {MAX_ITERS} iters)"
        ),
        "value": m["mbps"],
        "unit": "Mbit/s",
        "vs_baseline": m["mbps"] / floor if floor else None,
        "device": device_summary(),
        "card": card_identity(),
        "compile_s": m["compile_s"],
        "median_ms": m["median_ms"],
        "min_ms": m["min_ms"],
        "max_ms": m["max_ms"],
        "reps": REPS,
        "iterations_executed": m["iterations_executed"],
        "avg_iterations": m["avg_iterations"],
        "successes": m["successes"],
        "peak_bytes_in_use": m["peak_bytes_in_use"],
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
