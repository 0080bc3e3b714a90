"""Measure equal-quality iteration budgets across schedules
(LDPC_EQ_CODE=5g:BG1:384 selects the 5G NR cross-family check).

Decodes the SAME channel realizations (identical per-chunk PRNG keys)
with several (decoder, max_iterations) configs across the DVB-S2 r=1/2
waterfall and reports FER / info-BER / avg iters per point. The claim
under test: HLMinsumbf16 at 15 iterations matches Minsumbf16 flooding at
30 iterations (the layered schedule converges in ~half the iterations —
reference horizontal_layered.rs:1-15).

All-zero-codeword BPSK/AWGN is exact for these sign-symmetric decoders
on a linear code. Error counters accumulate on device; one fetch per
(config, point).

Usage: python tools/equal_quality.py [out.jsonl]
"""

import json
import os
import pathlib
import sys
import time
from functools import partial

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_toolbox_tpu.cli import _enable_compile_cache

BATCH = 1024
#: (ebn0_db, chunks): frames = chunks * BATCH, escalating into the floor
POINTS = [(1.4, 8), (1.5, 16), (1.6, 32), (1.7, 64), (1.8, 128)]
CONFIGS = [
    ("HLMinsumbf16", 15),
    ("Minsumbf16", 30),
    ("HLMinsumbf16", 30),  # reference point: the layered ceiling
]
# overrides: LDPC_EQ_CONFIGS="HLMinsumbf16:18,HLMinsumbf16:20"
#            LDPC_EQ_POINTS="1.5:16,1.6:32,1.7:64"
if os.environ.get("LDPC_EQ_CONFIGS"):
    CONFIGS = [
        (s.split(":")[0], int(s.split(":")[1]))
        for s in os.environ["LDPC_EQ_CONFIGS"].split(",")
    ]
if os.environ.get("LDPC_EQ_POINTS"):
    POINTS = [
        (float(s.split(":")[0]), int(s.split(":")[1]))
        for s in os.environ["LDPC_EQ_POINTS"].split(",")
    ]


def main():
    from ldpc_toolbox_tpu.codes.dvbs2 import Code
    from ldpc_toolbox_tpu.decoder.factory import make_arithmetic
    from ldpc_toolbox_tpu.decoder.lifted import lifted_graph_for
    from ldpc_toolbox_tpu.decoder.lifted_flooding import (
        lifted_flooding_decode,
    )
    from ldpc_toolbox_tpu.decoder.lifted_layered import lifted_layered_decode

    _enable_compile_cache()
    out_path = sys.argv[1] if len(sys.argv) > 1 else "results/equal_quality.jsonl"
    code_spec = os.environ.get("LDPC_EQ_CODE", "dvbs2:R1_2")
    if code_spec.startswith("5g:"):
        from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
        from ldpc_toolbox_tpu.decoder.lifted import LiftedGraph, nr5g_maps

        _, bgname, zs = code_spec.split(":")
        bg = BaseGraph[bgname]
        z = int(zs)
        h = bg.h(z)
        lg = LiftedGraph.from_sparse(h, *nr5g_maps(bg, z))

        class code:  # shim: n/k fields only
            n = h.num_cols
            k = h.num_cols - h.num_rows
    else:
        code = Code[code_spec.split(":")[1]]
        lg = lifted_graph_for(code)
    rate = code.k / code.n

    rows = []
    for name, iters in CONFIGS:
        schedule, arith = make_arithmetic(name)
        decode = (
            lifted_layered_decode
            if schedule == "layered"
            else lifted_flooding_decode
        )
        dec = partial(decode, lg, arith, max_iterations=iters)

        @jax.jit
        def chunk(key, sigma, acc):
            # identical noise for every config: the key alone fixes it
            z = jax.random.normal(key, (BATCH, code.n), jnp.float32)
            x = -1.0 + sigma * z
            llrs = (-2.0 / sigma**2) * x
            r = dec(llrs)
            bits = r["codeword"][:, : code.k].astype(jnp.int32)
            frame_bad = jnp.sum(jnp.any(bits != 0, axis=1))
            bit_bad = jnp.sum(bits)
            its = jnp.sum(r["iterations"])
            return (
                acc[0] + frame_bad,
                acc[1] + bit_bad,
                acc[2] + its,
            )

        for ebn0, chunks in POINTS:
            sigma = float(np.sqrt(0.5 / (rate * 10 ** (0.1 * ebn0))))
            acc = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
            t0 = time.perf_counter()
            for c in range(chunks):
                key = jax.random.key(1000 * int(ebn0 * 10) + c)
                acc = chunk(key, sigma, acc)
            fe, be, its = (int(np.asarray(a)) for a in acc)
            dt = time.perf_counter() - t0
            frames = chunks * BATCH
            row = {
                "decoder": name,
                "max_iters": iters,
                "ebn0_db": ebn0,
                "frames": frames,
                "frame_errors": fe,
                "fer": fe / frames,
                "ber": be / (frames * code.k),
                "avg_iters": its / frames,
                "seconds": round(dt, 1),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    with open(out_path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
