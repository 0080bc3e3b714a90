"""Smoke test of the main path on the GPU, against the CPU as reference.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the sharded BER step

One process drives the card. Phases (any failure raises, so the script
exits non-zero and prints no result line):

1. Device: JAX's default backend must be a GPU; there is no CPU fallback.
2. Flagship through ``Decoder``: DVB-S2 R1_2 normal frames (n = 64800),
   HLMinsumbf16, 1024 random codewords over BPSK/AWGN at 2.0 dB, 30
   iterations. Every frame must decode to the codeword sent; the first 16
   frames are decoded again on the CPU and compared.
3. Other schedules and rule classes, GPU against CPU on the same LLRs,
   plus the transcendental clamp and the dense GF(2) encoder on the card.
4. The ``ber`` CLI in-process at 2.0 dB: at least one batch, FER <= 1e-2.
5. Determinism: phase 2's decode again on the card, identical outputs.

Tolerances (stated once here, applied in ``compare``):

* integer rules (``*i8``): success, iterations and codewords identical on
  every frame, converged or not — the arithmetic is integer after the
  quantizer, so any difference is a bug;
* float rules: success masks may differ on at most one frame of 16, and
  codewords are identical on frames both sides decoded — f32 sums run in
  another order on the GPU (reductions, fused multiply-adds), which can
  move a marginal frame across the convergence line.

With ``--four-cards`` only the sharded path runs: one ``BerTest`` step of
the flagship at batch 4 x 256 on a 1-D ``batch`` mesh of four cards,
compared with the same step on one card with the same key (counters must
be equal).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import io
import json
import math
import time

import numpy as np

SEED = 20260
ITERS = 30
# the flagship and its sizes (module constants, so a rehearsal on the CPU
# can shrink them; the script itself always runs them as written)
FLAGSHIP = "R1_2"  # codes.dvbs2.Code member
BER_SPEC = "dvbs2:1/2"
BATCH = 1024
BG1_Z = 384


def log(msg):
    print(msg, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def peak_bytes(device=None):
    import jax

    device = device if device is not None else jax.devices()[0]
    return device.memory_stats()["peak_bytes_in_use"]


def sigma_for(ebn0_db, rate):
    return math.sqrt(0.5 / (rate * 10 ** (0.1 * ebn0_db)))


def channel_llrs(key, cw, sigma):
    """BPSK over AWGN, on the default device."""
    from ldpc_toolbox_tpu.simulation import AwgnChannel, Bpsk

    mod = Bpsk()
    rx = AwgnChannel.add_noise(key, mod.modulate(cw), sigma)
    return mod.demodulate(rx, sigma)


def timed_decode(dec, llrs, iters):
    """(host outputs, seconds) of one decode_batch call."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(dec.decode_batch(llrs, iters))
    dt = time.perf_counter() - t0
    return {k: np.asarray(v) for k, v in out.items()}, dt


def cpu_decode(dec, llrs, iters):
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return timed_decode(dec, np.asarray(llrs), iters)


def compare(name, gpu, cpu, exact):
    """GPU outputs against the CPU reference on the same LLRs."""
    if exact:
        for k in ("success", "iterations", "codeword"):
            check(
                np.array_equal(gpu[k], cpu[k]),
                f"{name}: {k} differs between GPU and CPU (integer rule)",
            )
        return "bit-identical"
    s_g, s_c = gpu["success"], cpu["success"]
    flips = int((s_g != s_c).sum())
    check(flips <= 1, f"{name}: success differs on {flips} frames")
    both = s_g & s_c
    check(
        np.array_equal(gpu["codeword"][both], cpu["codeword"][both]),
        f"{name}: codewords differ on frames both sides decoded",
    )
    iter_diff = int((gpu["iterations"][both] != cpu["iterations"][both]).sum())
    return f"success flips {flips}, iteration diffs {iter_diff}"


def phase_flagship():
    import jax

    from ldpc_toolbox_tpu.codes.dvbs2 import Code
    from ldpc_toolbox_tpu.decoder import Decoder
    from ldpc_toolbox_tpu.encoder import Encoder

    code = Code[FLAGSHIP]
    t0 = time.perf_counter()
    dec = Decoder(code, "HLMinsumbf16")
    enc = Encoder(code.h())
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    msgs = rng.integers(0, 2, size=(BATCH, enc.k), dtype=np.uint8)
    cw = enc.encode_batch(msgs)
    llrs = channel_llrs(
        jax.random.key(SEED), cw, sigma_for(2.0, code.k / code.n)
    )
    first, t_first = timed_decode(dec, llrs, ITERS)
    again, t_run = timed_decode(dec, llrs, ITERS)
    cw = np.asarray(cw)
    n_ok = int(first["success"].sum())
    log(
        f"phase 2 flagship {FLAGSHIP} HLMinsumbf16 B={BATCH}: setup {setup:.3f} s, "
        f"compile {t_first - t_run:.3f} s, run {t_run:.6f} s "
        f"({1e-6 * code.k * BATCH / t_run:.3f} Mbit/s decoded), "
        f"peak_bytes_in_use {peak_bytes()}, success {n_ok}/{BATCH}, "
        f"avg iterations {first['iterations'].mean():.3f}"
    )
    check(n_ok == BATCH, f"flagship: {BATCH - n_ok} frames failed")
    check(np.array_equal(first["codeword"], cw), "flagship: wrong codewords")
    ref, t_cpu = cpu_decode(dec, llrs[:16], ITERS)
    verdict = compare("flagship", {k: v[:16] for k, v in first.items()},
                      ref, exact=False)
    log(f"phase 2 CPU reference on frames 0-15 ({t_cpu:.3f} s): {verdict}")
    return dec, llrs, first, again


def phase_rules():
    import jax

    from ldpc_toolbox_tpu.codes.ccsds import C2Code
    from ldpc_toolbox_tpu.codes.dvbs2 import Code
    from ldpc_toolbox_tpu.codes.nr5g import BaseGraph
    from ldpc_toolbox_tpu.decoder import Decoder
    from ldpc_toolbox_tpu.encoder import Encoder

    frames, iters = 16, 10
    key = jax.random.key(SEED + 1)
    r12 = Code[FLAGSHIP]
    enc = Encoder(r12.h())
    rng = np.random.default_rng(SEED + 1)
    msgs = rng.integers(0, 2, size=(frames, enc.k), dtype=np.uint8)
    # random codewords, so a NaN posterior (hard-deciding to the
    # all-zero word) shows up as a wrong decode
    llr_r12 = channel_llrs(
        key, enc.encode_batch(msgs), sigma_for(1.0, r12.k / r12.n)
    )

    def zero_word_llrs(n, rate, ebn0_db):
        cw = jax.numpy.zeros((frames, n), jax.numpy.uint8)
        return channel_llrs(key, cw, sigma_for(ebn0_db, rate))

    bg1 = (BaseGraph.BG1, BG1_Z)
    h_bg1 = BaseGraph.BG1.h(BG1_Z)
    llr_bg1 = zero_word_llrs(
        h_bg1.num_cols, 1 - h_bg1.num_rows / h_bg1.num_cols, 0.5
    )
    c2 = C2Code()
    h_c2 = c2.h()
    llr_c2 = zero_word_llrs(
        h_c2.num_cols, 1 - h_c2.num_rows / h_c2.num_cols, 3.0
    )
    cases = [
        (f"{FLAGSHIP} @1.0dB", r12, llr_r12, "Minsumbf16"),
        (f"{FLAGSHIP} @1.0dB", r12, llr_r12, "HLMinstarapproxi8"),
        (f"{FLAGSHIP} @1.0dB", r12, llr_r12, "Minstarapproxi8"),
        (f"{FLAGSHIP} @1.0dB", r12, llr_r12, "Tanhf32"),
        (f"{FLAGSHIP} @1.0dB", r12, llr_r12, "Phif32"),
        (f"5G BG1 Z={BG1_Z} @0.5dB", bg1, llr_bg1, "HLMinstarapproxi8"),
        (f"5G BG1 Z={BG1_Z} @0.5dB", bg1, llr_bg1, "Minsumbf16"),
        ("C2 Z=511 @3.0dB", c2, llr_c2, "HLMinsumbf16"),
        ("C2 Z=511 @3.0dB", c2, llr_c2, "Minstarapproxi8"),
    ]
    for label, code, llrs, name in cases:
        dec = Decoder(code, name)
        gpu, t_gpu = timed_decode(dec, llrs, iters)
        _, t_run = timed_decode(dec, llrs, iters)
        cpu, t_cpu = cpu_decode(dec, llrs, iters)
        verdict = compare(f"{label} {name}", gpu, cpu,
                          exact=dec.arithmetic.is_int8)
        log(
            f"phase 3 {label} {name} x{frames}, {iters} iters: GPU compile "
            f"{t_gpu - t_run:.3f} s run {t_run:.6f} s, CPU {t_cpu:.3f} s, "
            f"success {int(gpu['success'].sum())}/{frames}, {verdict}, "
            f"peak_bytes_in_use {peak_bytes()}"
        )
    phase_transcendentals()
    phase_dense_encoder(h_c2)


def phase_transcendentals():
    """XLA's GPU tanh is not libm's: the Tanhf32 clamp must keep check
    messages finite when tanh saturates."""
    import jax.numpy as jnp

    from ldpc_toolbox_tpu.decoder.factory import make_arithmetic

    x = jnp.arange(0, 2001, dtype=jnp.float32) * 0.01  # 0 .. 20 by 0.01
    t = np.asarray(jnp.tanh(x))
    sat = np.asarray(x)[t == 1.0]
    log(
        "phase 3 f32 tanh(x) == 1.0 on the card from x = "
        f"{sat.min() if sat.size else 'never (<= 20)'}"
    )
    ph = np.asarray(-jnp.log(jnp.tanh(0.5 * x)))
    zero = np.asarray(x)[ph == 0.0]
    log(
        "phase 3 f32 textbook -ln(tanh(x/2)) == 0 on the card from x = "
        f"{zero.min() if zero.size else 'never (<= 20)'}"
    )
    _, tanh_rule = make_arithmetic("Tanhf32")
    rng = np.random.default_rng(SEED + 2)
    msgs = rng.choice([-1.0, 1.0], size=(64, 7, 256)) * rng.uniform(
        0.0, 60.0, size=(64, 7, 256)
    )
    out = np.asarray(tanh_rule.check_messages(jnp.asarray(msgs, jnp.float32)))
    check(np.isfinite(out).all(), "Tanhf32 check messages not finite")
    log(f"phase 3 Tanhf32 check messages finite, max |m| {np.abs(out).max()}")


def phase_dense_encoder(h_c2):
    """The dense GF(2) encoder (full-precision f32 product) against the
    integer reference, at C2 size."""
    from ldpc_toolbox_tpu.encoder import Encoder
    from ldpc_toolbox_tpu.gf2 import gf2_matmul
    from ldpc_toolbox_tpu.systematic import (
        full_rank_rows,
        permute_columns,
        systematic_permutation,
    )

    h_enc = full_rank_rows(h_c2)
    enc = Encoder(permute_columns(h_enc, systematic_permutation(h_enc)))
    check(not enc.staircase, "C2 encoder is not the dense form")
    rng = np.random.default_rng(SEED + 3)
    msgs = rng.integers(0, 2, size=(256, enc.k), dtype=np.uint8)
    cw = np.asarray(enc.encode_batch(msgs))
    ref = gf2_matmul(msgs, enc._g0.T)
    check(np.array_equal(cw[:, enc.k:], ref), "dense encoder parity wrong")
    log(
        f"phase 3 dense encoder ({enc.n_rows}x{enc.k} G0) on the card "
        f"matches gf2_matmul on 256 messages"
    )


def phase_ber_cli():
    from ldpc_toolbox_tpu import cli

    argv = [
        "ber", BER_SPEC, "--decoder", "HLMinsumbf16",
        "--min-ebn0", "2.0", "--max-ebn0", "2.0", "--step-ebn0", "0.5",
        "--frame-errors", "10", "--max-iter", str(ITERS),
        "--batch-size", str(BATCH), "--max-time", "30",
    ]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    dt = time.perf_counter() - t0
    lines = buf.getvalue().replace("\x1b[1A\x1b[2K", "").splitlines()
    rows = [ln for ln in lines if ln.strip().startswith("2.00")]
    check(rows, "ber printed no row for 2.0 dB")
    last = rows[-1]
    cols = [c.strip() for c in last.split("|")]
    frames, fer = int(cols[1]), float(cols[6])
    log(f"phase 4 ber {' '.join(argv[1:])}")
    log(f"phase 4   {last}")
    log(
        f"phase 4 ber wall {dt:.3f} s (compile included), frames {frames}, "
        f"FER {fer}, peak_bytes_in_use {peak_bytes()}"
    )
    check(frames >= BATCH, f"ber ran {frames} frames, fewer than one batch")
    check(fer <= 1e-2, f"ber FER {fer} > 1e-2 at 2.0 dB")


def phase_determinism(dec, llrs, first, again):
    _, t = timed_decode(dec, llrs, ITERS)
    third, _ = timed_decode(dec, llrs, ITERS)
    for out in (again, third):
        for k in ("success", "iterations", "codeword"):
            check(np.array_equal(first[k], out[k]),
                  f"determinism: {k} changed between identical decodes")
    log(f"phase 5 three repeated flagship decodes identical (run {t:.6f} s)")


def phase_four_cards():
    import jax

    from ldpc_toolbox_tpu.codes.dvbs2 import Code
    from ldpc_toolbox_tpu.decoder.lifted import lifted_graph_for
    from ldpc_toolbox_tpu.parallel import default_mesh
    from ldpc_toolbox_tpu.simulation import BerTestBuilder

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 devices, have {len(devices)}")
    code = Code[FLAGSHIP]
    kw = dict(
        h=code.h(),
        lifted_graph=lifted_graph_for(code),
        decoder_implementation="HLMinsumbf16",
        ebn0s_db=[2.0],
        max_iterations=ITERS,
        batch_size=BATCH,
        seed=SEED,
    )
    key = jax.random.key(SEED)
    sigma = sigma_for(2.0, code.k / code.n)
    mesh = default_mesh(devices[:4])
    sharded = BerTestBuilder(**kw, mesh=mesh).build()
    hlo = sharded._step.lower(key, sigma).compile().as_text()
    gathers = hlo.count("all-gather-start(") + hlo.count("all-gather(")
    reduces = hlo.count("all-reduce-start(") + hlo.count("all-reduce(")
    t0 = time.perf_counter()
    got = jax.device_get(sharded._step(key, sigma))
    t_sh = time.perf_counter() - t0
    peaks = [peak_bytes(d) for d in devices[:4]]
    single = BerTestBuilder(**kw).build()
    t0 = time.perf_counter()
    want = jax.device_get(single._step(key, sigma))
    t_one = time.perf_counter() - t0
    log(
        f"four cards: sharded step (B=4x{BATCH // 4}) compiled HLO has {gathers} "
        f"all-gathers and {reduces} all-reduces; first call {t_sh:.3f} s; "
        f"per-card peak_bytes_in_use {peaks}"
    )
    log(f"four cards: one-card step first call {t_one:.3f} s")
    for label, test in (("sharded", sharded), ("one-card", single)):
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(test._step(key, sigma))
        dt = (time.perf_counter() - t0) / 3
        log(f"four cards: {label} step steady {dt:.6f} s "
            f"({1e-6 * test.k * BATCH / dt:.3f} Mbit/s end to end)")
    log(f"four cards: sharded  {json.dumps({k: int(v) for k, v in got.items()})}")
    log(f"four cards: one card {json.dumps({k: int(v) for k, v in want.items()})}")
    for name, v in want.items():
        check(int(got[name]) == int(v),
              f"four cards: {name} {int(got[name])} != one card {int(v)}")
    check(gathers == 0, "the sharded step all-gathers the batch")
    log("four cards: sharded counters equal the one-card counters")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded BER step on four cards")
    args = parser.parse_args()

    import jax

    from ldpc_toolbox_tpu.cli import _enable_compile_cache
    from ldpc_toolbox_tpu.utils.device import (
        card_identity,
        device_summary,
        require_gpu,
    )

    require_gpu()  # phase 1: exits non-zero without a GPU
    log(card_identity())
    log(f"jax {jax.__version__}")
    _enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        dec, llrs, first, again = phase_flagship()
        phase_rules()
        phase_ber_cli()
        phase_determinism(dec, llrs, first, again)
    log(f"total {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": device_summary()}), flush=True)


if __name__ == "__main__":
    main()
