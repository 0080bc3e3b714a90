"""Command-line interface.

The 9 subcommands of the reference CLI (cli.rs:30-51) with matching names,
flags and output formats: ``5g``, ``ber``, ``ccsds``, ``ccsds-c2``,
``dvbs2``, ``encode``, ``mackay-neal``, ``peg``, ``systematic``.
Constructions print alists on stdout; ``--girth`` output matches the
reference stream-for-stream (ccsds/dvbs2/5g: girth only, stdout,
"Code girth = N" / "Code girth is infinite"; peg: alist then girth on
stderr). ``ber`` renders the reference's live progress table
(cli/ber.rs:315-340) and optional results files.

Differences from the reference, by design:

* ``--num-threads`` is accepted but ignored; the decode batch, set with
  ``--batch-size``, takes the place of the worker pool.
* ``--shard`` shards the batch over all visible devices.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time


def _die(msg: str) -> "NoReturn":  # noqa: F821
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(1)


def parse_puncturing_pattern(s: str) -> list[bool]:
    """Parse "1,1,1,0" (cli/ber.rs:219-229)."""
    out = []
    for a in s.split(","):
        if a == "0":
            out.append(False)
        elif a == "1":
            out.append(True)
        else:
            raise ValueError("invalid puncturing pattern")
    return out


def parse_duration(s: str) -> float:
    """Parse humantime-style durations: "30s", "5m", "1h 30m"; a bare
    number is seconds (framework extension — humantime requires a unit).
    Strict like humantime: unknown units and trailing junk are errors."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    units = {
        "ms": 1e-3, "s": 1.0, "sec": 1.0, "secs": 1.0, "m": 60.0,
        "min": 60.0, "mins": 60.0, "h": 3600.0, "hr": 3600.0,
        "hours": 3600.0, "hour": 3600.0, "d": 86400.0, "day": 86400.0,
        "days": 86400.0,
    }
    total = 0.0
    pos = 0
    pattern = re.compile(r"\s*([0-9]+(?:\.[0-9]+)?)\s*([a-z]*)\s*")
    while pos < len(s):
        m = pattern.match(s, pos)
        if m is None or m.start(1) != pos and not s[pos:m.start(1)].isspace():
            raise ValueError(f"cannot parse duration {s!r}")
        num, unit = m.group(1), m.group(2)
        if unit == "":
            # bare seconds allowed only as the entire input
            if pos != 0 or m.end() != len(s):
                raise ValueError(f"cannot parse duration {s!r}")
            total += float(num)
        elif unit in units:
            total += float(num) * units[unit]
        else:
            raise ValueError(f"unknown duration unit {unit!r}")
        pos = m.end()
    return total


def _print_alist_or_girth(h, girth: bool, alist_newline: bool = False) -> None:
    """Reference semantics for the standards subcommands: ``--girth``
    prints ONLY the girth, on stdout ("Code girth = N" / "Code girth is
    infinite", cli/ccsds.rs:63-68, cli/dvbs2.rs:84-89, cli/nr5g.rs:39-46);
    otherwise the alist. ``alist_newline`` matches the reference's
    ``println!`` (5g) vs ``print!`` (ccsds, dvbs2)."""
    if girth:
        g = h.girth()
        if g is None:
            print("Code girth is infinite")
        else:
            print(f"Code girth = {g}")
    else:
        sys.stdout.write(h.alist() + ("\n" if alist_newline else ""))


# -- subcommand runners ------------------------------------------------------


def run_5g(args) -> None:
    from .codes.nr5g import LIFTING_SIZES, BaseGraph

    bg = BaseGraph.BG1 if args.base_graph == "1" else BaseGraph.BG2
    if args.lifting_size not in LIFTING_SIZES:
        # the reference validates Z as a clap ValueEnum (nr5g.rs:78-232)
        _die(
            f"invalid lifting size {args.lifting_size} "
            f"(valid: {', '.join(str(z) for z in sorted(LIFTING_SIZES))})"
        )
    h = bg.h(args.lifting_size)
    _print_alist_or_girth(h, args.girth, alist_newline=True)


def run_ccsds(args) -> None:
    from .codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate

    rates = {"1/2": AR4JARate.R1_2, "2/3": AR4JARate.R2_3, "4/5": AR4JARate.R4_5}
    sizes = {
        1024: AR4JAInfoSize.K1024,
        4096: AR4JAInfoSize.K4096,
        16384: AR4JAInfoSize.K16384,
    }
    if args.rate not in rates:
        _die(f"invalid rate {args.rate}")
    if args.block_size not in sizes:
        _die(f"invalid block size {args.block_size}")
    h = AR4JACode(rates[args.rate], sizes[args.block_size]).h()
    _print_alist_or_girth(h, args.girth)


def run_ccsds_c2(args) -> None:
    from .codes.ccsds import C2Code

    sys.stdout.write(C2Code().h().alist())


def run_dvbs2(args) -> None:
    from .codes.dvbs2 import Code

    name = "R" + args.rate.replace("/", "_") + ("short" if args.short else "")
    try:
        code = Code[name]
    except KeyError:
        frame = "short" if args.short else "normal"
        _die(f"Invalid rate {args.rate} for {frame} FECFRAME")
    _print_alist_or_girth(code.h(), args.girth)


def run_mackay_neal(args) -> None:
    from .mackay_neal import Config, FillPolicy, MacKayNealError

    conf = Config(
        nrows=args.num_rows,
        ncols=args.num_columns,
        wr=args.wr,
        wc=args.wc,
        backtrack_cols=args.backtrack_cols,
        backtrack_trials=args.backtrack_trials,
        min_girth=args.min_girth,
        girth_trials=args.girth_trials,
        fill_policy=FillPolicy.UNIFORM if args.uniform else FillPolicy.RANDOM,
    )
    if args.search:
        found = conf.search(args.seed, args.seed_trials)
        if found is None:
            _die("no solution found")  # cli/mackay_neal.rs:105
        seed, h = found
        print(f"seed = {seed}", file=sys.stderr)
    else:
        try:
            h = conf.run(args.seed)
        except MacKayNealError as e:
            _die(str(e))
    print(h.alist())  # println! (cli/mackay_neal.rs:111)


def run_peg(args) -> None:
    from .peg import Config, PegError

    conf = Config(nrows=args.num_rows, ncols=args.num_columns, wc=args.wc)
    try:
        h = conf.run(args.seed)
    except PegError as e:
        _die(str(e))
    for r in range(h.num_rows):
        if h.row_weight(r) < 2:
            # exact reference wording incl. the Unicode relation signs
            # (cli/peg.rs:56-64)
            msg = "warning: at least 1 row weight ≤ 1"
            if conf.wc < 3:
                msg += " (try col weight ≥ 3?)"
            print(msg, file=sys.stderr)
            break
    print(h.alist())  # println! (cli/peg.rs:66)
    if args.girth:
        # peg reports girth on STDERR, with the long infinity wording
        # (cli/peg.rs:67-71) — unlike ccsds/dvbs2/5g
        g = h.girth()
        if g is None:
            print("Code girth = infinity (there are no cycles)", file=sys.stderr)
        else:
            print(f"Code girth = {g}", file=sys.stderr)


def run_systematic(args) -> None:
    from .sparse import SparseMatrix
    from .systematic import SystematicError, parity_to_systematic

    h = SparseMatrix.from_alist_file(args.alist)
    try:
        hs = parity_to_systematic(h)
    except SystematicError as e:
        _die(str(e))
    print(hs.alist())  # println! (cli/systematic.rs:24)


def run_encode(args) -> None:
    import numpy as np

    from .encoder import Encoder, EncoderError
    from .simulation.puncturing import Puncturer
    from .sparse import SparseMatrix

    h = SparseMatrix.from_alist_file(args.alist)
    try:
        encoder = Encoder(h)
    except EncoderError as e:
        _die(str(e))
    puncturer = (
        Puncturer(parse_puncturing_pattern(args.puncturing))
        if args.puncturing
        else None
    )
    k = encoder.k
    # constant-memory streaming like the reference's read_exact loop
    # (cli/encode.rs:34-71): read a bounded chunk of frames, batch-encode
    # it, write, repeat; a trailing partial word is ignored (read_exact
    # EOF semantics).
    chunk_frames = max(1, (1 << 22) // k)
    with open(args.input, "rb") as inp, open(args.output, "wb") as out:
        pending = b""
        while True:
            buf = inp.read(chunk_frames * k - len(pending))
            data = pending + buf
            nwords = len(data) // k
            pending = data[nwords * k :]
            if nwords == 0:
                if not buf:
                    return
                continue
            msgs = np.frombuffer(data[: nwords * k], np.uint8).reshape(
                nwords, k
            )
            cw = np.asarray(encoder.encode_batch(msgs))
            if puncturer is not None:
                cw = np.asarray(puncturer.puncture(cw))
            out.write(cw.astype(np.uint8).tobytes())
            if not buf:
                return


_BER_HEADER = (
    "  Eb/N0 |   Frames | Bit errs | Frame er | False de |     BER |"
    "     FER | Avg iter | Avg corr | Throughp | Elapsed\n"
    "--------|----------|----------|----------|----------|---------|"
    "---------|----------|----------|----------|----------"
)


def _format_duration(seconds: float) -> str:
    """Whole-second humantime-like rendering ("1m 5s")."""
    s = int(seconds)
    if s == 0:
        return "0s"
    parts = []
    for unit, size in (("d", 86400), ("h", 3600), ("m", 60), ("s", 1)):
        if s >= size:
            parts.append(f"{s // size}{unit}")
            s %= size
    return " ".join(parts)


def _format_progress(stats, force_ldpc: bool) -> str:
    code_stats = stats.ldpc if (force_ldpc or stats.bch is None) else stats.bch
    return (
        f"{stats.ebn0_db:7.2f} | {stats.num_frames:8} | "
        f"{code_stats.bit_errors:8} | {code_stats.frame_errors:8} | "
        f"{stats.false_decodes:8} | {code_stats.ber:7.2e} | "
        f"{code_stats.fer:7.2e} | {stats.average_iterations:8.1f} | "
        f"{code_stats.average_iterations_correct:8.1f} | "
        f"{stats.throughput_mbps:8.3f} | "
        f"{_format_duration(stats.elapsed)}"
    )


def _resolve_ber_code(spec: str):
    """Resolve the ber positional: an alist path, or a code spec
    ("dvbs2:1/2", "dvbs2:1/2:short", "5g:1:384", "ccsds:1/2:1024",
    "ccsds-c2") — specs additionally enable the block-circulant fast path.
    Returns (h, lifted_graph_or_None)."""
    import os

    from .decoder.lifted import LiftedGraph, lifted_graph_for
    from .sparse import SparseMatrix

    if os.path.exists(spec) or ":" not in spec and spec != "ccsds-c2":
        try:
            return SparseMatrix.from_alist_file(spec), None
        except (FileNotFoundError, ValueError) as e:
            _die(f"cannot read alist {spec!r}: {e}")
    parts = spec.split(":")
    if parts[0] == "dvbs2":
        from .codes.dvbs2 import Code

        name = "R" + parts[1].replace("/", "_")
        if len(parts) > 2 and parts[2] == "short":
            name += "short"
        code = Code[name]
        return code.h(), lifted_graph_for(code)
    if parts[0] == "5g":
        from .codes.nr5g import BaseGraph
        from .decoder.lifted import nr5g_maps

        bg = BaseGraph.BG1 if parts[1] == "1" else BaseGraph.BG2
        z = int(parts[2])
        h = bg.h(z)
        vm, cm, Z, nvg, ncg = nr5g_maps(bg, z)
        return h, LiftedGraph.from_sparse(h, vm, cm, Z, nvg, ncg)
    if parts[0] == "ccsds":
        from .codes.ccsds import AR4JACode, AR4JAInfoSize, AR4JARate

        rate = {"1/2": AR4JARate.R1_2, "2/3": AR4JARate.R2_3,
                "4/5": AR4JARate.R4_5}[parts[1]]
        size = {1024: AR4JAInfoSize.K1024, 4096: AR4JAInfoSize.K4096,
                16384: AR4JAInfoSize.K16384}[int(parts[2])]
        code = AR4JACode(rate, size)
        return code.h(), lifted_graph_for(code)
    if parts[0] == "ccsds-c2":
        from .codes.ccsds import C2Code

        code = C2Code()
        return code.h(), lifted_graph_for(code)
    _die(f"cannot resolve code spec or alist path {spec!r}")


def _systematic_perm_if_needed(h):
    """(perm, encoder_h, encoder) — (None, None, Encoder) when H builds
    a direct systematic encoder (the probe Encoder is returned so BerTest
    does not repeat the dense GF(2) Gauss reduction), (perm, h_enc, None)
    otherwise.

    C2's trailing square submatrix is singular — and its H is even
    rank-deficient (1022 rows, rank 1020: the (8176, 7156) code, where
    the reference's own `systematic` subcommand errors out). For such
    codes this CLI reduces H to its full-rank row space for *encoding*
    (systematic.full_rank_rows) and computes the systematic column
    permutation; the harness encodes on encoder_h[:, perm] while the
    channel and (lifted fast-path) decoder run in the original column
    order with every redundant check intact."""
    from .encoder import Encoder, EncoderError
    from .systematic import (
        SystematicError,
        full_rank_rows,
        systematic_permutation,
    )

    try:
        return None, None, Encoder(h)
    except EncoderError:
        pass
    h_enc = full_rank_rows(h)
    try:
        perm = systematic_permutation(h_enc)
    except SystematicError as e:
        _die(str(e))
    return perm, (None if h_enc is h else h_enc), None


def run_ber(args) -> None:
    from .simulation.factory import BerTestBuilder, Modulation

    try:
        puncturing = (
            parse_puncturing_pattern(args.puncturing) if args.puncturing else None
        )
    except ValueError as e:
        _die(str(e))
    try:
        h, lifted = _resolve_ber_code(args.alist)
    except (KeyError, ValueError, IndexError) as e:
        _die(f"invalid code spec {args.alist!r}: {e!r}")
    if args.no_lifted:
        lifted = None
    sys_perm, enc_h, prebuilt_enc = _systematic_perm_if_needed(h)
    num_ebn0s = int((args.max_ebn0 - args.min_ebn0) / args.step_ebn0) + 1
    ebn0s = [args.min_ebn0 + i * args.step_ebn0 for i in range(num_ebn0s)]

    mesh = None
    if args.shard:
        from .parallel import default_mesh

        mesh = default_mesh()

    state = {"last_ebn0": None, "printed": False}

    def reporter(stats, final):
        if state["printed"] and state["last_ebn0"] == stats.ebn0_db:
            # rewrite the current line in place
            sys.stdout.write("\x1b[1A\x1b[2K")
        sys.stdout.write(_format_progress(stats, False) + "\n")
        sys.stdout.flush()
        state["last_ebn0"] = stats.ebn0_db
        state["printed"] = True
        if final:
            if out_file:
                out_file.write(_format_progress(stats, False) + "\n")
                out_file.flush()
            if out_file_ldpc:
                out_file_ldpc.write(_format_progress(stats, True) + "\n")
                out_file_ldpc.flush()

    try:
        modulation = Modulation.parse(args.modulation)
    except ValueError as e:
        _die(str(e))
    test = BerTestBuilder(
        h=h,
        modulation=modulation,
        decoder_implementation=args.decoder,
        puncturing_pattern=puncturing,
        interleaving_columns=args.interleaving,
        max_frame_errors=args.frame_errors,
        min_run_time=parse_duration(args.min_time) if args.min_time else None,
        max_run_time=parse_duration(args.max_time) if args.max_time else None,
        max_iterations=args.max_iter,
        ebn0s_db=ebn0s,
        reporter=reporter,
        bch_max_errors=args.bch_max_errors,
        batch_size=args.batch_size,
        seed=args.seed,
        mesh=mesh,
        lifted_graph=lifted,
        checkpoint_path=args.checkpoint,
        profile_dir=args.profile_dir,
        systematic_permutation=sys_perm,
        encoder_h=enc_h,
        prebuilt_encoder=prebuilt_enc,
    )
    try:
        test = test.build()
    except (ValueError, KeyError) as e:
        _die(str(e))
    if args.precompile:
        # compile the jitted sweep step (AOT lower+compile, no frames
        # run) with exactly the avals test.run() will call it with, so
        # the persistent compile cache is warm for the real invocation
        import jax

        t0 = time.perf_counter()
        test._step.lower(jax.random.key(args.seed), 0.5).compile()
        dt = time.perf_counter() - t0
        print(
            f"precompiled {args.alist} {args.decoder} "
            f"batch={args.batch_size} max_iter={args.max_iter} "
            f"modulation={args.modulation} in {dt:.1f}s"
        )
        return
    out_file = open(args.output_file, "w") if args.output_file else None
    out_file_ldpc = (
        open(args.output_file_ldpc, "w")
        if (args.output_file_ldpc and args.bch_max_errors > 0)
        else None
    )

    print(_BER_HEADER)
    for f in (out_file, out_file_ldpc):
        if f:
            f.write(_BER_HEADER + "\n")
    try:
        test.run()
    except KeyboardInterrupt:
        # reference traps Ctrl-C to restore the terminal (cli/ber.rs:
        # 254-261); here the sweep additionally left a resumable
        # checkpoint before unwinding
        sys.stdout.write("\n")
        msg = "interrupted"
        if args.checkpoint:
            msg += f"; resume with --checkpoint {args.checkpoint}"
        print(msg, file=sys.stderr)
        sys.exit(130)
    finally:
        for f in (out_file, out_file_ldpc):
            if f:
                f.close()


def run_precompile(args) -> None:
    """Warm the persistent compile cache: ``ber --precompile`` for each
    (code, decoder) shape of the grid, one after another in this process
    (a second JAX process would need a device of its own)."""
    codes = [c for c in args.codes.split(",") if c]
    decoders = [d for d in args.decoders.split(",") if d]
    parser = build_parser()
    failed = []
    t0 = time.perf_counter()
    print(
        f"precompiling {len(codes) * len(decoders)} shapes "
        f"(batch={args.batch_size}, max_iter={args.max_iter})"
    )
    for code in codes:
        for dec in decoders:
            ber_args = parser.parse_args([
                "ber", code, "--decoder", dec, "--precompile",
                "--min-ebn0", "1", "--max-ebn0", "1", "--step-ebn0", "1",
                "--batch-size", str(args.batch_size),
                "--max-iter", str(args.max_iter),
                "--modulation", args.modulation,
            ])
            try:
                run_ber(ber_args)
            except SystemExit:  # _die already printed the reason
                print(f"  FAIL {code} {dec}")
                failed.append((code, dec))
    print(f"done in {time.perf_counter() - t0:.0f}s, {len(failed)} failed")
    if failed:
        sys.exit(1)


# -- parser ------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldpc-toolbox-tpu",
        description="LDPC toolbox on JAX (capability parity with ldpc-toolbox)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("5g", help="Generates the alist of 5G NR LDPCs")
    s.add_argument("--base-graph", required=True, choices=["1", "2"])
    s.add_argument("--lifting-size", required=True, type=int)
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_5g)

    s = sub.add_parser("ber", help="Performs a BER simulation")
    s.add_argument(
        "alist",
        help="alist file, or a code spec enabling the block-circulant fast "
        "path: dvbs2:RATE[:short], 5g:BG:Z, ccsds:RATE:K, ccsds-c2",
    )
    s.add_argument("--output-file")
    s.add_argument("--output-file-ldpc")
    s.add_argument("--decoder", default="Phif64")
    s.add_argument("--modulation", default="BPSK", choices=["BPSK", "8PSK"])
    s.add_argument("--puncturing")
    s.add_argument("--interleaving", type=int)
    s.add_argument("--min-ebn0", type=float, required=True)
    s.add_argument("--max-ebn0", type=float, required=True)
    s.add_argument("--step-ebn0", type=float, required=True)
    s.add_argument("--max-iter", type=int, default=100)
    s.add_argument("--frame-errors", type=int, default=100)
    s.add_argument("--min-time")
    s.add_argument("--max-time")
    s.add_argument("--bch-max-errors", type=int, default=0)
    s.add_argument("--batch-size", type=int, default=128)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--shard", action="store_true",
                   help="shard the batch over all devices")
    s.add_argument("--num-threads", type=int, default=None,
                   help="accepted for reference-CLI compatibility (ignored)")
    s.add_argument("--checkpoint", help="sweep checkpoint file (resumable)")
    s.add_argument("--profile-dir", help="jax.profiler trace directory")
    s.add_argument("--no-lifted", action="store_true",
                   help="disable the block-circulant fast path")
    s.add_argument("--precompile", action="store_true",
                   help="compile the sweep step into the persistent "
                   "cache and exit (no frames run)")
    s.set_defaults(func=run_ber)

    s = sub.add_parser(
        "precompile",
        help="Warm the persistent compile cache for a set of "
        "(code, decoder) shapes",
    )
    s.add_argument(
        "--codes",
        default="dvbs2:1/2,dvbs2:1/2:short,5g:1:384,5g:2:384,"
        "ccsds:1/2:4096,ccsds-c2",
        help="comma-separated ber code specs",
    )
    s.add_argument(
        "--decoders",
        default="Minsumbf16,HLMinsumbf16",
        help="comma-separated decoder implementation names",
    )
    s.add_argument("--batch-size", type=int, default=128)
    s.add_argument("--max-iter", type=int, default=100)
    s.add_argument("--modulation", default="BPSK", choices=["BPSK", "8PSK"])
    s.set_defaults(func=run_precompile)

    s = sub.add_parser("ccsds", help="Generates the alist of CCSDS LDPCs")
    s.add_argument("-r", "--rate", required=True)
    s.add_argument("--block-size", type=int, required=True)
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_ccsds)

    s = sub.add_parser("ccsds-c2", help="Generates the alist of CCSDS C2 LDPC")
    s.set_defaults(func=run_ccsds_c2)

    s = sub.add_parser("dvbs2", help="Generates the alist of DVB-S2 LDPCs")
    s.add_argument("-r", "--rate", required=True)
    s.add_argument("--short", action="store_true")
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_dvbs2)

    s = sub.add_parser("encode", help="Encodes a file of unpacked bits")
    s.add_argument("alist")
    s.add_argument("input")
    s.add_argument("output")
    s.add_argument("puncturing", nargs="?")
    s.set_defaults(func=run_encode)

    s = sub.add_parser("mackay-neal", help="Generates a MacKay-Neal LDPC")
    s.add_argument("num_rows", type=int)
    s.add_argument("num_columns", type=int)
    s.add_argument("wr", type=int)
    s.add_argument("wc", type=int)
    s.add_argument("seed", type=int)
    s.add_argument("--backtrack-cols", type=int, default=0)
    s.add_argument("--backtrack-trials", type=int, default=0)
    s.add_argument("--min-girth", type=int)
    s.add_argument("--girth-trials", type=int, default=0)
    s.add_argument("--uniform", action="store_true")
    s.add_argument("--seed-trials", type=int, default=1000)
    s.add_argument("--search", action="store_true")
    s.set_defaults(func=run_mackay_neal)

    s = sub.add_parser("peg", help="Generates an LDPC with Progressive Edge Growth")
    s.add_argument("num_rows", type=int)
    s.add_argument("num_columns", type=int)
    s.add_argument("wc", type=int)
    s.add_argument("seed", type=int)
    s.add_argument("--girth", action="store_true")
    s.set_defaults(func=run_peg)

    s = sub.add_parser(
        "systematic",
        help="Permutes the columns of an alist to make the code systematic",
    )
    s.add_argument("alist")
    s.set_defaults(func=run_systematic)

    return p


#: persistent compile cache when JAX_COMPILATION_CACHE_DIR is not set: one
#: fixed directory inside the checkout (listed in .gitignore), so every run
#: from this checkout finds what an earlier one compiled
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compile_cache() -> None:
    """Persist compiled executables across runs. JAX itself reads
    ``JAX_COMPILATION_CACHE_DIR``; only without it is the cache pointed at
    ``DEFAULT_COMPILE_CACHE``."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_COMPILE_CACHE, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _enable_compile_cache()
    args.func(args)


if __name__ == "__main__":
    main()
