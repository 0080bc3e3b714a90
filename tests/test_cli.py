"""CLI subcommand tests (matching cli.rs:30-51 command surface)."""

import contextlib
import io

import numpy as np
import pytest

from ldpc_toolbox_tpu.cli import (
    main,
    parse_duration,
    parse_puncturing_pattern,
)
from ldpc_toolbox_tpu.sparse import SparseMatrix


def run_cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(args)
    return buf.getvalue()


def test_parse_puncturing_pattern():
    assert parse_puncturing_pattern("1,1,1,0") == [True, True, True, False]
    with pytest.raises(ValueError):
        parse_puncturing_pattern("1,2")


def test_parse_duration():
    assert parse_duration("30s") == 30
    assert parse_duration("5m") == 300
    assert parse_duration("1h 30m") == 5400
    assert parse_duration("90") == 90
    for junk in ("5x", "1h 30q", "3s 4", "s", "4 5s", ""):
        with pytest.raises(ValueError):
            parse_duration(junk)


def run_cli_streams(args):
    """(stdout, stderr) of a CLI invocation."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(args)
    return out.getvalue(), err.getvalue()


def test_cli_girth_output_parity():
    """Exact reference girth strings and streams: ccsds/dvbs2/5g print
    ONLY the girth on stdout ("Code girth = N", cli/ccsds.rs:63-68,
    cli/dvbs2.rs:84-89, cli/nr5g.rs:39-46; girth 6 per the reference's
    doc examples); peg prints the alist then girth on stderr with the
    long infinity wording (cli/peg.rs:66-71)."""
    out, err = run_cli_streams(
        ["ccsds", "--rate", "1/2", "--block-size", "1024", "--girth"]
    )
    assert out == "Code girth = 6\n" and err == ""
    out, err = run_cli_streams(["dvbs2", "--rate", "1/2", "--short", "--girth"])
    assert out == "Code girth = 6\n" and err == ""
    out, err = run_cli_streams(
        ["5g", "--base-graph", "2", "--lifting-size", "8", "--girth"]
    )
    assert out.startswith("Code girth = ") and err == ""
    out, err = run_cli_streams(["peg", "8", "16", "3", "1", "--girth"])
    assert out.splitlines()[0] == "16 8"  # alist still on stdout
    assert err.startswith("Code girth = ")


def test_cli_5g_invalid_lifting_size():
    with pytest.raises(SystemExit):
        run_cli_streams(["5g", "--base-graph", "1", "--lifting-size", "100"])


def test_cli_alist_trailing_newline_parity():
    """println! vs print! parity: the alist string itself ends with one
    newline; mackay-neal/systematic/peg/5g println! it (one extra blank
    line), ccsds/dvbs2/ccsds-c2 print! it (no extra)
    (cli/mackay_neal.rs:111, cli/systematic.rs:24, cli/ccsds.rs:70)."""
    out = run_cli(["mackay-neal", "8", "16", "6", "3", "42", "--uniform"])
    assert out.endswith("\n\n") and not out.endswith("\n\n\n")
    out = run_cli(["ccsds", "--rate", "1/2", "--block-size", "1024"])
    assert out.endswith("\n") and not out.endswith("\n\n")
    out = run_cli(["ccsds-c2"])
    assert out.endswith("\n") and not out.endswith("\n\n")
    out = run_cli(["5g", "--base-graph", "2", "--lifting-size", "8"])
    assert out.endswith("\n\n") and not out.endswith("\n\n\n")


def test_cli_mackay_neal_and_systematic(tmp_path):
    alist = run_cli(["mackay-neal", "8", "16", "6", "3", "42", "--uniform"])
    h = SparseMatrix.from_alist(alist)
    assert h.num_rows == 8 and h.num_cols == 16
    f = tmp_path / "code.alist"
    f.write_text(alist)
    sysal = run_cli(["systematic", str(f)])
    hs = SparseMatrix.from_alist(sysal)
    assert hs.num_rows == 8 and hs.num_cols == 16


def test_cli_peg(capsys_disabled=None):
    alist = run_cli(["peg", "8", "16", "3", "1"])
    h = SparseMatrix.from_alist(alist)
    assert all(h.col_weight(c) == 3 for c in range(16))


def test_cli_dvbs2_shapes():
    out = run_cli(["dvbs2", "--rate", "8/9", "--short"])
    assert out.splitlines()[0] == "16200 1800"


def test_cli_dvbs2_invalid_rate():
    with pytest.raises(SystemExit):
        run_cli(["dvbs2", "--rate", "7/8"])


def test_cli_5g():
    out = run_cli(["5g", "--base-graph", "2", "--lifting-size", "8"])
    assert out.splitlines()[0] == "416 336"


def test_cli_ccsds():
    out = run_cli(["ccsds", "--rate", "4/5", "--block-size", "1024"])
    assert out.splitlines()[0] == "1408 384"


def test_cli_encode(tmp_path):
    alist = run_cli(["mackay-neal", "8", "16", "6", "3", "42", "--uniform"])
    code = tmp_path / "code.alist"
    code.write_text(alist)
    sysal = run_cli(["systematic", str(code)])
    syscode = tmp_path / "sys.alist"
    syscode.write_text(sysal)
    msgs = np.random.default_rng(0).integers(0, 2, size=(3, 8), dtype=np.uint8)
    inp = tmp_path / "msgs.bin"
    msgs.tofile(inp)
    out = tmp_path / "cw.bin"
    run_cli(["encode", str(syscode), str(inp), str(out)])
    cw = np.fromfile(out, dtype=np.uint8).reshape(3, 16)
    hd = SparseMatrix.from_alist(sysal).to_dense().astype(int)
    assert not ((cw.astype(int) @ hd.T) & 1).any()
    # punctured variant keeps the first 3/4
    outp = tmp_path / "cwp.bin"
    run_cli(["encode", str(syscode), str(inp), str(outp), "1,1,1,0"])
    cwp = np.fromfile(outp, dtype=np.uint8).reshape(3, 12)
    np.testing.assert_array_equal(cwp, cw[:, :12])


def test_cli_ber(tmp_path):
    alist = run_cli(["mackay-neal", "16", "32", "6", "3", "44", "--uniform"])
    code = tmp_path / "code.alist"
    code.write_text(alist)
    sysal = run_cli(["systematic", str(code)])
    syscode = tmp_path / "sys.alist"
    syscode.write_text(sysal)
    results = tmp_path / "results.txt"
    out = run_cli(
        [
            "ber",
            str(syscode),
            "--decoder",
            "Phif32",
            "--min-ebn0",
            "4.0",
            "--max-ebn0",
            "5.0",
            "--step-ebn0",
            "1.0",
            "--frame-errors",
            "4",
            "--max-iter",
            "20",
            "--batch-size",
            "32",
            "--output-file",
            str(results),
        ]
    )
    assert "Eb/N0" in out
    lines = results.read_text().splitlines()
    assert len(lines) == 4  # 2 header lines + 2 Eb/N0 points
    assert lines[2].strip().startswith("4.00")
    assert lines[3].strip().startswith("5.00")


def test_external_decoder_example():
    """The decoder plug-in surface (examples/external_decoder_ber.py,
    mirroring the reference's examples/external_decoder_ber.rs)."""
    import sys

    sys.path.insert(0, "examples")
    try:
        import external_decoder_ber as ex
    finally:
        sys.path.pop(0)
    ex.register()
    from ldpc_toolbox_tpu.decoder import Decoder
    from ldpc_toolbox_tpu.mackay_neal import Config
    from ldpc_toolbox_tpu.systematic import parity_to_systematic

    h = parity_to_systematic(Config(nrows=16, ncols=32, wr=6, wc=3).run(42))
    dec = Decoder(h, "Offsetminsumf32")
    from ldpc_toolbox_tpu.encoder import Encoder

    enc = Encoder(h)
    msg = np.ones(enc.k, np.uint8)
    cw = enc.encode(msg)
    llr = np.where(cw == 0, 3.0, -3.0)
    llr[0] = -llr[0] * 0.3  # one soft error
    out = dec.decode(llr, 30)
    assert out.success
    np.testing.assert_array_equal(out.codeword, cw)


def test_cli_ber_precompile():
    """`ber --precompile` AOT-compiles the sweep step into the persistent
    cache and exits without running frames."""
    out = run_cli(
        [
            "ber", "5g:2:8", "--decoder", "Minsumf32", "--precompile",
            "--min-ebn0", "1", "--max-ebn0", "1", "--step-ebn0", "1",
            "--max-iter", "4", "--batch-size", "8",
        ]
    )
    assert "precompiled 5g:2:8 Minsumf32" in out
    # frames did not run: no progress rows after the header
    assert "0.00e+00" not in out


def test_cli_precompile_grid_in_one_process(monkeypatch):
    """`precompile` compiles its (code x decoder) grid one shape after
    another in this process: a second JAX process would need a device of
    its own."""
    import subprocess

    def no_subprocess(*a, **k):
        raise AssertionError("precompile started a subprocess")

    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    out = run_cli(
        [
            "precompile", "--codes", "5g:2:8",
            "--decoders", "Minsumf32,HLMinsumf32",
            "--batch-size", "8", "--max-iter", "2",
        ]
    )
    assert "precompiled 5g:2:8 Minsumf32" in out
    assert "precompiled 5g:2:8 HLMinsumf32" in out
    assert "0 failed" in out


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is one fixed directory
    of the checkout, which .gitignore lists."""
    import pathlib

    import jax

    from ldpc_toolbox_tpu import cli

    root = pathlib.Path(__file__).resolve().parent.parent
    assert pathlib.Path(cli.DEFAULT_COMPILE_CACHE) == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text().splitlines()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        cli._enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == cli.DEFAULT_COMPILE_CACHE
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache stays where JAX puts
    it: the program sets no directory of its own."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import jax\n"
        "from ldpc_toolbox_tpu.cli import _enable_compile_cache\n"
        "_enable_compile_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": str(tmp_path),
           "PYTHONPATH": str(root)}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
