"""Regenerate results/cpu_floors.json — the single authoritative CPU
floors file — with a pinned protocol.

Protocol (recorded in the file): scalar reference-semantics C++ shim
(capi/bench_capi.cpp), one decoder per worker on ALL host cores, fixed
20 s per row, max 30 iterations, decode-only (AWGN all-zero-codeword
LLRs generated per worker), throughput = k * frames / time (reference
ber.rs:574). Run on an otherwise-idle host: concurrent jobs share its
cores and depress floors by up to ~2x.

Every floor consumed by bench.py must come from this file. Usage: python tools/measure_floors.py [seconds]
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "results" / "cpu_floors.json"
SECONDS = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
MAX_ITERS = 30

#: spec -> (ebn0_db, decoders). ebn0 pins each code's operating point
#: (C2's floor is measured in its waterfall at 4 dB).
PLAN = {
    "dvbs2:R1_2": (1.0, [
        "Minsumf32", "HLMinsumf32", "Minstarapproxf32",
        "HLMinstarapproxf32", "Phif64", "Phif32", "Tanhf32",
        "Minstarapproxi8", "HLMinstarapproxi8", "Aminstari8",
        "HLAminstari8",
    ]),
    "dvbs2:R1_2short": (1.0, ["Minsumf32", "HLMinsumf32"]),
    "dvbs2:R9_10": (3.5, ["HLMinsumf32"]),
    "5g:BG1:384": (1.0, [
        "Minsumf32", "HLMinsumf32", "Minstarapproxi8",
        "HLMinstarapproxi8",
    ]),
    "5g:BG2:384": (1.0, ["HLMinsumf32"]),
    "ccsds:R1_2:4096": (1.0, ["Minsumf32", "HLMinsumf32"]),
    "c2": (4.0, ["Minsumf32", "HLMinsumf32"]),
}


def alist_for(spec: str) -> tuple[pathlib.Path, float, int, int]:
    """(alist path, rate, n, k). Builds + caches the alist under
    results/. k is the true dimension (C2's H has two redundant rows:
    k = 7156, not n - m; codes/ccsds.rs:340)."""
    from tools.bench_row import build

    safe = spec.replace(":", "_").lower()
    path = ROOT / "results" / f"floor_{safe}.alist"
    lg, n, k = build(spec)
    if spec == "c2":
        k = 7156
    if not path.exists():
        from ldpc_toolbox_tpu.codes.ccsds import (
            AR4JACode,
            AR4JAInfoSize,
            AR4JARate,
            C2Code,
        )
        from ldpc_toolbox_tpu.codes.dvbs2 import Code as DvbCode
        from ldpc_toolbox_tpu.codes.nr5g import BaseGraph

        parts = spec.split(":")
        if parts[0] == "dvbs2":
            h = DvbCode[parts[1]].h()
        elif parts[0] == "5g":
            h = BaseGraph[parts[1]].h(int(parts[2]))
        elif parts[0] == "ccsds":
            h = AR4JACode(
                AR4JARate[parts[1]], AR4JAInfoSize[f"K{parts[2]}"]
            ).h()
        else:
            h = C2Code().h()
        path.write_text(h.alist())
    return path, k / n, n, k


def main():
    subprocess.run(
        ["make", "-s", "-C", str(ROOT / "capi"), "bench_capi"], check=True
    )
    floors = {
        "_protocol": (
            f"capi/bench_capi scalar C++ shim, all host cores, "
            f"{SECONDS:.0f}s/row, max {MAX_ITERS} iters, decode-only "
            f"AWGN all-zero-codeword; idle host required; mbps = "
            f"k*frames/time with the TRUE k (C2: 7156)"
        ),
    }
    for spec, (ebn0, decoders) in PLAN.items():
        alist, rate, n, k = alist_for(spec)
        row = {"ebn0_db": ebn0, "n": n, "k": k}
        for dec in decoders:
            out = subprocess.run(
                [
                    str(ROOT / "capi" / "bench_capi"),
                    str(alist), dec, str(MAX_ITERS), str(ebn0),
                    str(rate), str(SECONDS),
                ],
                capture_output=True, text=True, check=True,
            )
            j = json.loads(out.stdout.strip().splitlines()[-1])
            # bench_capi normalizes by n - m (the alist dims); rescale
            # to the true k (differs only for rank-deficient C2)
            k_alist = 7154 if spec == "c2" else k
            row[dec] = round(j["mbps"] * k / k_alist, 3)
            row[f"{dec}:avg_iters"] = j["avg_iters"]
            print(f"{spec:18s} {dec:22s} {row[dec]:8.3f} Mbit/s "
                  f"avg_it={j['avg_iters']}", flush=True)
        floors[spec] = row
    OUT.write_text(json.dumps(floors, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
