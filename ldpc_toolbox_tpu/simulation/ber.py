"""Monte-Carlo BER/FER simulation harness (batched, sharded, jitted).

Rebuild of the reference's ``src/simulation/ber.rs``. The reference runs a
thread-per-worker frame loop with mpsc fan-in (ber.rs:303-359); here the
whole per-frame chain — random message, encode, puncture, interleave,
modulate, AWGN, demodulate, deinterleave, depuncture, decode, count
systematic bit errors (ber.rs:436-481) — is ONE jitted step over a batch
of frames, with the noise standard deviation as a traced scalar so a
single compilation serves every Eb/N0 point. The codeword batch shards
over a device mesh; the step returns nine scalar counters, reduced on
device (an all-reduce across devices when sharded).

Semantics preserved from the reference:

* sigma = sqrt(0.5 / (rate * bits_per_symbol * 10^(EbN0/10))), with
  rate = k/n after puncturing (ber.rs:246-302);
* bit errors counted on systematic bits only (ber.rs:467-472);
* ``false_decode`` = decoder converged but wrong (ber.rs:474);
* stop rule per point: frame_errors >= max AND elapsed >= min_time, or
  elapsed >= max_time (ber.rs:522-531);
* optional virtual BCH outer decoder: frames with residual bit errors
  <= bch_max_errors count as corrected; termination then keys on BCH
  frame errors (ber.rs:328-337, 514-520);
* Statistics fields including throughput_mbps = 1e-6*k*frames/elapsed
  (ber.rs:550-582).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..decoder import DecodeGraph, flooding_decode, layered_decode
from ..decoder.factory import make_arithmetic
from ..encoder import Encoder
from ..sparse import SparseMatrix
from .channel import AwgnChannel
from .interleaving import Interleaver
from .modulation import Bpsk
from .puncturing import Puncturer

__all__ = [
    "BerTest",
    "BerTestParameters",
    "Statistics",
    "CodeStatistics",
]


@dataclass
class CodeStatistics:
    """Per-code-layer statistics (ber.rs:168-189)."""

    bit_errors: int = 0
    frame_errors: int = 0
    correct_iterations: int = 0
    ber: float = 0.0
    fer: float = 0.0
    average_iterations_correct: float = 0.0


@dataclass
class Statistics:
    """Statistics for one Eb/N0 point (ber.rs:145-166)."""

    ebn0_db: float
    num_frames: int
    false_decodes: int
    total_iterations: int
    average_iterations: float
    elapsed: float  # seconds
    throughput_mbps: float
    ldpc: CodeStatistics
    bch: Optional[CodeStatistics] = None


@dataclass
class BerTestParameters:
    """Configuration of a BER test (mirrors BerTestParameters, ber.rs:60-96)."""

    h: SparseMatrix
    decoder_implementation: str = "Phif64"
    puncturing_pattern: Optional[Sequence[bool]] = None
    # abs value = columns; negative = read rows backwards (ber.rs:66-70)
    interleaving_columns: Optional[int] = None
    max_frame_errors: int = 100
    min_run_time: Optional[float] = None  # seconds
    max_run_time: Optional[float] = None
    max_iterations: int = 100
    ebn0s_db: Sequence[float] = field(default_factory=list)
    # reporter(stats, final) called every >= report_interval and per point
    reporter: Optional[Callable[[Statistics, bool], None]] = None
    report_interval: float = 0.5
    bch_max_errors: int = 0
    # batch of frames per decode step (takes the place of the reference's
    # num_workers)
    batch_size: int = 128
    seed: int = 0
    mesh: Optional[object] = None  # jax.sharding.Mesh for multi-chip runs
    # block-circulant fast path: a decoder.lifted.LiftedGraph for the code
    lifted_graph: Optional[object] = None
    # checkpoint file: sweep state is saved after every completed Eb/N0
    # point (and periodically within a point) so long sweeps are resumable
    checkpoint_path: Optional[str] = None
    # directory for jax.profiler traces (one trace per Eb/N0 point)
    profile_dir: Optional[str] = None
    # column permutation to a systematic-encodable form (systematic.py
    # systematic_permutation): encoding happens on h[:, perm] (whose
    # trailing square is invertible), the channel/decoder run in the
    # original column order (preserving the lifted fast path), and bit
    # errors are counted on the message positions perm[:k]. Needed for
    # codes like CCSDS C2 whose own trailing square is singular.
    systematic_permutation: Optional[object] = None
    # full-rank encoding matrix for rank-deficient codes (systematic.py
    # full_rank_rows): same null space as h but with redundant rows
    # dropped, so k = n - rank. Encoding/permutation use this matrix;
    # the decoder keeps h's redundant checks. CCSDS C2's 1022-row H has
    # rank 1020 — the (8176, 7156) code of the CCSDS docs.
    encoder_h: Optional[SparseMatrix] = None
    # an Encoder already built for encoder_h (or h): skips the second
    # dense GF(2) Gauss reduction when the caller probed encodability
    # (cli._systematic_perm_if_needed)
    prebuilt_encoder: Optional[object] = None


@dataclass
class _Counters:
    num_frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    false_decodes: int = 0
    total_iterations: int = 0
    correct_iterations: int = 0
    bch_bit_errors: int = 0
    bch_frame_errors: int = 0
    bch_correct_iterations: int = 0

    def add(self, d):
        self.num_frames += int(d["num_frames"])
        self.bit_errors += int(d["bit_errors"])
        self.frame_errors += int(d["frame_errors"])
        self.false_decodes += int(d["false_decodes"])
        self.total_iterations += int(d["total_iterations"])
        self.correct_iterations += int(d["correct_iterations"])
        self.bch_bit_errors += int(d["bch_bit_errors"])
        self.bch_frame_errors += int(d["bch_frame_errors"])
        self.bch_correct_iterations += int(d["bch_correct_iterations"])


def _shard_decode(decode, mesh):
    """Run a lifted decode per shard over the mesh ``batch`` axis.

    Left to the SPMD partitioner, the lifted decode's plane gathers
    all-gather the batch: its compiled BER step holds four all-gathers
    (layered) or seven (flooding) on a 4-device mesh. ``shard_map``
    instead runs the whole decode on each device's local batch shard —
    frames are independent, so this is exact, and the step keeps only
    the counter all-reduce — and each shard's iteration ``while_loop``
    exits as soon as *its* frames converge rather than the global worst
    case.
    """
    from jax.sharding import PartitionSpec

    spec = PartitionSpec("batch")

    def sharded(graph, arithmetic, llr, max_iterations):
        def local(x):
            return decode(graph, arithmetic, x, max_iterations)

        # check_vma=False: the decode allocates fresh while_loop carries
        # (e.g. per-frame iteration counters) that JAX types as unvarying,
        # clashing with the batch-varying data carries. The function is
        # axis-name-agnostic and purely per-frame, so the check is moot.
        return jax.shard_map(
            local, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False
        )(llr)

    return sharded


class BerTest:
    """BER test over a list of Eb/N0 points."""

    def __init__(self, parameters: BerTestParameters, modulation=None):
        p = parameters
        self.p = p
        self.modulation = modulation if modulation is not None else Bpsk()
        h = p.h
        enc_h = p.encoder_h if p.encoder_h is not None else h
        self.k = h.num_cols - enc_h.num_rows
        self.n_cw = h.num_cols
        self.puncturer = (
            Puncturer(p.puncturing_pattern) if p.puncturing_pattern else None
        )
        self.interleaver = (
            Interleaver(abs(p.interleaving_columns), p.interleaving_columns < 0)
            if p.interleaving_columns
            else None
        )
        punct_rate = self.puncturer.rate() if self.puncturer else 1.0
        self.n = round(self.n_cw / punct_rate)
        self.rate = self.k / self.n
        if p.systematic_permutation is not None:
            import numpy as np

            from ..systematic import permute_columns

            perm = np.asarray(p.systematic_permutation, np.int64)
            self.encoder = Encoder(permute_columns(enc_h, perm))
            # permuted codeword -> original column order for the channel
            self._enc_unperm = jnp.asarray(np.argsort(perm))
            # message bits live at these original-order positions
            self._msg_cols = jnp.asarray(perm[: self.k])
        else:
            self.encoder = (
                p.prebuilt_encoder
                if p.prebuilt_encoder is not None
                else Encoder(enc_h)
            )
            self._enc_unperm = None
            self._msg_cols = None
        self.schedule, self.arithmetic = make_arithmetic(
            p.decoder_implementation
        )
        if p.lifted_graph is not None and self.schedule in (
            "flooding",
            "layered",
        ):
            from ..decoder.lifted_flooding import lifted_flooding_decode
            from ..decoder.lifted_layered import lifted_layered_decode

            self.graph = p.lifted_graph
            self._decode = (
                lifted_flooding_decode
                if self.schedule == "flooding"
                else lifted_layered_decode
            )
            if p.mesh is not None:
                self._decode = _shard_decode(self._decode, p.mesh)
        else:
            self.graph = DecodeGraph.from_sparse(h)
            self._decode = (
                flooding_decode
                if self.schedule == "flooding"
                else layered_decode
            )
        self.statistics: list[Statistics] = []
        self._step = jax.jit(self._make_step())

    # -- the jitted per-batch step ----------------------------------------

    def _make_step(self):
        p = self.p
        B = p.batch_size
        k = self.k
        mod = self.modulation
        mesh = p.mesh

        def step(key, noise_sigma):
            kmsg, knoise = jax.random.split(key)
            msg = jax.random.bernoulli(kmsg, 0.5, (B, k)).astype(jnp.uint8)
            if mesh is not None:
                from ..parallel import shard_batch

                msg = shard_batch(msg, mesh)
            cw = self.encoder._encode_batch(msg)
            if self._enc_unperm is not None:
                cw = cw[:, self._enc_unperm]
            tx = self.puncturer.puncture(cw) if self.puncturer else cw
            tx = self.interleaver.interleave(tx) if self.interleaver else tx
            sym = mod.modulate(tx)
            rx = AwgnChannel.add_noise(knoise, sym, noise_sigma)
            llr = mod.demodulate(rx, noise_sigma)
            llr = self.interleaver.deinterleave(llr) if self.interleaver else llr
            llr = self.puncturer.depuncture(llr) if self.puncturer else llr
            out = self._decode(
                self.graph, self.arithmetic, llr, p.max_iterations
            )
            # bit errors on systematic bits only (ber.rs:467-472)
            sys_bits = (
                out["codeword"][:, :k]
                if self._msg_cols is None
                else out["codeword"][:, self._msg_cols]
            )
            errbits = jnp.sum(sys_bits != msg, axis=1, dtype=jnp.int32)
            frame_err = errbits > 0
            false_dec = frame_err & out["success"]
            iters = out["iterations"]
            bch_frame_err = errbits > p.bch_max_errors
            # int32 per-step counters (host accumulates in Python ints)
            s = partial(jnp.sum, dtype=jnp.int32)
            return {
                "num_frames": jnp.int32(B),
                "bit_errors": s(errbits),
                "frame_errors": s(frame_err),
                "false_decodes": s(false_dec),
                "total_iterations": s(iters),
                "correct_iterations": s(jnp.where(frame_err, 0, iters)),
                "bch_bit_errors": s(jnp.where(bch_frame_err, errbits, 0)),
                "bch_frame_errors": s(bch_frame_err),
                "bch_correct_iterations": s(
                    jnp.where(bch_frame_err, 0, iters)
                ),
            }

        return step

    # -- driver loop -------------------------------------------------------

    def _point_statistics(
        self, c: _Counters, ebn0_db: float, elapsed: float
    ) -> Statistics:
        nf = max(c.num_frames, 1)
        has_bch = self.p.bch_max_errors > 0
        ldpc = CodeStatistics(
            bit_errors=c.bit_errors,
            frame_errors=c.frame_errors,
            correct_iterations=c.correct_iterations,
            ber=c.bit_errors / (self.k * nf),
            fer=c.frame_errors / nf,
            average_iterations_correct=(
                c.correct_iterations / max(nf - c.frame_errors, 1)
            ),
        )
        bch = None
        if has_bch:
            bch = CodeStatistics(
                bit_errors=c.bch_bit_errors,
                frame_errors=c.bch_frame_errors,
                correct_iterations=c.bch_correct_iterations,
                ber=c.bch_bit_errors / (self.k * nf),
                fer=c.bch_frame_errors / nf,
                average_iterations_correct=(
                    c.bch_correct_iterations / max(nf - c.bch_frame_errors, 1)
                ),
            )
        return Statistics(
            ebn0_db=ebn0_db,
            num_frames=c.num_frames,
            false_decodes=c.false_decodes,
            total_iterations=c.total_iterations,
            average_iterations=c.total_iterations / nf,
            elapsed=elapsed,
            throughput_mbps=1e-6 * self.k * c.num_frames / max(elapsed, 1e-12),
            ldpc=ldpc,
            bch=bch,
        )

    # -- sweep checkpointing (SURVEY.md §5: resumable multi-host sweeps) ----

    def _checkpoint_state(self, point, counters, step_idx, point_elapsed):
        import dataclasses

        return {
            "version": 1,
            "seed": self.p.seed,
            "ebn0s_db": [float(e) for e in self.p.ebn0s_db],
            "decoder": self.p.decoder_implementation,
            "completed": [dataclasses.asdict(s) for s in self.statistics],
            "point": point,
            "counters": dataclasses.asdict(counters),
            "step_idx": step_idx,
            "point_elapsed": point_elapsed,
        }

    def _save_checkpoint(self, state) -> None:
        import json
        import os

        tmp = self.p.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.p.checkpoint_path)

    def _load_checkpoint(self):
        import json
        import os

        path = self.p.checkpoint_path
        if not path or not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        if (
            state.get("version") != 1
            or state.get("seed") != self.p.seed
            or state.get("ebn0s_db") != [float(e) for e in self.p.ebn0s_db]
            or state.get("decoder") != self.p.decoder_implementation
        ):
            return None  # parameters changed: start fresh
        for s in state["completed"]:
            ldpc = CodeStatistics(**s.pop("ldpc"))
            bch = s.pop("bch")
            self.statistics.append(
                Statistics(
                    **s, ldpc=ldpc, bch=CodeStatistics(**bch) if bch else None
                )
            )
        return state

    def run(self) -> list[Statistics]:
        import contextlib

        p = self.p
        base_key = jax.random.key(p.seed)
        min_time = p.min_run_time or 0.0
        max_time = p.max_run_time if p.max_run_time is not None else float("inf")
        has_bch = p.bch_max_errors > 0

        resume = self._load_checkpoint()
        start_point = 0
        resume_counters = None
        resume_step = 0
        resume_elapsed = 0.0
        if resume is not None:
            start_point = resume["point"]
            resume_counters = _Counters(**resume["counters"])
            resume_step = resume["step_idx"]
            resume_elapsed = resume["point_elapsed"]

        for point, ebn0_db in enumerate(p.ebn0s_db):
            if point < start_point:
                continue  # restored from checkpoint
            ebn0 = 10.0 ** (0.1 * float(ebn0_db))
            esn0 = self.rate * self.modulation.BITS_PER_SYMBOL * ebn0
            noise_sigma = float(np.sqrt(0.5 / esn0))
            if point == start_point and resume_counters is not None:
                counters = resume_counters
                step_idx = resume_step
                start = time.monotonic() - resume_elapsed
            else:
                counters = _Counters()
                step_idx = 0
                start = time.monotonic()
            last_report = time.monotonic()
            in_flight = []  # small pipeline: host accounting overlaps device

            if p.profile_dir:
                profile_cm = jax.profiler.trace(p.profile_dir)
            else:
                profile_cm = contextlib.nullcontext()
            interrupted = False
            with profile_cm:
              try:
                while True:
                    elapsed = time.monotonic() - start
                    errors = (
                        counters.bch_frame_errors
                        if has_bch
                        else counters.frame_errors
                    )
                    if (
                        errors >= p.max_frame_errors and elapsed >= min_time
                    ) or elapsed >= max_time:
                        break
                    key = jax.random.fold_in(
                        jax.random.fold_in(base_key, point), step_idx
                    )
                    in_flight.append(self._step(key, noise_sigma))
                    step_idx += 1
                    if len(in_flight) >= 2:
                        counters.add(jax.device_get(in_flight.pop(0)))
                    now = time.monotonic()
                    if now - last_report >= p.report_interval:
                        last_report = now
                        if p.reporter is not None:
                            p.reporter(
                                self._point_statistics(
                                    counters, ebn0_db, now - start
                                ),
                                False,
                            )
                        if p.checkpoint_path:
                            self._save_checkpoint(
                                self._checkpoint_state(
                                    point, counters, step_idx, now - start
                                )
                            )
              except KeyboardInterrupt:
                  # graceful Ctrl-C (reference cli/ber.rs:254-261): drain
                  # the pipeline, leave a resumable checkpoint, unwind
                  interrupted = True
            for d in in_flight:
                counters.add(jax.device_get(d))
            if interrupted:
                if p.checkpoint_path:
                    self._save_checkpoint(
                        self._checkpoint_state(
                            point,
                            counters,
                            step_idx,
                            time.monotonic() - start,
                        )
                    )
                raise KeyboardInterrupt
            stats = self._point_statistics(
                counters, ebn0_db, time.monotonic() - start
            )
            self.statistics.append(stats)
            if p.reporter is not None:
                p.reporter(stats, True)
            if p.checkpoint_path:
                self._save_checkpoint(
                    self._checkpoint_state(point + 1, _Counters(), 0, 0.0)
                )
        return self.statistics
