"""BER test builder over the modulation registry.

Mirrors ``src/simulation/factory.rs``: the `Modulation` enum selects
BPSK or 8PSK (factory.rs:56-73) and `BerTestBuilder` assembles a
`BerTest` (factory.rs:44-108).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional, Sequence

from ..sparse import SparseMatrix
from .ber import BerTest, BerTestParameters
from .modulation import Bpsk, Psk8

__all__ = ["Modulation", "BerTestBuilder"]


class Modulation(Enum):
    BPSK = "BPSK"
    PSK8 = "8PSK"

    def instance(self):
        return Bpsk() if self is Modulation.BPSK else Psk8()

    @classmethod
    def parse(cls, s: str) -> "Modulation":
        for m in cls:
            if m.value == s:
                return m
        raise ValueError(f"invalid modulation {s!r}")


@dataclass
class BerTestBuilder:
    """Monomorphization-free equivalent of factory.rs:44-61."""

    h: SparseMatrix
    modulation: Modulation = Modulation.BPSK
    decoder_implementation: str = "Phif64"
    puncturing_pattern: Optional[Sequence[bool]] = None
    interleaving_columns: Optional[int] = None
    max_frame_errors: int = 100
    min_run_time: Optional[float] = None
    max_run_time: Optional[float] = None
    max_iterations: int = 100
    ebn0s_db: Sequence[float] = field(default_factory=list)
    reporter: Optional[Callable] = None
    bch_max_errors: int = 0
    batch_size: int = 128
    seed: int = 0
    mesh: Optional[object] = None
    lifted_graph: Optional[object] = None
    checkpoint_path: Optional[str] = None
    profile_dir: Optional[str] = None
    systematic_permutation: Optional[object] = None
    encoder_h: Optional[SparseMatrix] = None
    prebuilt_encoder: Optional[object] = None

    def build(self) -> BerTest:
        params = BerTestParameters(
            h=self.h,
            decoder_implementation=self.decoder_implementation,
            puncturing_pattern=self.puncturing_pattern,
            interleaving_columns=self.interleaving_columns,
            max_frame_errors=self.max_frame_errors,
            min_run_time=self.min_run_time,
            max_run_time=self.max_run_time,
            max_iterations=self.max_iterations,
            ebn0s_db=self.ebn0s_db,
            reporter=self.reporter,
            bch_max_errors=self.bch_max_errors,
            batch_size=self.batch_size,
            seed=self.seed,
            mesh=self.mesh,
            lifted_graph=self.lifted_graph,
            checkpoint_path=self.checkpoint_path,
            profile_dir=self.profile_dir,
            systematic_permutation=self.systematic_permutation,
            encoder_h=self.encoder_h,
            prebuilt_encoder=self.prebuilt_encoder,
        )
        return BerTest(params, self.modulation.instance())
