"""Flat check-major edge tables of a lifted graph for the layered sweep.

``build_lifted_layout`` flattens the check buckets of a
``decoder.lifted.LiftedGraph`` into one check-major order of base edges:
bucket by bucket, group by group, slot by slot. Check group ``g`` of a
bucket with metadata ``m`` owns the ``m.d`` consecutive edges starting at
``m.ebase + (g - m.g0) * m.d``. For each edge the tables give the
variable-group plane it reads, the lift shift that rolls that plane into
check coordinates, and the lane of an incomplete circulant to mask (the
DVB-S2 staircase corner). Together they describe H exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CheckBucketMeta", "LiftedLayout", "build_lifted_layout"]


@dataclass(frozen=True)
class CheckBucketMeta:
    """Check groups [g0, g1) of degree d; their first edge is ebase."""

    g0: int
    g1: int
    d: int
    ebase: int


@dataclass(frozen=True)
class LiftedLayout:
    Z: int
    E: int  # base edges
    VG: int  # variable groups (bucket order)
    chk_meta: tuple  # tuple[CheckBucketMeta], check-bucket order
    syn_vg: np.ndarray  # (E,) bucket-order variable-group plane per edge
    syn_rot: np.ndarray  # (E,) lift shift s: var lane w -> check lane w+s
    syn_mask: np.ndarray  # (E,) missing lane in check coords, -1 = none


def build_lifted_layout(lg) -> LiftedLayout:
    """Build the check-major edge tables of a LiftedGraph.

    Raises ValueError for graphs whose incomplete circulants miss more than
    one lane of an edge (no standards family here does).
    """
    E = lg.num_base_edges
    metas = []
    g0 = ebase = 0
    for b in lg.chk_buckets:
        count = len(b.groups)
        if count == 0:
            continue
        metas.append(CheckBucketMeta(g0=g0, g1=g0 + count, d=b.degree,
                                     ebase=ebase))
        g0 += count
        ebase += count * b.degree
    if ebase != E:
        raise ValueError(f"check buckets cover {ebase} of {E} base edges")

    def flat(attr):
        parts = [
            getattr(b, attr).reshape(-1)
            for b in lg.chk_buckets
            if len(b.groups) and b.degree
        ]
        return np.concatenate(parts).astype(np.int32)

    syn_mask = np.full(E, -1, np.int32)
    for _vm_posn, cm_posn, lanes_c, _lanes_v in lg.missing:
        if len(lanes_c) != 1:
            raise ValueError(
                "lifted layout supports single-lane circulant gaps only"
            )
        syn_mask[cm_posn] = int(lanes_c[0])

    return LiftedLayout(
        Z=lg.Z,
        E=E,
        VG=lg.num_var_groups,
        chk_meta=tuple(metas),
        syn_vg=flat("var_group_pos"),
        syn_rot=flat("shifts"),
        syn_mask=syn_mask,
    )
