"""GOP engine helpers shared by both encoders (SURVEY.md E4).

coding_order(): display -> coding reorder from the config GOP table
(all-intra / LDP / hierarchical-B random access), with IDR boundaries
respected so journal resume stays deterministic.

ref_lists(): per-picture reference list construction (one active ref per
list; L0 = nearest past first, L1 = nearest future first, GPB fallback).
"""

from __future__ import annotations

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


def coding_order(cfg, n_frames: int, start_poc: int) -> list:
    """[(poc, slice_type, ref_deltas, qp_offset)] in coding order.

    qp_offset implements the temporal-layer QP/lambda cascade (HM
    TEncGOP's per-GOP-entry QP offsets, SURVEY.md §1 L4 / §3.5): each
    picture codes at cfg.qp + its GOP entry's qp_offset, which is what
    makes hierarchical GOP structures rate-efficient."""
    all_intra = cfg.intra_period == 1 or not cfg.gop
    if all_intra:
        return [(start_poc + i, SLICE_I, (), 0) for i in range(n_frames)]
    st_map = {"I": SLICE_I, "P": SLICE_P, "B": SLICE_B}
    gop = cfg.gop
    gop_len = max(e.poc_offset for e in gop)
    order = []
    i = 0
    while i < n_frames:
        poc = start_poc + i
        is_idr = poc == 0 or (cfg.intra_period > 0
                              and poc % cfg.intra_period == 0)
        if is_idr or i == 0:
            order.append((poc, SLICE_I, (), 0))
            i += 1
            continue
        base = poc - 1  # GOP anchored at the previous picture
        block_ok = (i + gop_len <= n_frames and gop_len > 1
                    and not any(cfg.intra_period > 0
                                and (base + k) % cfg.intra_period == 0
                                for k in range(1, gop_len + 1)))
        if block_ok:
            for e in gop:
                order.append((base + e.poc_offset, st_map[e.slice_type],
                              tuple(e.ref_pocs), e.qp_offset))
            i += gop_len
        else:
            order.append((poc, SLICE_P, (-1,),
                          gop[0].qp_offset if gop else 0))
            i += 1
    return order


def ref_lists(dpb: dict, cvs_poc: int, slice_type: int, ref_deltas,
              is_idr: bool, num_ref: int = 2):
    """Resolve reference lists from the DPB (cvs-local POC keyed).

    L0 = past-first, L1 = future-first (GPB fallback), each truncated to
    `num_ref` active references (multi-ref, SURVEY.md E7/C4).  Returns
    (slice_type, refs_l0, refs_l1, (before, after)) — slice_type may
    downgrade B -> P when no L1 ref exists.
    """
    before = tuple(sorted(-d for d in ref_deltas if d < 0))
    after = tuple(sorted(d for d in ref_deltas if d > 0))
    before = tuple(d for d in before if cvs_poc - d in dpb)
    after = tuple(d for d in after if cvs_poc + d in dpb)
    if not is_idr and not before and not after:
        before = (1,) if cvs_poc - 1 in dpb else ()
    l0_pocs = [cvs_poc - d for d in before] + [cvs_poc + d for d in after]
    l1_pocs = [cvs_poc + d for d in after] + [cvs_poc - d for d in before]
    refs_l0 = [dpb[p] for p in l0_pocs[:num_ref]]
    refs_l1 = [dpb[p] for p in l1_pocs[:num_ref]]
    if slice_type == SLICE_B and not refs_l1:
        slice_type = SLICE_P
    return slice_type, refs_l0, refs_l1, (before, after)
