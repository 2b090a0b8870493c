"""Segmented reductions over SORTED segment ids, deterministic on the card.

Counterpart: balm_tpu/ops/segments.py (segment_bounds :41,
sorted_segment_sum :57, segment_first :119).  The JAX module builds its
sums out of a blocked cumsum to dodge the TPU's slow large-table
scatter-add; the port needs the semantics only, and one more property:
the same input gives the same bits on the card.  Float `index_add_`
adds in the order its atomics land, so no float sum here scatters, and
no index scatter either: the ids are sorted, so every segment's rows
come from one `torch.searchsorted` (a scatter-min of positions would
send every dropped row to one dump address, its atomics serialized
there).  The sums are one `torch.segment_reduce`, each segment in row
order: on the card it beat the JAX module's two-level blocked cumsum
(PERF.md §6, PR 9).  Out-of-range ids (negative, or >= num_segments)
are dropped; being sorted, they sit at the two ends and are never read.
"""

from __future__ import annotations

import torch


def _edges(seg, S):
    """(S + 1,) int64: segment s of the sorted ids is rows
    edges[s]:edges[s + 1]."""
    q = torch.arange(S + 1, device=seg.device, dtype=seg.dtype)
    return torch.searchsorted(seg, q)


def segment_bounds(seg, num_segments: int):
    """Start (inclusive) / end (exclusive) positions of each segment id
    in a SORTED (N,) integer segment array; out-of-range ids dropped.
    Returns (start (S,), end (S,), have (S,) bool), int64; an empty
    segment has start N and end 0, as in JAX."""
    e = _edges(seg, num_segments)
    start, end = e[:-1], e[1:]
    have = end > start
    return (torch.where(have, start, seg.shape[0]),
            torch.where(have, end, 0), have)


def sorted_segment_sum(data, seg, *, num_segments: int):
    """segment_sum for SORTED `seg`: data (N, C) float, seg (N,) integer
    ascending -> (num_segments, C), zero where a segment is empty; the
    rows of out-of-range ids are not read."""
    return torch.segment_reduce(data, "sum",
                                offsets=_edges(seg, num_segments), axis=0,
                                unsafe=True)


def segment_first(values, seg, *, num_segments: int):
    """First-row value per segment of a SORTED segment array:
    values (N, C) -> (S, C), zero where a segment is empty."""
    start, _, have = segment_bounds(seg, num_segments)
    out = values[torch.where(have, start, 0)]
    return torch.where(have[:, None], out, torch.zeros_like(out))
