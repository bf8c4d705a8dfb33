"""Backend-agreement fidelity: the BASELINE "<5% segment-ID disagreement
against Meili" proxy.

Counterpart: reporter_tpu/matcher/fidelity.py (``length_weighted_agreement``,
``mean_disagreement``). Length-weighted: per segment id, the covered
meters both backends agree on, so a 5 m junction sliver does not weigh as
much as a 500 m segment.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence


def length_weighted_agreement(results_a: Iterable[Sequence],
                              results_b: Iterable[Sequence],
                              ) -> tuple[float, float]:
    """(agree_meters, total_meters) over paired per-trace record lists
    (records with ``segment_id`` and ``length``). A trace where both
    backends emit nothing agrees perfectly and adds (1, 1)."""
    agree = total = 0.0
    for a, b in zip(results_a, results_b):
        la: Counter = Counter()
        lb: Counter = Counter()
        for r in a:
            la[r.segment_id] += r.length
        for r in b:
            lb[r.segment_id] += r.length
        if not la and not lb:
            agree += 1.0
            total += 1.0
            continue
        total += max(sum(la.values()), sum(lb.values()), 1.0)
        agree += sum(min(la[k], lb[k]) for k in la.keys() & lb.keys())
    return agree, total


def mean_disagreement(results_a: Iterable[Sequence],
                      results_b: Iterable[Sequence]) -> float:
    """Per-trace length-weighted disagreement, averaged."""
    vals = []
    for a, b in zip(results_a, results_b):
        agree, total = length_weighted_agreement([a], [b])
        vals.append(1.0 - agree / total)
    return sum(vals) / max(len(vals), 1)
