"""Shape-bucketing partitioner for vectorized trial execution.

Own copy of ``rafiki_tpu/worker/vmap_partition.py``. A batch of advisor
proposals can only train as ONE vectorized program when every member
runs the same computation: knobs that shape the
program (architecture width/depth, image size, batch size, epoch count)
must be identical across the stack, while pure dynamic hyperparameters
(lr/momentum/weight-decay riding the optimizer state through
``tunable_optimizer``) may differ per member — that is exactly the
params-stacking contract ``sdk/population.PopulationTrainer`` (and the
fused serving ensemble) enforce.

This module is the pure, unit-testable half of that decision: given K
proposed knob dicts and the template's declared dynamic-knob names
(``PopulationSpec.dynamic_knobs``), split the batch into vmap-compatible
buckets. Members of one bucket agree on every NON-dynamic knob; buckets
are bounded by the spec's ``max_members`` (the per-chip memory
heuristic). Singleton buckets degrade to the scalar trial path in the
worker: a batch of architecturally diverse proposals costs nothing, it
just does not vectorize.

Determinism contract: bucket order follows first appearance in
``knobs_list`` and member order within a bucket preserves proposal
order, so trial rows, advisor feedback, and ASHA rung reports line up
with what the advisor proposed.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Sequence


def static_signature(knobs: Dict[str, Any],
                     dynamic_knobs: Iterable[str]) -> str:
    """Canonical signature of a proposal's program-shaping knobs: the
    sorted JSON of every knob NOT declared dynamic. Two proposals with
    the same signature can share one (vmapped) program."""
    dyn = set(dynamic_knobs)
    static = {k: v for k, v in knobs.items() if k not in dyn}
    return json.dumps(static, sort_keys=True, default=str)


def partition_for_vmap(
    knobs_list: Sequence[Dict[str, Any]],
    dynamic_knobs: Iterable[str],
    max_members: int = 0,
) -> List[List[Dict[str, Any]]]:
    """Split proposed knob dicts into vmap-compatible buckets.

    Each returned bucket is a list of knob dicts that agree on every
    non-dynamic knob; ``max_members > 0`` splits oversized buckets into
    chunks of at most that many members. Empty input -> no buckets."""
    dyn = tuple(dynamic_knobs)
    groups: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for knobs in knobs_list:
        sig = static_signature(knobs, dyn)
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(knobs)
    cap = max(int(max_members), 0)
    buckets: List[List[Dict[str, Any]]] = []
    for sig in order:
        members = groups[sig]
        if cap and len(members) > cap:
            buckets.extend(members[i:i + cap]
                           for i in range(0, len(members), cap))
        else:
            buckets.append(members)
    return buckets
