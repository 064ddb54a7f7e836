"""Shared traversal over PhysicalPlanNode child links (port of
``auron_tpu/plan/protowalk.py``).

Every plan operator reaches its inputs through one of: ``child``,
``left``/``right``, or the repeated ``children`` of union. The optimizer,
explain, the planner's template fill and the stage split walk plans
through this one definition.
"""

from __future__ import annotations

from typing import Callable, Iterator


def child_nodes(node) -> Iterator:
    """Yield the direct child plan nodes (mutable references)."""
    inner = getattr(node, node.WhichOneof("plan"))
    if hasattr(inner, "children"):
        yield from inner.children
        return
    for f in ("child", "left", "right"):
        try:
            present = inner.HasField(f)
        except ValueError:
            continue
        if present:
            yield getattr(inner, f)


def rewrite_children(node, fn: Callable):
    """Copy ``node`` with every direct child replaced by ``fn(child)``."""
    from auron_tpu_torch import proto as pb

    new = pb.PhysicalPlanNode()
    new.CopyFrom(node)
    inner = getattr(new, new.WhichOneof("plan"))
    if hasattr(inner, "children"):
        for c in inner.children:
            c.CopyFrom(fn(c))
        return new
    for f in ("child", "left", "right"):
        try:
            present = inner.HasField(f)
        except ValueError:
            continue
        if present:
            getattr(inner, f).CopyFrom(fn(getattr(inner, f)))
    return new
