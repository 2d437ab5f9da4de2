"""Per-round lineage for surgical shard recovery (DESIGN.md §13).

Spark survives worker loss because every RDD partition carries its
lineage — the deterministic recipe that recomputes just that partition
from surviving parents (Gittens et al. 1607.01335 call this out as the
decisive operational advantage over C+MPI at scale).  Our plan IR
already contains everything such a recipe needs: the §4 round taxonomy
fixes HOW each node executes on a mesh, `dist_analysis` fixes WHERE
each operand lives, and rounds are pure functions of their inputs.
This pass makes the recipe explicit: it annotates every top-level plan
node (and every member of a `FusedRound` region) with a `RoundLineage`
describing, for shard k of the round's output,

  * which input arrays feed it and how each is reachable after shard k's
    worker died —
      ``rep``      replicated: every surviving device holds a full copy,
                   re-reading it is free;
      ``aligned``  ONED_ROW/ONED_VAR block aligned with the round axis:
                   the recompute needs BLOCK k of the array, re-fetched
                   from the host/global copy or replayed from the last
                   loop-carry snapshot;
      ``gathered`` sharded but read through an all_gather inside the
                   round: any surviving shard already materialized the
                   full array during the round, so recovery reads the
                   gathered copy;
  * what the round writes and under which taxonomy class (``store`` /
    ``reduce`` / ``scalar`` / ``rebalance`` — the class picks the
    recovery protocol in distributed.py: aligned stores recompute shard
    k's block surgically, reduce rounds with a replicated destination
    need nothing, reduce rounds with a sharded destination replay the
    cached round executable and re-slice);
  * its `depth` — the longest producer chain from program inputs to
    this round, i.e. how many upstream rounds a from-scratch
    reconstruction of its inputs would replay.  Recovery itself never
    replays the chain (inputs survive in the host env / peer replicas);
    the depth is the ledger's measure of how much work lineage-based
    recovery SAVED versus a restart, reported on every ``recovered:``
    line.

The pass is analysis-only: it never reorders, rewrites or re-classifies
nodes, and single-device execution ignores the annotation entirely.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import plan as P
from .dist_analysis import Dist, aligned_reads, gathers_of, round_axis

__all__ = ["RoundLineage", "compute_lineage", "pass_lineage",
           "explain_lineage"]


@dataclass(frozen=True)
class RoundLineage:
    """The recovery recipe for one round's lost output shard."""

    axis: Optional[str]                    # shard axis var; None = replicated
    writes: tuple[tuple[str, str], ...]    # (array, store|reduce|scalar|...)
    reads: tuple[tuple[str, str], ...]     # (array, rep|aligned|gathered)
    depth: int = 0                         # longest producer chain feeding us

    @property
    def recoverable(self) -> bool:
        """A replicated round loses nothing when a worker dies (every
        survivor holds the result); a sharded round is recoverable
        because every read kind above names a surviving source."""
        return True

    def read_kind(self, array: str) -> Optional[str]:
        for name, kind in self.reads:
            if name == array:
                return kind
        return None

    def pretty(self) -> str:
        w = ", ".join(f"{a}:{k}" for a, k in self.writes) or "·"
        r = ", ".join(f"{a}:{k}" for a, k in self.reads) or "·"
        ax = self.axis or "rep"
        return f"axis={ax} depth={self.depth} writes[{w}] reads[{r}]"


def _write_kind(node) -> str:
    if isinstance(node, P.Rebalance):
        return "rebalance"
    if isinstance(node, P.ScalarReduce):
        return "scalar"
    if isinstance(node, P.REDUCE_NODES):
        return "reduce"
    return "store"


def _read_kind(node, name: str, axis, dists: dict) -> str:
    d = dists.get(name, Dist.REP)
    if d == Dist.REP:
        return "rep"
    if axis is not None and name in aligned_reads(node, axis):
        return "aligned"
    return "gathered"


def _leaf_lineage(node, dists: dict, depth_of: dict) -> RoundLineage:
    axis = round_axis(node)
    dest = getattr(node, "dest", None)
    writes = ((dest, _write_kind(node)),) if dest is not None else ()
    reads = tuple(
        (name, _read_kind(node, name, axis, dists))
        for name in sorted(gathers_of(node)) if name != dest)
    depth = 1 + max((depth_of.get(name, 0) for name, _k in reads), default=0)
    return RoundLineage(axis=axis, writes=writes, reads=reads, depth=depth)


def _fused_lineage(parts, dists: dict, depth_of: dict) -> RoundLineage:
    """A Fused node (one space, parallel parts) or a FusedRound region
    (sequential members) recovers as one unit: the union of its members'
    recipes.  An array both written and read inside the region counts
    only as a write — the region re-derives it during replay."""
    writes: list = []
    reads: dict = {}
    depth = 0
    axis = None
    written: set = set()
    for p in parts:
        sub = (_fused_lineage(p.parts, dists, depth_of)
               if isinstance(p, (P.Fused, P.FusedRound))
               else _leaf_lineage(p, dists, depth_of))
        if sub.axis is not None:
            axis = axis or sub.axis
        depth = max(depth, sub.depth)
        for a, k in sub.writes:
            if a not in written:
                written.add(a)
                writes.append((a, k))
        for a, k in sub.reads:
            if a not in written:
                # later members' aligned reads of earlier members' outputs
                # never degrade an already-recorded external read kind
                reads.setdefault(a, k)
    return RoundLineage(axis=axis, writes=tuple(writes),
                        reads=tuple(sorted(reads.items())), depth=depth)


def compute_lineage(nodes, dists: dict) -> None:
    """Annotate every node in `nodes` (recursing into SeqLoop bodies and
    FusedRound regions) with `node.lineage`.  `dists` is the program's
    {array: Dist} map from the distribution analysis."""
    depth_of: dict = {}

    def visit(ns):
        for n in ns:
            if isinstance(n, P.SeqLoop):
                # the loop body re-runs every iteration; carries written
                # inside feed the next iteration's reads, so a carry's
                # depth is the deepest body round + 1 (one replayed round
                # per carry per iteration — recovery restores carries
                # from the peer-replica / checkpoint tier instead)
                visit(n.body)
                body_depth = max((m.lineage.depth for m in n.body
                                  if getattr(m, "lineage", None) is not None),
                                 default=0)
                n.lineage = RoundLineage(
                    axis=None,
                    writes=tuple((c, "carry") for c in n.carry),
                    reads=(), depth=body_depth + 1)
                for c in n.carry:
                    depth_of[c] = n.lineage.depth
                continue
            if isinstance(n, (P.Fused, P.FusedRound)):
                if isinstance(n, P.FusedRound):
                    visit(n.parts)     # members also carry their own recipe
                    lin = _fused_lineage(n.parts, dists, depth_of)
                else:
                    lin = _fused_lineage(n.parts, dists, depth_of)
                n.lineage = lin
            else:
                n.lineage = _leaf_lineage(n, dists, depth_of)
            for a, _k in n.lineage.writes:
                depth_of[a] = n.lineage.depth

    visit(nodes)


def pass_lineage(nodes, prog, config):
    """Pipeline pass (after round-fusion): record every round's recovery
    recipe.  `config.lineage=False` leaves nodes unannotated — the
    distributed executor then treats any shard loss as a ladder event
    (the pre-§13 behaviour)."""
    if not getattr(config, "lineage", True):
        return nodes
    from .dist_analysis import collect
    compute_lineage(nodes, collect(nodes))
    return nodes


def explain_lineage(nodes, name: str = "") -> str:
    """Golden-testable rendering of the recovery recipes, one line per
    annotated round, mirroring explain_rounds()' shape."""
    out = [f"== round lineage{': ' + name if name else ''} =="]

    def visit(ns, indent=0):
        for n in ns:
            lin = getattr(n, "lineage", None)
            pre = "  " * indent
            head = n.describe() if hasattr(n, "describe") else type(n).__name__
            out.append(f"{pre}{head}")
            if lin is not None:
                out.append(f"{pre}    lineage: {lin.pretty()}")
            if isinstance(n, P.SeqLoop):
                visit(n.body, indent + 1)
            elif isinstance(n, (P.Fused, P.FusedRound)):
                visit(n.parts, indent + 1)

    visit(nodes)
    return "\n".join(out)
