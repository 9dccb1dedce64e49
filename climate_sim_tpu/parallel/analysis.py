"""Structural dataflow analysis of sharded chunk programs.

A weak-scaling latency model needs ONE number per sharded path: how many
exchange latencies are SERIALIZED on a step's critical path (the ``slope``
in ``eff(L) = T_step / (T_step + slope * L)``).  Latency injection on a
host-serialized virtual mesh overstates it — the callback runtime
serializes the two *directions* of a round that real links run
concurrently.  The quantity is a property of the dataflow graph, not of
link speed, so compute it exactly: walk the jaxpr and take the longest
chain of data-dependent ``ppermute`` ops.

The reference's analogue is the dependency structure of its nonblocking
exchange (reference: src/halo.cpp:28-46): columns first, then full rows
that INCLUDE the just-received corner ghosts — the same 2-round chain the
sharded path's x-faces-then-y-rows exchange has.
"""

from __future__ import annotations

from typing import Sequence


def _subjaxprs(params):
    from jax._src import core as jcore

    for v in params.values():
        items = v if isinstance(v, (list, tuple)) else (v,)
        for s in items:
            if isinstance(s, jcore.ClosedJaxpr):
                yield s.jaxpr
            elif isinstance(s, jcore.Jaxpr):
                yield s


def _chain(jx, in_depths: Sequence[int]) -> int:
    """Longest ppermute chain ending at any var of ``jx``, given the chain
    depths already carried by its invars.  Sub-jaxpr'd equations (shard_map,
    pjit, scan/while bodies) contribute their own internal chain on top of
    their inputs' — for loops that is the PER-ITERATION chain, which is
    exactly the per-step number the latency model wants."""
    from jax._src import core as jcore

    env = {}
    for v, d in zip(jx.invars, in_depths):
        env[v] = d

    def depth_of(v) -> int:
        return env.get(v, 0) if isinstance(v, jcore.Var) else 0

    out = 0
    for eqn in jx.eqns:
        in_ds = [depth_of(v) for v in eqn.invars]
        d = max(in_ds, default=0)
        subs = list(_subjaxprs(eqn.params))
        if eqn.primitive.name == "ppermute":
            d += 1
        elif subs:
            # Seed each sub-jaxpr invar with ITS caller operand's depth
            # when the operand lists align 1:1 (pjit / shard_map / scan —
            # the closed-jaxpr convention is consts+carry+xs in eqn-invar
            # order), so a chain entering via one operand is not counted
            # through an unrelated operand's ppermutes (advisor finding,
            # r04).  Primitives whose sub-jaxprs bind only a subset
            # (while_loop cond/body) keep the conservative max-depth
            # seeding.  Floor at d either way: an empty/identity
            # sub-jaxpr (outvars aliasing invars, zero eqns) returns 0,
            # which must not RESET the accumulated chain passing through
            # it; loop bodies still count once regardless of trip count
            # (the per-iteration chain is what the caller wants).
            best = d
            for s in subs:
                seed = in_ds if len(s.invars) == len(eqn.invars) \
                    else [d] * len(s.invars)
                best = max(best, _chain(s, seed))
            d = best
        for v in eqn.outvars:
            env[v] = d
        out = max(out, d)
    return out


def ppermute_critical_depth(fn, *example_args) -> int:
    """Serialized exchange rounds on the critical path of ``fn``'s program.

    ``fn`` is a (possibly jitted) function — typically ``advance(1)``, so
    the result is rounds per step.
    Chains are counted through shard_map/pjit/scan boundaries; concurrent
    ppermutes (e.g. the left/right faces of one exchange round) count once.
    """
    import jax

    jaxpr = jax.make_jaxpr(fn)(*example_args)
    return _chain(jaxpr.jaxpr, [0] * len(jaxpr.jaxpr.invars))
