"""Routing policies registered from outside the engines, as in
``repro.sim.policies``: ``cost_model`` (code 4) and ``slack_aware``
(code 5).  The bodies are the reference's own text, run on the torch
namespace :mod:`repro_torch.core.xp`."""
from __future__ import annotations

from ..core.registry import ROUTING, RouteCtx, register_routing


@register_routing("cost_model")
def cost_model(xp, ctx: RouteCtx):
    """Predicted end-to-end latency per node; cheapest wins.

    A node whose target pool can host the container pays ``p_cold *
    cold_cost`` with its occupancy as ``p_cold``; one that never can, or
    is down, pays the cloud's round trip plus its cold-start share.
    Ties resolve to the lowest node index (``argmin``'s first minimum)."""
    frac = ctx.free / xp.maximum(ctx.cap, xp.float32(1e-6))
    cold_cost = ctx.cold - ctx.warm
    p_cold = xp.float32(1.0) - frac
    edge_pred = p_cold * cold_cost
    cloud_pred = ctx.cloud_rtt_s + ctx.cloud_cold_prob * cold_cost
    feasible = (ctx.cap >= ctx.size - xp.float32(1e-9)) & ctx.node_up
    return xp.argmin(xp.where(feasible, edge_pred, cloud_pred))


@register_routing("slack_aware", needs_free=False)
def slack_aware(xp, ctx: RouteCtx):
    """Chain-SLO routing: a chain with no slack left is shed to a down
    node or to a node that can never host it (both drop to the cloud
    without touching a pool); everything else routes ``sticky``.
    Chainless traffic has infinite slack, so this is exact ``sticky``
    there."""
    doomed = ctx.chain_slack <= xp.float32(0.0)
    down = (~ctx.node_up).astype(xp.int32)
    have_down = xp.sum(down) > 0
    cap_dump = xp.argmin(ctx.cap)
    never_fits = ctx.cap[cap_dump] < ctx.size - xp.float32(1e-9)
    dump = xp.where(have_down, xp.argmax(down), cap_dump)
    shed = doomed & (have_down | never_fits)
    home = ROUTING.spec("sticky").fn(xp, ctx)
    return xp.where(shed, dump, home)
