"""Mixture-of-Experts layer (GShard/Switch-style capacity dispatch); port
of ``repro.models.moe``.

Top-k softmax router with a load-balance auxiliary loss over a *grouped*
token layout ``[G, S_g, D]``: each group routes on its own, and an
expert holds at most ``C`` of a group's (token, choice) pairs, in the
flattened (token, choice) order; the rest are dropped.  The reference
dispatches and combines with one-hot einsums over ``[G, S_g, E, C]``;
here each kept pair is scattered to its slot of an ``[E, G * C, D]``
buffer and gathered back from it, which keeps the same pairs and sums
the same terms.  The reference's sharding constraints
(``partitioning.moe_*``) are no-ops on one device and are not carried
over.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import partitioning
from .config import ModelConfig
from .layers import _dtype, _normal, act_fn, dense_init, mlp, mlp_init


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor       # load-balance loss (Switch-style)
    router_entropy: torch.Tensor


def _expert_weights(gen, e: int, din: int, dout: int, dtype: str,
                    device) -> torch.Tensor:
    """``[e, din, dout]`` normal draws times ``din ** -0.5`` in ``dtype``,
    drawn one expert at a time so that no f32 copy of the whole tensor
    exists (kimi-k2's is 22.5 GB in f32)."""
    if torch.device(device).type == "meta":
        return torch.empty((e, din, dout), dtype=_dtype(dtype),
                           device="meta")
    out = torch.empty((e, din, dout), dtype=_dtype(dtype), device=device)
    for i in range(e):
        out[i] = _normal(gen, (din, dout), din ** -0.5, dtype, device)
    return out


def moe_init(gen, cfg: ModelConfig, *, device="cpu") -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, d, e, "float32", device=device),
        "gate": _expert_weights(gen, e, d, f, cfg.dtype, device),
        "up": _expert_weights(gen, e, d, f, cfg.dtype, device),
        "down": _expert_weights(gen, e, f, d, cfg.dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, f * cfg.n_shared_experts, cfg.act,
                               cfg.dtype, device=device)
    return p


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_group * cfg.experts_per_token
            * cfg.capacity_factor / cfg.n_experts)
    return max(c, 1)


def _group_size(n_tok: int, e: int, group_size: int | None) -> int:
    """The reference's group size: ``min(n_tok, 1024 if E >= 64 else
    4096)`` (or ``group_size``), halved until it divides ``n_tok``."""
    sg = group_size or min(n_tok, 1024 if e >= 64 else 4096)
    sg = min(sg, n_tok)
    while n_tok % sg:
        sg //= 2
    return sg


def _route(cfg: ModelConfig, p: dict, xg: torch.Tensor, c: int):
    """Routing of a grouped ``xg`` [G, Sg, D]: (probs f32 [G,Sg,E],
    topk_p f32 [G,Sg,K] renormalised, topk_e i64 [G,Sg,K], pos i64
    [G,Sg,K] within the expert's buffer, keep bool [G,Sg,K]).

    Top-k by a stable descending sort, so that on exact ties the lower
    expert index wins, as ``jax.lax.top_k`` keeps it.  ``pos`` is the
    exclusive cumsum of the one-hot choices over each group's flattened
    (token, choice) order, in integers."""
    g, sg, _ = xg.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xg.float() @ p["router"]["w"].float()          # [G,Sg,E]
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_e = torch.sort(probs, dim=-1, descending=True,
                                stable=True)
    topk_p, topk_e = topk_p[..., :k], topk_e[..., :k]
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(topk_e, e)         # [G,Sg,K,E]
    flat = onehot.reshape(g, sg * k, e)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(g, sg, k, e)
    pos = torch.gather(before, -1, topk_e[..., None])[..., 0]
    return probs, topk_p, topk_e, pos, pos < c


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              group_size: int | None = None) -> MoEOutput:
    """x: [B, S, D] -> MoEOutput with y: [B, S, D] in x's dtype.

    Tokens are reshaped to groups [G, S_g, D]; each group independently
    routes with capacity C = S_g * k / E * capacity_factor (at decode,
    S == 1, C = S_g: nothing is dropped)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n_tok = b * s
    sg = _group_size(n_tok, e, group_size)
    g = n_tok // sg
    xg = partitioning.moe_tokens(x.reshape(g, sg, d))
    c = sg if s == 1 else _capacity(sg, cfg)
    cdt = x.dtype

    probs, topk_p, topk_e, pos, keep = _route(cfg, p, xg, c)
    # the reference rounds the gate to the compute dtype in its combine
    gate = torch.where(keep, topk_p, 0.0).to(cdt).float()

    # dispatch: kept pair (g, s, j) -> row g * C + pos of expert e's
    # buffer; a dropped pair to the spare row G * C, which no product
    # reads (no boolean indexing, so no host sync)
    gi = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(keep, gi * c + pos, g * c)
    xe = torch.zeros((e, g * c + 1, d), dtype=cdt, device=x.device)
    xe[topk_e, slot] = xg[:, :, None].expand(g, sg, k, d)
    xe = partitioning.moe_dispatch(xe[:, :g * c])
    f = act_fn(cfg.act)
    hidden = partitioning.moe_dispatch(
        f(torch.bmm(xe, p["gate"].to(cdt))) * torch.bmm(xe, p["up"].to(cdt)))
    ye = partitioning.moe_dispatch(
        torch.bmm(hidden, p["down"].to(cdt)))               # [E,G*C,D]
    # combine in f32: each token's kept experts, times their gates
    picked = ye[topk_e, torch.where(keep, slot, 0)].float()
    y = partitioning.moe_tokens(
        torch.where(keep[..., None], picked * gate[..., None], 0.0).sum(2))

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xg, cfg.act).float()

    # Switch load-balance loss: E * sum_e(f_e * p_e); the token share in
    # the compute dtype, as the reference's one-hot ``sel`` is
    me = probs.mean(dim=(0, 1))
    chosen = torch.zeros((g, sg, e), dtype=torch.float32, device=x.device)
    chosen.scatter_(-1, topk_e, 1.0)
    ce = chosen.mean(dim=(0, 1)).to(cdt) / k
    aux = e * torch.sum(me * ce.float())
    entropy = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9),
                                    dim=-1))
    return MoEOutput(y.reshape(b, s, d).to(x.dtype), aux, entropy)
