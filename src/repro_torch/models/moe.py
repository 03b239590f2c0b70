"""Top-k mixture-of-experts: capacity dispatch and the dropless path.

Port of ``repro.models.moe``. The router runs in f32: softmax over the
experts, the top ``k`` (sorted) renormalised to sum to one. Expert weights
are stored ``(e, d, f)`` / ``(e, f, d)`` and cast to the activation dtype
on use; every expert product is one ``torch.matmul`` batched over the
expert axis (f32 sums), which reads each weight in its stored layout: an
einsum contracting ``d`` against ``(e, d, f)`` would permute and copy the
whole expert tensor first.

``apply_moe`` (training and prefill) routes tokens in groups of
``cfg.moe_group_size`` (one group when the token count does not divide),
assigns them choice-major (every token's first choice before any second
choice) and drops an assignment past its expert's ``capacity`` slots: its
combine weight is zero and the residual carries the token. The reference
builds one-hot dispatch and combine tensors for this; here each kept
assignment's slot ``expert * capacity + position`` indexes a gather of the
tokens into the experts' slots and a gather of the expert outputs back,
the same selection with no one-hot products.

``apply_moe_dense`` (decode, verify and the tree draft) runs every expert
on every token and combines the top-k gates, dropping nothing.
``active_topk`` (a scalar or per-slot ``(B,)``) is the runtime width gate:
choices at or past it get zero gate before the renormalisation, which is
top-k at the narrower k because the top-k is sorted.

Both return ``(y, aux)`` with aux the Switch load-balancing loss
``e * sum_e frac_e * pmean_e`` over the first choices.

On a rank of a tensor-parallel mesh (``parallel.tensor_parallel``) the
router is replicated and scores every expert, but the rank holds only
``expert_range``'s experts (expert parallelism) or a ``moe_d_ff`` column
slice of each: it runs those under their gates and returns a partial sum
for ``reduce_partial``, in f32 (the caller rounds the reduced sum once).

With bf16 activations the gate projection and the expert outputs come out
of their products rounded to bf16, where the reference keeps them in f32
until the gated sum; in f32 the two are the same arithmetic.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.models.layers import dense_init
from repro_torch.parallel import tensor_parallel as TP


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, lead=(), device=None):
    """Router ``(d, e)`` in f32, experts ``wi`` / ``wg`` ``(e, d, f)`` and
    ``wo`` ``(e, f, d)`` in ``cfg.param_dtype``, fan-in scaled."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    pd = dtype_of(cfg.param_dtype)
    kw = dict(device=device, lead=lead)
    p = {"router": dense_init(gen, (d, e), dtype=torch.float32, **kw),
         "wi": dense_init(gen, (e, d, f), in_axis=1, dtype=pd, **kw),
         "wo": dense_init(gen, (e, f, d), in_axis=1, dtype=pd, **kw)}
    if cfg.activation == "swiglu":
        p["wg"] = dense_init(gen, (e, d, f), in_axis=1, dtype=pd, **kw)
    return p


def _capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(group * top_k / n_experts * factor))
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4


def _route(x, router, k: int):
    """f32 router probabilities and the sorted top-k: (probs, gates, idx)."""
    probs = torch.softmax(torch.matmul(x.float(), router.float()), dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1, sorted=True)
    return probs, gate_vals, idx


def _renorm(gate_vals):
    return gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)


def _aux(probs, idx, e: int):
    """Switch load-balancing loss over every axis but the experts'."""
    top1 = F.one_hot(idx[..., 0], e).float().reshape(-1, e)
    return e * torch.sum(top1.mean(0) * probs.reshape(-1, e).mean(0))


def _experts(params, xe, cfg: ModelConfig):
    """Every expert's MLP on its own rows: xe (e, R, d) -> (e, R, d), in
    xe's dtype with f32 sums."""
    dt = xe.dtype
    h = torch.matmul(xe, params["wi"].to(dt))
    if "wg" in params:
        g = torch.matmul(xe, params["wg"].to(dt))
        h = F.silu(g.float()).to(dt) * h
    elif cfg.activation == "squared_relu":
        h = torch.relu(h).square()
    else:  # gelu (tanh approximation, jax.nn.gelu's default)
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    return torch.matmul(h, params["wo"].to(dt))


def apply_moe(params, x, cfg: ModelConfig, top_k: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Capacity dispatch per token group."""
    dt = x.dtype
    B, S, d = x.shape
    k = top_k or cfg.top_k
    e = cfg.n_experts
    T = B * S
    g = min(cfg.moe_group_size, T)
    if T % g:
        g = T  # fall back to one group (tiny smoke inputs)
    ng = T // g
    xt = x.reshape(ng, g, d)
    probs, gate_vals, idx = _route(xt, params["router"], k)
    gate_vals = _renorm(gate_vals)
    cap = _capacity(g, k, e, cfg.capacity_factor)

    # choice-major priority: assignment (choice j, token t) is row j * g + t;
    # its slot in its expert is the count of earlier rows that chose it
    m = F.one_hot(idx.transpose(1, 2).reshape(ng, k * g), e)  # (ng, kg, e)
    pos = ((torch.cumsum(m, dim=1) - 1) * m).sum(-1)  # (ng, kg)
    pos = pos.reshape(ng, k, g).transpose(1, 2)  # (ng, g, k)
    keep = pos < cap
    # the slot expert * cap + pos of each kept assignment; e * cap (a zero
    # row past the experts' slots) for a dropped one
    slot = torch.where(keep, idx * cap + pos, e * cap)

    # the token that fills each expert slot (g: a zero row) and the gather
    tok = torch.full((ng, e * cap + 1), g, dtype=torch.long, device=x.device)
    src = torch.arange(g, device=x.device)[None, :, None].expand(ng, g, k)
    tok.scatter_(1, slot.reshape(ng, g * k), src.reshape(ng, g * k))
    tok = tok[:, :e * cap]
    xt_pad = torch.cat([xt, xt.new_zeros(ng, 1, d)], dim=1)
    xe = torch.gather(xt_pad, 1, tok[..., None].expand(ng, e * cap, d))
    xe = xe.reshape(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    e0, ne = TP.expert_range(e)
    ye = _experts(params, xe[e0:e0 + ne], cfg)  # (ne, ng * cap, d)
    if ne != e:  # the other ranks' experts add nothing here
        ye = torch.cat([ye.new_zeros(e0, ng * cap, d), ye,
                        ye.new_zeros(e - e0 - ne, ng * cap, d)])
    ye = ye.reshape(e, ng, cap, d).transpose(0, 1).reshape(ng, e * cap, d)
    ye = torch.cat([ye, ye.new_zeros(ng, 1, d)], dim=1)
    yk = torch.gather(ye, 1, slot.reshape(ng, g * k, 1).expand(ng, g * k, d))
    w = torch.where(keep, gate_vals, 0.0).to(dt).float()
    y = (yk.reshape(ng, g, k, d).float() * w[..., None]).sum(2)
    return _out(y, dt).reshape(B, S, d), _aux(probs, idx, e)


def apply_moe_dense(params, x, cfg: ModelConfig, top_k: Optional[int] = None,
                    active_topk=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dropless top-k MoE: every expert on every token, combined
    through the sparse gates. ``active_topk`` (scalar or per-slot ``(B,)``
    int) zeroes the gates of choices at or past it before the
    renormalisation."""
    dt = x.dtype
    B, S, d = x.shape
    k = top_k or cfg.top_k
    e = cfg.n_experts
    probs, gate_vals, idx = _route(x, params["router"], k)
    if active_topk is not None:
        at = torch.as_tensor(active_topk, dtype=torch.int32, device=x.device)
        choice = torch.arange(k, device=x.device)
        live = choice < (at[:, None, None] if at.dim() else at)
        gate_vals = torch.where(live, gate_vals, 0.0)
    gate_vals = _renorm(gate_vals)
    gates = torch.zeros(B, S, e, dtype=torch.float32, device=x.device)
    gates = gates.scatter(-1, idx, gate_vals)  # top-k experts are distinct
    e0, ne = TP.expert_range(e)
    ye = _experts(params, x.reshape(1, B * S, d).expand(ne, B * S, d), cfg)
    y = torch.einsum("etd,te->td", ye.float(),
                     gates.reshape(B * S, e)[:, e0:e0 + ne])
    return _out(y, dt).reshape(B, S, d), _aux(probs, idx, e)


def _out(y, dt):
    """The gated sum in the activation dtype; a rank's partial stays in
    f32, rounded once after ``reduce_partial`` sums the ranks' (as the
    whole sum is rounded once on one device)."""
    return y if TP.model_sharded() else y.to(dt)
