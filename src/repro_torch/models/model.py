"""Dense decoder: init / prefill / decode over a per-slot KV cache.

Port of ``repro.models.model`` for the dense family (token-only decoders
whose layers are attention + MLP). Layer stacks keep the JAX layout: one
group = one period of the layer pattern, group parameters and caches
stacked on a leading ``n_groups`` axis. The ``lax.scan`` over groups
becomes a Python loop over per-group views; the cache is updated in place
through those views (JAX donates the cache buffer for the same effect).

SSM, MoE, encoder-decoder and frontend families, paged caches, and the
speculative verify / tree paths raise ``NotImplementedError`` naming the
slice of the port they arrive with.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import layers as L

Params = Dict
Cache = Dict


def _check_family(cfg: ModelConfig) -> None:
    if any(k != "attn" for k in cfg.layer_pattern):
        raise NotImplementedError(f"{cfg.name}: SSM layers arrive with the "
                                  f"SSM slice of the port")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers arrive with the "
                                  f"MoE slice of the port")
    if cfg.is_encdec or cfg.frontend or not cfg.use_rope:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder, frontend and "
                                  f"absolute-position models arrive with a "
                                  f"later slice")


def _tree_index(tree, i):
    """Per-group view: ``a[i]`` on every leaf of a nested dict."""
    return {k: _tree_index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Seeded random parameters with the JAX tree layout and init scales.

    Same shapes and truncated-normal fan-in scale as
    ``repro.models.model.init_params``; the numbers come from a
    ``torch.Generator`` (seeded with ``seed`` unless one is passed), so they
    differ from JAX's. Tests that compare the two convert JAX's params with
    ``repro_torch.convert.params_from_jax`` instead."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    pd = dtype_of(cfg.param_dtype)
    v = cfg.padded_vocab()
    lead = (cfg.n_groups,)
    params: Params = {
        "embed": L.dense_init(gen, (v, cfg.d_model), in_axis=-1, dtype=pd,
                              device=dev),
        "final_norm": L.init_norm(cfg, device=dev),
    }
    stack = {}
    for p in range(cfg.period):
        layer = {"norm1": L.init_norm(cfg, lead=lead, device=dev),
                 "attn": L.init_attention(gen, cfg, lead=lead, device=dev)}
        if cfg.d_ff:
            layer["norm2"] = L.init_norm(cfg, lead=lead, device=dev)
            layer["mlp"] = L.init_mlp(gen, cfg, lead=lead, device=dev)
        stack[f"pos{p}"] = layer
    params["stack"] = stack
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, v), dtype=pd,
                                         device=dev)
    if cfg.elastic.exit_layers and cfg.elastic.dedicated_exit_norm:
        params["exit_norms"] = {f"g{g}": L.init_norm(cfg, device=dev)
                                for g in cfg.elastic.exit_layers}
    return params


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _group_fwd(group_params, h, cfg: ModelConfig, positions, *, causal=True,
               want_cache=False, cache_extra=0):
    """Run one period of layers. Returns (h, cache_or_None)."""
    caches = {}
    for p in range(cfg.period):
        lp = group_params[f"pos{p}"]
        hn = L.apply_norm(lp["norm1"], h, cfg)
        mix, (k_, v_) = L.mha(lp["attn"], hn, cfg, positions, causal=causal)
        if want_cache:
            caches[f"pos{p}"] = _pack_kv_cache(k_, v_, cfg, cache_extra)
        h = h + mix
        if cfg.d_ff:
            hn = L.apply_norm(lp["norm2"], h, cfg)
            h = h + L.apply_mlp(lp["mlp"], hn, cfg)
    return h, (caches if want_cache else None)


def _pack_kv_cache(k, v, cfg: ModelConfig, extra: int = 0):
    """Full-seq K/V -> decode cache layout (rolling buffer for sliding
    windows, ``extra`` free slots appended otherwise)."""
    S = k.shape[1]
    w = cfg.sliding_window
    if w:
        eff = min(S, w)
        slots = torch.arange(S - eff, S, device=k.device) % w
        kc = torch.zeros((k.shape[0], w) + tuple(k.shape[2:]), dtype=k.dtype,
                         device=k.device)
        vc = torch.zeros_like(kc)
        kc[:, slots] = k[:, -eff:]
        vc[:, slots] = v[:, -eff:]
        k, v = kc, vc
    elif extra:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, extra))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
    if cfg.kv_quant:
        kq, ks_ = L.quantize_kv(k)
        vq, vs = L.quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks_, "v_scale": vs}
    return {"k": k, "v": v}


def _scan_groups(stack, h, cfg: ModelConfig, positions, *, start: int,
                 stop: int, want_cache: bool = False, cache_extra: int = 0):
    """Run groups [start, stop). Returns (h, caches stacked on a leading
    group axis, or None)."""
    per_group = []
    for g in range(start, stop):
        h, c = _group_fwd(_tree_index(stack, g), h, cfg, positions,
                          want_cache=want_cache, cache_extra=cache_extra)
        per_group.append(c)
    if not want_cache:
        return h, None
    caches = {pn: {k: torch.stack([c[pn][k] for c in per_group])
                   for k in per_group[0][pn]} for pn in per_group[0]}
    return h, caches


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding. Returns (h, positions)."""
    dt = dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    h = params["embed"][tokens].to(dt)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    return h, positions


def _logits(params, h, cfg: ModelConfig, norm_params):
    h = L.apply_norm(norm_params, h, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return L.matmul(h, w, h.dtype)


def _exit_norm(params, cfg: ModelConfig, depth: int):
    norm_p = params["final_norm"]
    if depth < cfg.n_groups:
        norm_p = params.get("exit_norms", {}).get(f"g{depth}", norm_p)
    return norm_p


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, *,
                      per_slot: bool = False, device=None) -> Cache:
    """Zeroed cache with room for ``capacity`` tokens:
    ``{"pos": () or (B,), "stack": {"pos0": {"k": (G,B,S,KV,hd), ...}}}``."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    stack = {f"pos{p}": L.init_kv_cache(cfg, batch, capacity, dt,
                                        lead=(cfg.n_groups,), device=dev)
             for p in range(cfg.period)}
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                      device=dev)
    return {"pos": pos, "stack": stack}


def reset_cache_slots(cache: Cache, mask) -> Cache:
    """Rewind every slot where ``mask`` (n_slots,) is True, in place.

    Position counters go to 0; attention KV is left as it is (position
    masking hides the previous occupant's keys). Dense decoders have no
    recurrent state to zero."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=cache["pos"].device)
    cache["pos"].masked_fill_(mask, 0)
    return cache


def reset_cache_slot(cache: Cache, slot) -> Cache:
    """Rewind one batch slot (see ``reset_cache_slots``)."""
    n_slots = cache["pos"].shape[0]
    mask = torch.arange(n_slots, device=cache["pos"].device) == int(slot)
    return reset_cache_slots(cache, mask)


def adopt_cache_slot(cache: Cache, pre: Cache, slot) -> Cache:
    """Copy slot ``slot`` of a prefilled engine-layout cache ``pre`` into
    ``cache``, in place (every leaf's lane and the position)."""
    for pn, layer in cache["stack"].items():
        for k, full in layer.items():
            full[:, slot] = pre["stack"][pn][k][:, slot].to(full.dtype)
    cache["pos"][slot] = pre["pos"][slot]
    return cache


def _group_decode(group_params, group_cache, h, pos, cfg: ModelConfig,
                  active=None, fused=False):
    for p in range(cfg.period):
        lp = group_params[f"pos{p}"]
        cp = group_cache[f"pos{p}"]
        hn = L.apply_norm(lp["norm1"], h, cfg)
        mix, _ = L.mha_decode(lp["attn"], hn, cp, pos, cfg, active=active,
                              fused=fused)
        h = h + mix
        if cfg.d_ff:
            hn = L.apply_norm(lp["norm2"], h, cfg)
            h = h + L.apply_mlp(lp["mlp"], hn, cfg,
                                active_ff=active.get("d_ff") if active else None)
    return h


def decode_step(params, cache, tokens, cfg: ModelConfig, *,
                depth: Optional[int] = None, active=None, pages=None,
                page_size=0, fused=False):
    """One-token decode. tokens: (B, 1). Returns (logits (B,1,Vp), cache).

    ``cache`` is updated in place: each group's K/V slice gets the new
    token and ``cache["pos"]`` advances by one. ``active`` is the runtime
    width operand (``elastic.active_widths_batch``: per-slot (B,) tensors)
    over full params and a full-width cache; ``depth`` truncates the layer
    loop at an exit and reads logits through that exit's norm."""
    if pages is not None:
        raise NotImplementedError("paged KV caches arrive with the paged "
                                  "slice of the port")
    depth = depth if depth is not None else cfg.n_groups
    dt = dtype_of(cfg.dtype)
    pos = cache["pos"]
    h = params["embed"][tokens].to(dt)
    for g in range(depth):
        h = _group_decode(_tree_index(params["stack"], g),
                          _tree_index(cache["stack"], g), h, pos, cfg,
                          active=active, fused=fused)
    logits = _logits(params, h, cfg, _exit_norm(params, cfg, depth))
    pos.add_(1)
    return logits, cache


def prefill(params, batch, cfg: ModelConfig, *, cache_extra: int = 0,
            per_slot: bool = False, slot: Optional[int] = None,
            n_slots: Optional[int] = None, depth: Optional[int] = None):
    """Process a full prompt; returns (last-position logits, decode cache).

    ``cache_extra`` appends free KV slots so decode can continue past the
    prompt. ``per_slot=True`` returns per-slot positions ``(B,)``; with
    ``slot`` (and ``n_slots``) a batch-1 prompt's state is scattered into
    slot ``slot`` of an ``n_slots``-wide zeroed cache, layout-identical to
    ``init_decode_cache(cfg, n_slots, S + cache_extra, per_slot=True)``.
    ``depth`` stops at an exit: logits from its exit head, cache groups past
    it zero."""
    _check_family(cfg)
    depth = depth if depth is not None else cfg.n_groups
    h, positions = _embed_inputs(params, batch, cfg)
    S = h.shape[1]
    h, caches = _scan_groups(params["stack"], h, cfg, positions, start=0,
                             stop=depth, want_cache=True,
                             cache_extra=cache_extra)
    if depth < cfg.n_groups:  # pad the group stack back to engine layout
        caches = {pn: {k: torch.cat(
            [a, torch.zeros((cfg.n_groups - depth,) + tuple(a.shape[1:]),
                            dtype=a.dtype, device=a.device)])
            for k, a in layer.items()} for pn, layer in caches.items()}
    logits = _logits(params, h[:, -1:], cfg, _exit_norm(params, cfg, depth))
    B = h.shape[0]
    dev = h.device
    if not per_slot:
        if slot is not None:
            raise ValueError("slot requires per_slot=True")
        return logits, {"pos": torch.full((), S, dtype=torch.int32,
                                          device=dev), "stack": caches}
    if slot is None:
        return logits, {"pos": torch.full((B,), S, dtype=torch.int32,
                                          device=dev), "stack": caches}
    if B != 1:
        raise ValueError(f"slot scatter needs a batch-1 prompt, got B={B}")
    ns = n_slots or 1
    stack = {}
    for pn, layer in caches.items():
        stack[pn] = {}
        for k, a in layer.items():
            wide = torch.zeros((a.shape[0], ns) + tuple(a.shape[2:]),
                               dtype=a.dtype, device=dev)
            wide[:, slot] = a[:, 0]
            stack[pn][k] = wide
    pos = torch.zeros((ns,), dtype=torch.int32, device=dev)
    pos[slot] = S
    return logits, {"pos": pos, "stack": stack}
