"""Decoder models: init / forward and loss / prefill / decode over a per-slot
cache.

Port of ``repro.models.model`` for the dense family (attention + MLP) and
the SSM family (mamba2 blocks, ``models.ssm``). Layer stacks keep the JAX
layout: one group = one period of the layer pattern, group parameters and
caches stacked on a leading ``n_groups`` axis. The ``lax.scan`` over groups
becomes a Python loop over per-group views; the cache is updated in place
through those views (JAX donates the cache buffer for the same effect).
Attention layers cache K/V; SSM layers cache the recurrent state (conv
tails ``conv_x`` / ``conv_bc`` and the SSD ``state``), which slot resets
zero.

Training runs ``forward`` (``depth``, ``collect_exits`` with their exit
norms, ``remat`` per group: ``torch.utils.checkpoint``, or selective
checkpointing that keeps the matrix products), ``cross_entropy`` (padded
vocab masked) and ``loss_fn``. Each leaf of the group stack is unbound once
per pass, so that its gradient is one stack of the groups' parts.

Speculative decoding has ``verify_step`` (read-only scoring of K+1
positions), ``verify_tree`` (read-only scoring of a flattened token tree:
ancestor-mask attention, per-node SSM state), the KV-carrying tree draft
(``init_tree_draft_carry`` and ``draft_tree_level``, one level's frontier
per pass) and ``commit_verify`` (in-place masked commit of K/V, a gather
of each SSM layer's candidate at ``n_accepted``; a tree's accepted path
through ``path_nodes``). ``decode_step``, ``verify_step``,
``verify_tree``, ``draft_tree_level`` and ``commit_verify`` also take a
block-paged cache (``models.paged``) through ``pages`` / ``page_size``.

MoE layers (``cfg.layer_is_moe``: granite and mixtral every layer, jamba
every other one) take ``models.moe`` in place of the MLP: the full
forward and ``prefill`` route by ``cfg.moe_impl`` (capacity dispatch, or
the dropless path under ``"dense"``) and sum the load-balancing loss into
``forward``'s aux; decode, verify and the tree draft always run the
dropless path, gated per slot by ``active["top_k"]``.

Encoder-decoder models (whisper) run an encoder stack over the frontend's
projected ``frames`` (sinusoidal positions, non-causal) once per prompt
pass; every decoder layer adds a cross-attention over its output, whose
K/V the prompt pass caches as ``cross_k`` / ``cross_v`` of shape
(G, B, KV, enc_seq, hd) (the reference keeps (G, B, enc_seq, KV, hd);
this layout is the ``flash_decode`` kernel's (B * KV, enc_seq, hd) as a
view). A ``vision_stub`` frontend (internvl) prepends the projected
``patches`` to the token embeddings, and ``loss_fn`` drops their logits.
Models without RoPE outside the SSM families add sinusoidal positions.
Speculative scoring (``verify_step``, ``verify_tree``,
``draft_tree_level``) refuses both families, as the reference does.

Under a serving mesh (``runtime.serving.MeshExecutor``) the same code runs
one rank's shard on a shard-local config; the collectives of
``parallel.tensor_parallel`` stand where the reference constrains a
sharding: the vocab-sharded embedding lookup, the all-reduce after every
row-parallel mixer and MLP output, and the all-gather of the logits.
Outside a shard context they are the identity.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.paged import cache_rows
from repro_torch.parallel import tensor_parallel as TP

Params = Dict
Cache = Dict


_RECURRENT_CACHE_KEYS = ("conv_x", "conv_bc", "state")


def pos_kind(cfg: ModelConfig) -> str:
    if cfg.use_rope:
        return "rope"
    if cfg.family in ("ssm", "hybrid"):
        return "none"
    return "sinusoidal"


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: attention + MLP layers, no experts, no
    RoPE, no window."""
    return cfg.scaled(layer_pattern=("attn",), n_layers=cfg.enc_layers,
                      n_experts=0, top_k=0, use_rope=False, sliding_window=0,
                      enc_layers=0)


def _check_token_only(cfg: ModelConfig, what: str) -> None:
    if cfg.is_encdec or cfg.frontend:
        raise NotImplementedError(f"{what} supports token-only decoders")


def _tree_index(tree, i):
    """Per-group view: ``a[i]`` on every leaf of a nested dict (a
    ``serve_2d`` stack gathers group ``i`` here)."""
    if isinstance(tree, TP.GroupGather):
        return tree.group(i)
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
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    pd = dtype_of(cfg.param_dtype)
    v = cfg.padded_vocab()
    params: Params = {
        "embed": L.dense_init(gen, (v, cfg.d_model), in_axis=-1, dtype=pd,
                              device=dev),
        "final_norm": L.init_norm(cfg, device=dev),
    }
    params["stack"] = _init_stack(gen, cfg, cfg.n_groups, dev,
                                  cross=cfg.is_encdec)
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, v), dtype=pd,
                                         device=dev)
    if cfg.elastic.exit_layers and cfg.elastic.dedicated_exit_norm:
        params["exit_norms"] = {f"g{g}": L.init_norm(cfg, device=dev)
                                for g in cfg.elastic.exit_layers}
    if cfg.is_encdec:
        params["encoder"] = {
            "stack": _init_stack(gen, _encoder_cfg(cfg), cfg.enc_layers, dev),
            "final_norm": L.init_norm(cfg, device=dev)}
    if cfg.frontend:
        params["frontend_proj"] = L.dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), dtype=pd, device=dev)
    return params


def _init_stack(gen, cfg: ModelConfig, n_groups: int, dev, *,
                cross: bool = False) -> Params:
    """One period of layers, each leaf stacked over ``n_groups``; ``cross``
    adds each layer's cross-attention (``norm_cross``, ``cross``)."""
    lead = (n_groups,)
    stack = {}
    for p in range(cfg.period):
        layer = {"norm1": L.init_norm(cfg, lead=lead, device=dev)}
        if cfg.layer_kind(p) == "attn":
            layer["attn"] = L.init_attention(gen, cfg, lead=lead, device=dev)
        else:
            layer["ssm"] = SSM.init_ssm(gen, cfg, lead=lead, device=dev)
        if cross:
            layer["norm_cross"] = L.init_norm(cfg, lead=lead, device=dev)
            layer["cross"] = L.init_attention(gen, cfg, lead=lead, device=dev)
        if cfg.layer_is_moe(p):
            layer["norm2"] = L.init_norm(cfg, lead=lead, device=dev)
            layer["moe"] = MOE.init_moe(gen, cfg, lead=lead, device=dev)
        elif cfg.d_ff:
            layer["norm2"] = L.init_norm(cfg, lead=lead, device=dev)
            layer["mlp"] = L.init_mlp(gen, cfg, lead=lead, device=dev)
        stack[f"pos{p}"] = layer
    return stack


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(lp, h, cfg: ModelConfig, p: int, active=None, dropless=False):
    """The second half of layer ``p``: h + its MoE or MLP on the normed h.
    Returns (h, the MoE aux loss or None). ``dropless`` (decode, verify and
    the tree draft) takes ``apply_moe_dense`` gated at ``active["top_k"]``;
    otherwise ``cfg.moe_impl`` picks the full pass's route."""
    if cfg.layer_is_moe(p):
        hn = L.apply_norm(lp["norm2"], h, cfg)
        if dropless:
            y, a = MOE.apply_moe_dense(
                lp["moe"], hn, cfg,
                active_topk=active.get("top_k") if active else None)
        elif cfg.moe_impl == "dense":
            y, a = MOE.apply_moe_dense(lp["moe"], hn, cfg)
        else:
            y, a = MOE.apply_moe(lp["moe"], hn, cfg)
        return h + TP.reduce_partial(y).to(h.dtype), a
    if cfg.d_ff:
        hn = L.apply_norm(lp["norm2"], h, cfg)
        h = h + TP.reduce_partial(L.apply_mlp(
            lp["mlp"], hn, cfg,
            active_ff=active.get("d_ff") if active else None))
    return h, None


def _group_fwd(group_params, h, cfg: ModelConfig, positions, *, enc_out=None,
               enc_positions=None, causal=True, want_cache=False,
               cache_extra=0):
    """Run one period of layers. Returns (h, aux, cache_or_None); aux is
    the MoE layers' load-balancing loss, 0.0 without MoE layers. An
    encoder-decoder layer adds its cross-attention over ``enc_out``; its
    K/V are cached as ``cross_k`` / ``cross_v`` (``L.init_cross_cache``)."""
    aux = 0.0
    caches = {}
    for p in range(cfg.period):
        lp = group_params[f"pos{p}"]
        hn = L.apply_norm(lp["norm1"], h, cfg)
        if cfg.layer_kind(p) == "attn":
            mix, (k_, v_) = L.mha(lp["attn"], hn, cfg, positions,
                                  causal=causal)
            if want_cache:
                caches[f"pos{p}"] = _pack_kv_cache(k_, v_, cfg, cache_extra)
        else:
            mix, st = SSM.ssm_forward(lp["ssm"], hn, cfg,
                                      return_state=want_cache)
            if want_cache:
                (x_tail, bc_tail), state = st
                caches[f"pos{p}"] = {"conv_x": x_tail, "conv_bc": bc_tail,
                                     "state": state}
        h = h + TP.reduce_partial(mix)
        if cfg.is_encdec:
            hn = L.apply_norm(lp["norm_cross"], h, cfg)
            mix, (ck, cv) = L.mha(lp["cross"], hn, cfg, positions,
                                  kv_x=enc_out, kv_positions=enc_positions,
                                  causal=False)
            if want_cache:
                caches[f"pos{p}"].update(cross_k=ck, cross_v=cv)
            h = h + TP.reduce_partial(mix)
        h, a = _ffn(lp, h, cfg, p)
        if a is not None:
            aux = aux + a
    return h, aux, (caches if want_cache else None)


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


def _group_views(tree):
    """One tree of views per group: ``a.unbind(0)`` once per leaf, so that
    under autograd every leaf's groups share one backward node (a stack of
    the group gradients), where indexing each group would build a
    full-size gradient per group and sum them. A ``serve_2d`` stack
    gathers each group when it is indexed."""
    if isinstance(tree, TP.GroupGather):
        return tree
    leaves = {k: _group_views(v) if isinstance(v, dict) else v.unbind(0)
              for k, v in tree.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[g] for k, v in leaves.items()} for g in range(n)]


def _remat_wrap(fn, policy: str):
    """Activation checkpointing of one group: ``"full"`` keeps nothing but
    the group's input (``torch.utils.checkpoint``); ``"dots"`` also keeps
    every matrix product's output (selective checkpointing), the port's
    ``dots_with_no_batch_dims_saveable``."""
    if policy == "none":
        return fn
    from torch.utils import checkpoint as ckpt

    if policy == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if policy != "dots":
        raise ValueError(f"remat policy {policy!r}; expected none | dots | "
                         f"full")
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.bmm.default, aten.addmm.default}

    def policy_fn(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    def ctx_fn():
        return ckpt.create_selective_checkpoint_contexts(policy_fn)

    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                      context_fn=ctx_fn)


def _scan_groups(stack, h, cfg: ModelConfig, positions, *, start: int,
                 stop: int, remat: str = "none", enc_out=None,
                 enc_positions=None, want_cache: bool = False,
                 cache_extra: int = 0):
    """Run groups [start, stop). Returns (h, the groups' summed MoE aux,
    caches stacked on a leading group axis or None). ``remat`` checkpoints
    each group (training; no caches then)."""
    if remat != "none" and want_cache:
        raise ValueError("remat applies to the training forward, which "
                         "keeps no caches")
    groups = _group_views(stack)
    per_group = []
    aux = 0.0
    enc = dict(enc_out=enc_out, enc_positions=enc_positions)
    for g in range(start, stop):
        if remat != "none":
            def body(x, gp=groups[g]):
                return _group_fwd(gp, x, cfg, positions, **enc)[:2]
            (h, a), c = _remat_wrap(body, remat)(h), None
        else:
            h, a, c = _group_fwd(groups[g], h, cfg, positions, **enc,
                                 want_cache=want_cache,
                                 cache_extra=cache_extra)
        aux = aux + a
        per_group.append(c)
    if not want_cache:
        return h, aux, None
    caches = {pn: {k: torch.stack([c[pn][k] for c in per_group])
                   for k in per_group[0][pn]} for pn in per_group[0]}
    return h, aux, caches


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token (+ frontend) embedding. Returns (h, positions, enc_out,
    enc_positions); the last two are None without an encoder.

    A ``vision_stub`` frontend's ``patches`` (B, P, frontend_dim) are
    projected by ``frontend_proj`` and prepended to the tokens. An
    encoder-decoder model projects ``frames`` (B, enc_seq, frontend_dim)
    the same way, adds sinusoidal positions and runs the encoder stack
    over them, non-causal, ending in the encoder's final norm."""
    dt = dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    h = TP.embed_lookup(params["embed"], tokens).to(dt)
    enc_out = enc_pos = None
    if cfg.frontend == "vision_stub":
        ph = L.matmul(batch["patches"].to(dt), params["frontend_proj"], dt)
        h = torch.cat([ph, h], dim=1)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    if pos_kind(cfg) == "sinusoidal":
        h = h + L.sinusoidal_pos(positions, cfg.d_model).to(dt)
    if cfg.is_encdec:
        eh = L.matmul(batch["frames"].to(dt), params["frontend_proj"], dt)
        enc_pos = torch.arange(eh.shape[1], dtype=torch.int32,
                               device=h.device)
        eh = eh + L.sinusoidal_pos(enc_pos, cfg.d_model).to(dt)
        ecfg = _encoder_cfg(cfg)
        for gp in _group_views(params["encoder"]["stack"]):
            eh = _group_fwd(gp, eh, ecfg, enc_pos, causal=False)[0]
        enc_out = L.apply_norm(params["encoder"]["final_norm"], eh, cfg)
    return h, positions, enc_out, enc_pos


def _logits(params, h, cfg: ModelConfig, norm_params):
    h = L.apply_norm(norm_params, h, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return TP.gather_vocab(L.matmul(h, w, h.dtype))


def _exit_norm(params, cfg: ModelConfig, depth: int):
    norm_p = params["final_norm"]
    if depth < cfg.n_groups:
        norm_p = params.get("exit_norms", {}).get(f"g{depth}", norm_p)
    return norm_p


def forward(params, batch, cfg: ModelConfig, *, depth: Optional[int] = None,
            collect_exits: Tuple[int, ...] = (), remat: str = "none"):
    """Full-sequence forward (training and evaluation).

    Returns (outputs, aux) where outputs maps "final" -> logits and
    "exit_g{i}" -> logits for each requested exit group below ``depth``
    (through that exit's norm); aux is the MoE load-balancing loss summed
    over the layers run, 0 without MoE layers. ``remat`` ("none" | "dots"
    | "full") checkpoints each layer group (the encoder is not
    checkpointed)."""
    depth = depth if depth is not None else cfg.n_groups
    h, positions, enc_out, enc_pos = _embed_inputs(params, batch, cfg)
    boundaries = sorted([g for g in collect_exits if g < depth]) + [depth]
    outputs = {}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    start = 0
    for b in boundaries:
        if b > start:
            h, a, _ = _scan_groups(params["stack"], h, cfg, positions,
                                   start=start, stop=b, remat=remat,
                                   enc_out=enc_out, enc_positions=enc_pos)
            aux = aux + a
        if b < depth:
            np_ = params.get("exit_norms", {}).get(f"g{b}",
                                                   params["final_norm"])
            outputs[f"exit_g{b}"] = _logits(params, h, cfg, np_)
        start = b
    outputs["final"] = _logits(params, h, cfg, _exit_norm(params, cfg, depth))
    return outputs, aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _mask_pad(logits, cfg: ModelConfig):
    """f32 logits with the padded vocab columns at -1e9."""
    v = cfg.vocab_size
    lg = logits.float()
    pad = lg.shape[-1] - v
    if not pad:
        return lg
    neg = torch.full(tuple(lg.shape[:-1]) + (pad,), -1e9, dtype=torch.float32,
                     device=lg.device)
    return torch.cat([lg[..., :v], neg], dim=-1)


def cross_entropy(logits, targets, cfg: ModelConfig, loss_mask=None):
    """Next-token CE with padded-vocab masking. logits: (B,S,Vp), targets:
    (B,S) integer."""
    lg = _mask_pad(logits, cfg)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if loss_mask is None:
        return nll.mean()
    loss_mask = loss_mask.float()
    return (nll * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, *, depth=None,
            remat: str = "none", aux_weight: float = 0.01):
    """Standard LM loss (teacher phase / plain training). Returns
    (loss, {"ce": ..., "moe_aux": ...}). A ``vision_stub`` model's logits
    cover the patches and the text; the loss takes the text's only."""
    outs, aux = forward(params, batch, cfg, depth=depth, remat=remat)
    logits = outs["final"]
    if cfg.frontend == "vision_stub":
        logits = logits[:, cfg.frontend_seq:]
    loss = cross_entropy(logits, batch["targets"], cfg,
                         batch.get("loss_mask"))
    return loss + aux_weight * aux, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, *,
                      per_slot: bool = False, device=None) -> Cache:
    """Zeroed cache with room for ``capacity`` tokens:
    ``{"pos": () or (B,), "stack": {"pos0": {"k": (G,B,S,KV,hd), ...}}}``;
    SSM layers hold ``conv_x`` / ``conv_bc`` (G,B,K-1,C) in ``cfg.dtype``
    and ``state`` (G,B,nh,hp,n) in f32 instead, whatever the capacity. An
    encoder-decoder model's layers also hold ``cross_k`` / ``cross_v``
    (G,B,KV,enc_seq,hd), which a prompt pass fills."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    lead = (cfg.n_groups,)

    def one_layer(p: int):
        c = (L.init_kv_cache(cfg, batch, capacity, dt, lead=lead, device=dev)
             if cfg.layer_kind(p) == "attn" else
             SSM.init_ssm_cache(cfg, batch, dtype=dt, lead=lead, device=dev))
        if cfg.is_encdec:
            c.update(L.init_cross_cache(cfg, batch, dt, lead=lead, device=dev))
        return c

    stack = {f"pos{p}": one_layer(p) for p in range(cfg.period)}
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                      device=dev)
    return {"pos": pos, "stack": stack}


def reset_cache_slots(cache: Cache, mask) -> Cache:
    """Rewind every slot where ``mask`` (n_slots,) is True, in place.

    Position counters go to 0 and the recurrent state of SSM layers (conv
    tails and SSD state, which carry across tokens unconditionally) is
    zeroed; attention KV is left as it is (position masking hides the
    previous occupant's keys), and so are the cross-attention's
    ``cross_k`` / ``cross_v``. One masked fill per leaf, on the device."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=cache["pos"].device)
    cache["pos"].masked_fill_(mask, 0)
    for layer in cache["stack"].values():
        for k, a in layer.items():
            if k in _RECURRENT_CACHE_KEYS:
                m = mask.reshape((1, mask.shape[0]) + (1,) * (a.dim() - 2))
                a.masked_fill_(m, 0)
    return cache


def reset_cache_slot(cache: Cache, slot) -> Cache:
    """Rewind one batch slot (see ``reset_cache_slots``)."""
    n_slots = cache["pos"].shape[0]
    mask = torch.arange(n_slots, device=cache["pos"].device) == int(slot)
    return reset_cache_slots(cache, mask)


def adopt_cache_slot(cache: Cache, pre: Cache, slot) -> Cache:
    """Copy slot ``slot`` of a prefilled engine-layout cache ``pre`` into
    ``cache``, in place (every leaf's lane, the cross-attention's K/V
    included, and the position)."""
    for pn, layer in cache["stack"].items():
        for k, full in layer.items():
            full[:, slot] = pre["stack"][pn][k][:, slot].to(full.dtype)
    cache["pos"][slot] = pre["pos"][slot]
    return cache


def _group_decode(group_params, group_cache, h, pos, cfg: ModelConfig,
                  active=None, pages=None, page_size=0, plan_len=0,
                  fused=False):
    for p in range(cfg.period):
        lp = group_params[f"pos{p}"]
        cp = group_cache[f"pos{p}"]
        self_keys = ({k: v for k, v in cp.items()
                      if not k.startswith("cross_")} if cfg.is_encdec else cp)
        hn = L.apply_norm(lp["norm1"], h, cfg)
        if cfg.layer_kind(p) == "attn":
            mix, _ = L.mha_decode(lp["attn"], hn, self_keys, pos, cfg,
                                  active=active, pages=pages,
                                  page_size=page_size, plan_len=plan_len,
                                  fused=fused)
        else:  # no fused path: ``fused`` reaches attention layers only
            mix, _ = SSM.ssm_decode_step(lp["ssm"], hn, self_keys, cfg,
                                         active=active)
        h = h + TP.reduce_partial(mix)
        if cfg.is_encdec:
            hn = L.apply_norm(lp["norm_cross"], h, cfg)
            mix, _ = L.mha_decode(lp["cross"], hn,
                                  {"k": cp["cross_k"], "v": cp["cross_v"]},
                                  pos, cfg, cross=True, active=active)
            h = h + TP.reduce_partial(mix)
        h, _ = _ffn(lp, h, cfg, p, active, dropless=True)
    return h


def decode_step(params, cache, tokens, cfg: ModelConfig, *,
                depth: Optional[int] = None, active=None, pages=None,
                page_size=0, plan_len=0, fused=False):
    """One-token decode. tokens: (B, 1). Returns (logits (B,1,Vp), cache).

    ``cache`` is updated in place: each group's K/V slice gets the new
    token and ``cache["pos"]`` advances by one. ``active`` is the runtime
    width operand (``elastic.active_widths_batch``: per-slot (B,) tensors)
    over full params and a full-width cache; ``depth`` truncates the layer
    loop at an exit and reads logits through that exit's norm.

    ``pages`` (B, P) int32 / ``page_size`` switch the attention cache to
    the block-paged layout (``models.paged``): its K/V leaves are page
    pools read and written through the table; SSM leaves stay per slot.
    ``plan_len`` (a slot's full capacity in positions) sizes the fused
    kernels' split plan so that every table width visits rows as the dense
    cache does; the unfused path ignores it. An encoder-decoder model's
    cross-attention reads the cache's ``cross_k`` / ``cross_v`` (on a card
    through the ``flash_decode`` kernel) whether ``fused`` or not."""
    depth = depth if depth is not None else cfg.n_groups
    pos = cache["pos"]
    h = _embed_at(params, tokens, cfg,
                  pos[:, None] if pos.dim() == 1 else pos.reshape(1))
    for g in range(depth):
        h = _group_decode(_tree_index(params["stack"], g),
                          _tree_index(cache["stack"], g), h, pos, cfg,
                          active=active, pages=pages, page_size=page_size,
                          plan_len=plan_len, fused=fused)
    logits = _logits(params, h, cfg, _exit_norm(params, cfg, depth))
    pos.add_(1)
    return logits, cache


# ---------------------------------------------------------------------------
# speculative verify / commit
# ---------------------------------------------------------------------------


def _group_verify(group_params, group_cache, h, pos, cfg: ModelConfig,
                  active=None, tree=None, pages=None, page_size=0,
                  plan_len=0, fused=False):
    """One period of layers over S speculative positions (read-only cache).
    Returns (h, per-layer write candidates for ``commit_verify``). With
    ``tree`` (a static topology, see ``verify_tree``) the S positions are a
    flattened token tree: attention gets its depths and ancestor mask, the
    SSM recurrence follows parent pointers."""
    cand = {}
    for p in range(cfg.period):
        lp = group_params[f"pos{p}"]
        hn = L.apply_norm(lp["norm1"], h, cfg)
        if cfg.layer_kind(p) == "attn":
            mix, cand[f"pos{p}"] = L.mha_verify(
                lp["attn"], hn, group_cache[f"pos{p}"], pos, cfg,
                active=active,
                node_depth=None if tree is None else tree.depths,
                tree_bias=None if tree is None else tree.ancestor_bias,
                pages=pages, page_size=page_size, plan_len=plan_len,
                fused=fused)
        elif tree is None:
            mix, cand[f"pos{p}"] = SSM.ssm_verify_step(
                lp["ssm"], hn, group_cache[f"pos{p}"], cfg, active=active)
        else:
            mix, cand[f"pos{p}"] = SSM.ssm_verify_tree(
                lp["ssm"], hn, group_cache[f"pos{p}"], cfg, tree,
                active=active)
        h, _ = _ffn(lp, h + TP.reduce_partial(mix), cfg, p, active,
                    dropless=True)
    return h, cand


def verify_step(params, cache, tokens, cfg: ModelConfig, *,
                depth: Optional[int] = None, active=None, pages=None,
                page_size=0, plan_len=0, fused=False):
    """Speculative verifier: score S = K+1 positions in one pass.

    ``tokens`` (B, S) is each slot's last committed token followed by its K
    drafts. The per-slot cache (``pos`` (B,)) is read, never written.
    Returns ``(logits (B, S, Vp), pending)``: ``logits[:, j]`` is the
    next-token distribution after ``tokens[:, :j+1]`` (what j+1 chained
    ``decode_step`` calls give), and ``pending = {"stack": {"pos0": {"k":
    (d, B, S, KV, hd), "v": ...}}}`` the raw K/V candidates of the first
    ``depth`` groups, for ``commit_verify``; SSM layers give per-step
    ``conv_x`` / ``conv_bc`` (d, B, S, K-1, C) and ``state``
    (d, B, S, nh, hp, n), entry j the value after consuming token j.
    ``pages`` / ``page_size`` / ``plan_len`` as in ``decode_step``.
    Encoder-decoder and frontend models raise ``NotImplementedError``."""
    _check_token_only(cfg, "verify_step")
    depth = depth if depth is not None else cfg.n_groups
    pos = cache["pos"]
    if pos.dim() != 1:
        raise ValueError("verify_step needs a per-slot cache (pos of shape (B,))")
    B, S = tokens.shape
    if cfg.sliding_window and S > cfg.sliding_window:
        # commit_verify's rolling scatter would map two window positions to
        # one buffer slot — bound K at the window
        raise ValueError(f"verify window of {S} positions exceeds the "
                         f"sliding window ({cfg.sliding_window}); use a "
                         f"draft length K <= window - 1")
    h = _embed_at(params, tokens, cfg,
                  pos.long()[:, None] + torch.arange(S, device=pos.device))
    return _verify_groups(params, cache, h, cfg, depth, active=active,
                          pages=pages, page_size=page_size,
                          plan_len=plan_len, fused=fused)


def _embed_at(params, tokens, cfg: ModelConfig, qpos):
    """Token embedding of (B, S) ``tokens``, plus sinusoidal positions at
    ``qpos`` (B, S) in a model that has them."""
    dt = dtype_of(cfg.dtype)
    h = TP.embed_lookup(params["embed"], tokens).to(dt)
    if pos_kind(cfg) == "sinusoidal":
        h = h + L.sinusoidal_pos(qpos, cfg.d_model).to(dt)
    return h


def _verify_groups(params, cache, h, cfg: ModelConfig, depth, tree=None,
                   **kw):
    """Run ``_group_verify`` over the first ``depth`` groups: (logits,
    pending) with each layer's candidates stacked over the groups."""
    pos = cache["pos"]
    cands = []
    for g in range(depth):
        h, c = _group_verify(_tree_index(params["stack"], g),
                             _tree_index(cache["stack"], g), h, pos, cfg,
                             tree=tree, **kw)
        cands.append(c)
    pend = {pn: {k: torch.stack([c[pn][k] for c in cands]) for k in cands[0][pn]}
            for pn in cands[0]}
    logits = _logits(params, h, cfg, _exit_norm(params, cfg, depth))
    return logits, {"stack": pend}


def verify_tree(params, cache, tokens, cfg: ModelConfig, *, tree,
                depth: Optional[int] = None, active=None, pages=None,
                page_size=0, plan_len=0, fused=False):
    """Token-tree verifier: score a whole candidate tree in one pass.

    ``tokens`` (B, N) is the flattened tree in BFS level order, node 0 each
    slot's last committed token, every other node a drafted candidate
    continuing its parent. ``tree`` is the static topology
    (``runtime.speculative.TreeTopology``): ``depths`` put node j at
    absolute position ``pos + depths[j]``, ``ancestor_bias`` restricts each
    node's attention among the new keys to its own root path (positions
    cannot separate siblings at one depth), ``paths`` / ``parents`` drive
    the SSM conv windows and state recurrence down each branch. The cache
    is read, never written, so any root-to-leaf path can be committed.

    Returns ``(logits (B, N, Vp), pending)``: row j is the next-token
    distribution after the root-to-j path (what chained ``decode_step``
    calls down that branch give), and ``pending`` the per-NODE write
    candidates, committed along the accepted path by
    ``commit_verify(..., path_nodes=...)``. ``depth``, ``active``,
    ``pages``, ``page_size``, ``plan_len`` and ``fused`` as in
    ``verify_step``."""
    _check_token_only(cfg, "verify_tree")
    depth = depth if depth is not None else cfg.n_groups
    pos = cache["pos"]
    if pos.dim() != 1:
        raise ValueError("verify_tree needs a per-slot cache (pos of shape (B,))")
    B, N = tokens.shape
    if N != tree.n_nodes:
        raise ValueError(f"tokens carry {N} nodes, topology has {tree.n_nodes}")
    if cfg.sliding_window and tree.n_levels + 1 > cfg.sliding_window:
        # commit_verify's rolling scatter would alias buffer slots
        raise ValueError(f"tree of depth {tree.n_levels} exceeds the sliding "
                         f"window ({cfg.sliding_window}); bound the tree "
                         f"depth at window - 1")
    depths = torch.as_tensor(tree.depths, dtype=torch.int64,
                             device=pos.device)
    h = _embed_at(params, tokens, cfg, pos.long()[:, None] + depths[None, :])
    return _verify_groups(params, cache, h, cfg, depth, tree=tree,
                          active=active, pages=pages, page_size=page_size,
                          plan_len=plan_len, fused=fused)


def _group_tree_level(group_params, group_cache, group_carry, h, pos,
                      cfg: ModelConfig, *, level, tree, active=None,
                      pages=None, page_size=0):
    """One period of layers over one tree-draft level's frontier: attention
    against the committed cache plus the carried K/V
    (``layers.mha_tree_level``), the SSM recurrence one step from each
    parent's carried state (``ssm.ssm_tree_level``). Returns (h, each
    layer's new carry rows for the frontier)."""
    rows = {}
    f0, f1 = tree.level_nodes(level)
    for p in range(cfg.period):
        lp = group_params[f"pos{p}"]
        cp, cr = group_cache[f"pos{p}"], group_carry[f"pos{p}"]
        hn = L.apply_norm(lp["norm1"], h, cfg)
        if cfg.layer_kind(p) == "attn":
            mix, rows[f"pos{p}"] = L.mha_tree_level(
                lp["attn"], hn, cp, pos, cfg, cr, level=level,
                carry_depths=tree.depths[:f1],
                bias=tree.ancestor_bias[f0:f1, :f1], active=active,
                pages=pages, page_size=page_size)
        else:
            mix, rows[f"pos{p}"] = SSM.ssm_tree_level(
                lp["ssm"], hn, cp, cr, cfg, parents=tree.parents[f0:f1],
                active=active)
        h, _ = _ffn(lp, h + TP.reduce_partial(mix), cfg, p, active,
                    dropless=True)
    return h, rows


def tree_carry_nodes(tree) -> int:
    """Carry rows the KV-carrying tree draft needs = nodes it processes per
    launch: every node but the last level's (leaves get no children)."""
    if tree.n_levels == 0:
        return 1
    return tree.level_nodes(tree.n_levels - 1)[1]


def init_tree_draft_carry(cfg: ModelConfig, batch: int, tree,
                          depth: Optional[int] = None, device=None) -> Cache:
    """Zeroed per-node carry for ``draft_tree_level``: the cache stack's
    layout over the first ``depth`` groups, ``tree_carry_nodes`` rows on the
    node axis. Attention layers carry round-tripped K/V rows
    ``(depth, B, Nc, KV, hd)``; SSM layers post-consume conv tails
    ``(depth, B, Nc, K-1, C)`` and the state ``(depth, B, Nc, nh, hp, n)``
    in f32."""
    depth = depth if depth is not None else cfg.n_groups
    dev = resolve_device(device)
    nc = tree_carry_nodes(tree)
    dt = dtype_of(cfg.dtype)
    lead = (depth, batch, nc)

    def one_layer(p: int):
        if cfg.layer_kind(p) == "attn":
            shape = lead + (cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
        kk = cfg.ssm_conv
        d_in = cfg.ssm_nheads * cfg.ssm_head_dim
        bc = 2 * cfg.ssm_ngroups * cfg.ssm_state
        return {"conv_x": torch.zeros(lead + (kk - 1, d_in), dtype=dt,
                                      device=dev),
                "conv_bc": torch.zeros(lead + (kk - 1, bc), dtype=dt,
                                       device=dev),
                "state": torch.zeros(lead + (cfg.ssm_nheads,
                                             cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=torch.float32, device=dev)}

    return {"stack": {f"pos{p}": one_layer(p) for p in range(cfg.period)}}


def draft_tree_level(params, cache, carry, tokens_lvl, cfg: ModelConfig, *,
                     tree, level: int, depth: Optional[int] = None,
                     active=None, pages=None, page_size=0):
    """Score ONE level of a draft token tree, carrying K/V forward.

    ``tokens_lvl`` (B, nf) is the frontier at ``level`` (level 0: the root,
    the last committed token). The committed per-slot ``cache`` is read
    only; what deeper levels need is written into ``carry`` (from
    ``init_tree_draft_carry``) at the frontier's rows, in place. Over the
    levels this gives ``verify_tree``'s frontier rows while touching each
    node once. Returns (logits (B, nf, Vp), carry)."""
    _check_token_only(cfg, "draft_tree_level")
    depth = depth if depth is not None else cfg.n_groups
    pos = cache["pos"]
    if pos.dim() != 1:
        raise ValueError("draft_tree_level needs a per-slot cache (pos (B,))")
    B, nf = tokens_lvl.shape
    f0, f1 = tree.level_nodes(level)
    if f1 - f0 != nf:
        raise ValueError(f"level {level} frontier is {f1 - f0} nodes, "
                         f"tokens carry {nf}")
    h = _embed_at(params, tokens_lvl, cfg,
                  (pos.long() + level)[:, None].expand(B, nf))
    for g in range(depth):
        gcar = _tree_index(carry["stack"], g)
        h, rows = _group_tree_level(_tree_index(params["stack"], g),
                                    _tree_index(cache["stack"], g), gcar, h,
                                    pos, cfg, level=level, tree=tree,
                                    active=active, pages=pages,
                                    page_size=page_size)
        for pn, layer in rows.items():
            for k, r in layer.items():
                gcar[pn][k][:, f0:f1] = r.to(gcar[pn][k].dtype)
    logits = _logits(params, h, cfg, _exit_norm(params, cfg, depth))
    return logits, carry


def commit_verify(cache, pending, n_accepted, cfg: ModelConfig,
                  path_nodes=None, pages=None, page_size=0) -> Cache:
    """Advance each slot by ``n_accepted + 1`` tokens from a verify pass.

    MUTATES ``cache`` in place and returns it. ``n_accepted`` is a (B,)
    device tensor in [0, S-1]; it never leaves the device. Candidate j of
    slot b is written at position ``pos[b] + j`` (rolling under a sliding
    window) where ``j <= n_accepted[b]``; rejected positions keep the old
    buffer contents, which the advanced position counter then masks. int8
    caches re-quantize the raw candidates. SSM layers take the per-step
    candidate at index ``n_accepted`` (an exact gather on the device).
    Groups past the verify depth are untouched; ``pos += n_accepted + 1``.

    With ``pages`` (B, P) int32 the K/V leaves are page pools: position
    ``pos[b] + j`` resolves through the table to its physical (page,
    offset), and a rejected position writes the pool's own contents back,
    as in the dense scatter (a boolean-mask write would read the accepted
    count back to the host once per leaf); the host then frees the tail
    pages speculation reached past the commit.

    ``path_nodes`` (B, L) commits a token tree (``verify_tree``'s per-node
    candidates): the node indices of each slot's accepted root-to-leaf path
    (entry 0 the root, entries past ``n_accepted`` any valid pad). K/V
    candidates are gathered along the path, after which the accepted
    branch is a linear window and the masked scatter applies unchanged; an
    SSM layer takes the candidate of node ``path_nodes[b, n_accepted[b]]``."""
    pos = cache["pos"]
    n_acc = torch.as_tensor(n_accepted, device=pos.device).long()
    pend = pending["stack"]
    first = next(iter(next(iter(pend.values())).values()))
    d, B, S = first.shape[:3]
    sel = n_acc  # the SSM candidate each slot takes
    if path_nodes is not None:
        path = torch.as_tensor(path_nodes, device=pos.device).long()
        sel = path.gather(1, n_acc[:, None])[:, 0]
        bix = torch.arange(B, device=pos.device)[:, None]
        pend = {pn: {k: (t[:, bix, path] if k in ("k", "v") else t)
                     for k, t in layer.items()}
                for pn, layer in pend.items()}
        S = path.shape[1]
    j = torch.arange(S, device=pos.device)
    acc = j[None, :] <= n_acc[:, None]  # (B, S)
    tgt = pos.long()[:, None] + j[None, :]

    def scatter(full, new):
        sub = full[:d]
        Sc = (pages.shape[1] * page_size if pages is not None
              else full.shape[2])
        slot = (torch.remainder(tgt, Sc) if cfg.sliding_window
                else torch.clamp(tgt, max=Sc - 1))
        rows = cache_rows(pages, slot, page_size)
        old = sub[(slice(None),) + rows]  # (d, B, S, ...)
        m = acc.reshape((1, B, S) + (1,) * (new.dim() - 3))
        sub[(slice(None),) + rows] = torch.where(m, new.to(full.dtype), old)

    def select_step(full, new):
        """full (G, B, ...) <- candidate ``sel`` of new (d, B, S, ...)."""
        ix = sel.reshape((1, B, 1) + (1,) * (new.dim() - 3))
        ix = ix.expand((d, B, 1) + tuple(new.shape[3:]))
        full[:d].copy_(torch.gather(new, 2, ix)[:, :, 0])

    for pn, layer in cache["stack"].items():
        pc = pend[pn]
        if "k" not in pc:  # ssm: per-step recurrent candidates
            for key in _RECURRENT_CACHE_KEYS:
                select_step(layer[key], pc[key])
        elif "k_scale" in layer:
            kq, ks_ = L.quantize_kv(pc["k"])
            vq, vs = L.quantize_kv(pc["v"])
            for key, new in (("k", kq), ("v", vq), ("k_scale", ks_),
                             ("v_scale", vs)):
                scatter(layer[key], new)
        else:
            scatter(layer["k"], pc["k"])
            scatter(layer["v"], pc["v"])
    pos.add_((n_acc + 1).to(pos.dtype))
    return cache


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
    it zero. ``batch`` carries ``frames`` (encoder-decoder) or ``patches``
    (``vision_stub``) beside ``tokens`` where the model takes them; the
    encoder's K/V land in every decoder layer's ``cross_k`` / ``cross_v``
    and the patches count as prompt positions."""
    depth = depth if depth is not None else cfg.n_groups
    h, positions, enc_out, enc_pos = _embed_inputs(params, batch, cfg)
    S = h.shape[1]
    h, _, caches = _scan_groups(params["stack"], h, cfg, positions, start=0,
                                stop=depth, enc_out=enc_out,
                                enc_positions=enc_pos, want_cache=True,
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
