"""Sharding rules for the mesh: parameter specs, the serving shard plan, and
the slicing that turns full tensors into one rank's pieces.

Port of ``repro.parallel.sharding``. A *spec* is a tuple with one entry per
tensor dim: ``None`` (replicated), an axis name, or a tuple of axis names
(the dim is split over their product, the first name outermost), as a JAX
``PartitionSpec`` lists them. A *mesh* is a ``torch.distributed``
``DeviceMesh`` with dims named ``("data", "model")`` (``("pod", "data",
"model")`` for the multi-pod shapes), or a plain ``{axis: size}`` mapping
where only the shape matters.

``param_specs`` gives the same spec as the JAX package, leaf for leaf, for
every family and the ``train``, ``serve_tp`` and ``serve_2d`` policies.
``decode_specs`` / ``verify_specs`` keep the JAX decisions of which head
dims a given tp splits.

Serving runs explicit SPMD (``ServeShard``, Megatron style): each rank holds
its shard of every parameter and of the cache and launches only its
shard's kernels, with the collectives of ``parallel.tensor_parallel`` where
JAX's partitioner would place them. ``plan_serve_shard`` fixes one rank's
piece of each split dim:

* query heads, ``d_ff`` columns, SSM heads (``d_inner`` channels) and the
  padded vocabulary split evenly over ``model`` (the column-parallel
  ``wq`` / ``wi`` / ``wg`` / ``w_x`` / ``w_z`` / ``conv_x``, the
  row-parallel ``wo`` / ``out_proj``, the vocab-sharded ``embed`` and
  ``unembed``, as ``param_specs`` shards them);
* KV heads split with the query heads when ``KV % tp == 0``. Otherwise
  (``tp % KV == 0``) a rank holds the one KV head its query heads read, so
  each KV head is replicated over ``tp / KV`` ranks and a fused kernel's
  group ``H_local / KV_local`` stays integral (JAX splits ``wk`` / ``wv``
  columns and lets XLA all-gather through ``decode_kv``);
* the SSM per-head vectors (``w_dt``, ``A_log``, ``D``, ``dt_bias``; JAX
  replicates them) are held as the slice of this rank's heads;
* MoE experts as ``param_specs`` splits them: ``n_experts / tp`` whole
  experts a rank where ``n_experts % tp == 0`` (expert parallelism), else
  every expert's ``moe_d_ff / tp`` columns; the router stays replicated,
  so every rank routes every token over all experts and runs only its
  own experts (or columns) under their gates, a partial sum;
* an encoder-decoder model's encoder stack and its decoder layers'
  cross-attention (``cross``) are cut as the self-attention and the MLP
  are; the frontend projection is replicated.

``serve_2d`` holds each parameter as ``param_specs(..., "serve_2d")`` cuts
it (dim 0, d_model or the vocabulary's other dim, over the data axes too),
a rank keeping ``1 / (dp * tp)`` of the weights, and gathers a layer
group's data-split dims over ``data`` just before the group runs
(``tensor_parallel.Serve2D``): every kernel then runs at the ``serve_tp``
shard's shapes and arithmetic.

The cache layout differs from JAX's on purpose: JAX shards the KV sequence
dim on ``model`` under ``serve_tp`` and lets XLA reshard; the port shards
the dense cache and the page pool by KV head, the same split as the K/V
projections, the cross-attention's encoder K/V by KV head too, and the SSM
state by head (``serve_cache_specs``). ``serve_2d`` keeps that layout: the
reference replicates its slots and splits the KV sequence over (data,
model). Slots split
over ``data`` when ``n_slots % dp == 0`` and the cache is dense; a paged
pool has no slot dim (and a shared prefix page is read by slots of any
data rank), so paged slots stay replicated over ``data``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# axis vocabulary
# ---------------------------------------------------------------------------


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in axis_sizes(mesh) else None


def _spec_axes(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: None, one name, or a tuple of names (a
    ``PartitionSpec`` entry normalizes a one-name tuple to the name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _axes_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(sizes[a] for a in axes)


# ---------------------------------------------------------------------------
# parameter specs (the JAX rules, leaf for leaf)
# ---------------------------------------------------------------------------


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, cfg: ModelConfig, mesh, policy: str) -> Any:
    """Spec tree matching ``params`` (only its structure and leaf ranks are
    read), by the JAX package's rules: ``train`` and ``serve_2d`` shard
    dim 0 (d_model / vocab) over the data axes and inner dims over
    ``model``; ``serve_tp`` shards inner dims only. MoE experts go to
    ``model`` when their count divides it (EP), else each expert's d_ff
    does."""
    sizes = axis_sizes(mesh)
    m = model_axis(mesh)
    d0: Any = _spec_axes(data_axes(mesh))
    if policy == "serve_tp":
        d0 = None
    ep = bool(cfg.n_experts) and cfg.n_experts % sizes.get("model", 1) == 0

    def leaf_spec(keys, leaf) -> Spec:
        nd = len(leaf.shape)
        o = 1 if "stack" in keys else 0  # leading group axis

        def spec(*axes):
            full = [None] * nd
            for i, ax in enumerate(axes):
                full[o + i] = ax
            return tuple(full)

        rep = (None,) * nd
        name = keys[-1]
        parent = keys[-2] if len(keys) >= 2 else ""
        if name == "embed":
            return (m, d0)
        if name == "unembed":
            return (d0, m)
        if name == "frontend_proj":
            return (None, d0)
        if name in ("scale", "bias"):  # norms (incl. ssm_norm)
            return spec(m) if parent == "ssm_norm" else rep
        if parent in ("attn", "cross"):
            if name in ("wq", "wk", "wv"):
                return spec(d0, m)
            if name == "wo":
                return spec(m, d0)
        if parent == "mlp":
            if name in ("wi", "wg"):
                return spec(d0, m)
            if name == "wo":
                return spec(m, d0)
        if parent == "moe":
            if name == "router":
                return spec(d0, None)
            if name in ("wi", "wg"):
                return spec(m, d0, None) if ep else spec(None, d0, m)
            if name == "wo":
                return spec(m, None, d0) if ep else spec(None, m, d0)
        if parent == "ssm":
            if name in ("w_x", "w_z"):
                return spec(d0, m)
            if name in ("w_bc", "w_dt"):
                return spec(d0, None)
            if name == "conv_x_w":
                return spec(m, None)
            if name == "conv_x_b":
                return spec(m)
            if name == "out_proj":
                return spec(m, d0)
        return rep

    return _map_with_path(params, leaf_spec)


def serve_policy(cfg: ModelConfig, tp: int = 16) -> str:
    """Pick serve sharding by per-chip footprint at TP-only sharding."""
    per_chip = cfg.n_params() * 2 / tp  # bf16
    return "serve_2d" if per_chip > 8e9 else "serve_tp"


def decode_specs(cfg: ModelConfig, mesh, policy: str,
                 batch: Optional[int] = None) -> Dict[str, Spec]:
    """The one-token decode's head layout, as JAX pins it: ``decode_q`` /
    ``decode_kv`` split heads over ``model`` where it divides the head
    count and replicate them otherwise; ``decode_ssm`` likewise for the
    SSM channels. ``batch`` splits the slot dim over the data axes only
    where it divides."""
    sizes = axis_sizes(mesh)
    m = model_axis(mesh)
    d: Any = _spec_axes(data_axes(mesh))
    if policy == "serve_2d":
        d = None
    b = d if batch and d is not None and batch % _axes_size(sizes, d) == 0 \
        else None
    tp = sizes.get("model", 1) if m else 1
    specs: Dict[str, Spec] = {"residual": (b, None, None)}
    if cfg.n_heads:
        specs["decode_q"] = (b, None, m if cfg.n_heads % tp == 0 else None,
                             None)
        specs["decode_kv"] = (b, None,
                              m if cfg.n_kv_heads % tp == 0 else None, None)
    if cfg.ssm_state:
        specs["decode_ssm"] = (b, None,
                               m if cfg.ssm_d_inner % tp == 0 else None)
    return specs


def verify_specs(cfg: ModelConfig, mesh, policy: str,
                 batch: Optional[int] = None) -> Dict[str, Spec]:
    """JAX's multi-position verify layout: heads replicated over ``model``
    (a workaround for an XLA CPU partitioner bug). The port keeps heads
    split at S > 1 as at S = 1 (the tests hold its tokens to the local
    engine's); this is kept for comparison with the JAX decisions."""
    d: Any = _spec_axes(data_axes(mesh))
    if policy == "serve_2d":
        d = None
    b = d if batch and d is not None \
        and batch % _axes_size(axis_sizes(mesh), d) == 0 else None
    specs: Dict[str, Spec] = {"residual": (b, None, None)}
    if cfg.n_heads:
        specs["decode_q"] = (b, None, None, None)
        specs["decode_kv"] = (b, None, None, None)
    if cfg.ssm_state:
        specs["decode_ssm"] = (b, None, None)
    return specs


# ---------------------------------------------------------------------------
# slicing full tensors by spec
# ---------------------------------------------------------------------------

Slices = Dict[int, Tuple[int, int]]  # dim -> (start, size)


def spec_slices(shape, spec: Spec, sizes: Dict[str, int],
                coord: Dict[str, int]) -> Slices:
    """The piece of a ``shape`` tensor that the rank at mesh coordinate
    ``coord`` holds under ``spec``: ``{dim: (start, size)}``. A split dim
    must divide evenly; a tuple of axes splits with its first axis
    outermost."""
    out: Slices = {}
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        n = _axes_size(sizes, axes)
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {axes} ({n} ways)")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        size = shape[dim] // n
        out[dim] = (idx * size, size)
    return out


def take(t: torch.Tensor, slices: Slices) -> torch.Tensor:
    """``t`` narrowed to ``slices``, as a contiguous tensor of its own."""
    for dim, (start, size) in slices.items():
        t = t.narrow(dim, start, size)
    return t.contiguous()


def mesh_coord(mesh) -> Dict[str, int]:
    """This rank's coordinate in a ``DeviceMesh``: ``{axis: index}``."""
    return {n: int(mesh.get_local_rank(n)) for n in mesh.mesh_dim_names}


def shard_params(params, specs, mesh, coord: Optional[Dict[str, int]] = None):
    """This rank's slices of the full tensors ``params`` under ``specs``
    (``coord`` picks another rank's, for host-side tests)."""
    sizes = axis_sizes(mesh)
    coord = mesh_coord(mesh) if coord is None else coord

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        return take(p, spec_slices(p.shape, s, sizes, coord))

    return walk(params, specs)


def unshard_params(pieces: Callable[[Dict[str, int]], Any], specs, mesh):
    """The full tensors back from every rank's pieces: ``pieces(coord)``
    gives the tree that rank holds. The inverse of ``shard_params``."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    coords = [dict(zip(names, c)) for c in
              _product([range(sizes[n]) for n in names])]
    trees = [(c, pieces(c)) for c in coords]

    def walk(path, s):
        if isinstance(s, dict):
            return {k: walk(path + (k,), v) for k, v in s.items()}
        parts = [(c, _at(t, path)) for c, t in trees]
        shape = list(parts[0][1].shape)
        for dim, ax in enumerate(s):
            if ax is not None:
                shape[dim] *= _axes_size(sizes, ax)
        full = torch.empty(shape, dtype=parts[0][1].dtype,
                           device=parts[0][1].device)
        for c, piece in parts:
            view = full
            for dim, (start, size) in spec_slices(shape, s, sizes, c).items():
                view = view.narrow(dim, start, size)
            view.copy_(piece)
        return full

    return walk((), specs)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _product(ranges):
    out = [()]
    for r in ranges:
        out = [o + (i,) for o in out for i in r]
    return out


# ---------------------------------------------------------------------------
# the serving shard plan
# ---------------------------------------------------------------------------

# the width operands (``elastic.active_widths``) whose prefix widths a
# shard turns local: each maps to a (start, size) range of the global dim
_ACTIVE_KEYS = ("q_dim", "kv_dim", "d_ff", "d_inner", "ssm_heads")


@dataclasses.dataclass(frozen=True)
class ServeShard:
    """One rank's piece of a served model over a (data, model) mesh.

    ``cfg`` is the shard-local config (local head, KV-head, d_ff, SSM head
    and expert ``moe_d_ff`` counts; ``n_experts`` stays global, since the
    router scores every expert): the model code and the kernels run on it
    unchanged. ``experts`` is (start, size) of the rank's experts (all of
    them where it holds columns of each, ``moe_ff``).
    ``ranges`` maps each width operand to the (start, size) of this rank's
    slice of the global dim, for turning a global prefix width into a local
    one. ``slots`` is (start, size) of this rank's slots when they split
    over ``data`` (``split_slots``), else (0, n_slots)."""

    cfg: ModelConfig
    tp: int
    dp: int
    model_rank: int
    data_rank: int
    n_slots: int
    split_slots: bool
    slots: Tuple[int, int]
    heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    ff: Tuple[int, int]
    ssm_heads: Tuple[int, int]
    vocab: Tuple[int, int]
    ranges: Dict[str, Tuple[int, int]]
    experts: Tuple[int, int] = (0, 0)
    moe_ff: Tuple[int, int] = (0, 0)


def plan_serve_shard(cfg: ModelConfig, mesh, *, n_slots: int,
                     paged: bool = False,
                     coord: Optional[Dict[str, int]] = None) -> ServeShard:
    """The ``ServeShard`` of the rank at ``coord`` (this rank's by
    default) for serving ``cfg`` with ``n_slots`` slots. Raises where the
    port has no layout: query heads, d_ff, SSM heads or the padded
    vocabulary not divisible by tp, or KV heads with neither ``KV % tp``
    nor ``tp % KV`` zero."""
    sizes = axis_sizes(mesh)
    coord = mesh_coord(mesh) if coord is None else coord
    tp = sizes.get("model", 1)
    r = coord.get("model", 0)
    dp, d = 1, 0
    for a in data_axes(mesh):
        d = d * sizes[a] + coord[a]
        dp *= sizes[a]

    def split(n: int, what: str) -> Tuple[int, int]:
        if n % tp:
            raise ValueError(f"{cfg.name}: {what} = {n} does not split over "
                             f"tp = {tp}")
        return (r * (n // tp), n // tp)

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    heads = kv = ff = sh = (0, 0)
    if H:
        heads = split(H, "n_heads")
        # the reference's decision: KV heads split where tp divides them
        if tp == 1 or decode_specs(cfg, sizes,
                                   "serve_tp")["decode_kv"][2] is not None:
            kv = split(KV, "n_kv_heads")
        elif tp % KV == 0:
            # the one KV head this rank's query heads read
            kv = (heads[0] // (H // KV), 1)
        else:
            raise ValueError(f"{cfg.name}: {KV} KV heads neither split over "
                             f"tp = {tp} nor replicate evenly across it")
    if cfg.d_ff:
        ff = split(cfg.d_ff, "d_ff")
    if cfg.ssm_state:
        sh = split(cfg.ssm_nheads, "ssm heads")
    experts = moe_ff = (0, 0)
    if cfg.n_experts:
        if cfg.n_experts % tp == 0:  # param_specs' expert parallelism
            experts, moe_ff = split(cfg.n_experts, "n_experts"), \
                (0, cfg.moe_d_ff)
        else:
            experts, moe_ff = (0, cfg.n_experts), split(cfg.moe_d_ff,
                                                        "moe_d_ff")
    vocab = split(cfg.padded_vocab(), "padded vocab")
    hp = cfg.ssm_head_dim
    lcfg = dataclasses.replace(
        cfg, n_heads=heads[1], n_kv_heads=kv[1],
        d_ff=ff[1] if cfg.d_ff else 0,
        moe_d_ff=moe_ff[1] if cfg.n_experts else cfg.moe_d_ff,
        ssm_d_inner_override=sh[1] * hp if cfg.ssm_state else 0)
    ranges = {"q_dim": (heads[0] * hd, heads[1] * hd),
              "kv_dim": (kv[0] * hd, kv[1] * hd),
              "d_ff": ff,
              "d_inner": (sh[0] * hp, sh[1] * hp),
              "ssm_heads": sh}
    split_slots = dp > 1 and not paged and n_slots % dp == 0
    slots = ((d * (n_slots // dp), n_slots // dp) if split_slots
             else (0, n_slots))
    return ServeShard(cfg=lcfg, tp=tp, dp=dp, model_rank=r, data_rank=d,
                      n_slots=n_slots, split_slots=split_slots, slots=slots,
                      heads=heads, kv_heads=kv, ff=ff, ssm_heads=sh,
                      vocab=vocab, ranges=ranges, experts=experts,
                      moe_ff=moe_ff)


def _serve_leaf_slices(keys, shape, shard: ServeShard, cfg: ModelConfig
                       ) -> Slices:
    """Where one full parameter leaf is cut for ``shard``."""
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    o = 1 if "stack" in keys else 0
    hd, hp = cfg.head_dim, cfg.ssm_head_dim
    q = (shard.heads[0] * hd, shard.heads[1] * hd)
    kv = (shard.kv_heads[0] * hd, shard.kv_heads[1] * hd)
    din = (shard.ssm_heads[0] * hp, shard.ssm_heads[1] * hp)
    if name == "embed":
        return {0: shard.vocab}
    if name == "unembed":
        return {1: shard.vocab}
    if parent in ("attn", "cross"):
        return {"wq": {o + 1: q}, "wk": {o + 1: kv}, "wv": {o + 1: kv},
                "wo": {o: q}}.get(name, {})
    if parent == "mlp":
        return {"wi": {o + 1: shard.ff}, "wg": {o + 1: shard.ff},
                "wo": {o: shard.ff}}.get(name, {})
    if parent == "moe" and name != "router":
        if shard.experts[1] != cfg.n_experts:  # whole experts
            return {o: shard.experts}
        return {o + (1 if name == "wo" else 2): shard.moe_ff}
    if parent == "ssm_norm":
        return {o: din}
    if parent == "ssm":
        if name in ("w_x", "w_z"):
            return {o + 1: din}
        if name in ("conv_x_w", "conv_x_b", "out_proj"):
            return {o: din}
        if name == "w_dt":
            return {o + 1: shard.ssm_heads}
        if name in ("A_log", "D", "dt_bias"):
            return {o: shard.ssm_heads}
    return {}


def shard_serve_params(params, shard: ServeShard, cfg: ModelConfig):
    """This rank's serving parameters: each leaf cut as ``param_specs``
    (``serve_tp``) cuts it, except the KV projections of a KV head
    replicated across ranks and the SSM per-head vectors, which are held
    as the slice this rank reads (see the module docstring)."""
    if shard.tp == 1:
        return params
    return _map_with_path(params, lambda keys, t: take(
        t, _serve_leaf_slices(keys, t.shape, shard, cfg)))


@dataclasses.dataclass(frozen=True)
class Serve2DLeaf:
    """How one ``serve_2d`` leaf turns into its ``serve_tp`` piece: the
    held piece is all-gathered over ``data`` on ``data_dim`` (None: not
    split over ``data``), then cut to ``after`` ({dim: (start, size)} of
    the gathered tensor: the slice the ``serve_tp`` shard reads of a dim
    ``param_specs`` replicates). Dims count from the leaf's first dim,
    the group axis of a stacked leaf included."""

    data_dim: Optional[int]
    after: Slices
    shape: Tuple[int, ...]  # the serve_tp piece's


def serve_2d_plan(params, shard: ServeShard, cfg: ModelConfig, mesh
                  ) -> Tuple[Any, Any]:
    """``(specs, recipes)`` of ``serve_2d``: ``param_specs(..., "serve_2d")``
    and, leaf for leaf, the ``Serve2DLeaf`` that rebuilds the ``serve_tp``
    piece (``_serve_leaf_slices``) from the held one. Raises where a
    ``serve_tp`` piece needs a gather over ``model`` too: KV heads fewer
    than tp, whose K/V projections the rank holds a column slice of, where
    it reads a whole head."""
    sizes = axis_sizes(mesh)
    if data_axes(mesh) != ("data",):
        raise ValueError(f"serve_2d serves over a (data, model) mesh, got "
                         f"axes {tuple(sizes)}")
    specs = param_specs(params, cfg, mesh, "serve_2d")
    coord = {"data": 0, "model": shard.model_rank}

    def recipe(keys, t):
        spec = _at(specs, keys)
        want = (_serve_leaf_slices(keys, t.shape, shard, cfg)
                if shard.tp > 1 else {})
        held = spec_slices(t.shape, spec, sizes, coord)
        data_dim = None
        for dim, ax in enumerate(spec):
            axes = _axes_of(ax)
            if "data" in axes and sizes["data"] > 1:
                data_dim = dim
            if "model" in axes and dim in held and \
                    want.get(dim, held[dim]) != held[dim]:
                raise ValueError(
                    f"{cfg.name}: serve_2d holds {'/'.join(keys)} split "
                    f"over model where the serve_tp shard reads another "
                    f"slice of dim {dim} ({cfg.n_kv_heads} KV heads under "
                    f"tp = {shard.tp})")
        after = {d: r for d, r in want.items()
                 if not (d in held and "model" in _axes_of(spec[d]))}
        shape = list(t.shape)
        for d, (_, n) in want.items():
            shape[d] = n
        return Serve2DLeaf(data_dim=data_dim, after=after,
                           shape=tuple(shape))

    return specs, _map_with_path(params, recipe)


def _axes_of(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def serve_cache_specs(cfg: ModelConfig, mesh, *, n_slots: int,
                      paged: bool = False) -> Dict[str, Spec]:
    """The port's serving-cache layout, per leaf name (leaves carry the
    leading group axis; the int8 scales follow ``k``): the dense ``k`` /
    ``v`` (G, slots, S, KV, hd) split by KV head on ``model`` (where
    ``KV % tp != 0`` each rank holds the one head its query heads read,
    ``plan_serve_shard``) and by slot on the data axes where the slot count
    divides; the page pool (G, pages, page, KV, hd) by KV head only; the
    SSM ``state`` (G, slots, nh, hp, n) and ``conv_x`` (G, slots, K-1,
    d_inner) by head or channel; an encoder-decoder layer's ``cross_k`` /
    ``cross_v`` (G, slots, KV, enc_seq, hd) by KV head as ``k`` and by
    slot; ``conv_bc`` and ``pos`` by slot only. ``serve_tp`` and
    ``serve_2d`` share it."""
    sizes = axis_sizes(mesh)
    dp = _axes_size(sizes, data_axes(mesh) or None)
    b: Any = (_spec_axes(data_axes(mesh))
              if dp > 1 and not paged and n_slots % dp == 0 else None)
    m = model_axis(mesh)
    return {"pos": (b,),
            "k": (None, None, None, m, None) if paged
            else (None, b, None, m, None),
            "cross_k": (None, b, m, None, None),
            "state": (None, b, m, None, None),
            "conv_x": (None, b, None, m),
            "conv_bc": (None, b, None, None)}
