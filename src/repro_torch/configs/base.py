"""Model / elastic / training configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``. The config is a
*complete* description of the computation: the model zoo (``repro.models``)
builds init/apply/prefill/decode functions from it, the sharding rules
(``repro.parallel.sharding``) derive partition specs from it, and NeuroForge
(``repro_torch.core.neuroforge``) derives analytical FLOP/byte/collective models
from it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Elastic (NeuroMorph) configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ElasticConfig:
    """NeuroMorph morphing space attached to a model.

    ``width_fractions`` are the selectable width morph levels (paper's
    "width-wise morphing": fraction of active filters -> fraction of active
    attention heads / kv heads / d_ff columns / SSD heads / MoE top_k).
    ``exit_layers`` are depth-morph exit points, expressed in *layer-group*
    indices (after group ``g`` the hidden state may branch to an exit head).
    The full model is always the last entry implicitly.
    """

    width_fractions: Tuple[float, ...] = (0.5, 1.0)
    exit_layers: Tuple[int, ...] = ()  # e.g. (8, 16) for a 32-layer net
    # Dedicated exit-head behaviour: each exit gets its own final norm; the
    # unembedding is shared (vocab-sized heads per exit would dwarf the
    # backbone — documented adaptation of the paper's per-exit FC heads).
    dedicated_exit_norm: bool = True
    # DistillCycle hyperparameters (paper Eq. 17-18, 20)
    distill_temperature: float = 2.0
    distill_lambda: float = 0.5
    lr_decay_gamma: float = 0.8

    def modes(self, n_groups: int) -> Tuple["MorphMode", ...]:
        """Enumerate all morph modes (cartesian depth x width)."""
        exits = tuple(e for e in self.exit_layers if 0 < e < n_groups)
        depths = exits + (n_groups,)
        out = []
        for d in depths:
            for w in self.width_fractions:
                out.append(MorphMode(depth=d, width=w))
        return tuple(out)


@dataclass(frozen=True)
class MorphMode:
    """One NeuroMorph execution path: run ``depth`` layer groups at ``width``."""

    depth: int  # number of layer groups to run
    width: float  # fraction of active width in (0, 1]

    @property
    def name(self) -> str:
        return f"d{self.depth}w{int(self.width * 100)}"


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | squared_relu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    use_rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # Attention variants
    sliding_window: int = 0  # 0 -> full attention; >0 -> SWA window

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> d_ff)
    moe_period: int = 1  # MoE every `period` layers (jamba: 2); 1 = every layer
    capacity_factor: float = 1.25
    moe_group_size: int = 512  # dispatch group size (tokens)
    moe_impl: str = "capacity"  # capacity (einsum dispatch) | dense (dropless oracle)

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_d_inner_override: int = 0  # set by NeuroMorph width morphing
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # Hybrid layer pattern: index within period -> "attn" | "ssm".
    # Model layers = pattern repeated n_layers/len(pattern) times.
    layer_pattern: Tuple[str, ...] = ()

    # Encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0  # fixed encoder length (1500 for whisper)

    # Modality frontend stub
    frontend: str = ""  # "" | "audio_stub" | "vision_stub"
    frontend_seq: int = 0  # e.g. 1500 audio frames / 256 image patches
    frontend_dim: int = 0  # embedding dim provided by the stub

    # Elastic / NeuroMorph
    elastic: ElasticConfig = field(default_factory=ElasticConfig)

    # Numerics
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"  # master param dtype (CPU tests); bf16 for dry-run

    # Attention implementation knobs (NeuroForge genome can override)
    attn_impl: str = "auto"  # auto | einsum | chunked  (chunked = O(S*chunk) memory)
    attn_chunk: int = 1024  # kv-block size for chunked attention
    kv_quant: bool = False  # int8 KV cache with per-(pos,head) scales (beyond-paper opt)

    # -- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if not self.layer_pattern:
            kind = "ssm" if self.family == "ssm" else "attn"
            object.__setattr__(self, "layer_pattern", (kind,))
        if self.n_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}"
            )

    # Layer-group (scan) structure -----------------------------------------
    @property
    def period(self) -> int:
        """Layers per scanned group. Dense archs: max(1, pattern)."""
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period

    def layer_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % self.period]

    def layer_is_moe(self, layer_idx: int) -> bool:
        if not self.n_experts:
            return False
        return layer_idx % self.moe_period == (self.moe_period - 1)

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_d_inner_override or self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(k == "ssm" for k in self.layer_pattern) and not self.is_encdec

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid state or sliding-window attn."""
        has_full_attn = any(k == "attn" for k in self.layer_pattern) and self.sliding_window == 0
        if self.is_encdec:
            has_full_attn = True
        return not has_full_attn or self.family in ("ssm", "hybrid")

    # Vocab padding for sharding (Megatron practice) -------------------------
    def padded_vocab(self, multiple: int = 2048) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    # Parameter counting (analytical; mirrors models/ param shapes) ----------
    def param_counts(self) -> dict:
        """Returns dict with total and active (per-token) parameter counts."""
        d, hd = self.d_model, self.head_dim
        counts = {"embed": self.padded_vocab() * d}
        unembed = 0 if self.tie_embeddings else self.padded_vocab() * d
        counts["unembed"] = unembed
        attn = ssm = mlp_dense = moe_total = moe_active = router = 0
        n_mlp_matrices = 3 if self.activation == "swiglu" else 2
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                attn += d * self.q_dim + self.q_dim * d + 2 * d * self.kv_dim
            else:
                d_in = self.ssm_d_inner
                proj_out = 2 * d_in + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads
                ssm += d * proj_out + d_in * d
                ssm += (d_in + 2 * self.ssm_ngroups * self.ssm_state) * self.ssm_conv
                ssm += 3 * self.ssm_nheads  # A_log, D, dt_bias
            if self.layer_is_moe(i):
                per_expert = n_mlp_matrices * d * self.moe_d_ff
                moe_total += self.n_experts * per_expert
                moe_active += self.top_k * per_expert
                router += d * self.n_experts
            else:
                mlp_dense += n_mlp_matrices * d * self.d_ff
        enc = 0
        if self.is_encdec:
            # encoder self-attn + mlp, decoder cross-attn (added to attn above? no:
            # decoder layers counted in n_layers as self-attn; add cross-attn here)
            enc_attn = self.enc_layers * (2 * d * self.q_dim + 2 * d * self.kv_dim)
            enc_mlp = self.enc_layers * n_mlp_matrices * d * self.d_ff
            cross = self.n_layers * (d * self.q_dim + self.q_dim * d + 2 * d * self.kv_dim)
            enc = enc_attn + enc_mlp + cross
        frontend_proj = self.frontend_dim * d if self.frontend else 0
        counts.update(
            attn=attn, ssm=ssm, mlp=mlp_dense, moe_total=moe_total, router=router,
            encdec_extra=enc, frontend=frontend_proj,
        )
        total = sum(counts.values())
        active = total - moe_total + moe_active
        counts["total"] = total
        counts["active"] = active
        return counts

    def n_params(self) -> int:
        return self.param_counts()["total"]

    def n_active_params(self) -> int:
        return self.param_counts()["active"]

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, with a reason when skipped."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic path at 512k (DESIGN.md)"
    return True, ""
