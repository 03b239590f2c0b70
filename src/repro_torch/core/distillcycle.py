"""DistillCycle training (paper §IV.B, Algorithm 2, Eq. 16-21).

Port of ``repro.core.distillcycle``. Three principles:
  1. *Grow progressively*: the schedule is ordered by depth; stage ``i``
     trains the network up to its exit boundary (Eq. 19). Deeper groups
     stay untouched until their stage arrives (shared-weight store).
  2. *Train in cycles*: each stage alternates a **teacher phase** (the full
     current net, plain CE, Eq. 16) and a **student phase** (the subnet, CE
     plus temperature-scaled KL distillation, Eq. 17/18).
  3. *Knowledge distillation*: students match the teacher's softened
     distribution; lambda balances ground truth against soft labels.

Subnet weights are prefix *views* of the full weights
(``core.elastic.slice_params``), so student gradients land straight in the
shared store: the paper's ``merge(subnet, net)`` is the identity.

Eq. 20 (exponential LR decay for earlier layers across stages) is a
per-stage global LR factor gamma^stage, with the paper's per-epoch
alpha / 10. Where the reference jits one step per depth (teacher) or mode
(student), the port builds one step callable per key and counts the
builds (``builds``), as ``core.morph`` counts its steps. The teacher's
forward in a student step runs under ``torch.no_grad()``: the port's
``stop_gradient``, and it keeps no teacher activations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MorphMode
from repro_torch.core import elastic
from repro_torch.data.pipeline import DataConfig, make_batch, to_device
from repro_torch.models.model import _mask_pad, cross_entropy, forward
from repro_torch.optim import (OptimizerConfig, apply_updates, grads_of,
                               init_opt_state, trainable)

# ---------------------------------------------------------------------------
# losses (Eq. 16-18)
# ---------------------------------------------------------------------------


def kd_loss(student_logits, teacher_logits, cfg: ModelConfig,
            temperature: float):
    """Eq. 17: tau^2 * KL( sigma(x_t / tau) || sigma(x_s / tau) )."""
    t = temperature
    sl = _mask_pad(student_logits, cfg) / t
    tl = _mask_pad(teacher_logits, cfg) / t
    pt = torch.softmax(tl, dim=-1)
    kl = torch.sum(pt * (torch.log_softmax(tl, dim=-1)
                         - torch.log_softmax(sl, dim=-1)), dim=-1)
    return (t * t) * kl.mean()


def teacher_loss(params, batch, cfg: ModelConfig, depth: int):
    """Eq. 16: plain CE on the current full network."""
    outs, aux = forward(params, batch, cfg, depth=depth)
    return cross_entropy(outs["final"], batch["targets"], cfg) + 0.01 * aux


def student_loss(params, batch, cfg: ModelConfig, mode: MorphMode,
                 teacher_logits, lam: float, temperature: float):
    """Eq. 18: L = lambda * L_GT + (1 - lambda) * L_KD on the subnet."""
    outs, aux = elastic.morph_forward(params, batch, cfg, mode)
    logits = outs["final"]
    ce = cross_entropy(logits, batch["targets"], cfg)
    kd = kd_loss(logits, teacher_logits, cfg, temperature)
    return lam * ce + (1.0 - lam) * kd + 0.01 * aux, {"ce": ce, "kd": kd}


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------


@dataclass
class DistillCycleConfig:
    temperature: float = 2.0  # tau
    lam: float = 0.5  # lambda
    gamma: float = 0.8  # Eq. 20 cross-stage decay
    epochs_per_stage: int = 2
    steps_per_epoch: int = 10
    epoch_lr_decay: float = 10.0  # paper line 22: alpha <- alpha / 10 per epoch
    teacher_steps_ratio: float = 1.0  # teacher steps per student step


def default_schedule(cfg: ModelConfig) -> Tuple[MorphMode, ...]:
    """Depth-ordered morphing schedule covering every deployable path.

    For each exit depth (ascending, ending at full depth) train the reduced
    widths first, then the full width: the paper's depth- and width-aware
    schedule."""
    exits = tuple(e for e in cfg.elastic.exit_layers if 0 < e < cfg.n_groups)
    depths = exits + (cfg.n_groups,)
    widths = tuple(sorted(cfg.elastic.width_fractions))
    return tuple(MorphMode(depth=d, width=w) for d in depths for w in widths)


class DistillCycle:
    """Runs Algorithm 2 over a shared-weight elastic model, in place on the
    params and optimizer state it is given."""

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig, dc: DataConfig,
                 schedule: Optional[Sequence[MorphMode]] = None,
                 dcfg: Optional[DistillCycleConfig] = None):
        self.cfg = cfg
        self.ocfg = ocfg
        self.dc = dc
        self.dcfg = dcfg or DistillCycleConfig(
            temperature=cfg.elastic.distill_temperature,
            lam=cfg.elastic.distill_lambda,
            gamma=cfg.elastic.lr_decay_gamma,
        )
        self.schedule = tuple(schedule or default_schedule(cfg))
        self.trained_paths: List[MorphMode] = []
        self.history: List[Dict] = []
        self.builds = 0
        self._teacher_steps: Dict[int, Callable] = {}
        self._student_steps: Dict[str, Callable] = {}

    # -- step callables (one per depth / mode, built once) -------------------
    def _teacher_step(self, depth: int):
        if depth not in self._teacher_steps:
            cfg, ocfg = self.cfg, self.ocfg

            def step(params, opt, batch, lr_scale):
                loss = teacher_loss(params, batch, cfg, depth)
                grads = grads_of(loss, params)
                params, opt, _ = apply_updates(params, grads, opt, ocfg,
                                               lr_scale)
                return params, opt, loss.detach()

            self._teacher_steps[depth] = step
            self.builds += 1
        return self._teacher_steps[depth]

    def _student_step(self, mode: MorphMode, teacher_depth: int):
        key = f"{mode.name}@t{teacher_depth}"
        if key not in self._student_steps:
            cfg, ocfg, dcfg = self.cfg, self.ocfg, self.dcfg

            def step(params, opt, batch, lr_scale):
                with torch.no_grad():
                    t_outs, _ = forward(params, batch, cfg,
                                        depth=teacher_depth)
                loss, parts = student_loss(params, batch, cfg, mode,
                                           t_outs["final"], dcfg.lam,
                                           dcfg.temperature)
                grads = grads_of(loss, params)
                params, opt, _ = apply_updates(params, grads, opt, ocfg,
                                               lr_scale)
                return (params, opt, loss.detach(),
                        {k: v.detach() for k, v in parts.items()})

            self._student_steps[key] = step
            self.builds += 1
        return self._student_steps[key]

    def _batch(self, step: int, device):
        return to_device(make_batch(self.cfg, self.dc, step), device)

    # -- main loop (Algorithm 2) ---------------------------------------------
    def run(self, params, opt_state=None, *, on_step=None):
        """Algorithm 2 over ``self.schedule``; returns (params, opt state).
        ``on_step(phase, mode, depth)``, when given, is called after every
        step ("teacher" at the grown depth, "student" at ``mode``)."""
        trainable(params)
        device = params["embed"].device
        opt = (opt_state if opt_state is not None
               else init_opt_state(params, self.ocfg))
        d = self.dcfg
        data_step = 0
        grown_depth = 0
        for stage, mode in enumerate(self.schedule):
            grown_depth = max(grown_depth, mode.depth)  # Eq. 19 growth
            stage_scale = d.gamma ** stage  # Eq. 20
            t_step = self._teacher_step(grown_depth)
            s_step = self._student_step(mode, grown_depth)
            for epoch in range(d.epochs_per_stage):
                lr_scale = stage_scale / (d.epoch_lr_decay ** epoch)
                # Phase 1: teacher (full current net, Eq. 16)
                n_teacher = max(1, int(d.steps_per_epoch * d.teacher_steps_ratio))
                for _ in range(n_teacher):
                    batch = self._batch(data_step, device)
                    data_step += 1
                    params, opt, t_loss = t_step(params, opt, batch, lr_scale)
                    if on_step:
                        on_step("teacher", mode, grown_depth)
                # Phase 2: student with KD (Eq. 17-18)
                for _ in range(d.steps_per_epoch):
                    batch = self._batch(data_step, device)
                    data_step += 1
                    params, opt, s_loss, parts = s_step(params, opt, batch,
                                                        lr_scale)
                    if on_step:
                        on_step("student", mode, grown_depth)
                self.history.append({
                    "stage": stage, "mode": mode.name, "epoch": epoch,
                    "teacher_loss": float(t_loss), "student_loss": float(s_loss),
                    "student_ce": float(parts["ce"]),
                    "student_kd": float(parts["kd"]),
                })
            self.trained_paths.append(mode)  # merge == identity (shared store)
        return params, opt

    # -- evaluation ----------------------------------------------------------
    @torch.no_grad()
    def eval_modes(self, params, n_batches: int = 4, seed_offset: int = 10_000,
                   with_agreement: bool = False):
        """Eval every trained path (paper Figs. 11/12 accuracy axis).

        Default: ``{mode name: eval CE}``. With ``with_agreement=True`` each
        entry becomes ``{"ce": ..., "agreement": ...}``, ``agreement`` being
        the subnet's top-1 match rate against the full model on the same
        batches: the offline predictor of speculative-draft acceptance (a
        greedy verifier accepts a drafted token exactly when draft and full
        model argmax agree)."""
        out = {}
        v = self.cfg.vocab_size
        device = params["embed"].device
        batches = [self._batch(seed_offset + i, device)
                   for i in range(n_batches)]
        full_top1 = []  # per-batch full-model argmax, computed once
        if with_agreement:
            full_mode = MorphMode(depth=self.cfg.n_groups, width=1.0)
            for batch in batches:
                fouts, _ = elastic.morph_forward(params, batch, self.cfg,
                                                 full_mode)
                full_top1.append(torch.argmax(fouts["final"][..., :v], -1))
        for mode in self.schedule:
            tot, agree, n_tok = 0.0, 0, 0
            for i, batch in enumerate(batches):
                outs, _ = elastic.morph_forward(params, batch, self.cfg, mode)
                lg = outs["final"]
                tot += float(cross_entropy(lg, batch["targets"], self.cfg))
                if with_agreement:
                    m = torch.argmax(lg[..., :v], -1) == full_top1[i]
                    agree += int(m.sum())
                    n_tok += m.numel()
            ce = tot / n_batches
            if with_agreement:
                out[mode.name] = {"ce": ce, "agreement": agree / max(n_tok, 1)}
            else:
                out[mode.name] = ce
        return out
