"""Optimizer and learning-rate schedule (counterpart of
``gke_ray_train_tpu/train/optim.py``).

The JAX package chains ``optax.clip_by_global_norm`` and
``optax.adamw``. Here that is one ``torch.optim.Optimizer``, ``AdamW``,
with optax's numerics where they differ from torch's own:

- clipping scales every gradient by ``max_norm / norm`` (as ``g / norm *
  max_norm``) only when ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- Adam's epsilon is added outside the square root of the bias-corrected
  second moment, and the decoupled weight decay is added to the Adam
  direction before the learning rate scales both;
- the learning rate is ``schedule(count)`` with ``count`` the number of
  updates already made, set into the param groups before each update.

``SGD`` is the same clip before ``optax.sgd`` with momentum (the
config's ``OPTIM=sgd``), and ``Adafactor`` the clip before
``optax.adafactor`` with its defaults (``OPTIM=adafactor``).

On a model sharded with FSDP2 (``parallel/sharding.py``) the parameters,
their gradients and the optimizer state are DTensors: each update runs on
this rank's shards, and what optax reads over a whole tensor (the global
norm; Adafactor's factored row / column means, its update RMS and the
parameter RMS) is summed over the shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from gke_ray_train_tpu_torch.parallel.sharding import (
    all_reduce_sum, global_mean, like_placed, local, sharded_dims)

Schedule = Callable[[int], float]


def warmup_cosine_schedule(base_lr: float, total_steps: int, *,
                           warmup_frac: float = 0.05,
                           min_lr_frac: float = 0.01) -> Schedule:
    """Linear warmup from 0 over ``warmup_frac`` of the steps, then
    cosine decay to ``min_lr_frac * base_lr``: the value of
    ``optax.warmup_cosine_decay_schedule`` as the JAX package builds it,
    as a plain function of the step count (step 0 gives 0)."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay = max(total_steps, warmup + 1) - warmup
    alpha = min_lr_frac if base_lr != 0.0 else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - max(count, 0) / warmup
            return -base_lr * frac + base_lr
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


# leaves AdamW must not decay: norm scales and projection biases, keyed by
# name (the JAX package's stacked layout defeats a rank test)
_NO_DECAY_KEYS = frozenset({
    "attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm",
    "final_norm", "bq", "bk", "bv"})


def default_weight_decay_mask(name: str, p: torch.Tensor) -> bool:
    """Decay weight matrices only: ``name`` (dotted, as
    ``named_parameters`` gives it) does not end in a norm or bias key,
    and the tensor is at least 2-D."""
    return name.rsplit(".", 1)[-1] not in _NO_DECAY_KEYS and p.dim() >= 2


def global_norm(grads: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                stage: Optional[Tuple[object, set]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``), of ``(parameter, local gradient)`` pairs whose
    parameters may be sharded DTensors: the sums of squares of the
    parameters sharded over the same mesh dims are all-reduced once over
    each of those dims (fsdp, and model for a 2-D parameter), so a
    replicated gradient, or a parameter's replicated mesh dim (``data``
    under HSDP, ``model`` for a norm), counts once. ``stage``: on a
    pipelined mesh ``(pipe group, ids of the stage's own parameters)``:
    the stages hold disjoint layers, so their squares are summed over the
    pipe group once, while the root's, the same on every stage, count
    once."""
    grads = list(grads)
    if stage is None:
        return torch.sqrt(_sum_squares(grads))
    group, own = stage
    total = all_reduce_sum(
        _sum_squares([pg for pg in grads if id(pg[0]) in own]), group)
    rest = [pg for pg in grads if id(pg[0]) not in own]
    if rest:
        total = total + _sum_squares(rest)
    return torch.sqrt(total)


def _sum_squares(grads: List[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> torch.Tensor:
    """The global sum of squares of :func:`global_norm`'s pairs (at least
    one pair)."""
    plain: List[torch.Tensor] = []
    by_groups: dict = {}
    for p, g in grads:
        sq = torch.sum(torch.square(g.float()))
        groups = tuple(group for _, group in sharded_dims(p))
        if groups:
            by_groups.setdefault(groups, []).append(sq)
        else:
            plain.append(sq)
    total = sum(plain) if plain else None
    for groups, sqs in by_groups.items():
        part = sum(sqs)
        for group in groups:
            part = all_reduce_sum(part, group)
        total = part if total is None else total + part
    return total


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` / ``make_sgd`` return: the settings, and
    ``build`` to make the optimizer over a model's named trainable
    tensors (as ``make_train_state`` does). ``kind`` "adamw" uses b1, b2,
    eps and the decay; "sgd" uses ``momentum`` only."""
    schedule: Union[Schedule, float]
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay_mask: Callable[[str, torch.Tensor], bool] = \
        default_weight_decay_mask
    kind: str = "adamw"
    momentum: float = 0.9
    # adafactor (optax 0.2.6 defaults)
    decay_rate: float = 0.8
    min_dim_size_to_factor: int = 128
    clipping_threshold: Optional[float] = 1.0
    multiply_by_parameter_scale: bool = True

    def lr(self, count: int) -> float:
        s = self.schedule
        return float(s(count)) if callable(s) else float(s)

    def build(self, named_params: Iterable[Tuple[str, torch.Tensor]]
              ) -> "ClippedOptimizer":
        if self.kind not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer kind {self.kind!r}; "
                             f"valid: {sorted(OPTIMIZERS)}")
        return OPTIMIZERS[self.kind](named_params, self)


class ClippedOptimizer(torch.optim.Optimizer):
    """Global-norm clipping, then the update of a subclass, in optax's
    arithmetic (module doc). Two param groups: decayed and not. The
    per-parameter state (``STATE_KEYS``, zeros like the parameter, or
    what ``_init_state`` makes) is made here, as optax's ``init`` makes
    it, so a checkpoint restores into it before any step. ``step()``
    updates in place and keeps the pre-clip global norm in
    ``last_grad_norm`` (a 0-dim fp32 tensor, read without a host sync);
    ``count`` is the number of updates made. ``_update`` gets the
    (possibly sharded) parameter and its state, and this rank's part of
    the clipped gradient."""

    STATE_KEYS: Tuple[str, ...] = ()

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 spec: OptimizerSpec):
        decay: List[torch.Tensor] = []
        keep: List[torch.Tensor] = []
        for name, p in named_params:
            (decay if spec.weight_decay_mask(name, p) else keep).append(p)
        groups = [{"params": ps, "weight_decay": wd}
                  for ps, wd in ((decay, spec.weight_decay), (keep, 0.0))
                  if ps]
        super().__init__(groups, dict(lr=spec.lr(0), weight_decay=0.0))
        self.spec = spec
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        # (pipe group, ids of the stage's own parameters) on a pipelined
        # mesh (train/step.py::make_train_state), for the global norm
        self.stage_norm: Optional[Tuple[object, set]] = None
        for g in self.param_groups:
            for p in g["params"]:
                self.state[p] = self._init_state(p)

    def _init_state(self, p: torch.Tensor) -> dict:
        return {k: torch.zeros_like(p) for k in self.STATE_KEYS}

    def _update(self, p: torch.Tensor, g: torch.Tensor, st: dict,
                lr: float, wd: float) -> None:
        raise NotImplementedError

    def _begin(self) -> None:
        """Per-step constants, after ``count`` moved to this update."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        spec = self.spec
        params = [p for g in self.param_groups for p in g["params"]]
        grads = {p: (local(p.grad) if p.grad is not None
                     else torch.zeros_like(local(p)))
                 for p in params}
        norm = global_norm(grads.items(), self.stage_norm)
        self.last_grad_norm = norm
        if spec.clip_norm is not None:
            # optax: select(norm < max_norm, g, g / norm * max_norm)
            trigger = norm < spec.clip_norm
            grads = {p: torch.where(trigger, g,
                                    g / norm.to(g.dtype) * spec.clip_norm)
                     for p, g in grads.items()}
        lr = spec.lr(self.count)
        self.count += 1
        self._begin()
        for group in self.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                self._update(p, grads[p], self.state[p], lr,
                             group["weight_decay"])
        return loss


class AdamW(ClippedOptimizer):
    """Clip, then AdamW: moments ``mu`` / ``nu``, bias corrections in
    fp32 as optax forms them, decoupled decay added to the direction."""

    STATE_KEYS = ("mu", "nu")

    def _begin(self) -> None:
        spec = self.spec
        n = torch.tensor(float(self.count), dtype=torch.float32)
        self._c1 = float(1.0 - torch.tensor(spec.b1, dtype=torch.float32)
                         ** n)
        self._c2 = float(1.0 - torch.tensor(spec.b2, dtype=torch.float32)
                         ** n)

    def _update(self, p, g, st, lr, wd):
        spec = self.spec
        p, mu, nu = local(p), local(st["mu"]), local(st["nu"])
        mu.copy_((1.0 - spec.b1) * g + spec.b1 * mu)
        nu.copy_((1.0 - spec.b2) * torch.square(g) + spec.b2 * nu)
        u = (mu / self._c1) / (torch.sqrt(nu / self._c2) + spec.eps)
        if wd:
            u = u + wd * p
        p.add_((u * -lr).to(p.dtype))


class SGD(ClippedOptimizer):
    """Clip, then ``optax.sgd(schedule, momentum)``: the trace ``g +
    momentum * trace`` scaled by the learning rate; no decay."""

    STATE_KEYS = ("trace",)

    def _update(self, p, g, st, lr, wd):
        p, tr = local(p), local(st["trace"])
        tr.copy_(g + self.spec.momentum * tr)
        p.add_((tr * -lr).to(p.dtype))


def factored_dims(shape, min_dim_size_to_factor: int
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (second largest, largest) dim of a
    tensor of at least 2 dims whose second largest dim reaches
    ``min_dim_size_to_factor``, else None (numpy's argsort, as optax)."""
    if len(shape) < 2:
        return None
    order = np.argsort(tuple(shape))
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(ClippedOptimizer):
    """Clip, then ``optax.adafactor(learning_rate=schedule,
    weight_decay_rate=...)`` with optax 0.2.6's defaults: factored
    second moments (``v_row`` / ``v_col``) on tensors whose two largest
    dims reach ``min_dim_size_to_factor``, a full ``v`` otherwise, decay
    ``1 - t ** -decay_rate``, the update clipped to block RMS
    ``clipping_threshold``, scaled by the learning rate, then by the
    parameter's RMS (at least 1e-3), plus ``weight_decay`` times the
    parameter (every parameter: optax is given no mask), in that order.
    Every mean is over the whole tensor when it is sharded."""

    def _init_state(self, p):
        fd = factored_dims(p.shape, self.spec.min_dim_size_to_factor)
        if fd is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = fd
        lp = local(p)
        out = {}
        for key, drop in (("v_row", d0), ("v_col", d1)):
            shape = tuple(n for i, n in enumerate(p.shape) if i != drop)
            lshape = tuple(n for i, n in enumerate(lp.shape) if i != drop)
            out[key] = like_placed(
                torch.zeros(lshape, dtype=p.dtype, device=lp.device), p,
                shape, dropped=(drop,))
        return out

    def _begin(self) -> None:
        # optax: t = count + 1 in fp32, decay 1 - t ** -decay_rate; kept
        # as Python floats so that no step copies a scalar to the card
        t = torch.tensor(float(self.count), dtype=torch.float32)
        decay = 1.0 - t ** (-self.spec.decay_rate)
        self._decay, self._keep = float(decay), float(1.0 - decay)

    def _update(self, p, g, st, lr, wd):
        spec = self.spec
        lp = local(p)
        dev = lp.device
        dr, keep = self._decay, self._keep
        g2 = torch.square(g) + spec.eps
        fd = factored_dims(p.shape, spec.min_dim_size_to_factor)
        if fd is not None:
            d1, d0 = fd
            vr, vc = local(st["v_row"]), local(st["v_col"])
            new_vr = (dr * vr + keep * global_mean(g2, p, (d0,))).to(vr.dtype)
            new_vc = (dr * vc + keep * global_mean(g2, p, (d1,))).to(vc.dtype)
            rd1 = d1 - 1 if d1 > d0 else d1
            row_mean = global_mean(new_vr, st["v_row"], (rd1,), keepdim=True)
            u = (g * torch.unsqueeze((new_vr / row_mean) ** -0.5, d0)
                 * torch.unsqueeze(new_vc ** -0.5, d1))
            vr.copy_(new_vr)
            vc.copy_(new_vc)
        else:
            v = local(st["v"])
            new_v = (dr * v + keep * g2).to(v.dtype)
            u = g * new_v ** -0.5
            v.copy_(new_v)
        if spec.clipping_threshold is not None:
            rms = torch.sqrt(global_mean(torch.square(u), p))
            u = u / torch.clamp_min(rms / spec.clipping_threshold, 1.0)
        u = torch.full((), lr, dtype=u.dtype, device=dev) * u
        if spec.multiply_by_parameter_scale:
            prms = torch.sqrt(global_mean(torch.square(lp), p))
            u = u * torch.where(prms <= 1e-3,
                                torch.full_like(prms, 1e-3), prms)
        if wd:
            u = u + wd * lp
        lp.add_((-u).to(lp.dtype))


OPTIMIZERS = {"adamw": AdamW, "sgd": SGD, "adafactor": Adafactor}


def make_optimizer(schedule: Union[Schedule, float], *,
                   weight_decay: float = 0.01,
                   clip_norm: Optional[float] = 1.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay_mask: Optional[
                       Callable[[str, torch.Tensor], bool]] = None
                   ) -> OptimizerSpec:
    """The JAX ``make_optimizer`` (clip, then AdamW with the name-keyed
    decay mask) as an ``OptimizerSpec``."""
    return OptimizerSpec(
        schedule=schedule, weight_decay=weight_decay, clip_norm=clip_norm,
        b1=b1, b2=b2, eps=eps,
        weight_decay_mask=weight_decay_mask or default_weight_decay_mask)


def make_adafactor(schedule: Union[Schedule, float], *,
                   clip_norm: Optional[float] = 1.0,
                   weight_decay_rate: Optional[float] = None
                   ) -> OptimizerSpec:
    """``optax.chain(clip_by_global_norm(clip_norm),
    adafactor(learning_rate=schedule,
    weight_decay_rate=weight_decay_rate))`` as an ``OptimizerSpec``
    (optax 0.2.6's other defaults: ``min_dim_size_to_factor`` 128,
    ``decay_rate`` 0.8, ``decay_offset`` 0, parameter scaling on,
    ``clipping_threshold`` 1.0, no momentum, ``eps`` 1e-30)."""
    return OptimizerSpec(schedule=schedule,
                         weight_decay=weight_decay_rate or 0.0,
                         clip_norm=clip_norm, eps=1e-30, kind="adafactor",
                         weight_decay_mask=lambda name, p: True)


def make_sgd(schedule: Union[Schedule, float], *,
             clip_norm: Optional[float] = 1.0,
             momentum: float = 0.9) -> OptimizerSpec:
    """``optax.chain(clip_by_global_norm(clip_norm), sgd(schedule,
    momentum))`` as an ``OptimizerSpec``."""
    return OptimizerSpec(schedule=schedule, weight_decay=0.0,
                         clip_norm=clip_norm, kind="sgd", momentum=momentum)
