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
config's ``OPTIM=sgd``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional, Tuple, Union

import torch

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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


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
    per-parameter state (``STATE_KEYS``, zeros like the parameter) is
    made here, as optax's ``init`` makes it, so a checkpoint restores
    into it before any step. ``step()`` updates in place and keeps the
    pre-clip global norm in ``last_grad_norm`` (a 0-dim fp32 tensor, read
    without a host sync); ``count`` is the number of updates made."""

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
        for g in self.param_groups:
            for p in g["params"]:
                self.state[p] = {k: torch.zeros_like(p)
                                 for k in self.STATE_KEYS}

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
        grads = {p: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for p in params}
        norm = global_norm(grads.values())
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
        mu, nu = st["mu"], st["nu"]
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
        tr = st["trace"]
        tr.copy_(g + self.spec.momentum * tr)
        p.add_((tr * -lr).to(p.dtype))


OPTIMIZERS = {"adamw": AdamW, "sgd": SGD}


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


def make_sgd(schedule: Union[Schedule, float], *,
             clip_norm: Optional[float] = 1.0,
             momentum: float = 0.9) -> OptimizerSpec:
    """``optax.chain(clip_by_global_norm(clip_norm), sgd(schedule,
    momentum))`` as an ``OptimizerSpec``."""
    return OptimizerSpec(schedule=schedule, weight_decay=0.0,
                         clip_norm=clip_norm, kind="sgd", momentum=momentum)
