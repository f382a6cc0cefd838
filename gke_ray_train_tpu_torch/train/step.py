"""The train step (counterpart of ``gke_ray_train_tpu/train/step.py``).

One optimizer step: the batch is split into ``grad_accum`` microbatches
run in sequence; each microbatch's summed token NLL is back-propagated,
its gradients accumulating in ``.grad``; the sum is then divided by the
total token weight (the exact mean: ``nll_sum / w_sum``, gradients times
``1 / w_sum``), and the optimizer clips and updates. This is the JAX
step's single-device case without manual overlap. ``FUSED_OPS`` routes
the blocks' rms_norms and q/k RoPE through the fused kernels
(``ops/fused_norm_rope.py``) and, on a config without a logit softcap
(the cap applies to logits the kernel never forms), the loss through the
fused cross-entropy (``ops/fused_ce.py``) on the final-normed hidden
state, as the JAX step does (:234-240, :278-292). Otherwise logits are
materialized in fp32 and reduced by ``token_nll``.

PyTorch's idiom in place of JAX's: the state is updated in place (the
trainable tensors and the optimizer's moments) and returned for the
JAX signature; the step count is a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike, check_on, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, Transformer, dropout_seed, forward, init_params, torch_dtype,
    unembed_head)
from gke_ray_train_tpu_torch.ops.fused_ce import fused_cross_entropy
from gke_ray_train_tpu_torch.ops.quant import is_qtensor
from gke_ray_train_tpu_torch.train.lora import LoraConfig, init_lora
from gke_ray_train_tpu_torch.train.optim import AdamW, OptimizerSpec

Batch = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    params: Transformer
    lora: Optional[Lora]         # None unless LoRA mode
    opt_state: AdamW             # holds the Adam moments and the count
    step: int


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of weighted token NLL and sum of weights, fp32 whatever the
    compute dtype: ``logsumexp(logits) - logits[target]``, so the
    [B, S, V] log-probabilities are never materialized."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, -1, targets.long()[..., None])[..., 0]
    w = weights.float()
    return torch.sum((lse - tgt) * w), torch.sum(w)


def trainable_tensors(params: Transformer, lora: Optional[Lora]
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of what the optimizer updates: the adapters in
    LoRA mode (``blocks.<i>.<target>.<a|b>``), else every parameter."""
    if lora is None:
        yield from params.named_parameters()
        return
    for i, layer in enumerate(lora):
        for t, ab in layer.items():
            for k, v in ab.items():
                yield f"blocks.{i}.{t}.{k}", v


def make_train_state(cfg: ModelConfig, optimizer: OptimizerSpec,
                     seed: int = 0, *, mesh=None,
                     lora_cfg: Optional[LoraConfig] = None,
                     params: Optional[Transformer] = None,
                     device: DeviceLike = None) -> TrainState:
    """Params (random from ``seed`` unless pre-built ``params`` are
    passed, e.g. a quantized base), LoRA adapters from ``seed + 1`` in
    LoRA mode, and the optimizer over the trainables, on ``device``
    (default ``cuda``). In LoRA mode the base is frozen; in full
    fine-tuning every parameter is trainable."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP queue 1, multi-GPU); the "
            "port trains on one device")
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, device=dev)
    check_on(params.embed, dev, "params")
    lora = None
    if lora_cfg is not None:
        params.requires_grad_(False)
        lora = init_lora(cfg, lora_cfg, seed + 1, device=dev)
    else:
        if any(is_qtensor(m) for m in params.modules()):
            raise ValueError("full fine-tuning needs full-precision "
                             "params; a quantized base trains through "
                             "LoRA (pass lora_cfg)")
        params.requires_grad_(True)
    opt = optimizer.build(trainable_tensors(params, lora))
    return TrainState(params=params, lora=lora, opt_state=opt, step=0)


_UNSET: Any = object()


def _as_device(batch: Batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=dev)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, optimizer: OptimizerSpec, *,
                    mesh=None, lora_cfg: Optional[LoraConfig] = None,
                    grad_accum: Any = _UNSET,
                    schedule: Optional[Callable[[int], float]] = None,
                    plan=None, overlap: str = "off",
                    device: DeviceLike = None
                    ) -> Callable[[TrainState, Batch], tuple]:
    """``(state, batch) -> (state, metrics)``.

    batch: "inputs" / "targets" [B, S] integer, "weights" [B, S] float,
    optional "segment_ids" / "positions" [B, S] (numpy or tensors); B
    must divide by ``grad_accum`` (default ``plan.grad_accum``, else 1).
    metrics: "loss" (exact token-weighted mean), "grad_norm" (global
    norm of the averaged gradients before clipping), "tokens" (the
    weight sum) as 0-dim tensors, and "learning_rate" (float) when a
    ``schedule`` is given. The step runs on ``device`` (default
    ``cuda``), where the state must lie.

    LoRA dropout masks are seeded per (step, microbatch, layer,
    projection), so a resumed run and the recomputation under remat draw
    the same masks. ``plan.fused_ops`` (``FUSED_OPS``, read from the plan
    only, as in the JAX step) runs the fused rms_norm / RoPE kernels and,
    without a logit softcap, the fused cross-entropy. On an MoE model
    each microbatch's loss adds ``cfg.router_aux_coef * router_aux * w``
    (the forward's aux over the microbatch's loss weights, billed per
    token so the divide by the total weight gives ce_mean + coef *
    aux_mean), as the JAX step does (:293-296). Manual overlap and meshes
    raise ``NotImplementedError``."""
    if grad_accum is _UNSET:
        grad_accum = plan.grad_accum if plan is not None else 1
    fused_ops = plan is not None and plan.fused_ops
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP queue 1, multi-GPU)")
    fused_ce = fused_ops and cfg.logit_softcap is None
    if overlap == "manual":
        raise NotImplementedError(
            "OVERLAP=manual (the shard_map microbatch pipeline) is not "
            "ported yet (ROADMAP queue 1, long context and parallelism)")
    dev = resolve_device(device)
    lora_mode = lora_cfg is not None
    drop = lora_cfg.dropout if lora_mode else 0.0
    dtype = torch_dtype(cfg.dtype)
    moe = cfg.n_experts > 0

    def train_step(state: TrainState, batch: Batch):
        if state.opt_state.spec is not optimizer:
            raise ValueError("the state's optimizer was not built from "
                             "this step's optimizer spec")
        params = state.params
        check_on(params.embed, dev, "the train state")
        trainables = [t for _, t in trainable_tensors(params, state.lora)]
        b = _as_device(batch, dev)
        B = b["inputs"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} does not divide into "
                             f"grad_accum={grad_accum} microbatches")
        mb = B // grad_accum
        for t in trainables:
            t.grad = None
        nll_sum = torch.zeros((), dtype=torch.float32, device=dev)
        w_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(grad_accum):
            micro = {k: v[m * mb:(m + 1) * mb] for k, v in b.items()}
            seed = (dropout_seed(state.step, m)
                    if lora_mode and drop > 0.0 else None)
            out = forward(
                params, micro["inputs"], cfg,
                positions=micro.get("positions"),
                segment_ids=micro.get("segment_ids"),
                lora=state.lora,
                lora_scale=lora_cfg.scale if lora_mode else 1.0,
                lora_dropout=drop, lora_seed=seed, fused_ops=fused_ops,
                return_pre_unembed=fused_ce, with_aux=moe,
                token_weights=micro["weights"] if moe else None)
            out, aux = out if moe else (out, None)
            if fused_ce:
                # the head of the one param tree: frozen under LoRA, so
                # the kernel forms no dhead; trained in full fine-tuning
                # (a tied head through embed.T)
                nll, w = fused_cross_entropy(
                    out, unembed_head(params, cfg).to(dtype),
                    micro["targets"], micro["weights"])
            else:
                nll, w = token_nll(out, micro["targets"], micro["weights"])
            del out
            if moe:
                nll = nll + cfg.router_aux_coef * aux["router_aux"] * w
            nll.backward()
            nll_sum += nll.detach()
            w_sum += w
        inv_w = torch.where(w_sum > 0, 1.0 / w_sum,
                            torch.zeros((), device=dev))
        with torch.no_grad():
            for t in trainables:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
                t.grad.mul_(inv_w.to(t.grad.dtype))
        metrics = {"loss": nll_sum * inv_w, "tokens": w_sum}
        if schedule is not None:
            metrics["learning_rate"] = float(schedule(state.step))
        state.opt_state.step()
        metrics["grad_norm"] = state.opt_state.last_grad_norm
        for t in trainables:
            t.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, mesh=None,
                   lora_cfg: Optional[LoraConfig] = None,
                   device: DeviceLike = None):
    """``(state, batch) -> (nll_sum, weight_sum)``: callers sum across
    batches, then divide (the exact eval loss). NLL only: an MoE model's
    router aux is a training term, as in the JAX eval step."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP queue 1, multi-GPU)")
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        check_on(state.params.embed, dev, "the train state")
        b = _as_device(batch, dev)
        logits = forward(state.params, b["inputs"], cfg,
                         positions=b.get("positions"),
                         segment_ids=b.get("segment_ids"),
                         lora=state.lora if lora_cfg is not None else None,
                         lora_scale=lora_cfg.scale if lora_cfg else 1.0)
        return token_nll(logits, b["targets"], b["weights"])

    return eval_step
