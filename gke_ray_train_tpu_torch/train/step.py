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

On a mesh (``parallel/mesh.py::build_mesh``: ranks over ``data`` ×
``fsdp`` × ``model`` × ``context``, one card each) the model is sharded
over ``model`` (tensor parallelism, ``parallel/tensor.py``) and with
FSDP2 (``parallel/sharding.py``; replicated over ``context``), and each
batch rank runs the step on its own rows, which its ``model`` peers
share; over ``context`` each rank holds its ``S / C`` tokens of those
rows and the attention runs across the context ranks (``ATTN_IMPL``
``ring`` or ``a2a``). The token NLL and weight sums are all-reduced over
the batch axes and ``context`` before the divide
(``parallel/mesh.py::token_groups``; every model rank holds the same,
merged over the vocab shards), so the loss and the gradient scale are
the global ones; FSDP2 sums the sharded gradients over the batch and
context ranks once a step (on the last microbatch), and the LoRA
adapters, replicated on every rank, have their gradients summed in one
all-reduce over the world: each model or context rank's is a partial sum
of the whole (``train/lora.py``). The optimizer reads the global norm
over the shards. With more than one batch or context rank, a rank's
LoRA dropout masks are seeded with its batch index, and its context
index where ``context`` exceeds 1: JAX draws one mask over the global
microbatch, whose tokens these ranks split.

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
    Lora, Transformer, dropout_seed, head_tp, init_params, torch_dtype,
    unembed_head)
from gke_ray_train_tpu_torch.ops.fused_ce import fused_cross_entropy
from gke_ray_train_tpu_torch.ops.quant import is_qtensor
from gke_ray_train_tpu_torch.train.lora import LoraConfig, init_lora
from gke_ray_train_tpu_torch.train.optim import AdamW, OptimizerSpec
from gke_ray_train_tpu_torch.parallel.sharding import (
    is_sharded, local, shard_model)
from gke_ray_train_tpu_torch.parallel.tensor import vocab_parallel_nll

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


def model_nll(logits: torch.Tensor, params: Transformer, cfg: ModelConfig,
              targets: torch.Tensor, weights: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``token_nll`` of ``forward``'s logits: of the whole vocab, or
    under tensor parallelism of this rank's vocab shard, merged exactly
    over the ``model`` axis (``parallel/tensor.py::vocab_parallel_nll``)."""
    tp = head_tp(params, cfg)
    if tp is None:
        return token_nll(logits, targets, weights)
    return vocab_parallel_nll(logits, targets, weights, tp)


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


def _check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ``build_mesh`` mesh whose only axes
    above 1 are the ported ones (data, fsdp, model, context)."""
    if mesh is None:
        return
    from gke_ray_train_tpu_torch.parallel.mesh import mesh_config_of
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh from parallel/mesh.py::"
                        f"build_mesh, not {type(mesh).__name__}")
    mesh_config_of(mesh).check_ported()


def make_train_state(cfg: ModelConfig, optimizer: OptimizerSpec,
                     seed: int = 0, *, mesh=None,
                     lora_cfg: Optional[LoraConfig] = None,
                     params: Optional[Transformer] = None,
                     device: DeviceLike = None) -> TrainState:
    """Params (random from ``seed`` unless pre-built ``params`` are
    passed, e.g. a quantized base), LoRA adapters from ``seed + 1`` in
    LoRA mode, and the optimizer over the trainables, on ``device``
    (default ``cuda``, ``cuda:LOCAL_RANK`` under a process group). In
    LoRA mode the base is frozen; in full fine-tuning every parameter is
    trainable.

    ``mesh``: the params are sharded over its model and fsdp axes
    (``parallel/sharding.py::shard_model``; params a sharded init already
    sharded stay so), the adapters are the same on every rank (rank 0's,
    broadcast), and the optimizer's state is sharded like its
    parameters."""
    _check_mesh(mesh)
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
    if mesh is not None:
        import torch.distributed as dist
        shard_model(params, mesh)
        # every rank holds the same adapters: the world group
        for _, t in trainable_tensors(None, lora) if lora else ():
            with torch.no_grad():
                dist.broadcast(t, src=0)
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
    the same masks; on a mesh of more than one batch rank the rank's
    batch index (``parallel/mesh.py::batch_rank``) joins the seed, at a
    ``context`` above 1 the batch index and the context index
    (``context_rank``) do, and under tensor parallelism the model rank
    joins a row-parallel projection's
    (``models/transformer.py::_drop_kw``). One process, and a mesh of one
    batch rank and one context rank, keep the seeds of the unmeshed
    step.
    ``plan.fused_ops`` (``FUSED_OPS``, read from the plan only, as in the
    JAX step) runs the fused rms_norm / RoPE kernels and,
    without a logit softcap, the fused cross-entropy. On an MoE model
    each microbatch's loss adds ``cfg.router_aux_coef * router_aux * w``
    (the forward's aux over the microbatch's loss weights, billed per
    token so the divide by the total weight gives ce_mean + coef *
    aux_mean), as the JAX step does (:293-296); under expert parallelism
    every model rank routes the same tokens and holds the same aux, so
    the sums over the batch axes (never over ``model``) count it once.
    Manual overlap raises
    ``NotImplementedError``.

    ``mesh``: the state is sharded over it (``make_train_state(mesh=)``)
    and ``batch`` is this rank's rows (at a ``context`` above 1 its
    tokens of them, ``parallel/placement.py``); ``loss`` and ``tokens``
    are the global ones (module doc)."""
    if grad_accum is _UNSET:
        grad_accum = plan.grad_accum if plan is not None else 1
    fused_ops = plan is not None and plan.fused_ops
    _check_mesh(mesh)
    fused_ce = fused_ops and cfg.logit_softcap is None
    # the batch (and context) index a rank's dropout seeds carry (empty:
    # one batch rank and one context rank)
    seed_rank = ()
    if mesh is not None:
        from gke_ray_train_tpu_torch.parallel.mesh import (
            batch_group_size, batch_rank, context_rank, context_size)
        if batch_group_size(mesh) > 1 or context_size(mesh) > 1:
            seed_rank = (batch_rank(mesh),)
        if context_size(mesh) > 1:
            seed_rank += (context_rank(mesh),)
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
        if mesh is not None and not is_sharded(params.embed):
            raise ValueError("a meshed step needs the state "
                             "make_train_state(mesh=) shards")
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
            seed = None
            if lora_mode and drop > 0.0:
                seed = dropout_seed(state.step, m, *seed_rank)

            def loss_fn(out, p, micro=micro):
                if fused_ce:
                    # the head of the one param tree: frozen under LoRA,
                    # so the kernel forms no dhead; trained in full
                    # fine-tuning (a tied head through embed.T); under
                    # TP this rank's vocab shard, merged over `model`
                    return fused_cross_entropy(
                        out, unembed_head(p, cfg).to(dtype),
                        micro["targets"], micro["weights"],
                        vocab_axis=head_tp(p, cfg))
                return model_nll(out, p, cfg, micro["targets"],
                                 micro["weights"])
            if mesh is not None:
                # FSDP2 sums the sharded gradients once, on the last one
                params.set_requires_gradient_sync(m == grad_accum - 1)
            # through Transformer.__call__, with the loss inside it: a
            # sharded root holds the embedding and head gathered
            out = params(
                micro["inputs"], cfg,
                positions=micro.get("positions"),
                segment_ids=micro.get("segment_ids"),
                lora=state.lora,
                lora_scale=lora_cfg.scale if lora_mode else 1.0,
                lora_dropout=drop, lora_seed=seed, fused_ops=fused_ops,
                return_pre_unembed=fused_ce, with_aux=moe,
                token_weights=micro["weights"] if moe else None,
                loss_fn=loss_fn, mesh=mesh)
            (nll, w), aux = out if moe else (out, None)
            if moe:
                nll = nll + cfg.router_aux_coef * aux["router_aux"] * w
            nll.backward()
            nll_sum += nll.detach()
            w_sum += w
        if mesh is not None:
            nll_sum, w_sum = _sum_over_ranks(nll_sum, w_sum, trainables,
                                             mesh)
        inv_w = torch.where(w_sum > 0, 1.0 / w_sum,
                            torch.zeros((), device=dev))
        with torch.no_grad():
            for t in trainables:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
                g = local(t.grad)
                g.mul_(inv_w.to(g.dtype))
        metrics = {"loss": nll_sum * inv_w, "tokens": w_sum}
        if schedule is not None:
            metrics["learning_rate"] = float(schedule(state.step))
        state.opt_state.step()
        metrics["grad_norm"] = state.opt_state.last_grad_norm
        for t in trainables:
            t.grad = None
        state.step += 1
        return state, metrics

    # what the divergence guard hashes of this step's settings
    # (analysis/guards.py::step_identity_text); callables are left out
    train_step.step_identity = {
        "model": dataclasses.asdict(cfg),
        "plan": plan.fingerprint() if plan is not None else None,
        "optimizer": {f.name: getattr(optimizer, f.name)
                      for f in dataclasses.fields(optimizer)
                      if not callable(getattr(optimizer, f.name))},
        "grad_accum": grad_accum, "fused_ops": fused_ops,
        "lora": dataclasses.asdict(lora_cfg) if lora_mode else None,
        "mesh": list(mesh.mesh.shape) if mesh is not None else None,
    }
    return train_step


def _sum_over_ranks(nll_sum, w_sum, trainables, mesh):
    """The step's global sums: the NLL and weight sums all-reduced over
    the batch axes and ``context`` (a ``model`` rank holds its batch
    rank's sums, the same on every peer; a context rank its tokens'),
    and the replicated trainables' (the adapters') gradients summed in
    one flat all-reduce over the world (over ``model`` and ``context``
    each rank's is a partial sum); FSDP2 has summed the sharded ones."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel.mesh import token_groups
    sums = torch.stack([nll_sum, w_sum])
    for group in token_groups(mesh):
        dist.all_reduce(sums, group=group)
    grads = [t.grad for t in trainables
             if t.grad is not None and not is_sharded(t)]
    if grads:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    return sums[0], sums[1]


def make_eval_step(cfg: ModelConfig, *, mesh=None,
                   lora_cfg: Optional[LoraConfig] = None,
                   device: DeviceLike = None):
    """``(state, batch) -> (nll_sum, weight_sum)``: callers sum across
    batches, then divide (the exact eval loss). NLL only: an MoE model's
    router aux is a training term, as in the JAX eval step. On a
    ``mesh`` the sums are this rank's rows' (at a ``context`` above 1 its
    tokens'; ``train/evaluate.py::sharded_eval_sums`` all-reduces
    them)."""
    _check_mesh(mesh)
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        check_on(state.params.embed, dev, "the train state")
        b = _as_device(batch, dev)
        out = state.params(
            b["inputs"], cfg, positions=b.get("positions"),
            segment_ids=b.get("segment_ids"),
            lora=state.lora if lora_cfg is not None else None,
            lora_scale=lora_cfg.scale if lora_cfg else 1.0,
            loss_fn=lambda logits, p: model_nll(logits, p, cfg,
                                                b["targets"], b["weights"]),
            mesh=mesh)
        if mesh is not None:
            # a sharded root keeps its gathered weights after a forward,
            # for the backward (shard_model); an eval has none to wait for
            state.params.reshard()
        return out

    return eval_step
