"""The train step (counterpart of ``gke_ray_train_tpu/train/step.py``).

One optimizer step: the batch is split into ``grad_accum`` microbatches
run in sequence; each microbatch's summed token NLL is back-propagated,
its gradients accumulating in ``.grad``; the sum is then divided by the
total token weight (the exact mean: ``nll_sum / w_sum``, gradients times
``1 / w_sum``), and the optimizer clips and updates. ``FUSED_OPS`` routes
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

Over ``pipe`` (``models/pipeline.py``) a rank holds its stage's layers
and its adapters; each grad-accum microbatch (JAX's order: grad-accum
outside, pipe microbatches inside) runs the pipeline's forward ticks
inside one call of the sharded root (``pipeline_forward``; the first
stage embeds, the last applies the final norm, head and loss to each
pipe microbatch) and then its backward ticks. The loss is the last
stage's token-weighted sum, the weight sum comes from the batch (every
pipe rank of a batch rank loads the same rows), the root's gradients are
summed over the pipe group (with tied embeddings the lookup's and the
head's), the adapters' over the ranks of the stage, and the global norm
sums each stage's squares once (``train/optim.py``). FSDP2 reduces once
a step, in each rank's last backward call. An MoE slot's router aux
enters its loss as JAX's pipelined aux does (the coefficient times the
microbatch weight over ``M·n_layers``).

``OVERLAP`` (``plan.overlap``, JAX :232): ``xla`` registers FSDP2's
explicit prefetch on the sharded model (``parallel/sharding.py::
set_prefetch``) and computes what ``off`` computes; ``manual`` runs each
microbatch's forward and backward through ``train/overlap.py``'s
hand-placed, double-buffered fsdp gathers (data / fsdp meshes, dense
blocks, full fine-tuning), its gradients reduced as FSDP2 reduces them;
on a mesh of more than one slice (``parallel/mesh.py::num_slices_of``)
staged at the slice boundary by the plan's ``dcn_sync``, and under
``dcn_compress`` with JAX's error-feedback residual carried from each
microbatch into the next, zeroed at the step's start and dropped at its
end (JAX :319-352).

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
    Lora, Transformer, _unembed, dropout_seed, head_tp, init_params,
    lora_layer_ids, pipeline_forward, pre_unembed, torch_dtype,
    unembed_head)
from gke_ray_train_tpu_torch.ops.fused_ce import fused_cross_entropy
from gke_ray_train_tpu_torch.ops.quant import is_qtensor
from gke_ray_train_tpu_torch.train.lora import LoraConfig, init_lora
from gke_ray_train_tpu_torch.train.optim import AdamW, OptimizerSpec
from gke_ray_train_tpu_torch.parallel.mesh import pipe_size
from gke_ray_train_tpu_torch.parallel.sharding import (
    is_sharded, local, set_prefetch, shard_model)
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
    LoRA mode (``blocks.<i>.<target>.<a|b>``, ``i`` the global layer: a
    pipeline stage's adapters are its layers'), else every parameter."""
    if lora is None:
        yield from params.named_parameters()
        return
    for i, layer in zip(lora_layer_ids(lora), lora):
        for t, ab in layer.items():
            for k, v in ab.items():
                yield f"blocks.{i}.{t}.{k}", v


def _check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ``build_mesh`` mesh of a layout the
    port runs (``MeshConfig.check_ported``)."""
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
    parameters. On a pipelined mesh a rank keeps its stage's layers and
    their adapters (broadcast over the stage's ranks), and the optimizer
    sums the stages' squares for its global norm."""
    from gke_ray_train_tpu_torch.models.pipeline import mesh_stage
    _check_mesh(mesh)
    dev = resolve_device(device)
    stage = mesh_stage(cfg, mesh)
    if params is None:
        params = init_params(cfg, seed, device=dev, mesh=mesh)
    check_on(params.embed, dev, "params")
    lora = None
    if lora_cfg is not None:
        params.requires_grad_(False)
        lora = init_lora(cfg, lora_cfg, seed + 1, device=dev, layers=stage)
    else:
        if any(is_qtensor(m) for m in params.modules()):
            raise ValueError("full fine-tuning needs full-precision "
                             "params; a quantized base trains through "
                             "LoRA (pass lora_cfg)")
        params.requires_grad_(True)
    if mesh is not None:
        import torch.distributed as dist
        from gke_ray_train_tpu_torch.parallel.mesh import stage_group
        shard_model(params, mesh)
        # every rank of a stage (the world without pipe) holds the same
        # adapters
        group = stage_group(mesh)
        src = 0 if group is None else dist.get_global_rank(group, 0)
        for _, t in trainable_tensors(None, lora) if lora else ():
            with torch.no_grad():
                dist.broadcast(t, src=src, group=group)
    opt = optimizer.build(trainable_tensors(params, lora))
    if stage is not None:
        from gke_ray_train_tpu_torch.parallel.mesh import pipe_group
        own = {id(t) for name, t in trainable_tensors(params, lora)
               if name.startswith("blocks.")}
        opt.stage_norm = (pipe_group(mesh), own)
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
                    pipe_microbatches: Any = _UNSET,
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
    ``overlap`` (``"off"``, ``"xla"`` or ``"manual"``; ``plan.overlap``
    wins where a plan is given, as the JAX step reads it from the plan
    alone): ``"xla"`` has FSDP2 prefetch the next block's gather in the
    forward and the previous one's in the backward; ``"manual"`` runs each
    microbatch through ``train/overlap.py::make_manual_grad_fn`` and
    raises ``ManualOverlapUnsupported`` where that path cannot run (no
    mesh, ``model`` / ``context`` / ``pipe`` above 1, LoRA, MoE).

    ``mesh``: the state is sharded over it (``make_train_state(mesh=)``)
    and ``batch`` is this rank's rows (at a ``context`` above 1 its
    tokens of them, ``parallel/placement.py``); ``loss`` and ``tokens``
    are the global ones (module doc). ``pipe_microbatches``: the pipe
    microbatches of each grad-accum microbatch on a pipelined mesh
    (default ``plan.pipe_microbatches``; 0 or None: one a hop,
    ``pipe_virtual × pipe``)."""
    if grad_accum is _UNSET:
        grad_accum = plan.grad_accum if plan is not None else 1
    if pipe_microbatches is _UNSET:
        pipe_microbatches = plan.pipe_microbatches if plan is not None else 0
    fused_ops = plan is not None and plan.fused_ops
    if plan is not None:
        overlap = plan.overlap
    from gke_ray_train_tpu_torch.plan import OVERLAP_MODES
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap={overlap!r} not in {OVERLAP_MODES}")
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
    dev = resolve_device(device)
    lora_mode = lora_cfg is not None
    manual = None
    compressed = False
    if overlap == "manual":
        from gke_ray_train_tpu_torch.parallel.mesh import num_slices_of
        from gke_ray_train_tpu_torch.train.overlap import (
            check_manual_support, make_manual_grad_fn)
        check_manual_support(cfg, mesh, lora=lora_mode)
        slices = num_slices_of(mesh)
        if plan is not None and plan.num_slices not in (1, slices):
            raise ValueError(
                f"the plan's num_slices={plan.num_slices} is not the "
                f"mesh's ({slices}): build the mesh with MeshConfig("
                "num_slices=...)")
        manual = make_manual_grad_fn(
            cfg, mesh, fused_ops=fused_ops, use_fused_ce=fused_ce,
            num_slices=slices,
            dcn_sync=plan.dcn_sync if plan is not None else "flat",
            dcn_compress=plan.dcn_compress if plan is not None else "none")
        compressed = manual.compressed
    prefetch = overlap == "xla" and mesh is not None
    drop = lora_cfg.dropout if lora_mode else 0.0
    dtype = torch_dtype(cfg.dtype)
    moe = cfg.n_experts > 0
    piped = pipe_size(mesh) > 1

    def train_step(state: TrainState, batch: Batch):
        if state.opt_state.spec is not optimizer:
            raise ValueError("the state's optimizer was not built from "
                             "this step's optimizer spec")
        params = state.params
        check_on(params.embed, dev, "the train state")
        if mesh is not None and not is_sharded(params.embed):
            raise ValueError("a meshed step needs the state "
                             "make_train_state(mesh=) shards")
        if prefetch and not getattr(params, "_prefetch_set", False):
            set_prefetch(params)
            params._prefetch_set = True
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
        # the compressed hop's error-feedback residual (None: zeros)
        residual = None
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
            if piped:
                nll, w = _pipe_microbatch(
                    params, micro, cfg, mesh, state.lora,
                    lora_cfg.scale if lora_mode else 1.0, drop, seed,
                    fused_ops, fused_ce, dtype, pipe_microbatches or None,
                    loss_fn, last=m == grad_accum - 1)
                nll_sum += nll
                w_sum += w
                continue
            if compressed:
                nll, w, residual = manual(params, micro, loss_fn,
                                          last=m == grad_accum - 1,
                                          residual=residual)
                nll_sum += nll
                w_sum += w
                continue
            if manual is not None:
                nll, w = manual(params, micro, loss_fn,
                                last=m == grad_accum - 1)
                nll_sum += nll
                w_sum += w
                continue
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
            root = ([t for n, t in trainable_tensors(params, state.lora)
                     if not n.startswith("blocks.")] if piped else ())
            nll_sum, w_sum = _sum_over_ranks(nll_sum, w_sum, trainables,
                                             mesh, root)
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
        "overlap": overlap,
        "lora": dataclasses.asdict(lora_cfg) if lora_mode else None,
        "mesh": list(mesh.mesh.shape) if mesh is not None else None,
        "pipe_microbatches": pipe_microbatches if piped else None,
    }
    return train_step


def _pipe_microbatch(params, micro, cfg, mesh, lora, lora_scale, drop,
                     seed, fused_ops, fused_ce, dtype, microbatches,
                     loss_fn, *, last: bool):
    """One grad-accum microbatch on a pipelined mesh: the forward ticks
    inside one call of the sharded root (the head's loss of each pipe
    microbatch on the last stage), then the backward ticks. FSDP2 keeps
    the gradients unreduced (and the root gathered) until this rank's
    last backward call of the step. Returns this rank's (NLL and aux
    sum, weight sum): the NLL is the last stage's, the aux each stage's
    own slots'; the weights are the batch's, the same on every stage."""
    from gke_ray_train_tpu_torch.models import pipeline as pl
    # the gates first, while the root is still sharded
    pl.check_run(cfg, mesh, microbatches, micro["inputs"].shape[0],
                 dropout=lora is not None and seed is not None and drop > 0)
    params.set_requires_gradient_sync(False)
    params.set_reshard_after_backward(False, recurse=False)

    def head(m, y):
        out = (pre_unembed(y, params, cfg) if fused_ce
               else _unembed(y, params, cfg, dtype))
        rows = slice(m * y.shape[0], (m + 1) * y.shape[0])
        return loss_fn(out, params, {k: v[rows] for k, v in micro.items()})
    run = params(micro["inputs"], cfg, step_fn=pipeline_forward,
                 positions=micro.get("positions"),
                 segment_ids=micro.get("segment_ids"), lora=lora,
                 lora_scale=lora_scale, lora_dropout=drop, lora_seed=seed,
                 fused_ops=fused_ops,
                 token_weights=micro["weights"] if cfg.n_experts else None,
                 mesh=mesh, microbatches=microbatches, head=head)
    M = run.schedule.microbatches
    Bm = micro["inputs"].shape[0] // M
    w = sum(micro["weights"][m * Bm:(m + 1) * Bm].float().sum()
            for m in range(M))
    nll = sum((nll_m.detach() for nll_m, _ in run.heads.values()),
              torch.zeros((), dtype=torch.float32, device=w.device))
    aux_scale = None
    if cfg.n_experts:
        # JAX's pipelined aux: the mean over microbatches of the layers'
        # sum, over n_layers, billed per token of the microbatch
        aux_scale = w * (cfg.router_aux_coef / (M * cfg.n_layers))
        nll = nll + pl.stage_aux(run, w.device).detach() * aux_scale

    def before_last():
        if last:
            params.set_requires_gradient_sync(True)
            params.set_reshard_after_backward(True, recurse=False)
    pl.run_backward(run, mesh, loss=lambda m: run.heads[m][0],
                    aux_scale=aux_scale, before_last=before_last)
    if last:
        # a root this stage never ran backward through (a middle stage)
        # is still gathered: free it
        params.reshard()
    return nll, w


def _sum_over_ranks(nll_sum, w_sum, trainables, mesh, root=()):
    """The step's global sums: the NLL and weight sums all-reduced over
    the batch axes and ``context`` (a ``model`` rank holds its batch
    rank's sums, the same on every peer; a context rank its tokens'),
    and the replicated trainables' (the adapters') gradients summed in
    one flat all-reduce over the world (over ``model`` and ``context``
    each rank's is a partial sum); FSDP2 has summed the sharded ones.
    On a pipelined mesh the NLL (the last stage's, and each stage's aux)
    is first summed over the pipe group, the adapters' gradients over
    the stage's ranks only, and the root's (each stage's part: the
    lookup's on the first, the head's on the last) over the pipe
    group (``root``: the root's trainables)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel.mesh import (
        pipe_group, stage_group, token_groups)
    piped = pipe_group(mesh) is not None
    if piped:
        dist.all_reduce(nll_sum, group=pipe_group(mesh))
    sums = torch.stack([nll_sum, w_sum])
    for group in token_groups(mesh):
        dist.all_reduce(sums, group=group)
    _flat_all_reduce([t.grad for t in trainables
                      if t.grad is not None and not is_sharded(t)],
                     stage_group(mesh))
    if piped:
        for t in root:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        _flat_all_reduce([local(t.grad) for t in root], pipe_group(mesh))
    return sums[0], sums[1]


def _flat_all_reduce(grads, group) -> None:
    """Sum ``grads`` over ``group`` in one flat all-reduce, in place."""
    import torch.distributed as dist
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def make_eval_step(cfg: ModelConfig, *, mesh=None,
                   lora_cfg: Optional[LoraConfig] = None,
                   device: DeviceLike = None):
    """``(state, batch) -> (nll_sum, weight_sum)``: callers sum across
    batches, then divide (the exact eval loss). NLL only: an MoE model's
    router aux is a training term, as in the JAX eval step. On a
    ``mesh`` the sums are this rank's rows' (at a ``context`` above 1 its
    tokens'; ``train/evaluate.py::sharded_eval_sums`` all-reduces
    them); on a pipelined mesh every stage's, through the pipelined
    forward (one microbatch a hop)."""
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
