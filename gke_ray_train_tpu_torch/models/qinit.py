"""Quantize-during-init for QLoRA base weights (counterpart of
``gke_ray_train_tpu/models/qinit.py``).

A random Llama-3.1-8B at full width has 6.98 G projection weights: 14 GB
in bf16, 28 GB in fp32, while its NF4 codes take 7 GB as int8. This init
builds each projection in bf16, quantizes it and frees it before the
next one, one layer at a time, so the full-precision tree never sits
whole on the card. An MoE expert bank (Mixtral-8x7B: 45.1 G values, 90
GB in bf16) is drawn and quantized one expert slice at a time, so not
even one bank exists in full precision; JAX's MoE path, which builds the
whole tree and then quantizes, would not fit one card. Norms, router,
embedding and head stay in ``cfg.param_dtype``.

On a mesh every rank makes the same draws (the meshed and plain inits
give the same weights, JAX ``qinit.py``'s sharding-invariant contract)
and shards each block over ``fsdp`` as soon as its projections are
quantized (``parallel/sharding.py::shard_unit``), so a rank keeps its
shard of each block, and of the full-precision weights only the one
projection being quantized. Where ``model`` exceeds 1 an expert bank is
sharded on its expert dim (expert parallelism): a rank still draws every
expert in order, so the generator's stream and each expert's draw are
those of one process, but rounds and quantizes only its own ``E /
model`` experts, whose codes and scales become its shard of the bank
(``parallel/sharding.py::place_local_experts``): bitwise one process's
slices. On a pipelined mesh a rank makes only its stage's blocks
(``models/pipeline.py::stage_layers``) and draws the other stages'
layers without keeping them, so a stage's blocks are one process's,
bitwise, and a 70B stage never holds another stage's layers.
"""

from __future__ import annotations

from typing import Collection

import torch
from torch import nn

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Transformer, init_std, proj_shapes, torch_dtype)
from gke_ray_train_tpu_torch.ops.quant import (
    DEFAULT_GROUP, QUANT_TARGETS, quantize_stacked, quantize_tensor)
from gke_ray_train_tpu_torch.parallel.mesh import AXIS_MODEL
from gke_ray_train_tpu_torch.parallel.sharding import (
    place_local_experts, shard_unit)


@torch.no_grad()
def init_quantized_params(cfg: ModelConfig, seed: int = 0, *,
                          kind: str = "nf4", group: int = DEFAULT_GROUP,
                          targets: Collection[str] = QUANT_TARGETS,
                          device: DeviceLike = None,
                          mesh=None) -> Transformer:
    """``init_params`` with the targeted projections quantized as they
    are created, on ``device`` (default ``cuda``).

    The same init distribution as the JAX package: truncated normal
    (±3 std) at std 0.02, the residual writers (wo, w_down) scaled by
    1/sqrt(2 * n_layers); a projection is rounded to bf16 before it is
    quantized, as JAX does (:39-41). An expert bank is drawn, rounded and
    quantized one expert ``[d_in, d_out]`` at a time. The draws come from
    a ``torch.Generator`` seeded with ``seed`` and are not JAX's: tests
    carry quantized JAX trees over with ``interop.qparams_from_numpy``.

    ``mesh``: each block is sharded over its fsdp axis once made (the
    root is left for ``make_train_state(mesh=)`` to shard)."""
    from gke_ray_train_tpu_torch.models.pipeline import mesh_stage
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    targets = tuple(targets)
    model = Transformer(cfg, device=dev, dtype=pdt, quantized=targets,
                        layers=mesh_stage(cfg, mesh))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, std: float) -> torch.Tensor:
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return w.mul_(std)

    def norm_(p) -> None:
        if p is not None:
            p.fill_(0.0 if cfg.norm_scale_plus_one else 1.0)

    # this rank's experts [first, first + n_local) of each bank under EP
    n_local, first = cfg.n_experts, 0
    if mesh is not None and mesh[AXIS_MODEL].size() > 1 and cfg.n_experts:
        n_local = cfg.n_experts // mesh[AXIS_MODEL].size()
        first = mesh[AXIS_MODEL].get_local_rank() * n_local

    def expert_slices(shape, std: float):
        for e in range(shape[0]):
            w = draw(shape[1:], std)
            if first <= e < first + n_local:
                yield w.to(torch.bfloat16)

    model.embed.copy_(draw(model.embed.shape, 0.02))
    held = dict(zip(layer_ids(model), model.blocks))
    for i in range(cfg.n_layers):
        blk = held.get(i)
        if blk is None:
            # another stage's layer: the same draws, none kept
            for name, shape in proj_shapes(cfg).items():
                if name in targets and len(shape) == 3:
                    for _ in range(shape[0]):
                        draw(shape[1:], 0.0)
                else:
                    draw(shape, 0.0)
            continue
        for p in (blk.attn_norm, blk.mlp_norm, blk.attn_post_norm,
                  blk.mlp_post_norm):
            norm_(p)
        for b in (blk.bq, blk.bk, blk.bv):
            if b is not None:
                b.zero_()
        for name, shape in proj_shapes(cfg).items():
            std = init_std(cfg, name)
            if name not in targets:
                getattr(blk, name).copy_(draw(shape, std))
            elif len(shape) == 3:
                setattr(blk, name, quantize_stacked(
                    expert_slices(shape, std), kind, group))
                if n_local < cfg.n_experts:
                    place_local_experts(getattr(blk, name), mesh, shape[0])
            else:
                setattr(blk, name, quantize_tensor(
                    draw(shape, std).to(torch.bfloat16), kind, group))
        if mesh is not None:
            shard_unit(blk, cfg, mesh)
    norm_(model.final_norm)
    if model.lm_head is not None:
        model.lm_head.copy_(draw(model.lm_head.shape, 0.02))
    return model
