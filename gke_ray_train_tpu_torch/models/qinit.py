"""Quantize-during-init for QLoRA base weights (counterpart of
``gke_ray_train_tpu/models/qinit.py``).

A random Llama-3.1-8B at full width has 6.98 G projection weights: 14 GB
in bf16, 28 GB in fp32, while its NF4 codes take 7 GB as int8. This init
builds each projection in bf16, quantizes it and frees it before the
next one, one layer at a time, so the full-precision tree never sits
whole on the card. Norms, embedding and head stay in ``cfg.param_dtype``.
"""

from __future__ import annotations

import math
from typing import Collection

import torch
from torch import nn

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Transformer, proj_shapes, torch_dtype)
from gke_ray_train_tpu_torch.ops.quant import (
    DEFAULT_GROUP, QUANT_TARGETS, quantize_tensor)


@torch.no_grad()
def init_quantized_params(cfg: ModelConfig, seed: int = 0, *,
                          kind: str = "nf4", group: int = DEFAULT_GROUP,
                          targets: Collection[str] = QUANT_TARGETS,
                          device: DeviceLike = None) -> Transformer:
    """``init_params`` with the targeted projections quantized as they
    are created, on ``device`` (default ``cuda``).

    The same init distribution as the JAX package: truncated normal
    (±3 std) at std 0.02, the residual writers (wo, w_down) scaled by
    1/sqrt(2 * n_layers); a projection is rounded to bf16 before it is
    quantized, as JAX does (:39-41). The draws come from a
    ``torch.Generator`` seeded with ``seed`` and are not JAX's: tests
    carry quantized JAX trees over with ``interop.qparams_from_numpy``."""
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE models (n_experts > 0) are not ported yet")
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    targets = tuple(targets)
    model = Transformer(cfg, device=dev, dtype=pdt, quantized=targets)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    stds = {name: 0.02 * (depth_scale if name in ("wo", "w_down") else 1.0)
            for name in proj_shapes(cfg)}

    def draw(shape, std: float) -> torch.Tensor:
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return w.mul_(std)

    def norm_(p) -> None:
        if p is not None:
            p.fill_(0.0 if cfg.norm_scale_plus_one else 1.0)

    model.embed.copy_(draw(model.embed.shape, 0.02))
    for blk in model.blocks:
        for p in (blk.attn_norm, blk.mlp_norm, blk.attn_post_norm,
                  blk.mlp_post_norm):
            norm_(p)
        for b in (blk.bq, blk.bk, blk.bv):
            if b is not None:
                b.zero_()
        for name, shape in proj_shapes(cfg).items():
            w = draw(shape, stds[name])
            if name in targets:
                setattr(blk, name, quantize_tensor(
                    w.to(torch.bfloat16), kind, group))
            else:
                getattr(blk, name).copy_(w)
            del w
    norm_(model.final_norm)
    if model.lm_head is not None:
        model.lm_head.copy_(draw(model.lm_head.shape, 0.02))
    return model
