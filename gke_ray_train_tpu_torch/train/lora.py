"""LoRA adapters (counterpart of ``gke_ray_train_tpu/train/lora.py``).

An adapter set is one dict per layer, ``{target: {"a": [d_in, r], "b":
[r, d_out]}}`` of fp32 leaf tensors that require a gradient: the
trainables of a (Q)LoRA fine-tune, handed to the optimizer, while the
base model stays frozen. The forward adds ``(alpha / r) * (x A) B`` to
each targeted projection (``models/transformer.py::_proj``); merging folds
``W + (alpha / r) A B`` into the base.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig, PROJ_TARGETS
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, Transformer, proj_shapes)
from gke_ray_train_tpu_torch.ops.quant import dequantize, is_qtensor

# every projection matrix, as the reference's LORA_TARGET_MODULES
ALL_TARGETS = PROJ_TARGETS
ATTN_TARGETS = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: int = 16
    targets: Tuple[str, ...] = ALL_TARGETS
    # dropout on the adapter-branch input (reference LORA_DROPOUT); the
    # train step applies it with masks seeded per (step, microbatch)
    dropout: float = 0.0

    @property
    def scale(self) -> float:
        return self.alpha / self.r

    @staticmethod
    def from_dict(cfg: dict) -> "LoraConfig":
        """From the reference's flat config keys (LORA_R, LORA_ALPHA,
        LORA_DROPOUT)."""
        return LoraConfig(
            r=int(cfg.get("LORA_R", 64)),
            alpha=int(cfg.get("LORA_ALPHA", 16)),
            dropout=float(cfg.get("LORA_DROPOUT", 0.0)),
        )


def _effective_targets(cfg: ModelConfig, lora_cfg: LoraConfig):
    """MoE models adapt attention only (no single delta-W spans the
    routed expert bank)."""
    if cfg.n_experts > 0:
        return tuple(t for t in lora_cfg.targets if t in ATTN_TARGETS)
    return lora_cfg.targets


def init_lora(cfg: ModelConfig, lora_cfg: LoraConfig, seed: int = 1, *,
              device: DeviceLike = None) -> Lora:
    """A ~ N(0, 1/r), B = 0 — the adapters start as the identity — on
    ``device`` (default ``cuda``), drawn from a ``torch.Generator``
    seeded with ``seed``. Always fp32: they are the only trained
    parameters, and bf16 masters would drop updates below ~value/256."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = proj_shapes(cfg)       # the JAX package's _target_shapes
    targets = _effective_targets(cfg, lora_cfg)
    out = []
    for _ in range(cfg.n_layers):
        layer = {}
        for t in targets:
            d_in, d_out = shapes[t]
            a = torch.randn((d_in, lora_cfg.r), generator=gen, device=dev,
                            dtype=torch.float32) / lora_cfg.r ** 0.5
            b = torch.zeros((lora_cfg.r, d_out), device=dev,
                            dtype=torch.float32)
            layer[t] = {"a": a.requires_grad_(True),
                        "b": b.requires_grad_(True)}
        out.append(layer)
    return out


@torch.no_grad()
def merge_lora(params: Transformer, lora: Lora,
               lora_cfg: LoraConfig) -> Transformer:
    """``W + (alpha / r) A B`` for every adapted matrix, in place (the
    counterpart of peft's ``merge_and_unload``). The delta is formed in
    fp32; a QLoRA base dequantizes to fp32 first and comes back as an
    fp32 parameter, as do quantized weights without an adapter, so the
    merged model holds plain tensors only. Returns ``params``."""
    for blk, adapters in zip(params.blocks, lora):
        for name, w in list(blk.named_children()) + list(
                blk.named_parameters(recurse=False)):
            if name not in adapters and not is_qtensor(w):
                continue
            base = dequantize(w, torch.float32) if is_qtensor(w) \
                else w.float()
            if name in adapters:
                ab = adapters[name]
                base = base + (ab["a"].float() @ ab["b"].float()) \
                    * lora_cfg.scale
            if is_qtensor(w):
                delattr(blk, name)
                blk.register_parameter(
                    name, nn.Parameter(base, requires_grad=False))
            else:
                w.copy_(base.to(w.dtype))
    return params
