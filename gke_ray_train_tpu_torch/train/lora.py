"""LoRA adapters (counterpart of ``gke_ray_train_tpu/train/lora.py``).

An adapter set is one dict per layer, ``{target: {"a": [d_in, r], "b":
[r, d_out]}}`` of fp32 leaf tensors that require a gradient: the
trainables of a (Q)LoRA fine-tune, handed to the optimizer, while the
base model stays frozen. The forward adds ``(alpha / r) * (x A) B`` to
each targeted projection (``models/transformer.py::_proj``); merging folds
``W + (alpha / r) A B`` into the base.

On a mesh the adapters are replicated: every rank holds the whole A and
B (rank 0's, broadcast; JAX shards them by ``lora_specs``). Under tensor
parallelism on ``model`` (``parallel/tensor.py``) a rank applies the part
that meets its weight shard: on a column-parallel projection (wq, wk,
wv, w_gate, w_up; output columns ``c_r``) ``y_r = s (x A) B[:, c_r]``, on
a row-parallel one (wo, w_down; input rows ``i_r``) the partial ``s (x_r
A[i_r]) B``, all-reduced with the base product. Each rank's adapter
gradient is then a partial sum of the whole, and summing over the model
ranks gives it exactly:

- column-parallel: ``dB`` is nonzero only in rank r's columns ``c_r``,
  where it is the whole ``s (x A)^T dy_r``; ``dA = s x^T (dy B^T)`` is
  ``Σ_r s x^T (dy_r B[:, c_r]^T)``, one term a rank (x, and its dropout
  mask, are the same on every model rank);
- row-parallel: ``dA`` is nonzero only in rank r's rows ``i_r``, where
  it is the whole ``s x_r^T (dy B^T)`` (dy is the same on every model
  rank); ``dB = s (x A)^T dy`` is ``Σ_r s (x_r A[i_r])^T dy``.

So the train step's one flat all-reduce of the adapter gradients over the
world (the batch ranks and the model ranks) gives every rank the global
gradient (``train/step.py``). On a pipelined mesh a rank's adapters are
those of its stage's layers only (``init_lora(layers=)``), and the
all-reduce runs over the ranks of its stage
(``parallel/mesh.py::stage_group``).
"""

from __future__ import annotations

import dataclasses
from typing import Collection, Optional, Tuple

import torch
from torch import nn

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig, PROJ_TARGETS
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, StageLora, Transformer, proj_shapes)
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
              device: DeviceLike = None,
              layers: Optional[Collection[int]] = None) -> Lora:
    """A ~ N(0, 1/r), B = 0 — the adapters start as the identity — on
    ``device`` (default ``cuda``), drawn from a ``torch.Generator``
    seeded with ``seed``. Always fp32: they are the only trained
    parameters, and bf16 masters would drop updates below ~value/256.
    ``layers``: keep only these global layers' adapters (a pipeline
    stage's, a ``StageLora``); every layer is drawn in order all the
    same, so they are one process's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = proj_shapes(cfg)       # the JAX package's _target_shapes
    targets = _effective_targets(cfg, lora_cfg)
    out = []
    keep = set(range(cfg.n_layers) if layers is None else layers)
    for i in range(cfg.n_layers):
        layer = {}
        for t in targets:
            d_in, d_out = shapes[t]
            a = torch.randn((d_in, lora_cfg.r), generator=gen, device=dev,
                            dtype=torch.float32) / lora_cfg.r ** 0.5
            b = torch.zeros((lora_cfg.r, d_out), device=dev,
                            dtype=torch.float32)
            layer[t] = {"a": a.requires_grad_(True),
                        "b": b.requires_grad_(True)}
        if i in keep:
            out.append(layer)
    return out if layers is None else StageLora(out, sorted(keep))


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
