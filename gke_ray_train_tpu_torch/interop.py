"""Carry a JAX package param tree (as numpy) into the port's modules.

The JAX tree, after ``jax.tree.map(np.asarray, params)``, is
``{"embed": [V, D], "blocks": [{name: [R, ...]} per pattern position],
"final_norm": [D], "lm_head": [D, V]}`` with leaves stacked over the
``R = n_layers / len(block_pattern)`` repeats. Layer ``i`` of the port is
repeat ``i // P`` at pattern position ``i % P``. Both packages keep the
``[d_in, d_out]`` orientation, so leaves copy over with no transposes.

A quantized (QLoRA) tree has ``QTensor`` leaves at the projections,
which ``jax.tree.map(np.asarray, ...)`` keeps as QTensors holding numpy
``codes [R, D, F]`` and ``scales [R, D / group, F]``;
``qparams_from_numpy`` carries them over bitwise.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, Transformer, torch_dtype)
from gke_ray_train_tpu_torch.ops.quant import QTensor


def _tensor(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # via float32: numpy has no native bfloat16, and bf16 -> f32 -> bf16
    # is exact
    arr = np.ascontiguousarray(np.asarray(a).astype(np.float32))
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _is_quantized(leaf: Any) -> bool:
    # the JAX QTensor, duck-typed: the port never imports its class
    return all(hasattr(leaf, a) for a in ("codes", "scales", "kind", "group"))


@torch.no_grad()
def params_from_numpy(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                      device: DeviceLike,
                      dtype: Optional[torch.dtype] = None) -> Transformer:
    """A ``Transformer`` on ``device`` holding the JAX tree's values, in
    ``dtype`` (default ``cfg.param_dtype``); quantized leaves become
    ``QTensor``s with the same codes and scales. Raises when the tree's
    leaves do not match the model's parameters one for one."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.param_dtype)
    blocks = np_params["blocks"]
    if len(blocks) != len(cfg.block_pattern):
        raise ValueError(f"param tree has {len(blocks)} pattern positions, "
                         f"config {len(cfg.block_pattern)}")
    quantized = {name for name, leaf in blocks[0].items()
                 if _is_quantized(leaf)}
    model = Transformer(cfg, device=dev, dtype=dt, quantized=quantized)
    for p, tree_block in enumerate(blocks):
        ours = {n for n, v in model.blocks[p].named_parameters()} | quantized
        if set(tree_block) != ours:
            raise ValueError(f"pattern position {p}: tree leaves "
                             f"{sorted(tree_block)} != model parameters "
                             f"{sorted(ours)}")
    P = len(cfg.block_pattern)
    for i, blk in enumerate(model.blocks):
        for name, param in blk.named_parameters():
            leaf = np.asarray(blocks[i % P][name])[i // P]
            param.copy_(_tensor(leaf, dev, dt))
        for name in quantized:
            leaf = blocks[i % P][name]
            setattr(blk, name, QTensor(
                torch.from_numpy(np.array(np.asarray(leaf.codes)[i // P],
                                          np.int8)).to(dev),
                torch.from_numpy(np.array(np.asarray(leaf.scales)[i // P],
                                          np.float32)).to(dev),
                leaf.kind, leaf.group))
    model.embed.copy_(_tensor(np_params["embed"], dev, dt))
    model.final_norm.copy_(_tensor(np_params["final_norm"], dev, dt))
    if model.lm_head is not None:
        model.lm_head.copy_(_tensor(np_params["lm_head"], dev, dt))
    elif "lm_head" in np_params:
        raise ValueError("tied-embedding config but the tree has lm_head")
    return model


def qparams_from_numpy(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                       device: DeviceLike,
                       dtype: Optional[torch.dtype] = None) -> Transformer:
    """``params_from_numpy`` for a quantized (QLoRA) tree: raises unless
    the tree has ``QTensor`` leaves."""
    if not any(_is_quantized(leaf) for blk in np_params["blocks"]
               for leaf in blk.values()):
        raise ValueError("the tree has no quantized leaves; use "
                         "params_from_numpy")
    return params_from_numpy(np_params, cfg, device=device, dtype=dtype)


def lora_from_numpy(np_lora: Mapping[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike,
                    dtype: torch.dtype = torch.float32,
                    requires_grad: bool = False) -> Lora:
    """The per-layer adapter list ``[{name: {"a": [d_in, r], "b": [r,
    d_out]}}]`` from a JAX LoRA tree ``{"blocks": [{name: {"a": [R, d_in,
    r], "b": [R, r, d_out]}}]}``. Adapters stay float32 by default, as
    the JAX package keeps them; the forward casts them at use."""
    dev = resolve_device(device)
    blocks = np_lora["blocks"]
    P = len(cfg.block_pattern)
    return [{name: {ab: _tensor(np.asarray(leaf[ab])[i // P], dev, dtype)
                    for ab in ("a", "b")}
             for name, leaf in blocks[i % P].items()}
            for i in range(cfg.n_layers)]
