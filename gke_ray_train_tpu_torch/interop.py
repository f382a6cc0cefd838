"""Carry a JAX package param tree (as numpy) into the port's modules.

The JAX tree, after ``jax.tree.map(np.asarray, params)``, is
``{"embed": [V, D], "blocks": [{name: [R, ...]} per pattern position],
"final_norm": [D], "lm_head": [D, V]}`` with leaves stacked over the
``R = n_layers / len(block_pattern)`` repeats. Layer ``i`` of the port is
repeat ``i // P`` at pattern position ``i % P``. Both packages keep the
``[d_in, d_out]`` orientation, so leaves copy over with no transposes.

An MoE tree adds the router ``[R, D, E]`` and expert banks ``[R, E, D,
F]`` (``[R, E, F, D]`` for ``w_down``), carried over the same way.

A quantized (QLoRA) tree has ``QTensor`` leaves at the projections and
banks, which ``jax.tree.map(np.asarray, ...)`` keeps as QTensors holding
numpy ``codes [R, ..., D, F]`` and ``scales [R, ..., D / group, F]``;
``qparams_from_numpy`` carries them over bitwise. NF4 codes stored as
int8 stay int8; codes stored as uint4 (JAX ``QUANT_STORE=uint4``: numpy
sees an ``ml_dtypes`` uint4 array) become the port's uint4 store, two
codes a byte (``ops/quant.py::pack_uint4``).

``stage=(pipe_rank, pipe, virtual)`` carries only a pipeline stage's
repeats of the stacked tree (``models/pipeline.py::stage_layers``): the
model holds that stage's blocks under their global indices, and the
adapter list that stage's layers, in order.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, StageLora, Transformer, layer_ids, torch_dtype)
from gke_ray_train_tpu_torch.ops.quant import QTensor, pack_uint4


def _tensor(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # via float32: numpy has no native bfloat16, and bf16 -> f32 -> bf16
    # is exact
    arr = np.ascontiguousarray(np.asarray(a).astype(np.float32))
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _is_quantized(leaf: Any) -> bool:
    # the JAX QTensor, duck-typed: the port never imports its class
    return all(hasattr(leaf, a) for a in ("codes", "scales", "kind", "group"))


def _qtensor(leaf: Any, r: int, device: torch.device) -> QTensor:
    """Repeat ``r`` of a JAX QTensor leaf as the port's ``QTensor``."""
    codes = np.asarray(leaf.codes)[r]
    scales = torch.from_numpy(np.array(np.asarray(leaf.scales)[r],
                                       np.float32)).to(device)
    if codes.dtype.name == "uint4":
        return QTensor(pack_uint4(torch.from_numpy(
            codes.astype(np.uint8))).to(device), scales, leaf.kind,
            leaf.group, store="uint4")
    return QTensor(torch.from_numpy(np.array(codes, np.int8)).to(device),
                   scales, leaf.kind, leaf.group)


Stage = Tuple[int, int, int]      # (pipe_rank, pipe, virtual)


def _layers(cfg: ModelConfig, stage: Optional[Stage]):
    """The global layers a stage holds; None (every layer) without one."""
    if stage is None:
        return None
    from gke_ray_train_tpu_torch.models.pipeline import stage_layers
    rank, pipe, virtual = stage
    return stage_layers(cfg, pipe, virtual, rank)


@torch.no_grad()
def params_from_numpy(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                      device: DeviceLike,
                      dtype: Optional[torch.dtype] = None,
                      stage: Optional[Stage] = None) -> Transformer:
    """A ``Transformer`` on ``device`` holding the JAX tree's values, in
    ``dtype`` (default ``cfg.param_dtype``); quantized leaves become
    ``QTensor``s with the same codes and scales; with ``stage`` only that
    pipeline stage's blocks. Raises when the tree's leaves do not match
    the model's parameters one for one."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.param_dtype)
    blocks = np_params["blocks"]
    if len(blocks) != len(cfg.block_pattern):
        raise ValueError(f"param tree has {len(blocks)} pattern positions, "
                         f"config {len(cfg.block_pattern)}")
    quantized = {name for name, leaf in blocks[0].items()
                 if _is_quantized(leaf)}
    model = Transformer(cfg, device=dev, dtype=dt, quantized=quantized,
                        layers=_layers(cfg, stage))
    held = dict(zip(layer_ids(model), model.blocks))
    for p, tree_block in enumerate(blocks):
        blk = next(b for i, b in held.items() if i % len(blocks) == p)
        ours = {n for n, v in blk.named_parameters()} | quantized
        if set(tree_block) != ours:
            raise ValueError(f"pattern position {p}: tree leaves "
                             f"{sorted(tree_block)} != model parameters "
                             f"{sorted(ours)}")
    P = len(cfg.block_pattern)
    for i, blk in held.items():
        for name, param in blk.named_parameters():
            leaf = np.asarray(blocks[i % P][name])[i // P]
            param.copy_(_tensor(leaf, dev, dt))
        for name in quantized:
            setattr(blk, name, _qtensor(blocks[i % P][name], i // P, dev))
    model.embed.copy_(_tensor(np_params["embed"], dev, dt))
    model.final_norm.copy_(_tensor(np_params["final_norm"], dev, dt))
    if model.lm_head is not None:
        model.lm_head.copy_(_tensor(np_params["lm_head"], dev, dt))
    elif "lm_head" in np_params:
        raise ValueError("tied-embedding config but the tree has lm_head")
    return model


def qparams_from_numpy(np_params: Mapping[str, Any], cfg: ModelConfig, *,
                       device: DeviceLike,
                       dtype: Optional[torch.dtype] = None,
                       stage: Optional[Stage] = None) -> Transformer:
    """``params_from_numpy`` for a quantized (QLoRA) tree: raises unless
    the tree has ``QTensor`` leaves."""
    if not any(_is_quantized(leaf) for blk in np_params["blocks"]
               for leaf in blk.values()):
        raise ValueError("the tree has no quantized leaves; use "
                         "params_from_numpy")
    return params_from_numpy(np_params, cfg, device=device, dtype=dtype,
                             stage=stage)


def lora_from_numpy(np_lora: Mapping[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike,
                    dtype: torch.dtype = torch.float32,
                    requires_grad: bool = False,
                    stage: Optional[Stage] = None) -> Lora:
    """The per-layer adapter list ``[{name: {"a": [d_in, r], "b": [r,
    d_out]}}]`` from a JAX LoRA tree ``{"blocks": [{name: {"a": [R, d_in,
    r], "b": [R, r, d_out]}}]}``. Adapters stay float32 by default, as
    the JAX package keeps them; the forward casts them at use. With
    ``stage`` the list holds that pipeline stage's layers only."""
    dev = resolve_device(device)
    blocks = np_lora["blocks"]
    P = len(cfg.block_pattern)
    ids = _layers(cfg, stage)
    out = [{name: {ab: _tensor(np.asarray(leaf[ab])[i // P], dev, dtype)
                   for ab in ("a", "b")}
            for name, leaf in blocks[i % P].items()}
           for i in (ids or range(cfg.n_layers))]
    return out if ids is None else StageLora(out, ids)
