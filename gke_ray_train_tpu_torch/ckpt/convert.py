"""The multi-rank export and its offline converter to HF safetensors
(counterpart of ``gke_ray_train_tpu/ckpt/convert.py``).

On one card the entry writes the HF layout directly
(``hf_io.py::save_hf_checkpoint``). Across ranks the weights are
sharded, so the entry saves the merged model through the checkpoint
manager instead (:func:`save_export`: every rank writes its shard of
each tensor), rank 0 writes a ``model_config.json`` sidecar
(:func:`write_sidecar`) and the tokenizer beside it, and this tool
turns the export into the HF layout anywhere with the files, one tensor
at a time:

    python -m gke_ray_train_tpu_torch.ckpt.convert <export_dir> <out_dir> \\
        [--step N] [--dtype bfloat16] [--model-config path.json]

The export holds per-layer tensors (``blocks.<i>.<key>``, an expert bank
whole, written in parts by the ranks that hold its experts, a layer of a
pipelined model by the ranks of its stage), each as
``save_hf_checkpoint`` holds it before its cast (a QLoRA projection
dequantized and merged in fp32), and the converter writes
them in ``save_hf_checkpoint``'s order: the converted directory equals a
one-card export of the same weights bitwise.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import sys
from typing import Dict, Iterator, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

SIDECAR = "model_config.json"
TOKENIZER_SUBDIR = "tokenizer"


def write_sidecar(cfg, export_dir: str) -> str:
    """The ModelConfig sidecar the converter reads (rank 0 writes it)."""
    os.makedirs(export_dir, exist_ok=True)
    path = os.path.join(export_dir, SIDECAR)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    return path


@contextlib.contextmanager
def _gathered(module):
    """A sharded FSDP2 unit's own weights whole for the block (all
    ranks enter together); nothing for an unsharded module."""
    from torch.distributed.fsdp import FSDPModule
    if not isinstance(module, FSDPModule):
        yield
        return
    module.unshard()
    try:
        yield
    finally:
        module.reshard()


def _whole(w):
    """A gathered unit's weight whole: one sharded over ``model`` (a
    DTensor, or a ``QTensor`` of DTensors) all-gathered over its model
    group (every rank enters; the codes travel as their own integer
    dtype), anything else as it is."""
    from torch.distributed.tensor import DTensor
    from gke_ray_train_tpu_torch.ops.quant import QTensor, is_qtensor
    from gke_ray_train_tpu_torch.parallel.sharding import as_dtype
    if is_qtensor(w) and isinstance(w.codes, DTensor):
        return QTensor(as_dtype(w.codes, w.code_dtype).full_tensor(),
                       w.scales.full_tensor(), w.kind, w.group, w.store)
    return w.full_tensor() if isinstance(w, DTensor) else w


def export_tensors(params, cfg, *, lora=None, lora_scale: float = 1.0
                   ) -> Iterator[Tuple[str, torch.Tensor, object]]:
    """(key, tensor, experts) of the merged model, one unit gathered at a
    time (over ``model`` too: every rank then holds each tensor whole):
    ``embed``, ``final_norm``, ``lm_head``, then ``blocks.<i>.<key>`` in
    the HF writer's order (an MoE bank dequantized). ``experts`` is None
    for a whole tensor; for a bank sharded over ``model`` (expert
    parallelism) the tensor is this rank's experts only and ``experts``
    the axis (``parallel/tensor.py::TensorParallel``): a bank is never
    gathered over ``model``. A pipeline stage yields its own layers,
    under their global indices."""
    from gke_ray_train_tpu_torch.ckpt.hf_io import (
        _EXPERT_HF, _hf_layer_names, merged_weight)
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    from gke_ray_train_tpu_torch.ops.quant import dequantize, is_qtensor
    from gke_ray_train_tpu_torch.parallel.tensor import local_weight, tp_of
    with _gathered(params):
        yield "embed", _whole(params.embed), None
        yield "final_norm", params.final_norm, None
        if params.lm_head is not None:
            yield "lm_head", _whole(params.lm_head), None
    for pos, (i, blk) in enumerate(zip(layer_ids(params), params.blocks)):
        adapters = lora[pos] if lora is not None else {}
        with _gathered(blk):
            for key in _hf_layer_names(cfg, i):
                yield f"blocks.{i}.{key}", merged_weight(
                    _whole(getattr(blk, key)), adapters.get(key),
                    lora_scale), None
            for key in _EXPERT_HF if cfg.n_experts else ():
                bank = getattr(blk, key)
                experts, bank = tp_of(bank), local_weight(bank)
                yield f"blocks.{i}.{key}", (
                    dequantize(bank, torch.float32) if is_qtensor(bank)
                    else bank), experts


def _expert_mesh(experts):
    """The host mesh a bank sharded over ``model`` is saved on: (model,
    the rest), each row the world ranks of one model rank in rank order
    (every rank enters: the model ranks are gathered)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, experts.rank)
    grid = [[w for w, m in enumerate(ranks) if m == r]
            for r in range(experts.size)]
    return DeviceMesh("cpu", torch.tensor(grid),
                      mesh_dim_names=("model", "rest"))


def _stage_mesh(layers):
    """The host mesh a pipeline stage's layers are saved on: the ranks
    that hold ``layers``, this rank's stage (the row of a stage × the
    rest mesh, the stages ordered by their first layer; every rank
    enters)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    stages = [None] * dist.get_world_size()
    dist.all_gather_object(stages, tuple(layers))
    grid = [[w for w, s in enumerate(stages) if s == stage]
            for stage in sorted(set(stages))]
    mesh = DeviceMesh("cpu", torch.tensor(grid),
                      mesh_dim_names=("stage", "rest"))
    return mesh["rest"]


def _expert_part(t: torch.Tensor, mesh, shape) -> torch.Tensor:
    """This rank's experts ``t`` as its block of the bank of global
    ``shape`` on the (model, rest) host mesh: its own experts (dim 0 over
    model), cut on dim 1 over the rest, in host memory."""
    from torch.distributed.tensor import DTensor, Shard
    n, j = mesh.size(1), mesh.get_local_rank(1)
    part = torch.chunk(t, n, dim=1)[j].to("cpu", copy=True)
    return DTensor.from_local(part, mesh, [Shard(0), Shard(1)],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


@torch.no_grad()
def save_export(params, cfg, export_dir: str, step: int, *, lora=None,
                lora_scale: float = 1.0) -> Dict[str, int]:
    """Save the merged model under ``export_dir`` through the checkpoint
    manager, synchronously (a final export has no goodput to protect).
    Every rank calls it: across ranks each tensor, whole on every rank
    once its unit is gathered over fsdp and model, is cut into the
    world's row blocks (a DTensor sharded on dim 0 over a host mesh), so
    each rank writes its part; an expert bank sharded over ``model`` is
    not gathered over it: each rank writes a part of its own experts (a
    host mesh of model × the rest). On a pipelined mesh a layer's tensors
    exist on its stage's ranks only, and are cut into those ranks' row
    blocks (:func:`_stage_mesh`), so each layer is written by the ranks
    that hold it. In one process the tensors are saved whole.
    What is saved is copied to host memory as each unit is gathered, so
    the card holds one gathered unit at a time. Returns ``{"tensors": n,
    "bytes": local bytes}``."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt.manager import CheckpointManager
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    mesh = emesh = smesh = None
    if world > 1:
        from torch.distributed.device_mesh import init_device_mesh
        # a host mesh over the world's group: the parts stay in host
        # memory (no collective runs on them; the save's own exchange of
        # plans goes through the group's backend)
        mesh = init_device_mesh("cpu", (world,))
        if getattr(params.blocks, "layer_ids", None) is not None:
            smesh = _stage_mesh(params.blocks.layer_ids)
    flat: Dict[str, torch.Tensor] = {}
    nbytes = 0
    for key, t, experts in export_tensors(params, cfg, lora=lora,
                                          lora_scale=lora_scale):
        t = t.detach()
        if experts is not None:
            emesh = emesh or _expert_mesh(experts)
            t = _expert_part(t, emesh, (experts.size * t.shape[0],)
                             + tuple(t.shape[1:]))
            nbytes += t.to_local().numel() * t.to_local().element_size()
        elif mesh is not None:
            from torch.distributed.tensor import DTensor, Shard
            on = (smesh if smesh is not None and key.startswith("blocks.")
                  else mesh)
            part = torch.chunk(t, on.size(), dim=0)[on.get_local_rank()].to(
                "cpu", copy=True)
            t = DTensor.from_local(part, on, [Shard(0)], run_check=False,
                                   shape=t.shape, stride=t.contiguous()
                                   .stride())
            nbytes += part.numel() * part.element_size()
        else:
            t = t.to("cpu", copy=True)
            nbytes += t.numel() * t.element_size()
        flat[key] = t
    mgr = CheckpointManager(export_dir, max_to_keep=1, score_attribute=None,
                            async_commit=False)
    try:
        mgr.save(int(step), {"params": flat}, force=True)
    finally:
        mgr.close()
    return {"tensors": len(flat), "bytes": nbytes}


def _step_dir(export_dir: str, step: Optional[int]) -> str:
    if step is None:
        steps = [int(n) for n in os.listdir(export_dir) if n.isdigit()]
        if not steps:
            raise FileNotFoundError(f"no export step in {export_dir}")
        step = max(steps)
    return os.path.join(export_dir, str(int(step)))


def convert(export_dir: str, out_dir: str, *, step: Optional[int] = None,
            dtype: str = "bfloat16", model_config: Optional[str] = None,
            max_shard_bytes: int = 4 << 30) -> str:
    """Stream an export into HF safetensors in ``out_dir``, one tensor
    read at a time in this process (the saving ranks need not exist),
    then ``config.json`` and the tokenizer saved beside the export.
    Returns ``out_dir``."""
    from torch.distributed.checkpoint import FileSystemReader
    from gke_ray_train_tpu_torch.ckpt.hf_io import (
        ShardedSafetensorsWriter, _EXPERT_HF, _hf_expert_names,
        _hf_layer_names, _maybe_t, hf_tensor, write_hf_config)
    from gke_ray_train_tpu_torch.ckpt.manager import _dcp_call
    from gke_ray_train_tpu_torch.models.config import ModelConfig

    cfg_path = model_config or os.path.join(export_dir, SIDECAR)
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no {SIDECAR} beside {export_dir} and no --model-config "
            "given; the export step writes this sidecar — for older "
            "exports, craft one from ModelConfig.to_dict()")
    with open(cfg_path) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    path = _step_dir(export_dir, step)
    meta = FileSystemReader(path).read_metadata().state_dict_metadata

    def leaf(key: str) -> torch.Tensor:
        m = meta[f"params/{key}"]
        flat = {f"params/{key}": torch.empty(tuple(m.size),
                                             dtype=m.properties.dtype)}
        _dcp_call("load", flat, checkpoint_id=path, collective=False)
        return flat[f"params/{key}"]

    w = ShardedSafetensorsWriter(out_dir, max_shard_bytes=max_shard_bytes)
    try:
        w.add("model.embed_tokens.weight", hf_tensor(leaf("embed"), dtype))
        w.add("model.norm.weight", hf_tensor(leaf("final_norm"), dtype))
        if "params/lm_head" in meta:
            w.add("lm_head.weight", hf_tensor(leaf("lm_head").t(), dtype))
        for i in range(cfg.n_layers):
            for key, tname in _hf_layer_names(cfg, i).items():
                w.add(tname, hf_tensor(_maybe_t(leaf(f"blocks.{i}.{key}"),
                                                key), dtype))
            for key in _EXPERT_HF if cfg.n_experts else ():
                bank = leaf(f"blocks.{i}.{key}")
                for e in range(cfg.n_experts):
                    w.add(_hf_expert_names(i, e)[key],
                          hf_tensor(_maybe_t(bank[e], key), dtype))
                del bank
    except BaseException:
        # a death mid-stream must not leave partial shards behind
        w.abort()
        raise
    w.finish()
    write_hf_config(cfg, out_dir, dtype)
    tok_dir = os.path.join(export_dir, TOKENIZER_SUBDIR)
    if os.path.isdir(tok_dir):
        shutil.copytree(tok_dir, out_dir, dirs_exist_ok=True)
    logger.info("converted %s -> %s", path, out_dir)
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("export_dir")
    p.add_argument("out_dir")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--model-config", default=None)
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    convert(a.export_dir, a.out_dir, step=a.step, dtype=a.dtype,
            model_config=a.model_config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
