"""HF-format weight interop (counterpart of
``gke_ray_train_tpu/ckpt/hf_io.py``): load a HF safetensors model into a
``Transformer``, export one, and write the ``config.json`` stock
``transformers`` loads.

- The files are read and written by the ``safetensors`` package
  (``safe_open`` and ``safetensors.torch.save_file``), one tensor at a
  time, in JAX's layout: shards of at most ``max_shard_bytes`` with a
  ``model.safetensors.index.json``, or one ``model.safetensors``.
- torch's ``nn.Linear`` stores a projection as ``[out, in]``; the port
  keeps ``[d_in, d_out]`` like the JAX package (``interop.py``), so the
  projections are transposed both ways. Embedding, norm scales and
  biases copy as they are. HF's Gemma-2 RMSNorm stores ``w`` of a
  ``(1 + w)`` norm, as ``norm_scale_plus_one`` does. A tied head has no
  ``lm_head.weight``; Qwen-2 adds the q/k/v biases.
- Mixtral's layout (``n_experts > 0``): the router is
  ``block_sparse_moe.gate`` and the expert banks are per (layer, expert)
  tensors ``block_sparse_moe.experts.{e}.w1 / w3 / w2`` (gate / up /
  down), each ``[out, in]``; the port's banks are ``[E, d_in, d_out]``.
- ``quantize="nf4" | "int8"`` quantizes each projection on the device as
  it streams in, an expert bank one (layer, expert) slice at a time, so
  the full-precision tree of a QLoRA base never exists on the card or in
  host memory.
- ``save_hf_checkpoint(..., lora=...)`` merges ``W + (alpha / r) A B``
  one projection at a time on the device, in fp32 as
  ``train/lora.py::merge_lora`` forms it, and streams the result in the
  export dtype to the writer: the trained state is left as it was. Expert
  banks stream expert by expert, with no merge (MoE adapters are
  attention-only).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, Transformer, layer_ids, torch_dtype)
from gke_ray_train_tpu_torch.ops.quant import (
    DEFAULT_GROUP, QUANT_KINDS, QUANT_TARGETS, dequantize, is_qtensor,
    quantize_stacked, quantize_tensor)


INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"


class ShardedReader:
    """Every tensor of a model directory: ``model.safetensors``, or the
    shards ``model.safetensors.index.json`` names (JAX ``_open_shards``).
    Files open at first use; ``get_tensor`` reads one CPU tensor."""

    def __init__(self, model_dir: str):
        index = os.path.join(model_dir, INDEX_FILE)
        single = os.path.join(model_dir, SINGLE_FILE)
        self._handles: Dict[str, object] = {}
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            self._where = {t: os.path.join(model_dir, fname)
                           for t, fname in weight_map.items()}
        elif os.path.exists(single):
            self._where = {t: single for t in self._open(single).keys()}
        else:
            raise FileNotFoundError(
                f"no {SINGLE_FILE} or {INDEX_FILE} in {model_dir}")

    def _open(self, path: str):
        if path not in self._handles:
            from safetensors import safe_open
            self._handles[path] = safe_open(path, framework="pt")
        return self._handles[path]

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def keys(self) -> List[str]:
        return list(self._where)

    def get_tensor(self, name: str) -> torch.Tensor:
        return self._open(self._where[name]).get_tensor(name)

    def close(self) -> None:
        self._handles.clear()


class ShardedSafetensorsWriter:
    """Incremental HF-layout writer with bounded host memory (JAX
    ``ShardedSafetensorsWriter``).

    Tensors collect on the host into a shard until ``max_shard_bytes``,
    which is then written as ``model-tmp-XXXXX.safetensors``;
    ``finish()`` renames the shards ``model-XXXXX-of-YYYYY.safetensors``
    and writes ``model.safetensors.index.json``. A model that fits one
    shard becomes a plain ``model.safetensors`` with no index.
    ``abort()`` removes the tmp shards of a failed export. Peak host
    memory: one shard plus one tensor."""

    def __init__(self, out_dir: str, *, max_shard_bytes: int = 4 << 30):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.max_shard_bytes = max_shard_bytes
        self._cur: Dict[str, torch.Tensor] = {}
        self._cur_bytes = 0
        self._shards: List[str] = []
        self._weight_maps: List[List[str]] = []
        self.bytes_written = 0

    def add(self, name: str, t: torch.Tensor) -> None:
        t = t.detach().to("cpu").contiguous()
        n = t.numel() * t.element_size()
        if self._cur and self._cur_bytes + n > self.max_shard_bytes:
            self._flush()
        self._cur[name] = t
        self._cur_bytes += n

    def _flush(self) -> None:
        from safetensors.torch import save_file
        path = os.path.join(self.out_dir,
                            f"model-tmp-{len(self._shards):05d}.safetensors")
        save_file(self._cur, path)
        self._shards.append(path)
        self._weight_maps.append(list(self._cur))
        self.bytes_written += os.path.getsize(path)
        self._cur = {}
        self._cur_bytes = 0

    def abort(self) -> None:
        for tmp in self._shards:
            try:
                os.remove(tmp)
            except OSError:
                pass
        self._shards, self._weight_maps = [], []
        self._cur, self._cur_bytes = {}, 0

    def finish(self) -> List[str]:
        """Rename the shards into place; returns their file names."""
        if self._cur or not self._shards:
            self._flush()
        n = len(self._shards)
        if n == 1:
            os.replace(self._shards[0],
                       os.path.join(self.out_dir, SINGLE_FILE))
            return [SINGLE_FILE]
        weight_map, names = {}, []
        for i, (tmp, tnames) in enumerate(zip(self._shards,
                                              self._weight_maps)):
            fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
            os.replace(tmp, os.path.join(self.out_dir, fname))
            names.append(fname)
            for t in tnames:
                weight_map[t] = fname
        with open(os.path.join(self.out_dir, INDEX_FILE), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        return names


def _hf_layer_names(cfg: ModelConfig, i: int) -> Dict[str, str]:
    """our key -> HF tensor name for decoder layer ``i``'s per-layer
    tensors (an MoE model's banks: ``_hf_expert_names``)."""
    base = f"model.layers.{i}"
    names = {
        "wq": f"{base}.self_attn.q_proj.weight",
        "wk": f"{base}.self_attn.k_proj.weight",
        "wv": f"{base}.self_attn.v_proj.weight",
        "wo": f"{base}.self_attn.o_proj.weight",
        "attn_norm": f"{base}.input_layernorm.weight",
    }
    if cfg.attn_qkv_bias:  # Qwen-2 layout
        names["bq"] = f"{base}.self_attn.q_proj.bias"
        names["bk"] = f"{base}.self_attn.k_proj.bias"
        names["bv"] = f"{base}.self_attn.v_proj.bias"
    if cfg.n_experts:  # Mixtral layout
        names["router"] = f"{base}.block_sparse_moe.gate.weight"
    else:
        names["w_gate"] = f"{base}.mlp.gate_proj.weight"
        names["w_up"] = f"{base}.mlp.up_proj.weight"
        names["w_down"] = f"{base}.mlp.down_proj.weight"
    if cfg.post_block_norm:  # Gemma-2 has four norms per block
        names["attn_post_norm"] = f"{base}.post_attention_layernorm.weight"
        names["mlp_norm"] = f"{base}.pre_feedforward_layernorm.weight"
        names["mlp_post_norm"] = f"{base}.post_feedforward_layernorm.weight"
    else:
        names["mlp_norm"] = f"{base}.post_attention_layernorm.weight"
    return names


# Mixtral's expert naming: w1 = gate, w3 = up, w2 = down
_EXPERT_HF = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


def _hf_expert_names(i: int, e: int) -> Dict[str, str]:
    """bank key -> HF tensor name of expert ``e`` in layer ``i``."""
    base = f"model.layers.{i}.block_sparse_moe.experts.{e}"
    return {k: f"{base}.{v}.weight" for k, v in _EXPERT_HF.items()}


# HF stores every projection (and the Mixtral router) as [out, in]; the
# port keeps [in, out]
_TRANSPOSED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "router"}


def _maybe_t(t: torch.Tensor, key: str) -> torch.Tensor:
    return t.t() if key in _TRANSPOSED else t


@torch.no_grad()
def load_hf_checkpoint(model_dir: str, cfg: ModelConfig, *,
                       quantize: Optional[str] = None,
                       device: DeviceLike = None,
                       dtype: Optional[torch.dtype] = None,
                       layers=None) -> Transformer:
    """A ``Transformer`` on ``device`` (default ``cuda``) holding the HF
    model in ``model_dir``, in ``dtype`` (default ``cfg.param_dtype``).

    ``quantize``: "nf4" | "int8" — each projection is cast to bf16 and
    quantized on the device as it is read (the JAX package's
    ``load_quantized``: the same codes and scales), an expert bank one
    (layer, expert) slice at a time; norms, router, embedding and head
    stay in ``dtype``. ``layers``: read only these global layers (a
    pipeline stage's, ``models/pipeline.py::stage_layers``)."""
    if quantize is not None and quantize not in QUANT_KINDS:
        raise ValueError(f"quantize={quantize!r} not in {QUANT_KINDS}")
    dev = resolve_device(device)
    pdt = dtype or torch_dtype(cfg.param_dtype)
    targets = QUANT_TARGETS if quantize else ()
    reader = ShardedReader(model_dir)
    try:
        model = Transformer(cfg, device=dev, dtype=pdt, quantized=targets,
                            layers=layers)
        for i, blk in zip(layer_ids(model), model.blocks):
            for key, tname in _hf_layer_names(cfg, i).items():
                w = _maybe_t(reader.get_tensor(tname), key)
                if key in targets:
                    setattr(blk, key, quantize_tensor(
                        w.to(dev).to(torch.bfloat16), quantize,
                        DEFAULT_GROUP))
                else:
                    getattr(blk, key).copy_(w)
            for key in _EXPERT_HF if cfg.n_experts else ():
                experts = (_maybe_t(reader.get_tensor(
                    _hf_expert_names(i, e)[key]), key)
                    for e in range(cfg.n_experts))
                if key in targets:
                    setattr(blk, key, quantize_stacked(
                        (w.to(dev).to(torch.bfloat16) for w in experts),
                        quantize, DEFAULT_GROUP))
                else:
                    for e, w in enumerate(experts):
                        getattr(blk, key)[e].copy_(w)
        model.embed.copy_(reader.get_tensor("model.embed_tokens.weight"))
        model.final_norm.copy_(reader.get_tensor("model.norm.weight"))
        if model.lm_head is not None:
            # some exports tie the head anyway
            name = ("lm_head.weight" if "lm_head.weight" in reader
                    else "model.embed_tokens.weight")
            model.lm_head.copy_(reader.get_tensor(name).t())
    finally:
        reader.close()
    return model


def merged_weight(t, adapter: Optional[dict] = None,
                  lora_scale: float = 1.0) -> torch.Tensor:
    """A layer tensor as the export holds it before the cast: a quantized
    projection dequantized to fp32, an adapted one ``W + lora_scale * A
    B`` in fp32, any other tensor as it is."""
    if not is_qtensor(t) and adapter is None:
        return t
    t = dequantize(t, torch.float32) if is_qtensor(t) else t.float()
    if adapter is not None:
        t = t + (adapter["a"].float() @ adapter["b"].float()) * lora_scale
    return t


def hf_tensor(t: torch.Tensor, dtype: str) -> torch.Tensor:
    """``t`` as the export stores it: cast to ``dtype`` where it lies,
    then a contiguous CPU tensor (the counterpart of JAX
    ``hf_dtype_np``)."""
    return t.detach().to(torch_dtype(dtype)).contiguous().cpu()


@torch.no_grad()
def save_hf_checkpoint(params: Transformer, cfg: ModelConfig, out_dir: str,
                       *, dtype: str = "bfloat16",
                       max_shard_bytes: int = 4 << 30,
                       lora: Optional[Lora] = None,
                       lora_scale: float = 1.0) -> dict:
    """Export ``params`` to HF safetensors (sharded above
    ``max_shard_bytes``) and ``config.json``, one tensor at a time.

    A quantized projection is dequantized to fp32 on its device; with
    ``lora`` (per-layer adapters) each adapted projection becomes
    ``W + lora_scale * A B`` in fp32 there before the cast: the merged
    model ``merge_lora`` would give, without changing ``params``. An
    expert bank streams expert by expert (dequantized one expert at a
    time). Returns ``{"shards": [file names], "bytes": written}``."""
    w = ShardedSafetensorsWriter(out_dir, max_shard_bytes=max_shard_bytes)
    try:
        w.add("model.embed_tokens.weight", hf_tensor(params.embed, dtype))
        w.add("model.norm.weight", hf_tensor(params.final_norm, dtype))
        if params.lm_head is not None:
            w.add("lm_head.weight", hf_tensor(params.lm_head.t(), dtype))
        for i, blk in enumerate(params.blocks):
            adapters = lora[i] if lora is not None else {}
            for key, tname in _hf_layer_names(cfg, i).items():
                t = merged_weight(getattr(blk, key), adapters.get(key),
                                  lora_scale)
                w.add(tname, hf_tensor(_maybe_t(t, key), dtype))
            for key in _EXPERT_HF if cfg.n_experts else ():
                bank = getattr(blk, key)
                for e in range(cfg.n_experts):
                    t = (dequantize(bank.select(e), torch.float32)
                         if is_qtensor(bank) else bank[e])
                    w.add(_hf_expert_names(i, e)[key],
                          hf_tensor(_maybe_t(t, key), dtype))
        shards = w.finish()
    except BaseException:
        w.abort()
        raise
    write_hf_config(cfg, out_dir, dtype)
    return {"shards": shards, "bytes": w.bytes_written}


# cfg.name prefix -> (HF architectures entry, model_type); other
# families keep a custom tag
_HF_ARCH = (
    ("llama", ("LlamaForCausalLM", "llama")),
    ("mixtral", ("MixtralForCausalLM", "mixtral")),
    ("mistral", ("MistralForCausalLM", "mistral")),
    ("gemma2", ("Gemma2ForCausalLM", "gemma2")),
    ("qwen2", ("Qwen2ForCausalLM", "qwen2")),
)


def write_hf_config(cfg: ModelConfig, out_dir: str,
                    dtype: str = "bfloat16") -> None:
    """The ``config.json`` of JAX ``write_hf_config``, key for key:
    ``rope_scaling`` exported bit-identical (every field feeds HF's
    rotary frequencies), ``max_position_embeddings`` the context the
    model was built with, Gemma-2's softcaps and query scale."""
    arch, model_type = next(
        (v for pfx, v in _HF_ARCH if cfg.name.startswith(pfx)),
        ("GkeRayTrainTpuForCausalLM", None))
    out = {
        "architectures": [arch],
        "model_family": cfg.name,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff,
        "head_dim": cfg.resolved_head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": dtype,
        "max_position_embeddings": cfg.max_seq_len,
        "hidden_act": ("gelu_pytorch_tanh"
                       if cfg.activation == "gelu_tanh" else "silu"),
        **({"num_local_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.expert_top_k}
           if cfg.n_experts else {}),
    }
    if model_type is not None:
        out["model_type"] = model_type
    if cfg.sliding_window is not None:
        out["sliding_window"] = cfg.sliding_window
    if cfg.attn_qkv_bias:
        out["attention_bias"] = True
    if cfg.rope_scaling:
        out["rope_scaling"] = {"rope_type": "llama3",
                               **dict(cfg.rope_scaling)}
    if model_type == "gemma2":
        if cfg.attn_softcap is not None:
            out["attn_logit_softcapping"] = cfg.attn_softcap
        if cfg.logit_softcap is not None:
            out["final_logit_softcapping"] = cfg.logit_softcap
        if cfg.attn_scale is not None:
            out["query_pre_attn_scalar"] = round(cfg.attn_scale ** -2)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(out, f, indent=2)
