"""The decoder-only transformer core (counterpart of
``gke_ray_train_tpu/models/transformer.py``).

A ``Transformer`` module holds the embedding, one ``Block`` per layer and
the final norm / unembedding; the functions below run it. Weights keep
the JAX package's ``[d_in, d_out]`` orientation (``x @ w``, the
``"bsd,dh->bsh"`` einsum), so a JAX param tree carries over with no
transposes (``interop.py``). Layer ``i`` is the JAX stack's repeat
``i // len(block_pattern)`` at pattern position ``i % len(block_pattern)``.

Families: llama2/3, mistral (window), qwen2 (q/k/v bias), gemma2
(softcaps, post-norms, ``(1 + w)`` norms, gelu_tanh, tied and scaled
embeddings) and mixtral (``n_experts > 0``: a router and expert banks in
place of the MLP, ``ops/moe.py``; LoRA adapts attention only, as in the
JAX package). A projection weight or expert bank may be a ``QTensor`` (a
QLoRA base, ``ops/quant.py``), dequantized at use. ``forward`` is
differentiable: with ``cfg.remat`` each repeat of the block pattern runs
under ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` of
``repeat_body``; ``remat_policy="dots"`` keeps the no-batch-dim matmul
outputs and recomputes the rest, :func:`dots_policy`), and LoRA dropout
draws its masks from explicit generators so a recomputed block redraws
the same masks. With ``fused_ops`` the blocks' rms_norms and q/k RoPE
run through the fused kernels (``ops/fused_norm_rope.py``).

Every layer runs through ``Block.__call__`` and the embedding, final
norm and head inside ``Transformer.__call__`` (a caller's loss through
``forward``'s ``loss_fn``), so a model sharded with FSDP2
(``parallel/sharding.py``) gathers each unit's weights around its
forward and again in its backward (under remat, inside the recomputation
too). The one exception is ``OVERLAP=manual`` (``train/overlap.py``),
which gathers the weights itself and runs the same ``_layer`` on them
through :class:`Gathered` views. On a mesh whose ``pipe`` axis exceeds 1
a rank's model holds only its stage's blocks (:class:`StageBlocks`,
registered under their global layer indices, so parameter names are the
whole model's), and ``forward`` runs the pipeline's ticks across the
stages (``models/pipeline.py``) without autograd, the last stage's
output broadcast so every stage runs the final norm and head, as JAX
runs them replicated; the train step drives the pipelined backward
itself (``train/step.py``).

Under tensor parallelism (``model`` above 1, ``parallel/tensor.py``) a
gathered unit's sharded weights are DTensors of the ``model`` submesh;
the layer computes on this rank's parts: ``n_heads / model`` query and
``n_kv_heads / model`` KV heads and ``d_ff / model`` MLP columns (the
local counts read from the local weights' widths), the column-parallel
projections behind ``copy_to_model`` and the row-parallel ones (``wo``,
``w_down``) followed by ``reduce_from_model`` (the partial products
summed in the compute dtype, as JAX's GSPMD sums them). An adapter
keeps its whole A and B on every rank and uses B's local columns on a
column-parallel projection and A's local rows on a row-parallel one,
whose partial ``x_r A_r B`` joins the partial base product before the
all-reduce (exact: the sum is linear). The embedding and the head are
sharded on the vocab: the lookup is ``vocab_parallel_embedding``, and
the logits (or, through the fused loss, the row statistics) are this
rank's vocab shard. On an MoE model ``model`` shards the expert banks on
their expert dim (expert parallelism): a rank runs its ``E / model``
experts on every token routed to them (``ops/moe.py``), beside the
tensor-parallel attention.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import math
import struct
from typing import Callable, Collection, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from gke_ray_train_tpu_torch.device import (
    DeviceLike, check_on, host_to_device, resolve_device)
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.ops.attention import (
    dot_product_attention, make_attention_mask)
from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
from gke_ray_train_tpu_torch.ops.norms import rms_norm
from gke_ray_train_tpu_torch.ops.quant import maybe_dequantize
from gke_ray_train_tpu_torch.ops.rope import (
    apply_rope, rope_frequencies, sinusoidal_positions)
from gke_ray_train_tpu_torch.parallel.tensor import (
    copy_to_model, local_weight, reduce_from_model, tp_of,
    vocab_parallel_embedding)

# per-layer LoRA adapters: lora[i][name] = {"a": [d_in, r], "b": [r, d_out]}
Lora = List[Dict[str, Dict[str, torch.Tensor]]]

logger = logging.getLogger(__name__)


def _warn_flash_fallback(seq_len: int) -> None:
    from gke_ray_train_tpu_torch.logging_utils import warn_once
    warn_once(logger, ("flash_fallback", seq_len),
              "attn_impl='flash' but seq_len=%d is not a 128 multiple — "
              "falling back to the O(S^2) dense-mask path; pad the "
              "sequence to a 128 multiple to keep the kernel", seq_len)


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype name ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _param(*shape, device, dtype) -> nn.Parameter:
    # frozen unless a full fine-tune marks the params trainable
    # (train/step.py::make_train_state)
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def proj_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """``[d_in, d_out]`` of the projections of a block, in init order: the
    four attention projections, then the MLP's three, or on an MoE model
    the router ``[D, E]`` and the expert banks ``[E, d_in, d_out]``."""
    hd = cfg.resolved_head_dim
    D, Fd, H, K = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
              "wo": (H * hd, D)}
    E = cfg.n_experts
    if E:
        shapes.update(router=(D, E), w_gate=(E, D, Fd), w_up=(E, D, Fd),
                      w_down=(E, Fd, D))
    else:
        shapes.update(w_gate=(D, Fd), w_up=(D, Fd), w_down=(Fd, D))
    return shapes


def init_std(cfg: ModelConfig, name: str) -> float:
    """The init std of projection ``name``: 0.02, the residual writers
    (wo, w_down) scaled by 1/sqrt(2 * n_layers), as in the JAX package."""
    if name in ("wo", "w_down"):
        return 0.02 / math.sqrt(2 * cfg.n_layers)
    return 0.02


class Block(nn.Module):
    """One decoder layer's weights; ``kind`` is "global" or "sliding".

    The projections named in ``quantized`` are left unset (None) for the
    caller to fill with ``QTensor``s, so no full-precision copy of them
    is ever allocated."""

    def __init__(self, cfg: ModelConfig, kind: str, *,
                 device: torch.device, dtype: torch.dtype,
                 quantized: Collection[str] = ()):
        super().__init__()
        D = cfg.d_model
        hd = cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.attn_norm = _param(D, **kw)
        self.mlp_norm = _param(D, **kw)
        for name, shape in proj_shapes(cfg).items():
            if name in quantized:
                setattr(self, name, None)
            else:
                self.register_parameter(name, _param(*shape, **kw))
        for name, n in (("bq", cfg.n_heads * hd), ("bk", cfg.n_kv_heads * hd),
                        ("bv", cfg.n_kv_heads * hd)):
            self.register_parameter(
                name, _param(n, **kw) if cfg.attn_qkv_bias else None)
        for name in ("attn_post_norm", "mlp_post_norm"):
            self.register_parameter(
                name, _param(D, **kw) if cfg.post_block_norm else None)

    def forward(self, x, *args, layer_fn: Optional[Callable] = None,
                **kwargs):
        """The layer over ``x`` (``_layer``'s arguments after its
        ``lp``): ``(x, the layer's router aux or None)``. ``layer_fn``
        runs in ``_layer``'s place with the same leading ``(x, lp)`` (the
        KV-cache decode's layer), so it too runs while a sharded block
        holds its weights gathered."""
        return (layer_fn or _layer)(x, self, *args, **kwargs)


class Gathered:
    """One unit's tensors held outside its module, by the attribute names
    the module registers them under: a ``Block``'s (with its ``kind``),
    or the root's ``embed`` / ``final_norm`` / ``lm_head`` with the
    ``blocks`` they run. ``_layer`` and :func:`forward` read it as they
    read a ``Block`` or a ``Transformer``, so the manual overlap
    (``train/overlap.py``) runs the one layer math on weights it gathered
    itself, and no FSDP2 hook gathers them again. ``tensors`` maps each
    registered name to its tensor; a name the module registers as None
    stays None."""

    def __init__(self, module: nn.Module, tensors: Dict[str, torch.Tensor]):
        self.kind = getattr(module, "kind", None)
        for name, p in module._parameters.items():
            setattr(self, name, None if p is None else tensors[name])
        if isinstance(module, Transformer):
            self.blocks = module.blocks


class StageBlocks(nn.Module):
    """A pipeline stage's blocks (``models/pipeline.py::stage_layers``),
    each registered under its global layer index, so ``named_parameters``
    and ``state_dict`` name them as the whole model does
    (``blocks.<i>.…``). Iterates, counts and indexes (by position, an int
    or a slice) as the list of the stage's blocks; ``layer_ids`` are
    their global indices, ascending, and ``mesh`` the pipelined mesh
    once the stage is sharded."""

    def __init__(self, blocks: Dict[int, "Block"]):
        super().__init__()
        for i in sorted(blocks):
            self.add_module(str(i), blocks[i])
        self.layer_ids = tuple(sorted(blocks))
        # the pipelined mesh the stage is sharded over
        # (``parallel/sharding.py::shard_model``), None before: the
        # decode reads its stages from here
        self.mesh = None

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class StageLora(list):
    """A pipeline stage's adapters: one dict a layer of the stage, in
    order, with ``layer_ids`` their global layer indices."""

    def __init__(self, layers, ids):
        super().__init__(layers)
        self.layer_ids = tuple(ids)


def lora_layer_ids(lora) -> tuple:
    """The global layer of each adapter dict of ``lora``: a stage's
    (:class:`StageLora`), else ``0 .. len - 1``."""
    ids = getattr(lora, "layer_ids", None)
    return tuple(range(len(lora))) if ids is None else ids


def lora_of_layers(lora, ids) -> list:
    """``lora``'s adapter dicts of the global layers ``ids``, in order:
    ``lora`` itself where it holds exactly those, else its entries of
    them (a whole model's adapters served by a pipeline stage); raises
    where it lacks one."""
    have = lora_layer_ids(lora)
    if tuple(have) == tuple(ids):
        return lora
    at = {i: n for n, i in enumerate(have)}
    missing = [i for i in ids if i not in at]
    if missing:
        raise ValueError(f"the adapters hold layers {list(have)}, not "
                         f"all of {list(ids)}")
    return StageLora([lora[at[i]] for i in ids], ids)


def layer_ids(params) -> tuple:
    """The global layer index of each of ``params.blocks``: a stage's
    (:class:`StageBlocks`), else ``0 .. n_layers - 1``."""
    ids = getattr(params.blocks, "layer_ids", None)
    return tuple(range(len(params.blocks))) if ids is None else ids


class Transformer(nn.Module):
    """Embedding, ``n_layers`` Blocks, final norm and (untied) head;
    ``quantized`` as for ``Block``. ``layers``: the global indices of the
    blocks to hold (a pipeline stage's, :class:`StageBlocks`); default
    every layer."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 dtype: torch.dtype, quantized: Collection[str] = (),
                 layers: Optional[Collection[int]] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, cfg.d_model, **kw)
        pattern = cfg.block_pattern

        def block(i):
            return Block(cfg, pattern[i % len(pattern)], quantized=quantized,
                         **kw)
        if layers is None:
            self.blocks = nn.ModuleList(block(i) for i in range(cfg.n_layers))
        else:
            self.blocks = StageBlocks({i: block(i) for i in layers})
        self.final_norm = _param(cfg.d_model, **kw)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings
            else _param(cfg.d_model, cfg.vocab_size, **kw))

    def forward(self, tokens: torch.Tensor,
                cfg: Optional[ModelConfig] = None, *,
                step_fn: Optional[Callable] = None, **kw):
        """:func:`forward` of this model (``cfg`` defaults to the one it
        was built with); with ``step_fn``, ``step_fn(self, tokens, cfg,
        **kw)`` in its place (the KV-cache decode's embedding and head),
        run while a sharded root holds its weights gathered."""
        return (step_fn or forward)(self, tokens, cfg or self.cfg, **kw)


Params = Transformer


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def to_stage(params: Transformer, layers: Collection[int]) -> Transformer:
    """Keep only the blocks of global indices ``layers`` (a pipeline
    stage's), in place, the others dropped; returns ``params``."""
    keep = set(layers)
    ids = layer_ids(params)
    params.blocks = StageBlocks({i: blk for i, blk in zip(ids, params.blocks)
                                 if i in keep})
    if set(params.blocks.layer_ids) != keep:
        raise ValueError(f"the model holds layers {sorted(ids)}, not all "
                         f"of the stage's {sorted(keep)}")
    return params


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None, mesh=None) -> Transformer:
    """A randomly initialized model on ``device`` (default ``cuda``).

    Truncated-normal (±3 std) init drawn from a ``torch.Generator`` on the
    target device, seeded with ``seed``; the two residual-writing
    matrices (wo, w_down) are scaled by 1/sqrt(2*n_layers), as in the
    JAX package; an MoE router draws at std 0.02. The draws are not
    JAX's: tests carry JAX's params over with
    ``interop.params_from_numpy`` instead. ``mesh``: on a pipelined mesh
    only this rank's stage's blocks are made; every layer is drawn in
    order all the same, so a stage holds one process's values bitwise."""
    from gke_ray_train_tpu_torch.models.pipeline import mesh_stage
    dev = resolve_device(device)
    stage = mesh_stage(cfg, mesh)
    model = Transformer(cfg, device=dev, dtype=torch_dtype(cfg.param_dtype),
                        layers=stage)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal_(p, std: float, shape=None) -> None:
        tmp = torch.empty(p.shape if shape is None else shape,
                          dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=gen)
        if p is not None:
            p.copy_(tmp.mul_(std))

    def norm_(p: Optional[torch.Tensor]) -> None:
        if p is not None:
            p.fill_(0.0 if cfg.norm_scale_plus_one else 1.0)

    normal_(model.embed, 0.02)
    held = dict(zip(layer_ids(model), model.blocks))
    for i in range(cfg.n_layers):
        blk = held.get(i)
        if blk is None:
            # another stage's layer: its draws only
            for name, shape in proj_shapes(cfg).items():
                normal_(None, 0.0, shape)
            continue
        norm_(blk.attn_norm)
        norm_(blk.mlp_norm)
        for b in (blk.bq, blk.bk, blk.bv):
            if b is not None:
                b.zero_()
        for name in proj_shapes(cfg):
            normal_(getattr(blk, name), init_std(cfg, name))
        norm_(blk.attn_post_norm)
        norm_(blk.mlp_post_norm)
    norm_(model.final_norm)
    if model.lm_head is not None:
        normal_(model.lm_head, 0.02)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

# LoRA dropout tags of the seven projections (the JAX package's fold-in
# tags: q k v o under the attention key, gate up down under the MLP's)
_DROP_TAGS = {"wq": 0, "wk": 1, "wv": 2, "wo": 3, "w_gate": 4, "w_up": 5,
              "w_down": 6}
# the projections whose input dim is sharded over ``model`` (the rest
# shard their output dim)
ROW_PARALLEL = frozenset({"wo", "w_down"})

# an optional ``(projection name, keep mask)`` callback each LoRA dropout
# draw is reported to (tests and the card check read the masks)
dropout_hook: Optional[Callable] = None


def dropout_seed(*parts: int) -> int:
    """A 63-bit generator seed mixed from integers (step, microbatch,
    layer, projection, ...): the same parts give the same seed."""
    h = hashlib.blake2b(struct.pack(f"<{len(parts)}q", *parts),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _lora_dropout(x: torch.Tensor, rate: float, seed: int,
                  name: Optional[str] = None) -> torch.Tensor:
    """Inverted dropout of the adapter-branch input, its keep mask drawn
    from a generator seeded with ``seed``: recomputing a checkpointed
    block redraws exactly the mask of its first forward."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    if dropout_hook is not None:
        dropout_hook(name, mask)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _proj(x: torch.Tensor, w, lora_p, lora_scale: float,
          dtype: torch.dtype, bias: Optional[torch.Tensor] = None, *,
          drop_rate: float = 0.0, drop_seed: Optional[int] = None,
          drop_name: Optional[str] = None) -> torch.Tensor:
    """x @ w (+ bias), plus the low-rank LoRA bypass (two small products,
    never a materialized delta-W) when an adapter is given: ``[d_in, r]``
    / ``[r, d_out]``, or per-row ``[B, d_in, r]`` / ``[B, r, d_out]``
    (``ops/lora_batched.py::bgmv``). The weight
    (a tensor or a ``QTensor``) is cast or dequantized to the compute
    dtype per call — a no-op cast when the params are stored in it.

    ``drop_rate`` / ``drop_seed``: LoRA dropout with peft semantics —
    on the adapter-branch input only; the frozen-base path never drops
    (``drop_name``: the projection, for ``dropout_hook``). A weight or
    bias sharded over ``model`` computes on this rank's part."""
    y = x @ maybe_dequantize(local_weight(w), dtype)
    if lora_p is not None:
        xl = x
        if drop_seed is not None and drop_rate > 0.0:
            xl = _lora_dropout(x, drop_rate, drop_seed, drop_name)
        if lora_p["a"].dim() == 3:
            # per-row adapters gathered from a multi-tenant pool ([B,
            # d_in, r] / [B, r, d_out]): the engine's batched multi-LoRA
            from gke_ray_train_tpu_torch.ops.lora_batched import bgmv
            y = y + bgmv(xl, lora_p["a"], lora_p["b"], scale=lora_scale,
                         dtype=dtype)
        else:
            xa = xl @ lora_p["a"].to(dtype)
            # a fill, not a host-to-card copy (which would wait for the
            # card)
            y = y + (xa @ lora_p["b"].to(dtype)) * torch.full(
                (), lora_scale, dtype=dtype, device=x.device)
    if bias is not None:
        y = y + local_weight(bias).to(dtype)
    return y


def _lora_entry(lora_p, name, tp=None):
    """Projection ``name``'s adapter; under tensor parallelism ``tp`` the
    part this rank applies: B's local columns (a column-parallel
    projection) or A's local rows (``ROW_PARALLEL``)."""
    if lora_p is None or name not in lora_p:
        return None
    ab = lora_p[name]
    if tp is None:
        return ab
    # dims from the end: a served pool's per-row adapters lead with the
    # batch ([B, d_in, r] / [B, r, d_out])
    if name in ROW_PARALLEL:
        return {"a": ab["a"].chunk(tp.size, dim=-2)[tp.rank], "b": ab["b"]}
    return {"a": ab["a"], "b": ab["b"].chunk(tp.size, dim=-1)[tp.rank]}


def _drop_kw(name: str, drop_rate: float, drop_seed: Optional[int],
             tp=None) -> dict:
    """The dropout arguments of projection ``name`` in one layer, whose
    own seed is ``drop_seed`` (None: no dropout). Under tensor
    parallelism a row-parallel projection's input is this model rank's
    slice of heads or ffn columns, a part of JAX's one global mask: the
    model rank enters its seed. A column-parallel one's input is the same
    on every model rank, and so is its mask."""
    if drop_seed is None:
        return {}
    parts = (drop_seed, _DROP_TAGS[name])
    if tp is not None and name in ROW_PARALLEL:
        parts += (tp.rank,)
    return dict(drop_rate=drop_rate, drop_seed=dropout_seed(*parts),
                drop_name=name)


def _rms_norm(x, scale, *, eps: float, scale_plus_one: bool,
              fused_ops: bool = False) -> torch.Tensor:
    """rms_norm, through the fused kernel when the plan asks for it
    (``FUSED_OPS``, ``ops/fused_norm_rope.py``)."""
    if fused_ops:
        from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
            fused_rmsnorm)
        return fused_rmsnorm(x, scale, eps=eps, scale_plus_one=scale_plus_one)
    return rms_norm(x, scale, eps=eps, scale_plus_one=scale_plus_one)


def _apply_rope_qk(q, k, positions, rope, fused_ops: bool = False):
    """RoPE on the projected q and k: one fused kernel launch when the
    plan asks for it, else two ``ops/rope.py`` passes."""
    if fused_ops:
        from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
            fused_rope_qk)
        return fused_rope_qk(q, k, positions, rope)
    return apply_rope(q, positions, rope), apply_rope(k, positions, rope)


def _mlp(x, lp: Block, cfg: ModelConfig, dtype, lora_p=None,
         lora_scale: float = 1.0, drop_rate: float = 0.0,
         drop_seed: Optional[int] = None):
    tp = tp_of(lp.w_gate)

    def proj(h, name):
        return _proj(h, getattr(lp, name), _lora_entry(lora_p, name, tp),
                     lora_scale, dtype,
                     **_drop_kw(name, drop_rate, drop_seed, tp))
    x = copy_to_model(x, tp)
    gate = proj(x, "w_gate")
    up = proj(x, "w_up")
    if cfg.activation == "silu":
        act = F.silu(gate)
    elif cfg.activation == "gelu_tanh":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {cfg.activation}")
    return reduce_from_model(proj(act * up, "w_down"), tp)


def _attn(x, lp: Block, cfg: ModelConfig, impl: str, dtype, rope,
          positions, mask, window, segment_ids, lora_p=None,
          lora_scale: float = 1.0, drop_rate: float = 0.0,
          drop_seed: Optional[int] = None, fused_ops: bool = False,
          mesh=None):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = tp_of(lp.wq)

    def proj(h, name, bias=None):
        return _proj(h, getattr(lp, name), _lora_entry(lora_p, name, tp),
                     lora_scale, dtype, bias=bias,
                     **_drop_kw(name, drop_rate, drop_seed, tp))
    # this rank's heads: all of them, or n_heads / model under TP
    x = copy_to_model(x, tp)
    q = proj(x, "wq", lp.bq).reshape(B, S, -1, hd)
    k = proj(x, "wk", lp.bk).reshape(B, S, -1, hd)
    v = proj(x, "wv", lp.bv).reshape(B, S, -1, hd)
    if rope is not None:
        q, k = _apply_rope_qk(q, k, positions, rope, fused_ops=fused_ops)
    if impl == "xla":
        out = dot_product_attention(q, k, v, mask, scale=cfg.attn_scale,
                                    logit_softcap=cfg.attn_softcap)
    else:
        # kernel paths take the mask inputs, never a materialized mask
        from gke_ray_train_tpu_torch.ops.dispatch import attention_dispatch
        out = attention_dispatch(
            impl, q.contiguous(), k.contiguous(), v.contiguous(),
            q_positions=positions, kv_positions=positions,
            q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            causal=True, sliding_window=window, scale=cfg.attn_scale,
            logit_softcap=cfg.attn_softcap, mesh=mesh)
    return reduce_from_model(proj(out.reshape(B, S, -1), "wo"), tp)


def _layer(x, lp: Block, cfg: ModelConfig, impl: str, dtype, rope,
           positions, masks, segment_ids, lo, lora_scale: float,
           drop_rate: float, drop_seed: Optional[int], fused_ops: bool,
           token_weights: Optional[torch.Tensor] = None, mesh=None):
    """One decoder layer: ``(x, the layer's router aux or None)``;
    ``mesh`` carries the ``context`` axis to the attention."""
    def norm(h, scale):
        return _rms_norm(h, scale, eps=cfg.norm_eps,
                         scale_plus_one=cfg.norm_scale_plus_one,
                         fused_ops=fused_ops)
    h = norm(x, lp.attn_norm)
    h = _attn(h, lp, cfg, impl, dtype, rope, positions, masks[lp.kind],
              cfg.sliding_window if lp.kind == "sliding" else None,
              segment_ids, lora_p=lo, lora_scale=lora_scale,
              drop_rate=drop_rate, drop_seed=drop_seed, fused_ops=fused_ops,
              mesh=mesh)
    if cfg.post_block_norm:
        h = norm(h, lp.attn_post_norm)
    x = x + h
    h = norm(x, lp.mlp_norm)
    aux = None
    if cfg.n_experts:
        # no adapter and no dropout on the routed expert bank, as in JAX;
        # under EP this rank's experts, over context the whole row's
        # capacity and positions (ops/moe.py)
        from gke_ray_train_tpu_torch.ops import moe
        h, aux = moe.moe_mlp(h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
                             cfg, dtype, weights=token_weights, mesh=mesh)
    else:
        h = _mlp(h, lp, cfg, dtype, lora_p=lo, lora_scale=lora_scale,
                 drop_rate=drop_rate, drop_seed=drop_seed)
    if cfg.post_block_norm:
        h = norm(h, lp.mlp_post_norm)
    return x + h, aux


def run_block_stack(x, blocks, cfg: ModelConfig, impl: str, dtype, rope,
                    positions, masks, segment_ids, *,
                    lora: Optional[Lora] = None, lora_scale: float = 1.0,
                    lora_dropout: float = 0.0,
                    lora_seed: Optional[int] = None,
                    fused_ops: bool = False,
                    token_weights: Optional[torch.Tensor] = None,
                    mesh=None, layer_call: Optional[Callable] = None):
    """Run ``blocks`` (a sequence of ``Block``) over the residual stream
    ``x``: ``(x, the summed router aux of the layers)``, the aux None on a
    dense model. ``lora``, when given, holds one adapter dict per block.
    ``fused_ops``: the norms and the q/k RoPE through the fused kernels;
    under remat their Functions run again in the recomputation.
    ``token_weights``: the MoE router aux's weights. ``mesh``: its
    ``context`` axis shards the sequence (the ring and all-to-all
    attention's collectives run inside each block, and again in its
    recomputation under remat).

    With ``cfg.remat`` and autograd recording, each repeat of the block
    pattern is one ``torch.utils.checkpoint`` region (non-reentrant): its
    activations are recomputed in the backward instead of kept; on an
    MoE model the aux rides through it with x. LoRA dropout is active
    when ``lora``, ``lora_dropout`` > 0 and ``lora_seed`` are all given;
    layer ``i`` seeds its masks from ``(lora_seed, i)``.

    ``layer_call``: ``layer_call(i, x, *args)`` in place of
    ``blocks[i](x, *args)`` (``args`` as ``Block.forward`` takes them
    after ``x``), inside the same remat regions: the manual overlap runs
    ``_layer`` on the layer's weights it gathered itself there
    (``train/overlap.py``), and under remat gathers them again in the
    recomputation."""
    drop = (lora is not None and lora_dropout > 0.0
            and lora_seed is not None)
    remat = cfg.remat and torch.is_grad_enabled()
    ckpt_kw = {}
    if remat and cfg.remat_policy == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts)
        ckpt_kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, dots_policy)
    P = len(cfg.block_pattern)

    def repeat(x, aux, first):
        for i in range(first, min(first + P, len(blocks))):
            args = (cfg, impl, dtype, rope, positions, masks, segment_ids,
                    lora[i] if lora is not None else None, lora_scale,
                    lora_dropout,
                    dropout_seed(lora_seed, i) if drop else None,
                    fused_ops, token_weights, mesh)
            if layer_call is not None:
                x, a = layer_call(i, x, *args)
            else:
                # through Block.__call__: a sharded block gathers its
                # weights
                x, a = blocks[i](x, *args)
            if a is not None:
                aux = aux + a
        return x, aux

    # the JAX scan's carry: the aux sums layer by layer from 0
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if cfg.n_experts else None)
    for first in range(0, len(blocks), P):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                repeat, x, aux, first, use_reentrant=False, **ckpt_kw)
        else:
            x, aux = repeat(x, aux, first)
    return x, aux


# the matmuls ``remat_policy="dots"`` saves: JAX's
# ``dots_with_no_batch_dims_saveable`` keeps every dot_general without
# batch dims, which in torch is a 2-D product (``x @ w`` with a 2-D
# ``w`` folds its leading dims into ``mm``); batched products (``bmm``),
# the dequantize passes, norms, activations and the kernels'
# autograd Functions are recomputed
DOTS_SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})

# an optional ``(op, saved: bool)`` callback each decision of
# :func:`dots_policy` is reported to (tests watch what is saved)
dots_policy_hook: Optional[Callable] = None


def dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="dots"``: save
    the outputs of :data:`DOTS_SAVED_OPS`, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    save = op in DOTS_SAVED_OPS
    if dots_policy_hook is not None and not ctx.is_recompute:
        dots_policy_hook(op, save)
    return (CheckpointPolicy.MUST_SAVE if save
            else CheckpointPolicy.PREFER_RECOMPUTE)


def resolve_seq_impl(cfg: ModelConfig, S: int, device: torch.device,
                     context: int = 1) -> str:
    """The attention impl a sequence of length S actually runs on
    ``device``: ``"auto"`` resolved, then the S % 128 dense fallback.
    Sharded over a ``context`` above 1 (S the shard's length) only the
    context-parallel impls run: ``"auto"`` (which resolves to the flash
    kernel on CUDA, as JAX's does on a TPU), ``"flash"`` and the dense
    ``"xla"`` (its mask is built from the shard's positions alone)
    raise, and there is no dense fallback."""
    impl = cfg.resolved_attn_impl(device)
    if context > 1:
        if impl not in ("ring", "a2a"):
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} on a mesh with "
                f"context={context} would drop attention across the "
                "sequence shards; use attn_impl='ring' or 'a2a'")
        return impl
    if impl == "flash" and S % 128 != 0:
        _warn_flash_fallback(S)
        impl = "xla"
    return impl


def embed_tokens(params: Transformer, tokens: torch.Tensor,
                 cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup in the compute dtype (gathered rows cast, not the
    whole table), with Gemma's sqrt(d_model) scale; a table sharded on
    the vocab over ``model`` through ``vocab_parallel_embedding``."""
    tp = tp_of(params.embed)
    if tp is None:
        x = F.embedding(tokens.long(), params.embed).to(dtype)
    else:
        x = vocab_parallel_embedding(tokens, local_weight(params.embed), tp,
                                     dtype)
    if cfg.embed_scale:
        # the scale rounded to x's dtype on the host (JAX multiplies by
        # it as an array of that dtype): no tensor made on the card
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))
    return x


# position tables on each device, made once: a copy from the host per
# forward would make the host wait for the card every microbatch
_TABLES: Dict[tuple, torch.Tensor] = {}


def _device_table(key: tuple, make, device: torch.device) -> torch.Tensor:
    table = _TABLES.get(key + (device,))
    if table is None:
        table = _TABLES[key + (device,)] = host_to_device(make(), device)
    return table


def position_inputs(cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor):
    """(x with the sinusoidal table added, None) or (x, RoPE inverse
    frequencies on x's device)."""
    if cfg.positional == "sinusoidal":
        table = _device_table(
            ("sinusoidal", cfg.max_seq_len, cfg.d_model),
            lambda: sinusoidal_positions(cfg.max_seq_len, cfg.d_model),
            x.device)
        idx = positions.long().clamp(0, cfg.max_seq_len - 1)
        return x + table.to(x.dtype)[idx], None
    return x, rope_table(cfg, x.device)


def rope_table(cfg: ModelConfig, device: torch.device
               ) -> Optional[torch.Tensor]:
    """RoPE inverse frequencies on ``device`` (None for sinusoidal
    positions, which the embedding adds)."""
    if cfg.positional == "sinusoidal":
        return None
    return _device_table(
        ("rope", cfg.resolved_head_dim, cfg.rope_theta, cfg.rope_scaling),
        lambda: rope_frequencies(cfg.resolved_head_dim, theta=cfg.rope_theta,
                                 llama3_scaling=cfg.rope_scaling),
        device)


def _masks(cfg: ModelConfig, impl: str, positions, segment_ids) -> dict:
    """Dense masks of each block kind, shared by every layer of one kind
    (the xla impl); None for the kernel paths, which build theirs
    in-kernel."""
    masks = {kind: None for kind in set(cfg.block_pattern)}
    if impl == "xla":
        for kind in masks:
            masks[kind] = make_attention_mask(
                positions, positions, segment_ids, segment_ids, causal=True,
                sliding_window=(cfg.sliding_window if kind == "sliding"
                                else None))
    return masks


def _default_positions(B: int, S: int, mesh, device) -> torch.Tensor:
    """``arange(S)``, at a ``context`` above 1 this rank's slice
    ``c * S + arange(S)`` of the global positions (S the shard's)."""
    from gke_ray_train_tpu_torch.parallel.mesh import context_rank
    off = context_rank(mesh) * S
    return torch.arange(off, off + S, dtype=torch.int32,
                        device=device).expand(B, S)


def pipeline_forward(params: Transformer, tokens: torch.Tensor,
                     cfg: ModelConfig, *, mesh,
                     positions: Optional[torch.Tensor] = None,
                     segment_ids: Optional[torch.Tensor] = None,
                     lora: Optional[Lora] = None, lora_scale: float = 1.0,
                     lora_dropout: float = 0.0,
                     lora_seed: Optional[int] = None,
                     fused_ops: bool = False,
                     token_weights: Optional[torch.Tensor] = None,
                     microbatches: Optional[int] = None,
                     head: Optional[Callable] = None):
    """The forward ticks of a pipelined mesh (``models/pipeline.py::
    run_forward``) over ``tokens`` [B, S], this rank's rows, cut into
    ``microbatches`` (default one a hop, ``pipe_virtual × pipe``): the
    first stage embeds each microbatch, every stage runs its blocks, the
    last calls ``head(m, y)`` on each microbatch's output. Returns the
    ``Run``. Raises on LoRA dropout, as JAX does."""
    from gke_ray_train_tpu_torch.models import pipeline as pl
    B, S = tokens.shape
    M = pl.check_run(cfg, mesh, microbatches, B, dropout=(
        lora is not None and lora_seed is not None and lora_dropout > 0.0))
    dev = params.embed.device
    check_on(tokens, dev, "tokens")
    dtype = torch_dtype(cfg.dtype)
    sch = pl.schedule_of(cfg, mesh, M)
    if positions is None:
        positions = _default_positions(B, S, mesh, dev)
    impl = pl.resolve_impl(cfg, mesh, S, dev)
    Bm = B // M
    micro = []
    for m in range(M):
        rows = slice(m * Bm, (m + 1) * Bm)
        pos = positions[rows]
        seg = segment_ids[rows] if segment_ids is not None else None
        micro.append({"positions": pos, "segment_ids": seg,
                      "masks": _masks(cfg, impl, pos, seg),
                      "weights": (token_weights[rows]
                                  if token_weights is not None else None)})
    inputs = None
    if sch.rank == 0:
        inputs = [position_inputs(cfg, embed_tokens(
            params, tokens[m * Bm:(m + 1) * Bm], cfg, dtype),
            micro[m]["positions"])[0] for m in range(M)]
    return pl.run_forward(
        params.blocks, cfg, mesh, schedule=sch, micro=micro, inputs=inputs,
        shape=(Bm, S, cfg.d_model), dtype=dtype, device=dev, impl=impl,
        rope=rope_table(cfg, dev), lora=lora, lora_scale=lora_scale,
        fused_ops=fused_ops, head=head)


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            lora: Optional[Lora] = None,
            lora_scale: float = 1.0,
            lora_dropout: float = 0.0,
            lora_seed: Optional[int] = None,
            fused_ops: bool = False,
            return_pre_unembed: bool = False,
            with_aux: bool = False,
            token_weights: Optional[torch.Tensor] = None,
            loss_fn: Optional[Callable] = None,
            mesh=None, pipe_microbatches: Optional[int] = None,
            layer_call: Optional[Callable] = None):
    """tokens [B, S] integer → logits [B, S, vocab] float32 (under tensor
    parallelism [B, S, vocab / model], this rank's vocab shard). Runs on
    the device the params and tokens lie on.

    ``lora_dropout`` / ``lora_seed``: adapter-input dropout, active only
    when both are given (and ``lora``); inference passes neither.
    ``fused_ops``: the blocks' rms_norms and q/k RoPE through the fused
    kernels (plan knob ``FUSED_OPS``); the final norm stays the plain op,
    as in the JAX package.
    ``return_pre_unembed``: return the final-normed hidden state
    [B, S, D] instead of the logits.
    ``with_aux``: return ``(out, {"router_aux": the mean of the layers'
    Switch load-balance aux})`` (0 on a dense model), as JAX does; the
    train step asks for it on MoE models. ``token_weights`` (optional
    [B, S], the loss weights): the aux balances real tokens, not
    padding; dense models ignore it.
    ``loss_fn``: when given, ``forward`` returns ``loss_fn(out, params)``
    (``out`` the logits or the pre-unembed state, as asked; with
    ``with_aux`` paired with the aux), so a loss that reads the head runs
    while a sharded root holds it gathered (``train/step.py``).
    ``mesh``: a ``parallel/mesh.py::build_mesh`` mesh; where its
    ``context`` axis C exceeds 1, ``tokens`` (and positions, segment
    ids, weights) are this rank's ``S / C`` tokens of each row, the
    attention runs ``"ring"`` or ``"a2a"`` across the context ranks
    (``resolve_seq_impl``), and absent positions are the rank's slice
    ``c * S / C + arange(S / C)`` of the global ``arange(S)``, as JAX
    shards it. Where its ``pipe`` axis exceeds 1 the block stack runs as
    ``pipe_microbatches`` microbatches (default one a hop) through the
    stages (:func:`pipeline_forward`), without autograd, and the result
    is the same on every stage; the router aux is JAX's pipelined one
    (``models/pipeline.py``). ``layer_call``: each layer through it
    (:func:`run_block_stack`), ``params`` then a :class:`Gathered` root
    (the manual overlap's, ``train/overlap.py``)."""
    from gke_ray_train_tpu_torch.parallel.mesh import (
        context_size, pipe_group, pipe_size)
    B, S = tokens.shape
    dev = params.embed.device
    check_on(tokens, dev, "tokens")
    dtype = torch_dtype(cfg.dtype)
    C = context_size(mesh)
    if pipe_size(mesh) > 1:
        # the pipelined block stack, the last stage's output broadcast so
        # every stage runs the tail below
        import torch.distributed as dist
        from gke_ray_train_tpu_torch.models import pipeline as pl
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the pipelined forward runs without autograd; training "
                "drives the pipeline's backward through train/step.py")
        run = pipeline_forward(
            params, tokens, cfg, mesh=mesh, positions=positions,
            segment_ids=segment_ids, lora=lora, lora_scale=lora_scale,
            lora_dropout=lora_dropout, lora_seed=lora_seed,
            fused_ops=fused_ops, token_weights=token_weights,
            microbatches=pipe_microbatches)
        x = pl.gather_outputs(run, mesh, (B, S, cfg.d_model), dtype, dev)
        aux = None
        if cfg.n_experts:
            aux = pl.stage_aux(run, dev)
            dist.all_reduce(aux, group=pipe_group(mesh))
            aux = aux / run.schedule.microbatches
    else:
        if positions is None:
            positions = _default_positions(B, S, mesh, dev)
        x = embed_tokens(params, tokens, cfg, dtype)
        x, rope = position_inputs(cfg, x, positions)
        impl = resolve_seq_impl(cfg, S, dev, C)
        x, aux = run_block_stack(
            x, params.blocks, cfg, impl, dtype, rope, positions,
            _masks(cfg, impl, positions, segment_ids), segment_ids,
            lora=lora, lora_scale=lora_scale, lora_dropout=lora_dropout,
            lora_seed=lora_seed, fused_ops=fused_ops,
            token_weights=token_weights, mesh=mesh, layer_call=layer_call)
    if return_pre_unembed:
        out = pre_unembed(x, params, cfg)
    else:
        out = _unembed(x, params, cfg, dtype)
    if loss_fn is not None:
        out = loss_fn(out, params)
    if with_aux:
        return out, {"router_aux": aux / cfg.n_layers if aux is not None
                     else torch.zeros((), dtype=torch.float32, device=dev)}
    return out


def pre_unembed(x, params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The final-normed hidden state."""
    return rms_norm(x, params.final_norm, eps=cfg.norm_eps,
                    scale_plus_one=cfg.norm_scale_plus_one)


def unembed_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The [D, vocab] unembedding matrix (tied or dedicated); under
    tensor parallelism this rank's [D, vocab / model] shard."""
    if cfg.tie_embeddings:
        return local_weight(params.embed).T
    return local_weight(params.lm_head)


def head_tp(params: Transformer, cfg: ModelConfig):
    """The ``model`` axis the head's vocab is sharded over, or None."""
    return tp_of(params.embed if cfg.tie_embeddings else params.lm_head)


def _unembed(x, params: Transformer, cfg: ModelConfig, dtype) -> torch.Tensor:
    """Final norm → (tied) unembedding → logit softcap; float32 logits
    from compute-dtype operands (``ops/matmul.py``); under tensor
    parallelism the logits of this rank's vocab shard."""
    x = copy_to_model(pre_unembed(x, params, cfg), head_tp(params, cfg))
    lead = x.shape[:-1]
    logits = matmul_f32(x.reshape(-1, x.shape[-1]),
                        unembed_head(params, cfg).to(dtype))
    logits = logits.reshape(*lead, -1)
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
