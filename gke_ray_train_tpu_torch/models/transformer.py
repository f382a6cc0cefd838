"""The decoder-only transformer core (counterpart of
``gke_ray_train_tpu/models/transformer.py``).

A ``Transformer`` module holds the embedding, one ``Block`` per layer and
the final norm / unembedding; the functions below run it. Weights keep
the JAX package's ``[d_in, d_out]`` orientation (``x @ w``, the
``"bsd,dh->bsh"`` einsum), so a JAX param tree carries over with no
transposes (``interop.py``). Layer ``i`` is the JAX stack's repeat
``i // len(block_pattern)`` at pattern position ``i % len(block_pattern)``.

Dense families only: llama2/3, mistral (window), qwen2 (q/k/v bias) and
gemma2 (softcaps, post-norms, ``(1 + w)`` norms, gelu_tanh, tied and
scaled embeddings). A projection weight may be a ``QTensor`` (a QLoRA
base, ``ops/quant.py``), dequantized at use. ``forward`` is
differentiable: with ``cfg.remat`` each repeat of the block pattern runs
under ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` of
``repeat_body``), and LoRA dropout draws its masks from explicit
generators so a recomputed block redraws the same masks. With
``fused_ops`` the blocks' rms_norms and q/k RoPE run through the fused
kernels (``ops/fused_norm_rope.py``). The pipeline and mesh paths of the
JAX ``forward`` belong to later slices.
"""

from __future__ import annotations

import hashlib
import logging
import math
import struct
from typing import Collection, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from gke_ray_train_tpu_torch.device import DeviceLike, check_on, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.ops.attention import (
    dot_product_attention, make_attention_mask)
from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
from gke_ray_train_tpu_torch.ops.norms import rms_norm
from gke_ray_train_tpu_torch.ops.quant import maybe_dequantize
from gke_ray_train_tpu_torch.ops.rope import (
    apply_rope, rope_frequencies, sinusoidal_positions)

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
    """``[d_in, d_out]`` of the seven projections of a block."""
    hd = cfg.resolved_head_dim
    D, Fd, H, K = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads
    return {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
            "wo": (H * hd, D), "w_gate": (D, Fd), "w_up": (D, Fd),
            "w_down": (Fd, D)}


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


class Transformer(nn.Module):
    """Embedding, ``n_layers`` Blocks, final norm and (untied) head;
    ``quantized`` as for ``Block``."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 dtype: torch.dtype, quantized: Collection[str] = ()):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(
                "MoE models (n_experts > 0) are not ported yet; the port "
                "runs dense families")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, cfg.d_model, **kw)
        pattern = cfg.block_pattern
        self.blocks = nn.ModuleList(
            Block(cfg, pattern[i % len(pattern)], quantized=quantized, **kw)
            for i in range(cfg.n_layers))
        self.final_norm = _param(cfg.d_model, **kw)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings
            else _param(cfg.d_model, cfg.vocab_size, **kw))

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        return forward(self, tokens, self.cfg, **kw)


Params = Transformer


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Transformer:
    """A randomly initialized model on ``device`` (default ``cuda``).

    Truncated-normal (±3 std) init drawn from a ``torch.Generator`` on the
    target device, seeded with ``seed``; the two residual-writing
    matrices (wo, w_down) are scaled by 1/sqrt(2*n_layers), as in the
    JAX package. The draws are not JAX's: tests carry JAX's params over
    with ``interop.params_from_numpy`` instead."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, dtype=torch_dtype(cfg.param_dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

    def normal_(p: torch.Tensor, std: float) -> None:
        tmp = torch.empty(p.shape, dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=gen)
        p.copy_(tmp.mul_(std))

    def norm_(p: Optional[torch.Tensor]) -> None:
        if p is not None:
            p.fill_(0.0 if cfg.norm_scale_plus_one else 1.0)

    normal_(model.embed, 0.02)
    for blk in model.blocks:
        norm_(blk.attn_norm)
        normal_(blk.wq, 0.02)
        normal_(blk.wk, 0.02)
        normal_(blk.wv, 0.02)
        normal_(blk.wo, 0.02 * depth_scale)
        norm_(blk.mlp_norm)
        for b in (blk.bq, blk.bk, blk.bv):
            if b is not None:
                b.zero_()
        normal_(blk.w_gate, 0.02)
        normal_(blk.w_up, 0.02)
        normal_(blk.w_down, 0.02 * depth_scale)
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


def dropout_seed(*parts: int) -> int:
    """A 63-bit generator seed mixed from integers (step, microbatch,
    layer, projection, ...): the same parts give the same seed."""
    h = hashlib.blake2b(struct.pack(f"<{len(parts)}q", *parts),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _lora_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of the adapter-branch input, its keep mask drawn
    from a generator seeded with ``seed``: recomputing a checkpointed
    block redraws exactly the mask of its first forward."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _proj(x: torch.Tensor, w, lora_p, lora_scale: float,
          dtype: torch.dtype, bias: Optional[torch.Tensor] = None, *,
          drop_rate: float = 0.0, drop_seed: Optional[int] = None
          ) -> torch.Tensor:
    """x @ w (+ bias), plus the low-rank LoRA bypass (two small products,
    never a materialized delta-W) when an adapter is given. The weight
    (a tensor or a ``QTensor``) is cast or dequantized to the compute
    dtype per call — a no-op cast when the params are stored in it.

    ``drop_rate`` / ``drop_seed``: LoRA dropout with peft semantics —
    on the adapter-branch input only; the frozen-base path never drops."""
    y = x @ maybe_dequantize(w, dtype)
    if lora_p is not None:
        if lora_p["a"].dim() != 2:
            raise NotImplementedError(
                "per-row adapters (batched multi-LoRA) are not ported yet")
        xl = x
        if drop_seed is not None and drop_rate > 0.0:
            xl = _lora_dropout(x, drop_rate, drop_seed)
        xa = xl @ lora_p["a"].to(dtype)
        # a fill, not a host-to-card copy (which would wait for the card)
        y = y + (xa @ lora_p["b"].to(dtype)) * torch.full(
            (), lora_scale, dtype=dtype, device=x.device)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def _lora_entry(lora_p, name):
    return None if lora_p is None or name not in lora_p else lora_p[name]


def _drop_kw(name: str, drop_rate: float, drop_seed: Optional[int]) -> dict:
    """The dropout arguments of projection ``name`` in one layer, whose
    own seed is ``drop_seed`` (None: no dropout)."""
    if drop_seed is None:
        return {}
    return dict(drop_rate=drop_rate,
                drop_seed=dropout_seed(drop_seed, _DROP_TAGS[name]))


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
    def proj(h, name):
        return _proj(h, getattr(lp, name), _lora_entry(lora_p, name),
                     lora_scale, dtype, **_drop_kw(name, drop_rate, drop_seed))
    gate = proj(x, "w_gate")
    up = proj(x, "w_up")
    if cfg.activation == "silu":
        act = F.silu(gate)
    elif cfg.activation == "gelu_tanh":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {cfg.activation}")
    return proj(act * up, "w_down")


def _attn(x, lp: Block, cfg: ModelConfig, impl: str, dtype, rope,
          positions, mask, window, segment_ids, lora_p=None,
          lora_scale: float = 1.0, drop_rate: float = 0.0,
          drop_seed: Optional[int] = None, fused_ops: bool = False):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads

    def proj(h, name, bias=None):
        return _proj(h, getattr(lp, name), _lora_entry(lora_p, name),
                     lora_scale, dtype, bias=bias,
                     **_drop_kw(name, drop_rate, drop_seed))
    q = proj(x, "wq", lp.bq).reshape(B, S, H, hd)
    k = proj(x, "wk", lp.bk).reshape(B, S, K, hd)
    v = proj(x, "wv", lp.bv).reshape(B, S, K, hd)
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
            logit_softcap=cfg.attn_softcap)
    return proj(out.reshape(B, S, H * hd), "wo")


def _layer(x, lp: Block, cfg: ModelConfig, impl: str, dtype, rope,
           positions, masks, segment_ids, lo, lora_scale: float,
           drop_rate: float, drop_seed: Optional[int], fused_ops: bool):
    def norm(h, scale):
        return _rms_norm(h, scale, eps=cfg.norm_eps,
                         scale_plus_one=cfg.norm_scale_plus_one,
                         fused_ops=fused_ops)
    h = norm(x, lp.attn_norm)
    h = _attn(h, lp, cfg, impl, dtype, rope, positions, masks[lp.kind],
              cfg.sliding_window if lp.kind == "sliding" else None,
              segment_ids, lora_p=lo, lora_scale=lora_scale,
              drop_rate=drop_rate, drop_seed=drop_seed, fused_ops=fused_ops)
    if cfg.post_block_norm:
        h = norm(h, lp.attn_post_norm)
    x = x + h
    h = norm(x, lp.mlp_norm)
    h = _mlp(h, lp, cfg, dtype, lora_p=lo, lora_scale=lora_scale,
             drop_rate=drop_rate, drop_seed=drop_seed)
    if cfg.post_block_norm:
        h = norm(h, lp.mlp_post_norm)
    return x + h


def run_block_stack(x, blocks, cfg: ModelConfig, impl: str, dtype, rope,
                    positions, masks, segment_ids, *,
                    lora: Optional[Lora] = None, lora_scale: float = 1.0,
                    lora_dropout: float = 0.0,
                    lora_seed: Optional[int] = None,
                    fused_ops: bool = False):
    """Run ``blocks`` (a sequence of ``Block``) over the residual stream
    ``x``; ``lora``, when given, holds one adapter dict per block.
    ``fused_ops``: the norms and the q/k RoPE through the fused kernels;
    under remat their Functions run again in the recomputation.

    With ``cfg.remat`` and autograd recording, each repeat of the block
    pattern is one ``torch.utils.checkpoint`` region (non-reentrant): its
    activations are recomputed in the backward instead of kept. LoRA
    dropout is active when ``lora``, ``lora_dropout`` > 0 and
    ``lora_seed`` are all given; layer ``i`` seeds its masks from
    ``(lora_seed, i)``."""
    drop = (lora is not None and lora_dropout > 0.0
            and lora_seed is not None)
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet (ROADMAP "
            "queue 1); the port recomputes whole blocks "
            "(remat_policy='full')")
    P = len(cfg.block_pattern)

    def repeat(x, first):
        for i in range(first, min(first + P, len(blocks))):
            x = _layer(x, blocks[i], cfg, impl, dtype, rope, positions,
                       masks, segment_ids,
                       lora[i] if lora is not None else None, lora_scale,
                       lora_dropout,
                       dropout_seed(lora_seed, i) if drop else None,
                       fused_ops)
        return x

    for first in range(0, len(blocks), P):
        if remat:
            x = torch.utils.checkpoint.checkpoint(repeat, x, first,
                                                  use_reentrant=False)
        else:
            x = repeat(x, first)
    return x


def resolve_seq_impl(cfg: ModelConfig, S: int, device: torch.device) -> str:
    """The attention impl a sequence of length S actually runs on
    ``device``: ``"auto"`` resolved, then the S % 128 dense fallback."""
    impl = cfg.resolved_attn_impl(device)
    if impl == "flash" and S % 128 != 0:
        _warn_flash_fallback(S)
        impl = "xla"
    return impl


def embed_tokens(params: Transformer, tokens: torch.Tensor,
                 cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup in the compute dtype (gathered rows cast, not the
    whole table), with Gemma's sqrt(d_model) scale."""
    x = F.embedding(tokens.long(), params.embed).to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    return x


def position_inputs(cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor):
    """(x with the sinusoidal table added, None) or (x, RoPE inverse
    frequencies on x's device)."""
    if cfg.positional == "sinusoidal":
        table = torch.from_numpy(
            sinusoidal_positions(cfg.max_seq_len, cfg.d_model)).to(x.device)
        idx = positions.long().clamp(0, cfg.max_seq_len - 1)
        return x + table.to(x.dtype)[idx], None
    rope = torch.from_numpy(rope_frequencies(
        cfg.resolved_head_dim, theta=cfg.rope_theta,
        llama3_scaling=cfg.rope_scaling)).to(x.device)
    return x, rope


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            lora: Optional[Lora] = None,
            lora_scale: float = 1.0,
            lora_dropout: float = 0.0,
            lora_seed: Optional[int] = None,
            fused_ops: bool = False,
            return_pre_unembed: bool = False) -> torch.Tensor:
    """tokens [B, S] integer → logits [B, S, vocab] float32. Runs on the
    device the params and tokens lie on.

    ``lora_dropout`` / ``lora_seed``: adapter-input dropout, active only
    when both are given (and ``lora``); inference passes neither.
    ``fused_ops``: the blocks' rms_norms and q/k RoPE through the fused
    kernels (plan knob ``FUSED_OPS``); the final norm stays the plain op,
    as in the JAX package.
    ``return_pre_unembed``: return the final-normed hidden state
    [B, S, D] instead of the logits."""
    B, S = tokens.shape
    dev = params.embed.device
    check_on(tokens, dev, "tokens")
    dtype = torch_dtype(cfg.dtype)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
    x = embed_tokens(params, tokens, cfg, dtype)
    x, rope = position_inputs(cfg, x, positions)
    impl = resolve_seq_impl(cfg, S, dev)
    # dense masks are shared by every layer of one kind; the kernel
    # paths build theirs in-kernel
    masks = {kind: None for kind in set(cfg.block_pattern)}
    if impl == "xla":
        for kind in masks:
            masks[kind] = make_attention_mask(
                positions, positions, segment_ids, segment_ids, causal=True,
                sliding_window=(cfg.sliding_window if kind == "sliding"
                                else None))
    x = run_block_stack(x, params.blocks, cfg, impl, dtype, rope, positions,
                        masks, segment_ids, lora=lora, lora_scale=lora_scale,
                        lora_dropout=lora_dropout, lora_seed=lora_seed,
                        fused_ops=fused_ops)
    if return_pre_unembed:
        return pre_unembed(x, params, cfg)
    return _unembed(x, params, cfg, dtype)


def pre_unembed(x, params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The final-normed hidden state."""
    return rms_norm(x, params.final_norm, eps=cfg.norm_eps,
                    scale_plus_one=cfg.norm_scale_plus_one)


def unembed_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The [D, vocab] unembedding matrix (tied or dedicated)."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _unembed(x, params: Transformer, cfg: ModelConfig, dtype) -> torch.Tensor:
    """Final norm → (tied) unembedding → logit softcap; float32 logits
    from compute-dtype operands (``ops/matmul.py``)."""
    x = pre_unembed(x, params, cfg)
    lead = x.shape[:-1]
    logits = matmul_f32(x.reshape(-1, x.shape[-1]),
                        unembed_head(params, cfg).to(dtype))
    logits = logits.reshape(*lead, -1)
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
