"""KV-cache decode (counterpart of ``gke_ray_train_tpu/models/kvcache.py``).

- The cache is ``{"k", "v"}`` of ``[n_layers, B, max_len, n_kv_heads,
  head_dim]``: layer ``i``'s rows are one contiguous slice.
- One function, ``forward_step``, serves prefill (T = prompt width) and
  decode (T = 1): new tokens sit at per-row positions ``lens +
  arange(T)``, their K/V are written into the cache, and attention masks
  by absolute position (kv_pos <= q_pos), so right-padded prompts need no
  compaction and garbage slots are overwritten before they become
  visible.
- Where JAX returns a new cache, the port writes the given cache in
  place and returns it.
- Prefill runs through the flash kernel when the prompt and cache widths
  both tile by 128 — the same gate as the JAX package, so both route the
  same shapes the same way; decode steps (T = 1) and ``attn_impl="xla"``
  keep the dense mask.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike, check_on, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, Params, _lora_entry, _mlp, _proj, _unembed, embed_tokens,
    position_inputs, torch_dtype)
from gke_ray_train_tpu_torch.ops.attention import (
    dot_product_attention, make_attention_mask)
from gke_ray_train_tpu_torch.ops.norms import rms_norm
from gke_ray_train_tpu_torch.ops.rope import apply_rope

Cache = Dict[str, torch.Tensor]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Cache:
    """Zeroed cache in the compute dtype: ``{"k", "v"}`` of
    [n_layers, batch, max_len, n_kv_heads, head_dim]."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def insert_cache_slot(pool: Cache, slot: int, row: Cache) -> Cache:
    """Write a batch-1 cache ``row`` into batch index ``slot`` of a pooled
    cache, in place — the continuous-batching admit path. No other slot's
    K/V bytes change."""
    for name in ("k", "v"):
        pool[name][:, slot] = row[name][:, 0].to(pool[name].dtype)
    return pool


def _scatter_rows(cache_kv: torch.Tensor, new_kv: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """Write new_kv [B, T, K, hd] into cache_kv [B, max_len, K, hd] at
    per-row offsets lens[b], in place.

    The start is clamped to [0, max_len - T] exactly as JAX's
    ``dynamic_update_slice`` clamps it: a done row whose lens reached
    max_len re-writes the last slots instead of writing out of range."""
    B, L = cache_kv.shape[:2]
    T = new_kv.shape[1]
    start = lens.long().clamp(0, L - T)
    idx = start[:, None] + torch.arange(T, device=cache_kv.device)[None, :]
    rows = torch.arange(B, device=cache_kv.device)[:, None]
    cache_kv[rows, idx] = new_kv.to(cache_kv.dtype)
    return cache_kv


def _warn_dense_prefill(T: int, max_len: int) -> None:
    from gke_ray_train_tpu_torch.logging_utils import warn_once
    warn_once(logging.getLogger(__name__), ("dense_prefill", T, max_len),
              "prefill width %d / cache %d do not tile by 128 — falling "
              "back to dense-mask attention (O(T*max_len) logits in "
              "memory); pad the prompt buffer to 128-multiples to use "
              "the flash kernel", T, max_len)


def forward_step(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 cache: Cache, lens: torch.Tensor, *,
                 lora: Optional[Lora] = None,
                 lora_scale: float = 1.0) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, T] at per-row absolute positions lens + arange(T) →
    (logits [B, T, vocab] float32, the cache updated in place)."""
    B, T = tokens.shape
    dev = params.embed.device
    check_on(tokens, dev, "tokens")
    dtype = torch_dtype(cfg.dtype)
    eps, sp1 = cfg.norm_eps, cfg.norm_scale_plus_one
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    max_len = cache["k"].shape[2]

    positions = lens.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=dev)[None, :]
    x = embed_tokens(params, tokens, cfg, dtype)
    x, rope = position_inputs(cfg, x, positions)

    kv_positions = torch.arange(max_len, dtype=torch.int32,
                                device=dev).expand(B, max_len)
    impl = cfg.resolved_attn_impl(dev)
    # ring/a2a are training-time context-parallel strategies; decode is
    # device-local, so they run plain flash here, as in the JAX package
    use_flash = (impl != "xla" and T > 1
                 and T % 128 == 0 and max_len % 128 == 0)
    if not use_flash and impl != "xla" and T > 1:
        _warn_dense_prefill(T, max_len)
    masks = {}
    if not use_flash:
        for kind in set(cfg.block_pattern):
            masks[kind] = make_attention_mask(
                positions, kv_positions, causal=True,
                sliding_window=(cfg.sliding_window if kind == "sliding"
                                else None))

    for i, lp in enumerate(params.blocks):
        lo = lora[i] if lora is not None else None

        def lr(name):
            return _lora_entry(lo, name)

        h = rms_norm(x, lp.attn_norm, eps=eps, scale_plus_one=sp1)
        q = _proj(h, lp.wq, lr("wq"), lora_scale, dtype, bias=lp.bq)
        k = _proj(h, lp.wk, lr("wk"), lora_scale, dtype, bias=lp.bk)
        v = _proj(h, lp.wv, lr("wv"), lora_scale, dtype, bias=lp.bv)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, K, hd)
        v = v.reshape(B, T, K, hd)
        if rope is not None:
            q = apply_rope(q, positions, rope)
            k = apply_rope(k, positions, rope)
        k_cache = _scatter_rows(cache["k"][i], k, lens)
        v_cache = _scatter_rows(cache["v"][i], v, lens)
        window = cfg.sliding_window if lp.kind == "sliding" else None
        if use_flash:
            from gke_ray_train_tpu_torch.ops.dispatch import (
                attention_dispatch)
            out = attention_dispatch(
                "flash", q.contiguous(), k_cache.to(dtype),
                v_cache.to(dtype),
                q_positions=positions, kv_positions=kv_positions,
                causal=True, sliding_window=window,
                scale=cfg.attn_scale, logit_softcap=cfg.attn_softcap)
        else:
            out = dot_product_attention(
                q, k_cache.to(dtype), v_cache.to(dtype), masks[lp.kind],
                scale=cfg.attn_scale, logit_softcap=cfg.attn_softcap)
        h = _proj(out.reshape(B, T, H * hd), lp.wo, lr("wo"), lora_scale,
                  dtype)
        if cfg.post_block_norm:
            h = rms_norm(h, lp.attn_post_norm, eps=eps, scale_plus_one=sp1)
        x = x + h
        h = rms_norm(x, lp.mlp_norm, eps=eps, scale_plus_one=sp1)
        h = _mlp(h, lp, cfg, dtype, lora_p=lo, lora_scale=lora_scale)
        if cfg.post_block_norm:
            h = rms_norm(h, lp.mlp_post_norm, eps=eps, scale_plus_one=sp1)
        x = x + h

    return _unembed(x, params, cfg, dtype), cache


def as_device_ints(x, device: torch.device) -> torch.Tensor:
    """A numpy array, list or tensor as an int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


@torch.no_grad()
def greedy_generate_cached(params: Params, prompt, prompt_len,
                           cfg: ModelConfig, *,
                           max_new_tokens: int = 64,
                           eos_ids: Sequence[int] = (),
                           lora: Optional[Lora] = None,
                           lora_scale: float = 1.0,
                           device: DeviceLike = None) -> torch.Tensor:
    """Greedy decode with a KV cache: one prefill, then single-token
    steps. prompt: [B, L] right-padded buffer with L >= prompt_len +
    max_new_tokens; prompt_len: [B]. Returns the buffer with the
    generated tokens written after each prompt; finished rows (EOS
    emitted) stop growing. Runs on ``device`` (default ``cuda``), where
    the params must lie.

    The prefill width is rounded up to a 128 multiple (capped at L) so
    the flash gate engages; the garbage K/V it writes past prompt_len
    sit at positions above every query's until a decode step overwrites
    them. The JAX ``while_loop`` is a Python loop here."""
    dev = resolve_device(device)
    check_on(params.embed, dev, "params")
    prompt = as_device_ints(prompt, dev)
    prompt_len = as_device_ints(prompt_len, dev)
    B, L = prompt.shape
    Lp = max(L - max_new_tokens, 1)
    if L % 128 == 0 and Lp > 1:
        Lp = min(L, ((Lp + 127) // 128) * 128)
    eos = torch.tensor(list(eos_ids) or [-1], dtype=torch.int32, device=dev)

    cache = init_cache(cfg, B, L, device=dev)
    logits, cache = forward_step(
        params, prompt[:, :Lp].contiguous(), cfg, cache,
        torch.zeros((B,), dtype=torch.int32, device=dev),
        lora=lora, lora_scale=lora_scale)
    idx = (prompt_len - 1).clamp(0, Lp - 1).long()
    rows = torch.arange(B, device=dev)
    cur_tok = torch.argmax(logits[rows, idx], dim=-1).to(torch.int32)

    buf, lens = prompt.clone(), prompt_len.clone()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    cols = torch.arange(L, device=dev)[None, :]
    for _ in range(max_new_tokens):
        if bool(done.all()):
            break
        write_pos = lens.clamp(0, L - 1)
        buf = torch.where((~done)[:, None] & (cols == write_pos[:, None]),
                          cur_tok[:, None], buf)
        logits, cache = forward_step(params, cur_tok[:, None], cfg, cache,
                                     lens, lora=lora, lora_scale=lora_scale)
        next_tok = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        now_eos = torch.any(cur_tok[:, None] == eos[None, :], dim=-1)
        new_lens = torch.where(done | (lens >= L), lens, lens + 1)
        done = done | now_eos | (new_lens >= L)
        lens, cur_tok = new_lens, next_tok
    return buf
