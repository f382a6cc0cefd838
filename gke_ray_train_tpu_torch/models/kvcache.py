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
- On a model sharded as it was trained (``parallel/sharding.py``: FSDP2
  units over ``fsdp``, DTensors over ``model``) every rank of the mesh
  runs the same generate: each unit is gathered around its use, a
  rank computes on its ``n_heads / model`` query and ``n_kv_heads /
  model`` KV heads (so the flash prefill runs on the local heads), the
  greedy pick is an argmax over the sharded vocab, and the picked tokens
  are agreed across the world, so every rank stops at the same step.
- On a pipelined mesh (``pipe`` above 1) a rank holds its stage's
  layers and caches those only; a step visits the stages one after
  another (JAX's decode has no pipe schedule either: GSPMD runs it on
  the pipe-sharded stack): the first stage embeds, each hop runs its
  layers and sends ``[B, T, D]`` to the next (``models/pipeline.py::
  run_hops``), the last applies the final norm and head, takes the
  argmax, and its tokens are broadcast to the world.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike, check_on, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, Params, _lora_entry, _mlp, _proj, _unembed, embed_tokens,
    head_tp, layer_ids, lora_of_layers, position_inputs, rope_table,
    torch_dtype)
from gke_ray_train_tpu_torch.ops.attention import (
    dot_product_attention, make_attention_mask)
from gke_ray_train_tpu_torch.ops.norms import rms_norm
from gke_ray_train_tpu_torch.ops.rope import apply_rope
from gke_ray_train_tpu_torch.parallel.sharding import is_sharded, release_root
from gke_ray_train_tpu_torch.parallel.tensor import (
    copy_to_model, reduce_from_model, tp_of, vocab_parallel_argmax)

Cache = Dict[str, torch.Tensor]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None, model: int = 1,
               layers: Optional[int] = None) -> Cache:
    """Zeroed cache in the compute dtype: ``{"k", "v"}`` of
    [layers, batch, max_len, n_kv_heads / model, head_dim]; ``model``
    the ways the served weights are split over tensor parallelism
    (:func:`model_shards`), each rank caching its own KV heads;
    ``layers`` the blocks the model holds (default ``n_layers``; a
    pipeline stage's, ``len(params.blocks)``), in their order."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    if cfg.n_kv_heads % model:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} does not split "
                         f"over model={model}")
    shape = (cfg.n_layers if layers is None else layers, batch, max_len,
             cfg.n_kv_heads // model, cfg.resolved_head_dim)
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


@dataclasses.dataclass
class _Step:
    """What every layer of one ``forward_step`` shares."""
    cfg: ModelConfig
    dtype: torch.dtype
    cache: Cache
    lens: torch.Tensor
    positions: torch.Tensor
    kv_positions: torch.Tensor
    rope: Optional[torch.Tensor]
    masks: Dict[str, torch.Tensor]
    use_flash: bool
    lora_scale: float


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
           positions: torch.Tensor, dtype: torch.dtype):
    """The root's part before the blocks: ``(x, rope)``."""
    return position_inputs(cfg, embed_tokens(params, tokens, cfg, dtype),
                           positions)


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
          dtype: torch.dtype) -> torch.Tensor:
    """The root's part after the blocks: the logits (under TP of this
    rank's vocab shard)."""
    return _unembed(x, params, cfg, dtype)


def _stage_step(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                step: "_Step", layer: Callable, mesh) -> torch.Tensor:
    """A pipeline stage's part of one ``forward_step``, run inside one
    call of the root (``models/pipeline.py::run_hops``): the first stage
    embeds, every stage runs its hops' layers, the last applies the
    final norm and the head. The logits on the last stage; an empty
    ``[B, T, 0]`` elsewhere (a stage that holds no vocab shard)."""
    from gke_ray_train_tpu_torch.models import pipeline as pl
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_rank, pipe_size
    B, T = tokens.shape
    dev = tokens.device
    x = None
    if pipe_rank(mesh) == 0:
        x = _embed(params, tokens, cfg, positions=step.positions,
                   dtype=step.dtype)[0]
    like = torch.empty((B, T, cfg.d_model), dtype=step.dtype, device=dev)
    x = pl.run_hops(cfg, mesh, x, like, len(params.blocks), layer)
    if pipe_rank(mesh) == pipe_size(mesh) - 1:
        return _head(params, x, cfg, dtype=step.dtype)
    return torch.empty((B, T, 0), dtype=torch.float32, device=dev)


def _through_root(params: Params, fn, x, cfg: ModelConfig, **kw):
    """``fn(params, x, cfg, **kw)`` through the root's ``__call__``, so a
    sharded root gathers its weights (embedding, final norm, head) around
    it, and frees them after (FSDP2 keeps a root gathered after its
    forward, for a backward a decode never runs)."""
    out = params(x, cfg, step_fn=fn, **kw)
    release_root(params)
    return out


def _decode_layer(x: torch.Tensor, lp, lo, s: _Step, i: int
                  ) -> torch.Tensor:
    """Layer ``i`` of one decode step over ``x``, its K/V written into
    the cache. Under tensor parallelism ``lp``'s gathered weights are
    DTensors of the ``model`` submesh and the layer runs on this rank's
    heads (read from the local widths, as ``_attn`` reads them): the
    column-parallel projections behind ``copy_to_model``, ``wo`` and the
    MLP's ``w_down`` followed by ``reduce_from_model``."""
    cfg, dtype = s.cfg, s.dtype
    B, T, _ = x.shape
    eps, sp1 = cfg.norm_eps, cfg.norm_scale_plus_one
    hd = cfg.resolved_head_dim
    tp = tp_of(lp.wq)

    def proj(h, name, bias=None):
        return _proj(h, getattr(lp, name), _lora_entry(lo, name, tp),
                     s.lora_scale, dtype, bias=bias)

    h = copy_to_model(rms_norm(x, lp.attn_norm, eps=eps,
                               scale_plus_one=sp1), tp)
    q = proj(h, "wq", lp.bq).reshape(B, T, -1, hd)
    k = proj(h, "wk", lp.bk).reshape(B, T, -1, hd)
    v = proj(h, "wv", lp.bv).reshape(B, T, -1, hd)
    if s.rope is not None:
        q = apply_rope(q, s.positions, s.rope)
        k = apply_rope(k, s.positions, s.rope)
    k_cache = _scatter_rows(s.cache["k"][i], k, s.lens)
    v_cache = _scatter_rows(s.cache["v"][i], v, s.lens)
    window = cfg.sliding_window if lp.kind == "sliding" else None
    if s.use_flash:
        from gke_ray_train_tpu_torch.ops.dispatch import attention_dispatch
        out = attention_dispatch(
            "flash", q.contiguous(), k_cache.to(dtype), v_cache.to(dtype),
            q_positions=s.positions, kv_positions=s.kv_positions,
            causal=True, sliding_window=window, scale=cfg.attn_scale,
            logit_softcap=cfg.attn_softcap)
    else:
        out = dot_product_attention(
            q, k_cache.to(dtype), v_cache.to(dtype), s.masks[lp.kind],
            scale=cfg.attn_scale, logit_softcap=cfg.attn_softcap)
    h = reduce_from_model(proj(out.reshape(B, T, -1), "wo"), tp)
    if cfg.post_block_norm:
        h = rms_norm(h, lp.attn_post_norm, eps=eps, scale_plus_one=sp1)
    x = x + h
    h = rms_norm(x, lp.mlp_norm, eps=eps, scale_plus_one=sp1)
    if cfg.n_experts:
        # the routed expert MLP; its load-balance aux is a training
        # loss term, dropped at inference. Capacity is per call:
        # routing is drop-free, and decode equals a full recompute,
        # only with ample capacity_factor (JAX's rule)
        from gke_ray_train_tpu_torch.ops import moe
        h, _ = moe.moe_mlp(h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
                           cfg, dtype)
    else:
        h = _mlp(h, lp, cfg, dtype, lora_p=lo, lora_scale=s.lora_scale)
    if cfg.post_block_norm:
        h = rms_norm(h, lp.mlp_post_norm, eps=eps, scale_plus_one=sp1)
    return x + h


def forward_step(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 cache: Cache, lens: torch.Tensor, *,
                 lora: Optional[Union[Lora, Dict[str, Any]]] = None,
                 lora_scale: float = 1.0) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, T] at per-row absolute positions lens + arange(T) →
    (logits [B, T, vocab] float32, the cache updated in place). Under
    tensor parallelism the logits are this rank's vocab shard
    ``[B, T, vocab / model]`` (:func:`greedy_pick` takes the global
    argmax) and the cache holds this rank's KV heads.

    ``lora``: one adapter (``lora[i][name] = {"a", "b"}``), or in
    multi-tenant serving ``{"aslot": [B] int32, "blocks": pool}`` with
    the stacked pool of ``serve/adapters.py``, from which each row's
    adapter is gathered layer by layer (``ops/lora_batched.py``).

    Each layer runs through ``Block.__call__`` and the embedding and
    head through the root's, so a model sharded with FSDP2 gathers one
    unit's weights around its use and frees them after (no second whole
    copy of the model); every rank of its mesh must make the same call.

    On a pipeline stage (``models/pipeline.py::stage_mesh``) the cache
    holds the stage's layers, the step is one trip through the stages
    (:func:`_stage_step`) and the logits are the last stage's: the
    other stages return ``[B, T, 0]``, and :func:`greedy_pick` agrees
    the tokens from the last stage."""
    from gke_ray_train_tpu_torch.models.pipeline import stage_mesh
    pool = aslot = None
    if isinstance(lora, dict) and "aslot" in lora:
        pool, aslot, lora = lora["blocks"], lora["aslot"], None
    # the adapters of the layers the model holds (a pipeline stage's)
    if pool is not None:
        pool = lora_of_layers(pool, layer_ids(params))
    if lora is not None:
        lora = lora_of_layers(lora, layer_ids(params))
    B, T = tokens.shape
    dev = params.embed.device
    check_on(tokens, dev, "tokens")
    dtype = torch_dtype(cfg.dtype)
    max_len = cache["k"].shape[2]

    positions = lens.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=dev)[None, :]
    mesh = stage_mesh(params)
    rope = rope_table(cfg, dev)
    if mesh is None:
        x = _through_root(params, _embed, tokens, cfg,
                          positions=positions, dtype=dtype)[0]

    kv_positions = torch.arange(max_len, dtype=torch.int32,
                                device=dev).expand(B, max_len)
    impl = cfg.resolved_attn_impl(dev)
    # ring/a2a are training-time context-parallel strategies; decode is
    # device-local (a context rank holds whole prompts and replicated
    # weights), so they run plain flash here, as in the JAX package
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
    step = _Step(cfg=cfg, dtype=dtype, cache=cache, lens=lens,
                 positions=positions, kv_positions=kv_positions, rope=rope,
                 masks=masks, use_flash=use_flash, lora_scale=lora_scale)

    def layer(x, i):
        if pool is not None:
            from gke_ray_train_tpu_torch.ops.lora_batched import gather_pool
            lo = gather_pool(pool[i], aslot)
        else:
            lo = lora[i] if lora is not None else None
        return params.blocks[i](x, lo, step, i, layer_fn=_decode_layer)

    if mesh is not None:
        return _through_root(params, _stage_step, tokens, cfg, step=step,
                             layer=layer, mesh=mesh), cache
    for i in range(len(params.blocks)):
        x = layer(x, i)
    return _through_root(params, _head, x, cfg, dtype=dtype), cache


def model_shards(params: Params) -> int:
    """The ways ``params``' heads are split over ``model`` (1 without
    tensor parallelism): a rank's cache holds ``n_kv_heads /`` this."""
    tp = tp_of(params.blocks[0].wk)
    return 1 if tp is None else tp.size


def greedy_pick(logits: torch.Tensor, params: Params,
                cfg: ModelConfig) -> torch.Tensor:
    """The greedy token [...] int32 of ``logits`` [..., vocab or its
    shard]: under tensor parallelism the argmax over the sharded vocab
    (``parallel/tensor.py::vocab_parallel_argmax``); on a sharded model
    then agreed across the world (rank 0's broadcast), so every rank
    writes, stops and admits on the same tokens and no rank leaves a
    loop its peers are still in. On a pipeline stage only the last
    stage has logits: it takes the argmax (over its model group) and
    its first rank's tokens are broadcast to the world
    (``models/pipeline.py::token_source``); the other stages' logits
    are the empty ``[..., 0]`` of :func:`forward_step`."""
    from gke_ray_train_tpu_torch.models import pipeline as pl
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_rank, pipe_size
    mesh = pl.stage_mesh(params)
    if pipe_rank(mesh) == pipe_size(mesh) - 1:
        tok = vocab_parallel_argmax(logits, head_tp(params, cfg)).to(
            torch.int32)
    else:
        tok = torch.empty(logits.shape[:-1], dtype=torch.int32,
                          device=logits.device)
    if is_sharded(params.embed):
        import torch.distributed as dist
        if dist.get_world_size() > 1:
            dist.broadcast(tok, src=0 if mesh is None
                           else pl.token_source(mesh))
    return tok


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
    them. The JAX ``while_loop`` is a Python loop here. On a sharded
    model every rank calls with the same prompt and returns the same
    buffer (module doc)."""
    dev = resolve_device(device)
    check_on(params.embed, dev, "params")
    prompt = as_device_ints(prompt, dev)
    prompt_len = as_device_ints(prompt_len, dev)
    B, L = prompt.shape
    Lp = max(L - max_new_tokens, 1)
    if L % 128 == 0 and Lp > 1:
        Lp = min(L, ((Lp + 127) // 128) * 128)
    eos = torch.tensor(list(eos_ids) or [-1], dtype=torch.int32, device=dev)

    cache = init_cache(cfg, B, L, device=dev, model=model_shards(params),
                       layers=len(params.blocks))
    logits, cache = forward_step(
        params, prompt[:, :Lp].contiguous(), cfg, cache,
        torch.zeros((B,), dtype=torch.int32, device=dev),
        lora=lora, lora_scale=lora_scale)
    idx = (prompt_len - 1).clamp(0, Lp - 1).long()
    rows = torch.arange(B, device=dev)
    cur_tok = greedy_pick(logits[rows, idx], params, cfg)

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
        next_tok = greedy_pick(logits[:, 0, :], params, cfg)
        now_eos = torch.any(cur_tok[:, None] == eos[None, :], dim=-1)
        new_lens = torch.where(done | (lens >= L), lens, lens + 1)
        done = done | now_eos | (new_lens >= L)
        lens, cur_tok = new_lens, next_tok
    return buf
