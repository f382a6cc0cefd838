"""Continuous-batching inference engine (counterpart of
``gke_ray_train_tpu/serve/engine.py``).

Iteration-level scheduling over length buckets:

- Every request is assigned the smallest declared bucket that fits
  ``prompt_len + max_new_tokens`` (serve/bucketing.py). Each bucket holds
  a pooled KV cache of ``[max_batch, bucket]`` and runs three step
  functions — ``prefill_step`` (``[1, L]``), ``decode_step``
  (``[max_batch, 1]``) and ``insert_slot``.
- Admission is slot-level: a finished sequence's slot is refilled at the
  next iteration (prefill the newcomer at batch 1, then copy its KV rows
  into the pool) without flushing the batch; the surviving sequences'
  K/V bytes are untouched.
- Where the JAX engine donates the batch state to its compiled steps,
  the port updates the state tensors in place.
- Multi-tenant serving: with ``adapters=`` (an ``AdapterPool``,
  serve/adapters.py) each request names its LoRA tenant
  (``Request.adapter_id``; None is the base model), and one decode step
  serves a mixed-tenant batch through ``ops/lora_batched.py``.
- Speculative decoding (``SPEC_DRAFT`` self / distilled, ``SPEC_K``): a
  draft model proposes ``spec_k`` tokens, one target forward verifies
  them, and greedy acceptance commits the longest agreeing prefix.
- Weights optionally serve quantized (``SERVE_QUANT``: int8 / nf4).
- On a model sharded across ranks every rank runs the same engine over
  the same requests; the picked tokens are agreed across the world, so
  the host-side scheduler decides alike on every rank (``BatchEngine``).

Sequential-equivalence contract: the per-slot update rule is exactly
``greedy_generate_cached``'s loop body, masked attention contributes
exact zeros for other slots' garbage (ops/attention.py NEG_INF
underflows), and prefill runs the full bucket width — which equals the
oracle's internal prefill width whenever the bucket is a 128-multiple
and ``max_new_tokens < 128``. So each completion is token-identical to a
batch-1 ``greedy_generate_cached`` run (with the request's adapter).

Not ported: AOT executable sidecars (eager PyTorch builds no
executables), CUDA graphs per bucket, decode cost reports and the
observability hooks (ROADMAP queue 1 items 7 and 9).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import (
    DeviceLike, check_on, resolve_device, synchronize)
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.kvcache import (
    forward_step, greedy_pick, init_cache, insert_cache_slot, model_shards)
from gke_ray_train_tpu_torch.models.transformer import Lora, Params
from gke_ray_train_tpu_torch.ops.quant import quantize_for_serving
from gke_ray_train_tpu_torch.parallel.sharding import is_sharded
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.serve.adapters import (
    AdapterPool, AdapterPoolPinned)
from gke_ray_train_tpu_torch.serve.bucketing import (
    form_prompt_buffer, pick_bucket, truncate_prompt)

logger = logging.getLogger(__name__)


def serve_plan(**overrides: Any) -> ExecutionPlan:
    """The serving plan: MAX_BATCH / DECODE_BUCKETS / PREFIX_CACHE /
    SERVE_QUANT / MAX_ADAPTERS / SPEC_DRAFT / SPEC_K from the
    environment, with kwarg overrides."""
    return ExecutionPlan.resolve(**overrides)


@dataclasses.dataclass
class Request:
    """One generation request; ``token_ids`` is the tokenized prompt.
    ``adapter_id``: the LoRA tenant that decodes it (None: the base
    model, the pool's zero adapter); needs an engine with an
    ``AdapterPool``."""
    rid: str
    token_ids: np.ndarray
    max_new_tokens: int = 32
    adapter_id: Optional[str] = None


@dataclasses.dataclass
class Completion:
    rid: str
    tokens: np.ndarray          # full row buffer [bucket] incl. prompt
    prompt_len: int
    length: int                 # prompt_len + generated count
    bucket: int
    finish_reason: str          # "eos" | "length"
    submit_s: float = 0.0
    first_token_s: float = 0.0  # submit -> first decoded token
    done_s: float = 0.0         # submit -> completion
    adapter_id: Optional[str] = None

    @property
    def generated(self) -> np.ndarray:
        """The generated region (includes the EOS token when one was
        produced, mirroring ``greedy_generate_cached``'s buffer)."""
        return self.tokens[self.prompt_len:self.length]


# ---------------------------------------------------------------------------
# the step bodies
# ---------------------------------------------------------------------------

def init_serve_state(cfg: ModelConfig, batch: int, width: int, *,
                     device: torch.device, multi_lora: bool = False,
                     draft_cfg: Optional[ModelConfig] = None,
                     model: int = 1,
                     layers: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed per-bucket batch state: token buffer, per-slot cursors and
    the pooled KV cache. ``active`` starts all-False — empty slots run
    the decode step as masked no-ops until admission fills them.

    ``multi_lora`` adds the per-slot adapter index ``aslot`` [B] (slot 0
    = the reserved zero adapter); ``draft_cfg`` adds the draft model's
    own KV pool ``dcache`` for speculative decoding. ``model``: the
    ways the served weights are split over tensor parallelism (the cache
    holds this rank's KV heads); ``layers``: the blocks the served model
    holds (a pipeline stage's; default every layer)."""
    def ints():
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    state = {
        "buf": torch.zeros((batch, width), dtype=torch.int32, device=device),
        "lens": ints(),
        "stop": ints(),
        "active": torch.zeros((batch,), dtype=torch.bool, device=device),
        "cur": ints(),
        "cache": init_cache(cfg, batch, width, device=device, model=model,
                            layers=layers),
    }
    if multi_lora:
        state["aslot"] = ints()
    if draft_cfg is not None:
        state["dcache"] = init_cache(draft_cfg, batch, width, device=device)
    return state


def _resolve_lora(state: Dict[str, Any], lora: Any, pool: bool) -> Any:
    """In pool mode the step's ``lora`` argument is the stacked pool;
    pair it with the state's per-slot adapter indices into the
    ``{"aslot", "blocks"}`` dict ``kvcache.forward_step`` gathers from."""
    if not pool or lora is None:
        return lora
    return {"aslot": state["aslot"], "blocks": lora}


def make_prefill_fn(cfg: ModelConfig, *, lora_scale: float = 1.0,
                    draft_cfg: Optional[ModelConfig] = None) -> Callable:
    """``prefill_step(params, prompt[1, L], prompt_len[1], lora) ->
    (first_tok[1], cache_row)`` — full-bucket-width prefill with lens=0:
    garbage K/V past the prompt sit at positions above every query's
    until decode overwrites them.

    With ``draft_cfg`` (speculative decoding) the signature grows a
    draft-params argument and the draft model's cache row rides along:
    ``spec_prefill(params, draft_params, prompt, prompt_len, lora) ->
    (first_tok, cache_row, dcache_row)``. The draft carries no adapters:
    it proposes, the (adapted) target disposes."""
    def target_prefill(params, prompt, prompt_len, lora):
        B, L = prompt.shape
        dev = prompt.device
        cache = init_cache(cfg, B, L, device=dev, model=model_shards(params),
                           layers=len(params.blocks))
        logits, cache = forward_step(
            params, prompt, cfg, cache,
            torch.zeros((B,), dtype=torch.int32, device=dev),
            lora=lora, lora_scale=lora_scale)
        idx = (prompt_len - 1).clamp(0, L - 1).long()
        rows = torch.arange(B, device=dev)
        first = greedy_pick(logits[rows, idx], params, cfg)
        return first, cache

    if draft_cfg is None:
        return target_prefill

    def spec_prefill_step(params, draft_params, prompt, prompt_len, lora):
        first, cache = target_prefill(params, prompt, prompt_len, lora)
        B, L = prompt.shape
        dev = prompt.device
        dcache = init_cache(draft_cfg, B, L, device=dev)
        forward_step(draft_params, prompt, draft_cfg, dcache,
                     torch.zeros((B,), dtype=torch.int32, device=dev))
        return first, cache, dcache
    return spec_prefill_step


def _eos_on(eos_host: np.ndarray, cache: Dict[torch.device, torch.Tensor],
            device: torch.device) -> torch.Tensor:
    eos = cache.get(device)
    if eos is None:
        eos = cache[device] = torch.as_tensor(eos_host, device=device)
    return eos


def make_decode_fn(cfg: ModelConfig, eos_ids: Sequence[int], *,
                   lora_scale: float = 1.0, pool: bool = False) -> Callable:
    """``decode_step(params, state, lora) -> state`` — one iteration for
    the whole slot batch, updating ``state`` in place. The per-slot rule
    is exactly ``greedy_generate_cached``'s loop body (write the pending
    token, forward one position, the greedy pick, advance), with the
    loop-count bound expressed as the per-slot absolute ``stop``
    position.

    ``pool=True`` (multi-tenant): ``lora`` is the stacked adapter pool
    and the state carries per-slot ``aslot`` indices, so one step decodes
    a mixed-tenant batch."""
    eos_host = np.asarray(list(eos_ids) or [-1], np.int32)
    eos_on: Dict[torch.device, torch.Tensor] = {}

    def decode_step(params, state, lora):
        buf, lens, stop = state["buf"], state["lens"], state["stop"]
        active, cur = state["active"], state["cur"]
        L = buf.shape[1]
        eos = _eos_on(eos_host, eos_on, buf.device)
        write_pos = lens.clamp(0, L - 1)
        cols = torch.arange(L, device=buf.device)[None, :]
        buf.copy_(torch.where(active[:, None] & (cols == write_pos[:, None]),
                              cur[:, None], buf))
        logits, _ = forward_step(params, cur[:, None], cfg, state["cache"],
                                 lens, lora=_resolve_lora(state, lora, pool),
                                 lora_scale=lora_scale)
        next_tok = greedy_pick(logits[:, 0, :], params, cfg)
        now_eos = torch.any(cur[:, None] == eos[None, :], dim=-1)
        new_lens = torch.where(~active | (lens >= L), lens, lens + 1)
        active &= ~now_eos & (new_lens < stop)
        lens.copy_(new_lens)
        cur.copy_(next_tok)
        return state
    return decode_step


def make_spec_decode_fn(cfg: ModelConfig, draft_cfg: ModelConfig,
                        eos_ids: Sequence[int], spec_k: int, *,
                        lora_scale: float = 1.0, pool: bool = False
                        ) -> Callable:
    """One speculative iteration, ``spec_decode(params, draft_params,
    state, lora) -> state`` (in place): the draft proposes ``spec_k``
    tokens by ``spec_k`` single-token steps on its own cache, the target
    verifies all ``spec_k + 1`` positions in one batched forward, and a
    vectorized greedy rule commits, per slot, the longest draft prefix
    the target agrees with plus the target's own next token.

    The committed stream is exactly what ``decode_step`` would produce: a
    draft token is consumed only when it equals the target's argmax given
    the same committed prefix; the first disagreement is replaced by the
    target's argmax and the rest is discarded (the cache rows it wrote
    are overwritten by the next iteration's ``spec_k + 1``-wide write
    before any query attends to them). The draft steers how many tokens
    commit per iteration, never which.

    Bucket headroom: the engine routes speculative requests with
    ``max_new_tokens + spec_k`` (``submit``), so every active slot has
    ``stop + spec_k <= width`` and the verify window never clamps into
    committed history. The verify forward (T = spec_k + 1, not a
    128-multiple) takes the dense attention path, the JAX gate."""
    eos_host = np.asarray(list(eos_ids) or [-1], np.int32)
    eos_on: Dict[torch.device, torch.Tensor] = {}
    K = int(spec_k)

    def spec_decode_step(params, draft_params, state, lora):
        buf, lens, stop = state["buf"], state["lens"], state["stop"]
        active, cur = state["active"], state["cur"]
        B, L = buf.shape
        dev = buf.device
        eos = _eos_on(eos_host, eos_on, dev)

        # draft: K sequential single-token proposals
        toks = [cur]
        pos = lens
        for _ in range(K):
            lg, _ = forward_step(draft_params, toks[-1][:, None], draft_cfg,
                                 state["dcache"], pos)
            toks.append(torch.argmax(lg[:, 0, :], dim=-1).to(torch.int32))
            pos = pos + 1
        # tokens_in[:, 0] is the committed pending token; 1..K the drafts
        tokens_in = torch.stack(toks, dim=1)                 # [B, K+1]

        # verify: one batched target forward over all K + 1
        logits, _ = forward_step(params, tokens_in, cfg, state["cache"],
                                 lens, lora=_resolve_lora(state, lora, pool),
                                 lora_scale=lora_scale)
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, K+1]

        # vectorized greedy acceptance
        match = (tokens_in[:, 1:] == tgt[:, :-1]).to(torch.int32)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)    # leading run
        consumed = accepted + 1                   # + the pending token
        # the sequential rule deactivates on the first consumed eos:
        # nothing after it may commit
        is_eos = torch.any(tokens_in[:, :, None] == eos[None, None, :],
                           dim=-1)
        has_eos = torch.any(is_eos, dim=1)
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
        eos_cut = torch.where(has_eos, first_eos + 1, K + 1)
        m = torch.minimum(torch.minimum(consumed, eos_cut), stop - lens)
        m = torch.where(active, m.clamp_min(0), 0)           # [B]

        rel = torch.arange(L, device=dev)[None, :] - lens[:, None]
        write = (rel >= 0) & (rel < m[:, None]) & active[:, None]
        vals = torch.gather(tokens_in, 1, rel.clamp(0, K))
        buf.copy_(torch.where(write, vals, buf))
        new_lens = lens + m
        consumed_eos = has_eos & (first_eos < m)
        # next pending token: the target's argmax after the last
        # committed token (the bonus token on full acceptance)
        nxt = torch.gather(tgt, 1, (m - 1).clamp(0, K)[:, None])[:, 0]
        cur.copy_(torch.where(active & (m > 0), nxt, cur))
        active &= ~consumed_eos & (new_lens < stop)
        lens.copy_(new_lens)
        return state
    return spec_decode_step


def make_insert_fn(*, multi_lora: bool = False, spec: bool = False
                   ) -> Callable:
    """``insert_slot(state, slot, cache_row, prompt_row, prompt_len, stop,
    first_tok[, dcache_row][, aslot]) -> state`` — admit one prefilled
    request into slot ``slot``, in place. ``spec`` adds the draft cache
    row, ``multi_lora`` the request's adapter slot index (both trailing,
    in that order). The cache rows are only read, so a memoized row can
    serve any number of slots."""
    def insert_slot(state, slot, cache_row, prompt_row, prompt_len, stop,
                    first_tok, *extra):
        insert_cache_slot(state["cache"], slot, cache_row)
        state["buf"][slot] = prompt_row[0]
        state["lens"][slot] = prompt_len[0]
        state["stop"][slot] = stop[0]
        state["active"][slot] = True
        state["cur"][slot] = first_tok[0]
        i = 0
        if spec:
            insert_cache_slot(state["dcache"], slot, extra[i])
            i += 1
        if multi_lora:
            state["aslot"][slot] = extra[i][0]
        return state
    return insert_slot


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    rid: str
    prompt_len: int
    submit_t: float
    first_token_t: float
    adapter_id: Optional[str] = None


class _BucketRuntime:
    """Per-bucket state + slot bookkeeping (the host-side half)."""

    def __init__(self, width: int, max_batch: int):
        self.width = width
        self.max_batch = max_batch
        self.state: Optional[Dict[str, Any]] = None   # device tensors
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.host_active = np.zeros((max_batch,), bool)
        self.decodes = 0            # decode iterations run so far
        # last fetched per-slot lens: the speculative acceptance ledger
        # is host arithmetic on the control tensors each step fetches
        self.prev_lens = np.zeros((max_batch,), np.int64)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def occupied(self) -> int:
        return sum(s is not None for s in self.slots)


def _check_sharded_plan(plan: ExecutionPlan) -> None:
    """Raise where the plan asks a sharded model for what only one card
    serves yet: a draft model, or quantized weights (``quantize_for_
    serving`` would quantize each rank's shards)."""
    for key, on in (("SPEC_DRAFT", plan.spec_draft != "none"),
                    ("SERVE_QUANT", plan.serve_quant != "none")):
        if on:
            raise NotImplementedError(
                f"{key} on a model sharded across ranks is not ported yet "
                "(ROADMAP queue 1 item 5, speculative and quantized "
                "serving on a sharded model); serve it on one card")


class BatchEngine:
    """The in-process continuous-batching engine.

    ``params`` is a ``Transformer`` on ``device`` (default ``cuda``; with
    no device given and no CUDA present the constructor raises);
    ``plan.serve_quant`` quantizes it at construction. Pass one adapter
    as ``lora`` (``interop.lora_from_numpy``), or a multi-tenant
    ``adapters=AdapterPool`` — not both. ``plan.spec_draft`` "self"
    drafts with the served weights themselves, "distilled" with
    ``draft=(draft_params, draft_cfg)``.

    On a model sharded across ranks (FSDP2 and / or ``model``) every
    rank runs its own engine over the same requests: the decode steps
    are collective, and since the picked tokens are agreed across the
    world (``models/kvcache.py::greedy_pick``) the host-side scheduler
    admits, refills and retires identically on every rank. The adapter
    pool is whole on every rank. ``SPEC_DRAFT`` and ``SERVE_QUANT``
    raise there."""

    _PREFIX_MEMO_MAX = 64

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 plan: Optional[ExecutionPlan] = None,
                 eos_ids: Sequence[int] = (),
                 lora: Optional[Lora] = None, lora_scale: float = 1.0,
                 adapters: Optional[AdapterPool] = None,
                 draft: Optional[Tuple[Params, ModelConfig]] = None,
                 device: DeviceLike = None,
                 heartbeat_fn: Optional[Callable[[int], None]] = None):
        self.device = resolve_device(device)
        check_on(params.embed, self.device, "params")
        self.plan = plan if plan is not None else serve_plan()
        self.cfg = cfg
        if is_sharded(params.embed):
            _check_sharded_plan(self.plan)
        self.params = quantize_for_serving(params, self.plan.serve_quant)
        # this rank's share of the KV heads (tensor parallelism) and of
        # the layers (a pipeline stage)
        self._kv_model = model_shards(params)
        self._kv_layers = len(params.blocks)
        if adapters is not None and lora is not None:
            raise ValueError(
                "pass either a single lora= adapter or a multi-tenant "
                "adapters= pool, not both")
        self.lora = lora
        self.pool = adapters
        self._pool_mode = adapters is not None
        self.eos_ids = tuple(int(e) for e in eos_ids)
        self.max_batch = self.plan.max_batch
        # speculative decoding: "self" drafts with the target's own
        # (already quantized) weights, the accept-all arm; "distilled"
        # takes a caller-provided small model
        self._draft: Optional[Tuple[Params, ModelConfig]] = None
        if self.plan.spec_draft == "self":
            self._draft = (self.params, cfg)
        elif self.plan.spec_draft == "distilled":
            if draft is None:
                raise ValueError(
                    "SPEC_DRAFT=distilled needs draft=(draft_params, "
                    "draft_cfg) — train side produces small configs")
            dparams, dcfg = draft
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size} — proposals must be target tokens")
            check_on(dparams.embed, self.device, "draft params")
            self._draft = (quantize_for_serving(
                dparams, self.plan.serve_quant), dcfg)
        self.spec_k = int(self.plan.spec_k) if self._draft else 0
        self.buckets = [b for b in self.plan.bucket_list()
                        if b <= cfg.max_seq_len
                        and (self._draft is None
                             or b <= self._draft[1].max_seq_len)]
        if not self.buckets:
            raise ValueError(
                f"no declared bucket {self.plan.bucket_list()} fits "
                f"max_seq_len={cfg.max_seq_len}")
        self._heartbeat = heartbeat_fn
        dcfg = self._draft[1] if self._draft else None
        self._prefill_fn = make_prefill_fn(cfg, lora_scale=lora_scale,
                                           draft_cfg=dcfg)
        if self._draft is not None:
            self._decode_fn = make_spec_decode_fn(
                cfg, dcfg, self.eos_ids, self.spec_k,
                lora_scale=lora_scale, pool=self._pool_mode)
        else:
            self._decode_fn = make_decode_fn(
                cfg, self.eos_ids, lora_scale=lora_scale,
                pool=self._pool_mode)
        self._insert_fn = make_insert_fn(multi_lora=self._pool_mode,
                                         spec=self._draft is not None)
        # whole-prompt prefix reuse (plan.prefix_cache): (bucket,
        # adapter, prompt_len, prompt-token hash) -> the prefill outputs;
        # bounded LRU
        self._prefix_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.prefix_hits = 0
        self.prefills = 0           # prefill_step executions
        self.spec_proposed = 0      # draft tokens offered to the target
        self.spec_accepted = 0      # draft tokens the target agreed with
        self._runtimes: Dict[int, _BucketRuntime] = {}
        self._pending: List[Request] = []
        self._pending_bucket: Dict[str, int] = {}
        self._completions: Dict[str, Completion] = {}
        self._submit_t: Dict[str, float] = {}
        self.iterations = 0
        self.refills = 0            # admissions into a non-fresh batch
        self.completed_total = 0
        # rolling windows, one entry per decode iteration
        self._token_latencies: Any = deque(maxlen=10_000)
        self._occupancy: Any = deque(maxlen=10_000)

    # -- the step functions' arguments ---------------------------------

    def _ints(self, *vals: int) -> torch.Tensor:
        return torch.tensor(vals, dtype=torch.int32, device=self.device)

    def _new_state(self, width: int) -> Dict[str, Any]:
        return init_serve_state(
            self.cfg, self.max_batch, width, device=self.device,
            multi_lora=self._pool_mode,
            draft_cfg=self._draft[1] if self._draft else None,
            model=self._kv_model, layers=self._kv_layers)

    def _decode_lora_arg(self) -> Any:
        """The ``lora`` argument of every decode call: the pool's stacked
        tensors (tenant churn writes them in place) or the one adapter."""
        return self.pool.blocks if self._pool_mode else self.lora

    def _prefill(self, width: int, buf: np.ndarray, plen: int,
                 aslot: int) -> tuple:
        lora_arg = self.lora
        if self._pool_mode:
            lora_arg = {"aslot": self._ints(aslot),
                        "blocks": self.pool.blocks}
        args = (self.params, torch.as_tensor(buf, device=self.device),
                self._ints(plen), lora_arg)
        if self._draft is not None:
            args = (args[0], self._draft[0]) + args[1:]
        return self._prefill_fn(*args)

    def _insert(self, state: Dict[str, Any], slot: int, out: tuple,
                buf: np.ndarray, plen: int, stop: int, aslot: int) -> None:
        extra = list(out[2:])       # the draft's cache row
        if self._pool_mode:
            extra.append(self._ints(aslot))
        self._insert_fn(state, slot, out[1],
                        torch.as_tensor(buf, device=self.device),
                        self._ints(plen), self._ints(stop), out[0], *extra)

    def _decode(self, state: Dict[str, Any]) -> None:
        if self._draft is not None:
            self._decode_fn(self.params, self._draft[0], state,
                            self._decode_lora_arg())
        else:
            self._decode_fn(self.params, state, self._decode_lora_arg())

    def set_heartbeat(self, fn: Optional[Callable[[int], None]]) -> None:
        """(Re)wire the per-iteration liveness beat, called with the
        iteration count after every ``step``."""
        self._heartbeat = fn

    @torch.no_grad()
    def warm_up(self, widths: Optional[Sequence[int]] = None) -> None:
        """Run one throwaway prefill, insert and decode per bucket on a
        scratch state, so that the first request does not pay for the
        allocator's first blocks and cuBLAS's first handles and
        heuristics. The JAX engine builds (or deserializes) its
        executables here; eager PyTorch has none to build. Counts nothing
        in :meth:`stats`."""
        for w in widths or self.buckets:
            state = self._new_state(w)
            buf = np.zeros((1, w), np.int32)
            out = self._prefill(w, buf, 1, 0)
            self._insert(state, 0, out, buf, 1, 2, 0)
            self._decode(state)
            del state, out
        synchronize(self.device)

    # -- request intake ------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; returns the bucket it will run in. Raises
        ValueError when no declared bucket fits (reject up front — a
        fixed-width bucket must never truncate silently)."""
        if request.rid in self._pending_bucket \
                or request.rid in self._completions:
            raise ValueError(f"request {request.rid}: rid already in "
                             "flight or unretrieved — rids must be "
                             "unique per engine")
        ids = np.asarray(request.token_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError(f"request {request.rid}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.rid}: max_new_tokens="
                             f"{request.max_new_tokens} must be >= 1")
        if request.adapter_id is not None and not self._pool_mode:
            raise ValueError(
                f"request {request.rid}: adapter_id="
                f"{request.adapter_id!r} but the engine has no adapter "
                "pool — construct BatchEngine(adapters=AdapterPool(...))")
        # speculative headroom: the verify window writes spec_k + 1 cache
        # positions from ``lens``, so the bucket must hold stop + spec_k:
        # route as if the request asked for max_new_tokens + spec_k
        budget = request.max_new_tokens + self.spec_k
        # reject before truncating: even a 1-token prompt cannot fit
        if budget + 1 > self.buckets[-1]:
            raise ValueError(
                f"request {request.rid}: max_new_tokens="
                f"{request.max_new_tokens}"
                + (f" + spec_k={self.spec_k}" if self.spec_k else "")
                + f" + a 1-token prompt needs {budget + 1} slots but "
                f"the largest usable bucket is {self.buckets[-1]} — "
                "lower max_new_tokens or declare a larger bucket")
        max_prompt = max(self.buckets[-1] - budget, 1)
        ids = truncate_prompt(ids, max_prompt,
                              label=f"request {request.rid} prompt")
        bucket = pick_bucket(len(ids), budget, self.buckets,
                             self.cfg.max_seq_len)
        request = dataclasses.replace(request, token_ids=ids)
        self._pending.append(request)
        self._pending_bucket[request.rid] = bucket
        self._submit_t[request.rid] = time.perf_counter()
        return bucket

    # -- the iteration loop --------------------------------------------

    def _admit(self) -> None:
        """Slot-level admission: fill every free slot whose bucket has a
        pending request — prefill at batch 1, insert into the pool."""
        still_pending: List[Request] = []
        for req in self._pending:
            width = self._pending_bucket[req.rid]
            rt = self._runtimes.get(width)
            if rt is None:
                rt = self._runtimes[width] = _BucketRuntime(
                    width, self.max_batch)
            free = rt.free_slots()
            if not free:
                still_pending.append(req)
                continue
            slot = free[0]
            aslot = 0
            if self._pool_mode:
                # resolve (and pin) the tenant before any state work: a
                # pool with every slot pinned is transient (requests
                # retire), so the request stays queued and retries
                try:
                    aslot = self.pool.acquire(req.adapter_id)
                except AdapterPoolPinned:
                    still_pending.append(req)
                    continue
            if rt.state is None:
                rt.state = self._new_state(width)
            elif rt.occupied() > 0 and rt.decodes > 0:
                # a true mid-batch refill: decode already ran for this
                # batch and other sequences are live
                self.refills += 1
            buf, plen = form_prompt_buffer(req.token_ids, width)
            stop = min(plen + req.max_new_tokens, width)
            out = self._prefill_outputs(req, width, buf, plen, aslot)
            # the first token exists once prefill has run on the device;
            # a stamp at enqueue time would not be time-to-first-token
            synchronize(self.device)
            self._insert(rt.state, slot, out, buf, plen, stop, aslot)
            rt.slots[slot] = _Slot(req.rid, plen, self._submit_t[req.rid],
                                   time.perf_counter(),
                                   adapter_id=req.adapter_id)
            rt.host_active[slot] = True
            rt.prev_lens[slot] = plen
        self._pending = still_pending

    def _prefill_outputs(self, req: Request, width: int, buf: np.ndarray,
                         plen: int, aslot: int) -> tuple:
        """Run (or reuse) the batch-1 prefill for one admission:
        ``(first_tok, cache_row[, dcache_row])``.

        Prefix reuse (plan.prefix_cache) memoizes whole post-truncation
        prompts by token hash per (bucket, tenant); replaying a memoized
        row through the insert step is the cold prefill by construction —
        the same tensors go in."""
        key = None
        if self.plan.prefix_cache:
            digest = hashlib.sha1(
                np.ascontiguousarray(buf).tobytes()).hexdigest()
            # plen rides in the key: a prompt that ends in token id 0
            # pads to the same buffer as a shorter one
            key = (width, req.adapter_id or "", int(plen), digest)
            hit = self._prefix_memo.get(key)
            if hit is not None:
                self._prefix_memo.move_to_end(key)
                self.prefix_hits += 1
                return hit
        out = self._prefill(width, buf, plen, aslot)
        self.prefills += 1
        if key is not None:
            self._prefix_memo[key] = out
            while len(self._prefix_memo) > self._PREFIX_MEMO_MAX:
                self._prefix_memo.popitem(last=False)
        return out

    def _collect(self, rt: _BucketRuntime, active: np.ndarray,
                 lens: np.ndarray, buf: np.ndarray) -> None:
        """Retire slots that went inactive this iteration."""
        now = time.perf_counter()
        for i, slot in enumerate(rt.slots):
            if slot is None or active[i]:
                continue
            row = np.array(buf[i])
            length = int(lens[i])
            gen = row[slot.prompt_len:length]
            reason = ("eos" if self.eos_ids and len(gen)
                      and int(gen[-1]) in self.eos_ids else "length")
            self._completions[slot.rid] = Completion(
                rid=slot.rid, tokens=row, prompt_len=slot.prompt_len,
                length=length, bucket=rt.width, finish_reason=reason,
                submit_s=slot.submit_t,
                first_token_s=slot.first_token_t - slot.submit_t,
                done_s=now - slot.submit_t, adapter_id=slot.adapter_id)
            if self._pool_mode:
                # unpin the tenant: its slot becomes evictable once no
                # in-flight request decodes against it
                self.pool.release(slot.adapter_id)
            rt.slots[i] = None
            rt.host_active[i] = False
            self.completed_total += 1
            self._submit_t.pop(slot.rid, None)
            self._pending_bucket.pop(slot.rid, None)

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit into free slots, then run ONE
        decode step per live bucket. Returns the number of slots still
        active plus pending requests (0 = drained)."""
        self._admit()
        total_active = 0
        for rt in self._runtimes.values():
            if rt.occupied() == 0:
                continue
            t0 = time.perf_counter()
            self._decode(rt.state)
            rt.decodes += 1
            # ONE fetch of the small control tensors per iteration (it
            # also waits for the step); buf only when a slot finished
            ctrl = torch.stack([rt.state["active"].to(torch.int32),
                                rt.state["lens"]]).cpu().numpy()
            active, lens = ctrl[0].astype(bool), ctrl[1]
            dt = time.perf_counter() - t0
            n_act = int(np.sum(rt.host_active))
            if self.spec_k:
                # acceptance ledger from the lens deltas just fetched:
                # each previously active slot was offered spec_k drafts
                # and committed (delta - 1) of them (the + 1 is the
                # target's own token)
                was = rt.host_active
                deltas = lens.astype(np.int64)[was] - rt.prev_lens[was]
                self.spec_proposed += self.spec_k * n_act
                self.spec_accepted += int(
                    np.clip(deltas - 1, 0, self.spec_k).sum())
            rt.prev_lens = lens.astype(np.int64)
            self._token_latencies.append(dt)
            self._occupancy.append(n_act / self.max_batch)
            total_active += int(np.sum(active))
            if bool(np.any(rt.host_active & ~active)):
                self._collect(rt, active, lens,
                              rt.state["buf"].cpu().numpy())
        self.iterations += 1
        if self._heartbeat is not None:
            try:
                self._heartbeat(self.iterations)
            except Exception as e:  # noqa: BLE001 - liveness best-effort
                logger.debug("serve heartbeat dropped: %s", e)
        return total_active + len(self._pending)

    def run_until_drained(self, requests: Sequence[Request] = ()
                          ) -> List[Completion]:
        """Submit ``requests`` and iterate until every queued request
        completed; returns (and releases) the completions in submit
        order."""
        for r in requests:
            self.submit(r)
        want = [r.rid for r in requests]
        while self.step() > 0:
            pass
        if want:
            return [self._completions.pop(rid) for rid in want]
        out = list(self._completions.values())
        self._completions.clear()
        return out

    def completion(self, rid: str) -> Optional[Completion]:
        return self._completions.get(rid)

    # -- reporting -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Iteration count, batch occupancy and the per-token latency
        distribution (one decode iteration produces one token per active
        slot, so the iteration latency is the per-token latency); the
        prefix, speculation and adapter counters when those are on."""
        lat = sorted(self._token_latencies)

        def pct(p):
            if not lat:
                return 0.0
            return lat[min(int(p / 100.0 * len(lat)), len(lat) - 1)]

        out = {
            "iterations": self.iterations,
            "refills": self.refills,
            "prefills": self.prefills,
            "completed": self.completed_total,
            "pending": len(self._pending),
            "batch_occupancy": (float(np.mean(self._occupancy))
                                if self._occupancy else 0.0),
            "p50_token_latency_s": pct(50),
            "p99_token_latency_s": pct(99),
            "plan_fingerprint": self.plan.fingerprint(),
        }
        if self.plan.prefix_cache:
            out["prefix_hits"] = self.prefix_hits
        if self.spec_k:
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
        if self._pool_mode:
            out.update(self.pool.stats())
        return out


def post_train_smoke(params: Params, cfg: ModelConfig, plan: ExecutionPlan,
                     prompt_ids: Sequence[np.ndarray], *,
                     eos_ids: Sequence[int] = (),
                     lora: Optional[Lora] = None, lora_scale: float = 1.0,
                     adapter_ids: Optional[Sequence[Optional[str]]] = None,
                     max_new_tokens: int = 32,
                     device: DeviceLike = None
                     ) -> Optional[Tuple[List[Completion], Dict[str, Any]]]:
    """The ``SERVE_AFTER_TRAIN`` hook the entry calls after training: the
    given tokenized prompts through a fresh engine on the just-trained
    weights, on ``device`` (default ``cuda``). With ``lora`` and
    ``adapter_ids`` tags the tagged prompts are served through a real
    ``AdapterPool`` in which every tag maps to ``lora``, so the batched
    multi-tenant path runs end to end. Returns (completions, stats), or
    None with a loud warning when no declared bucket fits the model, no
    prompt is usable, or serving fails: a smoke must degrade, not kill a
    finished training run.

    On a model sharded across ranks the smoke is collective: every rank
    calls it with the same prompts and runs the engine (``BatchEngine``
    doc); rank 0 returns (completions, stats), the others None. There a
    failure is raised, not degraded: a rank that gave up alone would
    leave its peers waiting in a collective."""
    usable = [b for b in plan.bucket_list() if b <= cfg.max_seq_len]
    if not usable:
        logger.warning(
            "SERVE_AFTER_TRAIN skipped: no declared bucket %s fits "
            "max_seq_len=%d (set DECODE_BUCKETS)", plan.bucket_list(),
            cfg.max_seq_len)
        return None
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompt_ids]
    prompts = [p for p in prompts if p.size]
    if not prompts:
        logger.warning("SERVE_AFTER_TRAIN skipped: no non-empty prompts")
        return None
    # the budget must fit the declared buckets: a smoke clamps rather
    # than crash
    max_new_tokens = min(max_new_tokens, max(usable[-1] - 1, 1))
    tags: List[Optional[str]] = list(adapter_ids or [])
    tags += [None] * (len(prompts) - len(tags))
    lora_kw: Dict[str, Any] = {"lora": lora, "lora_scale": lora_scale}
    sharded = is_sharded(params.embed)
    t0 = time.perf_counter()
    try:
        if lora is not None and any(t is not None for t in tags):
            pool = AdapterPool.from_template(
                lora, max_adapters=max(plan.max_adapters,
                                       len({t for t in tags if t})))
            for aid in sorted({t for t in tags if t}):
                pool.register(aid, lora)
            lora_kw = {"adapters": pool, "lora_scale": lora_scale}
        elif lora is None:
            tags = [None] * len(prompts)
        engine = BatchEngine(params, cfg, plan=plan, eos_ids=eos_ids,
                             device=device, **lora_kw)
        comps = engine.run_until_drained([
            Request(rid=f"smoke{i}", token_ids=p,
                    max_new_tokens=max_new_tokens, adapter_id=tags[i])
            for i, p in enumerate(prompts)])
    except Exception:  # noqa: BLE001 - the degrade contract above
        if sharded:
            raise
        logger.warning("SERVE_AFTER_TRAIN failed; training output is "
                       "unaffected", exc_info=True)
        return None
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            return None
    stats = engine.stats()
    stats["wall_s"] = round(time.perf_counter() - t0, 3)
    stats["generated_tokens"] = int(
        sum(c.length - c.prompt_len for c in comps))
    stats["adapter_requests"] = sum(1 for t in tags if t is not None)
    logger.info(
        "SERVE_AFTER_TRAIN: %d request(s) -> %d tokens in %.2fs "
        "(occupancy %.2f, p50 %.1fms/token, plan %s)",
        len(comps), stats["generated_tokens"], stats["wall_s"],
        stats["batch_occupancy"], stats["p50_token_latency_s"] * 1e3,
        stats["plan_fingerprint"])
    return comps, stats
