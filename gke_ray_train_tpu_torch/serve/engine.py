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

Sequential-equivalence contract: the per-slot update rule is exactly
``greedy_generate_cached``'s loop body, masked attention contributes
exact zeros for other slots' garbage (ops/attention.py NEG_INF
underflows), and prefill runs the full bucket width — which equals the
oracle's internal prefill width whenever the bucket is a 128-multiple
and ``max_new_tokens < 128``. So each completion is token-identical to a
batch-1 ``greedy_generate_cached`` run.

Not ported yet: speculative decoding, the multi-tenant adapter pool,
quantized serving weights, AOT executable sidecars, decode cost reports
and the observability hooks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import (
    DeviceLike, check_on, resolve_device, synchronize)
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.kvcache import (
    forward_step, init_cache, insert_cache_slot)
from gke_ray_train_tpu_torch.models.transformer import Lora, Params
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.serve.bucketing import (
    form_prompt_buffer, pick_bucket, truncate_prompt)

logger = logging.getLogger(__name__)


def serve_plan(**overrides: Any) -> ExecutionPlan:
    """The serving plan: MAX_BATCH / DECODE_BUCKETS / PREFIX_CACHE from
    the environment, with kwarg overrides."""
    return ExecutionPlan.resolve(**overrides)


@dataclasses.dataclass
class Request:
    """One generation request; ``token_ids`` is the tokenized prompt."""
    rid: str
    token_ids: np.ndarray
    max_new_tokens: int = 32


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

    @property
    def generated(self) -> np.ndarray:
        """The generated region (includes the EOS token when one was
        produced, mirroring ``greedy_generate_cached``'s buffer)."""
        return self.tokens[self.prompt_len:self.length]


# ---------------------------------------------------------------------------
# the step bodies
# ---------------------------------------------------------------------------

def init_serve_state(cfg: ModelConfig, batch: int, width: int, *,
                     device: torch.device) -> Dict[str, Any]:
    """Zeroed per-bucket batch state: token buffer, per-slot cursors and
    the pooled KV cache. ``active`` starts all-False — empty slots run
    the decode step as masked no-ops until admission fills them."""
    def ints():
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    return {
        "buf": torch.zeros((batch, width), dtype=torch.int32, device=device),
        "lens": ints(),
        "stop": ints(),
        "active": torch.zeros((batch,), dtype=torch.bool, device=device),
        "cur": ints(),
        "cache": init_cache(cfg, batch, width, device=device),
    }


def make_prefill_fn(cfg: ModelConfig, *, lora_scale: float = 1.0
                    ) -> Callable:
    """``prefill_step(params, prompt[1, L], prompt_len[1], lora) ->
    (first_tok[1], cache_row)`` — full-bucket-width prefill with lens=0:
    garbage K/V past the prompt sit at positions above every query's
    until decode overwrites them."""
    def prefill_step(params, prompt, prompt_len, lora):
        B, L = prompt.shape
        dev = prompt.device
        cache = init_cache(cfg, B, L, device=dev)
        logits, cache = forward_step(
            params, prompt, cfg, cache,
            torch.zeros((B,), dtype=torch.int32, device=dev),
            lora=lora, lora_scale=lora_scale)
        idx = (prompt_len - 1).clamp(0, L - 1).long()
        rows = torch.arange(B, device=dev)
        first = torch.argmax(logits[rows, idx], dim=-1).to(torch.int32)
        return first, cache
    return prefill_step


def make_decode_fn(cfg: ModelConfig, eos_ids: Sequence[int], *,
                   lora_scale: float = 1.0) -> Callable:
    """``decode_step(params, state, lora) -> state`` — one iteration for
    the whole slot batch, updating ``state`` in place. The per-slot rule
    is exactly ``greedy_generate_cached``'s loop body (write the pending
    token, forward one position, argmax, advance), with the loop-count
    bound expressed as the per-slot absolute ``stop`` position."""
    eos_host = np.asarray(list(eos_ids) or [-1], np.int32)
    eos_on: Dict[torch.device, torch.Tensor] = {}

    def decode_step(params, state, lora):
        buf, lens, stop = state["buf"], state["lens"], state["stop"]
        active, cur = state["active"], state["cur"]
        L = buf.shape[1]
        eos = eos_on.get(buf.device)
        if eos is None:
            eos = eos_on[buf.device] = torch.as_tensor(eos_host,
                                                       device=buf.device)
        write_pos = lens.clamp(0, L - 1)
        cols = torch.arange(L, device=buf.device)[None, :]
        buf.copy_(torch.where(active[:, None] & (cols == write_pos[:, None]),
                              cur[:, None], buf))
        logits, _ = forward_step(params, cur[:, None], cfg, state["cache"],
                                 lens, lora=lora, lora_scale=lora_scale)
        next_tok = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        now_eos = torch.any(cur[:, None] == eos[None, :], dim=-1)
        new_lens = torch.where(~active | (lens >= L), lens, lens + 1)
        active &= ~now_eos & (new_lens < stop)
        lens.copy_(new_lens)
        cur.copy_(next_tok)
        return state
    return decode_step


def make_insert_fn() -> Callable:
    """``insert_slot(state, slot, cache_row, prompt_row, prompt_len, stop,
    first_tok) -> state`` — admit one prefilled request into slot
    ``slot``, in place. The cache row is only read, so a memoized row
    can serve any number of slots."""
    def insert_slot(state, slot, cache_row, prompt_row, prompt_len, stop,
                    first_tok):
        insert_cache_slot(state["cache"], slot, cache_row)
        state["buf"][slot] = prompt_row[0]
        state["lens"][slot] = prompt_len[0]
        state["stop"][slot] = stop[0]
        state["active"][slot] = True
        state["cur"][slot] = first_tok[0]
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


class _BucketRuntime:
    """Per-bucket state + slot bookkeeping (the host-side half)."""

    def __init__(self, width: int, max_batch: int):
        self.width = width
        self.max_batch = max_batch
        self.state: Optional[Dict[str, Any]] = None   # device tensors
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.host_active = np.zeros((max_batch,), bool)
        self.decodes = 0            # decode iterations run so far

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def occupied(self) -> int:
        return sum(s is not None for s in self.slots)


class BatchEngine:
    """The in-process continuous-batching engine.

    ``params`` is a ``Transformer`` on ``device`` (default ``cuda``; with
    no device given and no CUDA present the constructor raises). ``lora``
    is an optional single adapter (``interop.lora_from_numpy``)."""

    _PREFIX_MEMO_MAX = 64

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 plan: Optional[ExecutionPlan] = None,
                 eos_ids: Sequence[int] = (),
                 lora: Optional[Lora] = None, lora_scale: float = 1.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on(params.embed, self.device, "params")
        self.plan = plan if plan is not None else serve_plan()
        self.cfg = cfg
        self.params = params
        self.lora = lora
        self.eos_ids = tuple(int(e) for e in eos_ids)
        self.max_batch = self.plan.max_batch
        self.buckets = [b for b in self.plan.bucket_list()
                        if b <= cfg.max_seq_len]
        if not self.buckets:
            raise ValueError(
                f"no declared bucket {self.plan.bucket_list()} fits "
                f"max_seq_len={cfg.max_seq_len}")
        self._prefill_fn = make_prefill_fn(cfg, lora_scale=lora_scale)
        self._decode_fn = make_decode_fn(cfg, self.eos_ids,
                                         lora_scale=lora_scale)
        self._insert_fn = make_insert_fn()
        # whole-prompt prefix reuse (plan.prefix_cache): (bucket,
        # prompt_len, prompt-token hash) -> (first token, cache row);
        # bounded LRU
        self._prefix_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.prefix_hits = 0
        self.prefills = 0           # prefill_step executions
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
        budget = request.max_new_tokens
        # reject before truncating: even a 1-token prompt cannot fit
        if budget + 1 > self.buckets[-1]:
            raise ValueError(
                f"request {request.rid}: max_new_tokens="
                f"{request.max_new_tokens} + a 1-token prompt needs "
                f"{budget + 1} slots but the largest usable bucket is "
                f"{self.buckets[-1]} — lower max_new_tokens or declare a "
                "larger bucket")
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

    def _ints(self, *vals: int) -> torch.Tensor:
        return torch.tensor(vals, dtype=torch.int32, device=self.device)

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
            if rt.state is None:
                rt.state = init_serve_state(self.cfg, self.max_batch, width,
                                            device=self.device)
            elif rt.occupied() > 0 and rt.decodes > 0:
                # a true mid-batch refill: decode already ran for this
                # batch and other sequences are live
                self.refills += 1
            buf, plen = form_prompt_buffer(req.token_ids, width)
            stop = min(plen + req.max_new_tokens, width)
            first, cache_row = self._prefill_outputs(width, buf, plen)
            # the first token exists once prefill has run on the device;
            # a stamp at enqueue time would not be time-to-first-token
            synchronize(self.device)
            self._insert_fn(rt.state, slot, cache_row,
                            torch.as_tensor(buf, device=self.device),
                            self._ints(plen), self._ints(stop), first)
            rt.slots[slot] = _Slot(req.rid, plen, self._submit_t[req.rid],
                                   time.perf_counter())
            rt.host_active[slot] = True
        self._pending = still_pending

    def _prefill_outputs(self, width: int, buf: np.ndarray,
                         plen: int) -> tuple:
        """Run (or reuse) the batch-1 prefill for one admission:
        ``(first_tok, cache_row)``.

        Prefix reuse (plan.prefix_cache) memoizes whole post-truncation
        prompts by token hash per bucket; replaying a memoized row through
        the insert step is the cold prefill by construction — the same
        tensors go in."""
        key = None
        if self.plan.prefix_cache:
            digest = hashlib.sha1(
                np.ascontiguousarray(buf).tobytes()).hexdigest()
            # plen rides in the key: a prompt that ends in token id 0
            # pads to the same buffer as a shorter one
            key = (width, int(plen), digest)
            hit = self._prefix_memo.get(key)
            if hit is not None:
                self._prefix_memo.move_to_end(key)
                self.prefix_hits += 1
                return hit
        out = self._prefill_fn(self.params,
                               torch.as_tensor(buf, device=self.device),
                               self._ints(plen), self.lora)
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
                done_s=now - slot.submit_t)
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
            self._decode_fn(self.params, rt.state, self.lora)
            rt.decodes += 1
            # ONE fetch of the small control tensors per iteration (it
            # also waits for the step); buf only when a slot finished
            ctrl = torch.stack([rt.state["active"].to(torch.int32),
                                rt.state["lens"]]).cpu().numpy()
            active, lens = ctrl[0].astype(bool), ctrl[1]
            dt = time.perf_counter() - t0
            n_act = int(np.sum(rt.host_active))
            self._token_latencies.append(dt)
            self._occupancy.append(n_act / self.max_batch)
            total_active += int(np.sum(active))
            if bool(np.any(rt.host_active & ~active)):
                self._collect(rt, active, lens,
                              rt.state["buf"].cpu().numpy())
        self.iterations += 1
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
        slot, so the iteration latency is the per-token latency)."""
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
        return out
