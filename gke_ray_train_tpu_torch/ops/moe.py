"""Mixture-of-Experts MLP (counterpart of ``gke_ray_train_tpu/ops/moe.py``).

Routing is fp32 end to end: logits ``x @ router``, a softmax over the
experts, the top k, and Mixtral's renormalisation over the chosen k. The
Switch load-balance aux is ``E * sum_e f_e * p_e`` (first-choice share
times mean router probability), with weighted means when ``weights`` is
given; all-zero weights give 0.

Static capacity with GShard's drop rule, as the JAX package has it: an
expert takes at most ``C = expert_capacity(cfg, S)`` tokens per batch
row; slot k's positions come after all of slot k-1's; positions count
per (row, expert) by a cumsum along the sequence; an assignment at or
beyond C is dropped (the token keeps its other slots' outputs, or only
the residual).

Over a ``context`` axis (the sequence cut into C shards, ``mesh=``) the
row is the whole sequence, as in JAX: ``S`` in the capacity is the global
length, and a position is what the whole-row cumsum gives it. Within
slot k a rank's tokens come after the lower context ranks' ones, and all
of slot k after all of slot k-1: one all-gather of each rank's counts
per (row, slot, expert) gives the base each rank adds to its own cumsum.
A rank's expert buffer has the whole row's capacity (its tokens take
their global positions in it).

Expert parallelism (the banks sharded on the expert dim over ``model``,
``parallel/sharding.py``): the input, replicated over ``model``, is
routed whole on every rank, so every rank makes the same decisions; a
rank dispatches only the assignments of its ``E / model`` experts (the
others park, as an undispatched one does) into ``[E / model, B, C, D]``,
runs its local banks, and combines its partial ``y`` in fp32. The
partials are summed over ``model`` in fp32 (at Mixtral's top 2, at most
two nonzero terms: the sum is exact) and rounded once, where JAX's
combine einsum over a sharded ``e`` rounds. The dispatched input and the
per-slot gate enter through ``copy_to_model``: their gradients are
summed over the group, so the router's gradient is whole and the same on
every model rank, and the routing's own share of the input's gradient is
counted once.

Where JAX forms one-hot ``[B, S, E, C]`` dispatch and combine tensors and
contracts them in einsums (a TPU idiom), ``moe_mlp`` moves tokens with
index ops. Every kept assignment owns a distinct slot ``(e, b, c)`` of
the expert buffer ``[E, B, C, D]``: ``index_copy`` places the tokens
there (its backward is a gather), and the combine gathers each token's
K slot outputs and sums them in slot order in fp32, never by atomics, so
a recomputed block and a resumed run give the same bits. Every shape is
fixed by (B, S, E, C, K): no ``nonzero``, no mask indexing, no host read.

Rounding points are JAX's: the per-slot gate rounds once to ``dtype``
(an assignment whose gate rounds to 0 is not dispatched, as JAX's
``combine > 0``); the expert input, gate, up and ``h`` round to
``dtype`` after fp32 accumulation; ``y`` accumulates in fp32 and rounds
once. The expert FFN is three batched matmuls over the expert dim, the
banks dequantized at use (``ops/quant.py::maybe_dequantize``).
``moe_mlp_onehot`` is the JAX einsum form, kept as the tests' reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.ops.quant import maybe_dequantize
from gke_ray_train_tpu_torch.parallel.mesh import context_group
from gke_ray_train_tpu_torch.parallel.tensor import (
    copy_to_model, local_weight, reduce_from_model, tp_of)


def expert_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Static per-row expert capacity, padded to a multiple of 8."""
    c = int(cfg.capacity_factor * cfg.expert_top_k * seq_len
            / cfg.n_experts)
    return max(8 * ((c + 7) // 8), 8)


class Routing(NamedTuple):
    """The router's decision for x ``[B, S, D]``, per token and slot k
    ``[B, S, K]``: ``gate`` (fp32, renormalised), ``expert`` and ``pos``
    (int64, the position in that expert's buffer of the row) and
    ``keep`` (``pos < C``); and the scalar ``aux``."""
    gate: torch.Tensor
    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor


def _group_size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def _gather_counts(counts: torch.Tensor, group) -> torch.Tensor:
    """Every context rank's ``counts`` ``[B, K, E]`` (int64, no
    gradient) in rank order, ``[C, B, K, E]``; staged through host
    memory where gloo holds CUDA tensors (``ops/ring_attention.py``)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops.ring_attention import (
        _from_host, _staged, _to_host)
    n = dist.get_world_size(group)
    host = _staged(group, counts)
    src = _to_host([counts])[0] if host else counts.contiguous()
    # stacked on dim 0, as gloo's all_gather_into_tensor wants it
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device, pin_memory=host)
    dist.all_gather_into_tensor(out, src, group=group)
    out = out.view(n, *src.shape)
    return _from_host(out, counts.device) if host else out


def slot_counts(expert: torch.Tensor, E: int) -> torch.Tensor:
    """The assignments of ``expert`` ``[B, S, K]`` per (row, slot,
    expert), ``[B, K, E]`` int64."""
    return torch.sum(F.one_hot(expert, E), dim=1)


def slot_positions(expert: torch.Tensor, E: int, before: torch.Tensor,
                   total: torch.Tensor) -> torch.Tensor:
    """Each assignment's position in its expert's buffer of the row,
    ``[B, S, K]``, for the tokens ``expert`` of one shard of the row:
    slot k after all of slots < k of the whole row (``total``, the
    row's :func:`slot_counts`), and after the lower shards' slot k
    (``before``, their counts summed)."""
    base = torch.zeros_like(total[:, 0])                        # [B, E]
    pos = []
    for k in range(expert.shape[-1]):
        oh = F.one_hot(expert[..., k], E)                       # [B, S, E]
        at = torch.cumsum(oh, dim=1) - 1 + (base + before[:, k])[:, None]
        base = base + total[:, k]
        pos.append(torch.gather(at, -1, expert[..., k:k + 1])[..., 0])
    return torch.stack(pos, dim=-1)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
          weights: Optional[torch.Tensor] = None,
          context=None) -> Routing:
    """Top-k routing, the Switch aux and the static-capacity positions
    (module docstring). ``context``: the process group of the context
    ranks whose shards of the sequence ``x`` [B, S/C, D] is one of; the
    capacity and positions are then the whole row's (the aux stays this
    shard's mean)."""
    import torch.distributed as dist
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    C = expert_capacity(cfg, S * _group_size(context))
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    first = F.one_hot(expert[..., 0], E).float()
    if weights is None:
        f_e = torch.mean(first, dim=(0, 1))
        p_e = torch.mean(probs, dim=(0, 1))
    else:
        w = weights.float()[..., None]
        wsum = torch.clamp(torch.sum(w), min=1e-9)
        f_e = torch.sum(first * w, dim=(0, 1)) / wsum
        p_e = torch.sum(probs * w, dim=(0, 1)) / wsum
    aux = E * torch.sum(f_e * p_e)

    counts = slot_counts(expert, E)
    if context is None:
        total, before = counts, torch.zeros_like(counts)
    else:
        every = _gather_counts(counts, context)              # [C, B, K, E]
        total = torch.sum(every, dim=0)
        before = torch.sum(every[:dist.get_rank(context)], dim=0)
    pos = slot_positions(expert, E, before, total)
    return Routing(gate, expert, pos, pos < C, aux)


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu":
        return F.silu(g)
    if cfg.activation == "gelu_tanh":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown activation {cfg.activation}")


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up, w_down,
            cfg: ModelConfig, dtype: torch.dtype,
            weights: Optional[torch.Tensor] = None, *, mesh=None):
    """x ``[B, S, D]`` → (y ``[B, S, D]`` in ``dtype``, aux fp32 scalar).

    router_w ``[D, E]``; w_gate / w_up ``[E, D, F]``, w_down ``[E, F, D]``
    (tensors or ``QTensor``s; under expert parallelism a gathered unit's
    DTensors of the ``model`` submesh, of which this rank's experts are
    used). ``weights`` (optional ``[B, S]``, the loss weights): the aux
    balances the real tokens, not padding. ``mesh``: its ``context``
    axis, when above 1, makes ``x`` this rank's shard of the sequence."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    context = context_group(mesh)
    C = expert_capacity(cfg, S * _group_size(context))
    tp = tp_of(w_gate)
    n_local = E // (1 if tp is None else tp.size)
    first = 0 if tp is None else tp.rank * n_local
    r = route(x, local_weight(router_w), cfg, weights, context=context)
    gate = copy_to_model((r.gate * r.keep).to(dtype), tp)       # [B, S, K]
    live = gate.detach() > 0
    if tp is not None:
        mine = (r.expert >= first) & (r.expert < first + n_local)
        live = live & mine
        gate = torch.where(mine, gate, torch.zeros_like(gate))
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot = ((r.expert - first) * B + rows) * C + r.pos
    # an assignment not dispatched here parks in a row of its own past
    # the n_local * B * C slots, so every index of the copy is distinct
    park = n_local * B * C + torch.arange(B * S * K, device=x.device).view(
        B, S, K)
    slot = torch.where(live, slot, park)
    xk = copy_to_model(x, tp).to(dtype)[:, :, None, :].expand(
        B, S, K, D).reshape(-1, D)
    buf = torch.zeros((n_local * B * C + B * S * K, D), dtype=dtype,
                      device=x.device).index_copy(0, slot.reshape(-1), xk)
    xin = buf[:n_local * B * C].view(n_local, B * C, D)
    del buf, xk
    g = torch.bmm(xin, maybe_dequantize(local_weight(w_gate), dtype))
    u = torch.bmm(xin, maybe_dequantize(local_weight(w_up), dtype))
    h = torch.bmm(_act(cfg, g) * u,
                  maybe_dequantize(local_weight(w_down), dtype))
    del g, u
    # a slot not dispatched here reads row 0 under a gate of 0
    out = h.reshape(n_local * B * C, D).index_select(
        0, torch.where(live, slot, 0).reshape(-1)).view(B, S, K, D)
    y = out[:, :, 0].float() * gate[..., 0:1].float()
    for k in range(1, K):
        y = y + out[:, :, k].float() * gate[..., k:k + 1].float()
    return reduce_from_model(y, tp).to(dtype), r.aux


def moe_mlp_onehot(x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up,
                   w_down, cfg: ModelConfig, dtype: torch.dtype,
                   weights: Optional[torch.Tensor] = None):
    """``moe_mlp`` in the JAX package's form: one-hot ``[B, S, E, C]``
    combine and dispatch tensors contracted in einsums, fp32 accumulation
    rounded once each. The tests' reference for the index-op route."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    C = expert_capacity(cfg, S)
    r = route(x, router_w, cfg, weights)
    f32 = torch.float32
    combine = torch.zeros((B, S, E, C), dtype=dtype, device=x.device)
    for k in range(K):
        oh = F.one_hot(r.expert[..., k], E).to(f32)             # [B, S, E]
        slot = F.one_hot(r.pos[..., k].clamp(0, C - 1), C).to(dtype)
        val = (r.keep[..., k].to(f32) * r.gate[..., k]).to(dtype)
        combine = combine + slot[:, :, None, :] * (
            oh.to(dtype) * val[..., None])[..., None]
    dispatch = (combine > 0).to(dtype)

    def ein(eq, a, b):
        return torch.einsum(eq, a.to(f32), b.to(f32))

    xin = ein("bsec,bsd->ebcd", dispatch, x.to(dtype)).to(dtype)
    g = ein("ebcd,edf->ebcf", xin, maybe_dequantize(w_gate, dtype)).to(dtype)
    u = ein("ebcd,edf->ebcf", xin, maybe_dequantize(w_up, dtype)).to(dtype)
    h = ein("ebcf,efd->ebcd", _act(cfg, g) * u,
            maybe_dequantize(w_down, dtype)).to(dtype)
    y = ein("bsec,ebcd->bsd", combine, h)
    return y.to(dtype), r.aux
