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


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
          weights: Optional[torch.Tensor] = None) -> Routing:
    """Top-k routing, the Switch aux and the static-capacity positions
    (module docstring)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    C = expert_capacity(cfg, S)
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

    base = torch.zeros((B, 1, E), dtype=torch.int64, device=x.device)
    pos = []
    for k in range(K):
        oh = F.one_hot(expert[..., k], E)                       # [B, S, E]
        at = torch.cumsum(oh, dim=1) - 1 + base
        base = base + torch.sum(oh, dim=1, keepdim=True)
        pos.append(torch.gather(at, -1, expert[..., k:k + 1])[..., 0])
    pos = torch.stack(pos, dim=-1)
    return Routing(gate, expert, pos, pos < C, aux)


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu":
        return F.silu(g)
    if cfg.activation == "gelu_tanh":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown activation {cfg.activation}")


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up, w_down,
            cfg: ModelConfig, dtype: torch.dtype,
            weights: Optional[torch.Tensor] = None):
    """x ``[B, S, D]`` → (y ``[B, S, D]`` in ``dtype``, aux fp32 scalar).

    router_w ``[D, E]``; w_gate / w_up ``[E, D, F]``, w_down ``[E, F, D]``
    (tensors or ``QTensor``s). ``weights`` (optional ``[B, S]``, the loss
    weights): the aux balances the real tokens, not padding."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    C = expert_capacity(cfg, S)
    r = route(x, router_w, cfg, weights)
    gate = (r.gate * r.keep).to(dtype)                          # [B, S, K]
    live = gate > 0
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot = (r.expert * B + rows) * C + r.pos
    # an assignment not dispatched parks in a row of its own past the
    # E * B * C slots, so every index of the copy is distinct
    park = E * B * C + torch.arange(B * S * K, device=x.device).view(B, S, K)
    slot = torch.where(live, slot, park)
    xk = x.to(dtype)[:, :, None, :].expand(B, S, K, D).reshape(-1, D)
    buf = torch.zeros((E * B * C + B * S * K, D), dtype=dtype,
                      device=x.device).index_copy(0, slot.reshape(-1), xk)
    xin = buf[:E * B * C].view(E, B * C, D)
    del buf, xk
    g = torch.bmm(xin, maybe_dequantize(w_gate, dtype))
    u = torch.bmm(xin, maybe_dequantize(w_up, dtype))
    h = torch.bmm(_act(cfg, g) * u, maybe_dequantize(w_down, dtype))
    del g, u
    # a slot not dispatched reads row 0 under a gate of 0
    out = h.reshape(E * B * C, D).index_select(
        0, torch.where(live, slot, 0).reshape(-1)).view(B, S, K, D)
    y = out[:, :, 0].float() * gate[..., 0:1].float()
    for k in range(1, K):
        y = y + out[:, :, k].float() * gate[..., k:k + 1].float()
    return y.to(dtype), r.aux


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
