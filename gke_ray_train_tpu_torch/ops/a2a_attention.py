"""All-to-all (Ulysses) context parallelism: the second context-parallel
attention next to ring attention (counterpart of
``gke_ray_train_tpu/ops/a2a_attention.py``).

Where the ring keeps the queries and rotates K/V C - 1 hops, this form
redistributes once: an all-to-all over the context group trades the
sequence sharding for a head sharding (``[B, S/C, h, dh] -> [B, S, h/C,
dh]``: every rank then holds the whole sequence of h/C of its heads),
one call of the flash kernels (``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` through ``ops/flash_attention.py``) runs there
with the plain causal / packed mask over the all-gathered positions and
segment ids, and the inverse all-to-all brings the output home. Two
collectives in place of C - 1 rotations.

The all-to-all is a ``torch.autograd.Function`` over the context group,
as ``parallel/tensor.py`` writes its own: :class:`_AllToAll`, its
backward the inverse all-to-all. The positions and segment ids are
all-gathered (:func:`_gather_seq`); they carry no gradient. Under gloo
CUDA tensors are staged through page-locked host memory
(``ops/ring_attention.py::TRANSPORT``).

:func:`a2a_supported` is JAX's predicate (:35-44): C must divide the
rank's head counts (``H / model`` and ``K / model``), so the GQA groups
nest inside the head chunks; ``ops/dispatch.py`` falls back to the ring
where it does not.
"""

from __future__ import annotations

from typing import Optional

import torch

from gke_ray_train_tpu_torch.ops import flash_attention as fa


def a2a_supported(mesh, n_heads: int, n_kv_heads: int) -> bool:
    """True when the ``context`` axis divides this rank's head counts
    (``n_heads`` / ``n_kv_heads`` are the local ones: under tensor
    parallelism already ``/ model``); False without a mesh."""
    from gke_ray_train_tpu_torch.parallel.mesh import context_size
    if mesh is None:
        return False
    C = context_size(mesh)
    return n_heads % C == 0 and n_kv_heads % C == 0


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` [C, ...]: chunk i goes to context
    rank i, chunk j of the result came from rank j."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops.ring_attention import (
        TRANSPORT, _from_host, _host_like, _staged, _to_host)
    host = _staged(group, x)
    src = _to_host([x])[0] if host else x.contiguous()
    out = _host_like(src) if host else torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    TRANSPORT["last"] = "host" if host else "direct"
    return _from_host(out, x.device) if host else out


def heads_to_seq(x: torch.Tensor, group, C: int) -> torch.Tensor:
    """[B, S/C, h, dh] -> [B, S, h/C, dh]: head chunk c stays on context
    rank c, the sequence chunks arrive in rank order (JAX's tiled
    ``all_to_all(split_axis=2, concat_axis=1)``)."""
    B, s, h, dh = x.shape
    parts = x.reshape(B, s, C, h // C, dh).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, group)      # [C (seq chunk), B, s, h/C, dh]
    return got.permute(1, 0, 2, 3, 4).reshape(B, C * s, h // C, dh)


def seq_to_heads(x: torch.Tensor, group, C: int) -> torch.Tensor:
    """The inverse: [B, S, h/C, dh] -> [B, S/C, h, dh]."""
    B, S, hc, dh = x.shape
    parts = x.reshape(B, C, S // C, hc, dh).permute(1, 0, 2, 3, 4)
    got = _all_to_all(parts, group)      # [C (head chunk), B, S/C, h/C, dh]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // C, C * hc, dh)


class _AllToAll(torch.autograd.Function):
    """:func:`heads_to_seq` (``to_seq``) or :func:`seq_to_heads`; the
    gradient goes back through the other."""

    @staticmethod
    def forward(ctx, x, group, C, to_seq):
        ctx.group, ctx.C, ctx.to_seq = group, C, to_seq
        return (heads_to_seq if to_seq else seq_to_heads)(x, group, C)

    @staticmethod
    def backward(ctx, g):
        back = seq_to_heads if ctx.to_seq else heads_to_seq
        return back(g.contiguous(), ctx.group, ctx.C), None, None, None


def _gather_seq(x: torch.Tensor, group, C: int) -> torch.Tensor:
    """[B, S/C] -> [B, S]: the shards of every context rank in rank order
    (JAX's tiled ``all_gather(axis=1)``), for the integer positions and
    segment ids, which carry no gradient."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops.ring_attention import (
        _from_host, _staged, _to_host)
    host = _staged(group, x)
    src = _to_host([x])[0] if host else x.contiguous()
    # [C * B, S/C]: the shards stacked on dim 0, in rank order
    out = torch.empty((C * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device, pin_memory=host)
    dist.all_gather_into_tensor(out, src, group=group)
    out = out.reshape(C, *src.shape).transpose(0, 1).reshape(
        x.shape[0], C * x.shape[1], *x.shape[2:])
    return _from_host(out, x.device) if host else out


def a2a_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mesh, q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  q_segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  sliding_window: Optional[int] = None,
                  scale: Optional[float] = None,
                  logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention on this rank's shards, with the
    contract of ``ring_attention``: q [B, S/C, H, dh], k / v [B, S/C, K,
    dh], positions and segment ids [B, S/C] (positions default to this
    rank's slice of ``arange(S)``); returns out [B, S/C, H, dh]. Raises
    where C does not divide H and K (use the ring)."""
    from gke_ray_train_tpu_torch.ops.ring_attention import _vec
    from gke_ray_train_tpu_torch.parallel.mesh import (
        context_group, context_rank, context_size)
    if mesh is None:
        raise ValueError("a2a attention needs a mesh with a context axis")
    B, s, H, dh = q.shape
    K = k.shape[2]
    C = context_size(mesh)
    if not a2a_supported(mesh, H, K):
        raise ValueError(
            f"context axis {C} does not divide the local head counts "
            f"(H={H}, K={K}); use attn_impl='ring'")
    dev = q.device
    qp = _vec(q_positions, B, s, "arange", dev, context_rank(mesh) * s)
    qs = _vec(q_segment_ids, B, s, "ones", dev)
    group = context_group(mesh)
    if C == 1:
        return fa.flash_attention(
            q, k, v, q_positions=qp, kv_positions=kv_positions,
            q_segment_ids=qs, kv_segment_ids=kv_segment_ids, causal=causal,
            sliding_window=sliding_window, scale=scale,
            logit_softcap=logit_softcap)
    # the model passes one positions / segments tensor for q and kv:
    # gathered once
    qp_all = _gather_seq(qp, group, C)
    qs_all = _gather_seq(qs, group, C)
    kp_all, ks_all = qp_all, qs_all
    if kv_positions is not None and kv_positions is not q_positions:
        kp_all = _gather_seq(_vec(kv_positions, B, s, "", dev), group, C)
    if kv_segment_ids is not None and kv_segment_ids is not q_segment_ids:
        ks_all = _gather_seq(_vec(kv_segment_ids, B, s, "", dev), group, C)
    out = fa.flash_attention(
        _AllToAll.apply(q, group, C, True),
        _AllToAll.apply(k, group, C, True),
        _AllToAll.apply(v, group, C, True),
        q_positions=qp_all, kv_positions=kp_all, q_segment_ids=qs_all,
        kv_segment_ids=ks_all, causal=causal,
        sliding_window=sliding_window, scale=scale,
        logit_softcap=logit_softcap)
    return _AllToAll.apply(out, group, C, False)
