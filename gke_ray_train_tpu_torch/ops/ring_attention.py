"""Ring attention: context-parallel flash attention over the ``context``
mesh axis (counterpart of ``gke_ray_train_tpu/ops/ring_attention.py``).

Each rank holds its batch rows, its ``S / C`` tokens of every sequence
(C the context size) and, under tensor parallelism, its heads
(``ops/dispatch.py``'s contract). Queries stay put; the K/V shards
rotate one hop around the ring of context ranks each step, their
positions and segment ids travelling with them, so causality and
packing masks are exact across shard boundaries.

- The forward (JAX :69-87): C steps of the flash forward kernel
  (``csrc/flash_fwd.cu`` through ``ops/flash_attention.py``) on the
  local queries against the visiting shard, merged by an online
  logsumexp (:func:`merge`, plain PyTorch as JAX's ``_merge`` is plain
  ``jnp``), with exactly C - 1 rotations.
- The backward (:93-134) is one ``torch.autograd.Function`` over the
  whole ring: a second ring of the dQ and dK/dV kernels
  (``csrc/flash_bwd.cu``), given the final lse and ``dvec = rowsum(dO *
  O)`` of the final output, computed once. ``p = exp(s - lse)`` is then
  exactly the visiting shard's slice of the global softmax, so the
  shards' gradients sum to the total: dQ accumulates here, dK and dV
  accumulate on buffers that rotate with their shard and land back on
  their owner after the full circle.

A shard wholly in the future of the local queries (rank 0's queries
against rank 1's K/V under causality) is dead in every tile: the forward
gives out 0 and lse NEG_INF there, which the merge weighs 0, and the
backward kernels write zeros.

The transport (:func:`rotate`, on :func:`send_recv`, which the pipeline
stages share, ``models/pipeline.py``) is one ``batch_isend_irecv`` over the
context group: send to ``(c + 1) % C``, receive from ``(c - 1) % C``.
Under gloo (several ranks of one card) CUDA tensors are staged through
page-locked host memory (:data:`TRANSPORT` reports which). Every
collective runs on the context group only, in the same order on every
rank, so it interleaves with FSDP2's on the fsdp group; under remat the
recomputed forward runs its ring again.

On the CPU (tests) each step runs the kernels' plain versions
(``flash_attention_reference``, ``flash_attention_bwd_reference``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from gke_ray_train_tpu_torch.ops import flash_attention as fa

# how the last rotation moved its tensors: "direct" (the backend took
# them where they lie) or "host" (gloo: CUDA tensors staged through host
# memory)
TRANSPORT = {"last": None}


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of ``group`` on ``t`` stages through host
    memory: gloo on CUDA tensors."""
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of the CUDA tensors ``xs`` in page-locked host memory, the
    copies waited for (gloo reads a buffer as soon as it is handed it)."""
    out = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
        x, non_blocking=True) for x in xs]
    torch.cuda.current_stream(xs[0].device).synchronize()
    return out


def _host_like(x: torch.Tensor) -> torch.Tensor:
    """An empty page-locked host tensor of ``x``'s shape and dtype."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _from_host(h: torch.Tensor, device) -> torch.Tensor:
    """A page-locked host tensor on ``device``, copied on the current
    stream without waiting (the host allocator keeps ``h`` until the
    copy is done)."""
    return h.to(device, non_blocking=True)


def send_recv(sends: List[torch.Tensor], dst: int,
              recv_like: List[torch.Tensor], src: int,
              group) -> List[torch.Tensor]:
    """One ``batch_isend_irecv`` over ``group``: ``sends`` to group rank
    ``dst``, and one tensor shaped as each of ``recv_like`` (dtype and
    device too) from group rank ``src``, returned; either list may be
    empty. Under gloo CUDA tensors are staged through page-locked host
    memory. The ``i``-th send meets the peer's ``i``-th receive."""
    import torch.distributed as dist
    ref = (sends or recv_like or [None])[0]
    if ref is None:
        return []
    host = _staged(group, ref)
    sends = [x.detach().contiguous() for x in sends]
    if host and sends:
        sends = _to_host(sends)
    recvs = [_host_like(x) if host else torch.empty(
        x.shape, dtype=x.dtype, device=x.device) for x in recv_like]
    to = dist.get_global_rank(group, dst)
    frm = dist.get_global_rank(group, src)
    ops = [dist.P2POp(dist.isend, x, to, group, tag=i)
           for i, x in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, x, frm, group, tag=i)
            for i, x in enumerate(recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    TRANSPORT["last"] = "host" if host else "direct"
    if host:
        recvs = [_from_host(r, x.device) for r, x in zip(recvs, recv_like)]
    return recvs


def rotate(xs: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor of ``xs`` one hop around the ring of ``group``: this
    rank's goes to the next context rank, and the previous one's is
    returned in its place (JAX's ``ppermute`` of ``_rotate``)."""
    import torch.distributed as dist
    C = dist.get_world_size(group)
    c = dist.get_rank(group)
    return send_recv(xs, (c + 1) % C, xs, (c - 1) % C, group)


def merge(o_acc: torch.Tensor, lse_acc: torch.Tensor, o_i: torch.Tensor,
          lse_i: torch.Tensor):
    """The online logsumexp merge of two normalized partials (JAX
    ``_merge``): o [B, S, H, dh] fp32, lse [B, H, S]. A row that attends
    nothing carries the finite NEG_INF, so the weights stay finite."""
    lse_new = torch.logaddexp(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_i = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    return o_acc * w_acc + o_i * w_i, lse_new


def _shard_grads(q, k, v, out, lse, g, dvec, qp, kp, qs, ks, kw):
    """dq, dk, dv of the local queries against one K/V shard, from the
    final out, lse and dvec: the dQ and dK/dV kernels on the card, their
    plain version on the CPU (which forms the same dvec from out)."""
    if q.device.type == "cpu":
        return fa.flash_attention_bwd_reference(
            q, k, v, out, lse, g, qp, kp, qs, ks, **kw)
    fa._check_kernel_inputs(q, k, v, g)
    args = (q, k, v, g, lse, dvec, qp, kp, qs, ks)
    dq = fa.flash_bwd_dq(*args, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    return dq, dk, dv


def _ring_forward(q, k, v, qp, kp, qs, ks, kw, group, size):
    out, lse = fa._forward(q, k, v, qp, kp, qs, ks, kw)
    o = out.float()
    kc, vc, kpc, ksc = k, v, kp, ks
    for _ in range(size - 1):
        kc, vc, kpc, ksc = rotate([kc, vc, kpc, ksc], group)
        o_i, lse_i = fa._forward(q, kc, vc, qp, kpc, qs, ksc, kw)
        o, lse = merge(o, lse, o_i.float(), lse_i)
    return o.to(q.dtype), lse


class RingAttention(torch.autograd.Function):
    """The whole ring, forward and backward (JAX ``ring`` /
    ``ring_fwd`` / ``ring_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, qp, kp, qs, ks, kw, group, size):
        out, lse = _ring_forward(q, k, v, qp, kp, qs, ks, kw, group, size)
        ctx.save_for_backward(q, k, v, out, lse, qp, kp, qs, ks)
        ctx.kw, ctx.group, ctx.size = kw, group, size
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, qp, kp, qs, ks = ctx.saved_tensors
        kw, group, size = ctx.kw, ctx.group, ctx.size
        g = g.to(q.dtype).contiguous()
        # D_i = rowsum(dO * O) of the final output, shard-invariant:
        # formed once, [B, H, S] fp32 like lse
        dvec = torch.sum(g.float() * out.float(), dim=-1).transpose(
            1, 2).contiguous()
        dq, dk, dv = _shard_grads(q, k, v, out, lse, g, dvec, qp, kp, qs,
                                  ks, kw)
        dq, dk, dv = dq.float(), dk.float(), dv.float()
        kc, vc, kpc, ksc = k, v, kp, ks
        for _ in range(size - 1):
            # the visiting shard and its gradient buffers move together
            kc, vc, kpc, ksc, dk, dv = rotate([kc, vc, kpc, ksc, dk, dv],
                                              group)
            dq_i, dk_i, dv_i = _shard_grads(q, kc, vc, out, lse, g, dvec,
                                            qp, kpc, qs, ksc, kw)
            dq = dq + dq_i.float()
            dk = dk + dk_i.float()
            dv = dv + dv_i.float()
        if size > 1:
            # C - 1 hops from their owner: one more completes the circle
            dk, dv = rotate([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def _vec(x, B, n, fill, dev, offset=0):
    if x is None:
        if fill == "arange":
            x = torch.arange(offset, offset + n, dtype=torch.int32,
                             device=dev)
        else:
            x = torch.ones((n,), dtype=torch.int32, device=dev)
        return x.expand(B, n).contiguous()
    if tuple(x.shape) != (B, n):
        raise ValueError(f"expected a [{B}, {n}] position/segment array, "
                         f"got {tuple(x.shape)}")
    return x.to(device=dev, dtype=torch.int32).contiguous()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   q_segment_ids: Optional[torch.Tensor] = None,
                   kv_segment_ids: Optional[torch.Tensor] = None,
                   causal: bool = True,
                   sliding_window: Optional[int] = None,
                   scale: Optional[float] = None,
                   logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention on this rank's shards: q [B, S/C, H,
    dh], k / v [B, S/C, K, dh] (its rows, tokens and heads), positions and
    segment ids [B, S/C]; returns out [B, S/C, H, dh]. ``mesh`` is a
    ``parallel/mesh.py::build_mesh`` mesh whose ``context`` axis is C.
    Positions default to this rank's slice of ``arange(S)`` (JAX builds
    ``arange(S)`` and shards it), segment ids to ones."""
    from gke_ray_train_tpu_torch.parallel.mesh import (
        context_group, context_rank, context_size)
    if mesh is None:
        raise ValueError("ring attention needs a mesh with a context axis")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, len, heads, "
                             "head_dim] tensor")
    B, S, H, dh = q.shape
    if k.shape != (B, S, k.shape[2], dh) or v.shape != k.shape \
            or H % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    size = context_size(mesh)
    # the JAX kernel's block rule on the shard's length
    fa.pick_block(fa.DEFAULT_BLOCK_Q, S)
    fa.pick_block(fa.DEFAULT_BLOCK_KV, S)
    dev = q.device
    off = context_rank(mesh) * S
    qp = _vec(q_positions, B, S, "arange", dev, off)
    kp = qp if kv_positions is None else _vec(kv_positions, B, S, "", dev)
    qs = _vec(q_segment_ids, B, S, "ones", dev)
    ks = qs if kv_segment_ids is None else _vec(kv_segment_ids, B, S, "",
                                                dev)
    kw = dict(causal=causal, sliding_window=sliding_window,
              scale=dh ** -0.5 if scale is None else float(scale),
              logit_softcap=logit_softcap)
    group = context_group(mesh)
    if size == 1:
        return fa.flash_attention(q, k, v, q_positions=qp, kv_positions=kp,
                                  q_segment_ids=qs, kv_segment_ids=ks, **kw)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RingAttention.apply(q, k, v, qp, kp, qs, ks, kw, group, size)
    return _ring_forward(q, k, v, qp, kp, qs, ks, kw, group, size)[0]
