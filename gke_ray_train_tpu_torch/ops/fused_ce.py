"""Fused cross-entropy over the vocab — CUDA C++ kernels written for
Hopper.

Counterpart of ``gke_ray_train_tpu/ops/fused_ce.py``: ``token_nll`` of
the logits ``x @ head`` without the [N, V] logits ever in device memory.
Three entries of ``csrc/fused_ce.cu`` replace the Pallas TPU kernels:

- ``fused_ce_row_stats`` replaces ``_fwd_kernel`` (:70, via ``_row_stats``
  :164): per row the logsumexp over vocab tiles (fp32 online max / sum)
  and the target logit gathered in-tile;
- ``fused_ce_dx`` replaces ``_dx_kernel`` (:106, via ``_grads`` :200):
  ``dx = ((softmax - onehot) * wg) @ head^T``;
- ``fused_ce_dhead`` replaces ``_dhead_kernel`` (:133):
  ``dhead = x^T @ ((softmax - onehot) * wg)``.

Both gradients recompute the logits from x, head and the saved lse. A
label outside [0, V) matches no vocab column: its target logit is 0 and
its row of dl has no one-hot term (JAX :88-95), so neither side ever
indexes ``head[:, target]``.

``FusedCrossEntropy`` (a ``torch.autograd.Function``) is the counterpart
of the JAX ``custom_vjp`` (:289-311): it saves x, head, targets, weights
and lse, never the logits; its backward computes dx always and dhead only
where the head takes a gradient (full fine-tuning, not LoRA).

Over a vocab sharded on ``model`` (JAX :262-284 and its shard_map call
site :316-392) each rank runs the same three kernels on its head shard
[D, V / model]: the labels are shifted into the shard's coordinates
(``parallel/tensor.py::shift_labels``; a label of another shard lands
outside [0, V / model), negative or past the end, and matches no
column), the row statistics are merged exactly across the shards
(``merge_row_stats``: the max, the sum of exponentials, the target
logit summed), dx, a partial sum over the shard's columns, is
all-reduced over ``model``, and dhead is the shard's own (FSDP2 sums it
over the batch ranks).

CUDA tensors launch the kernels; CPU tensors run the plain PyTorch
versions beside them (``fused_ce_row_stats_reference``,
``fused_ce_grads_reference``), and only CPU tensors do. A CUDA tensor the
kernels cannot take raises; nothing falls back. ``fused_ce_row_stats
.launches``, ``fused_ce_dx.launches`` and ``fused_ce_dhead.launches``
count calls that launched a kernel entry (each entry runs its launches
over the vocab chunks itself).

The row statistics, dx and dhead each run one of three GEMM bodies,
chosen by ``grad_route`` from the dtype, the shapes and the operands'
alignment (never by a failure): ``wgmma`` (the Hopper body: TMA ring,
producer warp, wgmma) for bf16 rows TMA can address, ``mma_sync`` for the
other bf16 shapes, ``fp32`` for float32. The C entries refuse a route the
shape does not fit. ``fused_ce_row_stats.routes``, ``fused_ce_dx.routes``
and ``fused_ce_dhead.routes`` count launches per route beside
``.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# vocab columns per backward chunk: the width of the dl scratch the dx /
# dhead entries fill and consume chunk by chunk (a multiple of
# _CHUNK_QUANTUM, the kernels' column tile); ``fused_cross_entropy``'s
# ``block_v`` sets another
_CHUNK = 8192
_CHUNK_QUANTUM = 128
# the entries' GEMM bodies, by the C entries' route code
ROUTES = {"fp32": 0, "mma_sync": 1, "wgmma": 2}


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """fp32 logits from the operands upcast (exact products of bf16
    values), the fp32 ``dot_general`` of the TPU kernels (:80-83)."""
    return x.float() @ head.float()


def _label_hits(targets: torch.Tensor, V: int) -> torch.Tensor:
    """[N, V] bool: column v is row n's label. A label outside [0, V)
    matches no column."""
    cols = torch.arange(V, device=targets.device, dtype=torch.int64)
    return cols[None, :] == targets.long()[:, None]


def fused_ce_row_stats_reference(x: torch.Tensor, head: torch.Tensor,
                                 targets: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-statistics kernel's function in plain PyTorch: ``(lse,
    tgt)`` [N] fp32 of the logits ``x @ head`` computed in fp32; ``tgt``
    is the label's logit, 0 for a label outside [0, V)."""
    logits = _logits(x, head)
    lse = torch.logsumexp(logits, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    tgt = torch.sum(torch.where(_label_hits(targets, head.shape[1]), logits,
                                zero), dim=-1)
    return lse, tgt


def fused_ce_grads_reference(x: torch.Tensor, head: torch.Tensor,
                             targets: torch.Tensor, wg: torch.Tensor,
                             lse: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dx and dhead kernels' function in plain PyTorch (JAX :106-157):
    ``dl = (exp(logits - lse) - onehot) * wg`` kept in fp32, then ``dx =
    dl @ head^T`` in x.dtype and ``dhead = x^T @ dl`` in head.dtype.
    wg: per-row weight times the loss cotangent."""
    logits = _logits(x, head)
    dl = (torch.exp(logits - lse[:, None])
          - _label_hits(targets, head.shape[1]).float()) \
        * wg.float()[:, None]
    dx = (dl @ head.float().T).to(x.dtype)
    dhead = (x.float().T @ dl).to(head.dtype)
    return dx, dhead


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_operands(x, head, targets, *rows) -> None:
    dev = x.device
    if x.dtype not in _DTYPE_CODES or head.dtype != x.dtype:
        raise TypeError(f"the kernels take float32 or bfloat16 x and head "
                        f"of one dtype, not {x.dtype} and {head.dtype}")
    N, D = x.shape
    if head.shape[0] != D:
        raise ValueError(f"head {tuple(head.shape)} does not match x "
                         f"{tuple(x.shape)}")
    named = [("x", x, x.dtype), ("head", head, x.dtype),
             ("targets", targets, torch.int32)]
    named += [(f"row input {i}", r, torch.float32)
              for i, r in enumerate(rows)]
    for name, t, dt in named:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            strided = "" if t.is_contiguous() else " (not contiguous)"
            raise ValueError(f"{name}: the kernel takes a contiguous {dt} "
                             f"tensor on {dev}, not {t.dtype} on "
                             f"{t.device}{strided}")
    for name, t in [("targets", targets)] + [
            (f"row input {i}", r) for i, r in enumerate(rows)]:
        if tuple(t.shape) != (N,):
            raise ValueError(f"{name} {tuple(t.shape)} is not [{N}]")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _route_of(x: torch.Tensor, head: torch.Tensor) -> str:
    """``grad_route`` of these operands: their dtype, D, V and data
    pointers."""
    return grad_route(x.dtype, x.shape[1], head.shape[1],
                      (x.data_ptr(), head.data_ptr()))


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {sorted(ROUTES)}")


def _row_stats_launch(x, head, targets, route: Optional[str] = None):
    """Launch the row statistics on ``route`` (default ``_route_of`` the
    operands; another is for comparing the bodies, and the C entry
    refuses one the shape does not fit) and count the launch."""
    from gke_ray_train_tpu_torch.kernels import load
    _check_operands(x, head, targets)
    route = _route_of(x, head) if route is None else route
    _check_route(route)
    N, D = x.shape
    V = head.shape[1]
    # the launch's CTA budget, two an SM, and room for as many vocab splits
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ctas = min(2 * sms, 65535)
    part = torch.empty((3 * ctas, N), dtype=torch.float32, device=x.device)
    lse = torch.empty((N,), dtype=torch.float32, device=x.device)
    tgt = torch.empty_like(lse)
    with torch.cuda.device(x.device):
        rc = load("fused_ce").fused_ce_row_stats(
            x.data_ptr(), head.data_ptr(), targets.data_ptr(),
            part.data_ptr(), lse.data_ptr(), tgt.data_ptr(), N, D, V,
            ctas, _DTYPE_CODES[x.dtype], ROUTES[route], _stream(x))
    _raise_on(rc, f"fused_ce_row_stats ({route} route)")
    fused_ce_row_stats.launches += 1
    fused_ce_row_stats.routes[route] += 1
    return lse, tgt


def _on(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


def fused_ce_row_stats(x: torch.Tensor, head: torch.Tensor,
                       targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tgt)`` [N] fp32 of the logits ``x [N, D] @ head [D, V]``
    without materializing them. targets: [N] int32. On CUDA x and head are
    contiguous float32 or bfloat16 of one dtype."""
    if _on(x, "fused_ce_row_stats") == "cuda":
        return _row_stats_launch(x, head, targets)
    return fused_ce_row_stats_reference(x, head, targets)


fused_ce_row_stats.launches = 0
fused_ce_row_stats.routes = dict.fromkeys(ROUTES, 0)


def grad_route(dtype: torch.dtype, D: int, V: int,
               pointers: Tuple[int, ...] = ()) -> str:
    """The GEMM body of the row statistics, dx and dhead entries for x
    [N, D] and head [D, V] of ``dtype`` at data pointers ``pointers``
    (the dx / dhead scratch is a fresh, aligned allocation): ``wgmma``
    where TMA can address every operand row (bf16, rows of D and V
    elements a multiple of 16 bytes, 16-byte aligned bases), ``mma_sync``
    for other bf16 shapes, ``fp32`` for float32."""
    if dtype == torch.float32:
        return "fp32"
    if D % 8 == 0 and V % 8 == 0 and all(p % 16 == 0 for p in pointers):
        return "wgmma"
    return "mma_sync"


def _grad_launch(entry: str, x, head, targets, wg, lse,
                 chunk: int = _CHUNK, route: Optional[str] = None
                 ) -> torch.Tensor:
    """Launch ``entry`` (``fused_ce_dx`` or ``fused_ce_dhead``) with a
    vocab chunk of ``chunk`` columns on ``route`` (default ``grad_route``
    of the operands; another is for comparing the bodies, and the C
    entry refuses one the shape does not fit) and count the launch on its
    wrapper."""
    from gke_ray_train_tpu_torch.kernels import load
    _check_operands(x, head, targets, wg, lse)
    if chunk < _CHUNK_QUANTUM or chunk % _CHUNK_QUANTUM:
        raise ValueError(f"block_v {chunk} is not a positive multiple of "
                         f"{_CHUNK_QUANTUM}")
    N, D = x.shape
    V = head.shape[1]
    route = _route_of(x, head) if route is None else route
    _check_route(route)
    dl = torch.empty((N, chunk), dtype=x.dtype, device=x.device)
    lib = load("fused_ce")
    args = (x.data_ptr(), head.data_ptr(), targets.data_ptr(), wg.data_ptr(),
            lse.data_ptr(), dl.data_ptr())
    tail = (N, D, V, chunk, _DTYPE_CODES[x.dtype], ROUTES[route], _stream(x))
    with torch.cuda.device(x.device):
        if entry == "fused_ce_dx":
            wrapper = fused_ce_dx
            out = torch.empty_like(x)
            # fp32 sums over the chunks: bf16 over more than one chunk
            # needs a buffer, float32 sums in dx itself
            acc = (torch.empty((N, D), dtype=torch.float32, device=x.device)
                   if x.dtype != torch.float32 and V > chunk else out)
            rc = lib.fused_ce_dx(*args, acc.data_ptr(), out.data_ptr(), *tail)
        else:
            wrapper = fused_ce_dhead
            out = torch.empty_like(head)
            rc = lib.fused_ce_dhead(*args, out.data_ptr(), *tail)
    _raise_on(rc, f"{entry} ({route} route)")
    wrapper.launches += 1
    wrapper.routes[route] += 1
    return out


def fused_ce_dx(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                wg: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """dx [N, D] in x.dtype: ``((softmax - onehot) * wg) @ head^T`` with
    the logits recomputed from x, head and lse [N] fp32. wg: [N] fp32,
    the row weight times the loss cotangent."""
    if _on(x, "fused_ce_dx") == "cuda":
        return _grad_launch("fused_ce_dx", x, head, targets, wg, lse)
    return fused_ce_grads_reference(x, head, targets, wg, lse)[0]


fused_ce_dx.launches = 0
fused_ce_dx.routes = dict.fromkeys(ROUTES, 0)


def fused_ce_dhead(x: torch.Tensor, head: torch.Tensor,
                   targets: torch.Tensor, wg: torch.Tensor,
                   lse: torch.Tensor) -> torch.Tensor:
    """dhead [D, V] in head.dtype: ``x^T @ ((softmax - onehot) * wg)``;
    the arguments as ``fused_ce_dx``."""
    if _on(x, "fused_ce_dhead") == "cuda":
        return _grad_launch("fused_ce_dhead", x, head, targets, wg, lse)
    return fused_ce_grads_reference(x, head, targets, wg, lse)[1]


fused_ce_dhead.launches = 0
fused_ce_dhead.routes = dict.fromkeys(ROUTES, 0)


class FusedCrossEntropy(torch.autograd.Function):
    """(nll sum, weight sum) of rows x [N, D] under head [D, V]. Saves x,
    head, targets, weights and lse (JAX :295-299); the backward forms dx
    always and dhead only where the head takes a gradient. With ``tp``
    (a ``parallel/tensor.py::TensorParallel``) head is this rank's vocab
    shard and targets are global ids: shifted, merged and summed as the
    module doc says."""

    @staticmethod
    def forward(ctx, x, head, targets, weights, block_v, tp=None):
        from gke_ray_train_tpu_torch.parallel.tensor import (
            merge_row_stats, shift_labels)
        if tp is not None:
            targets = shift_labels(targets, tp.rank, head.shape[1])
        lse, tgt = fused_ce_row_stats(x, head, targets)
        lse, tgt = merge_row_stats(lse, tgt, tp)
        ctx.save_for_backward(x, head, targets, weights, lse)
        ctx.block_v = block_v
        ctx.tp = tp
        w_sum = torch.sum(weights)
        ctx.mark_non_differentiable(w_sum)
        return torch.sum((lse - tgt) * weights), w_sum

    @staticmethod
    def backward(ctx, g_nll, g_w):
        x, head, targets, weights, lse = ctx.saved_tensors
        wg = (weights * g_nll).contiguous()
        need_dhead = ctx.needs_input_grad[1]
        if x.is_cuda:   # the chunk reaches the kernels, not the wrappers
            dx = _grad_launch("fused_ce_dx", x, head, targets, wg, lse,
                              ctx.block_v)
            dhead = (_grad_launch("fused_ce_dhead", x, head, targets, wg,
                                  lse, ctx.block_v) if need_dhead else None)
        else:
            dx = fused_ce_dx(x, head, targets, wg, lse)
            dhead = (fused_ce_dhead(x, head, targets, wg, lse)
                     if need_dhead else None)
        if ctx.tp is not None:
            # dx contracts over the vocab: a partial sum per shard
            import torch.distributed as dist
            dist.all_reduce(dx, group=ctx.tp.group)
        return dx, dhead, None, None, None, None


def fused_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                        targets: torch.Tensor, weights: torch.Tensor, *,
                        vocab_axis=None, mesh=None,
                        block_v: int = _CHUNK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted nll sum, weight sum), both fp32 — ``token_nll``
    semantics, the logits never materialized. x: [B, S, D] final-normed
    hidden; head: [D, V] (a transposed view, as a tied embedding gives,
    is copied contiguous); targets / weights: [B, S]. ``block_v``: the
    vocab chunk of the backward kernels (JAX's ``block_v`` vocab tile,
    :248), a multiple of 128; the plain versions ignore it.

    The sharded vocab (module doc): ``vocab_axis`` is the
    ``parallel/tensor.py::TensorParallel`` of the ``model`` axis (JAX's
    axis name inside a shard_map); ``mesh`` (a
    ``parallel/mesh.py::build_mesh`` mesh) shards the vocab over its
    ``model`` axis where that is above 1, as JAX's ``mesh=`` does.
    ``head`` is then this rank's shard [D, V / model] (a DTensor gives
    its local part) and ``targets`` hold global ids. With ``vocab_axis``
    the sums are this rank's rows' (the same on every ``model`` peer: the
    port's train step sums them over the batch axes and ``context`` once
    a step); with ``mesh`` they are summed over the batch axes and
    ``context`` here (``parallel/mesh.py::token_groups``), as JAX's
    ``mesh=`` sums them over ``(*BATCH_AXES, AXIS_CONTEXT)`` (:321-324):
    every rank returns the global sums, whose gradient is each rank's
    own."""
    from gke_ray_train_tpu_torch.parallel.tensor import (
        TensorParallel, local_weight, tensor_parallel)
    tp = vocab_axis
    if mesh is not None:
        if not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a DeviceMesh from parallel/"
                            f"mesh.py::build_mesh, not {type(mesh).__name__}")
        tp = tensor_parallel(mesh)
    elif tp is not None and not isinstance(tp, TensorParallel):
        raise TypeError(f"vocab_axis takes the TensorParallel of the model "
                        f"axis (or pass mesh=), not {tp!r}")
    head = local_weight(head)
    B, S, D = x.shape
    if tuple(targets.shape) != (B, S) or tuple(weights.shape) != (B, S):
        raise ValueError(f"targets {tuple(targets.shape)} and weights "
                         f"{tuple(weights.shape)} are not [{B}, {S}]")
    dev = x.device
    nll, w = FusedCrossEntropy.apply(
        x.reshape(B * S, D).contiguous(), head.contiguous(),
        targets.reshape(-1).to(device=dev, dtype=torch.int32).contiguous(),
        weights.reshape(-1).to(device=dev, dtype=torch.float32).contiguous(),
        int(block_v), tp)
    if mesh is not None:
        from gke_ray_train_tpu_torch.parallel.mesh import token_groups
        from gke_ray_train_tpu_torch.parallel.tensor import reduce_over
        for group in token_groups(mesh):
            nll, w = reduce_over(nll, group), reduce_over(w, group)
    return nll, w
