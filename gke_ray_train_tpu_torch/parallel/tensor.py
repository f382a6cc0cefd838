"""Tensor parallelism on the ``model`` axis: the collectives GSPMD derives
in the JAX package, written out (the port's counterpart of the
``_constrain`` calls of ``gke_ray_train_tpu/models/transformer.py``
:288-289, :567 and of the sharded-vocab merge of ``ops/fused_ce.py``
:274-284).

A weight sharded over ``model`` is a DTensor on the mesh's ``model``
submesh (``parallel/sharding.py``; under FSDP2 it is one while its unit
is gathered). The model code and the kernels never compute on a
DTensor: they take this rank's part (:func:`local_weight`, the port's
counterpart of ``shard_map``) and call the conjugate pair around it,
each a ``torch.autograd.Function`` over the model group:

- :func:`copy_to_model` before a column-parallel group (``wq`` ``wk``
  ``wv``, ``w_gate`` ``w_up``; the unfused head): identity forward,
  all-reduce of the input's gradient backward, whose column shards
  each gave a part of it;
- :func:`reduce_from_model` after a row-parallel projection (``wo``,
  ``w_down``), and wherever shards' partial sums meet: all-reduce
  forward, identity backward, since every model rank then holds the same
  (replicated) value and the same gradient of it.

On these two the vocab-sharded pieces are built: the embedding lookup
(:func:`vocab_parallel_embedding`: each rank looks up the ids in its own
vocab range, zeros the rest, one all-reduce) and the exact merge of the
row statistics (:func:`merge_row_stats`: ``lse = m + log Σ_r exp(lse_r -
m)`` with ``m`` the max over the shards, the target logit summed, since
it lives in exactly one shard), shared by the fused cross-entropy
(``ops/fused_ce.py``) and the unfused loss (:func:`vocab_parallel_nll`),
and the decode's greedy pick over the shards
(:func:`vocab_parallel_argmax`). Logits are never all-gathered over the
vocab.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gke_ray_train_tpu_torch.parallel.mesh import AXIS_MODEL


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``model`` axis: the group of its
    tensor-parallel peers, their count and its index among them."""
    group: object
    size: int
    rank: int


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """This rank's place on ``mesh``'s ``model`` axis (its tensor-parallel
    peers: the same batch rank, the other shards of every weight); None
    when ``model`` is 1."""
    sub = mesh[AXIS_MODEL]
    if sub.size() <= 1:
        return None
    return TensorParallel(group=sub.get_group(), size=sub.size(),
                          rank=sub.get_local_rank())


def _dtensor_of(w):
    """The DTensor holding ``w``'s values (a ``QTensor``'s codes), or
    None."""
    from torch.distributed.tensor import DTensor
    from gke_ray_train_tpu_torch.ops.quant import is_qtensor
    t = w.codes if is_qtensor(w) else w
    return t if isinstance(t, DTensor) else None


def tp_of(w) -> Optional[TensorParallel]:
    """The ``model`` axis ``w`` (a weight or a ``QTensor``) is sharded
    over, read from its placement whether its unit is gathered (a
    DTensor of the ``model`` submesh) or not (the last dim of FSDP2's
    (fsdp, model) mesh), without slicing the mesh; None for a plain
    tensor, a DTensor of a mesh without ``model``, or ``model`` 1."""
    t = _dtensor_of(w)
    if t is None:
        return None
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if AXIS_MODEL not in names:
        return None
    d = names.index(AXIS_MODEL)
    if mesh.size(d) <= 1:
        return None
    return TensorParallel(group=mesh.get_group(d), size=mesh.size(d),
                          rank=mesh.get_local_rank(d))


def local_weight(w):
    """This rank's part of ``w``: a DTensor's local tensor (through
    autograd: its gradient lands on the DTensor), a ``QTensor`` whose
    codes and scales are its local ones; anything else as it is."""
    from gke_ray_train_tpu_torch.ops.quant import QTensor, is_qtensor
    if w is None:
        return None
    if is_qtensor(w):
        if _dtensor_of(w) is None:
            return w
        codes = w.codes.to_local()
        if codes.dtype != w.code_dtype:
            codes = codes.view(w.code_dtype)
        return QTensor(codes, w.scales.to_local(), w.kind, w.group,
                       w.store)
    from torch.distributed.tensor import DTensor
    return w.to_local() if isinstance(w, DTensor) else w


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward; the gradient passed on as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]
                  ) -> torch.Tensor:
    """``x`` (replicated over ``model``) as the input of column shards:
    its gradient is summed over the group. ``x`` itself without TP."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]
                      ) -> torch.Tensor:
    """The sum over the group of the shards' partial ``x``, replicated;
    ``x`` itself without TP."""
    return x if tp is None else reduce_over(x, tp.group)


def reduce_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (all-reduce forward), whose
    gradient is passed on as it is: each rank's part of a sum every rank
    then holds."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` (no gradient)."""
    import torch.distributed as dist
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def shift_labels(targets: torch.Tensor, rank: int, v_local: int
                 ) -> torch.Tensor:
    """Global vocab ids as ids of shard ``rank`` (``v_local`` columns):
    ``t - rank * v_local``. A label of another shard lands outside
    ``[0, v_local)`` (negative or at least ``v_local``) and matches no
    column: the "contributes 0" the merge relies on (JAX
    ``ops/fused_ce.py`` :266-274)."""
    return targets - rank * v_local


def merge_shard_stats(lses: torch.Tensor, tgts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact merge of every shard's row statistics held in one
    process, stacked ``[n_shards, N]``: what :func:`merge_row_stats`
    computes across ranks, by the same formula."""
    m = torch.amax(lses, dim=0)
    return (m + torch.log(torch.sum(torch.exp(lses - m), dim=0)),
            torch.sum(tgts, dim=0))


def merge_row_stats(lse: torch.Tensor, tgt: torch.Tensor,
                    tp: Optional[TensorParallel]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This shard's ``(lse, tgt)`` [N] merged with its peers' (JAX's
    ``pmax`` / ``psum`` pair): ``lse = m + log Σ_r exp(lse_r - m)``, the
    target logits summed. Differentiable in ``lse`` and ``tgt`` (``m``
    is held constant: the merged value does not depend on it)."""
    if tp is None:
        return lse, tgt
    m = all_reduce_max(lse, tp.group)
    total = reduce_from_model(torch.exp(lse - m), tp)
    return m + torch.log(total), reduce_from_model(tgt, tp)


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor,
                             tp: TensorParallel,
                             dtype: torch.dtype) -> torch.Tensor:
    """Rows of the embedding whose local part ``table`` [V / model, D] is
    this rank's vocab range, in ``dtype``: each rank looks up the ids in
    its range and zeros the others, and one all-reduce puts every row
    together (one nonzero term each: exact)."""
    v_local = table.shape[0]
    local_ids = shift_labels(ids.long(), tp.rank, v_local)
    off = (local_ids < 0) | (local_ids >= v_local)
    rows = torch.nn.functional.embedding(local_ids.masked_fill(off, 0),
                                         table).to(dtype)
    rows = rows.masked_fill(off[..., None], 0)
    return reduce_from_model(rows, tp)


def vocab_parallel_argmax(logits: torch.Tensor,
                          tp: Optional[TensorParallel]) -> torch.Tensor:
    """The global vocab id of the largest logit of each row, where the
    last dim of ``logits`` is this rank's vocab shard (GSPMD's argmax
    over a sharded vocab in JAX): each shard's max and the global id of
    its first occurrence, the max all-reduced over the group, then the
    least id among the shards that hold it, so ties go to the lowest id
    as ``torch.argmax``'s do. Two all-reduces of one value a row; the
    logits are never gathered. ``torch.argmax`` itself without TP."""
    if tp is None:
        return torch.argmax(logits, dim=-1)
    import torch.distributed as dist
    m, idx = torch.max(logits.float(), dim=-1)
    gid = idx + tp.rank * logits.shape[-1]
    top = all_reduce_max(m, tp.group)
    cand = torch.where(m == top, gid, torch.full_like(gid, torch.iinfo(
        gid.dtype).max))
    return _all_reduce(cand, tp.group, dist.ReduceOp.MIN)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       weights: torch.Tensor, tp: TensorParallel
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``token_nll`` (sum of weighted NLL, sum of weights; fp32) of
    logits whose last dim is this rank's vocab shard: the shard's lse
    and target logit (of its shifted labels) merged exactly across the
    group (:func:`merge_row_stats`), the unfused counterpart of the
    sharded fused cross-entropy."""
    logits32 = logits.float()
    v_local = logits32.shape[-1]
    lse = torch.logsumexp(logits32, dim=-1)
    local_t = shift_labels(targets.long(), tp.rank, v_local)
    hit = (local_t >= 0) & (local_t < v_local)
    tgt = torch.gather(logits32, -1,
                       local_t.clamp(0, v_local - 1)[..., None])[..., 0]
    tgt = torch.where(hit, tgt, torch.zeros((), dtype=tgt.dtype,
                                            device=tgt.device))
    lse, tgt = merge_row_stats(lse, tgt, tp)
    w = weights.float()
    return torch.sum((lse - tgt) * w), torch.sum(w)
