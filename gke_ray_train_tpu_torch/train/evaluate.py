"""Sharded exact-eval walk (counterpart of
``gke_ray_train_tpu/train/evaluate.py``).

The eval rows are partitioned across input-shard groups while every
group walks the same number of steps:

- the global row count is padded up to steps * host_batch * in_shards;
- padding rows carry zero weights, so they add nothing to the
  token-weighted sums;
- the eval step returns (nll_sum, weight_sum) of its batch, so the
  per-shard sums combine into the exact global eval loss.

The walk is numpy on the host; ``place_batch`` puts each slice on the
card (``data/prefetch.py::make_place_batch``; a batch copied on its side
stream is waited for on the current one), else the eval step does.
With more than one input shard under a ``torch.distributed`` world
above one (one batch rank per shard, ``parallel/placement.py``) the
shards' sums are all-reduced, so every rank returns the global sums: over
the mesh's batch axes and ``context`` when the walk is given its
``mesh`` (the ``model`` ranks of one batch rank walk the same rows; its
``context`` ranks the same rows, each its own tokens of them), else over
the world; in one process a walk returns its own shard's sums. On a
pipelined mesh the eval step runs the pipeline's forward ticks and every
stage computes the sums of the last stage's output
(``models/transformer.py::forward``), so the ``pipe`` ranks of a batch
rank hold the same sums and are not summed over.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from gke_ray_train_tpu_torch.data.prefetch import PlacedBatch
from gke_ray_train_tpu_torch.device import world_size


def sharded_eval_sums(state, eval_step: Callable,
                      rows: Dict[str, np.ndarray], *,
                      host_batch: int, in_shards: int = 1,
                      in_shard_id: int = 0,
                      place_batch: Callable = None, mesh=None) -> tuple:
    """Walk this shard group's partition of ``rows`` and return its
    (nll_sum, weight_sum) floats. Every shard must be called with the
    same ``rows``: the partition is computed from ``in_shard_id``."""
    eb = max(host_batch, 1)
    n_rows = len(rows["inputs"])
    stride = eb * in_shards
    steps = max((n_rows + stride - 1) // stride, 1)
    nll = w = 0.0
    for s in range(steps):
        start = s * stride + in_shard_id * eb
        b = {k: v[start:start + eb] for k, v in rows.items()}
        got = len(b["inputs"])
        if got < eb:
            # zero-weight padding keeps the batch shape constant and
            # every shard in step, even where only some have tail rows
            b = {k: np.concatenate(
                [v, np.zeros((eb - got,) + v.shape[1:], v.dtype)])
                for k, v in b.items()}
        if place_batch is not None:
            b = place_batch(b)
            if isinstance(b, PlacedBatch):
                b = b.wait()
        n, ww = eval_step(state, b)
        nll += float(n)
        w += float(ww)
    from gke_ray_train_tpu_torch.parallel.mesh import context_size
    if (in_shards > 1 or context_size(mesh) > 1) and world_size() > 1:
        nll, w = _sum_over_shards(nll, w, mesh)
    return nll, w


def _sum_over_shards(nll: float, w: float, mesh=None) -> tuple:
    """The shards' sums added in float64 over ``mesh``'s batch axes and
    ``context``, or the world without a mesh (on the card under NCCL)."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel.mesh import (
        collective_device, token_groups)
    sums = torch.tensor([nll, w], dtype=torch.float64,
                        device=collective_device())
    for group in (token_groups(mesh) if mesh is not None else [None]):
        dist.all_reduce(sums, group=group)
    nll, w = sums.tolist()
    return nll, w


def sharded_eval_loss(state, eval_step: Callable,
                      rows: Dict[str, np.ndarray], *,
                      host_batch: int, in_shards: int = 1,
                      in_shard_id: int = 0,
                      place_batch: Callable = None, mesh=None) -> float:
    nll, w = sharded_eval_sums(
        state, eval_step, rows, host_batch=host_batch,
        in_shards=in_shards, in_shard_id=in_shard_id,
        place_batch=place_batch, mesh=mesh)
    return nll / max(w, 1.0)
