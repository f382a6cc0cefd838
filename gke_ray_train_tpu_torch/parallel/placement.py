"""Per-rank input partitioning over the batch axes (counterpart of
``gke_ray_train_tpu/parallel/placement.py``).

JAX forms one global array from every host's local rows
(``make_array_from_process_local_data``). Under FSDP2 each rank runs the
step on its own rows and the gradients are summed across ranks, so the
global batch is the union of the ranks' rows and never exists as one
tensor: a rank feeds its input pipeline its share of the rows
(``data/sft.py::sft_epoch_batches(num_hosts=, host_id=)``) and places
them on its own card (``data/prefetch.py::make_place_batch``). Every
batch rank (data × fsdp) is its own input shard; the ``model`` ranks of
one batch rank share its shard (``batch_rank`` leaves ``model`` out), as
JAX's ``P(("data", "fsdp"))`` replicates the rows over ``model``.

Over ``context`` (JAX's ``context_sharded`` placement, :32-33, :70-104:
``P(BATCH_AXES, "context")`` on the token-aligned keys) the context ranks
of one batch rank take the same rows, and each keeps its contiguous
``S / C`` tokens of them (:func:`context_slice`). The targets are
shifted on the host, so no token's loss crosses a shard boundary; a batch
without positions gets them from the model, which gives context rank c
the positions ``c * S / C + arange(S / C)``
(``models/transformer.py::forward``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike
from gke_ray_train_tpu_torch.parallel.mesh import (
    batch_group_size, batch_rank, context_rank, context_size)

# the keys laid out along the sequence (JAX's ``_SEQ_KEYS``)
SEQ_KEYS = ("inputs", "targets", "weights", "segment_ids", "positions")


def input_shard_layout(mesh=None) -> Tuple[int, int]:
    """(shard_count, shard_index) of this rank's input rows: every rank
    of the data × fsdp batch axes feeds distinct rows, data-major.
    ``(1, 0)`` without a mesh."""
    if mesh is None:
        return 1, 0
    return batch_group_size(mesh), batch_rank(mesh)


def host_batch_size(global_batch: int, *, num_shards: int) -> int:
    """Rows each of ``num_shards`` input shards contributes a step
    (:func:`input_shard_layout`'s count); raises, naming the fix, when
    the global batch does not divide among the shards."""
    n = num_shards
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} input "
            "shards — pick PER_DEVICE_TRAIN_BATCH_SIZE * mesh data axes "
            "so every host group contributes the same number of rows")
    return global_batch // n


def context_slice(batch: Mapping[str, np.ndarray], mesh
                  ) -> Dict[str, np.ndarray]:
    """This context rank's contiguous ``S / C`` tokens of the
    token-aligned keys (:data:`SEQ_KEYS`) of its rows; the batch as it is
    where ``context`` is 1. Raises where C does not divide S."""
    C = context_size(mesh)
    if C == 1:
        return dict(batch)
    c = context_rank(mesh)
    out = {}
    for k, v in batch.items():
        if k in SEQ_KEYS:
            S = v.shape[1]
            if S % C:
                raise ValueError(f"{k}: sequence length {S} not divisible "
                                 f"by the context axis (size {C})")
            v = v[:, c * (S // C):(c + 1) * (S // C)]
        out[k] = v
    return out


def place_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows ``[local_B, S]`` on its card (default
    ``cuda:LOCAL_RANK`` under a process group): the
    ``data/prefetch.py::make_place_batch`` placement, made for one
    batch."""
    from gke_ray_train_tpu_torch.data.prefetch import make_place_batch
    out = make_place_batch(device)(batch)
    return out.wait() if hasattr(out, "wait") else out
