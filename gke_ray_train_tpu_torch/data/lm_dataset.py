"""Sliding-window next-token LM dataset + per-host sharded batching
(counterpart of ``gke_ray_train_tpu/data/lm_dataset.py``, the port's own
copy; numpy only).

Replaces the reference's TextDataset (ray-jobs/pytorch_llm_ray.py:107-119,
input ids[i:i+L], target ids[i+1:i+L+1]) and the DistributedSampler that
``train.torch.prepare_data_loader`` injects (:216, epoch reshuffle
:265-266). No per-sample __getitem__/collate: whole batches are
gathered from the token array with one vectorized numpy indexing op;
each host owns a disjoint stride of the global batch sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SlidingWindowDataset:
    ids: np.ndarray          # [N] int32 token stream
    seq_len: int

    def __post_init__(self):
        self.ids = np.asarray(self.ids, dtype=np.int32)

    def __len__(self) -> int:
        return max(0, len(self.ids) - self.seq_len)

    def gather(self, starts: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorized batch gather: one fancy-index instead of B python
        __getitem__ calls + collate."""
        offsets = np.arange(self.seq_len + 1, dtype=np.int64)
        windows = self.ids[starts[:, None] + offsets[None, :]]
        return {
            "inputs": windows[:, :-1].astype(np.int32),
            "targets": windows[:, 1:].astype(np.int32),
            "weights": np.ones((len(starts), self.seq_len), np.float32),
        }


@dataclasses.dataclass
class ShardedBatches:
    """Deterministic, seeded, per-host-sharded batch iterator.

    Epoch reshuffling parity with sampler.set_epoch
    (pytorch_llm_ray.py:265-266): pass a different ``epoch`` to
    ``iter_epoch``. ``max_samples`` mirrors the reference's test_run
    16k-sample cap (pytorch_llm_ray.py:198-201).
    """
    dataset: SlidingWindowDataset
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 42
    shuffle: bool = True
    drop_last: bool = True
    max_samples: Optional[int] = None

    def __post_init__(self):
        if self.global_batch % self.num_hosts != 0:
            raise ValueError(
                f"global batch {self.global_batch} must divide evenly over "
                f"{self.num_hosts} hosts")
        self.host_batch = self.global_batch // self.num_hosts

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.max_samples is not None:
            n = min(n, self.max_samples)
        return n // self.global_batch if self.drop_last else (
            (n + self.global_batch - 1) // self.global_batch)

    def iter_epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        if self.max_samples is not None:
            n = min(n, self.max_samples)
        order = np.arange(n, dtype=np.int64)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        steps = self.steps_per_epoch()
        for s in range(steps):
            chunk = order[s * self.global_batch:(s + 1) * self.global_batch]
            mine = chunk[self.host_id::self.num_hosts]
            batch = self.dataset.gather(mine)
            if len(mine) < self.host_batch:  # last partial batch, pad
                pad = self.host_batch - len(mine)
                batch = {
                    k: np.concatenate(
                        [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in batch.items()}
            yield batch
