"""Sequence packing with segment ids (counterpart of
``gke_ray_train_tpu/data/packing.py``, the port's own copy; numpy only).

Greedy packing in arrival order: documents go into the current row until
the next one does not fit, then the row is emitted. Packed rows carry
``segment_ids`` (0 = padding) and positions that restart at 0 in every
document, so attention isolates the documents and RoPE sees each one
from position 0. The boundary token of each document predicts nothing
(weight 0) instead of the next document's first token.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np


def pack_examples(examples: Iterable[Dict[str, np.ndarray]], seq_len: int,
                  *, pad_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """examples: iterable of {input_ids [L], loss_weights [L]} (L <= anything;
    longer examples are truncated to seq_len+1 tokens).

    Yields packed rows: inputs/targets [seq_len], weights [seq_len],
    segment_ids [seq_len], positions [seq_len]. Targets are next-token
    within each segment; the boundary token of each segment predicts
    nothing (weight 0) instead of leaking into the next document.
    """
    buf_ids: List[np.ndarray] = []

    def emit(buf: List[np.ndarray]) -> Dict[str, np.ndarray]:
        inputs = np.full(seq_len, pad_id, np.int32)
        targets = np.full(seq_len, pad_id, np.int32)
        weights = np.zeros(seq_len, np.float32)
        segs = np.zeros(seq_len, np.int32)
        pos = np.zeros(seq_len, np.int32)
        off = 0
        for si, (ids, w) in enumerate(buf, start=1):
            L = len(ids)
            inputs[off:off + L - 1] = ids[:-1]
            targets[off:off + L - 1] = ids[1:]
            weights[off:off + L - 1] = w[1:]
            segs[off:off + L - 1] = si
            pos[off:off + L - 1] = np.arange(L - 1)
            off += L - 1
        return {"inputs": inputs, "targets": targets, "weights": weights,
                "segment_ids": segs, "positions": pos}

    used = 0
    for ex in examples:
        ids = np.asarray(ex["input_ids"], np.int32)[: seq_len + 1]
        w = np.asarray(ex["loss_weights"], np.float32)[: seq_len + 1]
        if len(ids) < 2:
            continue
        need = len(ids) - 1  # tokens of sequence space this example uses
        if used + need > seq_len and used > 0:
            yield emit(buf_ids)
            buf_ids, used = [], 0
        buf_ids.append((ids, w))
        used += need
    if buf_ids:
        yield emit(buf_ids)


def batch_packed(packed: Iterable[Dict[str, np.ndarray]],
                 batch_size: int, *, drop_last: bool = True,
                 pad_id: int = 0,
                 seq_len: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Stack packed rows into [B, S] batches; final partial batch is padded
    with empty rows unless dropped."""
    rows: List[Dict[str, np.ndarray]] = []
    for r in packed:
        rows.append(r)
        if len(rows) == batch_size:
            yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            rows = []
    if rows and not drop_last:
        S = seq_len if seq_len is not None else len(rows[0]["inputs"])
        empty = {"inputs": np.full(S, pad_id, np.int32),
                 "targets": np.full(S, pad_id, np.int32),
                 "weights": np.zeros(S, np.float32),
                 "segment_ids": np.zeros(S, np.int32),
                 "positions": np.zeros(S, np.int32)}
        while len(rows) < batch_size:
            rows.append(empty)
        yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
