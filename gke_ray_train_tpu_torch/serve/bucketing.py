"""Prompt bucketing for the serve engine — a numpy copy of
``gke_ray_train_tpu/serve/bucketing.py``.

A request's working width is rounded up to a fixed bucket so every
prompt of similar length shares one cache shape. 128-multiples matter
twice — they are the flash-prefill tiling gate in ``models/kvcache.py``,
and they make ``greedy_generate_cached``'s internal prefill rounding land
on the full bucket width, which keeps the engine's full-width prefill
bitwise-comparable to the sequential oracle.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_BUCKET_QUANTUM = 128


def prompt_bucket(n: int, *, bucket: int = DEFAULT_BUCKET_QUANTUM) -> int:
    """Round a width up to a fixed bucket so every prompt of similar
    length shares one cache shape."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pick_bucket(prompt_len: int, max_new_tokens: int,
                buckets: Sequence[int],
                max_seq_len: Optional[int] = None) -> int:
    """The smallest declared bucket that fits ``prompt_len + max_new``
    (and the model's ``max_seq_len`` when given). Raises ValueError
    when no bucket fits — the scheduler rejects the request up front
    instead of truncating it silently."""
    need = prompt_len + max_new_tokens
    usable = sorted(b for b in buckets
                    if max_seq_len is None or b <= max_seq_len)
    if not usable:
        raise ValueError(
            f"no declared bucket {sorted(buckets)} fits the model's "
            f"max_seq_len={max_seq_len}")
    for b in usable:
        if need <= b:
            return b
    raise ValueError(
        f"request needs {need} slots (prompt {prompt_len} + "
        f"{max_new_tokens} new) but the largest usable bucket is "
        f"{usable[-1]} — truncate the prompt or declare a larger bucket")


def truncate_prompt(ids: np.ndarray, max_prompt: int,
                    *, label: str = "prompt") -> np.ndarray:
    """Keep the LAST ``max_prompt`` tokens (the reference's behavior),
    but loudly: a silently truncated prompt makes the model answer a
    question the user never finished asking."""
    if len(ids) > max_prompt:
        logger.warning(
            "%s of %d tokens exceeds the %d-token budget; truncating "
            "to the last %d tokens (the head of the prompt is DROPPED)",
            label, len(ids), max_prompt, max_prompt)
        return ids[-max_prompt:]
    return ids


def form_prompt_buffer(ids: np.ndarray, width: int
                       ) -> Tuple[np.ndarray, int]:
    """(right-padded [1, width] int32 buffer, prompt_len) — the fixed
    buffer shape prefill runs at. ``ids`` must already fit
    ``width`` (callers bucket/truncate first)."""
    ids = np.asarray(ids, np.int32)
    if len(ids) > width:
        raise ValueError(f"prompt of {len(ids)} tokens does not fit the "
                         f"{width}-wide buffer — bucket/truncate first")
    buf = np.zeros((1, width), np.int32)
    buf[0, :len(ids)] = ids
    return buf, len(ids)
