"""Dataset preparation — wikitext-2 to shared storage (counterpart of
``gke_ray_train_tpu/data/prepare.py``, the port's own copy).

Parity with the reference's data-prep Ray task
(ray-jobs/prepare_wikitext2_ray_job.py:18-91): per split, download
wikitext-2-raw-v1 via HF datasets, join the text lines, write one raw
file; idempotently skip existing non-empty files (:39-47). The function is
plain (the Ray decoration lives in the entry script, as in the reference)
so it also runs locally and in tests with a synthetic fallback corpus.
The fallback seeds each split's corpus with ``hash(split)``, as the JAX
package does: Python salts string hashes per process, so the corpus
differs between processes unless ``PYTHONHASHSEED`` is set.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

logger = logging.getLogger(__name__)

SPLITS = ("train", "validation", "test")


def _target_path(out_dir: str, split: str) -> str:
    return os.path.join(out_dir, f"wikitext2_{split}.txt")


def prepare_wikitext2(out_dir: str, *,
                      splits=SPLITS,
                      force: bool = False,
                      synthetic_fallback: bool = False,
                      synthetic_chars: int = 200_000) -> Dict[str, str]:
    """Write one concatenated raw-text file per split; returns
    {split: path}. Idempotent: existing non-empty files are kept
    (prepare_wikitext2_ray_job.py:39-47 behavior).

    ``synthetic_fallback``: in an offline environment (no HF hub egress),
    generate a deterministic synthetic corpus instead of failing — keeps
    the smoke path runnable anywhere.
    """
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    todo = []
    for split in splits:
        path = _target_path(out_dir, split)
        out[split] = path
        if not force and os.path.exists(path) and os.path.getsize(path) > 0:
            logger.info("%s exists and is non-empty; skipping", path)
            continue
        todo.append(split)
    if not todo:
        return out

    try:
        if synthetic_fallback and not hub_reachable():
            raise ConnectionError("HF hub unreachable (offline probe)")
        from datasets import load_dataset
        for split in todo:
            ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
            text = "\n".join(ds["text"])
            with open(out[split], "w") as f:
                f.write(text)
            logger.info("wrote %s (%d chars)", out[split], len(text))
    except Exception as e:  # zero-egress env, hub outage, ...
        if not synthetic_fallback:
            raise
        logger.warning("falling back to synthetic corpus (%s)", e)
        for split in todo:
            text = _synthetic_corpus(
                seed=hash(split) % (2 ** 31),
                n_chars=synthetic_chars if split == "train"
                else synthetic_chars // 10)
            with open(out[split], "w") as f:
                f.write(text)
    return out


def hub_reachable(timeout: float = 3.0) -> bool:
    """Cheap egress probe — load_dataset in a zero-egress container can
    hang for minutes on connect timeouts; fail fast instead."""
    if os.environ.get("HF_HUB_OFFLINE") == "1" or \
            os.environ.get("HF_DATASETS_OFFLINE") == "1":
        return False
    import socket
    try:
        with socket.create_connection(("huggingface.co", 443),
                                      timeout=timeout):
            return True
    except OSError:
        return False


def _synthetic_corpus(seed: int, n_chars: int) -> str:
    """Deterministic fake-wiki text with word-like statistics (zipfian
    vocab, sentences, headings) — enough structure for a char LM to have
    something learnable."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vocab = ["the", "of", "and", "in", "to", "a", "was", "is", "for", "on",
             "as", "by", "with", "he", "she", "at", "from", "that", "it",
             "his", "her", "were", "are", "which", "this", "first", "album",
             "game", "season", "city", "river", "war", "king", "church",
             "north", "south", "century", "world", "state", "team", "music",
             "film", "series", "station", "university", "history"]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    parts = []
    total = 0
    while total < n_chars:
        if rng.random() < 0.02:
            head = " ".join(rng.choice(vocab, size=2, p=probs)).title()
            s = f"\n = {head} = \n"
        else:
            n = int(rng.integers(5, 18))
            words = rng.choice(vocab, size=n, p=probs)
            s = " ".join(words).capitalize() + ". "
        parts.append(s)
        total += len(s)
    return "".join(parts)[:n_chars]
