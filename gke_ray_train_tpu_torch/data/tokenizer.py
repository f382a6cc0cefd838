"""Tokenizers (counterpart of ``gke_ray_train_tpu/data/tokenizer.py``,
the port's own copy; numpy only).

``CharTokenizer`` fits a char <-> id vocabulary on raw text (the
pre-train path), ``ByteTokenizer`` maps UTF-8 bytes to ids (the offline
stand-in for an HF tokenizer). Ids 0..3 are reserved (pad, bos, eos, unk)
so the segment-id / padding conventions hold everywhere. Both save to
and load from the same JSON sidecar as the JAX package's, so a tokenizer
saved by one package loads in the other.

HF tokenizers (Llama etc.) load lazily through ``transformers``: only the
tokenizer, and only where its files are at hand.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
_RESERVED = {PAD_ID: "<pad>", BOS_ID: "<bos>", EOS_ID: "<eos>",
             UNK_ID: "<unk>"}


class CharTokenizer:
    """Character-level tokenizer for the from-scratch pre-train path."""

    def __init__(self, stoi: Optional[Dict[str, int]] = None):
        self.stoi: Dict[str, int] = dict(stoi or {})
        self.itos: Dict[int, str] = {i: s for s, i in self.stoi.items()}

    @classmethod
    def fit(cls, text: str) -> "CharTokenizer":
        chars = sorted(set(text))
        stoi = {ch: i + len(_RESERVED) for i, ch in enumerate(chars)}
        return cls(stoi)

    @property
    def vocab_size(self) -> int:
        return len(self.stoi) + len(_RESERVED)

    def encode(self, text: str) -> np.ndarray:
        return np.fromiter((self.stoi.get(ch, UNK_ID) for ch in text),
                           dtype=np.int32, count=len(text))

    def decode(self, ids) -> str:
        return "".join(self.itos.get(int(i), "") for i in ids
                       if int(i) not in _RESERVED)

    def save(self, path: str) -> None:
        """One serialization shared with the artifact sidecar
        (save_tokenizer): {"type": "char", "stoi": ...}."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"type": "char", "stoi": self.stoi}, f)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path) as f:
            return cls(json.load(f)["stoi"])


class ByteTokenizer:
    """UTF-8 byte tokenizer (vocab 256 + reserved ids) — the offline /
    smoke-test stand-in for an HF tokenizer: same call surface
    (``__call__ → {"input_ids"}``, ``decode``, ``eos_token_id``)."""

    chat_template = None
    eos_token_id = EOS_ID
    pad_token_id = PAD_ID

    @property
    def vocab_size(self) -> int:
        return 256 + len(_RESERVED)

    def __call__(self, text: str, add_special_tokens: bool = False):
        ids = [b + len(_RESERVED) for b in text.encode("utf-8")]
        return {"input_ids": ids}

    def encode(self, text: str) -> List[int]:
        return self(text)["input_ids"]

    def decode(self, ids) -> str:
        # ids outside [len(_RESERVED), 256 + len(_RESERVED)) are skipped
        # like reserved ids: a model whose vocab is padded past the byte
        # range (e.g. to a sharding-divisible size) can legitimately
        # emit them while untrained, and decode must degrade like
        # errors="replace" does — not crash the inference comparison
        bs = bytes(int(i) - len(_RESERVED) for i in ids
                   if len(_RESERVED) <= int(i) < 256 + len(_RESERVED))
        return bs.decode("utf-8", errors="replace")


def load_hf_tokenizer(model_id: str, hf_token: Optional[str] = None):
    """``AutoTokenizer.from_pretrained`` with the pad-token fixup of
    ray-jobs/fine_tune_llama_ray.py:207-209. Needs ``transformers`` and the
    model's tokenizer files (the hub, or a local directory)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_id, token=hf_token)
    if tok.pad_token is None:
        tok.pad_token = tok.eos_token
    return tok


# sidecar name for the non-HF tokenizers; deliberately NOT
# "tokenizer.json" (that name belongs to HF fast-tokenizer files)
GRAFT_TOKENIZER_FILE = "graft_tokenizer.json"


def save_tokenizer(tok, out_dir: str) -> None:
    """Save the tokenizer next to the model weights so the export dir is
    a self-contained artifact (the reference ships the tokenizer with
    every merged/full model — fine_tune_llama_ray.py:355,374, and with
    the pre-train checkpoint — pytorch_llm_ray.py tokenizer save).

    HF tokenizers write their standard files (``tokenizer_config.json``
    etc. — ``AutoTokenizer.from_pretrained(out_dir)`` then loads the dir
    directly); ByteTokenizer/CharTokenizer write a small JSON sidecar
    that :func:`load_saved_tokenizer` round-trips."""
    os.makedirs(out_dir, exist_ok=True)
    if hasattr(tok, "save_pretrained"):
        tok.save_pretrained(out_dir)
        return
    path = os.path.join(out_dir, GRAFT_TOKENIZER_FILE)
    if isinstance(tok, CharTokenizer):
        tok.save(path)  # same {"type","stoi"} format as CharTokenizer
    elif isinstance(tok, ByteTokenizer):
        with open(path, "w") as f:
            json.dump({"type": "byte"}, f)
    else:
        raise TypeError(f"cannot save tokenizer of type {type(tok)!r}")


def load_saved_tokenizer(model_dir: str):
    """Load whatever :func:`save_tokenizer` put in ``model_dir``:
    the graft sidecar when present, else AutoTokenizer conventions
    (the same call a reference user makes on its output dirs)."""
    sidecar = os.path.join(model_dir, GRAFT_TOKENIZER_FILE)
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            data = json.load(f)
        kind = data.get("type")
        # legacy char files predate the "type" field but carry "stoi"
        if kind == "char" or (kind is None and "stoi" in data):
            if "stoi" not in data:
                raise ValueError(
                    f"char tokenizer sidecar {sidecar} has no 'stoi' "
                    "vocabulary — the file is corrupted")
            return CharTokenizer(data["stoi"])
        if kind == "byte":
            return ByteTokenizer()
        # an unknown type must fail, not decode with the wrong vocabulary
        # (a future 'bpe' sidecar, or corrupted JSON)
        raise ValueError(
            f"unrecognized tokenizer sidecar type {kind!r} in {sidecar} "
            "(known: 'char', 'byte') — refusing to guess a vocabulary")
    return load_hf_tokenizer(model_dir)
