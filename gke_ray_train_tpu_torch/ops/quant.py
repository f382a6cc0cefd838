"""Blockwise weight quantization (counterpart of
``gke_ray_train_tpu/ops/quant.py``).

A targeted projection weight ``[D, F]`` becomes a ``QTensor``: codes of
the same shape plus one fp32 scale per group of ``group`` input rows and
output column (``[D / group, F]``), grouped along the input dim.

- ``"nf4"``: the 4-bit NormalFloat codebook of QLoRA, absmax-scaled per
  group; codes are stored one per int8 (the JAX package's default
  ``QUANT_STORE=int8``; its ``uint4`` opt-in is not ported).
- ``"int8"``: symmetric per-group int8.

Codes and scales are bitwise equal to the JAX package's: the same fp32
``w / absmax`` and the first nearest codebook entry (``argmin`` order).
``dequantize`` looks codes up in the 16-entry table, the plain form on a
GPU (the JAX select chain is a TPU idiom), and multiplies in fp32 before
the one cast to the compute dtype, as JAX does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Union

import torch
from torch import nn

# NF4 codebook (QLoRA appendix E): quantiles of N(0, 1) normalized to
# [-1, 1]; the JAX package's values, float32
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0)

DEFAULT_GROUP = 64
# the weights a QLoRA fine-tune quantizes: the projections LoRA adapts
# (models/config.py::PROJ_TARGETS, kept as a copy so that this module
# imports nothing of models/, whose package imports it)
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_KINDS = ("nf4", "int8")


class QTensor(nn.Module):
    """codes ``[D, F]`` int8 + scales ``[D / group, F]`` float32.

    A module holding two buffers, so it sits in a ``Block`` where the
    full-precision weight would, moves with ``.to()`` and never takes a
    gradient."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor,
                 kind: str = "nf4", group: int = DEFAULT_GROUP):
        super().__init__()
        if kind not in QUANT_KINDS:
            raise ValueError(f"unknown quant kind {kind!r}")
        self.register_buffer("codes", codes)
        self.register_buffer("scales", scales)
        self.kind = kind
        self.group = group

    @property
    def shape(self) -> torch.Size:
        return self.codes.shape

    def extra_repr(self) -> str:
        return f"{self.kind}, shape={tuple(self.shape)}, group={self.group}"


def is_qtensor(x: Any) -> bool:
    return isinstance(x, QTensor)


def _nf4_codes(normed: torch.Tensor) -> torch.Tensor:
    """Index of the first nearest codebook entry — ``argmin`` over
    ``|normed - book|`` with its first-minimum rule, one entry at a time
    so the [..., 16] distance tensor is never formed."""
    best = torch.full_like(normed, float("inf"))
    codes = torch.zeros(normed.shape, dtype=torch.int8, device=normed.device)
    for i, c in enumerate(NF4_CODEBOOK):
        d = torch.abs(normed - torch.tensor(c, dtype=torch.float32,
                                            device=normed.device))
        closer = d < best
        best = torch.where(closer, d, best)
        codes.masked_fill_(closer, i)
    return codes


@torch.no_grad()
def quantize_tensor(w: torch.Tensor, kind: str = "nf4",
                    group: int = DEFAULT_GROUP) -> QTensor:
    """Quantize ``w [..., D, F]`` along the input dim (axis -2) in groups
    of ``group`` rows; a D that ``group`` does not divide takes the
    largest divisor of D below it (tiny models have odd widths)."""
    *lead, D, F = w.shape
    if D % group:
        group = next(g for g in range(min(group, D), 0, -1) if D % g == 0)
    wg = w.float().reshape(*lead, D // group, group, F)
    absmax = torch.amax(torch.abs(wg), dim=-2, keepdim=True)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if kind == "nf4":
        scales = absmax
        codes = _nf4_codes(wg / torch.where(scales > 0, scales, one))
    elif kind == "int8":
        # XLA folds the JAX package's `absmax / 127.0` into a product
        # with the fp32 reciprocal; the same product keeps scales bitwise
        scales = absmax * torch.tensor(1.0 / 127.0, dtype=torch.float32)
        codes = torch.round(wg / torch.where(scales > 0, scales, one)
                            ).clamp_(-127, 127).to(torch.int8)
    else:
        raise ValueError(f"unknown quant kind {kind!r}")
    return QTensor(codes.reshape(*lead, D, F).contiguous(),
                   scales[..., 0, :].contiguous(), kind, group)


# the codebook as a tensor, one per device: made once, since a copy from
# the host to the card waits for the card
_BOOKS: Dict[torch.device, torch.Tensor] = {}


def _codebook(device: torch.device) -> torch.Tensor:
    book = _BOOKS.get(device)
    if book is None:
        book = _BOOKS[device] = torch.tensor(NF4_CODEBOOK,
                                             dtype=torch.float32,
                                             device=device)
    return book


def dequantize(qt: QTensor, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    """``codes -> value * scale`` in fp32, cast once to ``dtype``."""
    *lead, D, F = qt.codes.shape
    g = qt.group
    codes = qt.codes.reshape(*lead, D // g, g, F)
    if qt.kind == "nf4":
        vals = _codebook(codes.device)[codes.int()]
    else:
        vals = codes.float()
    return (vals * qt.scales[..., :, None, :]).reshape(*lead, D, F).to(dtype)


def maybe_dequantize(w: Union[torch.Tensor, QTensor],
                     dtype: torch.dtype) -> torch.Tensor:
    """The model's weight hook: a QTensor dequantizes, a tensor casts."""
    if is_qtensor(w):
        return dequantize(w, dtype)
    return w.to(dtype)


@torch.no_grad()
def quantize_params(params: nn.Module, kind: str = "nf4",
                    group: int = DEFAULT_GROUP,
                    targets: Iterable[str] = QUANT_TARGETS) -> nn.Module:
    """Quantize the targeted projections of every block in place (the
    weight parameter is replaced by a ``QTensor``); norms, embedding and
    head stay in full precision. Returns ``params``."""
    for blk in params.blocks:
        for name in targets:
            w = getattr(blk, name)
            if is_qtensor(w):
                continue
            qt = quantize_tensor(w, kind, group)
            delattr(blk, name)
            setattr(blk, name, qt)
    return params
