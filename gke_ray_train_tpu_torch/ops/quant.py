"""Blockwise weight quantization (counterpart of
``gke_ray_train_tpu/ops/quant.py``).

A targeted projection weight ``[..., D, F]`` (a ``[D, F]`` matrix or an
MoE expert bank ``[E, D, F]``) becomes a ``QTensor``: codes plus one fp32
scale per group of ``group`` input rows and output column (``[...,
D / group, F]``), grouped along the input dim.

- ``"nf4"``: the 4-bit NormalFloat codebook of QLoRA, absmax-scaled per
  group. ``QUANT_STORE`` picks how the codes are stored, as in the JAX
  package: ``int8`` (the default) one code a byte, ``uint4`` two codes a
  byte (``pack_uint4``; half the bytes), read from the environment at
  each quantization.
- ``"int8"``: symmetric per-group int8, one code a byte whatever
  ``QUANT_STORE`` says (JAX's rule).

Codes and scales are bitwise equal to the JAX package's: the same fp32
``w / absmax`` and the first nearest codebook entry (``argmin`` order).
``dequantize`` unpacks uint4 codes with shifts and masks, looks codes up
in the 16-entry table, the plain form on a GPU (the JAX select chain is a
TPU idiom), and multiplies in fp32 before the one cast to the compute
dtype, as JAX does.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterable, Optional, Union

import torch
from torch import nn

from gke_ray_train_tpu_torch.device import host_to_device

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
QUANT_STORES = ("int8", "uint4")


def nf4_store() -> str:
    """How NF4 codes are stored: ``QUANT_STORE`` from the environment,
    ``int8`` (default) or ``uint4``; any other value raises."""
    want = os.environ.get("QUANT_STORE", "int8").lower()
    if want not in QUANT_STORES:
        raise ValueError(f"QUANT_STORE={want!r}; use int8|uint4")
    return want


def pack_uint4(codes: torch.Tensor) -> torch.Tensor:
    """Codes 0..15 ``[..., F]`` (F even) as bytes ``[..., F / 2]`` uint8:
    column 2j in the low nibble, 2j + 1 in the high one."""
    if codes.shape[-1] % 2:
        raise ValueError(f"uint4 packing needs an even last dim, got "
                         f"{tuple(codes.shape)}")
    c = codes.to(torch.uint8)
    return (c[..., 0::2] | (c[..., 1::2] << 4)).contiguous()


def unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """``pack_uint4`` undone: bytes ``[..., F / 2]`` to codes ``[..., F]``
    uint8."""
    return torch.stack((packed & 15, packed >> 4), dim=-1).flatten(-2)


class QTensor(nn.Module):
    """codes + scales ``[..., D / group, F]`` float32. ``store`` "int8":
    codes ``[..., D, F]`` int8; "uint4" (NF4 only): codes ``[..., D,
    F / 2]`` uint8, two a byte (``pack_uint4``). ``shape`` is the logical
    ``[..., D, F]`` either way.

    A module holding two buffers, so it sits in a ``Block`` where the
    full-precision weight would, moves with ``.to()`` and never takes a
    gradient. Sharded with FSDP2 (``parallel/sharding.py``) the two are
    frozen parameters, and the codes are kept as a one-byte float dtype
    (the same bytes: FSDP2 makes every parameter it shards able to take
    a gradient, which an integer tensor cannot); :meth:`code_tensor`
    reads them back as ``code_dtype``."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor,
                 kind: str = "nf4", group: int = DEFAULT_GROUP,
                 store: str = "int8"):
        super().__init__()
        if kind not in QUANT_KINDS:
            raise ValueError(f"unknown quant kind {kind!r}")
        if store not in QUANT_STORES or (store == "uint4" and kind != "nf4"):
            raise ValueError(f"store {store!r} for quant kind {kind!r}")
        self.register_buffer("codes", codes)
        self.register_buffer("scales", scales)
        self.code_dtype = codes.dtype
        self.kind = kind
        self.group = group
        self.store = store

    @property
    def shape(self) -> torch.Size:
        s = self.codes.shape
        if self.store == "uint4":
            return torch.Size((*s[:-1], 2 * s[-1]))
        return s

    def select(self, i: int) -> "QTensor":
        """Index ``i`` of the leading dim (one expert of a bank): views of
        the codes and scales."""
        return QTensor(self.code_tensor()[i], self.scales[i], self.kind,
                       self.group, self.store)

    def code_tensor(self) -> torch.Tensor:
        """The stored codes as ``code_dtype`` (int8, or uint8 for
        uint4), whatever byte dtype holds them."""
        c = self.codes
        return c if c.dtype == self.code_dtype else c.view(self.code_dtype)

    def unpacked_codes(self) -> torch.Tensor:
        """The codes one a byte, ``[..., D, F]``."""
        if self.store == "uint4":
            return unpack_uint4(self.code_tensor())
        return self.code_tensor()

    def extra_repr(self) -> str:
        return (f"{self.kind}, shape={tuple(self.shape)}, group={self.group}"
                f", store={self.store}")


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
    largest divisor of D below it (tiny models have odd widths). NF4
    codes are stored as ``nf4_store()`` says."""
    *lead, D, F = w.shape
    if D % group:
        group = next(g for g in range(min(group, D), 0, -1) if D % g == 0)
    wg = w.float().reshape(*lead, D // group, group, F)
    absmax = torch.amax(torch.abs(wg), dim=-2, keepdim=True)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if kind == "nf4":
        scales = absmax
        codes = _nf4_codes(wg / torch.where(scales > 0, scales, one))
        store = nf4_store()
    elif kind == "int8":
        # XLA folds the JAX package's `absmax / 127.0` into a product
        # with the fp32 reciprocal; the same product keeps scales bitwise
        scales = absmax * torch.tensor(1.0 / 127.0, dtype=torch.float32)
        codes = torch.round(wg / torch.where(scales > 0, scales, one)
                            ).clamp_(-127, 127).to(torch.int8)
        store = "int8"
    else:
        raise ValueError(f"unknown quant kind {kind!r}")
    codes = codes.reshape(*lead, D, F)
    codes = pack_uint4(codes) if store == "uint4" else codes.contiguous()
    return QTensor(codes, scales[..., 0, :].contiguous(), kind, group, store)


@torch.no_grad()
def quantize_stacked(slices: Iterable[torch.Tensor], kind: str = "nf4",
                     group: int = DEFAULT_GROUP) -> QTensor:
    """One ``QTensor [E, D, F]`` from the slices ``w_e [D, F]`` of an
    expert bank, quantized one at a time: a caller that makes each slice
    as it is consumed (a generator) never holds the bank in full
    precision. Groups run along D, so this equals quantizing the stack."""
    qs = []
    for w in slices:
        qs.append(quantize_tensor(w, kind, group))
        del w               # freed before the next slice is made
    q0 = qs[0]
    return QTensor(torch.stack([q.code_tensor() for q in qs]),
                   torch.stack([q.scales for q in qs]), q0.kind, q0.group,
                   q0.store)


# the codebook as a tensor, one per device: made once, and through
# pinned memory, since a copy from pageable host memory to the card waits
# for the card
_BOOKS: Dict[torch.device, torch.Tensor] = {}


def _codebook(device: torch.device) -> torch.Tensor:
    book = _BOOKS.get(device)
    if book is None:
        book = _BOOKS[device] = host_to_device(
            torch.tensor(NF4_CODEBOOK, dtype=torch.float32), device)
    return book


def dequantize(qt: QTensor, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    """``codes -> value * scale`` in fp32, cast once to ``dtype``."""
    *lead, D, F = qt.shape
    g = qt.group
    codes = qt.unpacked_codes().reshape(*lead, D // g, g, F)
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


SERVE_QUANT_KINDS = ("none", "int8", "nf4")


def _shallow_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` sharing its tensors, with registries of its
    own: replacing a parameter of the copy leaves ``module`` as it is."""
    out = copy.copy(module)
    for reg in ("_parameters", "_buffers", "_modules"):
        object.__setattr__(out, reg, dict(getattr(module, reg)))
    return out


@torch.no_grad()
def quantize_for_serving(params: nn.Module, kind: Optional[str],
                         group: int = DEFAULT_GROUP) -> nn.Module:
    """The serving engine's weight-encoding hook (``serve/engine.py``):
    ``"none"`` returns ``params`` itself; ``"int8"`` / ``"nf4"`` return a
    new model whose projection targets are quantized, sharing every other
    tensor with ``params``, which is left as it was (the JAX package
    returns a new tree). Leaves already quantized (a QLoRA base) stay as
    they are."""
    kind = (kind or "none").strip().lower()
    if kind == "none":
        return params
    if kind not in SERVE_QUANT_KINDS:
        raise ValueError(f"serve quant kind {kind!r}; use "
                         f"{'|'.join(SERVE_QUANT_KINDS)}")
    out = _shallow_copy(params)
    out.blocks = nn.ModuleList(_shallow_copy(b) for b in params.blocks)
    return quantize_params(out, kind=kind, group=group)
