"""Batched multi-LoRA matmul, the multi-tenant decode primitive
(counterpart of ``gke_ray_train_tpu/ops/lora_batched.py``).

Punica / S-LoRA's BGMV ("batched gather matrix-vector"): a mixed-tenant
batch carries a per-row adapter slot index ``aslot`` [B], and every row's
activations go through its own tenant's low-rank A / B pair, selected
from a stacked adapter pool, with no per-tenant dispatch.

Layout: the port's single adapter is a per-layer list ``lora[i][name] =
{"a": [d_in, r], "b": [r, d_out]}`` (``train/lora.py``); the pool
(``serve/adapters.py``) stacks adapters on a leading axis, ``pool[i][name]
= {"a": [A, d_in, r], "b": [A, r, d_out]}``.

**Gather granularity.** JAX gathers every layer's per-row adapters once,
before its block scan: a ``[n_repeats, B, d_in, r]`` transient per leaf,
B times one adapter's bytes (8 x 671 MB for r-64 fp32 adapters on the
seven projections of Llama-3.1-8B). The port's eager block loop gathers
per layer instead (``gather_pool`` on one layer's pool, called by
``models/kvcache.py::forward_step``): the same values, with 1 / n_layers
of the transient, at the cost of one gather launch per leaf and layer.

On a model sharded over ``model`` the pool stays whole on every rank;
after the gather ``models/transformer.py::_lora_entry`` takes each row's
B columns of a column-parallel projection or A rows of a row-parallel
one, so the partial product joins the base's before the all-reduce.

JAX computes this as two einsums outside any Pallas kernel, so the port
runs two ``torch.bmm``; there is no kernel of its own to write. Serving
is forward-only: the registry entry is value-only.
"""

from __future__ import annotations

from typing import Dict

import torch


def gather_pool(pool_layer: Dict[str, Dict[str, torch.Tensor]],
                aslot: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """One layer's per-row adapters from its stacked pool: ``{name: {"a":
    [A, d_in, r], "b": [A, r, d_out]}}`` and ``aslot`` [B] → the same
    dict with leaves ``[B, ...]``, row ``b`` holding adapter
    ``aslot[b]``."""
    idx = aslot.to(torch.long)
    return {name: {ab: t.index_select(0, idx) for ab, t in leaf.items()}
            for name, leaf in pool_layer.items()}


def bgmv(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
         scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Per-row low-rank bypass: row ``i`` of ``x`` [B, T, d_in] through its
    own ``a[i]`` [B, d_in, r] / ``b[i]`` [B, r, d_out] → the [B, T, d_out]
    delta. The contraction order and dtype discipline of
    ``models/transformer.py::_proj``'s single-adapter branch: x·A in
    ``dtype``, then ·B, then × scale."""
    xa = torch.bmm(x, a.to(dtype))
    return torch.bmm(xa, b.to(dtype)) * torch.full(
        (), scale, dtype=dtype, device=x.device)


def lora_batched_matmul(x: torch.Tensor, a_pool: torch.Tensor,
                        b_pool: torch.Tensor, aslot: torch.Tensor, *,
                        scale: float = 1.0,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather + ``bgmv`` for one projection, the registry-facing op:
    ``a_pool`` [A, d_in, r] / ``b_pool`` [A, r, d_out], ``x`` [B, T, d_in],
    ``aslot`` [B] → [B, T, d_out]."""
    idx = aslot.to(torch.long)
    return bgmv(x.to(dtype), a_pool.index_select(0, idx),
                b_pool.index_select(0, idx), scale=scale, dtype=dtype)
