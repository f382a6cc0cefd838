"""Attention implementation dispatch (counterpart of
``gke_ray_train_tpu/ops/dispatch.py``).

``"xla"`` (the dense-mask path) is handled inline in the model code;
this module routes the kernel paths, which take mask *inputs*
(positions, segment ids, causality, window) and never a materialized
[S, T] mask. The port runs on one device, so there is no mesh and no
``shard_map``: ``"flash"`` goes straight to the CUDA kernel. The
context-parallel strategies ``"ring"`` and ``"a2a"`` come with a later
slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_dispatch(impl: str, q, k, v, *,
                       q_positions=None, kv_positions=None,
                       q_segment_ids=None, kv_segment_ids=None,
                       causal: bool = True,
                       sliding_window: Optional[int] = None,
                       scale=None, logit_softcap=None) -> torch.Tensor:
    if impl == "flash":
        from gke_ray_train_tpu_torch.ops.flash_attention import (
            flash_attention)
        return flash_attention(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            causal=causal, sliding_window=sliding_window, scale=scale,
            logit_softcap=logit_softcap)
    if impl in ("ring", "a2a"):
        raise NotImplementedError(
            f"attn_impl={impl!r} (context-parallel attention across "
            "devices) is not ported yet: it comes with the multi-GPU "
            "slice of the port; use 'flash' or 'xla'")
    raise ValueError(f"unknown attn_impl {impl!r}")
