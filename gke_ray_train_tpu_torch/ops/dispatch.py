"""Attention implementation dispatch (counterpart of
``gke_ray_train_tpu/ops/dispatch.py``).

``"xla"`` (the dense-mask path) is handled inline in the model code;
this module routes the kernel paths, which take mask *inputs*
(positions, segment ids, causality, window) and never a materialized
[S, T] mask. JAX wraps the kernel in a ``shard_map`` over the mesh
(:33-61); in the port every rank calls it on its own tensors, which are
already its part: its batch rows (data × fsdp), its ``S / C`` tokens of
every sequence (``context``, C its size) and, under tensor parallelism,
its ``n_heads / model`` query and ``n_kv_heads / model`` KV heads (the
GQA group is unchanged).

- ``"flash"`` goes straight to the CUDA kernel; on a mesh whose
  ``context`` exceeds 1 it raises, as JAX's does (:49-52): it would
  silently drop attention across the shards.
- ``"ring"`` (``ops/ring_attention.py``) rotates the K/V shards around
  the context ranks; without a mesh it raises ``ValueError``, as JAX's
  does.
- ``"a2a"`` (``ops/a2a_attention.py``) trades the sequence sharding for
  a head sharding and back. Without a mesh, or on one whose ``context``
  is 1, there is nothing to redistribute and it runs ``"flash"`` (JAX
  :110-118); where C does not divide the local head counts it runs the
  ring, the same function (:119-128).

``"auto"`` is resolved before this module (``models/config.py``): to
``"flash"`` on CUDA, and so at a context above 1 it raises with
``"flash"``'s message, naming ``"ring"`` / ``"a2a"``, as JAX's ``auto``
does on a TPU; it never quietly becomes the ring.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_dispatch(impl: str, q, k, v, *,
                       q_positions=None, kv_positions=None,
                       q_segment_ids=None, kv_segment_ids=None,
                       causal: bool = True,
                       sliding_window: Optional[int] = None,
                       scale=None, logit_softcap=None,
                       mesh=None) -> torch.Tensor:
    """``mesh``: the ``parallel/mesh.py::build_mesh`` mesh whose
    ``context`` axis the sequence is sharded over (None: one shard)."""
    from gke_ray_train_tpu_torch.parallel.mesh import context_size
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sliding_window=sliding_window, scale=scale,
              logit_softcap=logit_softcap)
    C = context_size(mesh)
    if impl == "a2a":
        if C == 1:
            # no context sharding to redistribute: the same computation
            impl = "flash"
        else:
            from gke_ray_train_tpu_torch.ops.a2a_attention import (
                a2a_attention, a2a_supported)
            if a2a_supported(mesh, q.shape[2], k.shape[2]):
                return a2a_attention(q, k, v, mesh=mesh, **kw)
            # C does not divide the local heads: the ring computes the
            # same function without that constraint
            impl = "ring"
    if impl == "flash":
        if C > 1:
            raise ValueError(
                f"attn_impl='flash' (or 'auto', which resolves to it) on a "
                f"mesh with context={C} would silently drop attention "
                "across the sequence shards; use attn_impl='ring' or "
                "'a2a'")
        from gke_ray_train_tpu_torch.ops.flash_attention import (
            flash_attention)
        return flash_attention(q, k, v, **kw)
    if impl == "ring":
        from gke_ray_train_tpu_torch.ops.ring_attention import (
            ring_attention)
        return ring_attention(q, k, v, mesh=mesh, **kw)
    raise ValueError(f"unknown attn_impl {impl!r}")
