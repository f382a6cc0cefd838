"""Attention — the dense reference implementation (counterpart of
``gke_ray_train_tpu/ops/attention.py``).

- GQA-native: query head ``h`` reads kv head ``h // G`` (the
  ``"b s (k g) d"`` grouping); K/V are never repeated in memory.
- The mask is built from positions, segment ids (0 = padding), causality
  and an optional sliding window; logits and softmax are fp32.
- Masked logits sit at ``NEG_INF = -2e38``, not ``-inf``: a fully masked
  row comes out uniform, and masked logits in a live row underflow to
  exact zeros — the serving engine's bitwise contract rests on that.
"""

from __future__ import annotations

from typing import Optional

import torch

from gke_ray_train_tpu_torch.ops.matmul import matmul_f32

NEG_INF = -2.0e38  # fp32-safe large negative (avoid actual -inf in softmax)


def make_attention_mask(q_positions: torch.Tensor,
                        kv_positions: torch.Tensor,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        *,
                        causal: bool = True,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """Boolean mask [batch, q_len, kv_len] (True = attend).

    positions: [batch, len] absolute token positions. segment_ids:
    [batch, len]; tokens attend only within their own segment and never
    to segment 0 (padding)."""
    q_pos = q_positions[:, :, None]
    kv_pos = kv_positions[:, None, :]
    mask = torch.ones(q_pos.shape[:2] + (kv_pos.shape[-1],), dtype=torch.bool,
                      device=q_positions.device)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    if q_segment_ids is not None:
        kv_seg = (kv_segment_ids if kv_segment_ids is not None
                  else q_segment_ids)
        mask &= q_segment_ids[:, :, None] == kv_seg[:, None, :]
        mask &= kv_seg[:, None, :] != 0
    return mask


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          *,
                          scale: Optional[float] = None,
                          logit_softcap: Optional[float] = None
                          ) -> torch.Tensor:
    """GQA attention.

    q: [B, S, H, dh]; k, v: [B, T, K, dh] with H % K == 0. mask:
    [B, S, T] boolean, True = attend. Returns [B, S, H, dh] in q.dtype.
    Softmax in fp32 (max-subtract / exp / sum); the probabilities are
    cast to v.dtype before the second product, as in the JAX op."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = dh ** -0.5 if scale is None else scale

    # [B, S, (K G), dh] -> [B*K, G*S, dh] against [B*K, dh, T]
    qg = q.reshape(B, S, K, G, dh).permute(0, 2, 3, 1, 4).reshape(
        B * K, G * S, dh)
    kt = k.permute(0, 2, 3, 1).reshape(B * K, dh, T)
    logits = matmul_f32(qg, kt).reshape(B, K, G, S, T) * scale
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    vt = v.permute(0, 2, 1, 3).reshape(B * K, T, dh)
    out = matmul_f32(probs.to(v.dtype).reshape(B * K, G * S, T), vt)
    out = out.reshape(B, K, G, S, dh).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, dh).to(q.dtype)
