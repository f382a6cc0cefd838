"""Flash attention forward — a CUDA C++ kernel written for Hopper.

Counterpart of ``gke_ray_train_tpu/ops/flash_attention.py``. The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel ``_fwd_kernel``
(:175): blockwise online-softmax GQA attention that never materializes
the [S, T] logits or mask, with the mask built in-kernel from positions
and segment ids (0 = padding), causality, an optional sliding window and
a tanh logit softcap. Its source note says what bounds it on an H100
and what the design does about that.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_reference``, the plain PyTorch version of the same
function, for CPU tensors only. A CUDA tensor either reaches the kernel
or raises. The backward kernels (dQ, dK/dV) come with the training
slice; until then tensors that need a gradient raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from gke_ray_train_tpu_torch.ops.attention import NEG_INF, make_attention_mask
from gke_ray_train_tpu_torch.ops.matmul import matmul_f32

FULL_BLOCK_LIMIT = 2048  # longest sequence the JAX kernel takes as one block
DEFAULT_BLOCK_Q = 256    # the JAX kernel's default blocks
DEFAULT_BLOCK_KV = 1024

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pick_block(requested: int, n: int) -> int:
    """The JAX package's block rule: the largest 128-multiple divisor of
    ``n`` that is <= ``requested``, else ``n`` itself up to
    FULL_BLOCK_LIMIT. The wrapper calls it on S and T so that the port
    takes exactly the sequence lengths the JAX kernel takes; the CUDA
    kernel's own tiles are fixed and mask a ragged tail themselves."""
    best = None
    for b in range(128, min(requested, n) + 1, 128):
        if n % b == 0:
            best = b
    if best is None:
        if n <= FULL_BLOCK_LIMIT:
            best = n
        else:
            raise ValueError(
                f"sequence length {n} has no 128-multiple block divisor "
                f"<= {requested} and is too long for a single block; pad "
                f"to a multiple of 128 and mask via segment_ids")
    return best


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_positions: torch.Tensor,
                              kv_positions: torch.Tensor,
                              q_segment_ids: torch.Tensor,
                              kv_segment_ids: torch.Tensor, *,
                              causal: bool, sliding_window: Optional[int],
                              scale: float, logit_softcap: Optional[float]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``(out [B, S, H, dh] in
    q.dtype, lse [B, H, S] float32)``. Rows that attend nothing give
    out = 0 and lse = NEG_INF, as the TPU kernel does (:219-225) — not
    the uniform row of ``dot_product_attention``."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, dh).permute(0, 2, 3, 1, 4).reshape(
        B * K, G * S, dh)
    kt = k.permute(0, 2, 3, 1).reshape(B * K, dh, T)
    s = matmul_f32(qg, kt).reshape(B, K, G, S, T) * scale
    if logit_softcap is not None:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    mask = make_attention_mask(q_positions, kv_positions, q_segment_ids,
                               kv_segment_ids, causal=causal,
                               sliding_window=sliding_window)
    mask = mask[:, None, None, :, :]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.where(mask, s, neg)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = torch.sum(p, dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    vt = v.permute(0, 2, 1, 3).reshape(B * K, T, dh)
    acc = matmul_f32(p.to(v.dtype).reshape(B * K, G * S, T), vt)
    out = acc.reshape(B, K, G, S, dh) / safe_l
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), neg)
    return out, lse.reshape(B, H, S)


def _launch(q, k, v, qp, kp, qs, ks, *, causal, sliding_window, scale,
            logit_softcap) -> Tuple[torch.Tensor, torch.Tensor]:
    from gke_ray_train_tpu_torch.kernels import load
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = load("flash_fwd").flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kp.data_ptr(), qs.data_ptr(), ks.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, T, H, K, dh, _DTYPE_CODES[q.dtype],
                int(causal), int(sliding_window is not None),
                int(sliding_window or 0), ctypes.c_float(scale),
                ctypes.c_float(logit_softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Flash attention forward.

    q: [B, S, H, dh]; k, v: [B, T, K, dh] with H % K == 0 (GQA), all
    contiguous; on CUDA float32 or bfloat16, 16-byte aligned, with dh in
    (64, 128, 256) — what the kernel takes. positions: [B, len] absolute
    positions (default arange); segment_ids: [B, len], 0 = padding
    (default all ones). Returns out [B, S, H, dh] in q.dtype, and with
    ``return_lse`` also lse [B, H, S] float32.

    ``flash_attention.launches`` counts kernel launches."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, len, heads, head_dim]")
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % K:
        raise ValueError(f"H={H} not a multiple of KV heads {K}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward yet: the dQ/dK/dV kernels "
            "come with the training slice")
    pick_block(DEFAULT_BLOCK_Q, S)
    pick_block(DEFAULT_BLOCK_KV, T)
    scale = dh ** -0.5 if scale is None else float(scale)
    dev = q.device

    def vec(x, n, fill):
        if x is None:
            if fill == "arange":
                x = torch.arange(n, dtype=torch.int32, device=dev)
            else:
                x = torch.ones((n,), dtype=torch.int32, device=dev)
            return x.expand(B, n).contiguous()
        if tuple(x.shape) != (B, n):
            raise ValueError(f"expected a [{B}, {n}] position/segment "
                             f"array, got {tuple(x.shape)}")
        return x.to(device=dev, dtype=torch.int32).contiguous()

    qp = vec(q_positions, S, "arange")
    kp = vec(kv_positions, T, "arange")
    qs = vec(q_segment_ids, S, "ones")
    ks = vec(kv_segment_ids, T, "ones")
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale,
              logit_softcap=logit_softcap)
    if dev.type == "cuda":
        # what only the kernel restricts; the plain version takes any
        if q.dtype not in _DTYPE_CODES:
            raise TypeError(f"the flash kernel takes float32 or bfloat16, "
                            f"not {q.dtype}")
        if dh not in HEAD_DIMS:
            raise ValueError(f"the flash kernel takes head_dim in "
                             f"{HEAD_DIMS}, not {dh}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the flash kernel reads q, k, v in 16-byte "
                             "vectors: their data must be 16-byte aligned")
        out, lse = _launch(q, k, v, qp, kp, qs, ks, **kw)
    elif dev.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, qp, kp, qs, ks, **kw)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
