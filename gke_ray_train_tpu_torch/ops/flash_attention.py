"""Flash attention, forward and backward — CUDA C++ kernels written for
Hopper.

Counterpart of ``gke_ray_train_tpu/ops/flash_attention.py``. Three
kernels replace the Pallas TPU kernels:

- ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel`` (:175): blockwise
  online-softmax GQA attention that never materializes the [S, T]
  logits or mask, with the mask built in-kernel from positions and
  segment ids (0 = padding), causality, an optional sliding window and
  a tanh logit softcap;
- ``csrc/flash_bwd.cu::flash_bwd_dq`` replaces ``_dq_kernel`` (:303) and
  ``flash_bwd_dkv`` replaces ``_dkv_kernel`` (:339): the gradient,
  recomputing the probabilities from the saved logsumexp.

In bf16 the three kernels are Hopper designs (wgmma, a TMA ring fed by a
producer warp, tiles classed dead / boundary / interior up front; dK/dV
sums the GQA group across a thread-block cluster, so G is at most
MAX_DKV_GROUP); float32 takes their scalar bodies. Each source note
says what bounds the kernel on an H100 and what the design does about
that. ``FlashAttention`` (a ``torch.autograd.Function``)
is the counterpart of the JAX ``custom_vjp`` (:546-559): its forward
saves q, k, v, out, lse and the mask inputs; its backward forms
``D = rowsum(dO * O)`` in fp32 outside the kernels, as JAX does
(:390-395), then launches the dQ and dK/dV kernels.

CUDA tensors launch the kernels; CPU tensors run the plain PyTorch
versions beside them (``flash_attention_reference``,
``flash_attention_bwd_reference``), and only CPU tensors do. A CUDA
tensor either reaches a kernel or raises.
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
# the bf16 dK/dV kernel's cluster holds one CTA per query head of a kv
# head; 8 is the portable cluster size (every shipped preset has G <= 8)
MAX_DKV_GROUP = 8
# the bf16 kernels class at most 2,048 tiles of 64 (or 128) rows up front
MAX_KERNEL_LEN = 2048 * 64
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


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  q_positions: torch.Tensor,
                                  kv_positions: torch.Tensor,
                                  q_segment_ids: torch.Tensor,
                                  kv_segment_ids: torch.Tensor, *,
                                  causal: bool,
                                  sliding_window: Optional[int],
                                  scale: float,
                                  logit_softcap: Optional[float]
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The backward kernels' function in plain PyTorch (the JAX ``_bwd``,
    :381-480): ``(dq [B, S, H, dh], dk, dv [B, T, K, dh])`` in the input
    dtype, from the forward's ``out`` and ``lse [B, H, S]`` and the
    output gradient ``do``.

    P is recomputed from lse and multiplied by the mask (a fully masked
    row has lse = NEG_INF, and exp(NEG_INF - NEG_INF) would be 1);
    ``dS = P * (dP - D)`` with ``D = rowsum(dO * O)`` in fp32, times the
    softcap factor ``1 - (s/c)^2`` where P > 0. The operands round where
    the TPU kernels round them: ``ds`` to the q/k dtype before dS.K and
    dS^T.Q, ``p`` to the dO dtype before P^T.dO. dK and dV sum the GQA
    group in fp32 and round once, as the dK/dV kernel does (the JAX
    package rounds each head's partial first, :465-479)."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K

    def grouped(x):        # [B, S, H, dh] -> [B*K, G*S, dh]
        return x.reshape(B, S, K, G, dh).permute(0, 2, 3, 1, 4).reshape(
            B * K, G * S, dh)

    def kv_rows(x):        # [B, T, K, dh] -> [B*K, T, dh]
        return x.permute(0, 2, 1, 3).reshape(B * K, T, dh)

    qg, dog = grouped(q), grouped(do)
    kr, vr = kv_rows(k), kv_rows(v)
    s = matmul_f32(qg, kr.transpose(1, 2)).reshape(B, K, G, S, T) * scale
    if logit_softcap is not None:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    mask = make_attention_mask(q_positions, kv_positions, q_segment_ids,
                               kv_segment_ids, causal=causal,
                               sliding_window=sliding_window)
    mask = mask[:, None, None, :, :]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.where(mask, s, neg)
    lse_g = lse.reshape(B, K, G, S, 1)
    p = torch.exp(s - lse_g) * mask
    dvec = torch.sum(do.float() * out.float(), dim=-1)      # [B, S, H]
    dvec = dvec.reshape(B, S, K, G).permute(0, 2, 3, 1)[..., None]
    dp = matmul_f32(dog, vr.transpose(1, 2)).reshape(B, K, G, S, T)
    ds = p * (dp - dvec)
    if logit_softcap is not None:
        sc = torch.where(p > 0, s, torch.zeros((), device=q.device))
        ds = ds * (1.0 - (sc / logit_softcap) ** 2)
    ds_g = ds.to(k.dtype).reshape(B * K, G * S, T)
    dq = matmul_f32(ds_g, kr) * scale
    dq = dq.reshape(B, K, G, S, dh).permute(0, 3, 1, 2, 4).reshape(
        B, S, H, dh).to(q.dtype)
    # over the whole group at once: [T, G*S] @ [G*S, dh]
    dk = matmul_f32(ds_g.transpose(1, 2).contiguous(), qg) * scale
    pt = p.to(do.dtype).reshape(B * K, G * S, T)
    dv = matmul_f32(pt.transpose(1, 2).contiguous(), dog)

    def back(x, dtype):    # [B*K, T, dh] -> [B, T, K, dh]
        return x.reshape(B, K, T, dh).permute(0, 2, 1, 3).contiguous().to(
            dtype)
    return dq, back(dk, k.dtype), back(dv, v.dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, qp, kp, qs, ks, *, causal, sliding_window, scale,
            logit_softcap) -> Tuple[torch.Tensor, torch.Tensor]:
    from gke_ray_train_tpu_torch.kernels import load
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = load("flash_fwd").flash_fwd
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kp.data_ptr(), qs.data_ptr(), ks.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, T, H, K, dh, _DTYPE_CODES[q.dtype],
                int(causal), int(sliding_window is not None),
                int(sliding_window or 0), ctypes.c_float(scale),
                ctypes.c_float(logit_softcap or 0.0), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def _bwd_args(q, k, v, do, lse, dvec, qp, kp, qs, ks, kw):
    """Check what the backward kernels read, then their C arguments."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    want = {"k": (k, (B, T, K, dh), q.dtype), "v": (v, (B, T, K, dh), q.dtype),
            "do": (do, (B, S, H, dh), q.dtype),
            "lse": (lse, (B, H, S), torch.float32),
            "dvec": (dvec, (B, H, S), torch.float32),
            "q_positions": (qp, (B, S), torch.int32),
            "kv_positions": (kp, (B, T), torch.int32),
            "q_segment_ids": (qs, (B, S), torch.int32),
            "kv_segment_ids": (ks, (B, T), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name}: the backward kernels take a contiguous {shape} "
                f"{dtype} tensor on {q.device}, not {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if q.device.type != "cuda" or not q.is_contiguous() or H % K:
        raise ValueError("the backward kernels take contiguous CUDA q with "
                         "H a multiple of K")
    _check_kernel_inputs(q, k, v, do)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), dvec.data_ptr(), qp.data_ptr(), kp.data_ptr(),
           qs.data_ptr(), ks.data_ptr())
    sw = kw["sliding_window"]
    common = (B, S, T, H, K, dh, _DTYPE_CODES[q.dtype], int(kw["causal"]),
              int(sw is not None), int(sw or 0), ctypes.c_float(kw["scale"]),
              ctypes.c_float(kw["logit_softcap"] or 0.0), _stream(q))
    return ins, common


def flash_bwd_dq(q, k, v, do, lse, dvec, qp, kp, qs, ks, *, causal,
                 sliding_window, scale, logit_softcap) -> torch.Tensor:
    """dQ [B, S, H, dh] from the dQ kernel (CUDA tensors only): ``do``
    the output gradient, ``lse`` [B, H, S] from the forward, ``dvec``
    [B, H, S] = rowsum(dO * O) in fp32; the int32 mask inputs as the
    forward takes them. ``flash_bwd_dq.launches`` counts launches."""
    from gke_ray_train_tpu_torch.kernels import load
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale,
              logit_softcap=logit_softcap)
    ins, common = _bwd_args(q, k, v, do, lse, dvec, qp, kp, qs, ks, kw)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = load("flash_bwd").flash_bwd_dq(*ins, dq.data_ptr(), *common)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA "
                           f"error {rc}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dvec, qp, kp, qs, ks, *, causal,
                  sliding_window, scale, logit_softcap
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, T, K, dh] from the dK/dV kernel, the GQA group summed
    in-kernel (in bf16 over a cluster of at most MAX_DKV_GROUP query
    heads); the arguments of ``flash_bwd_dq``.
    ``flash_bwd_dkv.launches`` counts launches."""
    from gke_ray_train_tpu_torch.kernels import load
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale,
              logit_softcap=logit_softcap)
    ins, common = _bwd_args(q, k, v, do, lse, dvec, qp, kp, qs, ks, kw)
    G = q.shape[2] // k.shape[2]
    if q.dtype == torch.bfloat16 and G > MAX_DKV_GROUP:
        raise ValueError(f"the bf16 dK/dV kernel sums a GQA group of at "
                         f"most {MAX_DKV_GROUP} query heads in one thread "
                         f"block cluster, not {G}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = load("flash_bwd").flash_bwd_dkv(*ins, dk.data_ptr(),
                                             dv.data_ptr(), *common)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA "
                           f"error {rc}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _check_kernel_inputs(*ts: torch.Tensor) -> None:
    """What only the kernels restrict; the plain versions take any."""
    q = ts[0]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {q.shape[-1]}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the flash kernel reads q, k, v in 16-byte "
                         "vectors: their data must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and max(q.shape[1], ts[1].shape[1]) > \
            MAX_KERNEL_LEN:
        raise ValueError(f"the bf16 flash kernels take sequences of at "
                         f"most {MAX_KERNEL_LEN} tokens")


def _forward(q, k, v, qp, kp, qs, ks, kw):
    if q.device.type == "cuda":
        _check_kernel_inputs(q, k, v)
        return _launch(q, k, v, qp, kp, qs, ks, **kw)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, qp, kp, qs, ks, **kw)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


class FlashAttention(torch.autograd.Function):
    """Flash attention with its flash backward (the JAX ``fa`` /
    ``fa_fwd`` / ``fa_bwd``). Under ``torch.utils.checkpoint`` with
    ``use_reentrant=False`` the first forward saves nothing and the
    recomputation saves (out, lse): the forward kernel runs twice per
    backward, the dQ and dK/dV kernels once each."""

    @staticmethod
    def forward(ctx, q, k, v, qp, kp, qs, ks, kw):
        out, lse = _forward(q, k, v, qp, kp, qs, ks, kw)
        ctx.save_for_backward(q, k, v, out, lse, qp, kp, qs, ks)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _glse):
        q, k, v, out, lse, qp, kp, qs, ks = ctx.saved_tensors
        # autograd may hand over a strided or expanded gradient
        g = g.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, g, qp, kp, qs, ks, **ctx.kw)
        else:
            _check_kernel_inputs(q, k, v, g)
            # D_i = sum_d dO_id * O_id per query row, fp32, [B, H, S] like
            # lse — one elementwise pass, not worth a kernel (JAX :390-395)
            dvec = torch.sum(g.float() * out.float(), dim=-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, g, lse, dvec, qp, kp, qs, ks)
            dq = flash_bwd_dq(*args, **ctx.kw)
            dk, dv = flash_bwd_dkv(*args, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


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
    """Flash attention, differentiable in q, k and v.

    q: [B, S, H, dh]; k, v: [B, T, K, dh] with H % K == 0 (GQA), all
    contiguous; on CUDA float32 or bfloat16, 16-byte aligned, with dh in
    (64, 128, 256) — what the kernels take. positions: [B, len] absolute
    positions (default arange); segment_ids: [B, len], 0 = padding
    (default all ones). Returns out [B, S, H, dh] in q.dtype, and with
    ``return_lse`` also lse [B, H, S] float32 (not differentiable).

    ``flash_attention.launches``, ``flash_bwd_dq.launches`` and
    ``flash_bwd_dkv.launches`` count kernel launches."""
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, qp, kp, qs, ks, kw)
    else:
        out, lse = _forward(q, k, v, qp, kp, qs, ks, kw)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
