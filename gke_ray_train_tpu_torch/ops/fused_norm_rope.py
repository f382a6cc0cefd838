"""Fused RMSNorm, one-launch q/k RoPE and per-head RMSNorm + RoPE — CUDA
C++ kernels written for Hopper.

Counterpart of ``gke_ray_train_tpu/ops/fused_norm_rope.py`` (plan knob
``FUSED_OPS`` and the kernel registry). Three kernels of
``csrc/fused_norm_rope.cu`` replace the Pallas TPU kernels:

- ``fused_rmsnorm`` replaces ``_rmsnorm_kernel`` (:96, via
  ``fused_rmsnorm`` :129): rms_norm over the last axis in fp32, with the
  optional Gemma ``(1 + scale)``, read once and written once;
- ``fused_rope_qk`` replaces ``_rope_qk_kernel`` (:103, via
  ``fused_rope_qk`` :189): q [B, S, H, dh] and k [B, S, K, dh] rotated in
  one launch, cos / sin of ``position * inv_freq`` computed once per row
  and shared by every head of both;
- ``fused_rmsnorm_rope`` replaces ``_rmsnorm_rope_kernel`` (:112, via
  ``fused_rmsnorm_rope`` :256): per head-row of x [B, S, H, dh] the
  rms_norm over dh, then the rotation of the unrounded fp32 result, cast
  to x's dtype once. No model family calls it; the kernel registry
  (``ops/registry.py``, the ``composed_*`` cases) does.

Each is a ``torch.autograd.Function``, the counterpart of the JAX
``custom_vjp``: the rms_norm backward is the closed form of JAX :162-176
in plain fp32 torch (JAX leaves it to XLA, not Pallas); the rope backward
is the same kernel with negated frequencies (a rotation's transpose is the
inverse rotation, JAX :235-240), and saves only positions and frequencies;
the norm + rope backward un-rotates the gradient, then takes the rms_norm
backward (JAX :296-318), in fp32 torch as JAX runs it in ``jnp``.

CUDA tensors launch the kernels; CPU tensors run the plain PyTorch
versions beside them (``fused_rmsnorm_reference``,
``fused_rope_qk_reference``, ``fused_rmsnorm_rope_reference``), and only
CPU tensors do. A CUDA tensor the kernels cannot take raises; nothing
falls back. ``fused_rmsnorm.launches``, ``fused_rope_qk.launches`` and
``fused_rmsnorm_rope.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gke_ray_train_tpu_torch.ops.norms import rms_norm
from gke_ray_train_tpu_torch.ops.rope import apply_rope

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, *,
                            eps: float, scale_plus_one: bool
                            ) -> torch.Tensor:
    """The rms_norm kernel's function in plain PyTorch: ``ops/norms.py``'s
    op, the fp32 op order of JAX ``_norm_block`` (:74-81) — mean of
    squares, ``x * rsqrt(var + eps)``, times ``scale`` or ``1 + scale``,
    cast to x.dtype."""
    return rms_norm(x, scale, eps=eps, scale_plus_one=scale_plus_one)


def fused_rope_qk_reference(q: torch.Tensor, k: torch.Tensor,
                            positions: torch.Tensor, inv_freqs: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rope kernel's function in plain PyTorch: ``ops/rope.py``'s op
    on q and on k, the fp32 op order of JAX ``_rot_block`` (:84-93) —
    angles ``position * inv_freq``, split halves ``(x1 cos - x2 sin, x2
    cos + x1 sin)``, each output cast to its input's dtype."""
    return (apply_rope(q, positions, inv_freqs),
            apply_rope(k, positions, inv_freqs))


def fused_rmsnorm_rope_reference(x: torch.Tensor, scale: torch.Tensor,
                                 positions: torch.Tensor,
                                 inv_freqs: torch.Tensor, *, eps: float,
                                 scale_plus_one: bool) -> torch.Tensor:
    """The norm + rope kernel's function in plain PyTorch: ``ops/norms.py``
    then ``ops/rope.py`` on the fp32 upcast of x, cast to x.dtype once at
    the end (JAX ``_norm_block`` then ``_rot_block`` on the unrounded y,
    :112-117). Not ``fused_rope_qk_reference`` of
    ``fused_rmsnorm_reference``, which rounds y to x.dtype in between."""
    y = rms_norm(x.float(), scale, eps=eps, scale_plus_one=scale_plus_one)
    return apply_rope(y, positions, inv_freqs).to(x.dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, dev: torch.device,
           dtypes: Tuple[torch.dtype, ...]) -> None:
    if t.device != dev or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous "
            f"{' or '.join(map(str, dtypes))} tensor on {dev}, not "
            f"{t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _rmsnorm_launch(x: torch.Tensor, scale: torch.Tensor, eps: float,
                    scale_plus_one: bool) -> torch.Tensor:
    from gke_ray_train_tpu_torch.kernels import load
    D = x.shape[-1]
    _check("x", x, x.device, tuple(_DTYPE_CODES))
    _check("scale", scale, x.device, tuple(_DTYPE_CODES))
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match "
                         f"the last axis of x ({D})")
    rows = x.numel() // D if D else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        rc = load("fused_norm_rope").fused_rmsnorm(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, D,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            ctypes.c_float(eps), int(scale_plus_one), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_rmsnorm kernel launch failed: CUDA "
                           f"error {rc}")
    fused_rmsnorm.launches += 1
    return y


def _rmsnorm_backward(x, scale, g32, eps, scale_plus_one, needs):
    """(dx, dscale) of rms_norm for the fp32 output gradient ``g32``, in
    the closed form of JAX :162-176; each only where ``needs`` asks."""
    x32 = x.float()
    s = scale.float()
    if scale_plus_one:
        s = 1.0 + s
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    y = x32 * r
    dx = dscale = None
    if needs[0]:
        gy = g32 * s
        # d rms_norm: r * (gy - y * mean(gy * y))
        dx = (r * (gy - y * torch.mean(gy * y, dim=-1, keepdim=True))
              ).to(x.dtype)
    if needs[1]:
        dscale = torch.sum((g32 * y).reshape(-1, x.shape[-1]),
                           dim=0).to(scale.dtype)
    return dx, dscale


def _rmsnorm_forward(x, scale, eps, scale_plus_one):
    if x.device.type == "cuda":
        return _rmsnorm_launch(x, scale, eps, scale_plus_one)
    if x.device.type == "cpu":
        return fused_rmsnorm_reference(x, scale, eps=eps,
                                       scale_plus_one=scale_plus_one)
    raise ValueError(f"fused_rmsnorm runs on cuda or cpu, not {x.device}")


class FusedRMSNorm(torch.autograd.Function):
    """rms_norm through the kernel; the closed-form fp32 backward of JAX
    :162-176, ``dscale`` only where it is asked for."""

    @staticmethod
    def forward(ctx, x, scale, eps, scale_plus_one):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.scale_plus_one = eps, scale_plus_one
        return _rmsnorm_forward(x, scale, eps, scale_plus_one)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _rmsnorm_backward(x, scale, g.float(), ctx.eps,
                                       ctx.scale_plus_one,
                                       ctx.needs_input_grad[:2])
        return dx, dscale, None, None


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5, scale_plus_one: bool = False
                  ) -> torch.Tensor:
    """rms_norm(x, scale) over the last axis in one kernel pass,
    differentiable in x and scale. x: [..., D] float32 or bfloat16;
    scale: [D] float32 or bfloat16; the result has x's dtype. On CUDA
    both must be contiguous."""
    return FusedRMSNorm.apply(x, scale, float(eps), bool(scale_plus_one))


fused_rmsnorm.launches = 0


def _rope_launch(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                 freqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from gke_ray_train_tpu_torch.kernels import load
    B, S, H, dh = q.shape
    K = k.shape[2]
    dev = q.device
    _check("q", q, dev, tuple(_DTYPE_CODES))
    _check("k", k, dev, (q.dtype,))
    _check("positions", positions, dev, (torch.int32,))
    _check("inv_freqs", freqs, dev, (torch.float32,))
    oq = torch.empty_like(q)
    ok = torch.empty_like(k)
    if B * S == 0:
        return oq, ok
    with torch.cuda.device(dev):
        rc = load("fused_norm_rope").fused_rope_qk(
            q.data_ptr(), k.data_ptr(), positions.data_ptr(),
            freqs.data_ptr(), oq.data_ptr(), ok.data_ptr(), B, S, H, K, dh,
            _DTYPE_CODES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"fused_rope_qk kernel launch failed: CUDA "
                           f"error {rc}")
    fused_rope_qk.launches += 1
    return oq, ok


def _rope(q, k, positions, freqs):
    if q.device.type == "cuda":
        return _rope_launch(q, k, positions, freqs)
    if q.device.type == "cpu":
        return fused_rope_qk_reference(q, k, positions, freqs)
    raise ValueError(f"fused_rope_qk runs on cuda or cpu, not {q.device}")


class FusedRopeQK(torch.autograd.Function):
    """q and k rotated in one launch; the backward is the same kernel on
    the output gradients with ``-inv_freqs``. Only positions and
    frequencies are saved (JAX :232-233)."""

    @staticmethod
    def forward(ctx, q, k, positions, inv_freqs):
        ctx.save_for_backward(positions, inv_freqs)
        return _rope(q, k, positions, inv_freqs)

    @staticmethod
    def backward(ctx, gq, gk):
        positions, inv_freqs = ctx.saved_tensors
        # autograd may hand over strided gradients
        dq, dk = _rope(gq.contiguous(), gk.contiguous(), positions,
                       -inv_freqs)
        return dq, dk, None, None


def fused_rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  inv_freqs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on q [B, S, H, dh] and k [B, S, K, dh] in one kernel launch,
    differentiable in q and k. positions: [B, S] integer; inv_freqs:
    [dh // 2] float32 on q's device. On CUDA q and k are contiguous
    float32 or bfloat16 of one dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be [B, S, heads, head_dim]")
    B, S, _, dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != dh or dh % 2:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not share [B, S, ..., head_dim] with an even "
                         "head_dim")
    if tuple(inv_freqs.shape) != (dh // 2,):
        raise ValueError(f"inv_freqs {tuple(inv_freqs.shape)} is not "
                         f"[{dh // 2}]")
    if tuple(positions.shape) != (B, S):
        raise ValueError(f"positions {tuple(positions.shape)} is not "
                         f"[{B}, {S}]")
    positions = positions.to(device=q.device, dtype=torch.int32).contiguous()
    return FusedRopeQK.apply(q, k, positions, inv_freqs)


fused_rope_qk.launches = 0


# the kernel holds a head-row's pairs in registers: at most 8 a lane
MAX_NORM_ROPE_HEAD_DIM = 256


def _rmsnorm_rope_launch(x, scale, positions, freqs, eps, scale_plus_one):
    from gke_ray_train_tpu_torch.kernels import load
    B, S, H, dh = x.shape
    dev = x.device
    _check("x", x, dev, tuple(_DTYPE_CODES))
    _check("scale", scale, dev, tuple(_DTYPE_CODES))
    _check("positions", positions, dev, (torch.int32,))
    _check("inv_freqs", freqs, dev, (torch.float32,))
    if dh > MAX_NORM_ROPE_HEAD_DIM:
        raise ValueError(f"the norm + rope kernel takes head_dim <= "
                         f"{MAX_NORM_ROPE_HEAD_DIM}, not {dh}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(dev):
        rc = load("fused_norm_rope").fused_rmsnorm_rope(
            x.data_ptr(), scale.data_ptr(), positions.data_ptr(),
            freqs.data_ptr(), y.data_ptr(), B, S, H, dh,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            ctypes.c_float(eps), int(scale_plus_one), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_rmsnorm_rope kernel launch failed: CUDA "
                           f"error {rc}")
    fused_rmsnorm_rope.launches += 1
    return y


def _rmsnorm_rope_forward(x, scale, positions, freqs, eps, scale_plus_one):
    if x.device.type == "cuda":
        return _rmsnorm_rope_launch(x, scale, positions, freqs, eps,
                                    scale_plus_one)
    if x.device.type == "cpu":
        return fused_rmsnorm_rope_reference(
            x, scale, positions, freqs, eps=eps,
            scale_plus_one=scale_plus_one)
    raise ValueError(f"fused_rmsnorm_rope runs on cuda or cpu, not "
                     f"{x.device}")


class FusedRMSNormRope(torch.autograd.Function):
    """Per-head rms_norm then RoPE through the kernel. The backward is
    JAX's closed form (:296-318) in fp32 torch: the gradient un-rotated
    (the rotation with ``-inv_freqs``), then the rms_norm backward over
    dh; ``dscale`` sums over every axis but the last."""

    @staticmethod
    def forward(ctx, x, scale, positions, inv_freqs, eps, scale_plus_one):
        ctx.save_for_backward(x, scale, positions, inv_freqs)
        ctx.eps, ctx.scale_plus_one = eps, scale_plus_one
        return _rmsnorm_rope_forward(x, scale, positions, inv_freqs, eps,
                                     scale_plus_one)

    @staticmethod
    def backward(ctx, g):
        x, scale, positions, inv_freqs = ctx.saved_tensors
        gy = apply_rope(g.float(), positions, -inv_freqs)
        dx, dscale = _rmsnorm_backward(x, scale, gy, ctx.eps,
                                       ctx.scale_plus_one,
                                       ctx.needs_input_grad[:2])
        return dx, dscale, None, None, None, None


def fused_rmsnorm_rope(x: torch.Tensor, scale: torch.Tensor,
                       positions: torch.Tensor, inv_freqs: torch.Tensor, *,
                       eps: float = 1e-5, scale_plus_one: bool = False
                       ) -> torch.Tensor:
    """rms_norm over head_dim, then RoPE, in one kernel pass,
    differentiable in x and scale. x: [B, S, H, dh] float32 or bfloat16
    (on CUDA contiguous, dh <= 256); scale: [dh] float32 or bfloat16;
    positions: [B, S] integer; inv_freqs: [dh // 2] float32 on x's
    device. The result has x's shape and dtype."""
    if x.dim() != 4:
        raise ValueError("x must be [B, S, heads, head_dim]")
    B, S, _, dh = x.shape
    if dh % 2:
        raise ValueError(f"head_dim {dh} is odd")
    if tuple(scale.shape) != (dh,):
        raise ValueError(f"scale {tuple(scale.shape)} is not [{dh}]")
    if tuple(inv_freqs.shape) != (dh // 2,):
        raise ValueError(f"inv_freqs {tuple(inv_freqs.shape)} is not "
                         f"[{dh // 2}]")
    if tuple(positions.shape) != (B, S):
        raise ValueError(f"positions {tuple(positions.shape)} is not "
                         f"[{B}, {S}]")
    positions = positions.to(device=x.device, dtype=torch.int32).contiguous()
    return FusedRMSNormRope.apply(x, scale, positions, inv_freqs,
                                  float(eps), bool(scale_plus_one))


fused_rmsnorm_rope.launches = 0
