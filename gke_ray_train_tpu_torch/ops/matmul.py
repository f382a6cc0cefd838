"""Matrix products whose result is float32 whatever the input dtype.

The JAX package asks XLA for ``preferred_element_type=float32`` where a
product feeds a softmax or an argmax (attention logits, the unembedding).
A bf16 ``torch.matmul`` would round those results to bf16 and can move
an argmax. On CUDA, half-precision inputs go through the ``out_dtype``
overload of ``torch.mm`` / ``torch.bmm`` (fp32 accumulate, fp32 result,
no fp32 copy of the operands); elsewhere the operands are upcast, which
is exact for the products of bf16 values.

The ``out_dtype`` overload has no gradient formula of its own that the
port relies on, so where autograd records the product, ``_MatmulF32``
carries it: the forward is the same overload, the backward takes the
fp32 output gradient back to the operands' dtype and runs two plain
products in it, the way a bf16 ``matmul`` would.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as float32, for 2-D ``[M, K] @ [K, N]`` or batched
    3-D ``[B, M, K] @ [B, K, N]`` operands."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return _mm_f32(a, b)
    return a.float() @ b.float()
