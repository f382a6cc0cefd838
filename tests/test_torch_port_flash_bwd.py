"""The port's flash-attention gradient against the JAX package's.

Same numpy inputs and output cotangent through both packages at float32
on the CPU: ``jax.grad`` of the JAX ``flash_attention`` (its custom VJP,
the Pallas ``_dq_kernel`` / ``_dkv_kernel`` in interpret mode, the way
tests/test_flash_attention.py runs them) against ``backward`` of the
port's ``flash_attention``, whose autograd.Function runs
``flash_attention_bwd_reference`` on CPU tensors. dq, dk and dv agree
within 5e-5 (the tolerance of tests/test_flash_attention.py:180: fp32
blockwise sums against one-shot ones).

The CUDA kernels against this plain version are
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.ops import flash_attention as jflash
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.ops import flash_attention as tflash

GRAD_TOL = 5e-5

CASES = {
    "causal": dict(B=2, S=128, H=4, K=4, dh=32),
    "gqa": dict(B=1, S=128, H=4, K=2, dh=64),
    "softcap": dict(B=1, S=64, H=4, K=2, dh=32, softcap=20.0),
    "window": dict(B=1, S=128, H=4, K=2, dh=32, window=24),
    "packed_padding": dict(B=2, S=128, H=4, K=2, dh=32, packed=True),
}


def _inputs(case, seed=11):
    r = np.random.default_rng(seed)
    B, S, H, K, dh = (case[x] for x in ("B", "S", "H", "K", "dh"))
    q = r.standard_normal((B, S, H, dh)).astype(np.float32)
    k = r.standard_normal((B, S, K, dh)).astype(np.float32)
    v = r.standard_normal((B, S, K, dh)).astype(np.float32)
    cot = r.standard_normal((B, S, H, dh)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.ones((B, S), np.int32)
    if case.get("packed"):
        # two documents, then a padding tail whose rows attend nothing
        seg[:, 40:90] = 2
        seg[:, 90:] = 0
    return q, k, v, cot, pos, seg


@pytest.mark.parametrize("case", CASES)
def test_flash_grads_match_jax(case):
    c = CASES[case]
    q, k, v, cot, pos, seg = _inputs(c)
    mask_kw = dict(causal=True, sliding_window=c.get("window"),
                   logit_softcap=c.get("softcap"))

    def jloss(q, k, v):
        out = jflash.flash_attention(
            q, k, v, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos), q_segment_ids=jnp.asarray(seg),
            kv_segment_ids=jnp.asarray(seg), block_q=64, block_kv=64,
            interpret=True, **mask_kw)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    before = (tflash.flash_attention.launches, tflash.flash_bwd_dq.launches,
              tflash.flash_bwd_dkv.launches)
    out = tflash.flash_attention(
        tq, tk, tv, q_positions=torch.from_numpy(pos),
        kv_positions=torch.from_numpy(pos),
        q_segment_ids=torch.from_numpy(seg),
        kv_segment_ids=torch.from_numpy(seg), **mask_kw)
    out.backward(torch.from_numpy(cot))
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name} [{case}]")
    if c.get("packed"):
        # padding rows attend nothing: no gradient reaches their queries
        assert float(tq.grad[:, 90:].abs().max()) == 0.0
    # CPU tensors never reach a kernel
    assert (tflash.flash_attention.launches, tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == before


def test_bwd_reference_equals_autograd_of_the_dense_path():
    """The plain backward against autograd through the plain forward
    (dense softmax, no recomputation from lse): same function, fp32."""
    c = dict(B=1, S=64, H=4, K=2, dh=32, softcap=30.0, window=20)
    q, k, v, cot, pos, seg = _inputs(c, seed=3)
    seg[:, 50:] = 0
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    p, s = torch.from_numpy(pos), torch.from_numpy(seg)
    kw = dict(causal=True, sliding_window=20, scale=32 ** -0.5,
              logit_softcap=30.0)
    out, lse = tflash.flash_attention_reference(*t, p, p, s, s, **kw)
    out.backward(torch.from_numpy(cot))
    dq, dk, dv = tflash.flash_attention_bwd_reference(
        *(x.detach() for x in t), out.detach(), lse.detach(),
        torch.from_numpy(cot),
        p, p, s, s, **kw)
    for got, want in zip((dq, dk, dv), (x.grad for x in t)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=0)


def test_backward_kernel_wrappers_check_their_arguments():
    """The dQ / dK/dV wrappers check shapes, dtypes and the device before
    they hand pointers to a kernel (CPU tensors never reach one)."""
    B, S, H, K, dh = 1, 128, 4, 2, 64
    q = torch.zeros((B, S, H, dh))
    kv = torch.zeros((B, S, K, dh))
    lse = torch.zeros((B, H, S))
    pos = torch.zeros((B, S), dtype=torch.int32)
    mkw = dict(causal=True, sliding_window=None, scale=0.125,
               logit_softcap=None)
    for fn in (tflash.flash_bwd_dq, tflash.flash_bwd_dkv):
        with pytest.raises(ValueError, match="lse"):
            fn(q, kv, kv, q, lse[:, :, :64], lse, pos, pos, pos, pos, **mkw)
        with pytest.raises(ValueError, match="q_segment_ids"):
            fn(q, kv, kv, q, lse, lse, pos, pos, pos.long(), pos, **mkw)
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, kv, kv, q, lse, lse, pos, pos, pos, pos, **mkw)


PRESETS = ("llama2_7b", "llama2_13b", "llama2_70b", "llama3_8b",
           "llama3_70b", "mistral_7b", "mixtral_8x7b", "qwen2_7b",
           "gemma2_9b")


@pytest.mark.parametrize("preset", PRESETS)
def test_every_preset_head_dim_is_a_kernel_head_dim(preset):
    """The head dim of every shipped model family is one the flash
    kernels take (in bf16 each has a wgmma body)."""
    cfg = getattr(tcfg, preset)(dtype="bfloat16")
    assert cfg.resolved_head_dim in tflash.HEAD_DIMS
