"""The port's ops (gke_ray_train_tpu_torch/ops) against the JAX package's.

Same inputs, made with numpy from a seed, through both packages at
float32 on the CPU. The Pallas flash forward runs in interpret mode, the
way tests/test_flash_attention.py runs it. Tolerances: 1e-6 for the
elementwise and dense ops (fp32, different summation order), 1e-5 for
the flash forward (blockwise online softmax against a one-shot softmax).

The kernel against its plain version on the card is
tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.ops import attention as jattn
from gke_ray_train_tpu.ops import flash_attention as jflash
from gke_ray_train_tpu.ops import norms as jnorms
from gke_ray_train_tpu.ops import rope as jrope
from gke_ray_train_tpu_torch.ops import attention as tattn
from gke_ray_train_tpu_torch.ops import flash_attention as tflash
from gke_ray_train_tpu_torch.ops import norms as tnorms
from gke_ray_train_tpu_torch.ops import rope as trope
from gke_ray_train_tpu_torch.ops.dispatch import attention_dispatch

ELEMENTWISE_TOL = 1e-6
FLASH_TOL = 1e-5
LLAMA31 = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
               original_max_position_embeddings=8192)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    r = _rng(0)
    x = r.standard_normal((2, 8, 64)).astype(np.float32)
    s = r.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(s),
                                      eps=1e-6, scale_plus_one=plus_one))
    got = tnorms.rms_norm(_t(x), _t(s), eps=1e-6,
                          scale_plus_one=plus_one).numpy()
    np.testing.assert_allclose(got, want, atol=ELEMENTWISE_TOL, rtol=0)


@pytest.mark.parametrize("scaling", [None, LLAMA31])
def test_rope_frequencies_identical(scaling):
    for hd in (16, 64, 128):
        want = jrope.rope_frequencies(hd, theta=500000.0,
                                      llama3_scaling=scaling)
        got = trope.rope_frequencies(hd, theta=500000.0,
                                     llama3_scaling=scaling)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the config's sorted-tuple form of the scaling dict
    if scaling:
        np.testing.assert_array_equal(
            trope.rope_frequencies(64, llama3_scaling=tuple(
                sorted(scaling.items()))),
            jrope.rope_frequencies(64, llama3_scaling=scaling))


def test_apply_rope_and_sinusoidal_match_jax():
    r = _rng(1)
    x = r.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = r.integers(0, 300, (2, 16)).astype(np.int32)
    inv = jrope.rope_frequencies(32, theta=10000.0, llama3_scaling=LLAMA31)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       jnp.asarray(inv)))
    got = trope.apply_rope(_t(x), _t(pos), _t(inv)).numpy()
    np.testing.assert_allclose(got, want, atol=ELEMENTWISE_TOL * 10, rtol=0)
    np.testing.assert_array_equal(trope.sinusoidal_positions(64, 32),
                                  jrope.sinusoidal_positions(64, 32))


def _positions_and_segments(B, S, seed):
    r = _rng(seed)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.ones((B, S), np.int32)
    cut = S // 3
    seg[:, cut:2 * cut] = 2
    seg[:, 2 * cut:] = 0                     # trailing padding
    seg[1] = r.permutation(seg[1])           # a scrambled row
    return pos, seg


@pytest.mark.parametrize("window", [None, 5])
def test_make_attention_mask_identical(window):
    pos, seg = _positions_and_segments(2, 24, seed=2)
    kv_pos = np.tile(np.arange(30, dtype=np.int32), (2, 1))
    want = np.asarray(jattn.make_attention_mask(
        jnp.asarray(pos), jnp.asarray(kv_pos), causal=True,
        sliding_window=window))
    got = tattn.make_attention_mask(_t(pos), _t(kv_pos), causal=True,
                                    sliding_window=window).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jattn.make_attention_mask(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg),
        jnp.asarray(seg), causal=True, sliding_window=window))
    got = tattn.make_attention_mask(_t(pos), _t(pos), _t(seg), _t(seg),
                                    causal=True,
                                    sliding_window=window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_dot_product_attention_matches_jax(softcap):
    """GQA (8 heads over 2), packed segments with padding — padding rows
    attend nothing and come out uniform in both packages."""
    r = _rng(3)
    B, S, H, K, dh = 2, 24, 8, 2, 16
    q = r.standard_normal((B, S, H, dh)).astype(np.float32)
    k = r.standard_normal((B, S, K, dh)).astype(np.float32)
    v = r.standard_normal((B, S, K, dh)).astype(np.float32)
    pos, seg = _positions_and_segments(B, S, seed=4)
    jm = jattn.make_attention_mask(jnp.asarray(pos), jnp.asarray(pos),
                                   jnp.asarray(seg), jnp.asarray(seg))
    want = np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
        logit_softcap=softcap))
    tm = tattn.make_attention_mask(_t(pos), _t(pos), _t(seg), _t(seg))
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), tm,
                                      logit_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=ELEMENTWISE_TOL, rtol=0)


FLASH_CASES = {
    "causal": dict(B=2, S=128, T=128, H=4, K=4, dh=32),
    "gqa": dict(B=1, S=128, T=128, H=8, K=2, dh=32),
    "packed_padding": dict(B=2, S=128, T=128, H=4, K=2, dh=32, packed=True),
    "window_softcap": dict(B=1, S=128, T=128, H=4, K=2, dh=64, window=24,
                           softcap=20.0),
}


def _flash_inputs(case, seed=5):
    r = _rng(seed)
    B, S, T, H, K, dh = (case[x] for x in ("B", "S", "T", "H", "K", "dh"))
    q = r.standard_normal((B, S, H, dh)).astype(np.float32)
    k = r.standard_normal((B, T, K, dh)).astype(np.float32)
    v = r.standard_normal((B, T, K, dh)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.ones((B, S), np.int32)
    if case.get("packed"):
        seg[:, 48:96] = 2
        seg[:, 96:] = 0
    return q, k, v, pos, seg


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_reference_matches_jax_kernel(case):
    """flash_attention_reference against the Pallas _fwd kernel in
    interpret mode: out and lse, including padding rows (out 0, lse
    NEG_INF)."""
    c = FLASH_CASES[case]
    q, k, v, pos, seg = _flash_inputs(c)
    scale = c["dh"] ** -0.5
    kw = dict(causal=True, window=c.get("window"), softcap=c.get("softcap"))
    j_out, j_lse = jflash._fwd(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3),
        jnp.asarray(pos)[:, None], jnp.asarray(pos)[:, None],
        jnp.asarray(seg)[:, None], jnp.asarray(seg)[:, None],
        scale=scale, block_q=64, block_kv=64, interpret=True, **kw)
    j_out = np.asarray(j_out).transpose(0, 2, 1, 3)
    j_lse = np.asarray(j_lse)[:, :, 0, :]
    t_out, t_lse = tflash.flash_attention_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(pos), _t(seg), _t(seg),
        causal=True, sliding_window=c.get("window"), scale=scale,
        logit_softcap=c.get("softcap"))
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=FLASH_TOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, atol=FLASH_TOL, rtol=0)
    # the public wrapper on CPU tensors is the plain version
    before = tflash.flash_attention.launches
    out = tflash.flash_attention(
        _t(q), _t(k), _t(v), q_positions=_t(pos), kv_positions=_t(pos),
        q_segment_ids=_t(seg), kv_segment_ids=_t(seg), causal=True,
        sliding_window=c.get("window"), scale=scale,
        logit_softcap=c.get("softcap"))
    np.testing.assert_array_equal(out.numpy(), t_out.numpy())
    assert tflash.flash_attention.launches == before   # no kernel on CPU


def test_flash_wrapper_rejects_what_it_cannot_take():
    q = torch.zeros((1, 128, 4, 32))
    k = torch.zeros((1, 128, 2, 32))
    with pytest.raises(ValueError, match="not a multiple"):
        tflash.flash_attention(q, torch.zeros((1, 128, 3, 32)),
                               torch.zeros((1, 128, 3, 32)))
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(
            1, 2), k, k)
    # tensors that need a gradient go through the autograd.Function (on
    # CPU its backward is the plain version): no raise, and a gradient
    qg = q.clone().requires_grad_(True)
    tflash.flash_attention(qg, k, k).sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape
    with pytest.raises(ValueError, match="head_dim"):
        tflash._check_kernel_inputs(q, k, k)
    with pytest.raises(ValueError, match="128"):
        # the JAX kernel's length rule: no 128-multiple block, too long
        n = tflash.FULL_BLOCK_LIMIT + 1
        tflash.flash_attention(torch.zeros((1, n, 1, 32)),
                               torch.zeros((1, n, 1, 32)),
                               torch.zeros((1, n, 1, 32)))
    assert tflash.pick_block(256, 512) == jflash.pick_block(256, 512)
    assert tflash.pick_block(1024, 200) == jflash.pick_block(1024, 200)


@pytest.mark.parametrize("impl", ["ring", "a2a"])
def test_context_parallel_impls_raise(impl):
    q = torch.zeros((1, 128, 4, 32))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        attention_dispatch(impl, q, q, q)
