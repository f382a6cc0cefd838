"""The port's decoder (gke_ray_train_tpu_torch/models) against the JAX
package's, at tiny dims on the CPU.

JAX ``init_params`` (plus a nonzero LoRA tree) is carried over with
``interop.params_from_numpy``; norm scales and biases are perturbed
first so that no family-specific parameter sits at its identity value.
Tolerances: float32 logits within 1e-4 (four layers of fp32 products in
different summation orders); caches within 1e-5; generated tokens
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import decode as jdecode
from gke_ray_train_tpu.models import kvcache as jkv
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.train.lora import LoraConfig, init_lora
from gke_ray_train_tpu_torch.interop import lora_from_numpy, params_from_numpy
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import decode as tdecode
from gke_ray_train_tpu_torch.models import kvcache as tkv
from gke_ray_train_tpu_torch.models import transformer as ttr
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


LOGITS_TOL = 1e-4
CACHE_TOL = 1e-5
V = 257

FAMILIES = {
    "llama3": dict(rope_theta=500000.0, rope_scaling=dict(
        factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_position_embeddings=8192)),
    "qwen2": dict(attn_qkv_bias=True, rope_theta=1e6, norm_eps=1e-6),
    "mistral": dict(block_pattern=("sliding",), sliding_window=16),
    "gemma2": dict(block_pattern=("sliding", "global"), sliding_window=16,
                   activation="gelu_tanh", tie_embeddings=True,
                   embed_scale=True, norm_scale_plus_one=True,
                   post_block_norm=True, attn_softcap=50.0,
                   logit_softcap=30.0, attn_scale=16 ** -0.5,
                   norm_eps=1e-6),
}


def _configs(family, **kw):
    base = dict(vocab_size=V, n_layers=4, max_seq_len=256)
    base.update(FAMILIES[family])
    base.update(kw)
    return jcfg.tiny(**base), tcfg.tiny(**base)


def _perturbed_numpy(params, seed):
    """The JAX tree as numpy, with norms and biases moved off their
    init values (ones/zeros) so every parameter matters."""
    r = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)

    def nudge(name, a):
        if "norm" in name or name in ("bq", "bk", "bv"):
            return (a + 0.1 * r.standard_normal(a.shape)).astype(a.dtype)
        return a
    tree["blocks"] = [{n: nudge(n, a) for n, a in blk.items()}
                      for blk in tree["blocks"]]
    tree["final_norm"] = nudge("final_norm", tree["final_norm"])
    return tree


def _carry(jc, tc, seed=0):
    tree = _perturbed_numpy(jtr.init_params(jc, jax.random.key(seed)), seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, params_from_numpy(tree, tc, device="cpu")


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(
        0, V, (B, S)).astype(np.int32)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_jax(family):
    jc, tc = _configs(family)
    jp, tp = _carry(jc, tc, seed=1)
    toks = _tokens(2, 40, seed=2)
    want = np.asarray(jtr.forward(jp, jnp.asarray(toks), jc))
    got = ttr.forward(tp, torch.from_numpy(toks), tc).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 40, V)
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0)


def test_forward_packed_segments_and_lora_match_jax():
    """Packed documents (segment ids + per-document positions) and a
    nonzero single adapter on every projection."""
    jc, tc = _configs("llama3")
    jp, tp = _carry(jc, tc, seed=3)
    lora = init_lora(jc, LoraConfig(r=4, alpha=8), jax.random.key(4))
    leaves, td = jax.tree.flatten(lora)
    ks = jax.random.split(jax.random.key(5), len(leaves))
    lora = jax.tree.unflatten(td, [0.05 * jax.random.normal(k, l.shape)
                                   for k, l in zip(ks, leaves)])
    tlora = lora_from_numpy(jax.tree.map(np.asarray, lora), tc, device="cpu")
    toks = _tokens(2, 48, seed=6)
    seg = np.ones((2, 48), np.int32)
    seg[:, 20:40] = 2
    seg[:, 40:] = 0
    pos = np.concatenate([np.arange(20), np.arange(20), np.arange(8)])
    pos = np.tile(pos.astype(np.int32), (2, 1))
    want = np.asarray(jtr.forward(
        jp, jnp.asarray(toks), jc, positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), lora=lora, lora_scale=2.0))
    got = ttr.forward(tp, torch.from_numpy(toks), tc,
                      positions=torch.from_numpy(pos),
                      segment_ids=torch.from_numpy(seg), lora=tlora,
                      lora_scale=2.0).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0)


def _port_cache(jcache, cfg):
    """The JAX cache ([R, B, L, K, hd] per pattern position) in the
    port's layer order."""
    P = len(cfg.block_pattern)
    return {n: np.stack([np.asarray(jcache["blocks"][i % P][n])[i // P]
                         for i in range(cfg.n_layers)])
            for n in ("k", "v")}


@pytest.mark.parametrize("family", ["llama3", "gemma2"])
def test_forward_step_flash_prefill_then_decode_match_jax(family):
    """Prefill at T=128 into a 256-wide cache — the flash gate is open in
    both packages: the Pallas kernel in interpret mode against the port's
    flash path — then three single-token decode steps (dense path)."""
    jc, tc = _configs(family, attn_impl="flash", n_layers=2)
    jp, tp = _carry(jc, tc, seed=7)
    B, T, L = 2, 128, 256
    toks = _tokens(B, T, seed=8)
    jcache = jkv.init_cache(jc, B, L)
    tcache = tkv.init_cache(tc, B, L, device="cpu")
    jlens = jnp.zeros((B,), jnp.int32)
    tlens = torch.zeros((B,), dtype=torch.int32)
    steps = [toks] + [_tokens(B, 1, seed=9 + i) for i in range(3)]
    for step_toks in steps:
        jl, jcache = jkv.forward_step(jp, jnp.asarray(step_toks), jc, jcache,
                                      jlens)
        tl, tcache = tkv.forward_step(tp, torch.from_numpy(step_toks), tc,
                                      tcache, tlens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_TOL, rtol=0)
        want = _port_cache(jcache, jc)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(), want[n],
                                       atol=CACHE_TOL, rtol=0)
        jlens = jlens + step_toks.shape[1]
        tlens = tlens + step_toks.shape[1]


@pytest.mark.parametrize("family", ["llama3", "mistral"])
def test_greedy_generation_token_identical_to_jax(family):
    """Both greedy decoders — KV-cached and full-forward — produce the
    JAX package's tokens, with an EOS that some row emits."""
    jc, tc = _configs(family, n_layers=2)
    jp, tp = _carry(jc, tc, seed=11)
    B, L, new = 2, 128, 12
    buf = np.zeros((B, L), np.int32)
    plen = np.array([9, 30], np.int32)
    r = np.random.default_rng(12)
    for b in range(B):
        buf[b, :plen[b]] = r.integers(1, V, plen[b])
    jout = np.asarray(jkv.greedy_generate_cached(
        jp, jnp.asarray(buf), jnp.asarray(plen), jc, max_new_tokens=new))
    # an EOS that the first row emits mid-generation
    eos = (int(jout[0, plen[0] + 3]),)
    for jfn, tfn in ((jkv.greedy_generate_cached,
                      tkv.greedy_generate_cached),
                     (jdecode.greedy_generate, tdecode.greedy_generate)):
        want = np.asarray(jfn(jp, jnp.asarray(buf), jnp.asarray(plen), jc,
                              max_new_tokens=new, eos_ids=eos))
        got = tfn(tp, buf, plen, tc, max_new_tokens=new, eos_ids=eos,
                  device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_init_params_shapes_and_device_rule(monkeypatch):
    _, tc = _configs("qwen2", n_layers=2)
    m = ttr.init_params(tc, seed=0, device="cpu")
    jp = jtr.init_params(_configs("qwen2", n_layers=2)[0], jax.random.key(0))
    for name, p in m.blocks[0].named_parameters():
        assert tuple(p.shape) == jp["blocks"][0][name].shape[1:], name
        assert not p.requires_grad
    assert sum(p.numel() for p in m.parameters()) == tc.param_count()
    # truncated at 3 std of 0.02; residual writers scaled by depth
    assert float(m.blocks[0].wq.abs().max()) <= 0.06 + 1e-6
    assert float(m.blocks[0].wo.std()) < float(m.blocks[0].wq.std())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_params(tc, seed=0)
    # an MoE config: the router [D, E] at std 0.02 and the expert banks
    # [E, d_in, d_out], w_down scaled by depth; quantized, the banks are
    # QTensors of that logical shape and no full-precision bank exists
    moe = dataclasses.replace(tc, n_experts=2, d_model=128, d_ff=256)
    m = ttr.init_params(moe, seed=0, device="cpu")
    blk = m.blocks[0]
    assert blk.router.shape == (128, 2)
    assert blk.w_gate.shape == blk.w_up.shape == (2, 128, 256)
    assert blk.w_down.shape == (2, 256, 128)
    assert 0.017 < float(blk.router.std()) < 0.023
    assert 0.017 < float(blk.w_gate.std()) < 0.023
    assert float(blk.w_down.std()) < 0.6 * float(blk.w_up.std())
    assert sum(p.numel() for p in m.parameters()) == moe.param_count()
    from gke_ray_train_tpu_torch.models.qinit import init_quantized_params
    from gke_ray_train_tpu_torch.ops.quant import QTensor
    q = init_quantized_params(moe, seed=0, device="cpu")
    names = {n for n, _ in q.named_parameters()}
    for key in ("w_gate", "w_up", "w_down"):
        qt = getattr(q.blocks[0], key)
        assert isinstance(qt, QTensor)
        assert qt.shape == getattr(blk, key).shape
        assert not any(n.endswith("." + key) for n in names)
    assert "blocks.0.router" in names
