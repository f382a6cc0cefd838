"""Cross-framework numerical parity: our forward vs stock transformers
(torch CPU) on the SAME exported weights.

The strongest interop oracle available offline: any error in the HF
tensor-name mapping, projection transposes, RoPE layout (split-halves
convention), GQA head grouping, or q/k/v bias handling shows up as a
logits mismatch against the reference implementation the rest of the
world runs.
"""

import dataclasses

import jax
import numpy as np
import pytest

from gke_ray_train_tpu.ckpt import load_hf_checkpoint, save_hf_checkpoint
from gke_ray_train_tpu.models import (
    forward, gemma2_9b, init_params, llama3_8b, mistral_7b,
    mixtral_8x7b, qwen2_7b)
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")


def tiny_dims(preset, **kw):
    base = dict(vocab_size=257, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64,
                dtype="float32", param_dtype="float32",
                rope_scaling=None)
    base.update(kw)
    return dataclasses.replace(preset(), **base)


CASES = {
    # llama3 exercises GQA + RoPE layout; rope_scaling off so the HF
    # side computes plain RoPE at these toy dims
    "llama3": lambda: tiny_dims(llama3_8b),
    # qwen2 adds q/k/v bias (nonzero below)
    "qwen2": lambda: tiny_dims(qwen2_7b),
    # mistral adds the sliding-window mask
    "mistral": lambda: tiny_dims(mistral_7b, sliding_window=16),
    # gemma2: the full mechanism stack at once — sliding/global
    # alternation, attn+final softcaps, post-block norms, (1+w) norm,
    # gelu_tanh, tied + scaled embeddings, query_pre_attn_scalar
    "gemma2": lambda: tiny_dims(
        gemma2_9b, n_layers=4, head_dim=16, sliding_window=16,
        attn_scale=16 ** -0.5),
    # mixtral: our GShard static-capacity einsum dispatch vs HF's
    # dropless per-token routing — identical when nothing drops
    # (capacity_factor >= E/top_k = 4 is provably drop-free)
    "mixtral": lambda: tiny_dims(mixtral_8x7b, capacity_factor=4.0),
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_forward_matches_stock_transformers(tmp_path, family):
    cfg = CASES[family]()
    params = init_params(cfg, jax.random.key(0))
    if cfg.attn_qkv_bias:
        rng = np.random.default_rng(1)
        for blk in params["blocks"]:
            for b in ("bq", "bk", "bv"):
                blk[b] = blk[b] + rng.normal(0, 0.3, blk[b].shape)
    out_dir = str(tmp_path / "hf")
    save_hf_checkpoint(params, cfg, out_dir, dtype="float32")

    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ours = np.asarray(forward(params, tokens, cfg))

    model = transformers.AutoModelForCausalLM.from_pretrained(
        out_dir, dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        theirs = model(torch.from_numpy(tokens).long()).logits.numpy()

    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def _save_tiny_torch_llama(tmp_path, dtype=None):
    """One tiny HF Llama, torch-initialized and save_pretrained'd —
    shared by the reverse-direction and bf16 load tests."""
    hf_cfg = transformers.LlamaConfig(
        vocab_size=257, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg)
    if dtype is not None:
        model = model.to(dtype)
    model.eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    return model


def test_torch_saved_checkpoint_loads_exactly(tmp_path):
    """Reverse direction: a checkpoint written by STOCK transformers
    (save_pretrained — the hub-snapshot layout) loads through
    load_hf_checkpoint with bit-identical weights and matching logits.
    (Debugging note: any position-dependent logit divergence here means
    a ROPE config mismatch, not a weight-mapping bug — position 0 is
    rotation-free.)"""
    model = _save_tiny_torch_llama(tmp_path)

    cfg = tiny_dims(llama3_8b, rope_theta=10000.0)
    params = load_hf_checkpoint(str(tmp_path), cfg)
    # weight-level exactness through the reverse mapping
    sd = model.state_dict()
    np.testing.assert_array_equal(
        np.asarray(params["embed"]), sd["model.embed_tokens.weight"])
    np.testing.assert_array_equal(
        np.asarray(params["blocks"][0]["wq"][0]),
        sd["model.layers.0.self_attn.q_proj.weight"].numpy().T)

    tokens = np.random.default_rng(3).integers(
        0, 257, (2, 24)).astype(np.int32)
    ours = np.asarray(forward(params, tokens, cfg))
    with torch.no_grad():
        theirs = model(torch.from_numpy(tokens).long()).logits.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_bf16_hub_style_checkpoint_loads(tmp_path):
    """Hub snapshots ship bf16 safetensors; the loader must read them
    (numpy has no native bfloat16 — ml_dtypes provides it) straight
    into bf16 params with EXACT values and a finite forward."""
    model = _save_tiny_torch_llama(tmp_path, dtype=torch.bfloat16)
    cfg = tiny_dims(llama3_8b, rope_theta=10000.0, dtype="bfloat16",
                    param_dtype="bfloat16")
    params = load_hf_checkpoint(str(tmp_path), cfg)
    assert str(params["embed"].dtype) == "bfloat16"
    # value-level exactness: a wrong byte decode would be finite but
    # garbage — compare against the torch tensors bit-for-bit (via fp32)
    np.testing.assert_array_equal(
        np.asarray(params["embed"], dtype=np.float32),
        model.state_dict()["model.embed_tokens.weight"].float().numpy())
    np.testing.assert_array_equal(
        np.asarray(params["blocks"][0]["wq"][0], dtype=np.float32),
        model.state_dict()[
            "model.layers.0.self_attn.q_proj.weight"].float().numpy().T)
    tokens = np.random.default_rng(3).integers(
        0, 257, (2, 16)).astype(np.int32)
    assert np.isfinite(np.asarray(forward(params, tokens, cfg))).all()
