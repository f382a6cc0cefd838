"""HF io of the port (``gke_ray_train_tpu_torch/ckpt/hf_io.py``) against
the ``safetensors`` package, the JAX package's ``ckpt/hf_io.py`` and
stock ``transformers``, at tiny dims on the CPU:

- the sharded writer's files and index read back through the package,
  and the reader follows an index the package's files are named in;
- a JAX ``save_hf_checkpoint`` loads into the port bitwise and the
  port's export loads into JAX bitwise (Llama; Gemma-2 with its pattern,
  ``(1 + w)`` norms and softcaps; Qwen-2 with nonzero biases; Mixtral
  with its router and per-expert tensors), in fp32 and bf16;
- ``load_hf_checkpoint(quantize="nf4" | "int8")`` gives JAX's codes and
  scales bitwise, Mixtral's expert banks included;
- the port's export passes the checks ``tests/test_hf_config_interop.py``
  and ``tests/test_torch_parity.py`` run on JAX's: stock ``AutoConfig``
  loads it, and the stock model's fp32 logits match the port's forward
  (rtol / atol 2e-4, the JAX test's; Mixtral at capacity_factor 4.0,
  where the port's static capacity drops nothing, as HF's dropless
  routing); a stock ``save_pretrained`` loads into the port exactly, a
  ``MixtralForCausalLM`` built from a local tiny config too;
- the merged LoRA export equals ``merge_lora`` followed by an export,
  bitwise, and leaves the trained state as it was.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import safetensors.torch as st_torch
import torch
import transformers

from gke_ray_train_tpu.ckpt import hf_io as jhf
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import hf_io as thf
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import forward, init_quantized_params
from gke_ray_train_tpu_torch.train import LoraConfig, init_lora, merge_lora
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _values(dtype, shape, seed):
    r = np.random.default_rng(seed)
    if dtype.is_floating_point:
        return torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(r.integers(max(info.min, -1000),
                                       min(info.max, 1000) + 1, shape)
                            ).to(dtype)


def test_sharded_writer_and_reader_agree_with_the_package(tmp_path):
    tensors = {f"t{i}": _values(torch.bfloat16, (64, 32), i)
               for i in range(5)}
    w = thf.ShardedSafetensorsWriter(str(tmp_path / "ours"),
                                     max_shard_bytes=3 * 64 * 32 * 2)
    for k, v in tensors.items():
        w.add(k, v)
    names = w.finish()
    assert names == ["model-00001-of-00002.safetensors",
                     "model-00002-of-00002.safetensors"]
    assert w.bytes_written == sum(os.path.getsize(tmp_path / "ours" / n)
                                  for n in names)
    with open(tmp_path / "ours" / thf.INDEX_FILE) as f:
        weight_map = json.load(f)["weight_map"]
    got = {}
    for fname in set(weight_map.values()):
        got.update(st_torch.load_file(str(tmp_path / "ours" / fname)))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert torch.equal(got[k], v)
        assert weight_map[k] in names
    # a directory the package wrote, shards and index, read by the port
    d = tmp_path / "theirs"
    d.mkdir()
    wm = {}
    for i, part in enumerate((["t0", "t1"], ["t2", "t3", "t4"])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        st_torch.save_file({k: tensors[k] for k in part}, str(d / fname))
        wm.update({k: fname for k in part})
    with open(d / thf.INDEX_FILE, "w") as f:
        json.dump({"metadata": {}, "weight_map": wm}, f)
    r = thf.ShardedReader(str(d))
    assert sorted(r.keys()) == sorted(tensors) and "t3" in r
    for k, v in tensors.items():
        assert torch.equal(r.get_tensor(k), v)
    r.close()
    # one shard: a plain model.safetensors, no index; abort removes tmps
    w1 = thf.ShardedSafetensorsWriter(str(tmp_path / "one"))
    w1.add("x", tensors["t0"])
    assert w1.finish() == [thf.SINGLE_FILE]
    assert sorted(os.listdir(tmp_path / "one")) == [thf.SINGLE_FILE]
    w2 = thf.ShardedSafetensorsWriter(str(tmp_path / "ab"),
                                      max_shard_bytes=1)
    w2.add("x", tensors["t0"])
    w2.add("y", tensors["t1"])
    w2.abort()
    assert os.listdir(tmp_path / "ab") == []


def _tiny_dims(preset, **kw):
    base = dict(vocab_size=257, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32",
                param_dtype="float32", rope_scaling=None)
    base.update(kw)
    return dataclasses.replace(preset(), **base)


FAMILIES = {
    "llama3": ("llama3_8b", {}),
    "qwen2": ("qwen2_7b", {}),
    "mistral": ("mistral_7b", {"sliding_window": 16}),
    "gemma2": ("gemma2_9b", {"n_layers": 4, "head_dim": 16,
                             "sliding_window": 16,
                             "attn_scale": 16 ** -0.5}),
    # 8 experts, top 2: capacity_factor E / K = 4 is drop-free
    "mixtral": ("mixtral_8x7b", {"capacity_factor": 4.0}),
}


def _configs(family):
    preset, kw = FAMILIES[family]
    return (_tiny_dims(getattr(jcfg, preset), **kw),
            _tiny_dims(getattr(tcfg, preset), **kw))


def _jax_params(jc, seed=0):
    """Random JAX params; the biases and norm scales nonzero / off one so
    every leaf is told apart."""
    params = jtr.init_params(jc, jax.random.key(seed))
    r = np.random.default_rng(seed + 1)
    for blk in params["blocks"]:
        for k in list(blk):
            if k.startswith("b") or k.endswith("norm"):
                blk[k] = blk[k] + r.normal(0, 0.3, blk[k].shape).astype(
                    np.float32)
    params["final_norm"] = params["final_norm"] + 0.25
    return params


def _assert_models_equal(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype, k
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["llama3", "gemma2", "qwen2",
                                    "mixtral"])
def test_exports_cross_between_the_packages_bitwise(tmp_path, family,
                                                    dtype):
    jc, tc = _configs(family)
    params = _jax_params(jc)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jhf.save_hf_checkpoint(params, jc, jdir, dtype=dtype)
    # JAX -> port: the port reads what JAX reads back from its own export
    ours = thf.load_hf_checkpoint(jdir, tc, device="cpu")
    want = interop.params_from_numpy(
        _np(jhf.load_hf_checkpoint(jdir, jc)), tc, device="cpu")
    _assert_models_equal(ours, want)
    if dtype == "float32":
        _assert_models_equal(ours, interop.params_from_numpy(
            _np(params), tc, device="cpu"))
    # port -> JAX: the port's export of the JAX weights loads into JAX
    # as JAX's own export does
    info = thf.save_hf_checkpoint(
        interop.params_from_numpy(_np(params), tc, device="cpu"), tc, tdir,
        dtype=dtype)
    assert info["shards"] == [thf.SINGLE_FILE] and info["bytes"] > 0
    got = _np(jhf.load_hf_checkpoint(tdir, jc))
    ref = _np(jhf.load_hf_checkpoint(jdir, jc))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    with open(os.path.join(tdir, "config.json")) as f:
        ours_cfg = json.load(f)
    with open(os.path.join(jdir, "config.json")) as f:
        assert ours_cfg == json.load(f)
    # the same tensor names, shapes and dtypes in both files
    a, b = thf.ShardedReader(tdir), thf.ShardedReader(jdir)
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        assert torch.equal(a.get_tensor(k), b.get_tensor(k)), k


@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_quantize_on_load_matches_jax(tmp_path, kind):
    jc, tc = _configs("qwen2")
    jc = dataclasses.replace(jc, d_model=128, d_ff=256, n_heads=4)
    tc = dataclasses.replace(tc, d_model=128, d_ff=256, n_heads=4)
    d = str(tmp_path / "hf")
    jhf.save_hf_checkpoint(_jax_params(jc), jc, d, dtype="bfloat16")
    theirs = jhf.load_hf_checkpoint(d, jc, quantize=kind)
    ours = thf.load_hf_checkpoint(d, tc, quantize=kind, device="cpu")
    P = len(jc.block_pattern)
    for i, blk in enumerate(ours.blocks):
        for key in thf.QUANT_TARGETS:
            q, jq = getattr(blk, key), theirs["blocks"][i % P][key]
            assert q.kind == jq.kind == kind and q.group == jq.group
            np.testing.assert_array_equal(
                q.codes.numpy(), np.asarray(jq.codes)[i // P], err_msg=key)
            np.testing.assert_array_equal(
                q.scales.numpy(), np.asarray(jq.scales)[i // P],
                err_msg=key)
        for key in ("attn_norm", "mlp_norm", "bq"):
            np.testing.assert_array_equal(
                getattr(blk, key).detach().numpy(),
                np.asarray(theirs["blocks"][i % P][key])[i // P])
    np.testing.assert_array_equal(ours.embed.detach().numpy(),
                                  np.asarray(theirs["embed"]))


CONFIG_CASES = [
    ("llama3_8b", "LlamaConfig", "llama"),
    ("llama2_7b", "LlamaConfig", "llama"),
    ("mistral_7b", "MistralConfig", "mistral"),
    ("mixtral_8x7b", "MixtralConfig", "mixtral"),
    ("gemma2_9b", "Gemma2Config", "gemma2"),
    ("qwen2_7b", "Qwen2Config", "qwen2"),
]


@pytest.mark.parametrize("preset,config_cls,model_type", CONFIG_CASES,
                         ids=[p for p, _, _ in CONFIG_CASES])
def test_autoconfig_loads_the_port_export(tmp_path, preset, config_cls,
                                          model_type):
    cfg = getattr(tcfg, preset)()
    thf.write_hf_config(cfg, str(tmp_path / "ours"))
    (tmp_path / "jax").mkdir()
    jhf.write_hf_config(getattr(jcfg, preset)(), str(tmp_path / "jax"))
    with open(tmp_path / "ours" / "config.json") as f:
        ours = json.load(f)
    with open(tmp_path / "jax" / "config.json") as f:
        assert ours == json.load(f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path / "ours"))
    assert type(hf).__name__ == config_cls
    assert hf.model_type == model_type
    assert hf.hidden_size == cfg.d_model
    assert hf.num_hidden_layers == cfg.n_layers
    assert hf.num_key_value_heads == cfg.n_kv_heads
    if model_type == "gemma2":
        assert hf.attn_logit_softcapping == 50.0
        assert hf.final_logit_softcapping == 30.0
        assert hf.query_pre_attn_scalar == 256
    if model_type == "llama" and cfg.rope_scaling:
        rs = dict(cfg.rope_scaling)
        assert hf.rope_scaling["rope_type"] == "llama3"
        assert hf.rope_scaling["original_max_position_embeddings"] \
            == rs["original_max_position_embeddings"]
        assert hf.rope_scaling["factor"] == rs["factor"]
        assert hf.max_position_embeddings == cfg.max_seq_len


def test_unknown_family_keeps_custom_tag(tmp_path):
    cfg = dataclasses.replace(tcfg.tiny(), name="basic-lm")
    thf.write_hf_config(cfg, str(tmp_path))
    with open(tmp_path / "config.json") as f:
        data = json.load(f)
    assert data["architectures"] == ["GkeRayTrainTpuForCausalLM"]
    assert "model_type" not in data


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_export_matches_stock_transformers(tmp_path, family):
    jc, tc = _configs(family)
    model = interop.params_from_numpy(_np(_jax_params(jc)), tc, device="cpu")
    out_dir = str(tmp_path / "hf")
    thf.save_hf_checkpoint(model, tc, out_dir, dtype="float32")
    tokens = np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 24)).astype(np.int64)
    with torch.no_grad():
        ours = forward(model, torch.from_numpy(tokens), tc).numpy()
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        out_dir, dtype=torch.float32)
    hf.eval()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def _save_tiny_torch_llama(path, dtype=None):
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
    model.save_pretrained(str(path), safe_serialization=True)
    return model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stock_save_pretrained_loads_exactly(tmp_path, dtype):
    """A checkpoint stock transformers wrote (the hub's layout) loads with
    the same weights, in bf16 too, and the same fp32 logits."""
    hf = _save_tiny_torch_llama(tmp_path, dtype)
    name = "float32" if dtype is torch.float32 else "bfloat16"
    cfg = _tiny_dims(tcfg.llama3_8b, rope_theta=10000.0, dtype=name,
                     param_dtype=name)
    model = thf.load_hf_checkpoint(str(tmp_path), cfg, device="cpu")
    sd = hf.state_dict()
    assert model.embed.dtype == dtype
    assert torch.equal(model.embed, sd["model.embed_tokens.weight"])
    assert torch.equal(model.blocks[1].wq,
                       sd["model.layers.1.self_attn.q_proj.weight"].T)
    assert torch.equal(model.lm_head, sd["lm_head.weight"].T)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 257, (2, 24)))
    with torch.no_grad():
        ours = forward(model, tokens, cfg)
    assert torch.isfinite(ours).all()
    if dtype is torch.float32:
        with torch.no_grad():
            theirs = hf(tokens).logits
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_merged_lora_export_equals_merge_lora(tmp_path):
    """The export's per-projection merge equals ``merge_lora`` then an
    export, bitwise, on an NF4 base, and leaves the base quantized and
    the adapters as they were."""
    cfg = tcfg.tiny(vocab_size=97, d_model=64, d_ff=128,
                    dtype="bfloat16", param_dtype="bfloat16")
    base = init_quantized_params(cfg, seed=0, device="cpu")
    lcfg = LoraConfig(r=4, alpha=8)
    lora = init_lora(cfg, lcfg, seed=1, device="cpu")
    with torch.no_grad():
        for layer in lora:
            for ab in layer.values():
                ab["b"].normal_(0, 0.05)
    codes = base.blocks[0].wq.codes.clone()
    thf.save_hf_checkpoint(base, cfg, str(tmp_path / "stream"), lora=lora,
                           lora_scale=lcfg.scale)
    assert torch.equal(base.blocks[0].wq.codes, codes)
    merged = merge_lora(init_quantized_params(cfg, seed=0, device="cpu"),
                        lora, lcfg)
    thf.save_hf_checkpoint(merged, cfg, str(tmp_path / "merged"))
    a = st_torch.load_file(str(tmp_path / "stream" / thf.SINGLE_FILE))
    b = st_torch.load_file(str(tmp_path / "merged" / thf.SINGLE_FILE))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_mixtral_round_trip_quantized_and_stock(tmp_path, kind):
    """Mixtral: a JAX bf16 export loads quantized into the port with JAX's
    codes and scales, the expert banks streamed one (layer, expert) at a
    time; a stock ``MixtralForCausalLM`` (a local tiny config, no
    download) saved with ``save_pretrained`` loads into the port with its
    router and experts in place and the same fp32 logits, drop-free; and
    an unknown quant kind is refused."""
    jc, tc = _configs("mixtral")
    d = str(tmp_path / "jax")
    jhf.save_hf_checkpoint(_jax_params(jc), jc, d, dtype="bfloat16")
    theirs = jhf.load_hf_checkpoint(d, jc, quantize=kind)
    ours = thf.load_hf_checkpoint(d, tc, quantize=kind, device="cpu")
    for i, blk in enumerate(ours.blocks):
        for key in thf.QUANT_TARGETS:
            q, jq = getattr(blk, key), theirs["blocks"][0][key]
            assert q.kind == jq.kind == kind and q.group == jq.group
            np.testing.assert_array_equal(
                q.codes.numpy(), np.asarray(jq.codes)[i], err_msg=key)
            np.testing.assert_array_equal(
                q.scales.numpy(), np.asarray(jq.scales)[i], err_msg=key)
        assert tuple(blk.w_down.shape) == (8, tc.d_ff, tc.d_model)
        np.testing.assert_array_equal(
            blk.router.detach().numpy(),
            np.asarray(theirs["blocks"][0]["router"])[i])

    hf_cfg = transformers.MixtralConfig(
        vocab_size=257, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rope_theta=1e6, rms_norm_eps=1e-5,
        tie_word_embeddings=False, sliding_window=None)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path / "stock"), safe_serialization=True)
    cfg = dataclasses.replace(tc, n_experts=4)
    model = thf.load_hf_checkpoint(str(tmp_path / "stock"), cfg,
                                   device="cpu")
    sd = hf.state_dict()
    mlp = "model.layers.1.block_sparse_moe"
    assert torch.equal(model.blocks[1].router, sd[f"{mlp}.gate.weight"].T)
    assert torch.equal(model.blocks[1].w_up[3],
                       sd[f"{mlp}.experts.3.w3.weight"].T)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 257, (2, 24)))
    with torch.no_grad():
        np.testing.assert_allclose(forward(model, tokens, cfg).numpy(),
                                   hf(tokens).logits.numpy(),
                                   rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="quantize"):
        thf.load_hf_checkpoint(str(tmp_path), tcfg.tiny(), quantize="fp8",
                               device="cpu")
