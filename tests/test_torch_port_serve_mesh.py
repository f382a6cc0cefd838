"""Serving across ranks: the port's KV-cache decode, ``BatchEngine`` and
both entries' serving branches on a model sharded as it was trained,
in gloo worlds on the CPU (``tests/_torch_serve_mesh.py``), held against
the one-process port and against the JAX package's generate on its
mesh of the same shape (``tree_shardings`` of ``param_specs``, as
``tests/test_inference_multihost.py`` shards it) on the fake devices.

Tiny fp32 models (2 layers, d_model 64, 4 heads over 2 KV heads, d_ff
128, vocab 256): a Llama (flash prefill on the local heads), a Gemma-2
(softcaps, a sliding window, tied embedding; ``attn_impl`` a2a), a
Qwen-2 (q/k/v biases drawn nonzero) and a Mixtral-style MoE (4 experts,
top 2, capacity factor 4.0). Two prompts of 40 and 97 tokens in a
256-wide buffer, 16 new tokens. Worlds: fsdp 2 and model 2 (2 ranks);
fsdp 2 × model 2, data 2 × fsdp 2 and fsdp 2 × context 2 (4 ranks).
The prefill and first-step logits agree within 1e-5 with one process
and with JAX's mesh; the greedy tokens are equal to both and across the
ranks. Then: the adapter-pool engine at model 2 against one process,
``SPEC_DRAFT`` / ``SERVE_QUANT`` refused, and both entries at world 2
with ``INFERENCE`` and ``SERVE_AFTER_TRAIN``: the files written once, by
rank 0, the base answers a world-1 run's; beyond one node the pre-train
entry's smoke warns and skips.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import kvcache as jkv
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.parallel.sharding import tree_shardings
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.train import LoraConfig, init_lora
from tests import _torch_multirank as mr
from tests import _torch_serve_mesh as sm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, L, MAX_NEW = 256, 256, 16
PLEN = (40, 97)
TOL = 1e-5                      # logits: ranks against one process, JAX
BASE = dict(vocab_size=V, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
            n_layers=2, max_seq_len=L)
# family: (the shared config, the port's attn_impl)
FAMILIES = {
    "llama": ({}, "flash"),
    "gemma": (dict(logit_softcap=30.0, attn_softcap=50.0,
                   tie_embeddings=True, post_block_norm=True,
                   norm_scale_plus_one=True, embed_scale=True,
                   activation="gelu_tanh",
                   block_pattern=("sliding", "global"), sliding_window=64),
              "a2a"),
    "qwen": (dict(attn_qkv_bias=True), "flash"),
    "moe": (dict(n_experts=4, expert_top_k=2, capacity_factor=4.0),
            "xla"),
}
# shape: (mesh axes, world, the cases decoded on it)
MESHES = {"fsdp2": (dict(fsdp=2), 2, ("llama", "moe")),
          "model2": (dict(fsdp=1, model=2), 2, ("llama", "gemma", "qwen")),
          "fsdp_model": (dict(fsdp=2, model=2), 4, ("llama",)),
          "hsdp": (dict(data=2, fsdp=2), 4, ("llama",)),
          "fsdp_context": (dict(fsdp=2, context=2), 4, ("gemma",))}
EOS = 7
SCALE = 2.0
FT_INFER = {"NUM_EVAL_SAMPLES_INFERENCE": 2,
            "MAX_NEW_GENERATION_TOKENS_INFERENCE": 16,
            "INFERENCE": True, "SERVE_AFTER_TRAIN": True}


def _cfgs(family):
    kw, impl = FAMILIES[family]
    kw = dict(BASE, **kw)
    return jcfg.tiny(**kw), tcfg.tiny(**dict(kw, attn_impl=impl))


def _jax_params(family, jc):
    params = jtr.init_params(jc, jax.random.key(3))
    if family != "qwen":
        return params
    r = np.random.default_rng(5)

    def bias(path, x):
        name = jax.tree_util.keystr(path)
        if any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            return x + jnp.asarray(0.1 * r.standard_normal(x.shape),
                                   x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(bias, params)


def _prompt():
    r = np.random.default_rng(11)
    buf = np.zeros((len(PLEN), L), np.int32)
    for i, n in enumerate(PLEN):
        buf[i, :n] = r.integers(1, V, n)
    return buf


def _jax_mesh_run(jc, jp, case, axes):
    """JAX's prefill and first-step logits and generate on its mesh of
    ``axes``, the params placed by ``param_specs``."""
    full = {**dict(data=1, fsdp=1, model=1, context=1), **axes}
    n = int(np.prod(list(full.values())))
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**full), jax.devices()[:n])
    params = jax.device_put(jp, tree_shardings(mesh, jtr.param_specs(jc)))
    prompt, plen = jnp.asarray(case["prompt"]), jnp.asarray(case["plen"])
    B = prompt.shape[0]
    Lp = sm.prefill_width(L, MAX_NEW)
    step = jax.jit(jkv.forward_step, static_argnums=2)
    pre, cache = step(params, prompt[:, :Lp], jc, jkv.init_cache(jc, B, L),
                      jnp.zeros((B,), jnp.int32))
    first = jnp.argmax(pre[jnp.arange(B), plen - 1], axis=-1).astype(
        jnp.int32)
    dec, _ = step(params, first[:, None], jc, cache, plen)
    tokens = jkv.greedy_generate_cached(params, prompt, plen, jc,
                                        max_new_tokens=MAX_NEW)
    return {"prefill": np.asarray(pre), "first": np.asarray(first),
            "decode": np.asarray(dec[:, 0]), "tokens": np.asarray(tokens)}


def _engine_job(tc):
    tenants = {}
    for i, aid in enumerate(("t1", "t2")):
        lora = init_lora(tc, LoraConfig(r=4, alpha=8), seed=20 + i,
                         device="cpu")
        g = torch.Generator().manual_seed(30 + i)
        tenants[aid] = [
            {name: {"a": ab["a"].detach().clone(),
                    "b": 0.05 * torch.randn(ab["b"].shape, generator=g)}
             for name, ab in layer.items()} for layer in lora]
    r = np.random.default_rng(13)
    requests = [(r.integers(1, V, n).astype(np.int32), m, tag)
                for n, m, tag in ((30, 12, "t1"), (9, 20, None),
                                  (51, 8, "t2"), (17, 16, "t1"),
                                  (64, 10, None))]
    return {"tenants": tenants, "scale": SCALE, "eos": EOS,
            "requests": requests}


def _ft_config(out, world):
    return {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
            "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": 384,
            "NUM_TRAIN_SAMPLES": 4, "NUM_EVAL_SAMPLES": 4,
            "PER_DEVICE_TRAIN_BATCH_SIZE": 1,
            "GRADIENT_ACCUMULATION_STEPS": 2 // world,
            "NUM_TRAIN_EPOCHS": 1, "LEARNING_RATE": 1e-3,
            "LORA_DROPOUT": 0.0, "USE_QLORA": True, "LORA_R": 4,
            "LORA_ALPHA": 8, "MESH_DATA": 1, "MESH_FSDP": -1,
            "SAVE_STRATEGY": "no", "EVALUATION_STRATEGY_SFT": "no",
            "LOGGING_STEPS": 1, "REPORT_TO": "none",
            "OUTPUT_DIR_BASE": str(out), **FT_INFER}


def _pretrain_config(out):
    return {"d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 128,
            "dataset_seq_len": 32, "model_max_seq_len": 128,
            "batch_size_per_device": 2, "max_samples": 16, "lr": 1e-3,
            "weight_decay": 0.01, "warmup_frac": 0.25, "min_lr_frac": 0.01,
            "grad_clip": 1.0, "epochs": 1, "log_every": 1,
            "prefetch_batches": 0, "dtype": "float32",
            "data_dir": os.path.join(out, "data"),
            "storage_path": os.path.join(out, "pretrain"), "run_name": "lm",
            "MESH_FSDP": -1, "MESH_DATA": 1, "SERVE_AFTER_TRAIN": True}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, monkeypatch_module):
    out = str(tmp_path_factory.mktemp("serve_mesh"))
    monkeypatch_module.setenv("HF_HUB_OFFLINE", "1")
    mr.clear_rendezvous(monkeypatch_module)
    cases, jax_side = {}, {}
    for family in FAMILIES:
        jc, tc = _cfgs(family)
        jp = _jax_params(family, jc)
        params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                           device="cpu")
        cases[family] = {"cfg": tc.to_dict(), "params": params.state_dict(),
                         "prompt": _prompt(), "plen": np.asarray(PLEN,
                                                                 np.int32),
                         "max_new": MAX_NEW}
        jax_side[family] = (jc, jp)
    _, tc = _cfgs("llama")
    inputs = {"cases": cases,
              "meshes": {s: m[2] for s, m in MESHES.items()},
              "world4": {s: m[0] for s, m in MESHES.items() if m[1] == 4},
              "engine": _engine_job(tc),
              "fine_tune": _ft_config(os.path.join(out, "ft2"), 2),
              "pretrain": _pretrain_config(out)}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    procs = {"serve2": sm.start("serve2", out, n=2),
             "serve4": sm.start("serve4", out, n=4)}
    # while the ranks run: one process of the port, JAX's meshes
    one = {}
    for family, case in cases.items():
        params, cfg = sm.model_of(case)
        one[family] = sm.run_decode(params, cfg, case)
    params, cfg = sm.model_of(cases["llama"])
    one["engine"] = sm.run_engine(params, cfg, inputs["engine"])
    jax_mesh = {}
    for shape, (axes, _, names) in MESHES.items():
        for family in names:
            jc, jp = jax_side[family]
            jax_mesh[(shape, family)] = _jax_mesh_run(jc, jp, cases[family],
                                                      axes)
    one["fine_tune"] = sm.run_fine_tune(
        _ft_config(os.path.join(out, "ft1"), 1))
    mr.wait(procs["serve2"], timeout=300)
    mr.wait(procs["serve4"], timeout=300)
    res = {name: [torch.load(os.path.join(out, f"{name}_{r}.pt"),
                             weights_only=False) for r in range(n)]
           for name, n in (("serve2", 2), ("serve4", 4))}
    return dict(out=out, one=one, jax_mesh=jax_mesh, res=res)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _rank_results(worlds, shape):
    world = "serve2" if MESHES[shape][1] == 2 else "serve4"
    return [r[shape] for r in worlds["res"][world]]


def _whole_vocab(ranks, family, key):
    """Each rank's logits over the whole vocab: its own, or under TP its
    model group's shards in model-rank order (``model`` is the fastest
    axis of these meshes: a group is ``model`` consecutive ranks)."""
    m = 2 // ranks[0][family]["kv_heads"]
    out = []
    for i in range(len(ranks)):
        group = sorted(ranks[i - i % m:i - i % m + m],
                       key=lambda r: r["model_rank"])
        out.append(torch.cat([r[family][key] for r in group], dim=-1))
    return out


CASES = [(shape, family) for shape, m in MESHES.items() for family in m[2]]


@pytest.mark.parametrize("shape,family", CASES,
                         ids=[f"{s}-{f}" for s, f in CASES])
def test_sharded_decode_matches_one_process_and_jax_mesh(worlds, shape,
                                                         family):
    """The prefill and first-step logits within 1e-5 of one process's and
    JAX's mesh generate's, the greedy tokens equal to both on every
    rank, and under ``model`` 2 a rank's cache of 1 of the 2 KV heads."""
    ranks = _rank_results(worlds, shape)
    one, jx = worlds["one"][family], worlds["jax_mesh"][(shape, family)]
    model = MESHES[shape][0].get("model", 1)
    for key in ("prefill", "decode"):
        for got in _whole_vocab(ranks, family, key):
            np.testing.assert_allclose(got.numpy(), one[key].numpy(),
                                       rtol=0, atol=TOL, err_msg=key)
            np.testing.assert_allclose(got.numpy(), jx[key], rtol=0,
                                       atol=TOL, err_msg=key)
    for r in ranks:
        np.testing.assert_array_equal(r[family]["first"].numpy(), jx["first"])
        np.testing.assert_array_equal(r[family]["tokens"].numpy(),
                                      one["tokens"].numpy())
        np.testing.assert_array_equal(r[family]["tokens"].numpy(),
                                      jx["tokens"])
        assert r[family]["kv_heads"] == 2 // model
    # the generate wrote new tokens (not a vacuous buffer)
    assert (one["tokens"].numpy()[0, PLEN[0]:PLEN[0] + MAX_NEW] != 0).any()


def test_engine_with_adapter_pool_at_model2_matches_one_process(worlds):
    """Tagged requests through the pool (one tenant slot, two tenants,
    so it evicts and waits on pins) at model 2: every rank's completions
    and counters equal one process's; the collective smoke returns on
    rank 0 alone, its tokens one process's."""
    one = worlds["one"]["engine"]
    ranks = [r["engine"] for r in worlds["res"]["serve2"]]
    assert one["stats"]["adapter_evictions"] > 0
    for r in ranks:
        assert len(r["tokens"]) == len(one["tokens"])
        for got, want in zip(r["tokens"], one["tokens"]):
            np.testing.assert_array_equal(got, want)
        assert r["lengths"] == one["lengths"]
        assert r["stats"] == one["stats"]
    assert ranks[1]["smoke"] is None
    toks, stats = ranks[0]["smoke"]
    wtoks, wstats = one["smoke"]
    assert stats == wstats and stats["adapter_requests"] == 1
    for got, want in zip(toks, wtoks):
        np.testing.assert_array_equal(got, want)


def test_spec_draft_and_serve_quant_refused_on_a_sharded_model(worlds):
    for r in worlds["res"]["serve2"]:
        for key in ("SPEC_DRAFT", "SERVE_QUANT"):
            msg = r["refusals"][key]
            assert msg and key in msg and "speculative and quantized " \
                "serving on a sharded model" in msg, msg


def test_fine_tune_entry_serves_at_world2(worlds):
    """The entry at fsdp 2 with ``INFERENCE`` and ``SERVE_AFTER_TRAIN``:
    both ranks finish, rank 0 alone writes the comparison and the smoke,
    and the base answers are the world-1 run's."""
    r0, r1 = [r["fine_tune"] for r in worlds["res"]["serve2"]]
    one = worlds["one"]["fine_tune"]
    for name in ("inference_comparison.json", "serve_smoke.json"):
        assert r0["wrote"].count(name) == 1, r0["wrote"]
        assert name not in r1["wrote"], r1["wrote"]
        assert one["wrote"].count(name) == 1
    assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
    assert r0["records"] and len(r0["records"]) == len(one["records"])
    assert [x["base_model_answer"] for x in r0["records"]] == \
        [x["base_model_answer"] for x in one["records"]]


def test_pretrain_entry_serves_at_world2_and_skips_beyond_a_node(worlds):
    """The pre-train entry's smoke on the sharded model: collective,
    stats on rank 0, None on rank 1; with ``LOCAL_WORLD_SIZE`` below the
    world (two nodes) it warns and skips on both."""
    r0, r1 = [r["pretrain"] for r in worlds["res"]["serve2"]]
    assert len(r0["smokes"]) == 1 and r0["smokes"][0] > 0
    assert r1["smokes"] == [None]
    assert not r0["skipped"] and not r1["skipped"]
    for r in worlds["res"]["serve2"]:
        assert r["pretrain_nodes"] == {"smokes": [], "skipped": True}
