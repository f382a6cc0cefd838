"""Decode across pipe stages: the port's KV-cache decode, ``BatchEngine``
and both entries' serving branches on a pipelined model, in gloo worlds
on the CPU (``tests/_torch_serve_mesh.py``: ``servepp2`` at pipe 2,
``servepp4`` at pipe 2 × model 2), held against the one-process port
and against the JAX package's ``greedy_generate_cached`` on its
pipelined mesh of the same shape (``tree_shardings`` of ``param_specs``)
on the fake devices.

Tiny fp32 models of 4 layers (d_model 64, 4 heads over 2 KV heads,
d_ff 128, vocab 256): a Llama (flash prefill), a Gemma-2 (softcaps, a
sliding window, a tied embedding looked up on the first stage and read
as the head on the last) and a Mixtral-style MoE (4 experts, top 2,
capacity factor 4.0; at pipe 2 × model 2 2 experts a rank). Two prompts
of 40 and 97 tokens in a 256-wide buffer, 16 new tokens. A stage holds
its layers and caches only those; a step visits the stages in layer
order; only the last stage has logits, and its tokens are broadcast to
the world. The last stage's prefill and first-step logits agree within
1e-5 with one process and with JAX's mesh (the Llama at pipe 2, the
Llama and the MoE at pipe 2 × model 2); the greedy tokens are
equal to both on every rank; each stage's cache is within 1e-5 of one
process's cache of its layers. Then at pipe 2: the adapter-pool engine and its
smoke against one process, ``SPEC_DRAFT`` / ``SERVE_QUANT`` refused,
and both entries at ``MESH_PIPE`` 2 with ``INFERENCE`` and
``SERVE_AFTER_TRAIN``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gke_ray_train_tpu_torch import interop
from tests import _torch_multirank as mr
from tests import _torch_serve_mesh as sm
from tests.test_torch_port_serve_mesh import (
    FT_INFER, MAX_NEW, PLEN, _cfgs as _cfgs2,
    _engine_job, _jax_mesh_run, _jax_params, _prompt)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


TOL = 1e-5
# the 4-layer models of this file
LAYERS = 4
# shape: (mesh axes, world, virtual, the cases decoded on it)
MESHES = {"pipe2": (dict(pipe=2), 2, 1, ("llama", "gemma", "moe")),
          "pipe2_v2": (dict(pipe=2), 2, 2, ("llama",)),
          "pipe2_model2": (dict(model=2, pipe=2), 4, 1, ("llama", "moe"))}
# the JAX mesh runs: (mesh axes, family)
JAX_RUNS = (("pipe2", "llama"), ("pipe2_model2", "llama"),
            ("pipe2_model2", "moe"))


def _cfgs(family):
    jc, tc = _cfgs2(family)
    import dataclasses
    return (dataclasses.replace(jc, n_layers=LAYERS),
            dataclasses.replace(tc, n_layers=LAYERS, attn_impl=(
                "flash" if tc.attn_impl == "a2a" else tc.attn_impl)))


def _ft_config(out):
    """The smoke fine-tune (a tiny QLoRA Llama the entry builds) at
    ``MESH_PIPE`` 2 on a world of 2."""
    return {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
            "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": 384,
            "NUM_TRAIN_SAMPLES": 4, "NUM_EVAL_SAMPLES": 4,
            "PER_DEVICE_TRAIN_BATCH_SIZE": 2,
            "GRADIENT_ACCUMULATION_STEPS": 1, "NUM_TRAIN_EPOCHS": 1,
            "LEARNING_RATE": 1e-3, "LORA_DROPOUT": 0.0, "USE_QLORA": True,
            "LORA_R": 4, "LORA_ALPHA": 8, "MESH_DATA": 1, "MESH_FSDP": 1,
            "MESH_PIPE": 2,
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
            "MESH_FSDP": 1, "MESH_DATA": 1, "MESH_PIPE": 2,
            "SERVE_AFTER_TRAIN": True}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, monkeypatch_module):
    out = str(tmp_path_factory.mktemp("serve_pipe"))
    monkeypatch_module.setenv("HF_HUB_OFFLINE", "1")
    mr.clear_rendezvous(monkeypatch_module)
    cases, jax_side = {}, {}
    for family in ("llama", "gemma", "moe"):
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
              "meshes": {s: m[3] for s, m in MESHES.items()},
              "engine": _engine_job(tc),
              "fine_tune": _ft_config(os.path.join(out, "ft2")),
              "pretrain": _pretrain_config(out)}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    procs = {"servepp2": sm.start("servepp2", out, n=2),
             "servepp4": sm.start("servepp4", out, n=4)}
    # while the ranks run: one process of the port, JAX's meshes
    one = {}
    for family, case in cases.items():
        params, cfg = sm.model_of(case)
        one[family] = sm.run_decode(params, cfg, case, keep_cache=True)
    params, cfg = sm.model_of(cases["llama"])
    one["engine"] = sm.run_engine(params, cfg, inputs["engine"])
    jax_mesh = {(shape, family): _jax_mesh_run(
        jax_side[family][0], jax_side[family][1], cases[family],
        MESHES[shape][0]) for shape, family in JAX_RUNS}
    mr.wait(procs["servepp2"], timeout=300)
    mr.wait(procs["servepp4"], timeout=300)
    res = {name: [torch.load(os.path.join(out, f"{name}_{r}.pt"),
                             weights_only=False) for r in range(n)]
           for name, n in (("servepp2", 2), ("servepp4", 4))}
    return dict(out=out, one=one, jax_mesh=jax_mesh, res=res)


def _ranks(worlds, shape):
    world = "servepp2" if MESHES[shape][1] == 2 else "servepp4"
    return [r[shape] for r in worlds["res"][world]]


def _last_stage_logits(ranks, family, key):
    """The logits over the whole vocab of each last-stage rank: its own,
    or under TP its model group's shards in model-rank order."""
    last = [r for r in ranks if r["pipe_rank"] == 1]
    shards = sorted(last, key=lambda r: r["model_rank"])
    return torch.cat([r[family][key] for r in shards], dim=-1)


CASES = [(shape, family) for shape, m in MESHES.items() for family in m[3]]


@pytest.mark.parametrize("shape,family", CASES,
                         ids=[f"{s}-{f}" for s, f in CASES])
def test_pipelined_decode_matches_one_process_and_jax_mesh(worlds, shape,
                                                           family):
    """The last stage's prefill and first-step logits within 1e-5 of one
    process's and, where it runs, JAX's pipelined mesh generate's (JAX's
    decode ignores the virtual stages: its pipe-2 mesh is the reference
    of both); the
    first stage has none; the greedy tokens equal to both on every
    rank."""
    ranks = _ranks(worlds, shape)
    one = worlds["one"][family]
    jshape = "pipe2" if shape == "pipe2_v2" else shape
    jx = worlds["jax_mesh"].get((jshape, family))
    for key in ("prefill", "decode"):
        got = _last_stage_logits(ranks, family, key).numpy()
        np.testing.assert_allclose(got, one[key].numpy(), rtol=0, atol=TOL,
                                   err_msg=key)
        if jx is not None:
            np.testing.assert_allclose(got, jx[key], rtol=0, atol=TOL,
                                       err_msg=key)
    for r in ranks:
        if r["pipe_rank"] == 0:
            assert r[family]["prefill"].shape[-1] == 0
        np.testing.assert_array_equal(r[family]["tokens"].numpy(),
                                      one["tokens"].numpy())
        if jx is not None:
            np.testing.assert_array_equal(r[family]["first"].numpy(),
                                          jx["first"])
            np.testing.assert_array_equal(r[family]["tokens"].numpy(),
                                          jx["tokens"])
    # the generate wrote new tokens (not a vacuous buffer)
    assert (one["tokens"].numpy()[0, PLEN[0]:PLEN[0] + MAX_NEW] != 0).any()


@pytest.mark.parametrize("shape,family", CASES,
                         ids=[f"{s}-{f}" for s, f in CASES])
def test_each_stage_caches_its_layers_as_one_process(worlds, shape, family):
    """After the prefill and one decode step a stage's cache holds its own
    layers (at virtual 2 its groups {p, p + 2}), within 1e-5 of one
    process's cache of those layers, under ``model`` 2 its half of the
    KV heads."""
    v = MESHES[shape][2]
    model = MESHES[shape][0].get("model", 1)
    one = worlds["one"][family]["cache"]
    n = len(one)
    for r in _ranks(worlds, shape):
        p, m = r["pipe_rank"], r["model_rank"]
        per = n // (2 * v)
        want = sorted(i for j in range(v)
                      for i in range((j * 2 + p) * per,
                                     (j * 2 + p + 1) * per))
        assert sorted(r[family]["cache"]) == want
        for i, (k, vv) in r[family]["cache"].items():
            for got, full in ((k, one[i][0]), (vv, one[i][1])):
                part = full.chunk(model, dim=2)[m]
                np.testing.assert_allclose(got.numpy(), part.numpy(),
                                           rtol=0, atol=TOL, err_msg=str(i))


def test_engine_with_adapter_pool_at_pipe2_matches_one_process(worlds):
    """Tagged requests through a stage's pool (one tenant slot, two
    tenants, so it evicts and waits on pins; the whole-model tenants
    written as the stage's layers) at pipe 2: every rank's completions
    and counters equal one process's; the collective smoke returns on
    rank 0 alone, its tokens one process's."""
    one = worlds["one"]["engine"]
    ranks = worlds["res"]["servepp2"]
    assert [r["layers"] for r in ranks] == [[0, 1], [2, 3]]
    assert one["stats"]["adapter_evictions"] > 0
    for r in (r["engine"] for r in ranks):
        assert len(r["tokens"]) == len(one["tokens"])
        for got, want in zip(r["tokens"], one["tokens"]):
            np.testing.assert_array_equal(got, want)
        assert r["lengths"] == one["lengths"]
        assert r["stats"] == one["stats"]
    assert ranks[1]["engine"]["smoke"] is None
    toks, stats = ranks[0]["engine"]["smoke"]
    wtoks, wstats = one["smoke"]
    assert stats == wstats and stats["adapter_requests"] == 1
    for got, want in zip(toks, wtoks):
        np.testing.assert_array_equal(got, want)


def test_spec_draft_and_serve_quant_refused_at_pipe2(worlds):
    """A pipelined model is sharded: ``SPEC_DRAFT`` and ``SERVE_QUANT``
    raise, naming ROADMAP item 5."""
    for r in worlds["res"]["servepp2"]:
        for key in ("SPEC_DRAFT", "SERVE_QUANT"):
            msg = r["refusals"][key]
            assert msg and key in msg and "item 5" in msg, msg


def test_fine_tune_entry_serves_at_pipe2(worlds):
    """The fine-tune entry at ``MESH_PIPE`` 2 with ``INFERENCE`` and
    ``SERVE_AFTER_TRAIN``: both stages finish with the same loss, rank 0
    alone writes the comparison (of the two samples asked for, each with
    both answers) and the smoke."""
    r0, r1 = [r["fine_tune"] for r in worlds["res"]["servepp2"]]
    for name in ("inference_comparison.json", "serve_smoke.json"):
        assert r0["wrote"].count(name) == 1, r0["wrote"]
        assert name not in r1["wrote"], r1["wrote"]
    assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
    assert len(r0["records"]) == FT_INFER["NUM_EVAL_SAMPLES_INFERENCE"]
    for rec in r0["records"]:
        assert isinstance(rec["base_model_answer"], str)
        assert isinstance(rec["finetuned_model_answer"], str)


def test_pretrain_entry_serves_at_pipe2(worlds):
    """The pre-train entry at ``MESH_PIPE`` 2 with ``SERVE_AFTER_TRAIN``:
    the smoke is collective across the stages, its stats on rank 0 and
    None on rank 1, and neither rank skips."""
    r0, r1 = [r["pretrain"] for r in worlds["res"]["servepp2"]]
    assert len(r0["smokes"]) == 1 and r0["smokes"][0] > 0
    assert r1["smokes"] == [None]
    assert not r0["skipped"] and not r1["skipped"]
