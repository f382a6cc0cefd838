"""The port across ranks: 2-rank gloo worlds on the CPU (one process a
rank, ``tests/_torch_multirank.py``) held against the one-process port
and against the JAX package's meshed step.

Tiny dims (2 layers, d_model 128, vocab 256, fp32, dense attention), 3
steps at a global batch of 8 rows of 64 tokens. The one-process port
and JAX's step take it as 4 microbatches of 2 rows; JAX's meshed step
shards each over ``data 1 × fsdp 2`` of the conftest's fake CPU devices,
and QLoRA and full fine-tuning also over ``data 2 × fsdp 1``;
the 2-rank world gives each rank 4 contiguous rows as 2 microbatches, so
every microbatch holds the same rows on all three sides (an MoE router
aux is a mean over a microbatch's tokens). Loss, grad_norm and the
trained tensors agree within 1e-6 (streams, relative; tensors, absolute)
with the one-process port and within 1e-5 with JAX. Then: a
world-2 save restores bitwise at world 1 and a world-1 save at world 2;
a world-2 export, converted, equals the one-process HF export bitwise;
the sharded eval sums equal the all-rows walk; a preemption flag on one
rank exits both at one boundary with a durable save; a plan that differs
on one rank trips ``DIVERGENCE_GUARD`` on both; two ranks of the entry's
worker complete a smoke config.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager, save_hf_checkpoint
from gke_ray_train_tpu_torch.ckpt.convert import convert
from gke_ray_train_tpu_torch.models import config as tcfg
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, S, B, ACCUM, STEPS = 256, 64, 8, 4, 3
LR, TOTAL, GROUP = 1e-3, 10, 32
PORT_RTOL, PORT_ATOL = 1e-6, 1e-6       # 2 ranks against one process
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5         # 2 ranks against JAX's mesh
CASES = ("qlora", "full", "moe")       # also against JAX's mesh
DATA_CASES = ("qlora", "full")          # data 2 x fsdp 1 (HSDP)


def _cfgs(case):
    kw = dict(vocab_size=V, d_model=128, d_ff=256, n_layers=2,
              max_seq_len=S, attn_impl="xla")
    if case == "moe":
        kw.update(n_experts=4, expert_top_k=2, capacity_factor=4.0)
    return jcfg.tiny(**kw), tcfg.tiny(**kw)


def _batch(seed, n=B):
    r = np.random.default_rng(seed)
    w = np.ones((n, S), np.float32)
    for i, k in enumerate(r.integers(S // 2, S + 1, n)):
        w[i, k:] = 0.0
    return {"inputs": r.integers(0, V, (n, S)).astype(np.int32),
            "targets": r.integers(0, V, (n, S)).astype(np.int32),
            "weights": w}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(jc, case, batches, mesh=None):
    """JAX's state (nonzero adapters for QLoRA) and its streams and
    trained tree after the batches, meshed or not."""
    params = jtr.init_params(jc, jax.random.key(0))
    lcfg = jlora.LoraConfig(r=8, alpha=16) if case == "qlora" else None
    if case == "qlora":
        params = jquant.quantize_params(params, kind="nf4", group=GROUP)
    sched = joptim.warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    opt = joptim.make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = jstep.make_train_state(jc, opt, jax.random.key(1), mesh=mesh,
                                   lora_cfg=lcfg, params=params)
    if lcfg is not None:
        r = np.random.default_rng(3)
        lora = jax.tree.map(lambda x: jnp.asarray(r.standard_normal(
            x.shape).astype(np.float32) * 0.05), state.lora)
        state = state._replace(lora=lora, opt_state=jax.jit(opt.init)(lora))
    init = state
    step = jstep.make_train_step(jc, opt, mesh=mesh, lora_cfg=lcfg,
                                 grad_accum=ACCUM, schedule=sched,
                                 donate=False)
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        for k in streams:
            streams[k].append(float(m[k]))
    return init, state, streams, lcfg


def _port_case(tc, case, jinit, lcfg, batches):
    """The case's inputs for the ranks (a state dict of the JAX start),
    and the one-process port's run of it."""
    params = interop.params_from_numpy(_np(jinit.params), tc, device="cpu")
    lora = (interop.lora_from_numpy(_np(jinit.lora), tc, device="cpu")
            if lcfg is not None else None)
    inputs = {"cfg": tc.to_dict(), "quant": case == "qlora",
              "group": GROUP, "params": params.state_dict(), "lora": lora,
              "lora_r": 8, "lora_alpha": 16, "lr": LR, "total": TOTAL,
              "accum": ACCUM, "batches": batches}
    state, fn, _, lc = mr.build_state(inputs)
    export_state = None
    if case == "qlora":
        export_state = (mr.build_state(inputs)[0], lc)
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for b in batches:
        state, m = fn(state, b)
        for k in streams:
            streams[k].append(float(m[k]))
    # the ranks run 2 microbatches of their 4 rows
    inputs["accum"] = ACCUM // 2
    return inputs, state, streams, export_state


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("world2"))
    batches = [_batch(100 + i) for i in range(STEPS)]
    eval_rows = _batch(7, n=6)
    inputs = {"eval_rows": eval_rows,
              "long_batches": [_batch(200 + i) for i in range(8)]}
    port, jinits = {}, {}
    for case in CASES:
        jc, tc = _cfgs(case)
        jinit, _, jstreams, lcfg = _jax_run(jc, case, batches)
        inputs[case], state, streams, exp = _port_case(
            tc, case, jinit, lcfg, batches)
        port[case] = {"state": state, "streams": streams, "tc": tc,
                      "jax_streams": jstreams, "export": exp}
        jinits[case] = jinit
    # full fine-tuning with adafactor (the factored branch on sharded
    # tensors), against the one-process port only
    ada = dict(inputs["full"], optim="adafactor", accum=ACCUM)
    state, fn, _, _ = mr.build_state(ada)
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for b in batches:
        state, m = fn(state, b)
        for k in streams:
            streams[k].append(float(m[k]))
    inputs["adafactor"] = dict(ada, accum=ACCUM // 2)
    port["adafactor"] = {"state": state, "streams": streams}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    # the world-1 save the ranks restore
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    mgr.save(port["full"]["state"].step, port["full"]["state"], force=True)
    mgr.close()
    entry = {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
             "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": 384,
             "NUM_TRAIN_SAMPLES": 12, "NUM_EVAL_SAMPLES": 4,
             "PER_DEVICE_TRAIN_BATCH_SIZE": 1,
             "GRADIENT_ACCUMULATION_STEPS": 2, "NUM_TRAIN_EPOCHS": 1,
             "LEARNING_RATE": 1e-3, "LORA_DROPOUT": 0.0, "MESH_DATA": 1,
             "MESH_FSDP": -1, "SAVE_STRATEGY": "steps",
             "SAVE_STEPS_SFT": 2, "EVALUATION_STRATEGY_SFT": "steps",
             "EVAL_STEPS_SFT": 1, "LOGGING_STEPS": 1,
             "OUTPUT_DIR_BASE": os.path.join(out, "entry"),
             "INFERENCE": False}
    with open(os.path.join(out, "entry.json"), "w") as f:
        json.dump(entry, f)
    procs = {name: mr.start(name, out, extra_env={"PREEMPT_SYNC_EVERY": "2"})
             for name in ("train", "agree")}
    # JAX's meshed step while the ranks run
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, fsdp=2),
                            jax.devices()[:2])
    jax_mesh = {}
    for case in CASES:
        jc, _ = _cfgs(case)
        _, jstate, streams, lcfg = _jax_run(jc, case, batches, mesh=mesh)
        jax_mesh[case] = {"streams": streams, "state": jstate, "lcfg": lcfg}
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=2, fsdp=1),
                            jax.devices()[:2])
    for case in DATA_CASES:
        jc, _ = _cfgs(case)
        _, jstate, streams, lcfg = _jax_run(jc, case, batches, mesh=mesh)
        jax_mesh[f"{case}_data2"] = {"streams": streams, "state": jstate,
                                     "lcfg": lcfg}
    # the one-process export of the QLoRA start, and its eval walk
    st, lc = port["qlora"]["export"]
    save_hf_checkpoint(st.params, port["qlora"]["tc"],
                       os.path.join(out, "hf_w1"), lora=st.lora,
                       lora_scale=lc.scale)
    for name, p in procs.items():
        mr.wait(p, timeout=240)
    res = torch.load(os.path.join(out, "train_w2.pt"), weights_only=False)
    agree = [json.load(open(os.path.join(out, f"agree_{r}.json")))
             for r in range(2)]
    return dict(out=out, port=port, jax_mesh=jax_mesh, res=res,
                agree=agree, inputs=inputs)


def _jax_trained(case, jax_mesh, tc):
    jm = jax_mesh[case]
    if jm["lcfg"] is not None:
        lora = interop.lora_from_numpy(_np(jm["state"].lora), tc,
                                       device="cpu")
        return {f"blocks.{i}.{t}.{ab}": layer[t][ab]
                for i, layer in enumerate(lora) for t in layer
                for ab in ("a", "b")}
    params = interop.params_from_numpy(_np(jm["state"].params), tc,
                                       device="cpu")
    return {n: p.detach() for n, p in params.named_parameters()}


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_one_process_and_jax_mesh(world2, case):
    """data 1 × fsdp 2: every weight sharded; loss, grad_norm and tokens
    streams and the trained tensors after 3 steps against the one-process
    port (1e-6) and JAX's meshed step (1e-5)."""
    res, port = world2["res"][case], world2["port"][case]
    assert res["sharded"]
    one = port["state"]
    want = mr.trained_tensors(one)
    jax_want = _jax_trained(case, world2["jax_mesh"], port["tc"])
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(res["streams"][k], port["streams"][k],
                                   rtol=PORT_RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(
            res["streams"][k], world2["jax_mesh"][case]["streams"][k],
            rtol=JAX_RTOL, atol=1e-9, err_msg=k)
    assert set(res["trained"]) == set(want) == set(jax_want)
    for name, t in res["trained"].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=0, atol=PORT_ATOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), jax_want[name].numpy(),
                                   rtol=0, atol=JAX_ATOL, err_msg=name)
    # the one-process port against JAX's unmeshed step, as the slice's
    # other tests hold it
    np.testing.assert_allclose(port["streams"]["loss"],
                               port["jax_streams"]["loss"], rtol=JAX_RTOL)


@pytest.mark.parametrize("case", DATA_CASES)
def test_data_axis_two_ranks_match_one_process_and_jax_mesh(world2, case):
    """data 2 × fsdp 1 (HSDP: each unit replicated over ``data``, one
    fsdp shard): rank r is the batch axes' tile r and takes row block r,
    the gradients are summed over ``data``; the streams and trained
    tensors after 3 steps against the one-process port (1e-6) and JAX's
    step on a data 2 × fsdp 1 mesh (1e-5)."""
    res = world2["res"][f"{case}_data2"]
    port = world2["port"][case]
    # replicated over data, sharded over fsdp on each spec's fsdp dim
    assert {p[0] for p in res["placements"]} == {"R"}, res["placements"]
    assert {p[1] for p in res["placements"]} == {"S(0)", "S(1)"}, \
        res["placements"]
    assert res["layout"] in ((2, 0), (2, 1))
    want = mr.trained_tensors(port["state"])
    jax_want = _jax_trained(f"{case}_data2", world2["jax_mesh"], port["tc"])
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(res["streams"][k], port["streams"][k],
                                   rtol=PORT_RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(
            res["streams"][k],
            world2["jax_mesh"][f"{case}_data2"]["streams"][k],
            rtol=JAX_RTOL, atol=1e-9, err_msg=k)
    assert set(res["trained"]) == set(want) == set(jax_want)
    for name, t in res["trained"].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=0, atol=PORT_ATOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), jax_want[name].numpy(),
                                   rtol=0, atol=JAX_ATOL, err_msg=name)


def test_two_ranks_adafactor_reads_whole_tensors(world2):
    """Full fine-tuning with OPTIM=adafactor on 2 ranks: the factored
    row / column means and the RMS terms are over each whole tensor, so
    the streams and trained tensors equal the one-process run's."""
    res, port = world2["res"]["adafactor"], world2["port"]["adafactor"]
    assert res["sharded"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(res["streams"][k], port["streams"][k],
                                   rtol=PORT_RTOL, atol=1e-9, err_msg=k)
    want = mr.trained_tensors(port["state"])
    for name, t in res["trained"].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=0, atol=PORT_ATOL, err_msg=name)


def test_quantized_init_on_a_mesh_is_the_plain_init(world2):
    """``init_quantized_params(mesh=)``: every code, scale and weight a
    DTensor whose whole equals the unmeshed init's (the same draws), each
    rank holding half of a block's codes."""
    q = world2["res"]["qinit"]
    assert q["same_keys"] and q["sharded"] and q["equal"]
    assert q["local_codes_rows"] == 64


def test_world2_save_restores_bitwise_at_world1(world2):
    """The ranks' save of the trained full-FT state, read into an
    unsharded one-process template, equals the ranks' state bitwise."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    template, _, _, _ = mr.build_state(world2["inputs"]["full"])
    mgr = CheckpointManager(os.path.join(world2["out"], "ckpt_w2"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    assert mgr.last_restore_resharded == (2, 1)
    mgr.close()
    saved = world2["res"]["full_saved"]
    got = flat_state(template)
    assert set(got) == set(saved)
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_world1_save_restores_bitwise_at_world2(world2):
    """The one-process save, restored into the ranks' sharded template,
    equals the one-process state bitwise."""
    want = mr.full_state(world2["port"]["full"]["state"])
    got = world2["res"]["full_restored"]
    assert world2["res"]["resharded"] == [1, 2] or \
        world2["res"]["resharded"] == (1, 2)
    assert set(got) == set(want)
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_world2_export_converts_to_the_one_process_export(world2, tmp_path):
    """The ranks' sharded export of the merged QLoRA start, converted,
    equals the one-process HF export file for file, bitwise."""
    out = world2["out"]
    assert os.path.exists(os.path.join(out, "export_w2",
                                       "model_config.json"))
    hf_w2 = str(tmp_path / "hf_w2")
    convert(os.path.join(out, "export_w2"), hf_w2, dtype="bfloat16")
    hf_w1 = os.path.join(out, "hf_w1")
    names = sorted(os.listdir(hf_w1))
    assert names == sorted(os.listdir(hf_w2)) and any(
        n.endswith(".safetensors") for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(hf_w1, n), os.path.join(hf_w2, n),
                           shallow=False), n


def test_sharded_eval_sums_equal_the_all_rows_walk(world2):
    """Each rank walks its half of the eval rows; the all-reduced sums
    equal the one-process walk over every row of the same weights."""
    from gke_ray_train_tpu_torch.train import (
        make_eval_step, sharded_eval_sums)
    from gke_ray_train_tpu_torch.train.lora import LoraConfig
    got = world2["res"]["qlora"]["eval_sums"]
    port = world2["port"]["qlora"]
    # the ranks' trained adapters on the one-process base
    state = port["state"]
    with torch.no_grad():
        for i, layer in enumerate(state.lora):
            for t in layer:
                for ab in ("a", "b"):
                    layer[t][ab].copy_(
                        world2["res"]["qlora"]["trained"]
                        [f"blocks.{i}.{t}.{ab}"])
    ev = make_eval_step(port["tc"], lora_cfg=LoraConfig(r=8, alpha=16),
                        device="cpu")
    want = sharded_eval_sums(state, ev, world2["inputs"]["eval_rows"],
                             host_batch=4)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == float(world2["inputs"]["eval_rows"]["weights"].sum())


def test_preemption_on_one_rank_exits_both_at_one_boundary(world2):
    """Rank 1 alone raises the flag after its 3rd step; with
    PREEMPT_SYNC_EVERY=2 both ranks exit at the same step, which is
    saved."""
    a0, a1 = world2["agree"]
    assert a0["preempted_at"] is not None
    assert a0["preempted_at"] == a1["preempted_at"]
    assert a0["steps_run"] == a1["steps_run"] == a0["preempted_at"]
    assert a0["preempted_at"] in a0["saved"] and a0["saved"] == a1["saved"]
    assert a0["preempted_at"] % 2 == 0 and a0["preempted_at"] < 8


def test_a_plan_differing_on_one_rank_trips_the_divergence_guard(world2):
    for r, a in enumerate(world2["agree"]):
        assert a["divergence"] and "DIFFERENT train_step" in \
            a["divergence"], (r, a["divergence"])
        assert "grad_accum" in a["divergence"]


def test_two_ranks_of_the_entry_complete_a_smoke_config(world2):
    """``fine_tune.train_loop_per_worker(config, device="cpu")`` on two
    gloo ranks, with a sharded eval after every step and a save every 2
    (a step after an eval finds its state sharded): both finish with the
    same finite loss, and rank 0 leaves the sharded export with its
    sidecar and tokenizer."""
    e0, e1 = (a["entry"] for a in world2["agree"])
    assert e0["step"] == e1["step"] == 3
    assert np.isfinite(e0["loss"]) and e0["loss"] == e1["loss"]
    export = os.path.join(world2["out"], "entry", "full_dcp")
    assert os.path.exists(os.path.join(export, "model_config.json"))
    assert os.path.isdir(os.path.join(export, "tokenizer"))
    hf = os.path.join(world2["out"], "entry_hf")
    convert(export, hf, dtype="float32")
    assert os.path.exists(os.path.join(hf, "config.json"))
