"""Tensor parallelism on ``model`` and HSDP: gloo worlds of the port on the
CPU (``tests/_torch_tp.py``) held against the one-process port and
against the JAX package's meshed step on the conftest's fake devices.

Tiny dims (2 layers, d_model 64, 4 heads over 2 KV heads, d_ff 128,
vocab 256, fp32, dense attention, NF4 groups of 32), 3 steps at a global
batch of 8 rows of 64 tokens as 2 microbatches (a rank of two batch ranks
takes its 4 rows as one). Cases: Llama-tiny NF4 QLoRA with ``FUSED_OPS``
0 and 1, Llama-tiny full fine-tuning with the fused cross-entropy (its dhead), and
a tied, softcapped Gemma-tiny, full fine-tuning through the unfused
vocab-parallel loss. Worlds: model 2 × fsdp 1 (2 ranks), data 2 × fsdp 2
(HSDP) and fsdp 2 × model 2 (4 ranks). Loss, grad_norm and tokens
(relative) and the trained tensors (absolute) agree within 1e-6 with the
one-process port and within 1e-5 with JAX's mesh of the same shape.
Then: the sharded-vocab fused cross-entropy against JAX's ``mesh=`` call
and, in one process, the shift-and-merge over 4 shards against the
unsharded plain version; checkpoints across fsdp 2 × model 2 and world 1
both ways, bitwise; the sharded export converted, bitwise the one-process
export; the plan check; the LoRA dropout masks across batch and model
ranks, and a world-1 step bitwise what it was before them.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import fused_ce as jfce
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager, save_hf_checkpoint
from gke_ray_train_tpu_torch.ckpt.convert import convert
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.ops import fused_ce as tfce
from gke_ray_train_tpu_torch.parallel import sharding as tshard
from gke_ray_train_tpu_torch.parallel import tensor as ttensor
from gke_ray_train_tpu_torch.plan import PlanError, model_findings
from tests import _torch_multirank as mr
from tests import _torch_tp as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, S, B, ACCUM, STEPS = 256, 64, 8, 2, 3
LR, TOTAL, GROUP = 1e-3, 10, 32
PORT_RTOL, PORT_ATOL = 1e-6, 1e-6       # ranks against one process
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5         # ranks against JAX's mesh
CE_RTOL = 1e-5                          # of the largest reference element
GEMMA = dict(logit_softcap=30.0, attn_softcap=50.0, tie_embeddings=True,
             post_block_norm=True, norm_scale_plus_one=True,
             embed_scale=True, activation="gelu_tanh")
# name: (family, NF4 QLoRA, FUSED_OPS)
CASES = {"qlora_f0": ("llama", True, False),
         "qlora_f1": ("llama", True, True),
         "full_f1": ("llama", False, True),
         "gemma": ("gemma", False, True)}
# (shape, case) of the 4-rank world; JAX's mesh runs the QLoRA ones;
# "full_ada" is full_f1 with OPTIM=adafactor (its factored statistics
# over 2-D shards), against the one-process port
TP4_CASES = {"hsdp": ("qlora_f1",),
             "fsdp_model": ("qlora_f1", "full_f1", "full_ada")}
MESHES = {"model2": dict(data=1, fsdp=1, model=2),
          "hsdp": dict(data=2, fsdp=2, model=1),
          "fsdp_model": dict(data=1, fsdp=2, model=2)}
JAX_RUNS = [("model2", c) for c in CASES] + [("hsdp", "qlora_f1"),
                                             ("fsdp_model", "qlora_f1")]
# a world-1 QLoRA step at LORA_DROPOUT 0.1, recorded on the tree before
# the dropout repair (two steps: loss and grad_norm as float.hex, then
# the sha256 of the trained adapters' bytes)
WORLD1_DROPOUT = (("0x1.6310fc0000000p+2", "0x1.e3407e0000000p-3"),
                  ("0x1.63e9c40000000p+2", "0x1.a5e51e0000000p-3"),
                  "0c62417c3615fefd02236c9881140405d56af682e4862db77ca1af36"
                  "126cfc8e")


def _cfgs(family):
    kw = dict(vocab_size=V, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
              n_layers=2, max_seq_len=S, attn_impl="xla")
    if family == "gemma":
        kw.update(GEMMA)
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


def _jax_run(case, batches, mesh=None):
    """JAX's start (nonzero adapters for QLoRA), and its streams and
    final state after the batches, meshed or not."""
    family, quant, fused = CASES[case]
    jc, _ = _cfgs(family)
    params = jtr.init_params(jc, jax.random.key(0))
    lcfg = jlora.LoraConfig(r=8, alpha=16) if quant else None
    if quant:
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
    step = jstep.make_train_step(
        jc, opt, mesh=mesh, lora_cfg=lcfg, grad_accum=ACCUM, schedule=sched,
        donate=False, plan=jplan.ExecutionPlan(fused_ops=fused))
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        for k in streams:
            streams[k].append(float(m[k]))
    return init, state, streams


def _port_inputs(case, jinit, batches):
    family, quant, fused = CASES[case]
    _, tc = _cfgs(family)
    params = interop.params_from_numpy(_np(jinit.params), tc, device="cpu")
    lora = (interop.lora_from_numpy(_np(jinit.lora), tc, device="cpu")
            if quant else None)
    return {"cfg": tc.to_dict(), "quant": quant, "group": GROUP,
            "params": params.state_dict(), "lora": lora, "lora_r": 8,
            "lora_alpha": 16, "lr": LR, "total": TOTAL, "accum": ACCUM,
            "fused": fused, "batches": batches}


def _ce_inputs(seed=21, Bn=2, Sn=32, D=64):
    """x, head and weights of the sharded-vocab CE, with labels on both
    vocab halves and one out of range (V + 5)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((Bn, Sn, D)).astype(np.float32)
    head = (r.standard_normal((D, V)) * 0.3).astype(np.float32)
    targets = r.integers(0, V, (Bn, Sn)).astype(np.int32)
    targets[0, :4] = (3, V // 2 - 1, V // 2, V - 1)
    targets[1, 5] = V + 5
    weights = r.uniform(0.5, 1.5, (Bn, Sn)).astype(np.float32)
    weights[1, :3] = 0.0
    return x, head, targets, weights


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    batches = [_batch(100 + i) for i in range(STEPS)]
    inputs = {"tp2_cases": tuple(CASES), "tp4_cases": TP4_CASES,
              "eval_rows": _batch(7, n=6)}
    port, jinits = {}, {}
    for case in CASES:
        jinit, _, _ = _jax_run(case, [])
        jinits[case] = jinit
        inputs[case] = _port_inputs(case, jinit, batches)
        r = tp.train(inputs[case], None)
        port[case] = r
    inputs["full_ada"] = dict(inputs["full_f1"], optim="adafactor")
    port["full_ada"] = tp.train(inputs["full_ada"], None)
    x, head, targets, weights = _ce_inputs()
    inputs["ce"] = {k: torch.from_numpy(v) for k, v in (
        ("x", x), ("head", head), ("targets", targets),
        ("weights", weights))}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    # the world-1 save the 4-rank world restores
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    st = port["full_f1"]["state"]
    mgr.save(st.step, st, force=True)
    mgr.close()
    procs = {"tp2": tp.start("tp2", out, n=2),
             "tp4": tp.start("tp4", out, n=4)}
    # JAX's meshed steps and CE while the ranks run
    jax_mesh = {}
    for shape, case in JAX_RUNS:
        mesh = jmesh.build_mesh(jmesh.MeshConfig(**MESHES[shape]),
                                jax.devices()[:int(np.prod(list(
                                    MESHES[shape].values())))])
        _, jstate, streams = _jax_run(case, batches, mesh=mesh)
        jax_mesh[(shape, case)] = {"state": jstate, "streams": streams}
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**MESHES["model2"]),
                            jax.devices()[:2])

    def loss(xj, hj):
        return jfce.fused_cross_entropy(xj, hj, jnp.asarray(targets),
                                        jnp.asarray(weights), mesh=mesh)
    (jnll, jw), (jdx, jdh) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                            jnp.asarray(head))
    jax_ce = {"nll": float(jnll), "w": float(jw), "dx": np.asarray(jdx),
              "dhead": np.asarray(jdh)}
    # the one-process export of the QLoRA start
    st, _, tc, lcfg = tp.build_state(inputs["qlora_f1"])
    save_hf_checkpoint(st.params, tc, os.path.join(out, "hf_w1"),
                       lora=st.lora, lora_scale=lcfg.scale)
    mr.wait(procs["tp2"], timeout=300)
    mr.wait(procs["tp4"], timeout=300)
    res = {name: [torch.load(os.path.join(out, f"{name}_{r}.pt"),
                             weights_only=False) for r in range(n)]
           for name, n in (("tp2", 2), ("tp4", 4))}
    return dict(out=out, port=port, jax_mesh=jax_mesh, jax_ce=jax_ce,
                res=res, inputs=inputs)


def _jax_trained(case, jstate):
    family, quant, _ = CASES[case]
    _, tc = _cfgs(family)
    if quant:
        lora = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        return {f"blocks.{i}.{t}.{ab}": layer[t][ab]
                for i, layer in enumerate(lora) for t in layer
                for ab in ("a", "b")}
    params = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
    return {n: p.detach() for n, p in params.named_parameters()}


def _hold(got, port, jax_side=None, case=None):
    """Streams and trained tensors against the one-process port, and
    against JAX's mesh where given."""
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(got["streams"][k], port["streams"][k],
                                   rtol=PORT_RTOL, atol=1e-9, err_msg=k)
        if jax_side is not None:
            np.testing.assert_allclose(got["streams"][k],
                                       jax_side["streams"][k],
                                       rtol=JAX_RTOL, atol=1e-9, err_msg=k)
    assert set(got["trained"]) == set(port["trained"])
    jw = _jax_trained(case, jax_side["state"]) if jax_side else None
    for name, t in got["trained"].items():
        np.testing.assert_allclose(t.numpy(), port["trained"][name].numpy(),
                                   rtol=0, atol=PORT_ATOL, err_msg=name)
        if jw is not None:
            np.testing.assert_allclose(t.numpy(), jw[name].numpy(), rtol=0,
                                       atol=JAX_ATOL, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_model2_matches_one_process_and_jax_mesh(worlds, case):
    """model 2 × fsdp 1: the sharded weights 2-D (fsdp, model) DTensors
    (the norms fsdp only), both ranks' streams and trained tensors after
    3 steps against the one-process port and JAX's mesh of that shape."""
    for rank, res in enumerate(worlds["res"]["tp2"]):
        got = res[case]
        pl = got["placements"]
        assert pl["blocks.0.attn_norm"] == ("S(0)",), pl
        if CASES[case][1]:
            assert pl["blocks.0.wq.codes"] == ("S(0)", "S(1)"), pl
            assert pl["blocks.0.wo.codes"] == ("S(1)", "S(0)"), pl
            assert pl["blocks.0.wo.scales"] == ("S(1)", "S(0)"), pl
        else:
            assert pl["blocks.0.w_up"] == ("S(0)", "S(1)"), pl
            assert pl["blocks.0.w_down"] == ("S(1)", "S(0)"), pl
        assert pl["embed"] == ("S(1)", "S(0)"), pl
        _hold(got, worlds["port"][case],
              worlds["jax_mesh"][("model2", case)], case)


@pytest.mark.parametrize("shape, case", [
    (s, c) for s, cs in TP4_CASES.items() for c in cs])
def test_four_ranks_match_one_process_and_jax_mesh(worlds, shape, case):
    """data 2 × fsdp 2 (HSDP: replicated over data) and fsdp 2 × model 2:
    every rank's streams and trained tensors after 3 steps against the
    one-process port and, for QLoRA, JAX's mesh of the same shape; with
    OPTIM=adafactor the factored row / column means and the RMS terms
    read each whole 2-D-sharded tensor, as one process reads it."""
    jax_side = worlds["jax_mesh"].get((shape, case))
    for res in worlds["res"]["tp4"]:
        got = res[shape][case]
        pls = set(got["placements"].values())
        if shape == "hsdp":
            assert pls == {("R", "S(0)"), ("R", "S(1)")}, pls
        else:
            assert ("S(0)", "S(1)") in pls and ("S(1)", "S(0)") in pls
        _hold(got, worlds["port"][case], jax_side, case)


def test_batch_rank_leaves_model_out(worlds):
    """The model ranks of one batch rank get the same input rows: at
    fsdp 2 × model 2 ranks 0 and 1 are batch rank 0, ranks 2 and 3 batch
    rank 1, each pair model ranks 0 and 1; at model 2 × fsdp 1 both ranks
    are the one input shard."""
    lay = [r["fsdp_model"]["layout"] for r in worlds["res"]["tp4"]]
    assert [x["batch_rank"] for x in lay] == [0, 0, 1, 1]
    assert [x["model_rank"] for x in lay] == [0, 1, 0, 1]
    assert [tuple(x["input_shard_layout"]) for x in lay] == \
        [(2, 0), (2, 0), (2, 1), (2, 1)]
    lay2 = [r["layout"] for r in worlds["res"]["tp2"]]
    assert [tuple(x["input_shard_layout"]) for x in lay2] == [(1, 0)] * 2
    assert [x["model_rank"] for x in lay2] == [0, 1]


def test_sharded_vocab_fused_ce_matches_jax_mesh(worlds):
    """``fused_cross_entropy(mesh=)`` at model 2, each rank holding its
    head half, labels on both halves and one out of range: the merged
    value, dx (all-reduced over model) and each rank's dhead shard
    against JAX's ``fused_cross_entropy(mesh=)`` on a model-2 mesh."""
    j = worlds["jax_ce"]
    ranks = [r["ce"] for r in worlds["res"]["tp2"]]
    for r in ranks:
        np.testing.assert_allclose(float(r["nll"]), j["nll"], rtol=CE_RTOL)
        assert float(r["w"]) == pytest.approx(j["w"], rel=1e-7)
        err = np.abs(r["dx"].numpy() - j["dx"]).max()
        assert err <= CE_RTOL * np.abs(j["dx"]).max(), err
    dhead = np.concatenate([r["dhead"].numpy() for r in ranks], axis=1)
    err = np.abs(dhead - j["dhead"]).max()
    assert err <= CE_RTOL * np.abs(j["dhead"]).max(), err


def test_shift_and_merge_over_four_shards_in_one_process():
    """The port's shift and merge over 4 vocab shards in one process (as
    the card's kernel check runs them): every shard's row statistics of
    its shifted labels (negative and past the shard's end among them, and
    global labels out of range), merged, equal the unsharded plain
    version; dx summed over the shards and the dhead shards side by side
    equal its gradients."""
    r = np.random.default_rng(4)
    N, D, Vf, n = 96, 32, 1000, 4
    x = torch.from_numpy(r.standard_normal((N, D)).astype(np.float32))
    head = torch.from_numpy(
        (r.standard_normal((D, Vf)) * 0.3).astype(np.float32))
    t = torch.from_numpy(r.integers(0, Vf, N).astype(np.int32))
    t[:3] = torch.tensor([Vf + 7, -2, Vf - 1], dtype=torch.int32)
    wg = torch.from_numpy(r.uniform(0.5, 1.5, N).astype(np.float32))
    lse0, tgt0 = tfce.fused_ce_row_stats_reference(x, head, t)
    dx0, dh0 = tfce.fused_ce_grads_reference(x, head, t, wg, lse0)
    shards = head.chunk(n, dim=1)
    v_local = shards[0].shape[1]
    shifted = [ttensor.shift_labels(t, k, v_local) for k in range(n)]
    assert bool((shifted[2] < 0).any()) and bool((shifted[1] >= v_local)
                                                 .any())
    stats = [tfce.fused_ce_row_stats(x, h.contiguous(), s)
             for h, s in zip(shards, shifted)]
    lse, tgt = ttensor.merge_shard_stats(
        torch.stack([s[0] for s in stats]), torch.stack([s[1] for s in stats]))
    np.testing.assert_allclose(lse.numpy(), lse0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), tgt0.numpy(), rtol=0, atol=0)
    assert float(tgt[0]) == 0.0 and float(tgt[1]) == 0.0
    dx = sum(tfce.fused_ce_dx(x, h.contiguous(), s, wg, lse)
             for h, s in zip(shards, shifted))
    dh = torch.cat([tfce.fused_ce_dhead(x, h.contiguous(), s, wg, lse)
                    for h, s in zip(shards, shifted)], dim=1)
    assert float((dx - dx0).abs().max()) <= CE_RTOL * float(dx0.abs().max())
    assert float((dh - dh0).abs().max()) <= CE_RTOL * float(dh0.abs().max())


@pytest.mark.parametrize("case", ["full_f1", "qlora_f1"])
def test_save_at_fsdp2_model2_restores_bitwise_at_world1(worlds, case):
    """The 4 ranks' save of a trained state (2-D DTensors; under QLoRA
    the frozen NF4 codes, held as a one-byte float, and their scales),
    read into an unsharded one-process template, equals the ranks'
    state bitwise (codes compared as int8)."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    template = tp.build_state(worlds["inputs"][case])[0]
    mgr = CheckpointManager(os.path.join(worlds["out"], f"ckpt_{case}_w4"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    assert mgr.last_restore_resharded == (4, 1)
    mgr.close()
    saved = worlds["res"]["tp4"][0][f"{case}_saved"]
    got = flat_state(template)
    assert set(got) == set(saved)
    assert any(k.endswith(".codes") for k in got) == (case == "qlora_f1")
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert v.dtype == got[k].dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_world1_save_restores_bitwise_at_fsdp2_model2(worlds):
    """The one-process save, restored into the 4 ranks' fsdp 2 × model 2
    template, equals the one-process state bitwise on every rank."""
    want = mr.full_state(worlds["port"]["full_f1"]["state"])
    for res in worlds["res"]["tp4"]:
        assert res["resharded"] == (1, 4)
        got = res["full_restored"]
        assert set(got) == set(want)
        for k, v in want.items():
            if torch.is_tensor(v):
                assert torch.equal(got[k], v), k
            else:
                assert got[k] == v, k


def test_sharded_export_converts_to_the_one_process_export(worlds,
                                                            tmp_path):
    """The 4 ranks' export of the merged QLoRA start (each unit gathered
    over fsdp and model), converted, equals the one-process HF export
    file for file, bitwise."""
    out = worlds["out"]
    hf_w4 = str(tmp_path / "hf_w4")
    convert(os.path.join(out, "export_w4"), hf_w4, dtype="bfloat16")
    hf_w1 = os.path.join(out, "hf_w1")
    names = sorted(os.listdir(hf_w1))
    assert names == sorted(os.listdir(hf_w4)) and any(
        n.endswith(".safetensors") for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(hf_w1, n), os.path.join(hf_w4, n),
                           shallow=False), n


def test_sharded_eval_sums_at_fsdp2_model2(worlds):
    """Each batch rank walks its half of the eval rows and the model
    ranks share them: the sums, all-reduced over the batch axes only,
    equal the one-process walk of the same trained adapters."""
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_eval_step, sharded_eval_sums)
    ranks = worlds["res"]["tp4"]
    state = tp.build_state(worlds["inputs"]["qlora_f1"])[0]
    trained = ranks[0]["fsdp_model"]["qlora_f1"]["trained"]
    with torch.no_grad():
        for i, layer in enumerate(state.lora):
            for t in layer:
                for ab in ("a", "b"):
                    layer[t][ab].copy_(trained[f"blocks.{i}.{t}.{ab}"])
    ev = make_eval_step(state.params.cfg, lora_cfg=LoraConfig(r=8, alpha=16),
                        device="cpu")
    want = sharded_eval_sums(state, ev, worlds["inputs"]["eval_rows"],
                             host_batch=4)
    for res in ranks:
        np.testing.assert_allclose(res["eval_sums"], want, rtol=1e-6)
    assert want[1] == float(worlds["inputs"]["eval_rows"]["weights"].sum())


def test_model_that_cannot_tile_raises_before_weights(monkeypatch):
    """Heads (or a sharded dim) that ``model`` does not divide raise in
    JAX's words, from the config alone: ``fine_tune``'s worker raises
    before it builds any weight; an MoE model tiles ``model`` 2 (its
    experts sharded over it) and raises where ``model`` does not divide
    its experts."""
    jc, tc = jcfg.tiny(vocab_size=V), tcfg.tiny(vocab_size=V)
    want = jplan.ExecutionPlan(fsdp=1, model=4).model_findings(jc,
                                                                n_chips=4)
    assert model_findings(tc, model=4) == want
    assert model_findings(tc, model=2) == []
    assert "param embed dim 0 (size 258) is not divisible" in "; ".join(
        model_findings(tcfg.tiny(vocab_size=258, n_heads=8, n_kv_heads=4),
                       model=4))
    with pytest.raises(PlanError, match="n_kv_heads=2 is not divisible"):
        tshard.check_model_on_mesh(tc, 4)
    # an MoE model shards its experts over model (expert parallelism):
    # it tiles where model divides the experts, and raises where not
    tshard.check_model_on_mesh(tcfg.tiny(n_experts=4), 2)
    with pytest.raises(PlanError, match="w_gate dim 0 \\(size 4\\)"):
        tshard.check_model_on_mesh(tcfg.tiny(n_experts=4, n_heads=8,
                                             n_kv_heads=8), 8)

    from gke_ray_train_tpu_torch import fine_tune
    built = []
    monkeypatch.setattr(fine_tune, "distributed_init",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(fine_tune, "world_size", lambda: 4)
    monkeypatch.setattr(fine_tune, "build_mesh", lambda *a, **k: object())
    for name in ("init_params", "init_quantized_params"):
        monkeypatch.setattr(fine_tune, name,
                            lambda *a, _n=name, **k: built.append(_n))
    config = {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
              "MESH_FSDP": 1, "MESH_MODEL": 4, "MAX_SEQ_LENGTH": 128,
              "OUTPUT_DIR_BASE": "/nonexistent"}
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(PlanError, match="n_kv_heads=2"):
        fine_tune.train_loop_per_worker(config, device="cpu")
    assert built == []


def _masks(res, key):
    return res[key]["masks"]


def test_dropout_masks_differ_across_batch_ranks(worlds):
    """LORA_DROPOUT 0.1 on two batch ranks (fsdp 2 in the 2-rank world;
    fsdp 2 × model 2 in the 4-rank one): every projection's mask differs
    between the batch ranks, whose inputs have one shape."""
    a, b = (_masks(r, "drop_fsdp2") for r in worlds["res"]["tp2"])
    assert set(a) == set(b) == {"wq", "wk", "wv", "wo", "w_gate", "w_up",
                                "w_down"}
    for name in a:
        assert a[name].shape == b[name].shape
        assert not torch.equal(a[name], b[name]), name
    r4 = worlds["res"]["tp4"]
    for name, m in _masks(r4[0], "drop").items():
        assert not torch.equal(m, _masks(r4[2], "drop")[name]), name
    for r in worlds["res"]["tp2"] + r4:
        for key in ("drop_fsdp2", "drop_model2", "drop"):
            if key in r:
                assert np.isfinite(r[key]["loss"])


def test_dropout_masks_at_model2_column_agree_row_differ(worlds):
    """At model 2 the two model ranks of a batch rank draw the same mask
    on a column-parallel projection's input (the same replicated input)
    and different masks on a row-parallel one's (each rank's slice of
    heads / ffn columns)."""
    for pair in (worlds["res"]["tp2"], worlds["res"]["tp4"][:2],
                 worlds["res"]["tp4"][2:]):
        key = "drop_model2" if "drop_model2" in pair[0] else "drop"
        a, b = (_masks(r, key) for r in pair)
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            assert torch.equal(a[name], b[name]), name
        for name in ("wo", "w_down"):
            assert a[name].shape == b[name].shape
            assert not torch.equal(a[name], b[name]), name
        assert a["wo"].shape[-1] == 32 and a["w_down"].shape[-1] == 64


def test_world1_dropout_step_is_bitwise_the_parents():
    """One process, LORA_DROPOUT 0.1: two QLoRA steps give the loss,
    grad_norm and trained adapters recorded before the masks took the
    rank into their seeds (one thread, so the sums' order is fixed)."""
    import hashlib
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_optimizer, make_train_state, make_train_step)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tcfg.tiny(vocab_size=256, max_seq_len=64, attn_impl="xla")
        params = init_quantized_params(cfg, seed=0, group=32, device="cpu")
        lcfg = LoraConfig(r=8, alpha=16, dropout=0.1)
        spec = make_optimizer(1e-3, weight_decay=0.01, clip_norm=0.5)
        st = make_train_state(cfg, spec, lora_cfg=lcfg, params=params,
                              device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for layer in st.lora:
                for t in layer:
                    for ab in ("a", "b"):
                        layer[t][ab].copy_(torch.randn(
                            layer[t][ab].shape, generator=g) * 0.05)
        fn = make_train_step(cfg, spec, lora_cfg=lcfg, grad_accum=2,
                             device="cpu")
        r = np.random.default_rng(11)
        got = []
        for _ in range(2):
            b = {"inputs": r.integers(0, 256, (4, 64)).astype(np.int32),
                 "targets": r.integers(0, 256, (4, 64)).astype(np.int32),
                 "weights": np.ones((4, 64), np.float32)}
            st, m = fn(st, b)
            got.append((float(m["loss"]).hex(),
                        float(m["grad_norm"]).hex()))
        h = hashlib.sha256()
        for layer in st.lora:
            for t in sorted(layer):
                for ab in ("a", "b"):
                    h.update(layer[t][ab].detach().numpy().tobytes())
    finally:
        torch.set_num_threads(threads)
    assert tuple(got) == WORLD1_DROPOUT[:2]
    assert h.hexdigest() == WORLD1_DROPOUT[2]
