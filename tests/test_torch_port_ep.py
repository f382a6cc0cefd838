"""Expert parallelism on ``model``: gloo worlds of the port on the CPU
(``tests/_torch_ep.py``) held against the one-process port and against
the JAX package's meshes of the same shapes on the conftest's fake
devices.

A tiny Mixtral (2 layers, d_model 64, 4 heads over 2 KV heads, 4
experts of d_ff 128, top 2 at capacity_factor 1.25, so experts overflow;
vocab 256, fp32, dense attention; NF4 groups of 32), 3 steps at a global
batch of 8 rows of 64 tokens as 2 microbatches. Worlds: model 2 × fsdp 1
(2 ranks, 2 experts a rank) and fsdp 2 × model 2 (4 ranks), then context
2 × model 2 on the same four (ring attention, against JAX's dense
attention on its mesh). Forward logits and router aux, 3 QLoRA and 3 full
fine-tuning steps' losses and grad_norms (relative) and trained tensors
(absolute), and a full fine-tune's router and bank gradients agree
within 1e-6 with the one-process port and within 1e-5 with JAX's mesh;
decode tokens are equal. Each rank holds its experts' slices bitwise
(of a carried JAX tree and of a sharded quantized init); checkpoints
across fsdp 2 × model 2 and world 1 restore bitwise both ways; the
sharded export converts to the one-process export, bitwise.
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
from gke_ray_train_tpu.models import kvcache as jkv
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.parallel.sharding import tree_shardings
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager, save_hf_checkpoint
from gke_ray_train_tpu_torch.ckpt.convert import convert
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.parallel import sharding as tshard
from gke_ray_train_tpu_torch.plan import PlanError, model_findings
from tests import _torch_ep as ep
from tests import _torch_multirank as mr
from tests import _torch_tp as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, S, B, ACCUM, STEPS, E = 256, 64, 8, 2, 3, 4
LR, TOTAL, GROUP = 1e-3, 10, 32
PORT_TOL = 1e-6         # ranks against one process
JAX_TOL = 1e-5          # ranks against JAX's mesh
MOE = dict(vocab_size=V, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
           n_layers=2, max_seq_len=S, n_experts=E, expert_top_k=2,
           capacity_factor=1.25, name="mixtral-tiny", attn_impl="xla")
MESHES = {"model2": dict(fsdp=1, model=2), "fsdp_model": dict(fsdp=2,
                                                              model=2),
          "ctx_model": dict(fsdp=1, model=2, context=2)}
DECODE = dict(plen=(20, 33), L=64, max_new=12)


def _cfgs(**kw):
    return jcfg.tiny(**MOE, **kw), tcfg.tiny(**MOE, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, n=B):
    r = np.random.default_rng(seed)
    w = np.ones((n, S), np.float32)
    for i, k in enumerate(r.integers(S // 2, S + 1, n)):
        w[i, k:] = 0.0
    return {"inputs": r.integers(0, V, (n, S)).astype(np.int32),
            "targets": r.integers(0, V, (n, S)).astype(np.int32),
            "weights": w}


def _jax_mesh(shape):
    full = {**dict(data=1, fsdp=1, model=1, context=1), **MESHES[shape]}
    n = int(np.prod(list(full.values())))
    return jmesh.build_mesh(jmesh.MeshConfig(**full), jax.devices()[:n])


def _jax_run(quant, batches, mesh=None):
    """JAX's start (nonzero adapters for QLoRA) and its streams and final
    state after the batches, meshed or not."""
    jc, _ = _cfgs()
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
        donate=False, plan=jplan.ExecutionPlan())
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        for k in streams:
            streams[k].append(float(m[k]))
    return init, state, streams


def _case(quant, jinit, batches):
    _, tc = _cfgs()
    params = interop.params_from_numpy(_np(jinit.params), tc, device="cpu")
    lora = (interop.lora_from_numpy(_np(jinit.lora), tc, device="cpu")
            if quant else None)
    return {"cfg": tc.to_dict(), "quant": quant, "group": GROUP,
            "params": params.state_dict(), "lora": lora, "lora_r": 8,
            "lora_alpha": 16, "lr": LR, "total": TOTAL, "accum": ACCUM,
            "fused": False, "batches": batches}


def _jax_forward(jp, jc, tokens, weights, mesh=None):
    if mesh is not None:
        jp = jax.device_put(jp, tree_shardings(mesh, jtr.param_specs(jc)))
    fn = jax.jit(lambda p, t, w: jtr.forward(p, t, jc, mesh=mesh,
                                             with_aux=True, token_weights=w))
    logits, aux = fn(jp, jnp.asarray(tokens), jnp.asarray(weights))
    return {"logits": np.asarray(logits), "aux": float(aux["router_aux"])}


def _jax_decode(jp, jc, d, mesh):
    jp = jax.device_put(jp, tree_shardings(mesh, jtr.param_specs(jc)))
    return np.asarray(jkv.greedy_generate_cached(
        jp, jnp.asarray(d["prompt"]), jnp.asarray(d["plen"]), jc,
        max_new_tokens=d["max_new"]))


MIXTRAL_JOB = os.path.join(mr.REPO, "ray-jobs",
                           "fine_tune_config_mixtral.json")
# the Mixtral job cut for the CPU: 2 steps of 2 rows at 384 tokens, fp32,
# its model axis at 2 (``_torch_ep.ENTRY_MOE``), both serving switches
ENTRY_CUT = {"MAX_SEQ_LENGTH": 384, "NUM_TRAIN_SAMPLES": 4,
             "NUM_EVAL_SAMPLES": 2, "PER_DEVICE_TRAIN_BATCH_SIZE": 1,
             "GRADIENT_ACCUMULATION_STEPS": 2, "MESH_FSDP": 1,
             "MESH_MODEL": 2, "SAVE_STRATEGY": "no",
             "EVALUATION_STRATEGY_SFT": "no", "LORA_R": 4, "LORA_ALPHA": 8,
             "LORA_DROPOUT": 0.0, "TRAIN_DTYPE": "float32",
             "REPORT_TO": "none", "LOGGING_STEPS": 1, "INFERENCE": True,
             "SERVE_AFTER_TRAIN": True, "NUM_EVAL_SAMPLES_INFERENCE": 2,
             "MAX_NEW_GENERATION_TOKENS_INFERENCE": 8}


def _entry_config(out):
    import json
    with open(MIXTRAL_JOB) as f:
        job = json.load(f)
    return dict(job, **ENTRY_CUT, OUTPUT_DIR_BASE=os.path.join(out,
                                                               "entry"))


def _prompt():
    r = np.random.default_rng(11)
    buf = np.zeros((len(DECODE["plen"]), DECODE["L"]), np.int32)
    for i, n in enumerate(DECODE["plen"]):
        buf[i, :n] = r.integers(1, V, n)
    return {"prompt": buf, "plen": np.asarray(DECODE["plen"], np.int32),
            "max_new": DECODE["max_new"]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep"))
    jc, tc = _cfgs()
    batches = [_batch(100 + i) for i in range(STEPS)]
    jp = jtr.init_params(jc, jax.random.key(0))
    jnp_params = _np(jp)
    lean_np = ep.lean_tree(jnp_params)
    ltok, lw = ep.lean_tokens(5, 2, S, V)
    inputs = {"cfg": tc.to_dict(), "group": GROUP,
              "ring_cfg": tcfg.tiny(**dict(MOE, attn_impl="ring"))
              .to_dict(),
              "dots_cfg": tcfg.tiny(**MOE, remat=True,
                                    remat_policy="dots").to_dict(),
              "params": interop.params_from_numpy(jnp_params, tc,
                                                  device="cpu").state_dict(),
              "lean_params": interop.params_from_numpy(
                  lean_np, tc, device="cpu").state_dict(),
              "lean": {"tokens": ltok, "weights": lw},
              "fwd": _batch(7, n=4), "grad": _batch(8, n=4),
              "decode": _prompt(), "entry": _entry_config(out)}
    jinits = {}
    for name, quant in (("qlora", True), ("full", False)):
        jinits[name] = _jax_run(quant, [])[0]
        inputs[name] = _case(quant, jinits[name], batches)
    port = {name: tp.train(inputs[name], None) for name in ("qlora",
                                                             "full")}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    # the world-1 save the 4-rank world restores
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    st = port["full"]["state"]
    mgr.save(st.step, st, force=True)
    mgr.close()
    procs = {"ep2": ep.start("ep2", out, n=2), "ep4": ep.start("ep4", out,
                                                               n=4)}
    # one process of the port and JAX's meshes while the ranks run
    one = {"forward": ep.forward(ep.model(inputs, None)[0], tc, None,
                                 inputs["fwd"]["inputs"],
                                 inputs["fwd"]["weights"]),
           "decode": ep.decode(inputs, None)["tokens"],
           "grads": ep.gradients(inputs, None),
           "qinit": ep.qinit(inputs, None),
           "lean_forward": ep.forward(ep.model(inputs, None, "lean_params")[0],
                                      tc, None, ltok, lw)}
    jax_side = {}
    for shape in ("model2", "fsdp_model"):
        mesh = _jax_mesh(shape)
        jax_side[shape] = {"forward": _jax_forward(
            jp, jc, inputs["fwd"]["inputs"], inputs["fwd"]["weights"],
            mesh), "qlora": _jax_run(True, batches, mesh)}
    jax_side["model2"]["decode"] = _jax_decode(jp, jc, inputs["decode"],
                                               _jax_mesh("model2"))
    jax_side["ctx_model"] = {"forward": _jax_forward(
        jax.tree.map(jnp.asarray, lean_np), jc, ltok, lw,
        _jax_mesh("ctx_model"))}
    # the one-process export of the QLoRA start
    st, _, qc, lcfg = tp.build_state(inputs["qlora"])
    save_hf_checkpoint(st.params, qc, os.path.join(out, "hf_w1"),
                       lora=st.lora, lora_scale=lcfg.scale)
    mr.wait(procs["ep2"], timeout=300)
    mr.wait(procs["ep4"], timeout=300)
    res = {name: [torch.load(os.path.join(out, f"{name}_{r}.pt"),
                             weights_only=False) for r in range(n)]
           for name, n in (("ep2", 2), ("ep4", 4))}
    return dict(out=out, inputs=inputs, port=port, one=one, jax=jax_side,
                jnp_params=jnp_params, res=res)


def _logits(ranks):
    """The full logits from the ranks' vocab shards (model rank order)
    and sequence shards (context rank order)."""
    by = {}
    for r in ranks:
        k = (r["ranks"]["context"], r["ranks"]["model"])
        by.setdefault(k, r["forward"]["logits"])
    n_c = 1 + max(c for c, _ in by)
    n_m = 1 + max(m for _, m in by)
    return torch.cat([torch.cat([by[(c, m)] for m in range(n_m)], dim=-1)
                      for c in range(n_c)], dim=1).numpy()


def _close(got, want, tol, what):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    scale = max(float(np.max(np.abs(np.asarray(want)))), 1e-30)
    assert err <= tol * scale, f"{what}: {err} against {tol} x {scale}"


WORLD = {"model2": "ep2", "fsdp_model": "ep4"}


@pytest.mark.parametrize("shape", ["model2", "fsdp_model"])
def test_each_rank_holds_only_its_experts(worlds, shape):
    """The banks of a carried JAX tree, sharded by ``shard_model``: a
    rank's local bank leads with E / model experts, bitwise its experts'
    slices of the JAX tree (under fsdp 2 also cut on the bank's fsdp
    dim), placed (fsdp, model) as ``S(d), S(0)``."""
    for r in worlds["res"][WORLD[shape]]:
        mrank = r["ranks"]["model"]
        n_f = MESHES[shape]["fsdp"]
        f = r["ranks"]["batch"] if n_f > 1 else 0
        for name, (t, pl) in r["banks"].items():
            i, key = int(name.split(".")[1]), name.split(".")[2]
            assert t.shape[0] == E // 2, (name, t.shape)
            fdim = 2 if key == "w_down" else 1
            assert pl == (f"S({fdim})", "S(0)"), (name, pl)
            full = worlds["jnp_params"]["blocks"][0][key][i]
            want = np.array_split(full[mrank * 2:(mrank + 1) * 2], n_f,
                                  axis=fdim)[f]
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


def test_sharded_quantized_init_makes_the_ranks_experts_bitwise(worlds):
    """``init_quantized_params(mesh=)`` at model 2: a rank draws every
    expert but quantizes only its own; its codes and scales equal one
    process's slices bitwise."""
    one = worlds["one"]["qinit"]
    for r in worlds["res"]["ep2"]:
        m = r["ranks"]["model"]
        for name, (t, pl) in r["qinit"].items():
            assert t.shape[0] == E // 2 and pl[1] == "S(0)", (name, pl)
            assert torch.equal(t, one[name][0][2 * m:2 * m + 2]), name


@pytest.mark.parametrize("shape", ["model2", "fsdp_model"])
def test_forward_matches_one_process_and_jax_mesh(worlds, shape):
    """Logits (each rank's vocab shard put together) and the router aux
    against one process and JAX's mesh of the shape."""
    ranks = worlds["res"][WORLD[shape]]
    got = _logits(ranks)
    one, jx = worlds["one"]["forward"], worlds["jax"][shape]["forward"]
    _close(got, one["logits"].numpy(), PORT_TOL, "one process")
    _close(got, jx["logits"], JAX_TOL, "jax mesh")
    for r in ranks:
        assert abs(r["forward"]["aux"] - one["aux"]) <= PORT_TOL
        assert abs(r["forward"]["aux"] - jx["aux"]) <= JAX_TOL


def test_context2_model2_forward_matches_jax_mesh(worlds):
    """Context 2 × model 2 (JAX's ``test_moe_forward_context_sharded_
    matches_unsharded`` composition) on tokens whose sequence halves lean
    to different experts: ring attention over the context ranks, experts
    over the model ranks, the whole row's capacity; logits against one
    process and JAX's mesh of that shape."""
    got = _logits([r["cm"] for r in worlds["res"]["ep4"]])
    _close(got, worlds["one"]["lean_forward"]["logits"].numpy(), PORT_TOL,
           "one process")
    _close(got, worlds["jax"]["ctx_model"]["forward"]["logits"], JAX_TOL,
           "jax mesh")


@pytest.mark.parametrize("remat", ["off", "dots"])
def test_full_ft_router_and_bank_gradients(worlds, remat):
    """One full-FT microbatch's backward at model 2: the router's
    gradient whole and equal on both ranks (the gate and the dispatched
    input enter through ``copy_to_model``, the aux is counted once), the
    banks' gradients put together from the ranks' experts, against one
    process without remat; with ``remat_policy="dots"`` (the expert
    ``bmm``s recomputed, the collectives run again) the same."""
    one = worlds["one"]["grads"]
    key = "grads" if remat == "off" else "grads_dots"
    ranks = worlds["res"]["ep2"]
    assert set(ranks[0][key]) == set(one)
    for name, want in one.items():
        a, b = ranks[0][key][name], ranks[1][key][name]
        assert torch.equal(a, b), name
        _close(a.numpy(), want.numpy(), PORT_TOL, name)


def _hold(got, port, jax_side=None, quant=True):
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(got["streams"][k], port["streams"][k],
                                   rtol=PORT_TOL, atol=1e-9, err_msg=k)
        if jax_side is not None:
            np.testing.assert_allclose(got["streams"][k], jax_side[2][k],
                                       rtol=JAX_TOL, atol=1e-9, err_msg=k)
    assert set(got["trained"]) == set(port["trained"])
    jw = None
    if jax_side is not None:
        _, tc = _cfgs()
        lora = interop.lora_from_numpy(_np(jax_side[1].lora), tc,
                                       device="cpu")
        jw = {f"blocks.{i}.{t}.{ab}": layer[t][ab]
              for i, layer in enumerate(lora) for t in layer
              for ab in ("a", "b")}
    for name, t in got["trained"].items():
        np.testing.assert_allclose(t.numpy(), port["trained"][name].numpy(),
                                   rtol=0, atol=PORT_TOL, err_msg=name)
        if jw is not None:
            np.testing.assert_allclose(t.numpy(), jw[name].numpy(), rtol=0,
                                       atol=JAX_TOL, err_msg=name)


@pytest.mark.parametrize("shape", ["model2", "fsdp_model"])
@pytest.mark.parametrize("case", ["qlora", "full"])
def test_three_steps_match_one_process_and_jax_mesh(worlds, shape, case):
    """3 steps' losses, grad_norms and tokens and the trained tensors
    (QLoRA: the attention adapters; full: every parameter, the router and
    the banks among them) on every rank, against one process and, for
    QLoRA, JAX's mesh of the shape."""
    jax_side = worlds["jax"][shape]["qlora"] if case == "qlora" else None
    for r in worlds["res"][WORLD[shape]]:
        _hold(r["train"][case], worlds["port"][case], jax_side)


def test_cached_decode_tokens_at_model2(worlds):
    """Greedy decode with the cache on the model-2 ranks (each running
    its experts on every token): tokens equal one process's and JAX's on
    its mesh of that shape."""
    want = worlds["one"]["decode"].numpy()
    np.testing.assert_array_equal(worlds["jax"]["model2"]["decode"], want)
    for r in worlds["res"]["ep2"]:
        np.testing.assert_array_equal(r["decode"]["tokens"].numpy(), want)


def test_save_at_fsdp2_model2_restores_bitwise_at_world1(worlds):
    """The 4 ranks' save of the trained full-FT state (banks sharded on
    the expert dim over model and on their fsdp dim), read into a
    one-process template, equals the ranks' state bitwise."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    template = tp.build_state(worlds["inputs"]["full"])[0]
    mgr = CheckpointManager(os.path.join(worlds["out"], "ckpt_full_w4"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    assert mgr.last_restore_resharded == (4, 1)
    mgr.close()
    saved = worlds["res"]["ep4"][0]["full_saved"]
    got = flat_state(template)
    assert set(got) == set(saved)
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_world1_save_restores_bitwise_at_fsdp2_model2(worlds):
    """The one-process save, restored into the 4 ranks' fsdp 2 × model 2
    template, equals the one-process state bitwise on every rank."""
    want = mr.full_state(worlds["port"]["full"]["state"])
    for r in worlds["res"]["ep4"]:
        assert r["resharded"] == (1, 4)
        got = r["full_restored"]
        assert set(got) == set(want)
        for k, v in want.items():
            if torch.is_tensor(v):
                assert torch.equal(got[k], v), k
            else:
                assert got[k] == v, k


def test_sharded_export_converts_to_the_one_process_export(worlds,
                                                            tmp_path):
    """The 4 ranks' export of the merged QLoRA start (each bank written
    in parts by the ranks holding its experts, never gathered over
    model), converted, equals the one-process HF export file for file."""
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


def test_experts_model_does_not_divide_raises_before_weights():
    """``E % model != 0`` raises in JAX's words from the config alone;
    a model that tiles raises nothing."""
    _, tc = _cfgs()
    assert model_findings(tc, model=2) == []
    bad = tcfg.tiny(**dict(MOE, n_experts=6, n_heads=8, n_kv_heads=4))
    found = model_findings(bad, model=4)
    assert found == [
        f"param {k} dim 0 (size 6) is not divisible by mesh axes "
        "('model',) (size 4)" for k in ("w_gate", "w_up", "w_down")]
    jfound = "; ".join(jplan.ExecutionPlan(fsdp=1, model=4).model_findings(
        jcfg.tiny(**dict(MOE, n_experts=6, n_heads=8, n_kv_heads=4)),
        n_chips=4))
    assert "(size 6) is not divisible by mesh axes ('model',) (size 4)" \
        in jfound
    with pytest.raises(PlanError, match="w_gate dim 0 \\(size 6\\)"):
        tshard.check_model_on_mesh(bad, 4)
    tshard.check_model_on_mesh(tc, 2)


def test_entry_at_model2_serves_and_exports_the_experts(worlds, tmp_path):
    """The fine-tune entry on the Mixtral job (its model cut to a tiny
    Mixtral) at ``MESH_MODEL`` 2 with ``INFERENCE`` and
    ``SERVE_AFTER_TRAIN``: both ranks finish with the same finite loss;
    the sharded export, each bank written by the rank holding its
    experts, converts to expert tensors bitwise a one-process quantized
    init's banks dequantized (a frozen base: LoRA adapts attention
    only)."""
    import glob
    from safetensors.torch import load_file
    from gke_ray_train_tpu_torch.ckpt.hf_io import (
        _EXPERT_HF, _hf_expert_names, _maybe_t, hf_tensor)
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.ops.quant import dequantize
    losses = [r["entry"]["loss"] for r in worlds["res"]["ep2"]]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    root = worlds["inputs"]["entry"]["OUTPUT_DIR_BASE"]
    export = glob.glob(os.path.join(root, "*_dcp"))
    assert len(export) == 1, export
    hf = str(tmp_path / "hf")
    convert(export[0], hf, dtype="bfloat16")
    got = {}
    for path in glob.glob(os.path.join(hf, "*.safetensors")):
        got.update(load_file(path))
    cfg = ep.entry_model_cfg(dtype="float32", param_dtype="float32")
    base = init_quantized_params(cfg, seed=0, device="cpu")
    for i, blk in enumerate(base.blocks):
        for key in _EXPERT_HF:
            bank = dequantize(getattr(blk, key), torch.float32)
            for e in range(cfg.n_experts):
                name = _hf_expert_names(i, e)[key]
                want = hf_tensor(_maybe_t(bank[e], key), "bfloat16")
                assert torch.equal(got[name], want), name
