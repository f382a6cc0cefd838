"""Pipeline parallelism on ``pipe``: gloo worlds of the port on the CPU
(``tests/_torch_pp.py``) held against the one-process port and against
the JAX package's pipelined meshes of the same shapes on the conftest's
fake devices.

A tiny Llama (4 layers, d_model 64, 4 heads over 2 KV heads, vocab 256,
fp32, dense attention, S 32), 3 steps at a global batch of 8 rows as
grad-accum 2 x pipe microbatches 2, as JAX's
``test_pipeline_train_step_matches_plain`` runs it. Worlds: pipe 2 (and
virtual 2), pipe 2 x fsdp 2, pipe 2 x data 2, pipe 2 x context 2 (ring
and a2a, virtual 1 and 2). The one-process reference runs the same rows
as ``accum x M`` microbatches of one process, the pipeline's math and
order. Forward logits, 3 QLoRA and 3 full fine-tuning steps' losses and
grad_norms (relative) and trained tensors (absolute) agree within 1e-6
with one process; logits within 1e-5 with JAX's pipelined mesh of each
shape, and the pipe 2 steps with JAX's pipelined steps. Also: the
packed-segments batch, a tiny Gemma-2 (tied embedding: the lookup's and
the head's gradients summed over the pipe group), a tiny Mixtral's
router aux (JAX's pipelined aux exactly, the unpipelined one at JAX's
own ``rtol=1e-2``), the tick pin, the error gates in JAX's words, a
checkpoint across pipe 2 and world 1 both ways, the sharded export, the
stage's quantized init, the divergence guard, the plan and config
surface against JAX's ``plan.py``, and what the mesh check and a
pipelined engine still refuse.
"""

import dataclasses
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
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.parallel.sharding import tree_shardings
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager, save_hf_checkpoint
from gke_ray_train_tpu_torch.ckpt.convert import convert
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import pipeline as tpipe
from gke_ray_train_tpu_torch.parallel import mesh as tmesh
from gke_ray_train_tpu_torch.plan import ExecutionPlan, PlanError, model_findings
from tests import _torch_multirank as mr
from tests import _torch_pp as pp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, S, B, ACCUM, M, STEPS = 256, 32, 8, 2, 2, 3
LR, TOTAL, GROUP = 1e-3, 10, 32
PORT_TOL = 1e-6         # ranks against one process
JAX_TOL = 1e-5          # ranks against JAX's pipelined mesh
AUX_RTOL = 1e-2         # pipelined router aux against the unpipelined one
LLAMA = dict(vocab_size=V, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
             n_layers=4, max_seq_len=S, attn_impl="xla")
GEMMA = dict(LLAMA, logit_softcap=30.0, attn_softcap=50.0,
             tie_embeddings=True, post_block_norm=True,
             norm_scale_plus_one=True, embed_scale=True,
             activation="gelu_tanh", block_pattern=("sliding", "global"),
             sliding_window=24)
MOE = dict(LLAMA, n_layers=2, n_experts=4, expert_top_k=2,
           capacity_factor=1.25, name="mixtral-tiny")
FAMILIES = {"llama": LLAMA, "gemma": GEMMA, "moe": MOE}
# the JAX meshes of the worlds, by the world's key
JAX_MESHES = {"v1": dict(pipe=2), "v2": dict(pipe=2),
              "fsdp": dict(fsdp=2, pipe=2), "data": dict(data=2, pipe=2),
              "ring_v1": dict(context=2, pipe=2),
              "ring_v2": dict(context=2, pipe=2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _packed(r, n):
    seg = np.ones((n, S), np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (n, 1))
    for i in range(n):
        cut = int(r.integers(6, S - 6))
        seg[i, cut:] = 2
        pos[i, cut:] = np.arange(S - cut)
    return seg, pos


def _batch(seed, n=B, packed=False):
    r = np.random.default_rng(seed)
    b = {"inputs": r.integers(0, V, (n, S)).astype(np.int32),
         "targets": r.integers(0, V, (n, S)).astype(np.int32)}
    w = np.ones((n, S), np.float32)
    for i, k in enumerate(r.integers(S // 2, S + 1, n)):
        w[i, k:] = 0.0
    b["weights"] = w
    if packed:
        b["segment_ids"], b["positions"] = _packed(r, n)
    return b


def _jax_mesh(**kw):
    full = {**dict(data=1, fsdp=1, model=1, context=1, pipe=1), **kw}
    n = int(np.prod(list(full.values())))
    return jmesh.build_mesh(jmesh.MeshConfig(**full), jax.devices()[:n])


def _jax_state(family, quant, mesh=None):
    """JAX's start of ``family`` (nonzero adapters for QLoRA): (state,
    optimizer, schedule, lora config, cfg)."""
    jc = jcfg.tiny(**FAMILIES[family])
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
    return state, opt, sched, lcfg, jc


def _jax_train(family, quant, batches, mesh):
    """JAX's pipelined steps on ``mesh``: the streams and final state."""
    state, opt, sched, lcfg, jc = _jax_state(family, quant, mesh)
    step = jstep.make_train_step(
        jc, opt, mesh=mesh, lora_cfg=lcfg, grad_accum=ACCUM,
        schedule=sched, donate=False, pipe_microbatches=M,
        plan=jplan.ExecutionPlan(pipe=2, pipe_microbatches=M))
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        for k in streams:
            streams[k].append(float(m[k]))
    return state, streams


def _jax_forward(family, tokens, mesh, virtual=1, segment_ids=None,
                 positions=None):
    jc = dataclasses.replace(jcfg.tiny(**FAMILIES[family]),
                             pipe_virtual=virtual)
    jp = jtr.init_params(jc, jax.random.key(0))
    jp = jax.device_put(jp, tree_shardings(mesh, jtr.param_specs(jc)))
    kw = {}
    if segment_ids is not None:
        kw = dict(segment_ids=jnp.asarray(segment_ids),
                  positions=jnp.asarray(positions))
    logits, aux = jax.jit(lambda p, t: jtr.forward(
        p, t, jc, mesh=mesh, with_aux=True, **kw))(jp, jnp.asarray(tokens))
    return {"logits": np.asarray(logits), "aux": float(aux["router_aux"])}


def _jax_start(family, quant):
    """JAX's start of ``family`` as ``_jax_state`` makes it, without its
    optimizer: the params, and for QLoRA the adapters (their tree's
    shapes from ``init_lora``, the values of ``_jax_state``'s draw)."""
    jc = jcfg.tiny(**FAMILIES[family])
    params = jtr.init_params(jc, jax.random.key(0))
    if not quant:
        return params, None
    params = jquant.quantize_params(params, kind="nf4", group=GROUP)
    lora = jlora.init_lora(jc, jlora.LoraConfig(r=8, alpha=16),
                           jax.random.key(1))
    r = np.random.default_rng(3)
    return params, jax.tree.map(lambda x: jnp.asarray(r.standard_normal(
        x.shape).astype(np.float32) * 0.05), lora)


def _case(family, quant, batches):
    """The port's case of JAX's start (``_torch_pp.build_state``)."""
    jparams, jlora_tree = _jax_start(family, quant)
    tc = tcfg.tiny(**FAMILIES[family])
    params = interop.params_from_numpy(_np(jparams), tc, device="cpu")
    lora = (interop.lora_from_numpy(_np(jlora_tree), tc, device="cpu")
            if quant else None)
    return {"cfg": tc.to_dict(), "quant": quant, "group": GROUP,
            "params": params.state_dict(), "lora": lora, "lora_r": 8,
            "lora_alpha": 16, "lr": LR, "total": TOTAL, "accum": ACCUM,
            "M": M, "batches": batches}


OFFLINE_JOB = os.path.join(mr.REPO, "ray-jobs",
                           "fine_tune_config_offline_8b.json")
# the offline_8b job cut for the CPU: fp32, 384 tokens, 2 steps of 4 rows
# (grad-accum 2 x pipe microbatches 2 of one row), a save and an eval
# every step, at MESH_PIPE 2
ENTRY_CUT = {"MAX_SEQ_LENGTH": 384, "NUM_TRAIN_SAMPLES": 8,
             "NUM_EVAL_SAMPLES": 4, "PER_DEVICE_TRAIN_BATCH_SIZE": 2,
             "GRADIENT_ACCUMULATION_STEPS": 2, "PIPE_MICROBATCHES": 2,
             "MESH_FSDP": 1, "MESH_PIPE": 2, "SAVE_STEPS_SFT": 1,
             "EVAL_STEPS_SFT": 1, "LORA_R": 4, "LORA_ALPHA": 8,
             "TRAIN_DTYPE": "float32", "REPORT_TO": "none",
             "LOGGING_STEPS": 1, "QUANT_KIND": "nf4"}


def _entry_config(out):
    import json
    with open(OFFLINE_JOB) as f:
        job = json.load(f)
    return dict(job, **ENTRY_CUT, OUTPUT_DIR_BASE=os.path.join(out,
                                                               "entry"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pp"))
    batches = [_batch(100 + i) for i in range(STEPS)]
    packed = [_batch(200 + i, packed=True) for i in range(STEPS)]
    fwd = _batch(7, n=4, packed=True)
    inputs = {"group": GROUP, "fwd": fwd, "entry": _entry_config(out),
              "llama_qlora": _case("llama", True, batches),
              "llama_full": _case("llama", False, batches),
              "llama_packed": _case("llama", False, packed),
              "gemma_full": _case("gemma", False, batches),
              "moe_qlora": _case("moe", True, batches),
              "moe_full": _case("moe", False, batches)}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    # the world-1 save the stages restore
    state = pp.build_state(inputs["llama_full"])[0]
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    mgr.save(state.step, state, force=True)
    mgr.close()
    one = {"full_state": mr.full_state(state)}
    procs = {"pp2": pp.start("pp2", out, n=2), "pp4": pp.start("pp4", out,
                                                               n=4)}
    # one process of the port while the ranks run (on two threads: the six
    # ranks take one each): the same rows as accum x M microbatches
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for name in ("llama_qlora", "llama_full", "llama_packed",
                     "gemma_full", "moe_qlora"):
            one[name] = pp.train(inputs[name], None)
        one["llama_qlora_v2"] = pp.train(inputs["llama_qlora"], None, 2)
    finally:
        torch.set_num_threads(threads)
    for name, case, seg in (("forward", "llama_full", None),
                            ("packed", "llama_full", "segment_ids"),
                            ("gemma", "gemma_full", None),
                            ("moe", "moe_full", None)):
        one[f"fwd_{name}"] = pp.forward(
            inputs[case], None, fwd["inputs"],
            segment_ids=fwd[seg] if seg else None)
    # JAX's pipelined meshes while the ranks run
    jx = {"forward": {}}
    for key, kw in JAX_MESHES.items():
        jx["forward"][key] = _jax_forward(
            "llama", fwd["inputs"], _jax_mesh(**kw),
            virtual=2 if key.endswith("v2") else 1)
    m2 = _jax_mesh(pipe=2)
    jx["packed"] = _jax_forward("llama", fwd["inputs"], m2,
                                segment_ids=fwd["segment_ids"],
                                positions=np.tile(np.arange(S), (4, 1)))
    jx["gemma"] = _jax_forward("gemma", fwd["inputs"], m2)
    jx["moe"] = _jax_forward("moe", fwd["inputs"], m2)
    jx["moe_plain"] = _jax_forward("moe", fwd["inputs"], _jax_mesh())
    for name, family, quant in (("llama_qlora", "llama", True),
                                ("llama_full", "llama", False)):
        jx[name] = _jax_train(family, quant, batches, m2)
    # the one-process export of the QLoRA start
    st, _, qc, lcfg = pp.build_state(inputs["llama_qlora"])
    save_hf_checkpoint(st.params, qc, os.path.join(out, "hf_w1"),
                       lora=st.lora, lora_scale=lcfg.scale)
    mr.wait(procs["pp2"], timeout=300)
    mr.wait(procs["pp4"], timeout=300)
    res = {name: [torch.load(os.path.join(out, f"{name}_{r}.pt"),
                             weights_only=False) for r in range(n)]
           for name, n in (("pp2", 2), ("pp4", 4))}
    return dict(out=out, inputs=inputs, one=one, jax=jx, res=res)


def _close(got, want, tol, what):
    got = np.asarray(got)
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert err <= tol * scale, f"{what}: {err} against {tol} x {scale}"


def _world(worlds, key):
    """(ranks' results of world ``key``) from the pp2 / pp4 outputs."""
    if key in ("v1", "v2"):
        return [r[key] for r in worlds["res"]["pp2"]], worlds["res"]["pp2"]
    return [r[key] for r in worlds["res"]["pp4"]], [r[key] for r in
                                                    worlds["res"]["pp4"]]


def _logits(results):
    """The logits of a world: the same on every pipe rank; over context
    each context rank's tokens, in context order."""
    by = {}
    for r, meta in results:
        by.setdefault(meta["context"], r["logits"])
    return torch.cat([by[c] for c in sorted(by)], dim=1).numpy()


def _hold(got, one, tol=PORT_TOL, stream_rtol=PORT_TOL, tensors=True):
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(got["streams"][k], one["streams"][k],
                                   rtol=stream_rtol, atol=1e-9, err_msg=k)
    if tensors:
        for name, t in got["trained"].items():
            np.testing.assert_allclose(
                t.numpy(), one["trained"][name].numpy(), rtol=0, atol=tol,
                err_msg=name)


def _merged(ranks):
    """The union of the ranks' trained tensors (each stage its layers)."""
    out = {}
    for r in ranks:
        out.update(r["trained"])
    return out


@pytest.mark.parametrize("key", ["v1", "v2", "fsdp", "data", "ring_v1",
                                 "ring_v2", "a2a_v1", "a2a_v2"])
def test_forward_matches_one_process_and_jax_mesh(worlds, key):
    """The pipelined forward (the last stage's output broadcast, the head
    on every stage) against one process and JAX's pipelined mesh of the
    world's shape (dense attention there, the same math)."""
    ranks = ([r for r in worlds["res"]["pp2"]] if key in ("v1", "v2")
             else worlds["res"]["pp4"])
    results = [(r[key]["forward"], (r["ranks"] if key in ("v1", "v2")
                                    else r[key]["ranks"]))
               for r in ranks]
    got = _logits(results)
    _close(got, worlds["one"]["fwd_forward"]["logits"].numpy(), PORT_TOL,
           "one process")
    jkey = key.replace("a2a", "ring")
    _close(got, worlds["jax"]["forward"][jkey]["logits"], JAX_TOL,
           "jax mesh")


def test_each_stage_holds_only_its_layers(worlds):
    """Pipe rank p holds the layers of its groups {j·P + p}: at virtual 1
    layers 2p, 2p + 1 of 4; at virtual 2 layers p and p + 2; the trained
    tensors of a stage name its layers (and the root) only."""
    for r in worlds["res"]["pp2"]:
        p = r["ranks"]["pipe"]
        assert r["v1"]["forward"]["layers"] == [2 * p, 2 * p + 1]
        assert r["v2"]["forward"]["layers"] == [p, p + 2]
        blocks = {int(n.split(".")[1]) for n in
                  r["v2"]["llama_full"]["trained"] if n.startswith("blocks.")}
        assert blocks == {p, p + 2}
    for r in worlds["res"]["pp4"]:
        p = r["fsdp"]["ranks"]["pipe"]
        assert r["fsdp"]["forward"]["layers"] == [2 * p, 2 * p + 1]


@pytest.mark.parametrize("key", ["v1", "v2", "fsdp", "data"])
@pytest.mark.parametrize("case", ["llama_qlora", "llama_full"])
def test_three_steps_match_one_process(worlds, key, case):
    """3 steps' streams on every rank and the trained tensors (each
    stage's layers, the root on every stage) against one process; the
    stages' tensors together are the whole model's."""
    one = (worlds["one"]["llama_qlora_v2"] if (key, case) == (
        "v2", "llama_qlora") else worlds["one"][case])
    ranks = [r[key][case] for r in (worlds["res"]["pp2"] if key in (
        "v1", "v2") else worlds["res"]["pp4"])]
    for r in ranks:
        _hold(r, one)
    assert set(_merged(ranks)) == set(one["trained"])


@pytest.mark.parametrize("key", ["ring_v1", "ring_v2", "a2a_v1", "a2a_v2"])
def test_context_worlds_train_as_one_process(worlds, key):
    """Pipe 2 x context 2 (ring or a2a attention across the context
    ranks inside each stage's blocks): 3 QLoRA steps against one
    process."""
    one = worlds["one"]["llama_qlora" if key.endswith("v1")
                        else "llama_qlora_v2"]
    for r in worlds["res"]["pp4"]:
        _hold(r[key]["llama_qlora"], one)


@pytest.mark.parametrize("case", ["llama_qlora", "llama_full"])
def test_pipe2_steps_match_jax_pipelined_steps(worlds, case):
    """The pipe 2 world's streams and trained tensors against JAX's
    pipelined step at grad-accum 2 x pipe microbatches 2."""
    jstate, streams = worlds["jax"][case]
    ranks = [r["v1"][case] for r in worlds["res"]["pp2"]]
    for r in ranks:
        for k in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(r["streams"][k], streams[k],
                                       rtol=JAX_TOL, atol=1e-9, err_msg=k)
    tc = tcfg.tiny(**LLAMA)
    if case == "llama_qlora":
        lora = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        want = {f"blocks.{i}.{t}.{ab}": layer[t][ab]
                for i, layer in enumerate(lora) for t in layer
                for ab in ("a", "b")}
    else:
        want = {k: v for k, v in interop.params_from_numpy(
            _np(jstate.params), tc, device="cpu").state_dict().items()}
    got = _merged(ranks)
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=JAX_TOL, err_msg=name)


def test_packed_segments(worlds):
    """Packed rows (segment ids and restarting positions): the forward
    against one process and JAX's pipelined mesh, 3 full fine-tuning
    steps against one process."""
    for r in worlds["res"]["pp2"]:
        got = r["packed"]["forward"]["logits"].numpy()
        _close(got, worlds["one"]["fwd_packed"]["logits"].numpy(),
               PORT_TOL, "one process")
        _close(got, worlds["jax"]["packed"]["logits"], JAX_TOL, "jax")
        _hold(r["packed"]["train"], worlds["one"]["llama_packed"])


def test_gemma2_tied_embedding_sums_the_root_over_pipe(worlds):
    """Gemma-2's pattern (sliding / global, softcaps, post-norms, a tied
    embedding): the forward against one process and JAX's pipelined
    mesh; 3 full fine-tuning steps against one process, the tied
    embedding's gradient the first stage's lookup's plus the last
    stage's head's, the same on both stages."""
    ranks = worlds["res"]["pp2"]
    for r in ranks:
        got = r["gemma"]["forward"]["logits"].numpy()
        _close(got, worlds["one"]["fwd_gemma"]["logits"].numpy(), PORT_TOL,
               "one process")
        _close(got, worlds["jax"]["gemma"]["logits"], JAX_TOL, "jax")
        _hold(r["gemma"]["train"], worlds["one"]["gemma_full"])
    assert torch.equal(ranks[0]["gemma"]["train"]["trained"]["embed"],
                       ranks[1]["gemma"]["train"]["trained"]["embed"])


def test_moe_router_aux_is_jax_pipelined_aux(worlds):
    """A tiny Mixtral: the pipelined router aux equals JAX's pipelined aux
    (a mean over microbatches of per-microbatch means) and the
    unpipelined one within JAX's own rtol 1e-2; the logits equal one
    process's; 3 QLoRA steps' streams within 1e-2 of one process."""
    one = worlds["one"]["fwd_moe"]
    for r in worlds["res"]["pp2"]:
        f = r["moe"]["forward"]
        _close(f["logits"].numpy(), one["logits"].numpy(), PORT_TOL,
               "logits")
        assert abs(f["aux"] - worlds["jax"]["moe"]["aux"]) <= \
            JAX_TOL * abs(worlds["jax"]["moe"]["aux"])
        np.testing.assert_allclose(f["aux"], one["aux"], rtol=AUX_RTOL)
        np.testing.assert_allclose(
            worlds["jax"]["moe"]["aux"], worlds["jax"]["moe_plain"]["aux"],
            rtol=AUX_RTOL)
        _hold(r["moe"]["train"], worlds["one"]["moe_qlora"],
              stream_rtol=AUX_RTOL, tensors=False)


@pytest.mark.parametrize("v,P,M_", [(1, 2, 4), (2, 2, 4), (2, 2, 8)])
def test_tick_pin(v, P, M_):
    """JAX's tick count ``T = M + v·P - 1``, and ``M·v`` stage passes a
    rank, each (group, microbatch) once, every hop in layer order."""
    seen = set()
    for p in range(P):
        sch = tpipe.Schedule(P, v, M_, p)
        assert sch.ticks == M_ + v * P - 1
        assert sch.passes == M_ * v
        for t in range(sch.ticks):
            for j, m in sch.slots(t):
                assert m == t - (j * P + p)
                seen.add((j * P + p, m))
    assert seen == {(h, m) for h in range(v * P) for m in range(M_)}


def test_error_gates_in_jax_words(worlds):
    """Each gate raises on both stages in JAX's words (``pipeline.py:333-
    365``, ``transformer.py:466-470``); ``attn impl`` through the impl
    resolution; a pipelined forward under autograd raises."""
    want = {"microbatches": "pipeline microbatches (1) must be >= pipe "
                            "stages (2)",
            "divisible": "batch 4 not divisible by 3 pipeline microbatches",
            "dropout": "LoRA dropout is not supported on a pipelined mesh",
            "n_repeats": "n_repeats=4 must be divisible by pipe axis x "
                         "virtual stages (2 x 4)",
            "virtual": "pipe_virtual=0 must be >= 1",
            "autograd forward": "runs without autograd"}
    for r in worlds["res"]["pp2"]:
        for name, text in want.items():
            assert r["gates"][name] is not None and text in \
                r["gates"][name], (name, r["gates"][name])
    bad = tcfg.tiny(**LLAMA)
    object.__setattr__(bad, "attn_impl", "nope")
    with pytest.raises(ValueError, match="unknown attn impl 'nope'"):
        tpipe.resolve_impl(bad, None, S, torch.device("cpu"))
    with pytest.raises(ValueError, match="batch-parallel extent 2"):
        tpipe.check_microbatches(2, 2, 1, 1, 2)


def test_checkpoint_pipe2_restores_bitwise_at_world1(worlds):
    """The stages' save of the trained full-FT state (each its layers under
    their global names), read into a one-process template, equals the
    stages' state bitwise."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    template = pp.build_state(worlds["inputs"]["llama_full"])[0]
    mgr = CheckpointManager(os.path.join(worlds["out"], "ckpt_pp2"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    assert mgr.last_restore_resharded == (2, 1)
    mgr.close()
    saved = {}
    for r in worlds["res"]["pp2"]:
        saved.update(r["full_saved"])
    got = flat_state(template)
    assert set(got) == set(saved)
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert torch.equal(mr._whole(got[k]), v), k
        else:
            assert got[k] == v, k


def test_world1_save_restores_bitwise_at_pipe2(worlds):
    """The one-process save restored into each stage: its layers and the
    root equal one process's bitwise."""
    want = worlds["one"]["full_state"]
    for r in worlds["res"]["pp2"]:
        assert r["resharded"] == (1, 2)
        got = r["full_restored"]
        assert set(got) <= set(want) and "opt/count" in got
        for k, v in got.items():
            if torch.is_tensor(v):
                assert torch.equal(v, want[k]), k
            else:
                assert v == want[k], k
    keys = set()
    for r in worlds["res"]["pp2"]:
        keys |= set(r["full_restored"])
    assert keys == set(want)


def test_sharded_export_converts_to_the_one_process_export(worlds,
                                                            tmp_path):
    """The stages' export of the merged QLoRA start (each layer written by
    its stage), converted, equals the one-process HF export file for
    file."""
    hf = str(tmp_path / "hf_pp2")
    convert(os.path.join(worlds["out"], "export_pp2"), hf, dtype="bfloat16")
    hf_w1 = os.path.join(worlds["out"], "hf_w1")
    names = sorted(os.listdir(hf_w1))
    assert names == sorted(os.listdir(hf)) and any(
        n.endswith(".safetensors") for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(hf_w1, n), os.path.join(hf, n),
                           shallow=False), n


def test_sharded_quantized_init_makes_the_stage_bitwise(worlds):
    """``init_quantized_params(mesh=)`` at pipe 2: a stage makes its own
    blocks only, drawing the others' without keeping them; its tensors
    equal one process's bitwise."""
    from gke_ray_train_tpu_torch.models import init_quantized_params
    one = init_quantized_params(tcfg.tiny(**LLAMA), seed=5, group=GROUP,
                                device="cpu")
    want = {**dict(one.named_parameters()), **dict(one.named_buffers())}
    for r in worlds["res"]["pp2"]:
        p = r["ranks"]["pipe"]
        got = r["qinit"]
        blocks = {int(k.split(".")[1]) for k in got if k.startswith("blocks.")}
        assert blocks == {2 * p, 2 * p + 1}
        for k, t in got.items():
            assert torch.equal(t, want[k]), k


def test_divergence_guard_on_a_pipelined_run(worlds):
    """The guard hashes the whole model's layer names on every stage: two
    healthy stages agree; a stage whose adapters have another rank makes
    both raise."""
    ranks = worlds["res"]["pp2"]
    assert ranks[0]["guard"]["healthy"] == ranks[1]["guard"]["healthy"]
    for r in ranks:
        assert r["guard"]["diverged"] is not None
        assert "DIFFERENT" in r["guard"]["diverged"]


def test_plan_and_config_surface_match_jax():
    """``PIPE_MICROBATCHES`` / ``PIPE_VIRTUAL_STAGES`` resolve as JAX's
    plan resolves them, with JAX's bounds; the depth finding in JAX's
    words; the pipe keys are the port's at a world above one."""
    config = {"PIPE_MICROBATCHES": "8", "PIPE_VIRTUAL_STAGES": 2,
              "MESH_PIPE": 2}
    ours = ExecutionPlan.resolve(config, env={})
    theirs = jplan.ExecutionPlan.resolve(config, env={})
    assert (ours.pipe_microbatches, ours.pipe_virtual_stages) == \
        (theirs.pipe_microbatches, theirs.pipe_virtual_stages) == (8, 2)
    assert ExecutionPlan().pipe_microbatches == \
        jplan.ExecutionPlan().pipe_microbatches == 0
    for bad in ({"PIPE_MICROBATCHES": -1}, {"PIPE_VIRTUAL_STAGES": 0}):
        with pytest.raises(PlanError):
            ExecutionPlan.resolve(bad, env={})
        with pytest.raises(jplan.PlanError):
            jplan.ExecutionPlan.resolve(bad, env={})
    tc, jc = tcfg.tiny(**LLAMA), jcfg.tiny(**LLAMA)
    assert model_findings(tc, model=1, pipe=2, virtual=2) == []
    found = model_findings(tc, model=1, pipe=2, virtual=3)
    jfound = jplan.ExecutionPlan(fsdp=1, pipe=2, pipe_virtual_stages=3) \
        .model_findings(jc, n_chips=2)
    assert found == [f for f in jfound if "n_repeats" in f] == [
        "n_repeats=4 is not divisible by pipe axis x virtual stages "
        "(2 x 3)"]
    keys = {"MESH_PIPE": 2, "PIPE_MICROBATCHES": 8,
            "PIPE_VIRTUAL_STAGES": 2}
    assert tconfig.tpu_only_keys(keys) == sorted(keys)
    assert tconfig.tpu_only_keys(keys, world=2) == []


def test_pipe_over_model_ports_and_the_rest_raise_naming_their_items(
        worlds):
    """Pipe over ``model`` (TP, EP) passes the mesh check; two slices of
    a ``data`` axis of 1 are refused there in the words of JAX's
    ``build_mesh`` on the same layout; a pipelined model
    serves, but ``SPEC_DRAFT`` / ``SERVE_QUANT`` on it raise, naming
    item 5 (on both stages of the pipe 2 world)."""
    cfg = tmesh.MeshConfig(fsdp=1, model=2, pipe=2).check_ported()
    assert (cfg.model, cfg.pipe) == (2, 2)
    assert tmesh.MeshConfig(fsdp=2, pipe=2).check_ported().pipe == 2
    with pytest.raises(ValueError, match="must be divisible") as got:
        tmesh.MeshConfig(fsdp=1, model=2, pipe=2,
                         num_slices=2).check_ported()
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(jmesh.MeshConfig(fsdp=1, model=2, pipe=2,
                                          num_slices=2), jax.devices()[:4])
    assert str(got.value) == str(want.value) == (
        "data axis (1) must be divisible by num_slices (2)")
    for r in worlds["res"]["pp2"]:
        for key in ("SPEC_DRAFT", "SERVE_QUANT"):
            msg = r["refusals"][key]
            assert msg and key in msg and "item 5" in msg, msg


def test_entry_at_pipe2_trains_resumes_and_exports(worlds, tmp_path):
    """The fine-tune entry on the offline_8b job (its model cut to a tiny
    Llama of 4 layers, fp32) at ``MESH_PIPE`` 2: both stages finish 2
    steps with the same finite loss and eval loss; run again for a second
    epoch, the entry resumes at its last save, trains to step 4 and
    exports again; the sharded export, each layer written by its stage,
    converts to every layer's tensors, all finite."""
    import glob
    from safetensors.torch import load_file
    from gke_ray_train_tpu_torch.ckpt.hf_io import _hf_layer_names
    runs = [r["entry"] for r in worlds["res"]["pp2"]]
    for i, steps in enumerate((2, 4)):
        a, b = runs[0][i], runs[1][i]
        assert a == b and np.isfinite(a["loss"]), (a, b)
        assert a["step"] == steps and len(a["evals"]) >= 2, a
        assert all(np.isfinite(a["evals"])), a
    root = worlds["inputs"]["entry"]["OUTPUT_DIR_BASE"]
    export = glob.glob(os.path.join(root, "*_dcp"))
    assert len(export) == 1, export
    assert os.path.isdir(export[0] + ".first")
    hf = str(tmp_path / "hf")
    convert(export[0], hf, dtype="bfloat16")
    got = {}
    for path in glob.glob(os.path.join(hf, "*.safetensors")):
        got.update(load_file(path))
    cfg = tcfg.tiny(**pp.ENTRY_LLAMA)
    want = {n for i in range(cfg.n_layers)
            for n in _hf_layer_names(cfg, i).values()}
    assert want <= set(got)
    assert all(bool(t.float().isfinite().all()) for t in got.values())


def test_interop_carries_a_stage_of_the_jax_tree():
    """``params_from_numpy`` / ``qparams_from_numpy`` / ``lora_from_numpy``
    with ``stage=(pipe_rank, pipe, virtual)`` carry only that stage's
    repeats of JAX's stacked tree, under their global indices, bitwise
    the whole model's."""
    jparams, jlora_tree = _jax_start("llama", True)
    tc = tcfg.tiny(**LLAMA)
    whole = interop.qparams_from_numpy(_np(jparams), tc, device="cpu")
    lora = interop.lora_from_numpy(_np(jlora_tree), tc, device="cpu")
    want = {**dict(whole.named_parameters()), **dict(whole.named_buffers())}
    for stage, layers in (((0, 2, 1), [0, 1]), ((1, 2, 2), [1, 3])):
        part = interop.qparams_from_numpy(_np(jparams), tc, device="cpu",
                                          stage=stage)
        assert list(part.blocks.layer_ids) == layers
        got = {**dict(part.named_parameters()),
               **dict(part.named_buffers())}
        assert {k for k in got if k.startswith("blocks.")} == {
            k for k in want if k.startswith("blocks.")
            and int(k.split(".")[1]) in layers}
        for k, t in got.items():
            assert torch.equal(t, want[k]), k
        plora = interop.lora_from_numpy(_np(jlora_tree), tc, device="cpu",
                                        stage=stage)
        assert list(plora.layer_ids) == layers
        for i, layer in zip(layers, plora):
            for t, ab in layer.items():
                for key in ("a", "b"):
                    assert torch.equal(ab[key], lora[i][t][key]), (i, t)
