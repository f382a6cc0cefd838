"""Context parallelism: gloo worlds of the port on the CPU
(``tests/_torch_cp.py``) held against the one-process port and against
the JAX package's meshes of the same shape on the conftest's fake
devices, whose flash kernels run in Pallas interpret mode.

Tiny dims (2 layers, d_model 64, 4 heads over 2 KV heads, d_ff 128,
vocab 256, fp32, NF4 groups of 32), 3 steps at a global batch of 8 rows
of 128 tokens as 2 microbatches (a rank of two batch ranks takes its 4
rows as one). Cases: a packed Gemma-tiny (softcaps, a sliding window on
alternate layers) QLoRA under ``a2a``; an unpacked Llama-tiny QLoRA
under ``ring``, whose positions the model builds per context rank; the
same with ``FUSED_OPS=1`` under ``a2a`` (the fused cross-entropy summed
over context); a packed Gemma-tiny full fine-tuning under ``ring`` (HSDP's
gradient sum over context). Worlds: fsdp 1 × context 2 (2 ranks) and
fsdp 2 × context 2 (4 ranks). Loss, grad_norm and tokens (relative) and
the trained tensors (absolute) agree within 1e-6 with the one-process
port and within 1e-5 with JAX's mesh.

Then: ring and a2a attention alone at context 2 and 4 (causal, packed
segments crossing the shard boundary with positions restarting per
document, Gemma's softcap and window), forward and gradients within
1e-5 of JAX's ``ring_attention`` / ``a2a_attention`` and of the
unsharded plain version; a2a falling back to the ring where C does not
divide the heads; ``flash`` / ``xla`` / ``auto`` raising at context 2;
the LoRA dropout masks differing across context ranks (a world-1 step
stays bitwise what it was: ``test_torch_port_tp.py::
test_world1_dropout_step_is_bitwise_the_parents``); the sharded eval
sums and the fused cross-entropy's ``mesh=`` sums over context; a
checkpoint at fsdp 2 × context 2 restored bitwise at world 1 and the
sharded export converted bitwise to the one-process one; the plan's
context checks and ``replan`` keeping context; and the shipped Gemma-2
4k config (``ATTN_IMPL`` ``a2a``) through the entry at world 1.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import a2a_attention as ja2a
from gke_ray_train_tpu.ops import dispatch as jdispatch
from gke_ray_train_tpu.ops import fused_ce as jfce
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.ops import ring_attention as jring
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager, save_hf_checkpoint
from gke_ray_train_tpu_torch.ckpt.convert import convert
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.ops import flash_attention as tflash
from gke_ray_train_tpu_torch.parallel import MeshConfig
from gke_ray_train_tpu_torch.plan import (
    PlanError, context_findings, replan)
from tests import _torch_cp as cp
from tests import _torch_multirank as mr
from tests import _torch_tp as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, S, B, ACCUM, STEPS = 256, 128, 8, 2, 3
LR, TOTAL, GROUP = 1e-3, 10, 32
PORT_RTOL, PORT_ATOL = 1e-6, 1e-6       # ranks against one process
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5         # ranks against JAX's mesh
ATTN_TOL = 1e-5                         # attention alone, absolute
GEMMA = dict(logit_softcap=30.0, attn_softcap=50.0, tie_embeddings=True,
             post_block_norm=True, norm_scale_plus_one=True,
             embed_scale=True, activation="gelu_tanh",
             block_pattern=("sliding", "global"), sliding_window=48)
# name: (family, NF4 QLoRA, FUSED_OPS, packed rows, ATTN_IMPL)
CASES = {"gemma_packed": ("gemma", True, False, True, "a2a"),
         "llama_unpacked": ("llama", True, False, False, "ring"),
         "llama_fused": ("llama", True, True, False, "a2a"),
         "gemma_full": ("gemma", False, False, True, "ring")}
MESHES = {"cp2": dict(data=1, fsdp=1, model=1, context=2),
          "cp4": dict(data=1, fsdp=2, model=1, context=2)}
# the entry's smoke config at fsdp 1 x context 2 (256-token shards)
ENTRY = {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
         "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": 512,
         "NUM_TRAIN_SAMPLES": 8, "NUM_EVAL_SAMPLES": 4,
         "PER_DEVICE_TRAIN_BATCH_SIZE": 1, "GRADIENT_ACCUMULATION_STEPS": 2,
         "NUM_TRAIN_EPOCHS": 1, "LEARNING_RATE": 1e-3, "LORA_DROPOUT": 0.0,
         "MESH_DATA": 1, "MESH_FSDP": 1, "MESH_CONTEXT": 2,
         "ATTN_IMPL": "ring", "SAVE_STRATEGY": "steps", "SAVE_STEPS_SFT": 2,
         "EVALUATION_STRATEGY_SFT": "steps", "EVAL_STEPS_SFT": 2,
         "LOGGING_STEPS": 1, "INFERENCE": False}
# the (world, case) runs JAX's mesh repeats
JAX_RUNS = [("cp2", c) for c in CASES] + [("cp4", "llama_fused"),
                                          ("cp4", "gemma_full")]


def _cfgs(family, impl):
    kw = dict(vocab_size=V, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
              n_layers=2, max_seq_len=S, attn_impl=impl)
    if family == "gemma":
        kw.update(GEMMA)
    return jcfg.tiny(**kw), tcfg.tiny(**kw)


def _packed_ids(r, n, length):
    """Segment ids of ``n`` rows of documents of 20-70 tokens (a padded
    tail of segment 0) and positions restarting at each document."""
    seg = np.zeros((n, length), np.int32)
    pos = np.zeros((n, length), np.int32)
    for i in range(n):
        t, doc = 0, 1
        while t < length - 10:
            ln = min(int(r.integers(20, 71)), length - 10 - t)
            seg[i, t:t + ln] = doc
            pos[i, t:t + ln] = np.arange(ln)
            t, doc = t + ln, doc + 1
    return seg, pos


def _batch(seed, packed, n=B):
    r = np.random.default_rng(seed)
    b = {"inputs": r.integers(0, V, (n, S)).astype(np.int32),
         "targets": r.integers(0, V, (n, S)).astype(np.int32)}
    if packed:
        seg, pos = _packed_ids(r, n, S)
        b.update(segment_ids=seg, positions=pos,
                 weights=(seg != 0).astype(np.float32))
    else:
        w = np.ones((n, S), np.float32)
        for i, k in enumerate(r.integers(S // 2, S + 1, n)):
            w[i, k:] = 0.0
        b["weights"] = w
    return b


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(case, batches, mesh=None):
    """JAX's start (nonzero adapters for QLoRA), and its streams and
    final state after the batches on ``mesh``."""
    family, quant, fused, _, impl = CASES[case]
    jc, _ = _cfgs(family, impl)
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
    family, quant, fused, _, impl = CASES[case]
    _, tc = _cfgs(family, impl)
    params = interop.params_from_numpy(_np(jinit.params), tc, device="cpu")
    lora = (interop.lora_from_numpy(_np(jinit.lora), tc, device="cpu")
            if quant else None)
    return {"cfg": tc.to_dict(), "quant": quant, "group": GROUP,
            "params": params.state_dict(), "lora": lora, "lora_r": 8,
            "lora_alpha": 16, "lr": LR, "total": TOTAL, "accum": ACCUM,
            "fused": fused, "batches": batches}


# ---------------------------------------------------------------------------
# attention alone
# ---------------------------------------------------------------------------

def _attn_cases(seed, H, K, fallback=False):
    """{name: q, k, v, do (fp32, [2, 128, ., 16]), mask inputs, impls}."""
    r = np.random.default_rng(seed)
    Bn, dh = 2, 16

    def rnd(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    base = lambda: dict(q=rnd(Bn, S, H, dh), k=rnd(Bn, S, K, dh),  # noqa: E731
                        v=rnd(Bn, S, K, dh), do=rnd(Bn, S, H, dh),
                        impls=("ring", "a2a"))
    if fallback:
        return {"fallback": base()}
    seg, pos = _packed_ids(r, Bn, S)
    return {"causal": base(),
            "packed": dict(base(), segment_ids=torch.from_numpy(seg),
                           positions=torch.from_numpy(pos)),
            "softcap_window": dict(base(), window=24, softcap=5.0)}


def _jax_attention(att, C, impl):
    """{name: (out, dq, dk, dv)} of JAX's context-parallel attention on
    a context-C mesh of the fake devices (``impl`` "a2a" through its
    dispatch, which falls back to the ring)."""
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, fsdp=1, model=1,
                                             context=C), jax.devices()[:C])
    out = {}
    for name, a in att.items():
        kw = dict(causal=True, sliding_window=a.get("window"),
                  logit_softcap=a.get("softcap"))
        if "segment_ids" in a:
            seg = jnp.asarray(a["segment_ids"].numpy())
            pos = jnp.asarray(a["positions"].numpy())
            kw.update(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
                      kv_segment_ids=seg)
        if impl == "ring":
            fn = lambda q, k, v: jring.ring_attention(  # noqa: E731
                q, k, v, mesh=mesh, **kw)
        else:
            fn = lambda q, k, v: jdispatch.attention_dispatch(  # noqa: E731
                "a2a", q, k, v, mesh=mesh, **kw)
        q, k, v, do = (jnp.asarray(a[x].numpy()) for x in ("q", "k", "v",
                                                           "do"))
        o, vjp = jax.vjp(jax.jit(fn), q, k, v)
        out[name] = tuple(np.asarray(t) for t in (o,) + vjp(do))
    return out


def _plain_attention(a):
    """The unsharded plain version: (out, dq, dk, dv)."""
    q, k, v = (a[x].clone().requires_grad_(True) for x in "qkv")
    out = tflash.flash_attention(
        q, k, v, q_positions=a.get("positions"),
        kv_positions=a.get("positions"), q_segment_ids=a.get("segment_ids"),
        kv_segment_ids=a.get("segment_ids"), sliding_window=a.get("window"),
        logit_softcap=a.get("softcap"))
    torch.sum(out * a["do"]).backward()
    return tuple(t.detach().numpy() for t in (out, q.grad, k.grad, v.grad))


def _whole(ranks, key):
    """The ranks' token shards of ``key`` side by side, per tensor."""
    return tuple(np.concatenate([r[key][i].numpy() for r in ranks], axis=1)
                 for i in range(4))


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cp"))
    inputs = {"cases": tuple(CASES), "eval_case": "llama_unpacked",
              "save_case": "gemma_full", "eval_rows": _batch(7, False, n=5)}
    port, jinits = {}, {}
    for case, (family, _, _, packed, _) in CASES.items():
        batches = [_batch(100 + i, packed) for i in range(STEPS)]
        jinit, _, _ = _jax_run(case, [])
        jinits[case] = (jinit, batches)
        inputs[case] = _port_inputs(case, jinit, batches)
        # one process: a2a without a context axis is the flash path
        one = dict(inputs[case], cfg=dict(inputs[case]["cfg"],
                                          attn_impl="a2a"))
        port[case] = tp.train(one, None)
    inputs["attn2"] = _attn_cases(31, H=4, K=2)
    inputs["attn4"] = {**_attn_cases(32, H=8, K=4),
                       **_attn_cases(33, H=8, K=2, fallback=True)}
    r = np.random.default_rng(21)
    inputs["ce"] = {
        "x": torch.from_numpy(r.standard_normal((2, S, 64)).astype(
            np.float32)),
        "head": torch.from_numpy((r.standard_normal((64, V)) * 0.3).astype(
            np.float32)),
        "targets": torch.from_numpy(r.integers(0, V, (2, S)).astype(
            np.int32)),
        "weights": torch.from_numpy(r.uniform(0.5, 1.5, (2, S)).astype(
            np.float32))}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    entry = dict(ENTRY, OUTPUT_DIR_BASE=os.path.join(out, "entry_cp2"))
    with open(os.path.join(out, "entry.json"), "w") as f:
        json.dump(entry, f)
    procs = {"cp2": cp.start("cp2", out, n=2), "cp4": cp.start("cp4", out,
                                                                n=4)}
    # JAX's meshes while the ranks run
    jax_mesh = {}
    for shape, case in JAX_RUNS:
        mc = MESHES[shape]
        mesh = jmesh.build_mesh(jmesh.MeshConfig(**mc), jax.devices()[
            :int(np.prod(list(mc.values())))])
        _, jstate, streams = _jax_run(case, jinits[case][1], mesh=mesh)
        jax_mesh[(shape, case)] = {"state": jstate, "streams": streams}
    jax_attn = {}
    for C, key in ((2, "attn2"), (4, "attn4")):
        for impl in ("ring", "a2a"):
            jax_attn[(C, impl)] = _jax_attention(inputs[key], C, impl)
    ce = {k: jnp.asarray(v.numpy()) for k, v in inputs["ce"].items()}
    ce_mesh = jmesh.build_mesh(jmesh.MeshConfig(**MESHES["cp2"]),
                               jax.devices()[:2])
    (jnll, jw), jdx = jax.value_and_grad(
        lambda x: jfce.fused_cross_entropy(x, ce["head"], ce["targets"],
                                           ce["weights"], mesh=ce_mesh),
        has_aux=True)(ce["x"])
    jax_ce = {"nll": float(jnll), "w": float(jw), "dx": np.asarray(jdx)}
    # the one-process export of the QLoRA start
    st, _, tc, lcfg = tp.build_state(inputs["llama_unpacked"])
    save_hf_checkpoint(st.params, tc, os.path.join(out, "hf_w1"),
                       lora=st.lora, lora_scale=lcfg.scale)
    # the entry in one process: no mesh, the model's a2a the flash path;
    # offline, so the entry never asks the hub
    offline = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        metrics, evals = cp.entry_run(dict(
            entry, ATTN_IMPL="a2a",
            OUTPUT_DIR_BASE=os.path.join(out, "entry_w1")))
        one = dict(metrics, evals=evals)
    finally:
        if offline is None:
            del os.environ["HF_HUB_OFFLINE"]
        else:
            os.environ["HF_HUB_OFFLINE"] = offline
    mr.wait(procs["cp2"], timeout=400)
    mr.wait(procs["cp4"], timeout=400)
    res = {name: [torch.load(os.path.join(out, f"{name}_{r}.pt"),
                             weights_only=False) for r in range(n)]
           for name, n in (("cp2", 2), ("cp4", 4))}
    return dict(out=out, port=port, jax_mesh=jax_mesh, jax_attn=jax_attn,
                jax_ce=jax_ce, res=res, inputs=inputs, entry_w1=one)


def _jax_trained(case, jstate):
    family, quant, _, _, impl = CASES[case]
    _, tc = _cfgs(family, impl)
    if quant:
        lora = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        return {f"blocks.{i}.{t}.{ab}": layer[t][ab]
                for i, layer in enumerate(lora) for t in layer
                for ab in ("a", "b")}
    params = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
    return {n: p.detach() for n, p in params.named_parameters()}


def _hold(got, port, jax_side, case):
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


@pytest.mark.parametrize("shape, case", [(s, c) for s in MESHES
                                         for c in CASES])
def test_step_matches_one_process_and_jax_mesh(worlds, shape, case):
    """fsdp 1 × context 2 and fsdp 2 × context 2: every rank's streams
    and trained tensors after 3 steps against the one-process port and
    JAX's mesh of the same shape; the parameters replicated over context
    (HSDP: a replicate dim, then fsdp)."""
    for res in worlds["res"][shape]:
        got = res[case]
        pls = set(got["placements"].values())
        assert pls == {("R", "S(0)"), ("R", "S(1)")} or pls == {
            ("R", "S(0)")}, pls
        _hold(got, worlds["port"][case],
              worlds["jax_mesh"].get((shape, case)), case)


def test_layout_over_context(worlds):
    """The context ranks of one batch rank are one input shard: at fsdp 1
    × context 2 both ranks feed every row, at fsdp 2 × context 2 ranks 0
    and 1 (context ranks 0 and 1) feed the first half of the rows."""
    lay = [r["layout"] for r in worlds["res"]["cp2"]]
    assert [x["context_rank"] for x in lay] == [0, 1]
    assert [tuple(x["input_shard_layout"]) for x in lay] == [(1, 0)] * 2
    lay = [r["layout"] for r in worlds["res"]["cp4"]]
    assert [x["batch_rank"] for x in lay] == [0, 0, 1, 1]
    assert [x["context_rank"] for x in lay] == [0, 1, 0, 1]
    assert [tuple(x["input_shard_layout"]) for x in lay] == \
        [(2, 0), (2, 0), (2, 1), (2, 1)]


@pytest.mark.parametrize("C, impl", [(2, "ring"), (2, "a2a"), (4, "ring"),
                                     (4, "a2a")])
def test_attention_alone_matches_jax_and_plain(worlds, C, impl):
    """Ring and a2a on each rank's token shard: out, dq, dk and dv side
    by side against JAX's context-parallel attention on a context-C mesh
    and against the unsharded plain version."""
    key = "attn2" if C == 2 else "attn4"
    ranks = [r["attn"] for r in worlds["res"]["cp2" if C == 2 else "cp4"]]
    for name, a in worlds["inputs"][key].items():
        got = _whole(ranks, (impl, name))
        plain = _plain_attention(a)
        want = worlds["jax_attn"][(C, impl)][name]
        for what, g, p, j in zip(("out", "dq", "dk", "dv"), got, plain,
                                 want):
            np.testing.assert_allclose(g, j, rtol=0, atol=ATTN_TOL,
                                       err_msg=f"{name} {what} vs JAX")
            np.testing.assert_allclose(g, p, rtol=0, atol=ATTN_TOL,
                                       err_msg=f"{name} {what} vs plain")


def test_a2a_falls_back_to_ring_where_context_does_not_divide_heads(
        worlds):
    """At context 4 with 2 KV heads the a2a dispatch runs the ring:
    bitwise the ring's result on every rank."""
    for r in worlds["res"]["cp4"]:
        for got, ring in zip(r["attn"][("a2a", "fallback")],
                             r["attn"][("ring", "fallback")]):
            assert torch.equal(got, ring)


def test_flash_xla_auto_raise_at_context2(worlds):
    """``flash``, ``xla`` and ``auto`` on a context-sharded mesh raise,
    naming ring and a2a, on both ranks."""
    for r in worlds["res"]["cp2"]:
        for impl, msg in r["raises"].items():
            assert msg is not None and "'ring'" in msg and "'a2a'" in msg, \
                (impl, msg)


def test_dropout_masks_differ_across_context_ranks(worlds):
    """LORA_DROPOUT 0.1: every projection's first mask differs between
    the context ranks (one shape each), at context 2 and across all four
    ranks of fsdp 2 × context 2."""
    for shape in ("cp2", "cp4"):
        masks = [r["drop"]["masks"] for r in worlds["res"][shape]]
        assert set(masks[0]) == {"wq", "wk", "wv", "wo", "w_gate", "w_up",
                                 "w_down"}
        for name in masks[0]:
            for i in range(len(masks)):
                for j in range(i + 1, len(masks)):
                    assert masks[i][name].shape == masks[j][name].shape
                    assert not torch.equal(masks[i][name],
                                           masks[j][name]), (shape, name)
        assert all(np.isfinite(r["drop"]["loss"])
                   for r in worlds["res"][shape])


def test_eval_sums_and_fused_ce_sum_over_context(worlds):
    """The sharded eval sums of the trained QLoRA adapters (each context
    rank its tokens of every row) equal the one-process walk; the fused
    cross-entropy's ``mesh=`` sums over context equal JAX's ``mesh=``
    call, and its dx shards JAX's dx."""
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_eval_step, sharded_eval_sums)
    case = worlds["inputs"]["llama_unpacked"]
    one = dict(case, cfg=dict(case["cfg"], attn_impl="a2a"))
    state = tp.build_state(one)[0]
    trained = worlds["res"]["cp2"][0]["llama_unpacked"]["trained"]
    with torch.no_grad():
        for i, layer in enumerate(state.lora):
            for t in layer:
                for ab in ("a", "b"):
                    layer[t][ab].copy_(trained[f"blocks.{i}.{t}.{ab}"])
    ev = make_eval_step(state.params.cfg, lora_cfg=LoraConfig(r=8, alpha=16),
                        device="cpu")
    want = sharded_eval_sums(state, ev, worlds["inputs"]["eval_rows"],
                             host_batch=3)
    for r in worlds["res"]["cp2"]:
        np.testing.assert_allclose(r["eval_sums"], want, rtol=1e-6)
    j = worlds["jax_ce"]
    ranks = [r["ce"] for r in worlds["res"]["cp2"]]
    for r in ranks:
        np.testing.assert_allclose(float(r["nll"]), j["nll"], rtol=1e-6)
        assert float(r["w"]) == pytest.approx(j["w"], rel=1e-6)
    dx = np.concatenate([r["dx"].numpy() for r in ranks], axis=1)
    np.testing.assert_allclose(dx, j["dx"], rtol=0, atol=1e-6)


def test_save_at_fsdp2_context2_restores_bitwise_at_world1(worlds):
    """The 4 ranks' save of the trained full fine-tuning state (HSDP:
    replicated over context, sharded over fsdp), read into an unsharded
    one-process template, equals the ranks' state bitwise."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    case = worlds["inputs"]["gemma_full"]
    template = tp.build_state(dict(case, cfg=dict(case["cfg"],
                                                  attn_impl="a2a")))[0]
    mgr = CheckpointManager(os.path.join(worlds["out"], "ckpt_cp4"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    assert mgr.last_restore_resharded == (4, 1)
    mgr.close()
    saved = worlds["res"]["cp4"][0]["saved"]
    got = flat_state(template)
    assert set(got) == set(saved)
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert v.dtype == got[k].dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_sharded_export_converts_to_the_one_process_export(worlds,
                                                            tmp_path):
    """The 4 ranks' export of the merged QLoRA start at fsdp 2 × context
    2, converted, equals the one-process HF export file for file."""
    out = worlds["out"]
    hf_cp4 = str(tmp_path / "hf_cp4")
    convert(os.path.join(out, "export_cp4"), hf_cp4, dtype="bfloat16")
    hf_w1 = os.path.join(out, "hf_w1")
    names = sorted(os.listdir(hf_w1))
    assert names == sorted(os.listdir(hf_cp4))
    for n in names:
        assert filecmp.cmp(os.path.join(hf_w1, n), os.path.join(hf_cp4, n),
                           shallow=False), n


def test_entry_worker_at_fsdp1_context2(worlds):
    """The entry's worker on two ranks at MESH_CONTEXT 2 (ring, the
    train and eval batches context-sharded, saves, the sharded export):
    both ranks end on the one-process entry's step, loss and grad norm,
    their eval losses (context-sharded eval batches, summed over
    context) are its, and the export of the context-sharded run is
    written."""
    import glob
    want = worlds["entry_w1"]
    assert len(want["evals"]) >= 2
    for r in worlds["res"]["cp2"]:
        got = r["entry"]
        for key in ("loss", "grad_norm", "evals"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
        assert got["step"] == want["step"] > 1
    assert glob.glob(os.path.join(worlds["out"], "entry_cp2", "*_dcp"))


# ---------------------------------------------------------------------------
# one process: the plan, replan, the entry at world 1
# ---------------------------------------------------------------------------

def test_plan_context_checks(monkeypatch):
    """JAX's finding (the axis divides the length) and the port's own
    (128-token shards, ring or a2a); JAX's ``context_sharded`` is whether
    the mesh the entries resolve from ``MESH_CONTEXT`` has a context
    axis above 1."""
    from gke_ray_train_tpu_torch.rayint.elastic import POOL_ENV, maybe_replan
    monkeypatch.delenv(POOL_ENV, raising=False)
    ring = tcfg.tiny(attn_impl="ring")
    assert context_findings(ring, context=1, max_seq_len=100) == []
    assert context_findings(ring, context=2, max_seq_len=4096) == []
    jp = jplan.ExecutionPlan(context=3, max_seq_len=4096, fsdp=1)
    want = [m for m in jp.model_findings(jcfg.tiny(), n_chips=3)
            if "context" in m]
    got = context_findings(ring, context=3, max_seq_len=4096)
    assert got[:1] == want and len(got) == 1
    assert "multiple of 128" in context_findings(
        ring, context=2, max_seq_len=128)[0]
    for impl in ("auto", "flash", "xla"):
        (msg,) = context_findings(tcfg.tiny(attn_impl=impl), context=2,
                                  max_seq_len=4096)
        assert "'ring' or 'a2a'" in msg
    for ctx in (1, 2):
        config = {"MESH_FSDP": -1, "MESH_CONTEXT": ctx}
        ours, _ = maybe_replan(MeshConfig.from_dict(config), 1, world=4,
                               config=config)
        theirs = jplan.ExecutionPlan.from_config(config)
        assert (ours.check_ported().context > 1) == theirs.context_sharded


def test_replan_keeps_context():
    """An elastic pool change reflows data and fsdp only: context 2 stays
    2, as in the JAX package's ``replan``; a pool context cannot tile
    raises."""
    declared = MeshConfig(fsdp=4, context=2)
    got, pdb = replan(declared, 4, chips=8, per_device_batch=1)
    assert (got.context, got.fsdp * got.data) == (2, 2)
    assert pdb == 2
    jgot = jplan.replan(jplan.ExecutionPlan(
        fsdp=4, context=2, topology="v5e-8", per_device_batch=1), 4)
    assert (jgot.context, jgot.fsdp * jgot.data) == (2, 2)
    with pytest.raises(PlanError, match="structural"):
        replan(declared, 3, chips=8, per_device_batch=1)


def test_gemma_4k_config_runs_with_its_a2a_through_the_entry(
        tmp_path, monkeypatch):
    """``ray-jobs/fine_tune_config_gemma2_4k.json``, unedited apart from
    tiny dims (``SMOKE_TEST``, 256 tokens, 16 rows, no saves), through
    the port's entry at world 1: it audits clean, keeps its
    ``ATTN_IMPL`` ``a2a``, runs every attention through the flash path
    and trains to a finite loss."""
    from gke_ray_train_tpu_torch import config as tconfig
    from gke_ray_train_tpu_torch import fine_tune
    with open(os.path.join(REPO, "ray-jobs",
                           "fine_tune_config_gemma2_4k.json")) as f:
        config = json.load(f)
    assert config["ATTN_IMPL"] == "a2a" and config["MESH_CONTEXT"] == 2
    assert tconfig.audit_config(dict(config)) == []
    config.update(SMOKE_TEST=True, MAX_SEQ_LENGTH=256, NUM_TRAIN_SAMPLES=16,
                  NUM_EVAL_SAMPLES=4, SAVE_STRATEGY="no",
                  OUTPUT_DIR_BASE=str(tmp_path / "out"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    seen, calls = [], {"flash": 0}
    step = fine_tune.make_train_step
    monkeypatch.setattr(fine_tune, "make_train_step", lambda cfg, *a, **k: (
        seen.append(cfg.attn_impl), step(cfg, *a, **k))[1])
    flash = tflash.flash_attention

    def counted(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)
    monkeypatch.setattr(tflash, "flash_attention", counted)
    metrics = fine_tune.train_loop_per_worker(config, device="cpu")
    assert seen == ["a2a"]
    assert calls["flash"] > 0
    assert np.isfinite(metrics["loss"])
