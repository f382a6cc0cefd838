"""Mixture-of-Experts in the port (``gke_ray_train_tpu_torch/ops/moe.py``
and the Mixtral path through the model, the train step and decode)
against the JAX package, at tiny dims on the CPU.

The same numpy inputs go through both packages. Tolerances, float32:
``y``, its gradients and logits within 1e-5 relative to the largest
reference value (fp32 products and sums in other orders); the router aux
within 1e-6 absolute; 5-step loss / grad_norm streams and the trained
tensors within 1e-4 relative (the repo's train-parity bound). Routing
decisions (top-k, capacity drops) are integers and must agree exactly:
the inputs are drawn so that no two router probabilities tie.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import kvcache as jkv
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import moe as jmoe
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import kvcache as tkv
from gke_ray_train_tpu_torch.models import transformer as ttr
from gke_ray_train_tpu_torch.models.qinit import init_quantized_params
from gke_ray_train_tpu_torch.ops import moe as tmoe
from gke_ray_train_tpu_torch.ops.quant import QTensor, quantize_tensor
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.serve import (
    BatchEngine, Request, form_prompt_buffer)
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_optimizer, make_train_state, make_train_step,
    warmup_cosine_schedule)
from tests import _torch_ep as ep
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


Y_RTOL = 1e-5
AUX_ATOL = 1e-6
TRAIN_RTOL = 1e-4
# capacity factors: 1.0 binds at these shapes (drops happen), 4.0 = E / K
# is drop-free
CAPACITY = {"binding": 1.0, "ample": 4.0}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _moe_cfgs(cf, **kw):
    base = dict(name="moe-tiny", d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=128, max_seq_len=64,
                n_experts=4, expert_top_k=2, capacity_factor=cf,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return jcfg.ModelConfig(**base), tcfg.ModelConfig(**base)


def _moe_inputs(seed, B=2, S=40, D=32, F=64, E=4):
    r = np.random.default_rng(seed)
    f = np.float32
    return dict(x=r.standard_normal((B, S, D)).astype(f),
                router=(r.standard_normal((D, E)) * 0.5).astype(f),
                w_gate=(r.standard_normal((E, D, F)) * 0.1).astype(f),
                w_up=(r.standard_normal((E, D, F)) * 0.1).astype(f),
                w_down=(r.standard_normal((E, F, D)) * 0.1).astype(f),
                cot=r.standard_normal((B, S, D)).astype(f),
                weights=(r.random((B, S)) > 0.3).astype(f))


def _banks(inp, bank):
    """The three banks for each package: as they are, or quantized by
    each package from the same values."""
    names = ("w_gate", "w_up", "w_down")
    if bank == "fp":
        return ([jnp.asarray(inp[n]) for n in names],
                [torch.from_numpy(inp[n]) for n in names])
    return ([jquant.quantize_tensor(jnp.asarray(inp[n]), bank)
             for n in names],
            [quantize_tensor(torch.from_numpy(inp[n]), bank) for n in names])


def _jax_moe(inp, jbanks, jc, weights):
    def loss(x, router):
        y, aux = jmoe.moe_mlp(x, router, *jbanks, jc, jnp.float32,
                              weights=weights)
        return jnp.sum(y * inp["cot"]) + 3.0 * aux, (y, aux)
    (_, (y, aux)), (gx, gr) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(inp["x"]),
                                            jnp.asarray(inp["router"]))
    return [np.asarray(a) for a in (y, aux, gx, gr)]


def _port_moe(fn, inp, tbanks, tc, weights):
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    router = torch.from_numpy(inp["router"]).requires_grad_(True)
    y, aux = fn(x, router, *tbanks, tc, torch.float32, weights=weights)
    (torch.sum(y * torch.from_numpy(inp["cot"])) + 3.0 * aux).backward()
    return [a.detach().numpy() for a in (y, aux, x.grad, router.grad)]


@pytest.mark.parametrize("bank", ["fp", "int8", "nf4"])
@pytest.mark.parametrize("weights", ["none", "random", "zeros"])
@pytest.mark.parametrize("capacity", sorted(CAPACITY))
def test_moe_mlp_matches_jax(capacity, weights, bank):
    """y, aux and the gradients with respect to x and the router, with
    binding capacity (drops happen) and ample capacity (none), with and
    without loss weights (all-zero weights: aux 0), on full-precision,
    int8 and NF4 expert banks."""
    jc, tc = _moe_cfgs(CAPACITY[capacity])
    inp = _moe_inputs(1)
    w = {"none": None, "random": inp["weights"],
         "zeros": np.zeros_like(inp["weights"])}[weights]
    jbanks, tbanks = _banks(inp, bank)
    want = _jax_moe(inp, jbanks, jc, None if w is None else jnp.asarray(w))
    got = _port_moe(tmoe.moe_mlp, inp, tbanks, tc,
                    None if w is None else torch.from_numpy(w))
    for name, g, ref in zip(("y", "aux", "dx", "drouter"), got, want):
        if name == "aux":
            assert abs(float(g) - float(ref)) <= AUX_ATOL
        else:
            assert _rel(g, ref) <= Y_RTOL, name
    r = tmoe.route(torch.from_numpy(inp["x"]), torch.from_numpy(
        inp["router"]), tc)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (capacity == "binding"), dropped
    if weights == "zeros":
        assert float(got[1]) == 0.0


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
def test_dispatch_route_equals_the_onehot_form(capacity):
    """The index-op route against the port's own plain one-hot version
    (the JAX einsum form): y and both gradients, float32; bf16 y within
    one bf16 ulp (2^-8) of the largest value."""
    _, tc = _moe_cfgs(CAPACITY[capacity])
    inp = _moe_inputs(2)
    _, tbanks = _banks(inp, "fp")
    w = torch.from_numpy(inp["weights"])
    got = _port_moe(tmoe.moe_mlp, inp, tbanks, tc, w)
    want = _port_moe(tmoe.moe_mlp_onehot, inp, tbanks, tc, w)
    for g, ref in zip(got, want):
        assert _rel(g, ref) <= 1e-6
    xb = torch.from_numpy(inp["x"]).bfloat16()
    bb = [b.bfloat16() for b in tbanks]
    rw = torch.from_numpy(inp["router"])
    with torch.no_grad():
        yb, _ = tmoe.moe_mlp(xb, rw, *bb, tc, torch.bfloat16)
        ob, _ = tmoe.moe_mlp_onehot(xb, rw, *bb, tc, torch.bfloat16)
    assert yb.dtype == torch.bfloat16
    assert _rel(yb.float().numpy(), ob.float().numpy()) <= 2.0 ** -8


def test_expert_capacity_matches_jax():
    for cf in (0.5, 1.0, 1.25, 2.0, 4.0):
        for S in (1, 7, 40, 128, 1024):
            jc, tc = _moe_cfgs(cf)
            assert tmoe.expert_capacity(tc, S) == jmoe.expert_capacity(jc, S)
    # Mixtral's microbatch: 320 slots an expert and row
    assert tmoe.expert_capacity(tcfg.mixtral_8x7b(), 1024) == 320


# -- a tiny Mixtral-pattern model -------------------------------------------

V = 97


def _model_cfgs(**kw):
    base = dict(vocab_size=V, n_layers=2, max_seq_len=256, n_experts=4,
                expert_top_k=2, name="mixtral-tiny", attn_impl="xla")
    base.update(kw)
    return jcfg.tiny(**base), tcfg.tiny(**base)


def _carry(jc, tc, seed=0):
    params = jtr.init_params(jc, jax.random.key(seed))
    return params, interop.params_from_numpy(
        jax.tree.map(np.asarray, params), tc, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_and_router_aux_match_jax(remat):
    jc, tc = _model_cfgs(remat=remat)
    jp, tp = _carry(jc, tc, seed=1)
    r = np.random.default_rng(2)
    toks = r.integers(0, V, (2, 48)).astype(np.int32)
    w = (r.random((2, 48)) > 0.3).astype(np.float32)
    jl, ja = jtr.forward(jp, jnp.asarray(toks), jc, with_aux=True,
                         token_weights=jnp.asarray(w))
    with torch.enable_grad():   # remat's checkpoint regions are live
        tl, ta = ttr.forward(tp, torch.from_numpy(toks), tc, with_aux=True,
                             token_weights=torch.from_numpy(w))
    assert _rel(tl.detach().numpy(), np.asarray(jl)) <= Y_RTOL
    assert abs(float(ta["router_aux"]) - float(ja["router_aux"])) \
        <= AUX_ATOL
    assert 0.5 < float(ta["router_aux"]) < 4.0
    # a dense model's aux is 0, as JAX's
    _, dense = ttr.forward(
        ttr.init_params(tcfg.tiny(vocab_size=V), device="cpu"),
        torch.from_numpy(toks), tcfg.tiny(vocab_size=V), with_aux=True)
    assert float(dense["router_aux"]) == 0.0


S, B, ACCUM = 128, 4, 2
LR, TOTAL = 1e-3, 10


def _batch(seed):
    r = np.random.default_rng(seed)
    w = np.ones((B, S), np.float32)
    for i, n in enumerate(r.integers(S // 2, S + 1, B)):
        w[i, n:] = 0.0
    return {"inputs": r.integers(0, V, (B, S)).astype(np.int32),
            "targets": r.integers(0, V, (B, S)).astype(np.int32),
            "weights": w}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _states(jc, tc, mode):
    """JAX's state and step, and the port's carried over from it (LoRA
    adapters nonzero from the start so every path carries signal)."""
    params = jtr.init_params(jc, jax.random.key(0))
    jl = tl = None
    if mode == "qlora":
        params = jquant.quantize_params(params, kind="nf4", group=32)
        jl = jlora.LoraConfig(r=4, alpha=8)
        tl = LoraConfig(r=4, alpha=8)
    sched = joptim.warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    opt = joptim.make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    jstate = jstep.make_train_state(jc, opt, jax.random.key(1), lora_cfg=jl,
                                    params=params)
    if jl is not None:
        r = np.random.default_rng(3)
        lora = jax.tree.map(lambda x: jnp.asarray(
            r.standard_normal(x.shape).astype(np.float32) * 0.05),
            jstate.lora)
        jstate = jstate._replace(lora=lora, opt_state=jax.jit(opt.init)(lora))
    jfn = jstep.make_train_step(jc, opt, lora_cfg=jl, grad_accum=ACCUM,
                                schedule=sched, donate=False)
    tparams = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
    tsched = warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    spec = make_optimizer(tsched, weight_decay=0.01, clip_norm=0.5)
    tstate = make_train_state(tc, spec, lora_cfg=tl, params=tparams,
                              device="cpu")
    if tl is not None:
        src = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        with torch.no_grad():
            for ours, theirs in zip(tstate.lora, src):
                assert sorted(ours) == sorted(theirs) == ["wk", "wo", "wq",
                                                          "wv"]
                for t in ours:
                    for ab in ("a", "b"):
                        ours[t][ab].copy_(theirs[t][ab])
    tfn = make_train_step(tc, spec, lora_cfg=tl, grad_accum=ACCUM,
                          schedule=tsched, device="cpu")
    return jstate, jfn, tstate, tfn


@pytest.mark.parametrize("mode,remat", [("qlora", True), ("full", False)])
def test_five_steps_match_jax(mode, remat):
    """5 steps of QLoRA (NF4 base, expert banks quantized, adapters on
    attention only, remat) and of full fine-tuning (router and banks
    trained) on the tiny Mixtral pattern: the loss (NLL plus
    router_aux_coef x aux), grad_norm and lr streams, then the trained
    tensors."""
    jc, tc = _model_cfgs(remat=remat)
    jstate, jfn, tstate, tfn = _states(jc, tc, mode)
    router0 = tstate.params.blocks[0].router.detach().clone()
    jm, tm = [], []
    for i in range(5):
        batch = _batch(100 + i)
        jstate, m = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tfn(tstate, batch)
        tm.append({k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm", "learning_rate", "tokens"):
        np.testing.assert_allclose([m[k] for m in tm], [m[k] for m in jm],
                                   rtol=TRAIN_RTOL, atol=1e-9, err_msg=k)
    if mode == "qlora":
        want = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        for ours, theirs in zip(tstate.lora, want):
            for t in ours:
                for ab in ("a", "b"):
                    assert _rel(ours[t][ab].detach().numpy(),
                                theirs[t][ab].numpy()) <= TRAIN_RTOL
        blk = tstate.params.blocks[0]
        assert isinstance(blk.w_gate, QTensor) and blk.w_gate.shape == (
            4, 64, 128)
        assert torch.equal(blk.router, router0)     # frozen
        return
    want = dict(interop.params_from_numpy(
        _np(jstate.params), tc, device="cpu").named_parameters())
    for name, p in tstate.params.named_parameters():
        assert _rel(p.detach().numpy(), want[name].detach().numpy()) \
            <= TRAIN_RTOL, name
    assert not torch.equal(tstate.params.blocks[0].router, router0)


def test_eval_step_is_nll_only():
    """The eval step leaves the router aux out, as JAX's does."""
    from gke_ray_train_tpu_torch.train import make_eval_step
    jc, tc = _model_cfgs()
    jstate, _, tstate, _ = _states(jc, tc, "full")
    batch = _batch(7)
    jn, jw = jstep.make_eval_step(jc)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tn, tw = make_eval_step(tc, device="cpu")(tstate, batch)
    np.testing.assert_allclose(float(tn), float(jn), rtol=Y_RTOL)
    assert float(tw) == float(jw)


# -- decode ---------------------------------------------------------------

EOS = 5


def test_cached_decode_and_engine_match_jax():
    """At capacity_factor 4.0 (drop-free; JAX tests/test_kvcache.py's
    rule) the KV-cache greedy decode equals JAX's, token for token, and
    every BatchEngine completion equals JAX's sequential batch-1 greedy
    decode, through two buckets and a mid-batch refill."""
    jc, tc = _model_cfgs(capacity_factor=4.0)
    jp, tp = _carry(jc, tc, seed=4)
    buf = np.zeros((2, 128), np.int32)
    plen = np.array([9, 30], np.int32)
    r = np.random.default_rng(5)
    for b in range(2):
        buf[b, :plen[b]] = r.integers(6, V, plen[b])
    want = np.asarray(jkv.greedy_generate_cached(
        jp, jnp.asarray(buf), jnp.asarray(plen), jc, max_new_tokens=12))
    got = tkv.greedy_generate_cached(tp, buf, plen, tc, max_new_tokens=12,
                                     device="cpu").numpy()
    np.testing.assert_array_equal(got, want)

    eng = BatchEngine(tp, tc, plan=ExecutionPlan.from_kwargs(
        max_batch=2, decode_buckets="128,256"), eos_ids=(EOS,), device="cpu")
    reqs = [Request(rid=f"r{i}", token_ids=r.integers(
        6, V, size=p).astype(np.int32), max_new_tokens=m)
        for i, (p, m) in enumerate([(7, 12), (30, 20), (150, 16), (50, 9)])]
    comps = eng.run_until_drained(reqs)
    assert {c.bucket for c in comps} == {128, 256} and eng.refills >= 1
    for req, c in zip(reqs, comps):
        pbuf, pl = form_prompt_buffer(req.token_ids, c.bucket)
        ref = jkv.greedy_generate_cached(
            jp, jnp.asarray(pbuf), jnp.asarray([pl], jnp.int32), jc,
            max_new_tokens=req.max_new_tokens, eos_ids=(EOS,))
        np.testing.assert_array_equal(c.tokens, np.asarray(ref[0]))


# -- the quantized init -----------------------------------------------------

def test_quantized_init_draws_banks_one_expert_at_a_time(monkeypatch):
    """``init_quantized_params`` on an MoE config: NF4 banks of the
    logical shape [E, d_in, d_out], each quantized from a bf16 slice of
    one expert (never a whole bank), and a full-precision router at std
    0.02."""
    from gke_ray_train_tpu_torch.ops import quant as tquant
    _, tc = _model_cfgs(d_model=128, d_ff=256, n_layers=2)
    seen = []
    orig = tquant.quantize_tensor

    def spy(w, *a, **kw):
        seen.append(tuple(w.shape))
        return orig(w, *a, **kw)
    monkeypatch.setattr(tquant, "quantize_tensor", spy)
    from gke_ray_train_tpu_torch.models import qinit
    monkeypatch.setattr(qinit, "quantize_tensor", spy)
    q = init_quantized_params(tc, seed=0, device="cpu")
    E = tc.n_experts
    assert sorted(seen) == sorted(
        [(128, 128)] * 2 * 2 + [(128, 64)] * 2 * 2       # wq wo, wk wv
        + [(128, 256)] * 2 * E * 2 + [(256, 128)] * E * 2)
    blk = q.blocks[0]
    for name, shape in (("w_gate", (E, 128, 256)), ("w_up", (E, 128, 256)),
                        ("w_down", (E, 256, 128))):
        qt = getattr(blk, name)
        assert isinstance(qt, QTensor) and qt.shape == shape
        assert qt.scales.shape == (E, shape[1] // 64, shape[2])
    assert not any(n.endswith(("w_gate", "w_up", "w_down"))
                   for n, _ in q.named_parameters())
    assert blk.router.shape == (128, E) and blk.router.requires_grad is False
    assert 0.017 < float(blk.router.std()) < 0.023
    assert float(blk.router.abs().max()) <= 0.06 + 1e-6
    # the banks' scales follow the residual-writer scaling: w_down's
    # absmax is about 1/sqrt(2 * n_layers) of w_gate's
    ratio = float(blk.w_down.scales.mean() / blk.w_gate.scales.mean())
    assert 0.35 < ratio < 0.65
    with torch.no_grad():
        logits = ttr.forward(q, torch.zeros((1, 16), dtype=torch.int32), tc)
    assert torch.isfinite(logits).all()


def test_full_precision_init_has_the_moe_tree():
    jc, tc = _model_cfgs()
    m = ttr.init_params(tc, seed=0, device="cpu")
    jp = jtr.init_params(jc, jax.random.key(0))
    for name, p in m.blocks[0].named_parameters():
        assert tuple(p.shape) == jp["blocks"][0][name].shape[1:], name
    assert sum(p.numel() for p in m.parameters()) == tc.param_count()
    assert "router" in dict(m.blocks[0].named_parameters())
    assert float(m.blocks[0].w_down.std()) < float(m.blocks[0].w_up.std())
    assert dataclasses.replace(tc, n_experts=0).param_count() < \
        tc.param_count()


# -- the sequence sharded over a context axis -----------------------------

def _lean_cfgs(**kw):
    """The tiny Mixtral at d_model 64 and capacity_factor 1.25 (Mixtral's),
    where the lean inputs overflow an expert."""
    return _model_cfgs(capacity_factor=1.25, max_seq_len=64, **kw)


def test_route_positions_on_shards_are_the_whole_rows():
    """``slot_positions`` of each half of a row, given the lower half's
    counts and the row's totals (what a context rank gathers), equal
    ``route`` over the whole row; routing each half on its own keeps
    other tokens (its own capacity and cumsum): the fault the context
    ranks' gather repairs."""
    _, tc = _lean_cfgs()
    inp = ep.lean_moe_inputs(9, B=2, S=64, D=64, F=128, E=4)
    x, router = torch.from_numpy(inp["x"]), torch.from_numpy(inp["router"])
    whole = tmoe.route(x, router, tc)
    halves = [whole.expert[:, :32], whole.expert[:, 32:]]
    counts = [tmoe.slot_counts(e, 4) for e in halves]
    total = counts[0] + counts[1]
    pos = torch.cat([
        tmoe.slot_positions(halves[0], 4, torch.zeros_like(total), total),
        tmoe.slot_positions(halves[1], 4, counts[0], total)], dim=1)
    assert torch.equal(pos, whole.pos)
    alone = torch.cat([tmoe.route(x[:, :32], router, tc).keep,
                       tmoe.route(x[:, 32:], router, tc).keep], dim=1)
    assert not bool(whole.keep.all())
    assert int((alone != whole.keep).sum()) >= 16


@pytest.fixture(scope="module")
def cp_world(tmp_path_factory):
    """fsdp 1 × context 2 over gloo (``tests/_torch_ep.py`` scenario
    ``cp_moe``): ``moe_mlp`` and ``route`` on the lean input's halves and
    the lean model's forward with ring attention; one process and JAX's
    context-2 mesh (dense attention) on the whole rows meanwhile."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gke_ray_train_tpu.parallel import mesh as jmesh
    from gke_ray_train_tpu.parallel.sharding import tree_shardings
    out = str(tmp_path_factory.mktemp("cp_moe"))
    jc, tc = _lean_cfgs()
    _, rc = _lean_cfgs(attn_impl="ring")
    lean = ep.lean_moe_inputs(9, B=2, S=64, D=64, F=128, E=4)
    tokens, weights = ep.lean_tokens(5, 2, 64, V)
    jtree = ep.lean_tree(jax.tree.map(
        np.asarray, jtr.init_params(jc, jax.random.key(4))))
    params = interop.params_from_numpy(jtree, tc, device="cpu")
    torch.save({"cfg": tc.to_dict(), "ring_cfg": rc.to_dict(),
                "lean_params": params.state_dict(),
                "lean": dict(lean, tokens=tokens, weights=weights)},
               os.path.join(out, "inputs.pt"))
    procs = ep.start("cp_moe", out, n=2)
    t = {k: torch.from_numpy(v) for k, v in lean.items()}
    banks = (t["w_gate"], t["w_up"], t["w_down"])
    one = {"y": tmoe.moe_mlp(t["x"], t["router"], *banks, tc,
                             torch.float32)[0],
           "route": tmoe.route(t["x"], t["router"], tc),
           "aux": [float(tmoe.route(h, t["router"], tc).aux)
                   for h in t["x"].chunk(2, dim=1)],
           "logits": ttr.forward(params, torch.from_numpy(tokens), tc)}
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, fsdp=1, model=1,
                                             context=2), jax.devices()[:2])
    xs = jax.device_put(jnp.asarray(lean["x"]),
                        NamedSharding(mesh, P(None, "context", None)))
    jy, _ = jax.jit(lambda x: jmoe.moe_mlp(
        x, *(jnp.asarray(lean[k]) for k in ("router", "w_gate", "w_up",
                                            "w_down")), jc, jnp.float32))(xs)
    jp = jax.device_put(jax.tree.map(jnp.asarray, jtree),
                        tree_shardings(mesh, jtr.param_specs(jc)))
    jl = jax.jit(lambda p, x: jtr.forward(p, x, jc, mesh=mesh))(
        jp, jnp.asarray(tokens))
    mr.wait(procs, timeout=300)
    ranks = [torch.load(os.path.join(out, f"cp_moe_{r}.pt"),
                        weights_only=False) for r in range(2)]
    ranks.sort(key=lambda r: r["ranks"]["context"])
    return dict(ranks=ranks, one=one, jax={"y": np.asarray(jy),
                                          "logits": np.asarray(jl)})


def test_context2_moe_matches_one_process_and_jax_mesh(cp_world):
    """fsdp 1 × context 2, fp32, on an input whose halves overflow unlike
    the whole row: the ranks' ``moe_mlp`` outputs put together equal one
    process's and JAX's on its context-2 mesh within 1e-5, their keep
    masks and positions the whole row's; each rank's aux is its half's
    mean (the documented divergence); the model's logits through ring
    attention equal one process's and JAX's mesh's."""
    ranks, one, jx = cp_world["ranks"], cp_world["one"], cp_world["jax"]
    y = torch.cat([r["y"] for r in ranks], dim=1).numpy()
    assert _rel(y, one["y"].detach().numpy()) <= Y_RTOL
    assert _rel(y, jx["y"]) <= Y_RTOL
    keep = torch.cat([r["keep"] for r in ranks], dim=1)
    assert torch.equal(keep, one["route"].keep)
    assert torch.equal(torch.cat([r["pos"] for r in ranks], dim=1),
                       one["route"].pos)
    for r, aux in zip(ranks, one["aux"]):
        assert abs(r["aux"] - aux) <= AUX_ATOL
    logits = torch.cat([r["forward"]["logits"] for r in ranks], dim=1)
    assert _rel(logits.numpy(), one["logits"].detach().numpy()) <= Y_RTOL
    assert _rel(logits.numpy(), jx["logits"]) <= Y_RTOL
