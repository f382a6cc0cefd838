"""The port's ``FUSED_OPS=1`` path against the JAX package's, at tiny dims
on the CPU: the fused rms_norm and q/k RoPE (``ops/fused_norm_rope.py``;
the Pallas kernels in interpret mode on the JAX side, the plain versions
under the port's autograd.Functions here), sequence packing, the plan
knob, and a tiny Gemma-2 trained with ``fused_ops`` on packed batches.

Tolerances, all float32: the ops' values within 1e-6 and gradients
within 1e-5 absolute (one fp32 reduction over the row in another order);
the train streams as in ``test_torch_port_train.py``: loss and grad_norm
within 1e-5 relative, the trained tensors after 5 steps within 2e-6
absolute at a peak lr of 1e-3. Packing is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu.data import packing as jpacking
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import fused_norm_rope as jfnr
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.ops.rope import rope_frequencies
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.data import batch_packed, pack_examples
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.ops import fused_norm_rope as tfnr
from gke_ray_train_tpu_torch.plan import ExecutionPlan, PlanError
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_optimizer, make_train_state, make_train_step,
    warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.step import trainable_tensors

VALUE_TOL = 1e-6
GRAD_TOL = 1e-5
STREAM_RTOL = 1e-5
PARAM_ATOL = 2e-6
V, S, B, ACCUM = 256, 128, 4, 2
LR, TOTAL = 1e-3, 10
GEMMA2 = dict(block_pattern=("sliding", "global"), sliding_window=16,
              activation="gelu_tanh", tie_embeddings=True, embed_scale=True,
              norm_scale_plus_one=True, post_block_norm=True,
              attn_softcap=50.0, logit_softcap=30.0, attn_scale=16 ** -0.5,
              norm_eps=1e-6)


def _packed_positions(r, Bn, Sn):
    """[Bn, Sn] positions restarting at 0 at random document starts."""
    pos = np.zeros((Bn, Sn), np.int32)
    for b in range(Bn):
        starts = np.sort(r.choice(np.arange(1, Sn), 3, replace=False))
        edges = [0, *starts, Sn]
        for lo, hi in zip(edges[:-1], edges[1:]):
            pos[b, lo:hi] = np.arange(hi - lo)
    return pos


@pytest.mark.parametrize("scale_plus_one", [False, True])
def test_fused_rmsnorm_value_and_grads_match_jax(scale_plus_one):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 24, 48)).astype(np.float32) * 2
    scale = (r.standard_normal(48) * 0.2
             + (0.0 if scale_plus_one else 1.0)).astype(np.float32)
    g = r.standard_normal(x.shape).astype(np.float32)
    kw = dict(eps=1e-6, scale_plus_one=scale_plus_one)
    jy, vjp = jax.vjp(lambda a, s: jfnr.fused_rmsnorm(a, s, **kw),
                      jnp.asarray(x), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    ty = tfnr.fused_rmsnorm(tx, ts, **kw)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=VALUE_TOL, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds),
                               atol=GRAD_TOL, rtol=0)
    # a frozen scale (LoRA): the backward forms dx alone
    tx.grad = None
    tfnr.fused_rmsnorm(tx, ts.detach(), **kw).sum().backward()
    assert tx.grad is not None


def test_fused_rope_qk_value_and_vjp_match_jax():
    """GQA (4 query heads, 2 kv heads) with packed positions that restart
    per document; the VJP is the inverse rotation."""
    r = np.random.default_rng(1)
    Bn, Sn, H, K, dh = 2, 32, 4, 2, 16
    q = r.standard_normal((Bn, Sn, H, dh)).astype(np.float32)
    k = r.standard_normal((Bn, Sn, K, dh)).astype(np.float32)
    pos = _packed_positions(r, Bn, Sn)
    gq = r.standard_normal(q.shape).astype(np.float32)
    gk = r.standard_normal(k.shape).astype(np.float32)
    freqs = rope_frequencies(dh, theta=10000.0)
    (jq, jk), vjp = jax.vjp(
        lambda a, b: jfnr.fused_rope_qk(a, b, jnp.asarray(pos),
                                        jnp.asarray(freqs)),
        jnp.asarray(q), jnp.asarray(k))
    jdq, jdk = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    tq = torch.from_numpy(q).requires_grad_(True)
    tk = torch.from_numpy(k).requires_grad_(True)
    oq, ok = tfnr.fused_rope_qk(tq, tk, torch.from_numpy(pos),
                                torch.from_numpy(freqs))
    torch.autograd.backward((oq, ok), (torch.from_numpy(gq),
                                       torch.from_numpy(gk)))
    for got, want in ((oq, jq), (ok, jk)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=VALUE_TOL, rtol=0)
    for got, want in ((tq.grad, jdq), (tk.grad, jdk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=0)
    with pytest.raises(ValueError, match="inv_freqs"):
        tfnr.fused_rope_qk(tq, tk, torch.from_numpy(pos),
                           torch.from_numpy(freqs[:-1]))
    with pytest.raises(ValueError, match="positions"):
        tfnr.fused_rope_qk(tq, tk, torch.from_numpy(pos[:, :-1]),
                           torch.from_numpy(freqs))


def _examples(seed, n, lo, hi, vocab):
    """Random documents: token ids of length lo..hi, the first third a
    prompt of loss weight 0."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(r.integers(lo, hi + 1))
        w = np.ones(L, np.float32)
        w[:L // 3] = 0.0
        out.append({"input_ids": r.integers(0, vocab, L).astype(np.int32),
                    "loss_weights": w})
    return out


@pytest.mark.parametrize("drop_last", [True, False])
def test_packing_matches_jax_bitwise(drop_last):
    ex = _examples(3, 40, 1, 90, V)
    ex.append({"input_ids": np.arange(300, dtype=np.int32) % V,
               "loss_weights": np.ones(300, np.float32)})   # truncated
    ours = list(batch_packed(pack_examples(ex, 64), 3, drop_last=drop_last))
    theirs = list(jpacking.batch_packed(jpacking.pack_examples(ex, 64), 3,
                                        drop_last=drop_last))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # positions restart per document; padding is segment 0, weight 0
    rows = ours[0]
    seg, pos = rows["segment_ids"][0], rows["positions"][0]
    starts = np.flatnonzero(np.diff(seg) != 0) + 1
    assert all(pos[s] == 0 for s in starts if seg[s] != 0)
    assert np.all(rows["weights"][rows["segment_ids"] == 0] == 0)


def test_plan_reads_fused_ops_from_env_and_config():
    for env, want in (({"FUSED_OPS": "1"}, True), ({"FUSED_OPS": "off"},
                                                   False), ({}, False)):
        ours = ExecutionPlan.resolve(env=env)
        assert ours.fused_ops is want
        assert jplan.ExecutionPlan.resolve(env=env).fused_ops is want
    assert ExecutionPlan.resolve(config={"FUSED_OPS": True},
                                 env={"FUSED_OPS": "0"}).fused_ops is True
    assert ExecutionPlan.from_config({"FUSED_OPS": 0}).fused_ops is False
    assert ExecutionPlan.resolve(env={}, fused_ops="yes").fused_ops is True
    with pytest.raises(PlanError, match="fused_ops"):
        ExecutionPlan.resolve(env={"FUSED_OPS": "maybe"})


def _packed_batches(n_steps):
    rows = B * n_steps
    packed = pack_examples(_examples(11, 12 * rows, 8, 70, V), S)
    out = list(batch_packed(packed, B))[:n_steps]
    assert len(out) == n_steps
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mode", ["qlora", "full"])
def test_gemma2_fused_ops_train_on_packed_rows_matches_jax(mode):
    """Tiny Gemma-2 (softcaps, post-norms, (1 + w) norms, tied embedding),
    attention through flash on both sides, remat, ``FUSED_OPS=1`` from
    the plan: 5 steps at grad-accum 2 on packed rows."""
    kw = dict(vocab_size=V, n_layers=2, attn_impl="flash", remat=True,
              **GEMMA2)
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    params = jtr.init_params(jc, jax.random.key(0))
    jl = tl = None
    if mode == "qlora":
        params = jquant.quantize_params(params, kind="nf4", group=32)
        jl, tl = jlora.LoraConfig(r=4, alpha=8), LoraConfig(r=4, alpha=8)
    sched = joptim.warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    opt = joptim.make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    jstate = jstep.make_train_state(jc, opt, jax.random.key(1), lora_cfg=jl,
                                    params=params)
    if jl is not None:
        r = np.random.default_rng(3)
        lora = jax.tree.map(lambda x: jnp.asarray(r.standard_normal(
            x.shape).astype(np.float32) * 0.05), jstate.lora)
        jstate = jstate._replace(lora=lora,
                                 opt_state=jax.jit(opt.init)(lora))
    jfn = jstep.make_train_step(
        jc, opt, lora_cfg=jl, grad_accum=ACCUM, schedule=sched, donate=False,
        plan=jplan.ExecutionPlan(fused_ops=True))

    tsched = warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    spec = make_optimizer(tsched, weight_decay=0.01, clip_norm=0.5)
    tstate = make_train_state(
        tc, spec, lora_cfg=tl, device="cpu",
        params=interop.params_from_numpy(_np(jstate.params), tc,
                                         device="cpu"))
    if tl is not None:
        src = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        with torch.no_grad():
            for ours, theirs in zip(tstate.lora, src):
                for t in ours:
                    for ab in ("a", "b"):
                        ours[t][ab].copy_(theirs[t][ab])
    tfn = make_train_step(tc, spec, lora_cfg=tl, schedule=tsched,
                          plan=ExecutionPlan(grad_accum=ACCUM,
                                             fused_ops=True), device="cpu")

    jm, tm = [], []
    for batch in _packed_batches(5):
        jstate, m = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tfn(tstate, batch)
        tm.append({k: float(v) for k, v in m.items()})
    for key in ("loss", "grad_norm", "learning_rate", "tokens"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm],
                                   rtol=STREAM_RTOL, atol=1e-9, err_msg=key)
    if tl is not None:
        want = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        got = [(f"{i}.{t}.{ab}", layer[t][ab])
               for i, layer in enumerate(tstate.lora)
               for t in layer for ab in ("a", "b")]
        ref = {f"{i}.{t}.{ab}": layer[t][ab]
               for i, layer in enumerate(want) for t in layer
               for ab in ("a", "b")}
    else:
        want = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
        got = list(trainable_tensors(tstate.params, None))
        ref = dict(want.named_parameters())
    for name, t in got:
        np.testing.assert_allclose(t.detach().numpy(),
                                   ref[name].detach().numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
