"""The port's fused cross-entropy (``ops/fused_ce.py``) against the JAX
package's, at tiny dims on the CPU: the same numpy inputs through the
JAX ``fused_cross_entropy`` (the Pallas kernels in interpret mode) and
the port's autograd.Function over the plain versions, and a tiny
Llama-style model (no logit softcap) trained with ``FUSED_OPS=1``, which
takes the loss through the fused cross-entropy on both sides.

Tolerances, all float32: the loss value within 1e-5 relative, dx and
dhead within 1e-5 of their largest reference element (one fp32 sum over
the vocab or the rows in another order, and the online logsumexp against
the full-row one); the train streams as in ``test_torch_port_fused.py``:
loss and grad_norm within 1e-5 relative, the trained tensors after 3
steps within 2e-6 absolute at a peak lr of 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import fused_ce as jfce
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models.transformer import unembed_head
from gke_ray_train_tpu_torch.ops import fused_ce as tfce
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_optimizer, make_train_state, make_train_step,
    warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.step import trainable_tensors

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-5
STREAM_RTOL = 1e-5
PARAM_ATOL = 2e-6
V, S, B, ACCUM = 256, 128, 4, 2
LR, TOTAL = 1e-3, 10


def _ce_inputs(V_, seed, Bn=2, Sn=64, D=64):
    """x, head, targets (one of them V + 5, out of range) and weights
    (random in [0.5, 1.5], a run of zeros and scattered zeros)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((Bn, Sn, D)).astype(np.float32)
    head = (r.standard_normal((D, V_)) * 0.3).astype(np.float32)
    targets = r.integers(0, V_, (Bn, Sn)).astype(np.int32)
    targets[0, 3] = V_ + 5
    weights = r.uniform(0.5, 1.5, (Bn, Sn)).astype(np.float32)
    weights[r.random((Bn, Sn)) < 0.2] = 0.0
    weights[1, :7] = 0.0
    return x, head, targets, weights


def _assert_rel(got, want, rtol, name):
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("V_, block_v", [(384, 128), (1000, None)])
def test_fused_cross_entropy_value_and_grads_match_jax(V_, block_v):
    """Three vocab tiles of 128 (the online merge runs across tiles), and
    V = 1,000, one full block that is no multiple of 128."""
    x, head, targets, weights = _ce_inputs(V_, V_)
    kw = {} if block_v is None else dict(block_v=block_v)

    def loss(xj, hj):
        return jfce.fused_cross_entropy(xj, hj, jnp.asarray(targets),
                                        jnp.asarray(weights), **kw)
    (jnll, jw), (jdx, jdh) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    nll, w = tfce.fused_cross_entropy(tx, th, torch.from_numpy(targets),
                                      torch.from_numpy(weights))
    nll.backward()
    np.testing.assert_allclose(float(nll.detach()), float(jnll),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(w), float(jw), rtol=1e-6)
    assert nll.dtype == w.dtype == torch.float32
    _assert_rel(tx.grad.numpy(), np.asarray(jdx), GRAD_RTOL, "dx")
    _assert_rel(th.grad.numpy(), np.asarray(jdh), GRAD_RTOL, "dhead")
    # weight-0 rows take no gradient
    assert float(tx.grad[1, :7].abs().max()) == 0.0


def test_plain_versions_keep_the_label_rule():
    """Against a dense formulation through autograd: a label outside
    [0, V) (V + 5, -1) gives a target logit of 0 and no one-hot term."""
    x, head, targets, weights = _ce_inputs(200, 5, Bn=2, Sn=20, D=32)
    t = torch.from_numpy(targets.reshape(-1))
    t[7] = -1
    xs = torch.from_numpy(x.reshape(-1, 32)).requires_grad_(True)
    hs = torch.from_numpy(head).requires_grad_(True)
    w = torch.from_numpy(weights.reshape(-1))
    logits = xs @ hs
    valid = (t >= 0) & (t < 200)
    picked = torch.gather(logits, 1, t.clamp(0, 199).long()[:, None])[:, 0]
    dense = torch.sum((torch.logsumexp(logits, -1)
                       - torch.where(valid, picked, 0.0)) * w)
    dense.backward()
    lse, tgt = tfce.fused_ce_row_stats_reference(xs.detach(), hs.detach(), t)
    assert float(tgt[3].abs()) == 0.0 and float(tgt[7].abs()) == 0.0
    np.testing.assert_allclose(float(torch.sum((lse - tgt) * w)),
                               float(dense.detach()), rtol=1e-6)
    dx, dh = tfce.fused_ce_grads_reference(xs.detach(), hs.detach(), t, w,
                                           lse)
    _assert_rel(dx.numpy(), xs.grad.numpy(), 1e-6, "dx")
    _assert_rel(dh.numpy(), hs.grad.numpy(), 1e-6, "dhead")


def test_frozen_head_forms_no_dhead(monkeypatch):
    """dhead only where the head takes a gradient (LoRA freezes it); dx
    alike either way."""
    calls = []
    real = tfce.fused_ce_dhead
    monkeypatch.setattr(tfce, "fused_ce_dhead",
                        lambda *a: calls.append(1) or real(*a))
    x, head, targets, weights = _ce_inputs(300, 9)
    grads = []
    for head_grad in (True, False):
        tx = torch.from_numpy(x).requires_grad_(True)
        th = torch.from_numpy(head).requires_grad_(head_grad)
        tfce.fused_cross_entropy(tx, th, torch.from_numpy(targets),
                                 torch.from_numpy(weights))[0].backward()
        grads.append(tx.grad)
        assert len(calls) == 1
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_fused_cross_entropy_refuses_what_is_not_ported():
    x = torch.zeros((1, 4, 8))
    head = torch.zeros((8, 16))
    t = torch.zeros((1, 4), dtype=torch.int32)
    w = torch.ones((1, 4))
    for kw in (dict(vocab_axis="model"), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="sharded vocab"):
            tfce.fused_cross_entropy(x, head, t, w, **kw)
    with pytest.raises(ValueError, match="targets"):
        tfce.fused_cross_entropy(x, head, t[:, :3], w)


# (dtype, D, V, misaligned x, the body dx / dhead take): the Llama-3.1-8B,
# Gemma-2-9B and registry bf16 shapes on wgmma; rows TMA cannot address
# (D 100, V 1,001, V 1) and a misaligned view on mma_sync; float32 on fp32
ROUTE_CASES = [
    (torch.bfloat16, 4096, 128256, False, "wgmma"),
    (torch.bfloat16, 3584, 256128, False, "wgmma"),
    (torch.bfloat16, 64, 256, False, "wgmma"),
    (torch.bfloat16, 100, 1001, False, "mma_sync"),
    (torch.bfloat16, 100, 1000, False, "mma_sync"),
    (torch.bfloat16, 64, 1001, False, "mma_sync"),
    (torch.bfloat16, 64, 1, False, "mma_sync"),
    (torch.bfloat16, 64, 256, True, "mma_sync"),
    (torch.float32, 4096, 128256, False, "fp32"),
    (torch.float32, 100, 1001, True, "fp32"),
]


@pytest.mark.parametrize("dtype, D, V, misaligned, want", ROUTE_CASES)
def test_grad_route_follows_dtype_shape_and_alignment(dtype, D, V,
                                                      misaligned, want):
    """The dx / dhead body is a function of dtype, shapes and the
    operands' alignment alone. x is a real [2, D] tensor (a view 2 bytes
    past an aligned base where ``misaligned``); head's pointer stands in
    for a [D, V] allocation, which is aligned."""
    buf = torch.zeros(2 * D + 1, dtype=dtype)
    x = buf[1:].view(2, D) if misaligned else buf[:2 * D].view(2, D)
    assert (x.data_ptr() % 16 != 0) == misaligned
    assert tfce.grad_route(dtype, D, V, (x.data_ptr(), 4096)) == want
    if not misaligned:
        assert tfce.grad_route(dtype, D, V) == want


def test_route_is_no_public_argument():
    """The route is chosen from the operands; the public entry points and
    the autograd.Function take no route, and ``_grad_launch`` names the
    routes it knows."""
    import inspect
    for fn in (tfce.fused_cross_entropy, tfce.fused_ce_dx,
               tfce.fused_ce_dhead, tfce.FusedCrossEntropy.forward):
        assert "route" not in inspect.signature(fn).parameters
    x, head, targets, weights = _ce_inputs(256, 11, Bn=2, Sn=8)
    args = [torch.from_numpy(a) for a in (x, head, targets, weights)]
    with pytest.raises(TypeError, match="route"):
        tfce.fused_cross_entropy(*args, route="mma_sync")
    xs, hs = args[0].reshape(-1, 64), args[1]
    t, w = args[2].reshape(-1), args[3].reshape(-1)
    lse, _ = tfce.fused_ce_row_stats_reference(xs, hs, t)
    with pytest.raises(ValueError, match="route"):
        tfce._grad_launch("fused_ce_dx", xs, hs, t, w, lse,
                          route="tensor_cores")


@pytest.mark.parametrize("dtype, D, V, misaligned, want", ROUTE_CASES)
def test_row_stats_take_the_gradients_route(dtype, D, V, misaligned, want):
    """The row statistics pick their body by the gradients' predicate, from
    their own operands: x a real [2, D] tensor (2 bytes past an aligned
    base where ``misaligned``), head a [D, V] view of one element (shape
    and an aligned pointer, no storage)."""
    buf = torch.zeros(2 * D + 1, dtype=dtype)
    x = buf[1:].view(2, D) if misaligned else buf[:2 * D].view(2, D)
    head = torch.zeros((), dtype=dtype).expand(D, V)
    assert tfce._route_of(x, head) == want


def test_row_stats_route_is_no_public_argument():
    """The public row statistics take no route; the private launch names
    the routes it knows before it touches a device."""
    import inspect
    assert "route" not in inspect.signature(
        tfce.fused_ce_row_stats).parameters
    x, head, targets, _ = _ce_inputs(256, 12, Bn=2, Sn=8)
    xs = torch.from_numpy(x).reshape(-1, 64)
    hs, t = torch.from_numpy(head), torch.from_numpy(targets).reshape(-1)
    with pytest.raises(TypeError, match="route"):
        tfce.fused_ce_row_stats(xs, hs, t, route="wgmma")
    with pytest.raises(ValueError, match="route"):
        tfce._row_stats_launch(xs, hs, t, route="tensor_cores")
    assert set(tfce.fused_ce_row_stats.routes) == set(tfce.ROUTES)


def _batch(seed):
    r = np.random.default_rng(seed)
    w = np.ones((B, S), np.float32)
    for i, n in enumerate(r.integers(S // 2, S + 1, B)):
        w[i, n:] = 0.0                      # padding tail, weight 0
    return {"inputs": r.integers(0, V, (B, S)).astype(np.int32),
            "targets": r.integers(0, V, (B, S)).astype(np.int32),
            "weights": w}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mode", ["full", "full_tied", "lora"])
def test_llama_fused_ce_train_matches_jax(mode, monkeypatch):
    """A tiny llama (no logit softcap; untied or tied head) with
    ``FUSED_OPS=1`` from the plan, 3 steps at grad-accum 2: the loss runs
    through the fused cross-entropy on both sides, dhead is formed in
    full fine-tuning only, and there the head trains."""
    counts = {"row_stats": 0, "dhead": 0}
    for name in counts:
        real = getattr(tfce, f"fused_ce_{name}")
        monkeypatch.setattr(
            tfce, f"fused_ce_{name}",
            lambda *a, _n=name, _f=real: counts.__setitem__(
                _n, counts[_n] + 1) or _f(*a))
    kw = dict(vocab_size=V, n_layers=2, tie_embeddings=mode == "full_tied")
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    assert jc.logit_softcap is None and tc.logit_softcap is None
    params = jtr.init_params(jc, jax.random.key(0))
    jl = tl = None
    if mode == "lora":
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
    head0 = unembed_head(tstate.params, tc).detach().clone()

    steps = 3
    jm, tm = [], []
    for i in range(steps):
        batch = _batch(200 + i)
        jstate, m = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tfn(tstate, batch)
        tm.append({k: float(v) for k, v in m.items()})
    for key in ("loss", "grad_norm", "learning_rate", "tokens"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm],
                                   rtol=STREAM_RTOL, atol=1e-9, err_msg=key)
    assert counts == {"row_stats": steps * ACCUM,
                      "dhead": 0 if tl is not None else steps * ACCUM}
    head = unembed_head(tstate.params, tc).detach()
    moved = float((head - head0).abs().max())
    if tl is not None:
        assert moved == 0.0
        want = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        got = [(f"{i}.{t}.{ab}", layer[t][ab])
               for i, layer in enumerate(tstate.lora)
               for t in layer for ab in ("a", "b")]
        ref = {f"{i}.{t}.{ab}": layer[t][ab]
               for i, layer in enumerate(want) for t in layer
               for ab in ("a", "b")}
    else:
        assert moved > 10 * PARAM_ATOL       # the lm_head trains
        want = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
        got = list(trainable_tensors(tstate.params, None))
        ref = dict(want.named_parameters())
    for name, t in got:
        np.testing.assert_allclose(t.detach().numpy(),
                                   ref[name].detach().numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
