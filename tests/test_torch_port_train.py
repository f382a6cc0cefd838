"""The port's train step (gke_ray_train_tpu_torch/train) against the JAX
package's, the slice as a whole, at tiny dims on the CPU.

A tiny llama3 (2 layers, d_model 64, 4/2 heads, vocab 256, S=128) in
float32: the JAX train state (params, adapters, a quantized base) is
carried over with ``interop``; both packages then take the same numpy
batches (random tokens, rows with a zero-weight padding tail) for 5
steps at grad-accum 2 with a warmup-cosine schedule, a clip that
triggers and weight decay, LoRA dropout 0. The loss, grad_norm and
learning_rate streams agree within 1e-5 relative (fp32 products and sums
in other orders), and the trainable tensors after the last step within
2e-6 absolute at a peak lr of 1e-3. Attention is the dense path on both
sides, plus QLoRA through flash on both sides (the Pallas kernels in
interpret mode, the port's autograd.Function over the plain versions)
with remat, for 2 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import init_params, init_quantized_params
from gke_ray_train_tpu_torch.ops import flash_attention as tflash
from gke_ray_train_tpu_torch.ops.quant import QTensor
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_eval_step, make_optimizer, make_train_state,
    make_train_step, merge_lora, warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.step import token_nll, trainable_tensors
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


STREAM_RTOL = 1e-5
PARAM_ATOL = 2e-6
V, S, B, ACCUM = 256, 128, 4, 2
LR, TOTAL = 1e-3, 10


def _cfgs(**kw):
    return jcfg.tiny(vocab_size=V, **kw), tcfg.tiny(vocab_size=V, **kw)


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


def _jax_state(jc, mode, lora_r=4):
    params = jtr.init_params(jc, jax.random.key(0))
    lcfg = None
    if mode != "full":
        lcfg = jlora.LoraConfig(r=lora_r, alpha=8)
    if mode == "qlora":
        params = jquant.quantize_params(params, kind="nf4", group=32)
    sched = joptim.warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    opt = joptim.make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = jstep.make_train_state(jc, opt, jax.random.key(1),
                                   lora_cfg=lcfg, params=params)
    if lcfg is not None:
        # B = 0 at init: give the adapters a nonzero start so every
        # gradient path carries signal from the first step
        r = np.random.default_rng(3)
        lora = jax.tree.map(
            lambda x: jnp.asarray(r.standard_normal(x.shape).astype(
                np.float32) * 0.05), state.lora)
        state = state._replace(lora=lora,
                               opt_state=jax.jit(opt.init)(lora))
    step = jstep.make_train_step(jc, opt, lora_cfg=lcfg, grad_accum=ACCUM,
                                 schedule=sched, donate=False)
    return state, step, lcfg


def _port_state(tc, jstate, lcfg):
    tl = None
    if lcfg is not None:
        tl = LoraConfig(r=lcfg.r, alpha=lcfg.alpha)
    params = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
    sched = warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    spec = make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = make_train_state(tc, spec, lora_cfg=tl, params=params,
                             device="cpu")
    if tl is not None:
        src = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        with torch.no_grad():
            for ours, theirs in zip(state.lora, src):
                for t in ours:
                    for ab in ("a", "b"):
                        ours[t][ab].copy_(theirs[t][ab])
    step = make_train_step(tc, spec, lora_cfg=tl, grad_accum=ACCUM,
                           schedule=sched, device="cpu")
    return state, step


def _run(mode, n_steps, **cfg_kw):
    jc, tc = _cfgs(**cfg_kw)
    jstate, jfn, lcfg = _jax_state(jc, mode)
    tstate, tfn = _port_state(tc, jstate, lcfg)
    jm, tm = [], []
    for i in range(n_steps):
        batch = _batch(100 + i)
        jstate, m = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tfn(tstate, batch)
        tm.append({k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm", "learning_rate", "tokens"):
        np.testing.assert_allclose([m[k] for m in tm], [m[k] for m in jm],
                                   rtol=STREAM_RTOL, atol=1e-9, err_msg=k)
    assert tstate.step == n_steps
    return jstate, tstate, tc


def _assert_trainables_match(jstate, tstate, tc, lora: bool):
    if lora:
        want = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        got = tstate.lora
        for ours, theirs in zip(got, want):
            for t in ours:
                for ab in ("a", "b"):
                    np.testing.assert_allclose(
                        ours[t][ab].detach().numpy(),
                        theirs[t][ab].numpy(), atol=PARAM_ATOL, rtol=0)
        return
    want = interop.params_from_numpy(_np(jstate.params), tc, device="cpu")
    theirs = dict(want.named_parameters())
    for name, p in tstate.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   theirs[name].detach().numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["full", "lora", "qlora"])
def test_five_steps_match_jax(mode):
    """Loss / grad_norm / lr streams and the trained tensors after 5
    steps, dense attention on both sides."""
    jstate, tstate, tc = _run(mode, 5, attn_impl="xla")
    _assert_trainables_match(jstate, tstate, tc, lora=mode != "full")
    if mode == "qlora":
        # the base stayed quantized and untouched
        assert isinstance(tstate.params.blocks[0].wq, QTensor)
        assert not any(p.requires_grad
                       for p in tstate.params.parameters())


def test_qlora_through_flash_with_remat_matches_jax():
    """QLoRA, attention through flash on both sides (forward and the
    dQ / dK/dV backward), per-block remat, 2 steps."""
    before = tflash.flash_attention.launches
    jstate, tstate, tc = _run("qlora", 2, attn_impl="flash", remat=True)
    _assert_trainables_match(jstate, tstate, tc, lora=True)
    assert tflash.flash_attention.launches == before   # CPU: no kernel


def test_eval_step_matches_jax():
    jc, tc = _cfgs(attn_impl="xla")
    jstate, _, lcfg = _jax_state(jc, "qlora")
    tstate, _ = _port_state(tc, jstate, lcfg)
    batch = _batch(7)
    jnll, jw = jstep.make_eval_step(jc, lora_cfg=lcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnll, tw = make_eval_step(tc, lora_cfg=LoraConfig(r=4, alpha=8),
                              device="cpu")(tstate, batch)
    np.testing.assert_allclose(float(tnll), float(jnll), rtol=STREAM_RTOL)
    assert float(tw) == float(jw)


def test_token_nll_matches_jax():
    r = np.random.default_rng(0)
    logits = r.standard_normal((2, 16, 50)).astype(np.float32) * 3
    tg = r.integers(0, 50, (2, 16)).astype(np.int32)
    w = (r.random((2, 16)) > 0.3).astype(np.float32)
    jn, jw = jstep.token_nll(jnp.asarray(logits), jnp.asarray(tg),
                             jnp.asarray(w))
    tn, tw = token_nll(torch.from_numpy(logits), torch.from_numpy(tg),
                       torch.from_numpy(w))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert float(tw) == float(jw)


def test_lora_dropout_masks_are_seeded_and_redrawn_under_remat():
    """Dropout changes the loss, the same seed gives the same loss with
    and without remat (the recomputed blocks redraw the same masks), and
    another seed gives another loss."""
    _, tc = _cfgs(attn_impl="xla")
    model = init_params(tc, seed=0, device="cpu")
    lcfg = LoraConfig(r=4, alpha=8, dropout=0.5)
    from gke_ray_train_tpu_torch.train import init_lora
    lora = init_lora(tc, lcfg, seed=1, device="cpu")
    with torch.no_grad():
        for layer in lora:
            for ab in layer.values():
                ab["b"].normal_(generator=torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(_batch(0)["inputs"])
    from gke_ray_train_tpu_torch.models import forward

    def loss_and_grad(cfg, seed):
        for layer in lora:
            for ab in layer.values():
                ab["a"].grad = None
        out = forward(model, tokens, cfg, lora=lora, lora_scale=lcfg.scale,
                      lora_dropout=lcfg.dropout, lora_seed=seed)
        loss = out.square().mean()
        loss.backward()
        return float(loss.detach()), lora[0]["wq"]["a"].grad.clone()

    with torch.no_grad():
        plain = float(forward(model, tokens, tc, lora=lora,
                              lora_scale=lcfg.scale).square().mean())
    l1, g1 = loss_and_grad(tc, 11)
    l2, g2 = loss_and_grad(dataclasses.replace(tc, remat=True), 11)
    l3, _ = loss_and_grad(tc, 12)
    assert l1 != plain and l1 != l3
    assert l1 == l2
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)


def test_init_quantized_params_and_merge_lora():
    """The quantized init holds int8 NF4 codes and fp32 scales for every
    projection, norms at one; merging dequantizes to fp32 and folds the
    adapters in, so the merged model's logits equal the adapted ones."""
    _, tc = _cfgs(attn_impl="xla")
    q = init_quantized_params(tc, seed=0, device="cpu")
    blk = q.blocks[0]
    assert isinstance(blk.w_down, QTensor) and blk.w_down.codes.dtype == \
        torch.int8 and blk.w_down.scales.shape == (128 // 64, 64)
    assert int(blk.wq.codes.min()) >= 0 and int(blk.wq.codes.max()) <= 15
    assert torch.all(blk.attn_norm == 1.0)
    assert not any(n.endswith(".wq") for n, _ in q.named_parameters())
    from gke_ray_train_tpu_torch.models import forward
    from gke_ray_train_tpu_torch.train import init_lora
    lcfg = LoraConfig(r=4, alpha=8)
    lora = init_lora(tc, lcfg, seed=1, device="cpu")
    with torch.no_grad():
        for layer in lora:
            for ab in layer.values():
                ab["b"].normal_(0.0, 0.1)
    tokens = torch.from_numpy(_batch(1)["inputs"][:1])
    with torch.no_grad():
        adapted = forward(q, tokens, tc, lora=lora, lora_scale=lcfg.scale)
        merged = forward(merge_lora(q, lora, lcfg), tokens, tc)
    assert not any(isinstance(m, QTensor) for m in q.modules())
    np.testing.assert_allclose(merged.numpy(), adapted.numpy(), atol=1e-4,
                               rtol=0)


def test_trainable_names_drive_the_decay_mask():
    _, tc = _cfgs()
    model = init_params(tc, seed=0, device="cpu")
    names = dict(trainable_tensors(model, None))
    assert "blocks.0.attn_norm" in names and "final_norm" in names
    spec = make_optimizer(0.1)
    state = make_train_state(tc, spec, params=model, device="cpu")
    decayed = {id(p) for p in state.opt_state.param_groups[0]["params"]}
    assert id(names["blocks.0.wq"]) in decayed
    assert id(names["embed"]) in decayed
    assert id(names["blocks.1.mlp_norm"]) not in decayed
    assert id(names["final_norm"]) not in decayed


def test_train_step_refuses_what_is_not_ported():
    """Manual overlap without a mesh raises ``ManualOverlapUnsupported``
    in JAX's words (it was ``NotImplementedError`` until the manual path
    was ported, ``tests/test_torch_port_overlap.py``); a mesh must be a
    DeviceMesh, and
    every layout a mesh can carry is ported (context and pipe came with
    their ports, pipe over model with the next: its double passes the
    mesh check; multi-slice raises at ``MeshConfig``);
    ``remat_policy="dots"`` (which raised before it was ported) now
    trains, to the numbers of ``"full"``."""
    from gke_ray_train_tpu_torch.train.step import _check_mesh
    _, tc = _cfgs()
    spec = make_optimizer(0.1)
    from gke_ray_train_tpu.train.overlap import check_manual_support
    from gke_ray_train_tpu_torch.train.overlap import (
        ManualOverlapUnsupported)
    with pytest.raises(ValueError) as jax_err:
        check_manual_support(None, None)
    with pytest.raises(ManualOverlapUnsupported) as err:
        make_train_step(tc, spec, device="cpu", overlap="manual")
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(tc, spec, device="cpu", mesh=object())

    class PPMesh:                   # data 1 x fsdp 1 x model 2 x pipe 2
        mesh_dim_names = ("data", "fsdp", "model", "context", "pipe")

        def size(self, i):
            return (1, 1, 2, 1, 2)[i]
    _check_mesh(PPMesh())
    losses = {}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(tc, remat=True, remat_policy=policy)
        model = init_params(cfg, seed=0, device="cpu")
        state = make_train_state(cfg, spec, params=model, device="cpu")
        _, m = make_train_step(cfg, spec, device="cpu")(state, _batch(0))
        losses[policy] = (float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(losses["dots"], losses["full"], rtol=1e-6)
