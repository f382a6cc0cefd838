"""``remat_policy="dots"`` and ``OPTIM=adafactor`` in the port, against
the port's other remat policies and the JAX package / optax on the CPU.

- dots: the gradients of a tiny Llama (2 layers, d_model 128, vocab 256,
  fp32, dense attention) equal no remat and ``"full"`` in the port
  (1e-6) and JAX's ``"dots"`` (1e-5), full fine-tuning and LoRA; a hook
  on the selective-checkpoint policy sees only 2-D products saved (the
  seven base projections a layer, and two LoRA products each).
- Adafactor: 5 updates against ``optax.chain(clip_by_global_norm(c),
  adafactor(learning_rate=schedule, weight_decay_rate=wd))`` at fp32
  (1e-6) on the full fine-tuning tensors of a d_model-128 model (the
  factored branch) and on QLoRA adapters (unfactored), decay on and
  off, a warmup-cosine schedule; and 3 train steps of the port's config
  path against JAX's (``OPTIM=adafactor``, peak lr 1e-3: streams 1e-5,
  tensors 5e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gke_ray_train_tpu import config as jconfig
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import transformer as ttr
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_adafactor, make_train_state, make_train_step,
    warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.optim import factored_dims
from gke_ray_train_tpu_torch.train.step import token_nll
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, S, B = 256, 64, 2


def _cfgs(**kw):
    base = dict(vocab_size=V, d_model=128, d_ff=256, n_layers=2,
                max_seq_len=S, attn_impl="xla")
    base.update(kw)
    return jcfg.tiny(**base), tcfg.tiny(**base)


def _tokens(seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, V, (B, S)).astype(np.int32),
            r.integers(0, V, (B, S)).astype(np.int32),
            (r.random((B, S)) > 0.2).astype(np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grads(jc, params, lora, lcfg, toks):
    x, t, w = (jnp.asarray(a) for a in toks)

    def loss(p, lo):
        logits = jtr.forward(p, x, jc, lora=lo,
                             lora_scale=lcfg.scale if lcfg else 1.0)
        nll, ws = jstep.token_nll(logits, t, w)
        return nll / ws
    if lora is None:
        return jax.grad(loss)(params, None)
    return jax.grad(loss, argnums=1)(params, lora)


def _port_grads(tc, model, lora, scale, toks):
    x, t, w = (torch.from_numpy(a) for a in toks)
    trainables = ([v for layer in lora for ab in layer.values()
                   for v in ab.values()] if lora is not None
                  else list(model.parameters()))
    for p in trainables:
        p.grad = None
        p.requires_grad_(True)
    logits = ttr.forward(model, x, tc, lora=lora, lora_scale=scale)
    nll, ws = token_nll(logits, t, w)
    (nll / ws).backward()
    if lora is not None:
        return {f"{i}.{n}.{ab}": v.grad.clone()
                for i, layer in enumerate(lora) for n, d in layer.items()
                for ab, v in d.items()}
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["full", "lora"])
def test_dots_grads_match_no_remat_full_and_jax_dots(mode):
    jc, tc = _cfgs(remat=True, remat_policy="dots")
    params = jtr.init_params(jc, jax.random.key(0))
    lcfg = jlora.LoraConfig(r=8, alpha=16) if mode == "lora" else None
    lora = None
    if lcfg is not None:
        r = np.random.default_rng(3)
        lora = jax.tree.map(lambda a: jnp.asarray(r.standard_normal(
            a.shape).astype(np.float32) * 0.05),
            jlora.init_lora(jc, lcfg, jax.random.key(1)))
    toks = _tokens(11)
    jg = _jax_grads(jc, params, lora, lcfg, toks)
    if lcfg is not None:
        want = {f"{i}.{n}.{ab}": v[ab] for i, layer in enumerate(
            interop.lora_from_numpy(_np(jg), tc, device="cpu"))
            for n, v in layer.items() for ab in ("a", "b")}
    else:
        want = dict(interop.params_from_numpy(
            _np(jg), tc, device="cpu").named_parameters())
    got = {}
    for name, kw in (("none", dict(remat=False)), ("full",
                     dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(tc, **kw)
        model = interop.params_from_numpy(_np(params), c, device="cpu")
        lo = (interop.lora_from_numpy(_np(lora), c, device="cpu")
              if lora is not None else None)
        got[name] = _port_grads(c, model, lo, lcfg.scale if lcfg else 1.0,
                                toks)
    for k, g in got["dots"].items():
        for other in ("none", "full"):
            np.testing.assert_allclose(g.numpy(), got[other][k].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{k} vs {other}")
        np.testing.assert_allclose(g.numpy(), want[k].detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=f"{k} vs jax")


@pytest.mark.parametrize("lora", [False, True])
def test_dots_policy_saves_only_no_batch_dim_products(monkeypatch, lora):
    """The policy hook sees every decision of the forward: only
    ``aten.mm`` / ``addmm`` are saved, one a base projection (7 a layer)
    plus ``x A`` and ``(x A) B`` of each adapted one; the attention's
    batched products are recomputed."""
    _, tc = _cfgs(remat=True, remat_policy="dots")
    model = ttr.init_params(tc, seed=0, device="cpu")
    lo = None
    if lora:
        from gke_ray_train_tpu_torch.train.lora import init_lora
        lo = init_lora(tc, LoraConfig(r=8, alpha=16), device="cpu")
    else:
        model.requires_grad_(True)
    seen = []
    monkeypatch.setattr(ttr, "dots_policy_hook",
                        lambda op, save: seen.append((op, save)))
    x, t, w = (torch.from_numpy(a) for a in _tokens(3))
    nll, _ = token_nll(ttr.forward(model, x, tc, lora=lo), t, w)
    nll.backward()
    saved = [op for op, s in seen if s]
    assert set(saved) <= ttr.DOTS_SAVED_OPS
    assert len(saved) == tc.n_layers * 7 * (3 if lora else 1)
    recomputed = {op for op, s in seen if not s}
    assert torch.ops.aten.bmm.default in recomputed
    assert not recomputed & ttr.DOTS_SAVED_OPS


# -- adafactor --------------------------------------------------------------

def _shapes(kind):
    _, tc = _cfgs()
    if kind == "full":
        model = ttr.init_params(tc, seed=0, device="cpu")
        return {n: tuple(p.shape) for n, p in model.named_parameters()}
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    out = {}
    for name, (d_in, d_out) in proj_shapes(tc).items():
        out[f"{name}.a"] = (d_in, 16)
        out[f"{name}.b"] = (16, d_out)
    return out


@pytest.mark.parametrize("kind", ["full", "lora"])
@pytest.mark.parametrize("wd", [0.001, 0.0])
def test_adafactor_matches_optax(kind, wd):
    shapes = _shapes(kind)
    fds = {n: factored_dims(s, 128) for n, s in shapes.items()}
    if kind == "full":
        assert any(fds.values()) and not all(fds.values())
    else:
        assert not any(fds.values())
    r = np.random.default_rng(0)
    init = {n: (r.standard_normal(s) * 0.02).astype(np.float32)
            for n, s in shapes.items()}
    sched_j = joptim.warmup_cosine_schedule(1e-2, 10, warmup_frac=0.2)
    tx = optax.chain(optax.clip_by_global_norm(0.3),
                     optax.adafactor(learning_rate=sched_j,
                                     weight_decay_rate=wd or None))
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    js = tx.init(jp)
    tp = {n: torch.tensor(v) for n, v in init.items()}
    spec = make_adafactor(warmup_cosine_schedule(1e-2, 10, warmup_frac=0.2),
                          clip_norm=0.3, weight_decay_rate=wd or None)
    opt = spec.build(tp.items())
    for step in range(5):
        # gradients of a few scales, so the clip triggers on some steps
        grads = {n: (r.standard_normal(s) * 10.0 ** (step % 3 - 2)).astype(
            np.float32) for n, s in shapes.items()}
        upd, js = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{n} step {step}")
    want_norm = float(optax.global_norm(
        {n: jnp.asarray(g) for n, g in grads.items()}))
    np.testing.assert_allclose(float(opt.last_grad_norm), want_norm,
                               rtol=1e-6)
    st = {k for s in opt.state.values() for k in s}
    assert st == ({"v", "v_row", "v_col"} if kind == "full" else {"v"})


def test_adafactor_config_train_steps_match_jax():
    """3 full fine-tuning steps with OPTIM=adafactor through each
    package's config path (clip 0.3, decay 0.001, warmup-cosine)."""
    jc, tc = _cfgs()
    config = {"OPTIM": "adafactor", "WEIGHT_DECAY": 0.001,
              "MAX_GRAD_NORM": 0.3, "LEARNING_RATE": 1e-3}
    jopt = jconfig.optimizer_from_config(
        config, jconfig.schedule_from_config(config, 10))
    params = jtr.init_params(jc, jax.random.key(0))
    jstate = jstep.make_train_state(jc, jopt, jax.random.key(1),
                                    params=params)
    jfn = jstep.make_train_step(jc, jopt, grad_accum=1, donate=False)
    tspec = tconfig.optimizer_from_config(
        config, tconfig.schedule_from_config(config, 10))
    tstate = make_train_state(
        tc, tspec, params=interop.params_from_numpy(_np(params), tc,
                                                    device="cpu"),
        device="cpu")
    tfn = make_train_step(tc, tspec, grad_accum=1, device="cpu")
    for i in range(3):
        x, t, w = _tokens(40 + i)
        batch = {"inputs": x, "targets": t, "weights": w}
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tstate, tm = tfn(tstate, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} {i}")
    want = dict(interop.params_from_numpy(_np(jstate.params), tc,
                                          device="cpu").named_parameters())
    for n, p in tstate.params.named_parameters():
        # adafactor scales each element of a vector (the norms) by its
        # own second moment, so the packages' fp32 reduction orders (up
        # to 7e-4 relative on the smallest gradient elements) reach the
        # update at lr size: 5e-5 here, where AdamW holds 2e-6; on equal
        # gradients the optimizer is held at 1e-6 above
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[n].detach().numpy(), rtol=0,
                                   atol=5e-5, err_msg=n)
