"""The port's quantization and optimizer against the JAX package's.

- ``quantize_tensor``: codes and scales bitwise equal to JAX's for nf4
  and int8, including a D that the group does not divide (the divisor
  fallback); ``dequantize`` equal in float32 and within one bf16 ulp in
  bfloat16.
- ``warmup_cosine_schedule``: equal to the JAX package's optax schedule
  at every step within 2e-7 of the peak rate (optax evaluates in
  float32: one or two ulps of the peak away from our float64).
- ``make_optimizer``: 5 updates of a small named tree equal optax's
  ``clip_by_global_norm`` + ``adamw`` within 1e-7, with a clip that
  triggers and one that does not, and the name-keyed decay mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu_torch.models.config import PROJ_TARGETS
from gke_ray_train_tpu_torch.ops import quant as tquant
from gke_ray_train_tpu_torch.train import optim as toptim
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


@pytest.mark.parametrize("kind", ["nf4", "int8"])
@pytest.mark.parametrize("shape,group", [((128, 48), 64), ((2, 96, 40), 64),
                                         ((72, 16), 64)])
def test_quantize_bitwise_equal_to_jax(kind, shape, group):
    r = np.random.default_rng(0)
    w = (r.standard_normal(shape) * 0.02).astype(np.float32)
    w[..., :8, 3] = 0.0                 # an all-zero group column
    w[..., 5, 7] = 0.5                  # an outlier
    jq = jquant.quantize_tensor(jnp.asarray(w), kind, group)
    tq = tquant.quantize_tensor(torch.from_numpy(w), kind, group)
    assert tq.group == jq.group and tq.kind == jq.kind
    assert tq.codes.dtype == torch.int8
    np.testing.assert_array_equal(tq.codes.numpy(),
                                  np.asarray(jq.codes).astype(np.int8))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(
        tquant.dequantize(tq, torch.float32).numpy(),
        np.asarray(jquant.dequantize(jq, jnp.float32)))
    got = tquant.dequantize(tq, torch.bfloat16).float().numpy()
    want = np.asarray(jquant.dequantize(jq, jnp.bfloat16).astype(
        jnp.float32))
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)


def test_quantize_odd_width_takes_the_divisor_group():
    w = torch.randn(72, 8)              # 64 does not divide 72: group 36
    q = tquant.quantize_tensor(w, "nf4", 64)
    assert q.group == 36 and q.scales.shape == (2, 8)
    assert tquant.NF4_CODEBOOK == tuple(float(x)
                                        for x in jquant.NF4_CODEBOOK)
    assert tquant.QUANT_TARGETS == PROJ_TARGETS
    assert tquant.DEFAULT_GROUP == jquant.DEFAULT_GROUP


def test_schedule_equals_optax_at_every_step():
    for total, frac in ((125, 0.03), (10, 0.2), (1, 0.05)):
        want = joptim.warmup_cosine_schedule(2e-4, total, warmup_frac=frac)
        got = toptim.warmup_cosine_schedule(2e-4, total, warmup_frac=frac)
        for step in range(total + 10):
            assert abs(got(step) - float(want(step))) <= 2e-7 * 2e-4, step
        assert got(0) == 0.0


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_optimizer_updates_equal_optax(clip):
    r = np.random.default_rng(1)
    shapes = {"wq": (6, 5), "attn_norm": (5,), "embed": (7, 6),
              "final_norm": (6,)}
    init = {k: r.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    sched = joptim.warmup_cosine_schedule(1e-2, 8, warmup_frac=0.25)
    jopt = joptim.make_optimizer(sched, weight_decay=0.1, clip_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in init.items()}
    spec = toptim.make_optimizer(
        toptim.warmup_cosine_schedule(1e-2, 8, warmup_frac=0.25),
        weight_decay=0.1, clip_norm=clip)
    topt = spec.build(tparams.items())
    clipped = []
    for step in range(5):
        grads = {k: r.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(g) for k, g in
                                   grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
        norm = float(optax.global_norm(
            {k: jnp.asarray(g) for k, g in grads.items()}))
        assert float(topt.last_grad_norm) == pytest.approx(norm, rel=1e-6)
        clipped.append(norm >= clip)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-7,
                                       rtol=0, err_msg=f"{k} step {step}")
    assert topt.count == 5
    assert all(clipped) if clip < 1 else not any(clipped)
    # the norms and the final norm scale decay not; the matrices do
    decay = {id(p) for p in topt.param_groups[0]["params"]}
    assert decay == {id(tparams["wq"]), id(tparams["embed"])}
