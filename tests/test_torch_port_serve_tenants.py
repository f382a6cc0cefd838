"""Multi-tenant and speculative serving of the port
(``gke_ray_train_tpu_torch/serve``, ``ops/lora_batched.py``,
``SERVE_QUANT``) against the JAX package, at tiny dims on the CPU.

The JAX package's contracts (``tests/test_serve.py``, multi-tenant and
speculative sections), on the same seeded weights, adapters and
requests through both packages:

- a mixed-tenant batch equals each tenant's sequential greedy decode and
  JAX's engine token for token, with the same pool counters;
- the zero adapter slot is bitwise the base model;
- the adapter pool's LRU, pinning and pinned retry answer as JAX's pool
  on the same calls;
- self, garbage (a random distilled draft) and adapter-composed
  speculation equal sequential greedy and JAX's speculative engine,
  acceptance counters included; speculative headroom enters admission;
- ``SERVE_QUANT`` int8 / nf4 equal the quantized oracle and JAX's
  engine; ``quantize_for_serving``'s contract;
- the plan's four serving knobs in the three dialects;
- ``post_train_smoke`` serves tagged adapters as JAX's does, and
  degrades;
- ``lora_batched_matmul`` against JAX's within fp32's tolerance.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import kvcache as jkv
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import lora_batched as jlb
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu.plan import ExecutionPlan as JPlan
from gke_ray_train_tpu.serve import AdapterPool as JPool
from gke_ray_train_tpu.serve import AdapterPoolPinned as JPinned
from gke_ray_train_tpu.serve import BatchEngine as JEngine
from gke_ray_train_tpu.serve import Request as JRequest
from gke_ray_train_tpu.serve import post_train_smoke as jsmoke
from gke_ray_train_tpu.train.lora import LoraConfig as JLoraConfig
from gke_ray_train_tpu.train.lora import init_lora as jinit_lora
from gke_ray_train_tpu_torch.ckpt import CheckpointManager
from gke_ray_train_tpu_torch.interop import lora_from_numpy, params_from_numpy
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import kvcache as tkv
from gke_ray_train_tpu_torch.models.transformer import _proj
from gke_ray_train_tpu_torch.ops import lora_batched as tlb
from gke_ray_train_tpu_torch.ops import quant as tquant
from gke_ray_train_tpu_torch.plan import ExecutionPlan, PlanError
from gke_ray_train_tpu_torch.serve import (
    AdapterPool, AdapterPoolPinned, BatchEngine, Request,
    adapter_from_checkpoint, form_prompt_buffer, post_train_smoke)
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


EOS = 5
V = 97
SCALE = 2.0       # LoraConfig(r=2, alpha=4).scale


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=64, max_seq_len=256)
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    jp = jtr.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def tenants(setup):
    """{id: (JAX tree, port adapter)} for three non-identity tenants (B
    drawn nonzero, so each adapter moves the output), as JAX's
    ``tenant_trees`` fixture makes them."""
    jc, _, tc, _ = setup
    lcfg = JLoraConfig(r=2, alpha=4)
    assert lcfg.scale == SCALE

    def mk(seed):
        t = jinit_lora(jc, lcfg, jax.random.key(seed))
        leaves, td = jax.tree.flatten(t)
        ks = jax.random.split(jax.random.key(seed + 1), len(leaves))
        return jax.tree.unflatten(td, [
            0.05 * jax.random.normal(k, leaf.shape, leaf.dtype)
            for k, leaf in zip(ks, leaves)])

    out = {}
    for i in (1, 2, 3):
        jt = mk(20 + 2 * i)
        out[f"t{i}"] = (jt, lora_from_numpy(jax.tree.map(np.asarray, jt), tc,
                                            device="cpu"))
    return out


def _jplan(**kw):
    base = dict(max_batch=2, decode_buckets="128", topology="cpu-8",
                compile_cache=False, aot_train_step=False)
    base.update(kw)
    return JPlan.from_kwargs(**base)


def _plan(**kw):
    base = dict(max_batch=2, decode_buckets="128")
    base.update(kw)
    return ExecutionPlan.from_kwargs(**base)


def _requests(spec, seed):
    """spec = [(prompt_len, max_new, adapter_id), ...]."""
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}",
                    token_ids=rng.integers(1, V, size=p).astype(np.int32),
                    max_new_tokens=m, adapter_id=a)
            for i, (p, m, a) in enumerate(spec)]


def _jreqs(reqs):
    return [JRequest(r.rid, r.token_ids, r.max_new_tokens,
                     adapter_id=r.adapter_id) for r in reqs]


def _oracle(tp, tc, req, lora=None, bucket=128):
    """The port's batch-1 greedy decode with one adapter (or none)."""
    buf, plen = form_prompt_buffer(req.token_ids, bucket)
    out = tkv.greedy_generate_cached(
        tp, buf, [plen], tc, max_new_tokens=req.max_new_tokens,
        eos_ids=(EOS,), lora=lora, lora_scale=SCALE if lora else 1.0,
        device="cpu")
    return out[0].numpy()


def _pools(tenants, max_adapters, register=(), loader=False):
    """The same pool in both packages: (JAX pool, port pool)."""
    jl = (lambda a: tenants[a][0]) if loader else None
    tl = (lambda a: tenants[a][1]) if loader else None
    jpool = JPool.from_template(tenants["t1"][0], max_adapters=max_adapters,
                                loader=jl)
    tpool = AdapterPool.from_template(tenants["t1"][1],
                                      max_adapters=max_adapters, loader=tl)
    for aid in register:
        jpool.register(aid, tenants[aid][0])
        tpool.register(aid, tenants[aid][1])
    return jpool, tpool


def _same_stats(ours, theirs, keys):
    for k in keys:
        assert ours[k] == theirs[k], (k, ours[k], theirs[k])


ADAPTER_KEYS = ("adapter_hits", "adapter_misses", "adapter_evictions",
                "adapter_resident")
SPEC_KEYS = ("spec_proposed", "spec_accepted", "iterations")


# -- multi-tenant decode ------------------------------------------------------

def test_mixed_adapter_batch_matches_per_adapter_oracle_and_jax(
        setup, tenants):
    """Two tenants and the base through two slots, more requests than
    slots, so refills switch the tenant of a slot mid-decode: every
    completion equals its tenant's sequential greedy and JAX's engine,
    with JAX's pool counters."""
    jc, jp, tc, tp = setup
    jpool, tpool = _pools(tenants, 4, register=("t1", "t2"))
    reqs = _requests([(7, 10, "t1"), (25, 12, "t2"), (12, 8, None),
                      (9, 10, "t1"), (30, 14, "t2")], seed=31)
    eng = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,), adapters=tpool,
                      lora_scale=SCALE, device="cpu")
    jeng = JEngine(jp, jc, plan=_jplan(), eos_ids=(EOS,), adapters=jpool,
                   lora_scale=SCALE)
    comps = eng.run_until_drained(reqs)
    jcomps = jeng.run_until_drained(_jreqs(reqs))
    assert eng.refills >= 2
    for r, c, jcomp in zip(reqs, comps, jcomps):
        assert c.adapter_id == jcomp.adapter_id == r.adapter_id
        lora = tenants[r.adapter_id][1] if r.adapter_id else None
        np.testing.assert_array_equal(c.tokens, _oracle(tp, tc, r, lora))
        np.testing.assert_array_equal(c.tokens, jcomp.tokens)
    st = eng.stats()
    _same_stats(st, jeng.stats(), ADAPTER_KEYS + ("iterations", "refills"))
    assert st["adapter_hits"] == 4 and st["adapter_misses"] == 0
    # the tenants really move the output
    assert any(not np.array_equal(c.tokens, _oracle(tp, tc, r))
               for r, c in zip(reqs, comps) if r.adapter_id)


def test_zero_adapter_slot_is_bitwise_base_model(setup, tenants):
    """A request without an adapter on a pooled engine routes to the zero
    slot: bitwise the no-pool engine and the no-LoRA oracle."""
    jc, jp, tc, tp = setup
    _, tpool = _pools(tenants, 2, register=("t1",))
    reqs = _requests([(14, 10, None), (40, 16, "t1"), (3, 12, None)],
                     seed=33)
    pooled = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,),
                         adapters=tpool, lora_scale=SCALE, device="cpu")
    plain = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,), device="cpu")
    got = pooled.run_until_drained(reqs)
    base = [r for r in reqs if r.adapter_id is None]
    want = plain.run_until_drained([dataclasses.replace(r) for r in base])
    for c, w, r in zip([c for c in got if c.adapter_id is None], want, base):
        np.testing.assert_array_equal(c.tokens, w.tokens)
        np.testing.assert_array_equal(c.tokens, _oracle(tp, tc, r))


def test_same_slot_batch_equals_single_adapter_engine(setup, tenants):
    """Every row on one tenant: the pooled engine equals the single
    ``lora=`` engine token for token."""
    jc, jp, tc, tp = setup
    _, tpool = _pools(tenants, 2, register=("t2",))
    reqs = _requests([(11, 12, "t2"), (20, 10, "t2"), (5, 9, "t2")],
                     seed=34)
    pooled = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,),
                         adapters=tpool, lora_scale=SCALE, device="cpu")
    single = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,),
                         lora=tenants["t2"][1], lora_scale=SCALE,
                         device="cpu")
    got = pooled.run_until_drained(reqs)
    want = single.run_until_drained(
        [dataclasses.replace(r, adapter_id=None) for r in reqs])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# -- the adapter pool ---------------------------------------------------------

POOL_SCENARIOS = {
    # JAX's test_adapter_pool_lru_eviction_and_pinning, then more
    "lru_and_pins": [("acquire", None), ("acquire", "t1"), ("acquire", "t2"),
                     ("release", "t1"), ("acquire", "t3"), ("acquire", "t2"),
                     ("acquire", "t1"), ("register", "t2"),
                     ("release", "t3"), ("acquire", "t1")],
    "nested_pins": [("acquire", "t1"), ("acquire", "t1"), ("acquire", "t2"),
                    ("release", "t1"), ("acquire", "t3"), ("release", "t1"),
                    ("acquire", "t3"), ("release", "t2"), ("acquire", "t1"),
                    ("release", None), ("slot_of", "t2")],
    "no_loader_miss": [("register", "t1"), ("acquire", "t1"),
                       ("acquire", "t2"), ("register", "t2"),
                       ("register", "t3"), ("release", "t1"),
                       ("register", "t3"), ("slot_of", "t1")],
}


def _drive_pool(pool, tenants_side, calls, pinned_exc):
    """Each call's answer: a slot, or the exception class's role."""
    out = []
    for op, aid in calls:
        try:
            if op == "acquire":
                v = pool.acquire(aid)
            elif op == "release":
                v = pool.release(aid)
            elif op == "slot_of":
                v = pool.slot_of(aid)
            else:
                v = pool.register(aid, tenants_side[aid])
        except pinned_exc:
            v = "pinned"
        except KeyError:
            v = "missing"
        except ValueError:
            v = "immutable"
        out.append((v, dict(pool.resident()), pool.stats()))
    return out


@pytest.mark.parametrize("name", sorted(POOL_SCENARIOS))
def test_adapter_pool_answers_as_jax_pool(tenants, name):
    """The same calls on both pools (loader-backed misses, LRU eviction,
    pins, the zero slot, immutable ids, a pool with no loader): the same
    slots, residency, counters and refusals after every call."""
    loader = name != "no_loader_miss"
    jpool, tpool = _pools(tenants, 2, loader=loader)
    calls = POOL_SCENARIOS[name]
    ours = _drive_pool(tpool, {k: v[1] for k, v in tenants.items()}, calls,
                       AdapterPoolPinned)
    theirs = _drive_pool(jpool, {k: v[0] for k, v in tenants.items()},
                         calls, JPinned)
    assert ours == theirs
    assert any(v == "pinned" for v, _, _ in ours) or name == "no_loader_miss"


def test_adapter_pool_writes_slots_and_keeps_zero_slot(setup, tenants):
    """Slot 0 stays zero; a registered tenant's slot holds its tensors,
    the layout JAX's pool holds at axis 1; a wrong shape fails loudly."""
    P = len(setup[2].block_pattern)
    jpool, tpool = _pools(tenants, 2, register=("t1", "t3"))
    for i, layer in enumerate(tpool.blocks):
        r, p = i // P, i % P
        for name, leaf in layer.items():
            for ab, t in leaf.items():
                assert t.shape[0] == 3 and not t[0].any()
                want = np.asarray(jpool.blocks[p][name][ab])[r]
                np.testing.assert_array_equal(t.numpy(), want)
    assert tpool.nbytes() == sum(
        np.asarray(x).nbytes for x in jax.tree.leaves(jpool.blocks))
    bad = [{n: {"a": torch.zeros(3, 2), "b": torch.zeros(2, 3)}
            for n in layer} for layer in tenants["t2"][1]]
    with pytest.raises(ValueError, match="shape"):
        tpool.register("bad", bad)
    with pytest.raises(ValueError, match="max_adapters"):
        AdapterPool(tenants["t1"][1], max_adapters=0)


def test_engine_retries_admission_when_pool_pinned(setup, tenants):
    """One tenant slot pinned by an in-flight request: a second tenant's
    request stays pending, then is admitted by evicting the retired
    tenant, as in JAX's engine, with the same counters."""
    jc, jp, tc, tp = setup
    jpool, tpool = _pools(tenants, 1, loader=True)
    r1, r2 = _requests([(10, 12, "t1"), (8, 6, "t2")], seed=35)
    eng = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,), adapters=tpool,
                      lora_scale=SCALE, device="cpu")
    jeng = JEngine(jp, jc, plan=_jplan(), eos_ids=(EOS,), adapters=jpool,
                   lora_scale=SCALE)
    for e, reqs in ((eng, (r1, r2)), (jeng, _jreqs((r1, r2)))):
        for r in reqs:
            e.submit(r)
        e.step()
    assert eng.completion(r2.rid) is None
    assert eng.stats()["pending"] == jeng.stats()["pending"] == 1
    ours = {c.rid: c for c in eng.run_until_drained()}
    theirs = {c.rid: c for c in jeng.run_until_drained()}
    assert set(ours) == {r1.rid, r2.rid}
    for r in (r1, r2):
        np.testing.assert_array_equal(ours[r.rid].tokens,
                                      theirs[r.rid].tokens)
        np.testing.assert_array_equal(
            ours[r.rid].tokens, _oracle(tp, tc, r, tenants[r.adapter_id][1]))
    st = eng.stats()
    _same_stats(st, jeng.stats(), ADAPTER_KEYS + ("iterations",))
    assert st["adapter_evictions"] == 1 and st["adapter_misses"] == 2


def test_adapter_from_checkpoint_feeds_the_pool(setup, tenants, tmp_path):
    """A checkpoint of a train state's adapters, read back topology-free
    (``restore_raw``) by ``adapter_from_checkpoint`` as a pool loader."""
    jc, jp, tc, tp = setup
    lora = tenants["t3"][1]
    state = {"step": 7, "lora": {f"{i}.{n}.{ab}": t for i, layer in
                                 enumerate(lora) for n, leaf in layer.items()
                                 for ab, t in leaf.items()}}
    mgr = CheckpointManager(str(tmp_path / "t3"), score_attribute=None)
    mgr.save(7, state, force=True)
    mgr.wait()
    raw = CheckpointManager(str(tmp_path / "t3")).restore_raw()
    assert raw["step"] == 7
    got = adapter_from_checkpoint(str(tmp_path / "t3"), device="cpu")
    for a, b in zip(got, lora):
        assert set(a) == set(b)
        for n in a:
            for ab in ("a", "b"):
                assert torch.equal(a[n][ab], b[n][ab])
    pool = AdapterPool.from_template(
        lora, max_adapters=1,
        loader=lambda aid: adapter_from_checkpoint(str(tmp_path / aid),
                                                   device="cpu"))
    assert pool.acquire("t3") == 1 and pool.stats()["adapter_misses"] == 1
    CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        adapter_from_checkpoint(str(tmp_path / "empty"), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "nolora"), score_attribute=None)
    mgr.save(1, {"step": 1, "x": torch.zeros(2)}, force=True)
    mgr.wait()
    with pytest.raises(ValueError, match="no 'lora'"):
        adapter_from_checkpoint(str(tmp_path / "nolora"), device="cpu")


# -- speculative decoding -----------------------------------------------------

def _spec_pair(setup, reqs, spec_kw, jdraft=None, tdraft=None, pools=None,
               plain_lora=False):
    jc, jp, tc, tp = setup
    jkw = {"draft": jdraft} if jdraft is not None else {}
    tkw = {"draft": tdraft} if tdraft is not None else {}
    if pools is not None:
        jkw["adapters"], tkw["adapters"] = pools
        jkw["lora_scale"] = tkw["lora_scale"] = SCALE
    eng = BatchEngine(tp, tc, plan=_plan(**spec_kw), eos_ids=(EOS,),
                      device="cpu", **tkw)
    jeng = JEngine(jp, jc, plan=_jplan(**spec_kw), eos_ids=(EOS,), **jkw)
    return (eng, eng.run_until_drained(reqs),
            jeng, jeng.run_until_drained(_jreqs(reqs)))


def test_speculative_self_draft_matches_sequential_and_jax(setup):
    """SPEC_DRAFT=self: the plain engine's streams, in fewer iterations,
    with JAX's acceptance counters."""
    jc, jp, tc, tp = setup
    reqs = _requests([(7, 12, None), (20, 10, None), (12, 14, None)],
                     seed=39)
    plain = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,), device="cpu")
    comps_p = plain.run_until_drained([dataclasses.replace(r) for r in reqs])
    eng, comps, jeng, jcomps = _spec_pair(
        setup, reqs, dict(spec_draft="self", spec_k=3))
    for p, c, j in zip(comps_p, comps, jcomps):
        np.testing.assert_array_equal(c.tokens, p.tokens)
        np.testing.assert_array_equal(c.tokens, j.tokens)
    st = eng.stats()
    _same_stats(st, jeng.stats(), SPEC_KEYS)
    assert st["iterations"] < plain.stats()["iterations"]
    assert 0 < st["spec_accepted"] <= st["spec_proposed"]
    assert "spec_proposed" not in plain.stats()


def test_speculative_garbage_draft_still_matches(setup):
    """A distilled draft of random weights and 2 layers of its own
    proposes mostly wrong tokens: the streams stay sequential greedy's
    and JAX's, and the counters are JAX's."""
    jc, jp, tc, tp = setup
    dkw = dict(vocab_size=V, d_model=16, n_layers=2, n_heads=2,
               n_kv_heads=1, d_ff=32, max_seq_len=256)
    djc, dtc = jcfg.tiny(**dkw), tcfg.tiny(**dkw)
    djp = jtr.init_params(djc, jax.random.key(99))
    dtp = params_from_numpy(jax.tree.map(np.asarray, djp), dtc,
                            device="cpu")
    reqs = _requests([(9, 10, None), (16, 8, None), (30, 12, None)],
                     seed=41)
    eng, comps, jeng, jcomps = _spec_pair(
        setup, reqs, dict(spec_draft="distilled", spec_k=3),
        jdraft=(djp, djc), tdraft=(dtp, dtc))
    for r, c, j in zip(reqs, comps, jcomps):
        np.testing.assert_array_equal(c.tokens, _oracle(tp, tc, r))
        np.testing.assert_array_equal(c.tokens, j.tokens)
    st = eng.stats()
    _same_stats(st, jeng.stats(), SPEC_KEYS)
    assert st["spec_accepted"] < st["spec_proposed"]


def test_speculation_composes_with_adapters(setup, tenants):
    """Speculation and the pool together: the draft proposes without
    adapters, the pooled target verifies per tenant; the streams are the
    per-adapter oracle's and JAX's."""
    jc, jp, tc, tp = setup
    reqs = _requests([(11, 10, "t1"), (19, 8, None), (6, 9, "t1")],
                     seed=43)
    eng, comps, jeng, jcomps = _spec_pair(
        setup, reqs, dict(spec_draft="self", spec_k=2),
        pools=_pools(tenants, 2, register=("t1",)))
    for r, c, j in zip(reqs, comps, jcomps):
        lora = tenants[r.adapter_id][1] if r.adapter_id else None
        np.testing.assert_array_equal(c.tokens, _oracle(tp, tc, r, lora))
        np.testing.assert_array_equal(c.tokens, j.tokens)
    _same_stats(eng.stats(), jeng.stats(), SPEC_KEYS + ADAPTER_KEYS)


def test_speculative_headroom_enters_admission(setup, caplog):
    """Routing budgets prompt + max_new + SPEC_K: a prompt that fits a
    plain engine's bucket exactly is truncated loudly on the speculative
    engine, with the tightened budget named; the rejection names
    spec_k."""
    jc, jp, tc, tp = setup
    req = Request("tight", np.arange(1, 109, dtype=np.int32), 20)
    plain = BatchEngine(tp, tc, plan=_plan(), eos_ids=(EOS,), device="cpu")
    with caplog.at_level(logging.WARNING):
        assert plain.submit(req) == 128
    assert not any("DROPPED" in r.message for r in caplog.records)
    caplog.clear()
    spec = BatchEngine(tp, tc, plan=_plan(spec_draft="self", spec_k=4),
                       eos_ids=(EOS,), device="cpu")
    with caplog.at_level(logging.WARNING):
        assert spec.submit(req) == 128
    assert any("104-token budget" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="spec_k=4"):
        spec.submit(Request("big", np.arange(1, 5, dtype=np.int32), 124))


def test_engine_refuses_bad_serving_arguments(setup, tenants):
    jc, jp, tc, tp = setup
    _, tpool = _pools(tenants, 1)
    with pytest.raises(ValueError, match="not both"):
        BatchEngine(tp, tc, plan=_plan(), lora=tenants["t1"][1],
                    adapters=tpool, device="cpu")
    with pytest.raises(ValueError, match="draft="):
        BatchEngine(tp, tc, plan=_plan(spec_draft="distilled"),
                    device="cpu")
    other = dataclasses.replace(tc, vocab_size=V + 1)
    with pytest.raises(ValueError, match="vocab"):
        BatchEngine(tp, tc, plan=_plan(spec_draft="distilled"),
                    draft=(tp, other), device="cpu")
    short = dataclasses.replace(tc, max_seq_len=128)
    eng = BatchEngine(tp, tc, plan=_plan(spec_draft="distilled",
                                         decode_buckets="128,256"),
                      draft=(tp, short), device="cpu")
    assert eng.buckets == [128]
    plain = BatchEngine(tp, tc, plan=_plan(), device="cpu")
    with pytest.raises(ValueError, match="no adapter pool"):
        plain.submit(Request("x", np.arange(1, 5, dtype=np.int32), 4,
                             adapter_id="t1"))


def test_prefix_memo_keys_on_the_tenant(setup, tenants):
    """The same prompt under two tenants prefills twice; under one tenant
    once; each completion equals its tenant's oracle."""
    jc, jp, tc, tp = setup
    _, tpool = _pools(tenants, 2, register=("t1", "t2"))
    eng = BatchEngine(tp, tc, plan=_plan(prefix_cache=True), eos_ids=(EOS,),
                      adapters=tpool, lora_scale=SCALE, device="cpu")
    base = _requests([(18, 8, None)], seed=37)[0]
    reqs = [dataclasses.replace(base, rid=f"p{i}", adapter_id=a)
            for i, a in enumerate(("t1", "t2", "t1"))]
    comps = eng.run_until_drained(reqs)
    st = eng.stats()
    assert st["prefix_hits"] == 1 and st["prefills"] == 2
    for r, c in zip(reqs, comps):
        np.testing.assert_array_equal(
            c.tokens, _oracle(tp, tc, r, tenants[r.adapter_id][1]))


def test_warm_up_counts_nothing_and_heartbeat_beats(setup, tenants):
    jc, jp, tc, tp = setup
    _, tpool = _pools(tenants, 1, register=("t1",))
    eng = BatchEngine(tp, tc, plan=_plan(spec_draft="self", spec_k=2,
                                         decode_buckets="128,256"),
                      eos_ids=(EOS,), adapters=tpool, lora_scale=SCALE,
                      device="cpu")
    eng.warm_up()
    st = eng.stats()
    assert st["prefills"] == st["iterations"] == st["spec_proposed"] == 0
    beats = []
    eng.set_heartbeat(beats.append)
    comps = eng.run_until_drained(_requests([(5, 6, "t1")], seed=3))
    assert beats == list(range(1, eng.iterations + 1))
    np.testing.assert_array_equal(
        comps[0].tokens,
        _oracle(tp, tc, _requests([(5, 6, "t1")], seed=3)[0],
                tenants["t1"][1]))

    def broken(i):
        raise RuntimeError("sink down")
    eng.set_heartbeat(broken)       # a lost beat never fails serving
    eng.run_until_drained(_requests([(5, 3, None)], seed=4))


# -- quantized serving --------------------------------------------------------

@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_quantized_serving_matches_quantized_oracle_and_jax(setup, kind):
    """SERVE_QUANT quantizes at construction: the completions equal the
    sequential oracle on the same quantized model, and JAX's engine."""
    jc, jp, tc, tp = setup
    reqs = _requests([(12, 10, None), (33, 12, None), (4, 9, None)],
                     seed=8)
    eng = BatchEngine(tp, tc, plan=_plan(serve_quant=kind), eos_ids=(EOS,),
                      device="cpu")
    jeng = JEngine(jp, jc, plan=_jplan(serve_quant=kind), eos_ids=(EOS,))
    qtp = tquant.quantize_for_serving(tp, kind)
    comps = eng.run_until_drained(reqs)
    jcomps = jeng.run_until_drained(_jreqs(reqs))
    for r, c, j in zip(reqs, comps, jcomps):
        np.testing.assert_array_equal(c.tokens, _oracle(qtp, tc, r))
        np.testing.assert_array_equal(c.tokens, j.tokens)
    assert tquant.is_qtensor(eng.params.blocks[0].wq)
    assert not tquant.is_qtensor(tp.blocks[0].wq)


def test_quantize_for_serving_contract(setup):
    """``none`` passes the model itself; an unknown kind raises; nf4
    returns a new model with JAX's codes and scales, sharing the rest,
    and leaves the original unquantized; a quantized base stays."""
    jc, jp, tc, tp = setup
    assert tquant.quantize_for_serving(tp, "none") is tp
    assert tquant.quantize_for_serving(tp, None) is tp
    with pytest.raises(ValueError, match="serve quant kind"):
        tquant.quantize_for_serving(tp, "fp4")
    assert tquant.SERVE_QUANT_KINDS == jquant.SERVE_QUANT_KINDS
    q = tquant.quantize_for_serving(tp, "NF4")
    jq = jquant.quantize_for_serving(jp, "nf4")
    for name in tquant.QUANT_TARGETS:
        assert not tquant.is_qtensor(getattr(tp.blocks[1], name))
        qt = getattr(q.blocks[1], name)
        jt = jq["blocks"][0][name]
        np.testing.assert_array_equal(qt.codes.numpy(),
                                      np.asarray(jt.codes)[1])
        np.testing.assert_array_equal(qt.scales.numpy(),
                                      np.asarray(jt.scales)[1])
    assert q.embed is tp.embed and q.blocks[0].attn_norm is \
        tp.blocks[0].attn_norm
    again = tquant.quantize_for_serving(q, "int8")
    assert again.blocks[0].wq is q.blocks[0].wq
    assert again.blocks[0].wq.kind == "nf4"


# -- the plan's serving knobs -------------------------------------------------

KNOBS = [("serve_quant", "SERVE_QUANT", "INT8", "int8", "fp4"),
         ("max_adapters", "MAX_ADAPTERS", "4", 4, 0),
         ("spec_draft", "SPEC_DRAFT", "SELF", "self", "oracle"),
         ("spec_k", "SPEC_K", "3", 3, 0)]


@pytest.mark.parametrize("field,key,text,value,bad", KNOBS)
def test_serving_knob_three_dialects_as_jax(field, key, text, value, bad):
    """Each knob: the same value from kwargs, config and env in both
    packages, the same default, it moves the fingerprint, and a bad
    value raises naming the field."""
    ours = {ExecutionPlan.from_kwargs(**{field: value}),
            ExecutionPlan.from_config({key: text}),
            ExecutionPlan.resolve(env={key: text})}
    assert len(ours) == 1
    (plan,) = ours
    assert getattr(plan, field) == value == getattr(
        JPlan.resolve(env={key: text}), field)
    assert getattr(ExecutionPlan(), field) == getattr(JPlan(), field)
    assert plan.fingerprint() != ExecutionPlan().fingerprint()
    with pytest.raises(PlanError, match=field):
        ExecutionPlan.from_kwargs(**{field: bad})
    with pytest.raises(Exception, match=field):
        JPlan.from_kwargs(**{field: bad})


def test_disabled_spellings_and_defaults():
    for off in ("", "0", "false", "off"):
        assert ExecutionPlan.from_config({"SPEC_DRAFT": off}).spec_draft \
            == JPlan.from_config({"SPEC_DRAFT": off}).spec_draft == "none"
        assert ExecutionPlan.resolve(env={"SERVE_QUANT": off}).serve_quant \
            == "none"
    cfg_plan = ExecutionPlan.from_config(
        {"MAX_ADAPTERS": "4", "PREFIX_CACHE": "1", "SPEC_DRAFT": "SELF",
         "SPEC_K": "3", "SERVE_QUANT": "nf4"})
    kw_plan = ExecutionPlan.from_kwargs(
        max_adapters=4, prefix_cache=True, spec_draft="self", spec_k=3,
        serve_quant="nf4")
    assert cfg_plan.fingerprint() == kw_plan.fingerprint()


# -- the post-train smoke -----------------------------------------------------

def test_post_train_smoke_serves_tagged_adapters_as_jax(setup, tenants):
    """Tagged prompts go through a real AdapterPool: the same completions
    and tenant counts as JAX's smoke, the tagged one through the
    adapter."""
    jc, jp, tc, tp = setup
    prompts = [np.arange(1, 20, dtype=np.int32),
               np.arange(1, 9, dtype=np.int32)]
    out = post_train_smoke(tp, tc, _plan(), prompts, eos_ids=(EOS,),
                           max_new_tokens=6, lora=tenants["t1"][1],
                           lora_scale=SCALE, adapter_ids=["tuned", None],
                           device="cpu")
    jout = jsmoke(jp, jc, _jplan(), prompts, eos_ids=(EOS,),
                  max_new_tokens=6, lora=tenants["t1"][0], lora_scale=SCALE,
                  adapter_ids=["tuned", None])
    assert out is not None and jout is not None
    (comps, stats), (jcomps, jstats) = out, jout
    assert [c.adapter_id for c in comps] == ["tuned", None]
    for c, j in zip(comps, jcomps):
        np.testing.assert_array_equal(c.tokens, j.tokens)
    for k in ("adapter_requests", "generated_tokens", "completed",
              "iterations") + ADAPTER_KEYS:
        assert stats[k] == jstats[k], k
    assert stats["adapter_requests"] == 1
    np.testing.assert_array_equal(
        comps[0].tokens,
        _oracle(tp, tc, Request("o", prompts[0], 6), tenants["t1"][1]))


def test_post_train_smoke_degrades(setup, tenants, caplog):
    """No bucket fits, no usable prompt, or serving fails: None and a
    loud warning, never a raise; untagged prompts ignore the adapter
    pool."""
    jc, jp, tc, tp = setup
    with caplog.at_level(logging.WARNING):
        assert post_train_smoke(tp, tc, _plan(decode_buckets="4096"),
                                [np.arange(1, 9, dtype=np.int32)],
                                device="cpu") is None
        assert post_train_smoke(tp, tc, _plan(),
                                [np.zeros((0,), np.int32)],
                                device="cpu") is None
        # a template that is not an adapter: the pool build fails
        assert post_train_smoke(tp, tc, _plan(),
                                [np.arange(1, 9, dtype=np.int32)],
                                lora=[{"wq": {"a": torch.zeros(3, 2)}}],
                                adapter_ids=["x"], device="cpu") is None
    msgs = [r.message for r in caplog.records]
    assert sum("SERVE_AFTER_TRAIN skipped" in m for m in msgs) == 2
    assert any("SERVE_AFTER_TRAIN failed" in m for m in msgs)
    out = post_train_smoke(tp, tc, _plan(),
                           [np.arange(1, 9, dtype=np.int32)],
                           eos_ids=(EOS,), max_new_tokens=300,
                           lora=tenants["t2"][1], lora_scale=SCALE,
                           device="cpu")
    comps, stats = out
    assert stats["adapter_requests"] == 0 and "adapter_hits" not in stats
    assert comps[0].length - comps[0].prompt_len <= 127


# -- the batched LoRA op ------------------------------------------------------

@pytest.mark.parametrize("T,dtype,tol", [(1, "float32", 1e-6),
                                         (8, "float32", 1e-6),
                                         (1, "bfloat16", 1e-2)])
def test_lora_batched_matmul_matches_jax(T, dtype, tol):
    """The port's gather + bgmv against JAX's on the same pools and slot
    indices (slot 0 the zero adapter): within fp32's tolerance, bf16's
    rounding otherwise; zero-slot rows exactly zero."""
    rng = np.random.default_rng(T)
    B, d_in, d_out, r, A = 5, 32, 48, 4, 3
    x = (rng.standard_normal((B, T, d_in)) * 0.5).astype(np.float32)
    a = (rng.standard_normal((A, d_in, r)) / 2).astype(np.float32)
    b = (rng.standard_normal((A, r, d_out)) * 0.5).astype(np.float32)
    a[0] = b[0] = 0.0
    aslot = np.array([0, 2, 1, 2, 0], np.int32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jlb.lora_batched_matmul(
        jnp.asarray(x).astype(jdt), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(aslot), scale=0.5, dtype=jdt).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tlb.lora_batched_matmul(
        torch.from_numpy(x).to(tdt), torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(aslot), scale=0.5,
        dtype=tdt)
    assert got.dtype == tdt and got.shape == (B, T, d_out)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert not got[aslot == 0].any()


def test_bgmv_rows_equal_the_single_adapter_projection():
    """Each row of a batched bypass equals ``_proj``'s single-adapter
    branch on that row (the sequential per-request oracle), fp32, within
    rounding of a batched against a single product."""
    g = torch.Generator().manual_seed(0)
    B, T, d_in, d_out, r = 4, 3, 32, 24, 4
    x = torch.randn(B, T, d_in, generator=g)
    w = torch.randn(d_in, d_out, generator=g) * 0.1
    a = torch.randn(B, d_in, r, generator=g)
    b = torch.randn(B, r, d_out, generator=g)
    got = _proj(x, w, {"a": a, "b": b}, 0.5, torch.float32)
    for i in range(B):
        want = _proj(x[i:i + 1], w, {"a": a[i], "b": b[i]}, 0.5,
                     torch.float32)
        torch.testing.assert_close(got[i:i + 1], want, rtol=1e-6,
                                   atol=1e-6)
