"""The port's continuous-batching engine (gke_ray_train_tpu_torch/serve)
at tiny dims on the CPU.

The contract is the JAX package's: every completion is token-identical
to a sequential batch-1 ``greedy_generate_cached`` run — the port's own
and the JAX package's, on the same weights — through a mid-batch refill
and across two buckets. Plus the admission checks, the cache-write
clamp and the prefix memo.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import kvcache as jkv
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.plan import ExecutionPlan as JPlan
from gke_ray_train_tpu.serve import BatchEngine as JEngine
from gke_ray_train_tpu.serve import Request as JRequest
from gke_ray_train_tpu_torch.interop import params_from_numpy
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import kvcache as tkv
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.serve import (
    BatchEngine, Request, form_prompt_buffer)
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


EOS = 5
V = 97


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=64, max_seq_len=256)
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    jp = jtr.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _plan(**kw):
    base = dict(max_batch=2, decode_buckets="128,256")
    base.update(kw)
    return ExecutionPlan.from_kwargs(**base)


def _engine(tp, tc, **kw):
    return BatchEngine(tp, tc, plan=_plan(**kw), eos_ids=(EOS,),
                       device="cpu")


def _requests(spec, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}",
                    token_ids=rng.integers(1, V, size=p).astype(np.int32),
                    max_new_tokens=m)
            for i, (p, m) in enumerate(spec)]


def _port_oracle(tp, tc, req, bucket):
    buf, plen = form_prompt_buffer(req.token_ids, bucket)
    out = tkv.greedy_generate_cached(tp, buf, [plen], tc,
                                     max_new_tokens=req.max_new_tokens,
                                     eos_ids=(EOS,), device="cpu")
    return out[0].numpy()


def _jax_oracle(jp, jc, req, bucket):
    buf, plen = form_prompt_buffer(req.token_ids, bucket)
    out = jkv.greedy_generate_cached(
        jp, jnp.asarray(buf), jnp.asarray([plen], jnp.int32), jc,
        max_new_tokens=req.max_new_tokens, eos_ids=(EOS,))
    return np.asarray(out[0])


def test_engine_matches_sequential_greedy_and_jax(setup):
    """Five requests through two slots per bucket, both buckets: every
    completion equals the port's batch-1 greedy and JAX's, token for
    token, and finished slots were refilled mid-batch."""
    jc, jp, tc, tp = setup
    eng = _engine(tp, tc)
    reqs = _requests([(7, 12), (30, 20), (3, 8), (150, 24), (50, 16),
                      (120, 40)])
    comps = eng.run_until_drained(reqs)
    assert [c.rid for c in comps] == [r.rid for r in reqs]
    assert {c.bucket for c in comps} == {128, 256}
    for r, c in zip(reqs, comps):
        np.testing.assert_array_equal(c.tokens,
                                      _port_oracle(tp, tc, r, c.bucket))
        np.testing.assert_array_equal(c.tokens,
                                      _jax_oracle(jp, jc, r, c.bucket))
        assert 0 < c.length - c.prompt_len <= r.max_new_tokens
    stats = eng.stats()
    assert eng.refills >= 1
    assert stats["completed"] == 6 and stats["pending"] == 0
    assert stats["prefills"] == 6
    assert 0 < stats["batch_occupancy"] <= 1.0
    assert stats["p99_token_latency_s"] >= stats["p50_token_latency_s"]
    assert stats["plan_fingerprint"] == eng.plan.fingerprint()


def test_mid_batch_refill_preserves_survivor(setup):
    """A request admitted into a slot freed mid-decode leaves the
    surviving sequence's tokens unchanged."""
    jc, jp, tc, tp = setup
    eng = _engine(tp, tc, decode_buckets="128")
    short, long_ = _requests([(6, 4), (40, 48)], seed=2)
    eng.submit(short)
    eng.submit(long_)
    while eng.completion(short.rid) is None:
        assert eng.step() > 0
    assert eng.completion(long_.rid) is None
    before = eng.refills
    late = dataclasses.replace(_requests([(17, 10)], seed=9)[0], rid="late")
    eng.submit(late)
    while eng.step() > 0:
        pass
    assert eng.refills > before
    for req in (short, long_, late):
        np.testing.assert_array_equal(eng.completion(req.rid).tokens,
                                      _jax_oracle(jp, jc, req, 128))


def test_submit_rejects_what_jax_rejects(setup):
    jc, jp, tc, tp = setup
    eng = _engine(tp, tc, decode_buckets="128")
    jeng = JEngine(jp, jc, plan=JPlan.from_kwargs(
        max_batch=2, decode_buckets="128", topology="cpu-8",
        compile_cache=False, aot_train_step=False), eos_ids=(EOS,))
    bad = [("big", np.arange(1, 10, dtype=np.int32), 200,
            "largest usable bucket"),
           ("empty", np.zeros((0,), np.int32), 8, "empty prompt"),
           ("none", np.arange(1, 5, dtype=np.int32), 0, "max_new_tokens")]
    for rid, ids, new, msg in bad:
        with pytest.raises(ValueError, match=msg):
            jeng.submit(JRequest(rid, ids, new))
        with pytest.raises(ValueError, match=msg):
            eng.submit(Request(rid, ids, new))
    ok = Request("dup", np.arange(1, 5, dtype=np.int32), 4)
    assert eng.submit(ok) == 128
    with pytest.raises(ValueError, match="unique"):
        eng.submit(ok)


@pytest.mark.parametrize("lens", [[0, 250], [253, 256], [256, 256]])
def test_scatter_rows_clamps_like_dynamic_update_slice(lens):
    """Starts past max_len - T clamp to max_len - T, as JAX's
    dynamic_update_slice does — a done row never writes out of range."""
    r = np.random.default_rng(3)
    cache = r.standard_normal((2, 256, 2, 8)).astype(np.float32)
    new = r.standard_normal((2, 4, 2, 8)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(jkv._scatter_rows(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray(lens)))
    t = torch.from_numpy(cache.copy())
    got = tkv._scatter_rows(t, torch.from_numpy(new), torch.from_numpy(lens))
    assert got.data_ptr() == t.data_ptr()           # written in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefix_memo_hit_reuses_prefill(setup):
    """An identical prompt resubmitted to a prefix-cache engine reuses
    the first prefill (one prefill for two requests) and yields the same
    tokens as a cold engine."""
    jc, jp, tc, tp = setup
    req = _requests([(33, 12)], seed=4)[0]
    again = dataclasses.replace(req, rid="again")
    cold = _engine(tp, tc).run_until_drained([req])[0]
    warm_eng = _engine(tp, tc, prefix_cache=True)
    first = warm_eng.run_until_drained([req])[0]
    second = warm_eng.run_until_drained([again])[0]
    stats = warm_eng.stats()
    assert stats["prefix_hits"] == 1 and stats["prefills"] == 1
    np.testing.assert_array_equal(first.tokens, cold.tokens)
    np.testing.assert_array_equal(second.tokens, cold.tokens)


def test_plan_reads_the_jax_env_keys():
    env = {"MAX_BATCH": "4", "DECODE_BUCKETS": "512, 256,256",
           "PREFIX_CACHE": "1"}
    ours = ExecutionPlan.resolve(env=env)
    theirs = JPlan.resolve(env=env)
    for f in ("max_batch", "decode_buckets", "prefix_cache"):
        assert getattr(ours, f) == getattr(theirs, f)
    assert ours.bucket_list() == theirs.bucket_list() == (256, 512)
    assert ExecutionPlan() == ExecutionPlan.resolve(env={})
    with pytest.raises(ValueError):
        ExecutionPlan.from_kwargs(max_batch=0)
    with pytest.raises(ValueError):
        ExecutionPlan.from_kwargs(decode_buckets="abc")
