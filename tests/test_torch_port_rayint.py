"""The port's trainer (``gke_ray_train_tpu_torch/rayint/trainer.py``,
``TorchTrainer``) against the JAX package's ``JaxTrainer`` on the CPU:

- the local fit of the same tiny job (each package's loop, checkpoint
  manager and fault injector; the same ``FAULT_SPEC``) gives the same
  ``Result`` in each scenario: clean, a kill with a failure budget of 1
  and of 0, a SIGTERM, a SIGTERM past the preemption budget, a
  ``ValueError`` (fails fast), a ``CheckpointRestoreError`` over a
  ``ValueError`` (retried), a hang under a heartbeat. Compared: status,
  attempts, preemptions, each attempt's status, step and resumed step,
  the error (its clock readings masked);
- the backoff sequence under the same seeded jitter;
- the failed attempt's frames are released before the next;
- the Ray fit through the fake Ray API (``tests/_torch_fake_ray.py``):
  ``{"GPU": 1}`` bundles and ``num_gpus``, the rendezvous env per rank
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
  ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; a node's cards shared), per-rank
  error attribution, a preemption not counted, a stall killed naming the
  rank, an elastic shrink starting fewer workers;
- the obs / autotune knobs raise naming item 9;
- ``ServeDeployment``'s in-process replicas against JAX's on the same
  tiny fp32 model, token for token, the board naming a wedged replica.
"""

import gc
import os
import random
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.ckpt import CheckpointManager as JManager
from gke_ray_train_tpu.ckpt.manager import (
    CheckpointRestoreError as JRestoreError)
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.rayint import trainer as jtrainer
from gke_ray_train_tpu.rayint.context import get_context as jctx
from gke_ray_train_tpu.testing import faults as jfaults
from gke_ray_train_tpu.train import loop as jloop
from gke_ray_train_tpu.train import preempt as jpreempt
from gke_ray_train_tpu_torch.ckpt import CheckpointManager
from gke_ray_train_tpu_torch.ckpt.manager import CheckpointRestoreError
from gke_ray_train_tpu_torch.models import tiny
from gke_ray_train_tpu_torch.rayint import (
    FailureConfig, RunConfig, ScalingConfig, TorchTrainer, get_context)
from gke_ray_train_tpu_torch.rayint import serving as tserving
from gke_ray_train_tpu_torch.rayint import supervisor as tsup
from gke_ray_train_tpu_torch.rayint import trainer as ttrainer
from gke_ray_train_tpu_torch.testing import faults
from gke_ray_train_tpu_torch.train import (
    make_optimizer, make_train_state, make_train_step, preempt)
from gke_ray_train_tpu_torch.train.loop import run_training
from tests import _torch_fake_ray as fake
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fault and preemption state is process-global, and the Ray fit's
    in-process workers write their env into os.environ."""
    env = dict(os.environ)
    monkeypatch.delenv("FAULT_SPEC", raising=False)
    for mod in (faults, jfaults):
        mod.reset_fired()
        mod.reset_pool()
    for p in (preempt, jpreempt):
        p.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset_fired()
        mod.reset_pool()
    for p in (preempt, jpreempt):
        p.reset()
        p.uninstall()
    os.environ.clear()
    os.environ.update(env)


def _np_batches(epoch, n=4, B=2, S=8, V=64):
    rng = np.random.default_rng(epoch)
    for _ in range(n):
        yield {"inputs": rng.integers(0, V, (B, S)).astype(np.int32),
               "targets": rng.integers(0, V, (B, S)).astype(np.int32),
               "weights": np.ones((B, S), np.float32)}


def _port_worker(ckpt_dir, *, ckpt_every=None, epochs=1, heartbeat=False):
    def worker(config):
        cfg = tiny(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                   n_kv_heads=2, d_ff=64)
        opt = make_optimizer(1e-3)
        state = make_train_state(cfg, opt, seed=0, device="cpu")
        step = make_train_step(cfg, opt, device="cpu")
        mgr = CheckpointManager(ckpt_dir, max_to_keep=4,
                                score_attribute=None)
        try:
            final, metrics = run_training(
                state, step, _np_batches, epochs=epochs, ckpt_manager=mgr,
                ckpt_every=ckpt_every,
                heartbeat_fn=get_context().heartbeat if heartbeat else None)
        finally:
            mgr.close()
        return {"final_step": int(final.step)}
    return worker


def _jax_worker(ckpt_dir, *, ckpt_every=None, epochs=1, heartbeat=False):
    from gke_ray_train_tpu.train import (
        make_optimizer as jopt, make_train_state as jstate,
        make_train_step as jstep)

    def worker(config):
        cfg = jcfg.tiny(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                        n_kv_heads=2, d_ff=64, dtype="float32",
                        param_dtype="float32")
        opt = jopt(1e-3)
        state = jstate(cfg, opt, jax.random.key(0))
        step = jstep(cfg, opt, donate=False)
        mgr = JManager(ckpt_dir, max_to_keep=4, async_save=False,
                       score_attribute=None)

        def batches(e):
            for b in _np_batches(e):
                yield {k: jnp.asarray(v) for k, v in b.items()}
        try:
            final, metrics = jloop.run_training(
                state, step, batches, epochs=epochs, ckpt_manager=mgr,
                ckpt_every=ckpt_every,
                heartbeat_fn=jctx().heartbeat if heartbeat else None)
        finally:
            mgr.close()
        return {"final_step": int(jax.device_get(final.step))}
    return worker


def _restore_error_worker(err_cls):
    calls = {"n": 0}

    def worker(config):
        calls["n"] += 1
        if calls["n"] == 1:
            try:
                raise ValueError("torn read")
            except ValueError as v:
                raise err_cls("step 5 failed to restore") from v
        return {"ok": 1}
    return worker


def _mask(text):
    """The error's clock readings (a stall's age, a save's seconds)."""
    return re.sub(r"\d+\.\d+s\b", "Ns", text) if text else text


def _summary(res):
    err = _mask(res.error)
    return {"status": res.status, "attempts": res.attempts,
            "preemptions": res.preemptions, "error": err,
            "metrics": res.metrics,
            "log": [(e["status"], e.get("step"), e.get("resumed_step"),
                     e.get("nonretryable"),
                     _mask(e.get("error", "")))
                    for e in res.attempt_log]}


SCENARIOS = {
    "clean": (None, dict(), dict()),
    "kill_budget_1": ("rank=0:kind=kill:step=5", dict(max_failures=1),
                      dict(ckpt_every=2, epochs=2)),
    "kill_budget_0": ("rank=0:kind=kill:step=2", dict(), dict()),
    "sigterm": ("rank=0:kind=sigterm:step=3",
                dict(max_failures=0, max_preemptions=2), dict()),
    "sigterm_exhausted": ("rank=0:kind=sigterm:step=2",
                          dict(max_failures=3, max_preemptions=0), dict()),
    "value_error": (None, dict(max_failures=3), "value_error"),
    "restore_error": (None, dict(max_failures=1), "restore_error"),
    "hang": ("rank=0:kind=hang:step=2:seconds=30", dict(max_failures=0),
             dict(heartbeat=True)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_local_fit_gives_the_jax_result(name, tmp_path, monkeypatch):
    spec, budgets, job = SCENARIOS[name]
    results = {}
    for pkg, Trainer, RC, FC, make in (
            ("jax", jtrainer.JaxTrainer, jtrainer.RunConfig,
             jtrainer.FailureConfig, _jax_worker),
            ("port", TorchTrainer, RunConfig, FailureConfig, _port_worker)):
        for mod in (faults, jfaults):
            mod.reset_fired()
        if spec:
            monkeypatch.setenv("FAULT_SPEC", spec)
        if job == "value_error":
            def fn(config):
                raise ValueError("MODEL_ID is not a model")
        elif job == "restore_error":
            fn = _restore_error_worker(
                JRestoreError if pkg == "jax" else CheckpointRestoreError)
        else:
            fn = make(str(tmp_path / pkg), **job)
        rc = RC(failure_config=FC(**budgets), retry_backoff_s=0.0,
                heartbeat_timeout_s=1.5 if name == "hang" else None)
        results[pkg] = _summary(Trainer(fn, run_config=rc,
                                        use_ray=False).fit())
        monkeypatch.delenv("FAULT_SPEC", raising=False)
    assert results["port"] == results["jax"]


def test_backoff_under_the_same_seeded_jitter(monkeypatch):
    delays = {}
    for pkg, mod in (("jax", jtrainer), ("port", ttrainer)):
        got = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        calls = {"n": 0}

        def flaky(config):
            calls["n"] += 1
            if calls["n"] < 4:
                raise RuntimeError("transient")
            return {"ok": 1}
        random.seed(1234)
        trainer = (mod.JaxTrainer if pkg == "jax" else mod.TorchTrainer)
        res = trainer(flaky, use_ray=False, run_config=mod.RunConfig(
            failure_config=mod.FailureConfig(max_failures=3),
            retry_backoff_s=1.5)).fit()
        assert res.error is None and res.attempts == 4
        delays[pkg] = got
    assert delays["port"] == delays["jax"] and len(delays["port"]) == 3
    assert 0.75 <= delays["port"][0] < 2.25


def test_a_failed_attempt_releases_its_frames():
    """The state a failed attempt held dies before the next attempt runs:
    its exception's frames are cleared."""
    refs = []

    def worker(config):
        big = torch.zeros(1024)
        refs.append(weakref.ref(big))
        if len(refs) == 1:
            raise RuntimeError("boom")
        gc.collect()
        assert refs[0]() is None, "attempt 1's tensor is still alive"
        return {"ok": 1}
    res = TorchTrainer(worker, use_ray=False, run_config=RunConfig(
        failure_config=FailureConfig(max_failures=1),
        retry_backoff_s=0.0)).fit()
    assert res.error is None and res.attempts == 2


@pytest.mark.parametrize("key,value", [
    ("OBS", "1"), ("OBS_DIR", "/tmp/obs"), ("TRACE", "true"),
    ("AUTOTUNE", "1"), ("OBS_CAPTURE", "on")])
def test_item9_knobs_raise(key, value, monkeypatch):
    res = TorchTrainer(lambda c: {"ok": 1}, train_loop_config={key: value},
                       use_ray=False).fit()
    assert res.status == "failed" and "item 9" in res.error
    assert res.attempt_log[0]["nonretryable"] is True
    monkeypatch.setenv(key, value)
    res = TorchTrainer(lambda c: {"ok": 1}, use_ray=False).fit()
    assert "item 9" in res.error
    monkeypatch.setenv(key, "0" if key != "OBS_DIR" else "")
    assert TorchTrainer(lambda c: {"ok": 1}, use_ray=False).fit().error \
        is None


def test_scaling_config_is_one_worker_per_card(monkeypatch):
    monkeypatch.setenv("NUM_NODES", "2")
    monkeypatch.setenv("NUM_GPUS_PER_NODE", "4")
    sc = ScalingConfig.from_env()
    assert sc.num_workers == 8 and sc.resources_per_worker == {"GPU": 1}


# -- the Ray path, through the fake Ray API ------------------------------------

@pytest.fixture
def fake_ray(monkeypatch):
    return fake.install(monkeypatch, ttrainer, tserving)


def test_fit_ray_gpu_bundles_and_rendezvous_env(fake_ray):
    seen = []

    def worker_fn(config):
        seen.append({k: os.environ.get(k) for k in (
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE", "CUDA_VISIBLE_DEVICES")})
        return {"loss": 1.0 + float(os.environ["RANK"])}
    res = TorchTrainer(worker_fn, train_loop_config={"X": 1},
                       scaling_config=ScalingConfig(num_workers=2),
                       use_ray=True).fit()
    assert res.error is None
    pg = fake_ray["placement_groups"][0]
    assert pg.strategy == "SPREAD" and len(pg.bundles) == 2
    assert pg.bundles[0] == {"GPU": 1, "CPU": 1}
    workers = [o for o in fake_ray["actor_opts"] if "num_gpus" in o]
    assert len(workers) == 2 and all(o["num_gpus"] == 1 and
                                     o["resources"] == {} for o in workers)
    assert fake_ray["sched_bundles"] == [0, 1]
    assert [s["RANK"] for s in seen] == ["0", "1"]
    assert [s["LOCAL_RANK"] for s in seen] == ["0", "1"]
    assert all(s["WORLD_SIZE"] == "2" and s["LOCAL_WORLD_SIZE"] == "2"
               and s["MASTER_ADDR"] == "10.0.0.1" for s in seen)
    assert len({s["MASTER_PORT"] for s in seen}) == 1
    assert 1024 < int(seen[0]["MASTER_PORT"]) < 65536
    assert res.metrics == {"loss": 1.0}
    assert res.worker_metrics == [{"loss": 1.0}, {"loss": 2.0}]
    assert fake_ray["removed_pgs"] == fake_ray["placement_groups"]


def test_rendezvous_shares_a_nodes_cards():
    envs = TorchTrainer._rendezvous(
        ["10.0.0.1", "10.0.0.2", "10.0.0.1", "10.0.0.2"],
        [[3], [0], [1], [2]], 29555)
    assert [e["RANK"] for e in envs] == ["0", "1", "2", "3"]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == [
        "1,3", "0,2", "1,3", "0,2"]
    assert [e["LOCAL_RANK"] for e in envs] == ["1", "0", "0", "1"]
    assert all(e["MASTER_ADDR"] == "10.0.0.1" and e["WORLD_SIZE"] == "4"
               and e["LOCAL_WORLD_SIZE"] == "2" for e in envs)


def test_fit_ray_names_the_failing_rank(fake_ray):
    def rank1_explodes(config):
        if os.environ["RANK"] == "1":
            raise RuntimeError("boom")
        return {"ok": 0}
    res = TorchTrainer(rank1_explodes,
                       scaling_config=ScalingConfig(num_workers=2),
                       use_ray=True).fit()
    assert "worker rank 1" in res.error and "10.0.0.1" in res.error
    assert "boom" in res.error


def test_fit_ray_preemption_is_not_a_failure(fake_ray):
    calls = {"n": 0}

    def preempted_once(config):
        calls["n"] += 1
        if calls["n"] == 1:
            raise preempt.Preempted(step=3, resumed_step=None, save_s=0.1)
        return {"ok": 1}
    res = TorchTrainer(preempted_once,
                       scaling_config=ScalingConfig(num_workers=1),
                       run_config=RunConfig(failure_config=FailureConfig(
                           max_failures=0, max_preemptions=2)),
                       use_ray=True).fit()
    assert res.error is None and res.metrics == {"ok": 1}
    assert res.preemptions == 1 and res.attempts == 2
    assert [e["status"] for e in res.attempt_log] == ["preempted", "ok"]
    assert res.attempt_log[0]["step"] == 3


def test_fit_ray_stall_killed_naming_the_rank(fake_ray, monkeypatch):
    monkeypatch.setattr(tsup.Supervisor, "stalled",
                        lambda self, timeout_s: [(1, 5, 9.9)])
    res = TorchTrainer(lambda config: "HANG",
                       scaling_config=ScalingConfig(num_workers=2),
                       run_config=RunConfig(
                           failure_config=FailureConfig(max_failures=0),
                           heartbeat_timeout_s=0.05),
                       use_ray=True).fit()
    assert "heartbeat timeout" in res.error
    assert "rank 1 (last step 5" in res.error
    assert len(fake_ray["killed"]) == 2
    assert fake_ray["removed_pgs"] == fake_ray["placement_groups"]


def test_fit_ray_heartbeats_reach_the_supervisor(fake_ray):
    def beats(config):
        get_context().heartbeat(7)
        return {}
    res = TorchTrainer(beats, scaling_config=ScalingConfig(num_workers=2),
                       run_config=RunConfig(heartbeat_timeout_s=60.0),
                       use_ray=True).fit()
    assert res.error is None
    sups = [a for a in fake_ray["actors"] if isinstance(a, tsup.Supervisor)]
    snap = sups[0].snapshot()
    assert snap[0]["step"] == 7 and snap[1]["step"] == 7
    assert snap[0]["done"] and snap[1]["done"]


def test_fit_ray_shrink_starts_the_survivors(fake_ray):
    seen = []

    def worker(config):
        seen.append((os.environ["WORLD_SIZE"],
                     os.environ.get("ELASTIC_N_DEVICES"),
                     os.environ.get("ELASTIC_FULL_POOL")))
        if len(seen) == 1:
            raise preempt.Preempted(step=2, pool=3)
        return {"ok": 1}
    res = TorchTrainer(worker, scaling_config=ScalingConfig(num_workers=4),
                       run_config=RunConfig(elastic=True),
                       use_ray=True).fit()
    assert res.error is None
    assert res.attempt_log[0]["event"] == "shrink"
    assert res.attempt_log[0]["pool"] == 3
    # attempt 1 ran the four workers, attempt 2 the three survivors
    assert seen == [("4", None, None)] * 4 + [("3", "3", "4")] * 3
    assert len(fake_ray["placement_groups"][1].bundles) == 3


# -- serving replicas -----------------------------------------------------------

def test_serve_deployment_matches_the_jax_replicas(monkeypatch):
    from gke_ray_train_tpu.models import transformer as jtr
    from gke_ray_train_tpu.plan import ExecutionPlan as JPlan
    from gke_ray_train_tpu.rayint import serving as jserving
    from gke_ray_train_tpu.serve import BatchEngine as JEngine
    from gke_ray_train_tpu_torch.interop import params_from_numpy
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    jc = jcfg.tiny(vocab_size=97, max_seq_len=128)
    jp = jtr.init_params(jc, jax.random.key(3))
    tc = tiny(vocab_size=97, max_seq_len=128)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [{"rid": f"r{i}", "token_ids": rng.integers(
        4, 97, int(rng.integers(3, 40))).astype(np.int32),
        "max_new_tokens": int(rng.integers(4, 20))} for i in range(5)]
    jdep = jserving.ServeDeployment(
        lambda: JEngine(jp, jc, plan=JPlan(max_batch=2,
                                           decode_buckets="128")),
        num_replicas=2, use_ray=False)
    jdep.start(warm=False)
    want = jdep.serve(reqs)
    tdep = tserving.ServeDeployment(
        lambda: BatchEngine(tp, tc, plan=ExecutionPlan(
            max_batch=2, decode_buckets="128"), device="cpu"),
        num_replicas=2, use_ray=False)
    tdep.start(warm=False)
    got = tdep.serve(reqs)
    keys = ("rid", "tokens", "generated", "prompt_len", "length", "bucket",
            "finish_reason")
    assert [{k: g[k] for k in keys} for g in got] == \
        [{k: w[k] for k in keys} for w in want]
    with pytest.raises(ValueError, match="duplicate"):
        tdep.serve([reqs[0], reqs[0]])
    # the board names a wedged replica: replica 0 keeps iterating,
    # replica 1 stops
    clock = {"t": 1000.0}
    monkeypatch.setattr(tsup.time, "monotonic", lambda: clock["t"])
    board = tdep._board
    board.beat(0, 10_000)
    board.beat(1, 10_000)
    clock["t"] += 30.0
    board.beat(0, 10_001)
    stalled = tdep.stalled(20.0)
    assert [s[0] for s in stalled] == [1]
    assert sorted(tdep.board_snapshot()) == [0, 1]
    tdep.shutdown()
    jdep.shutdown()


def test_serve_deployment_through_the_fake_ray(fake_ray):
    class Engine:
        def __init__(self):
            self.beat = None

        def set_heartbeat(self, fn):
            self.beat = fn

        def warm_up(self):
            pass

        def run_until_drained(self, reqs):
            from gke_ray_train_tpu_torch.serve.engine import Completion
            self.beat(1)
            return [Completion(rid=r.rid, tokens=np.asarray(r.token_ids),
                               prompt_len=1, length=len(r.token_ids),
                               bucket=128, finish_reason="length")
                    for r in reqs]

        def stats(self):
            return {}
    dep = tserving.ServeDeployment(Engine, num_replicas=2,
                                   resources_per_replica={"GPU": 1})
    assert dep.use_ray
    dep.start()
    out = dep.serve([{"rid": "a", "token_ids": [5, 6]},
                     {"rid": "b", "token_ids": [7, 8, 9]}])
    assert [o["rid"] for o in out] == ["a", "b"]
    assert all(o.get("num_gpus") == 1 for o in fake_ray["actor_opts"]
               if "num_gpus" in o)
    assert sorted(dep.board_snapshot()) == [0, 1]
    dep.shutdown()
    assert len(fake_ray["killed"]) == 3
