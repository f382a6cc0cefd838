"""The port's fault injection (``gke_ray_train_tpu_torch/testing/faults.py``)
against the JAX package's (``gke_ray_train_tpu/testing/faults.py``), and
the drills of ``tests/test_faults.py`` on the port's loop, checkpoint
manager and trainer, on the CPU:

- the ``FAULT_SPEC`` grammar parses alike in both packages, valid and
  invalid specs (one parametrised test);
- a fault fires once: in one process, and across processes through the
  marker beside the checkpoints (a torn last line counts as fired, an
  unreadable marker as every fault fired); an unreadable pool marker
  raises;
- the port's loop raises ``InjectedKill`` after the step JAX's loop does,
  and binds and calls an injector it is handed once per step;
- ``ckpt_truncate``: the resume falls back to the prior step and
  quarantines the torn one (``tests/test_faults.py:232-296``), and a
  restore that fails on every step re-raises and quarantines nothing;
- ``kill_during_commit`` on an ``ASYNC_CKPT`` manager leaves COMMITTING
  without COMMITTED, and the resume takes the previous step;
- ``hang`` under the trainer's heartbeat becomes a ``HeartbeatTimeout``
  naming the rank, long before the hang ends; ``slice_evict`` on a pool
  of one slice refuses to evict it all, in JAX's words (the slice drills
  are in ``test_torch_port_hier.py``).
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.testing import faults as jfaults
from gke_ray_train_tpu.train import loop as jloop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager
from gke_ray_train_tpu_torch.models import tiny
from gke_ray_train_tpu_torch.rayint import (
    FailureConfig, RunConfig, TorchTrainer, get_context)
from gke_ray_train_tpu_torch.testing import faults
from gke_ray_train_tpu_torch.train import (
    make_optimizer, make_train_state, make_train_step, preempt)
from gke_ray_train_tpu_torch.train.loop import run_training
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    """Fault state is process-global by design (fire-once across
    attempts); no test may leak it into another."""
    monkeypatch.delenv("FAULT_SPEC", raising=False)
    for mod in (faults, jfaults):
        mod.reset_fired()
        mod.reset_pool()
    preempt.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset_fired()
        mod.reset_pool()
    preempt.reset()
    preempt.uninstall()


def _batches(n=4, B=2, S=8, V=64):
    def batches(epoch):
        rng = np.random.default_rng(epoch)
        for _ in range(n):
            yield {"inputs": rng.integers(0, V, (B, S)).astype(np.int32),
                   "targets": rng.integers(0, V, (B, S)).astype(np.int32),
                   "weights": np.ones((B, S), np.float32)}
    return batches


def _setup():
    cfg = tiny(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
               n_kv_heads=2, d_ff=64)
    opt = make_optimizer(1e-3)
    state = make_train_state(cfg, opt, seed=0, device="cpu")
    return state, make_train_step(cfg, opt, device="cpu"), _batches()


def _worker(ckpt_dir, *, ckpt_every=None, epochs=1, record=None,
            heartbeat=False, max_to_keep=4, async_commit=False):
    """A trainer worker running the port's loop on the tiny model;
    ``record`` collects {trained step: batch fingerprint}, later attempts
    overwriting."""
    def worker(config):
        state, step_fn, batches = _setup()
        mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep,
                                score_attribute=None,
                                async_commit=async_commit)

        def recording_step(st, batch):
            if record is not None:
                record[int(st.step) + 1] = int(batch["inputs"].sum())
            return step_fn(st, batch)
        try:
            final, metrics = run_training(
                state, recording_step, batches, epochs=epochs,
                ckpt_manager=mgr, ckpt_every=ckpt_every,
                heartbeat_fn=(get_context().heartbeat if heartbeat
                              else None))
        finally:
            mgr.close()
        return {"final_step": int(final.step), **metrics}
    return worker


# -- the grammar ---------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "rank=1:kind=kill:step=5;rank=*:kind=hang:step=3:seconds=7.5",
    "kind=sigterm:step=2",
    " kind=ckpt_truncate:step=4 ; ",
    "kind=pool_shrink:step=2:to=4",
    "rank=0:kind=slice_evict:step=1:slice=0",
    "kind=kill_during_commit:step=3",
    "",
    # invalid: each raises ValueError in both packages
    "kind=explode:step=1",
    "kind=kill",
    "step=3",
    "rank=1:kind=kill:step=5:foo=1",
    "kill@5",
    "kind=pool_shrink:step=2",
    "kind=kill:step=2:to=3",
    "kind=sigterm:step=1:seconds=2",
    "kind=pool_shrink:step=1:to=2:slice=1",
    "rank=x:kind=kill:step=1",
    "kind=kill:step=two",
])
def test_fault_spec_parses_as_the_jax_package(spec):
    def parse(mod):
        try:
            return [dataclasses.asdict(s) for s in mod.parse_fault_spec(spec)]
        except ValueError as e:
            return type(e).__name__
    ours, theirs = parse(faults), parse(jfaults)
    assert ours == theirs
    assert faults.KINDS == jfaults.KINDS


def test_fault_fires_once_per_process():
    inj = faults.FaultInjector(
        faults.parse_fault_spec("rank=0:kind=kill:step=2"), rank=0)
    with pytest.raises(faults.InjectedKill):
        inj.on_step(2)
    inj.on_step(2)
    # a retried attempt's fresh injector sees the fault spent too
    faults.FaultInjector(faults.parse_fault_spec("rank=0:kind=kill:step=2"),
                         rank=0).on_step(2)
    # rank=1's fault never fires on rank 0
    faults.FaultInjector(faults.parse_fault_spec("rank=1:kind=kill:step=3"),
                         rank=0).on_step(3)


def test_fault_fires_once_across_processes_and_marker_edges(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), score_attribute=None)
    spec = "rank=0:kind=kill:step=2"
    with pytest.raises(faults.InjectedKill, match="injected kill at step 2"):
        faults.FaultInjector(faults.parse_fault_spec(spec), rank=0,
                             ckpt_manager=mgr).on_step(2)
    faults.reset_fired()   # "a new process"
    faults.FaultInjector(faults.parse_fault_spec(spec), rank=0,
                         ckpt_manager=mgr).on_step(2)
    # the same marker key as the JAX package writes
    marker = os.path.join(mgr.directory, faults.MARKER_NAME)
    key = open(marker).read().strip()
    assert faults.MARKER_NAME == jfaults.MARKER_NAME
    assert key == jfaults.FaultInjector(
        jfaults.parse_fault_spec(spec), rank=0)._marker_key(
            jfaults.parse_fault_spec(spec)[0])
    # a torn last line counts as fired
    with open(marker, "w") as f:
        f.write(key[:len(key) // 2])
    faults.reset_fired()
    faults.FaultInjector(faults.parse_fault_spec(spec), rank=0,
                         ckpt_manager=mgr).on_step(2)
    # present but unreadable: every fault counts as fired
    os.remove(marker)
    os.makedirs(marker)
    faults.reset_fired()
    faults.FaultInjector(faults.parse_fault_spec(spec), rank=0,
                         ckpt_manager=mgr).on_step(2)
    # the pool marker: absent is the full pool, garbage raises
    d = str(tmp_path / "pool")
    os.makedirs(d)
    assert faults.current_pool(d) is None
    with open(os.path.join(d, faults.POOL_MARKER_NAME), "w") as f:
        f.write("not-a-number")
    with pytest.raises(RuntimeError, match="unreadable"):
        faults.current_pool(d)
    with open(os.path.join(d, faults.POOL_MARKER_NAME), "w") as f:
        f.write("4")
    assert faults.current_pool(d) == 4


def test_port_loop_raises_injected_kill_at_the_jax_step(monkeypatch):
    from gke_ray_train_tpu.models import config as jcfg
    from gke_ray_train_tpu.train import (
        make_optimizer as jopt, make_train_state as jstate,
        make_train_step as jstep)
    monkeypatch.setenv("FAULT_SPEC", "kind=kill:step=3")
    jc = jcfg.tiny(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                   n_kv_heads=2, d_ff=64)
    jo = jopt(1e-3)
    js = jstate(jc, jo, jax.random.key(0))
    jf = jstep(jc, jo, donate=False)
    trained = {"jax": 0, "port": 0}

    def jax_step(st, b):
        trained["jax"] += 1
        return jf(st, {k: jnp.asarray(v) for k, v in b.items()})
    with pytest.raises(jfaults.InjectedKill) as je:
        jloop.run_training(js, jax_step, _batches(), epochs=2)
    state, step_fn, batches = _setup()

    def port_step(st, b):
        trained["port"] += 1
        return step_fn(st, b)
    with pytest.raises(faults.InjectedKill) as te:
        run_training(state, port_step, batches, epochs=2)
    assert str(te.value) == str(je.value) == "injected kill at step 3 (rank 0)"
    assert trained == {"jax": 3, "port": 3}

    # an injector handed in is bound to the manager and called each step
    class Injector:
        def __init__(self):
            self.bound, self.steps = None, []

        def bind_ckpt(self, mgr):
            self.bound = mgr

        def on_step(self, s):
            self.steps.append(s)
    monkeypatch.delenv("FAULT_SPEC")
    inj = Injector()
    state, step_fn, batches = _setup()

    class Mgr:
        def restore_if_available(self, st):
            return st, None

        def save(self, *a, **k):
            return True

        def wait(self):
            pass

        def latest_step(self):
            return None
    mgr = Mgr()
    run_training(state, step_fn, batches, epochs=1, fault_injector=inj,
                 ckpt_manager=mgr)
    assert inj.bound is mgr and inj.steps == [1, 2, 3, 4]


# -- ckpt_truncate: the corrupt-checkpoint fallback ----------------------------

def test_ckpt_truncate_falls_back_to_prior_step_and_quarantines(
        tmp_path, monkeypatch):
    d = str(tmp_path / "run")
    monkeypatch.setenv("FAULT_SPEC", "rank=0:kind=ckpt_truncate:step=4")
    res = TorchTrainer(_worker(d, ckpt_every=2), use_ray=False).fit()
    assert res.error is None and res.metrics["final_step"] == 4
    monkeypatch.delenv("FAULT_SPEC")
    record = {}
    res2 = TorchTrainer(_worker(d, ckpt_every=2, record=record),
                        use_ray=False).fit()
    assert res2.error is None
    assert res2.attempt_log[0]["resumed_step"] == 2
    assert res2.metrics["final_step"] == 4
    assert sorted(record) == [3, 4]
    assert os.path.isdir(os.path.join(d, "4.corrupt"))


def test_restore_falls_back_or_reraises_untouched(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"w": torch.arange(512, dtype=torch.float32)}
    mgr = CheckpointManager(d, max_to_keep=3, score_attribute=None)
    mgr.save(2, state)
    mgr.save(4, {"w": state["w"] * 2})
    faults.FaultInjector([faults.FaultSpec(kind="ckpt_truncate", step=4)],
                         ckpt_manager=mgr)._truncate_latest(4)
    mgr2 = CheckpointManager(d, max_to_keep=3, score_attribute=None)
    out, step = mgr2.restore_if_available(
        {"w": torch.zeros(512, dtype=torch.float32)})
    assert step == 2 and torch.equal(out["w"], state["w"])
    assert mgr2.latest_step() == 2
    assert os.path.isdir(os.path.join(d, "4.corrupt"))
    # every step failing is a template mismatch: re-raise, keep the steps
    wrong = {"w": torch.zeros(512), "extra": torch.zeros(4)}
    with pytest.raises(Exception):
        CheckpointManager(d, score_attribute=None).restore_if_available(wrong)
    assert os.path.isdir(os.path.join(d, "2"))
    assert not os.path.exists(os.path.join(d, "2.corrupt"))


# -- kill_during_commit: the write-ahead recovery drill ------------------------

def test_kill_during_commit_resumes_from_the_previous_step(
        tmp_path, monkeypatch):
    d = str(tmp_path / "run")
    monkeypatch.setenv("CKPT_STORAGE_DELAY_S", "0.3")
    monkeypatch.setenv("FAULT_SPEC", "kind=kill_during_commit:step=4")
    res = TorchTrainer(_worker(d, ckpt_every=2, async_commit=True),
                       use_ray=False).fit()
    assert res.status == "failed"
    assert "injected kill during commit of step 4" in res.error
    assert os.path.exists(os.path.join(d, "COMMITTING.4"))
    assert not os.path.exists(os.path.join(d, "COMMITTED.4"))
    assert os.path.exists(os.path.join(d, "COMMITTED.2"))
    monkeypatch.delenv("FAULT_SPEC")
    monkeypatch.setenv("CKPT_STORAGE_DELAY_S", "0")
    ref_record, record = {}, {}
    ref = TorchTrainer(_worker(str(tmp_path / "ref"), ckpt_every=2,
                               async_commit=True, record=ref_record),
                       use_ray=False).fit()
    res2 = TorchTrainer(_worker(d, ckpt_every=2, async_commit=True,
                                record=record), use_ray=False).fit()
    assert res2.attempt_log[0]["resumed_step"] == 2
    assert sorted(record) == [3, 4]
    assert res2.metrics["loss"] == ref.metrics["loss"]
    assert os.path.isdir(os.path.join(d, "4.corrupt"))


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _tear_drill(d, branch, monkeypatch):
    """Save steps 2 and 4 on an async manager and tear step 4 with the
    kill landing in ``branch``: "queued" (the committer still busy with
    step 2, step 4 in the queue) or "in_flight" (the committer holds step
    4, inside its storage wait, before it serializes). Returns the torn
    step and the files on disk."""
    import threading
    st, _, _ = _setup()
    release = threading.Event()
    if branch == "queued":
        commit_one = CheckpointManager._commit_one

        def held(self, step, host, metrics):
            if step == 2:
                release.wait(30)
            return commit_one(self, step, host, metrics)
        monkeypatch.setattr(CheckpointManager, "_commit_one", held)
    mgr = CheckpointManager(d, max_to_keep=4, score_attribute=None,
                            async_commit=True,
                            storage_delay_s=0.5 if branch == "in_flight"
                            else 0.0)
    mgr.save(2, st)
    if branch == "in_flight":
        mgr.wait()
    mgr.save(4, st)
    if branch == "in_flight":
        assert mgr.wait_until_committing(4, timeout=30)
    else:
        assert not mgr.wait_until_committing(4, timeout=0.2)
        assert mgr._committing_now == 2
    torn = mgr.tear_mid_commit(partial=True)
    release.set()
    mgr._committer.join(30)
    assert not mgr._committer.is_alive()
    return torn, _tree(d)


def test_kill_during_commit_leaves_one_state_from_either_branch(
        tmp_path, monkeypatch):
    """The commit drill's two races forced one at a time: the kill with
    step 4 still queued, and the kill while the committer holds step 4
    before it serializes. Both leave the same files (COMMITTING.4 beside
    a torn ``4/_PARTIAL``, step 2 committed), and a resume quarantines
    step 4 as ``4.corrupt`` and restores step 2 in both."""
    trees = {}
    for branch in ("queued", "in_flight"):
        d = str(tmp_path / branch)
        torn, trees[branch] = _tear_drill(d, branch, monkeypatch)
        monkeypatch.undo()
        assert torn == 4
        assert "COMMITTING.4" in trees[branch], branch
        assert "COMMITTED.4" not in trees[branch], branch
        assert os.path.join("4", "_PARTIAL") in trees[branch], branch
        assert "COMMITTED.2" in trees[branch], branch
        st, _, _ = _setup()
        mgr = CheckpointManager(d, max_to_keep=4, score_attribute=None,
                                async_commit=True)
        _, resumed = mgr.restore_if_available(st)
        mgr.close()
        assert resumed == 2, branch
        assert os.path.isdir(os.path.join(d, "4.corrupt")), branch
    assert trees["queued"].keys() == trees["in_flight"].keys()
    for name in ("COMMITTING.4", os.path.join("4", "_PARTIAL")):
        assert trees["queued"][name] == trees["in_flight"][name], name


def test_kill_during_commit_needs_an_async_manager(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "c"), score_attribute=None)
    inj = faults.FaultInjector(
        faults.parse_fault_spec("kind=kill_during_commit:step=1"),
        ckpt_manager=mgr)
    with pytest.raises(RuntimeError, match="ASYNC_CKPT=1"):
        inj.on_step(1)
    # one slice (NUM_SLICES unset): evicting it is the whole pool, which
    # JAX's injector refuses in the same words
    monkeypatch.delenv("NUM_SLICES", raising=False)
    errs = []
    for mod in (faults, jfaults):
        mod.reset_fired()
        with pytest.raises(RuntimeError, match="ENTIRE pool") as e:
            mod.FaultInjector(mod.parse_fault_spec(
                "kind=slice_evict:step=1")).on_step(1)
        errs.append(str(e.value))
        mod.reset_fired()
    assert errs[0] == errs[1]


# -- hang: the heartbeat watchdog ----------------------------------------------

def test_hang_becomes_a_heartbeat_timeout_naming_the_rank(
        tmp_path, monkeypatch):
    monkeypatch.setenv("FAULT_SPEC", "rank=0:kind=hang:step=2:seconds=30")
    t0 = time.monotonic()
    res = TorchTrainer(
        _worker(str(tmp_path / "run"), heartbeat=True), use_ray=False,
        run_config=RunConfig(failure_config=FailureConfig(max_failures=0),
                             heartbeat_timeout_s=1.5)).fit()
    assert time.monotonic() - t0 < 20
    assert res.status == "failed" and res.attempts == 1
    assert "heartbeat timeout" in res.error
    assert "rank 0 (last step 2" in res.error
    assert "no step progress for 1.5s" in res.error
