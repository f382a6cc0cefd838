"""The port's checkpoint manager (``gke_ray_train_tpu_torch/ckpt/
manager.py``) against the behaviours the JAX package's tests hold its
manager to, rewritten on port states at tiny dims on the CPU:

- ``tests/test_ckpt.py``: round trip, retention keeps the best, fresh
  start and resume, the LoRA view restoring a pre-view full checkpoint;
- ``tests/test_resume_skip.py``: a finished checkpoint resumes to zero
  new steps, a mid-epoch one trains only the remainder, an empty epoch
  still raises;
- ``tests/test_goodput.py``'s manager cases: the async save returns fast
  and commits in the background, ``wait`` surfaces a background failure,
  ``tear_mid_commit`` leaves COMMITTING without COMMITTED, a sync-mode
  suspect is excluded and then healed on verify, a quarantined step that
  reappears is never offered, a kill during a commit resumes the previous
  step bitwise;

and ``run_training`` with the real manager: preempted, then resumed, it
ends on the losses and adapters of an uninterrupted run, bitwise.

The last section drives the JAX manager (``gke_ray_train_tpu/ckpt/
manager.py``, orbax underneath) and the port's through the same actions
side by side and requires the same answers after each: what ``save``
returns, the tracked steps, ``latest_step``, ``best_step``, the step
``restore_if_available`` resumes and the values it restores, and the step
directories, quarantined steps and markers on disk.
"""

import dataclasses
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.ckpt import CheckpointManager as JaxCheckpointManager
from gke_ray_train_tpu_torch.ckpt import (
    CheckpointCommitError, CheckpointManager, flat_state)
from gke_ray_train_tpu_torch.models import init_params, tiny
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_optimizer, make_train_state, make_train_step,
    make_sgd, preempt)
from gke_ray_train_tpu_torch.train.loop import run_training
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


CFG = tiny(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
           d_ff=64)
LORA_VIEW = (lambda st: dataclasses.replace(st, params=None),
             lambda st, v: dataclasses.replace(v, params=st.params))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("ASYNC_CKPT", "PEER_REPLICATION", "CKPT_COMMIT_TIMEOUT_S",
              "CKPT_STORAGE_DELAY_S", "FAULT_SPEC"):
        monkeypatch.delenv(k, raising=False)
    preempt.reset()
    yield
    preempt.reset()


def _setup(mode="full", seed=0, spec=None):
    spec = spec or make_optimizer(1e-2)
    lcfg = LoraConfig(r=4, alpha=8) if mode == "lora" else None
    state = make_train_state(CFG, spec, seed=seed, lora_cfg=lcfg,
                             params=init_params(CFG, seed, device="cpu"),
                             device="cpu")
    return state, make_train_step(CFG, spec, lora_cfg=lcfg, device="cpu")


def _batch(seed):
    r = np.random.default_rng(seed)
    return {"inputs": r.integers(0, 64, (2, 8)).astype(np.int32),
            "targets": r.integers(0, 64, (2, 8)).astype(np.int32),
            "weights": np.ones((2, 8), np.float32)}


def _batches(epoch, n=4):
    for i in range(n):
        yield _batch(epoch * 10 + i)


def _assert_flat_equal(a, b):
    fa, fb = flat_state(a), flat_state(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def _small_state():
    return {"w": torch.arange(512, dtype=torch.float32),
            "m": torch.ones((4, 8)) * 3.0, "step": 7}


def _zeros_like(state):
    return {k: torch.zeros_like(v) if torch.is_tensor(v) else 0
            for k, v in state.items()}


def _marker(root, kind, step):
    return os.path.join(str(root), f"{kind}.{step}")


# -- tests/test_ckpt.py ------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "lora"])
def test_save_restore_roundtrip(tmp_path, mode):
    """A trained state (moments nonzero, count 2) restores bitwise into a
    state of another seed, in place: the optimizer the step checks by
    identity stays the one it was."""
    state, step = _setup(mode)
    for i in range(2):
        state, _ = step(state, _batch(i))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    assert mgr.save(3, state, {"loss": 2.5}) is True
    mgr.wait()
    assert mgr.latest_step() == 3
    other, _ = _setup(mode, seed=5)
    opt = other.opt_state
    restored = mgr.restore(other)
    assert restored is other and restored.opt_state is opt
    assert restored.step == 2 and opt.count == 2
    _assert_flat_equal(restored, state)
    mgr.close()


def test_restore_before_any_step_and_sgd_state(tmp_path):
    """The optimizer state exists from construction (optax's init): a
    state saved before its first step restores, and SGD's trace is
    checkpointed like AdamW's moments."""
    for spec in (make_optimizer(1e-2), make_sgd(1e-2)):
        state, step = _setup(spec=spec)
        mgr = CheckpointManager(str(tmp_path / spec.kind))
        mgr.save(0, state)
        other, _ = _setup(seed=3, spec=spec)
        _assert_flat_equal(mgr.restore(other), state)
        state, _ = step(state, _batch(0))
        keys = {k.rsplit("/", 1)[-1] for k in flat_state(state)
                if k.startswith("opt/") and k != "opt/count"}
        assert keys == set(type(state.opt_state).STATE_KEYS)


def test_retention_keeps_best(tmp_path):
    state, _ = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    mgr.save(1, state, {"loss": 2.0})
    mgr.save(2, state, {"loss": 5.0})  # worse: best stays at 1
    mgr.wait()
    assert mgr.best_step() == 1
    assert mgr.all_steps() == [1]
    recency = CheckpointManager(str(tmp_path / "recent"), max_to_keep=2,
                                score_attribute=None)
    for s in (1, 2, 3):
        recency.save(s, state, {"loss": float(s)})
    assert recency.all_steps() == [2, 3] and recency.best_step() == 3


def test_restore_if_available_fresh_and_resume(tmp_path):
    state, _ = _setup()
    mgr = CheckpointManager(str(tmp_path / "c"))
    got, step = mgr.restore_if_available(state)
    assert step is None and got is state
    mgr.save(7, state, {"loss": 1.0})
    mgr.wait()
    got, step = mgr.restore_if_available(state)
    assert step == 7 and mgr.last_restore_source == "storage"
    # orbax's gate: an older step, or one off the interval, is refused
    assert mgr.save(5, state) is False
    # (the default score ranks the steps, so each save carries it)
    gated = CheckpointManager(str(tmp_path / "g"), save_interval_steps=4)
    assert [gated.save(s, state, {"loss": 1.0}) for s in (2, 4, 6, 8)] == \
        [True, True, False, True]
    assert gated.save(9, state, {"loss": 1.0}, force=True) is True
    mgr.close()


def test_lora_ckpt_view_restores_pre_view_full_checkpoint(tmp_path):
    """A checkpoint written before the LoRA view existed holds the full
    state (params included); resuming with the view configured restores
    its adapters and trains on."""
    state, step_fn = _setup("lora")
    d = str(tmp_path / "sft")
    mgr = CheckpointManager(d)
    base = [{t: {k: v.detach().clone() for k, v in ab.items()}
             for t, ab in layer.items()} for layer in state.lora]
    with torch.no_grad():
        for layer in state.lora:
            for ab in layer.values():
                for v in ab.values():
                    v.add_(1.0)
    # step stays 0, so the fast-forward skips nothing
    mgr.save(41, state, metrics={"loss": 1.0}, force=True)
    assert any(k.startswith("params/") for k in flat_state(state))
    with torch.no_grad():
        for layer, old in zip(state.lora, base):
            for t, ab in layer.items():
                for k, v in ab.items():
                    v.copy_(old[t][k])
    mgr2 = CheckpointManager(d)
    final, _ = run_training(state, step_fn, lambda e: iter([_batch(1)]),
                            epochs=1, ckpt_manager=mgr2, ckpt_view=LORA_VIEW)
    assert final.step == 1
    a = final.lora[0]["wq"]["a"].detach()
    # restored (+1), then trained one step at lr 1e-2
    assert torch.allclose(a, base[0]["wq"]["a"] + 1.0, atol=0.05)
    assert not torch.allclose(a, base[0]["wq"]["a"] + 1.0, atol=0, rtol=0)


# -- tests/test_resume_skip.py ----------------------------------------------

def test_finished_checkpoint_resumes_to_zero_new_steps(tmp_path):
    d = str(tmp_path / "run")
    state, step_fn = _setup()
    final, _ = run_training(state, step_fn, _batches, epochs=1,
                            ckpt_manager=CheckpointManager(d))
    assert final.step == 4
    state2, step_fn2 = _setup()
    calls = []

    def counting(st, b):
        calls.append(1)
        return step_fn2(st, b)
    final2, _ = run_training(state2, counting, _batches, epochs=1,
                             ckpt_manager=CheckpointManager(d))
    assert final2.step == 4 and not calls
    _assert_flat_equal(final2, final)


def test_midepoch_checkpoint_trains_only_remainder(tmp_path):
    d = str(tmp_path / "run")
    state, step_fn = _setup()
    mgr = CheckpointManager(d, max_to_keep=1, score_attribute=None)
    run_training(state, step_fn, lambda e: _batches(e, n=2), epochs=1,
                 ckpt_manager=mgr, ckpt_every=2)
    state2, step_fn2 = _setup()
    calls = []

    def counting(st, b):
        calls.append(1)
        return step_fn2(st, b)
    final2, _ = run_training(
        state2, counting, _batches, epochs=1,
        ckpt_manager=CheckpointManager(d, max_to_keep=1,
                                       score_attribute=None))
    assert final2.step == 4 and len(calls) == 2


def test_resumed_run_with_empty_epoch_still_raises(tmp_path):
    d = str(tmp_path / "run")
    state, step_fn = _setup()
    run_training(state, step_fn, _batches, epochs=1,
                 ckpt_manager=CheckpointManager(d))
    state2, step_fn2 = _setup()
    with pytest.raises(ValueError, match="0 batches"):
        run_training(state2, step_fn2, lambda e: iter(()), epochs=1,
                     ckpt_manager=CheckpointManager(d))


# -- tests/test_goodput.py's manager cases -----------------------------------

def test_async_save_returns_fast_and_commits_in_background(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, score_attribute=None, async_commit=True,
                            storage_delay_s=0.5)
    state = _small_state()
    t0 = time.perf_counter()
    assert mgr.save(1, state) is True
    assert time.perf_counter() - t0 < 0.4
    assert not os.path.exists(_marker(d, "COMMITTED", 1))
    assert mgr.save(1, state) is False   # already snapshot
    mgr.wait()
    assert mgr.commits_done == 1
    (rec,) = mgr.commit_log
    assert rec["step"] == 1 and rec["status"] == "ok"
    assert rec["commit_s"] >= 0.5
    assert os.path.exists(_marker(d, "COMMITTED", 1))
    assert not os.path.exists(_marker(d, "COMMITTING", 1))
    assert mgr.latest_step() == 1
    out, step = mgr.restore_if_available(_zeros_like(state))
    assert step == 1
    _assert_flat_equal(out, state)
    mgr.close()


def test_wait_surfaces_background_commit_failure(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), score_attribute=None,
                            async_commit=True)

    def exploding_write(*a, **k):
        raise RuntimeError("emulated storage outage")
    mgr._write_step = exploding_write
    assert mgr.save(1, _small_state()) is True
    with pytest.raises(CheckpointCommitError):
        mgr.wait()
    mgr.close()


def test_tear_mid_commit_leaves_committing_without_committed(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, score_attribute=None, async_commit=True,
                            storage_delay_s=0.2)
    state = _small_state()
    mgr.save(1, state)
    mgr.wait()
    mgr.save(2, state)
    assert mgr.tear_mid_commit() == 2 and mgr.last_torn_step == 2
    assert os.path.exists(_marker(d, "COMMITTING", 2))
    assert not os.path.exists(_marker(d, "COMMITTED", 2))
    assert mgr.save(3, state) is False   # the torn manager is dead
    mgr.close()

    mgr2 = CheckpointManager(d, score_attribute=None, async_commit=True)
    out, step = mgr2.restore_if_available(_zeros_like(state))
    assert step == 1
    _assert_flat_equal(out, state)
    assert mgr2.last_restore_source == "storage"
    assert not os.path.exists(_marker(d, "COMMITTING", 2))
    assert not os.path.exists(os.path.join(d, "2"))
    assert mgr2.latest_step() == 1
    mgr2.close()


def test_tear_mid_commit_requires_an_inflight_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), score_attribute=None,
                            async_commit=True)
    mgr.save(1, _small_state())
    mgr.wait()
    with pytest.raises(RuntimeError, match="no in-flight commit"):
        mgr.tear_mid_commit()
    mgr.close()
    with pytest.raises(RuntimeError, match="ASYNC_CKPT"):
        CheckpointManager(str(tmp_path / "sync"),
                          score_attribute=None).tear_mid_commit()


def test_sync_mode_suspect_excluded_then_healed_on_verify(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _small_state()
    mgr = CheckpointManager(d, score_attribute=None, max_to_keep=4)
    mgr.save(2, state)
    two = {k: v + 1 for k, v in state.items()}
    mgr.save(4, two)
    # forge the mid-commit signature on step 4
    os.remove(_marker(d, "COMMITTED", 4))
    with open(_marker(d, "COMMITTING", 4), "w") as f:
        f.write("COMMITTING step=4\n")

    mgr2 = CheckpointManager(d, score_attribute=None, max_to_keep=4)
    assert mgr2.latest_step() == 2          # the suspect is not offered
    out, step = mgr2.restore_if_available(_zeros_like(state))
    assert step == 4                        # ... but it verified fine
    _assert_flat_equal(out, two)
    assert os.path.exists(_marker(d, "COMMITTED", 4))
    assert not os.path.exists(_marker(d, "COMMITTING", 4))
    assert mgr2.latest_step() == 4


def test_quarantined_step_reappearing_is_never_offered(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _small_state()
    mgr = CheckpointManager(d, score_attribute=None, max_to_keep=4)
    mgr.save(2, state)
    mgr.save(4, {k: v + 1 for k, v in state.items()})

    # first crash: step 4's data is torn; the resume quarantines it
    biggest, size = None, -1
    for root, _, files in os.walk(os.path.join(d, "4")):
        for f in files:
            p = os.path.join(root, f)
            if os.path.getsize(p) > size:
                biggest, size = p, os.path.getsize(p)
    with open(biggest, "r+b") as f:
        f.truncate(max(size // 2, 1))
    mgr2 = CheckpointManager(d, score_attribute=None, max_to_keep=4)
    out, step = mgr2.restore_if_available(_zeros_like(state))
    assert step == 2
    assert os.path.isdir(os.path.join(d, "4.corrupt"))

    # second crash at the same step: a partial "4" reappears beside its
    # quarantined namesake, with its write-ahead marker
    os.makedirs(os.path.join(d, "4"))
    with open(os.path.join(d, "4", "_PARTIAL"), "wb") as f:
        f.write(b"\x00" * 64)
    with open(_marker(d, "COMMITTING", 4), "w") as f:
        f.write("COMMITTING step=4\n")
    for async_commit in (True, False):
        mgr3 = CheckpointManager(d, score_attribute=None,
                                 async_commit=async_commit, max_to_keep=4)
        assert mgr3.latest_step() == 2, async_commit
        out, step = mgr3.restore_if_available(_zeros_like(state))
        assert step == 2
        _assert_flat_equal(out, state)
        mgr3.close()


def test_every_step_failing_reraises_and_quarantines_nothing(tmp_path):
    """A template the checkpoints do not fit (a caller bug) re-raises the
    first error and leaves every step in place."""
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, score_attribute=None, max_to_keep=4)
    mgr.save(1, _small_state())
    mgr.save(2, _small_state())
    with pytest.raises(Exception, match="zz"):
        mgr.restore_if_available({"zz": torch.zeros(3)})
    assert mgr.all_steps() == [1, 2]


def test_peer_replication_raises_naming_the_roadmap(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="item 8"):
        CheckpointManager(str(tmp_path / "a"), peer=True)
    monkeypatch.setenv("PEER_REPLICATION", "1")
    with pytest.raises(NotImplementedError, match="item 8"):
        CheckpointManager(str(tmp_path / "b"))
    CheckpointManager(str(tmp_path / "c"), peer=False)


class _KillDuringCommit:
    """The fault injector's ``kill_during_commit`` at one step: tear the
    commit that step's save started, then die."""

    def __init__(self, step):
        self.step, self.mgr = step, None

    def bind_ckpt(self, mgr):
        self.mgr = mgr

    def on_step(self, step):
        if step == self.step:
            torn = self.mgr.tear_mid_commit()
            raise RuntimeError(f"injected kill during commit of step {torn}")


def _recording(step_fn, losses):
    def step(st, b):
        st, m = step_fn(st, b)
        losses[st.step] = float(m["loss"])
        return st, m
    return step


def test_kill_during_commit_resumes_previous_step_bitwise(tmp_path):
    """A kill mid-commit of step 4 resumes from step 2's save, never a
    torn 4, and the resumed trajectory equals an uninterrupted run's."""
    batches = lambda e: _batches(e, n=8)   # noqa: E731
    ref_losses = {}
    state, step_fn = _setup()
    mgr = CheckpointManager(str(tmp_path / "ref"), max_to_keep=4,
                            score_attribute=None, async_commit=True,
                            storage_delay_s=0.05)
    ref, _ = run_training(state, _recording(step_fn, ref_losses), batches,
                          epochs=1, ckpt_manager=mgr, ckpt_every=2)
    mgr.close()
    assert ref.step == 8

    d = str(tmp_path / "chaos")
    losses = {}
    state, step_fn = _setup()
    mgr = CheckpointManager(d, max_to_keep=4, score_attribute=None,
                            async_commit=True, storage_delay_s=0.05)
    with pytest.raises(RuntimeError, match="commit of step 4"):
        run_training(state, _recording(step_fn, losses), batches,
                     epochs=1, ckpt_manager=mgr, ckpt_every=2,
                     fault_injector=_KillDuringCommit(4))
    mgr.close()
    state, step_fn = _setup()
    mgr = CheckpointManager(d, max_to_keep=4, score_attribute=None,
                            async_commit=True, storage_delay_s=0.05)
    resumed = []
    mgr.restore_if_available = (lambda f: lambda t: (
        lambda out: resumed.append(out[1]) or out)(f(t)))(
            mgr.restore_if_available)
    final, _ = run_training(state, _recording(step_fn, losses), batches,
                            epochs=1, ckpt_manager=mgr, ckpt_every=2)
    mgr.close()
    assert resumed == [2] and final.step == 8
    assert losses == ref_losses
    _assert_flat_equal(final, ref)
    assert not [f for f in os.listdir(d) if f.startswith("COMMITTING.")]


@pytest.mark.parametrize("async_commit", [False, True])
def test_preempted_and_resumed_run_matches_uninterrupted(tmp_path,
                                                         async_commit):
    """LoRA with the entry's view: preempted after step 3 (a forced save),
    resumed in a fresh process-like state from the same seeds; steps 4-6
    and the final adapters and moments equal the uninterrupted run's."""
    batches = lambda e: _batches(e, n=6)   # noqa: E731
    ref_losses = {}
    state, step_fn = _setup("lora")
    ref, _ = run_training(state, _recording(step_fn, ref_losses), batches,
                          epochs=1, ckpt_view=LORA_VIEW,
                          ckpt_manager=CheckpointManager(
                              str(tmp_path / "ref"), score_attribute=None,
                              max_to_keep=2, async_commit=async_commit),
                          ckpt_every=2)

    d = str(tmp_path / "run")
    losses = {}
    state, step_fn = _setup("lora")

    def preempting(st, b):
        out = _recording(step_fn, losses)(st, b)
        if out[0].step == 3:
            preempt.request(source="test")
        return out
    mgr = CheckpointManager(d, score_attribute=None, max_to_keep=2,
                            async_commit=async_commit)
    with pytest.raises(preempt.Preempted) as ei:
        run_training(state, preempting, batches, epochs=1,
                     ckpt_manager=mgr, ckpt_every=2, ckpt_view=LORA_VIEW)
    mgr.close()
    assert ei.value.step == 3 and mgr.latest_step() == 3
    preempt.reset()
    state, step_fn = _setup("lora")
    mgr = CheckpointManager(d, score_attribute=None, max_to_keep=2,
                            async_commit=async_commit)
    final, _ = run_training(state, _recording(step_fn, losses), batches,
                            epochs=1, ckpt_manager=mgr, ckpt_every=2,
                            ckpt_view=LORA_VIEW)
    mgr.close()
    assert final.step == 6 and losses == ref_losses
    assert not any(k.startswith("params/")
                   for k in flat_state(LORA_VIEW[0](final)))
    _assert_flat_equal(LORA_VIEW[0](final), LORA_VIEW[0](ref))


# -- the JAX manager, side by side -------------------------------------------

_LAYOUT = re.compile(r"^(\d+(\.corrupt\d*)?|COMMITT(ING|ED)\.\d+)$")


def _state_np(k):
    """The state numbered ``k``: its ``w[0]`` is ``k``."""
    return {"w": np.arange(64, dtype=np.float32) + k,
            "m": np.full((4, 8), 3.0 + k, np.float32)}


def _outcome(fn):
    try:
        return fn()
    except Exception as e:   # noqa: BLE001 - both sides must raise
        return ("raises", isinstance(e, KeyError))


class _Side:
    """One package's manager, its directory and what it answered."""

    def __init__(self, root, jax_side, kw):
        self.dir, self.jax, self.kw = root, jax_side, kw
        self.log = []
        self.open()

    def open(self):
        if self.jax:
            self.mgr = JaxCheckpointManager(self.dir, async_save=False,
                                            **self.kw)
        else:
            self.mgr = CheckpointManager(self.dir, **self.kw)

    def state(self, k):
        if self.jax:
            return {n: jnp.asarray(v) for n, v in _state_np(k).items()}
        return {n: torch.from_numpy(v) for n, v in _state_np(k).items()}

    def steps(self):
        return list(self.mgr._mgr.all_steps() if self.jax
                    else self.mgr.all_steps())

    def restored(self, out):
        w, m = (np.asarray(out[n]) for n in ("w", "m"))
        k = float(w[0])
        assert np.array_equal(w, _state_np(k)["w"])
        assert np.array_equal(m, _state_np(k)["m"])
        return k


class _Pair:
    """Both managers on the same actions; each answer goes to its log."""

    def __init__(self, tmp_path, **kw):
        self.sides = [_Side(str(tmp_path / n), n == "jax", dict(kw))
                      for n in ("jax", "port")]

    def _each(self, tag, fn):
        for side in self.sides:
            side.log.append((tag, _outcome(lambda: fn(side))))

    def save(self, step, k=None, metrics=None, force=False):
        k = step if k is None else k
        self._each(f"save {step}", lambda s: s.mgr.save(
            step, s.state(k), metrics, force=force))

    def query(self, tag="query"):
        for side in self.sides:
            side.log.append((tag, (
                _outcome(side.steps), _outcome(side.mgr.latest_step),
                _outcome(side.mgr.best_step),
                sorted(n for n in os.listdir(side.dir)
                       if _LAYOUT.match(n)))))

    def restore(self, template=None):
        def go(s):
            like = template(s) if template else {
                n: v * 0 for n, v in s.state(0).items()}
            out, step = s.mgr.restore_if_available(like)
            return step, (None if step is None else s.restored(out))
        self._each("restore_if_available", go)
        self.query("after restore")

    def wait(self):
        self._each("wait", lambda s: s.mgr.wait())

    def reopen(self, **kw):
        for side in self.sides:
            side.mgr.close()
            side.kw.update(kw)
            side.open()

    def on_disk(self, fn):
        for side in self.sides:
            fn(side.dir)

    def tear_in_flight(self, step, queue=None):
        """Save ``step`` behind a slow store and, once its commit is in
        flight, save ``queue`` (when given) and tear: one side at a time,
        so that each tear lands inside its own commit window."""
        for side in self.sides:
            side.mgr.storage_delay_s = 0.3
            side.log.append((f"save {step}", _outcome(
                lambda: side.mgr.save(step, side.state(step)))))
            deadline = time.monotonic() + 30
            while side.mgr._committing_now != step:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            if queue is not None:
                side.log.append((f"save {queue}", _outcome(
                    lambda: side.mgr.save(queue, side.state(queue)))))
            side.log.append(("tear", _outcome(side.mgr.tear_mid_commit)))

    def check(self):
        for side in self.sides:
            side.mgr.close()
        jax_log, port_log = (s.log for s in self.sides)
        assert port_log == jax_log


def _forge_suspect(step):
    def forge(d):
        os.remove(_marker(d, "COMMITTED", step))
        with open(_marker(d, "COMMITTING", step), "w") as f:
            f.write(f"COMMITTING step={step}\n")
    return forge


def _tear_data(step):
    """Truncate every file of a step's data to half its size."""
    def tear(d):
        for r, _, fs in os.walk(os.path.join(d, str(step))):
            for f in fs:
                p = os.path.join(r, f)
                with open(p, "r+b") as fh:
                    fh.truncate(os.path.getsize(p) // 2)
    return tear


def _reappear(step):
    """A second crash at a quarantined step: a partial directory and its
    write-ahead marker come back."""
    def back(d):
        os.makedirs(os.path.join(d, str(step)))
        with open(os.path.join(d, str(step), "_PARTIAL"), "wb") as f:
            f.write(b"\x00" * 64)
        with open(_marker(d, "COMMITTING", step), "w") as f:
            f.write(f"COMMITTING step={step}\n")
    return back


def _save_gate(pair):
    """The interval, ``force``, an older step, a step that exists."""
    for step, force in ((2, False), (4, False), (6, False), (8, False),
                        (9, True), (3, False), (3, True), (8, False),
                        (12, False), (12, True), (14, False), (16, False)):
        pair.save(step, force=force)
        pair.wait()
        pair.query()
    pair.reopen()
    pair.query("reopened")
    pair.save(20)
    pair.wait()
    pair.query()
    pair.restore()


def _recency(pair):
    for step in (1, 2, 3):
        pair.save(step, metrics={"loss": float(step)})
        pair.query()
    pair.save(1, force=True)     # an older step, saved last
    pair.query()
    pair.save(5)
    pair.query()
    pair.reopen()
    pair.query("reopened")
    pair.restore()


def _by_score(mode):
    def run(pair):
        for step, loss in ((1, 2.0), (2, 5.0), (3, 2.0), (4, 9.0),
                           (5, 1.0), (6, 1.0), (7, 0.5)):
            pair.save(step, metrics={"loss": loss, "acc": -loss})
            pair.query()
        pair.reopen()
        pair.query("reopened")
        pair.restore()
    return run


def _score_missing(pair):
    """A save whose metrics lack the score: orbax ranks and raises."""
    pair.save(1, metrics={"loss": 3.0})
    pair.save(2, metrics={"acc": 1.0})
    pair.query()
    pair.save(3, metrics={"loss": 1.0})
    pair.query()


def _suspect(pair):
    """A COMMITTING marker without COMMITTED on the newest step (the
    sync mode): not offered, counted by retention, verified and healed
    by the restore walk."""
    for step in (2, 4):
        pair.save(step, metrics={"loss": 6.0 - step})
    pair.wait()
    pair.on_disk(_forge_suspect(4))
    pair.reopen()
    pair.query("reopened")
    pair.save(5, metrics={"loss": 3.0})
    pair.wait()
    pair.query()
    pair.on_disk(_forge_suspect(5))
    pair.reopen()
    pair.restore()


def _torn_then_reappearing(async_commit):
    def run(pair):
        for step in (2, 4, 6):
            pair.save(step)
        pair.wait()
        pair.on_disk(_tear_data(6))
        pair.reopen()
        pair.restore()
        pair.on_disk(_reappear(6))
        pair.reopen()
        pair.query("reopened")
        if not async_commit:
            # JAX's sync manager restores nothing beside a step directory
            # that holds no orbax metadata (orbax reads the layout as one
            # of several items), so the resume goes through an
            # async-commit manager, as tests/test_goodput.py's does
            pair.reopen(async_commit=True)
        pair.restore()
        pair.save(8)
        pair.wait()
        pair.query()
    return run


def _async_commits(pair):
    """Snapshots deduplicated, a commit torn in flight, then a queued
    one torn behind an in-flight commit, each resumed."""
    for step in (1, 1, 2, 3):
        pair.save(step)
    pair.wait()
    pair.query()
    pair.tear_in_flight(4)
    pair.save(5)
    pair.query("torn")
    pair.reopen()
    pair.restore()
    pair.tear_in_flight(6, queue=7)
    pair.wait()
    pair.query("torn")
    pair.reopen()
    pair.restore()


def _every_step_fails(pair):
    """A template the checkpoints do not fit re-raises and quarantines
    nothing."""
    for step in (1, 2):
        pair.save(step)
    pair.restore(template=lambda s: {"zz": s.state(0)["m"]})


_SCENARIOS = {
    "save_gate": (_save_gate, dict(score_attribute=None, max_to_keep=10,
                                   save_interval_steps=4)),
    "save_gate_async": (_save_gate, dict(score_attribute=None,
                                         max_to_keep=10,
                                         save_interval_steps=4,
                                         async_commit=True)),
    "recency": (_recency, dict(score_attribute=None, max_to_keep=2)),
    "score_min": (_by_score("min"), dict(max_to_keep=3)),
    "score_max": (_by_score("max"), dict(max_to_keep=2, score_mode="max")),
    "acc_max": (_by_score("max"), dict(max_to_keep=2, score_mode="max",
                                       score_attribute="acc")),
    "score_missing": (_score_missing, dict(max_to_keep=1)),
    "suspect_recency": (_suspect, dict(score_attribute=None,
                                       max_to_keep=2)),
    "suspect_score": (_suspect, dict(max_to_keep=2)),
    "torn_sync": (_torn_then_reappearing(False),
                  dict(score_attribute=None, max_to_keep=4)),
    "torn_async": (_torn_then_reappearing(True),
                   dict(score_attribute=None, max_to_keep=4,
                        async_commit=True)),
    "async_commits": (_async_commits, dict(score_attribute=None,
                                           max_to_keep=3,
                                           async_commit=True)),
    "every_step_fails": (_every_step_fails, dict(score_attribute=None,
                                                 max_to_keep=4)),
}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_manager_decides_as_the_jax_manager(tmp_path, name):
    run, kw = _SCENARIOS[name]
    pair = _Pair(tmp_path, **kw)
    try:
        run(pair)
    finally:
        pair.check()
