"""The port's pre-train entry (``gke_ray_train_tpu_torch/pretrain.py``)
against the JAX package's (``ray-jobs/pretrain_llm_ray.py``, loaded as
``tests/test_entry_smoke.py`` loads an entry), on the CPU:

- both workers on the same corpus files (JAX's rank 0 writes them, the
  port reads them) at d 64 / 2 layers / 4 heads / seq 32 in fp32, the
  port started from JAX's seed-0 weights (carried in through
  ``interop.params_from_numpy`` by wrapping the port's
  ``make_train_state``): every step's loss within 1e-4 relative, read
  through each package's ``run_training``; JAX's mesh is cut to one
  device (the suite has 8 fake ones) and its compile cache and AOT
  sidecar are off;
- the port's tokenizer file beside the checkpoints loads in JAX's
  ``CharTokenizer``, ids alike;
- a kill at step 5, retried by ``TorchTrainer`` from the step-4 save,
  ends bitwise on the uninterrupted run (losses and the last checkpoint);
- ``main`` exits 0 on the smoke config and 1 when the worker fails.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from gke_ray_train_tpu import train as jtrain
from gke_ray_train_tpu.data import load_saved_tokenizer as jload_tokenizer
from gke_ray_train_tpu.rayint import elastic as jelastic
from gke_ray_train_tpu.train import loop as jloop
from gke_ray_train_tpu_torch import pretrain
from gke_ray_train_tpu_torch.ckpt import CheckpointManager
from gke_ray_train_tpu_torch.interop import params_from_numpy
from gke_ray_train_tpu_torch.rayint import (
    FailureConfig, RunConfig, TorchTrainer)
from gke_ray_train_tpu_torch.testing import faults
from gke_ray_train_tpu_torch.train import preempt
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    mr.clear_rendezvous(monkeypatch)
    monkeypatch.delenv("FAULT_SPEC", raising=False)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("COMPILE_CACHE", "0")
    monkeypatch.setenv("AOT_TRAIN_STEP", "0")
    faults.reset_fired()
    yield
    faults.reset_fired()
    preempt.reset()
    preempt.uninstall()


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "pretrain_entry_parity",
        os.path.join(REPO, "ray-jobs", "pretrain_llm_ray.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(tmp_path, name, **over):
    config = {"d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 128,
              "dataset_seq_len": 32, "model_max_seq_len": 64,
              "batch_size_per_device": 4, "max_samples": 32,
              "lr": 1e-3, "weight_decay": 0.01, "warmup_frac": 0.25,
              "min_lr_frac": 0.01, "grad_clip": 1.0, "epochs": 1,
              "log_every": 1, "prefetch_batches": 0, "dtype": "float32",
              "data_dir": str(tmp_path / "data"),
              "storage_path": str(tmp_path / name), "run_name": "lm"}
    config.update(over)
    return config


def _recording(run_training, losses):
    """``run_training`` with its step wrapped to read each loss."""
    def wrapped(state, step_fn, *a, **kw):
        def step(st, batch):
            st, m = step_fn(st, batch)
            losses.append(float(np.asarray(m["loss"])))
            return st, m
        return run_training(state, step, *a, **kw)
    return wrapped


def test_port_worker_matches_the_jax_worker(tmp_path, monkeypatch):
    entry = _jax_entry()
    monkeypatch.setattr(jelastic, "maybe_replan",
                        lambda plan, **kw: (plan, jax.devices()[:1]))
    jax_params = {}
    orig_state = jtrain.make_train_state

    def jax_state(cfg, opt, key, **kw):
        state = orig_state(cfg, opt, key, **kw)
        jax_params["tree"] = jax.tree.map(np.asarray, state.params)
        return state
    monkeypatch.setattr(jtrain, "make_train_state", jax_state)
    jax_losses, port_losses = [], []
    monkeypatch.setattr(jloop, "run_training",
                        _recording(jloop.run_training, jax_losses))
    entry.train_loop_per_worker(_config(tmp_path, "jax"))

    orig_port_state = pretrain.make_train_state

    def port_state(cfg, opt, seed=0, *, device=None, mesh=None):
        params = params_from_numpy(jax_params["tree"], cfg, device=device)
        return orig_port_state(cfg, opt, seed, device=device, mesh=mesh,
                               params=params)
    monkeypatch.setattr(pretrain, "make_train_state", port_state)
    monkeypatch.setattr(pretrain, "run_training",
                        _recording(pretrain.run_training, port_losses))
    metrics = pretrain.train_loop_per_worker(_config(tmp_path, "port"),
                                             device="cpu")
    assert len(jax_losses) == len(port_losses) == 8
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert metrics["step"] == 8
    # the port's tokenizer beside its checkpoints, read by JAX
    run_dir = str(tmp_path / "port" / "lm")
    jtok = jload_tokenizer(run_dir)
    from gke_ray_train_tpu_torch.data import CharTokenizer
    ttok = CharTokenizer.load(str(tmp_path / "data" / "char_tokenizer.json"))
    text = "The first album = History =\n"
    assert type(jtok).__name__ == "CharTokenizer"
    assert list(jtok.encode(text)) == list(ttok.encode(text))
    assert jtok.vocab_size == ttok.vocab_size


def _run(tmp_path, name, spec=None, max_failures=0):
    losses = {}
    orig = pretrain.make_train_step
    orig_run = pretrain.run_training

    def make_train_step(*a, **kw):
        step = orig(*a, **kw)

        def recorded(st, batch):
            st, m = step(st, batch)
            losses[int(st.step)] = float(m["loss"])
            return st, m
        return recorded
    pretrain.make_train_step = make_train_step
    # a save every 2 steps (the entry saves once an epoch)
    pretrain.run_training = functools.partial(orig_run, ckpt_every=2)
    if spec:
        os.environ["FAULT_SPEC"] = spec
    try:
        res = TorchTrainer(
            functools.partial(pretrain.train_loop_per_worker, device="cpu"),
            train_loop_config=_config(tmp_path, name),
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=max_failures),
                retry_backoff_s=0.0),
            use_ray=False).fit()
    finally:
        pretrain.make_train_step, pretrain.run_training = orig, orig_run
        os.environ.pop("FAULT_SPEC", None)
    mgr = CheckpointManager(str(tmp_path / name / "lm"),
                            score_attribute=None)
    return res, losses, mgr.latest_step(), mgr.restore_raw()


def test_a_kill_resumed_by_the_trainer_ends_on_the_uninterrupted_run(
        tmp_path):
    ref, ref_losses, ref_step, ref_ckpt = _run(tmp_path, "ref")
    res, losses, step, ckpt = _run(tmp_path, "kill", "kind=kill:step=5", 1)
    assert ref.error is None and res.error is None
    assert [e["status"] for e in res.attempt_log] == ["failed", "ok"]
    assert res.attempt_log[1]["resumed_step"] == 4
    assert losses == ref_losses and sorted(losses) == list(range(1, 9))
    assert step == ref_step == 8

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    a, b = dict(flat(ref_ckpt)), dict(flat(ckpt))
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_main_exit_codes(tmp_path, monkeypatch):
    monkeypatch.setenv("SMOKE_TEST", "1")
    monkeypatch.setenv("MAX_SAMPLES", "8")
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("STORAGE_PATH", str(tmp_path / "runs"))
    monkeypatch.setenv("PREFETCH_BATCHES", "0")
    orig = pretrain.train_loop_per_worker
    # no card here: the default device fails the attempt, and main says 1
    assert not torch.cuda.is_available()
    assert pretrain.main() == 1
    monkeypatch.setattr(pretrain, "train_loop_per_worker",
                        functools.partial(orig, device="cpu"))
    assert pretrain.main() == 0
    assert CheckpointManager(
        str(tmp_path / "runs" / "basic_lm_pretrain"),
        score_attribute=None).latest_step() == 2
    assert pretrain.job_config({"SMOKE_TEST": "1"})["max_samples"] == 1600
    assert "max_samples" not in pretrain.job_config({})
