"""The port's training loop (``gke_ray_train_tpu_torch/train/loop.py``) and
its pieces against the JAX package's, at tiny dims on the CPU.

Loop parity: the tiny float32 Llama of ``tests/test_torch_port_train.py``
(2 layers, d_model 64, vocab 256, S 128, dense attention), its JAX train
state carried over with ``interop``; both ``run_training`` calls take the
same numpy batches (2 epochs x 3 batches at grad-accum 2), log every 2
steps, eval every 3 steps and at each epoch's end over 10 eval rows at
host batch 4 (a padded tail), with a meter, a report_fn and a
TensorBoard writer, at prefetch 0 and 2, for LoRA and full fine-tuning.
The loss / grad_norm / learning_rate / eval_loss values of the last
metrics and of every report and eval agree within 1e-5 relative (fp32
products and sums in other orders), the trainables within 2e-6 absolute,
epoch / step and the metric keys exactly.

The host arithmetic (goodput ledger, meter, cadence, guard parsing, plan
knobs) is held bitwise against JAX's; the loop's behaviour (preemption,
resume fast-forward with an in-memory checkpoint double, the eval walk,
TensorBoard events, the profiler window, KERNELCHECK, the multi-card
refusals; FAULT_SPEC is tests/test_torch_port_faults.py's) mirrors the JAX package's tests.
"""

import copy
import glob
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu import config as jconfig
from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu.analysis import guards as jguards
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.train import evaluate as jevaluate
from gke_ray_train_tpu.train import loop as jloop
from gke_ray_train_tpu.train import lora as jlora
from gke_ray_train_tpu.train import metrics as jmetrics
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import preempt as jpreempt
from gke_ray_train_tpu.train import step as jstep
from gke_ray_train_tpu.train import tb as jtb
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.analysis import guards as tguards
from gke_ray_train_tpu_torch.analysis import kernelcheck as tkc
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import init_params
from gke_ray_train_tpu_torch.ops import registry as treg
from gke_ray_train_tpu_torch.plan import ExecutionPlan, PlanError
from gke_ray_train_tpu_torch.rayint import get_context
from gke_ray_train_tpu_torch.train import (
    LoraConfig, make_eval_step, make_optimizer, make_train_state,
    make_train_step, sharded_eval_loss, sharded_eval_sums,
    warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train import evaluate as tevaluate
from gke_ray_train_tpu_torch.train import loop as tloop
from gke_ray_train_tpu_torch.train import metrics as tmetrics
from gke_ray_train_tpu_torch.train import preempt as tpreempt
from gke_ray_train_tpu_torch.train import profiling as tprof
from gke_ray_train_tpu_torch.train import tb as ttb
from gke_ray_train_tpu_torch.train.step import (
    TrainState, trainable_tensors)
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


STREAM_RTOL = 1e-5
PARAM_ATOL = 2e-6
V, S, B, ACCUM = 256, 128, 4, 2
LR, TOTAL = 1e-3, 10
EPOCHS, PER_EPOCH, N_EVAL, EVAL_HB = 2, 3, 10, 4
STREAMS = ("loss", "grad_norm", "learning_rate", "eval_loss")


def _batch(seed, n=B):
    r = np.random.default_rng(seed)
    w = np.ones((n, S), np.float32)
    for i, k in enumerate(r.integers(S // 2, S + 1, n)):
        w[i, k:] = 0.0                      # padding tail, weight 0
    return {"inputs": r.integers(0, V, (n, S)).astype(np.int32),
            "targets": r.integers(0, V, (n, S)).astype(np.int32),
            "weights": w}


def _epoch_batches(epoch):
    for i in range(PER_EPOCH):
        yield _batch(100 + 10 * epoch + i)


EVAL_ROWS = _batch(7, n=N_EVAL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_side(mode):
    """JAX state, train step and eval step at the tiny config."""
    jc = jcfg.tiny(vocab_size=V, attn_impl="xla")
    params = jtr.init_params(jc, jax.random.key(0))
    lcfg = jlora.LoraConfig(r=4, alpha=8) if mode == "lora" else None
    sched = joptim.warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    opt = joptim.make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = jstep.make_train_state(jc, opt, jax.random.key(1),
                                   lora_cfg=lcfg, params=params)
    if lcfg is not None:
        # B = 0 at init: a nonzero start gives every path signal
        r = np.random.default_rng(3)
        lora = jax.tree.map(
            lambda x: jnp.asarray(r.standard_normal(x.shape).astype(
                np.float32) * 0.05), state.lora)
        state = state._replace(lora=lora,
                               opt_state=jax.jit(opt.init)(lora))
    step = jstep.make_train_step(jc, opt, lora_cfg=lcfg, grad_accum=ACCUM,
                                 schedule=sched, donate=False)
    return dict(cfg=jc, state=state, step=step, lcfg=lcfg,
                eval_step=jstep.make_eval_step(jc, lora_cfg=lcfg))


def _port_side(jside):
    """The port's state (carried over from JAX's), train and eval step."""
    tc = tcfg.tiny(vocab_size=V, attn_impl="xla")
    jl = jside["lcfg"]
    tl = LoraConfig(r=jl.r, alpha=jl.alpha) if jl is not None else None
    params = interop.params_from_numpy(_np(jside["state"].params), tc,
                                       device="cpu")
    sched = warmup_cosine_schedule(LR, TOTAL, warmup_frac=0.2)
    spec = make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = make_train_state(tc, spec, lora_cfg=tl, params=params,
                             device="cpu")
    if tl is not None:
        src = interop.lora_from_numpy(_np(jside["state"].lora), tc,
                                      device="cpu")
        with torch.no_grad():
            for ours, theirs in zip(state.lora, src):
                for t in ours:
                    for ab in ("a", "b"):
                        ours[t][ab].copy_(theirs[t][ab])
    step = make_train_step(tc, spec, lora_cfg=tl, grad_accum=ACCUM,
                           schedule=sched, device="cpu")
    return dict(cfg=tc, state=state, step=step, lcfg=tl,
                eval_step=make_eval_step(tc, lora_cfg=tl, device="cpu"))


@pytest.fixture(scope="module")
def jax_sides():
    """One JAX side per mode, so its jitted steps compile once."""
    return {mode: _jax_side(mode) for mode in ("lora", "full")}


def _read_scalars(logdir):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util
    out = {}
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        for event in EventFileLoader(path).Load():
            for v in getattr(event.summary, "value", []):
                if v.HasField("tensor"):
                    val = float(tensor_util.make_ndarray(v.tensor))
                else:
                    val = v.simple_value
                out.setdefault(v.tag, []).append((event.step, val))
    return out


def _run(pkg, side, tmp_path, prefetch):
    """run_training of ``pkg`` ("jax" or "torch") on ``side``; returns
    (final state, last metrics, reports, evals, TB scalars)."""
    loop, ev, metrics, tb = {
        "jax": (jloop, jevaluate, jmetrics, jtb),
        "torch": (tloop, tevaluate, tmetrics, ttb)}[pkg]
    reports, evals = [], []

    def eval_fn(st):
        out = {"eval_loss": ev.sharded_eval_loss(
            st, side["eval_step"], EVAL_ROWS, host_batch=EVAL_HB)}
        evals.append(out)
        return out
    kw = {} if pkg == "jax" else {"device": "cpu"}
    meter = metrics.ThroughputMeter(
        side["cfg"], seq_len=S, n_devices=1,
        trainable="lora" if side["lcfg"] is not None else "full", **kw)
    logdir = str(tmp_path / f"tb_{pkg}")
    state, last = loop.run_training(
        side["state"], side["step"], _epoch_batches, epochs=EPOCHS,
        log_every=2, meter=meter, report_fn=reports.append,
        eval_fn=eval_fn, eval_every=3, eval_at_epoch_end=True,
        prefetch=prefetch, tb_writer=tb.TensorBoardWriter(logdir))
    return state, last, reports, evals, _read_scalars(logdir)


def _assert_close_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in ("epoch", "step"):
        if k in want:
            assert got[k] == want[k], k
    for k in STREAMS:
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=STREAM_RTOL,
                                       atol=1e-9, err_msg=k)


def _assert_trainables_match(jstate, tstate, tc, lora):
    if lora:
        want = interop.lora_from_numpy(_np(jstate.lora), tc, device="cpu")
        for ours, theirs in zip(tstate.lora, want):
            for t in ours:
                for ab in ("a", "b"):
                    np.testing.assert_allclose(
                        ours[t][ab].detach().numpy(),
                        theirs[t][ab].numpy(), atol=PARAM_ATOL, rtol=0)
        return
    want = dict(interop.params_from_numpy(_np(jstate.params), tc,
                                          device="cpu").named_parameters())
    for name, p in tstate.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("mode", ["lora", "full"])
def test_run_training_matches_jax(jax_sides, tmp_path, mode, prefetch):
    jside = jax_sides[mode]
    tside = _port_side(jside)
    js, jlast, jrep, jev, jtbs = _run("jax", jside, tmp_path, prefetch)
    ts, tlast, trep, tev, ttbs = _run("torch", tside, tmp_path, prefetch)
    assert int(js.step) == ts.step == EPOCHS * PER_EPOCH
    _assert_close_metrics(tlast, jlast)
    assert "eval_loss" in tlast
    assert len(trep) == len(jrep) == EPOCHS
    for got, want in zip(trep, jrep):
        _assert_close_metrics(got, want)
    # eval at steps 3 and 6 and at each epoch's end (steps 3 and 6)
    assert len(tev) == len(jev) == 4
    for got, want in zip(tev, jev):
        _assert_close_metrics(got, want)
    _assert_trainables_match(js, ts, tside["cfg"], lora=mode == "lora")
    # the TensorBoard events parse back to JAX's tags at JAX's steps
    assert sorted(ttbs) == sorted(jtbs)
    for tag in jtbs:
        assert [s for s, _ in ttbs[tag]] == [s for s, _ in jtbs[tag]], tag
    for tag in STREAMS:
        np.testing.assert_allclose([v for _, v in ttbs[tag]],
                                   [v for _, v in jtbs[tag]],
                                   rtol=STREAM_RTOL, err_msg=tag)


# -- preemption ---------------------------------------------------------------

class MemCkpt:
    """An in-memory checkpoint manager double: the duck-typed interface
    ``run_training`` calls. ``copy_fn(view)`` makes the stored snapshot,
    ``restore_fn(snapshot, template)`` the restored view."""

    def __init__(self, copy_fn=lambda st: st,
                 restore_fn=lambda snap, template: snap):
        self.saved = {}
        self.copy_fn, self.restore_fn = copy_fn, restore_fn
        self.async_commit = False
        self.last_restore_source = None

    def restore_if_available(self, template):
        if not self.saved:
            return None, None
        step = max(self.saved)
        return self.restore_fn(self.saved[step], template), step

    def save(self, step, view, metrics=None, force=False):
        self.saved[step] = self.copy_fn(view)

    def wait(self):
        pass

    def latest_step(self):
        return max(self.saved) if self.saved else None


def _port_copy(st, spec=None):
    """A snapshot of a port TrainState that later steps do not touch:
    params and adapters copied, the optimizer rebuilt over the copies
    from ``spec`` (default the state's; the step checks it by identity)
    with its moments and update count."""
    params, lora = copy.deepcopy(st.params), copy.deepcopy(st.lora)
    opt = (spec or st.opt_state.spec).build(trainable_tensors(params, lora))
    opt.load_state_dict(copy.deepcopy(st.opt_state.state_dict()))
    opt.count = st.opt_state.count
    return TrainState(params=params, lora=lora, opt_state=opt, step=st.step)


def _port_ckpt():
    """The double for port states: restored over the template's spec."""
    return MemCkpt(_port_copy,
                   lambda snap, tpl: _port_copy(snap, tpl.opt_state.spec))


@pytest.mark.parametrize("at", [2, 4])
def test_preemption_raises_at_the_same_step_as_jax(jax_sides, at):
    """``preempt.request()`` during step ``at``: both loops force-save
    step ``at`` into the checkpoint double and raise ``Preempted`` at the
    next boundary, with the ledger attached."""
    jside = jax_sides["lora"]
    tside = _port_side(jside)
    out = {}
    for pkg, side, mod, loop, make_mgr in (
            ("jax", jside, jpreempt, jloop, MemCkpt),
            ("torch", tside, tpreempt, tloop, _port_ckpt)):
        calls = [0]

        def step(state, batch, side=side, mod=mod, calls=calls):
            calls[0] += 1
            if calls[0] == at:
                mod.request(source="test")
            return side["step"](state, batch)
        mgr = make_mgr()
        mod.reset()
        try:
            with pytest.raises(mod.Preempted) as ei:
                loop.run_training(side["state"], step, _epoch_batches,
                                  epochs=EPOCHS, log_every=1,
                                  ckpt_manager=mgr)
        finally:
            mod.reset()
        out[pkg] = (ei.value, sorted(mgr.saved))
    (je, jsaved), (te, tsaved) = out["jax"], out["torch"]
    assert te.step == je.step == at
    # the forced save at the exit step, beside epoch 0's end-of-epoch save
    assert tsaved == jsaved == ([PER_EPOCH] if at > PER_EPOCH else []) + [at]
    assert te.save_s is not None and te.resumed_step is None
    assert sorted(te.ledger) == sorted(je.ledger) == \
        sorted(tmetrics.LEDGER_TERMS)
    assert get_context().goodput == te.ledger


# -- resume fast-forward (mirrors tests/test_resume_skip.py) ------------------

def _tiny_port():
    cfg = tcfg.tiny(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                    n_kv_heads=2, d_ff=64, max_seq_len=16)
    spec = make_optimizer(1e-3)
    state = make_train_state(cfg, spec, params=init_params(
        cfg, seed=0, device="cpu"), device="cpu")
    step = make_train_step(cfg, spec, device="cpu")
    calls = [0]

    def counted(st, b):
        calls[0] += 1
        return step(st, b)

    def batches(epoch):
        r = np.random.default_rng(epoch)
        for _ in range(4):
            yield {"inputs": r.integers(0, 64, (2, 16)).astype(np.int32),
                   "targets": r.integers(0, 64, (2, 16)).astype(np.int32),
                   "weights": np.ones((2, 16), np.float32)}
    return state, counted, batches, calls


def test_finished_checkpoint_resumes_to_zero_new_steps():
    mgr = _port_ckpt()
    state, step, batches, _ = _tiny_port()
    final, _ = tloop.run_training(state, step, batches, epochs=1,
                                  ckpt_manager=mgr)
    assert final.step == 4 and mgr.latest_step() == 4
    state2, step2, _, calls = _tiny_port()
    final2, _ = tloop.run_training(state2, step2, batches, epochs=1,
                                   ckpt_manager=mgr)
    assert final2.step == 4 and calls[0] == 0
    assert get_context().resumed_step == 4


def test_midepoch_checkpoint_trains_only_remainder():
    import itertools
    mgr = _port_ckpt()
    state, step, batches, _ = _tiny_port()
    tloop.run_training(state, step,
                       lambda e: itertools.islice(batches(e), 2),
                       epochs=1, ckpt_manager=mgr, ckpt_every=2)
    assert mgr.latest_step() == 2
    state2, step2, _, calls = _tiny_port()
    final2, _ = tloop.run_training(state2, step2, batches, epochs=1,
                                   ckpt_manager=mgr)
    assert final2.step == 4 and calls[0] == 2
    led = get_context().goodput
    assert led["restore_s"] > 0 and led["fast_forward_s"] >= 0
    # the resumed run ends where an uninterrupted one does
    state3, step3, _, _ = _tiny_port()
    final3, _ = tloop.run_training(state3, step3, batches, epochs=1)
    for (name, a), (_, b) in zip(
            trainable_tensors(final2.params, final2.lora),
            trainable_tensors(final3.params, final3.lora)):
        assert torch.equal(a, b), name


def test_resumed_run_with_empty_epoch_still_raises():
    mgr = _port_ckpt()
    state, step, batches, _ = _tiny_port()
    tloop.run_training(state, step, batches, epochs=1, ckpt_manager=mgr)
    state2, step2, _, _ = _tiny_port()
    with pytest.raises(ValueError, match="0 batches"):
        tloop.run_training(state2, step2, lambda e: iter(()), epochs=1,
                           ckpt_manager=mgr)


# -- the eval walk (mirrors tests/test_evaluate.py) ---------------------------

@pytest.mark.parametrize("n_rows", [10, 7])
def test_sharded_eval_matches_full_walk_and_jax(jax_sides, n_rows):
    """Two shards of the walk sum to the full walk, which equals JAX's
    ``sharded_eval_loss``; padding adds no weight."""
    jside = jax_sides["lora"]
    tside = _port_side(jside)
    rows = {k: v[:n_rows] for k, v in EVAL_ROWS.items()}
    calls = [0]

    def counted(st, b):
        calls[0] += 1
        return tside["eval_step"](st, b)
    full = sharded_eval_loss(tside["state"], counted, rows, host_batch=2)
    assert calls[0] == -(-n_rows // 2)
    want = jevaluate.sharded_eval_loss(jside["state"], jside["eval_step"],
                                       rows, host_batch=2)
    np.testing.assert_allclose(full, want, rtol=STREAM_RTOL)
    calls[0] = 0
    parts = [sharded_eval_sums(tside["state"], counted, rows, host_batch=2,
                               in_shards=2, in_shard_id=i) for i in range(2)]
    assert calls[0] == 2 * -(-n_rows // 4)
    np.testing.assert_allclose(sum(p[0] for p in parts)
                               / sum(p[1] for p in parts), full, rtol=1e-6)
    np.testing.assert_allclose(sum(p[1] for p in parts),
                               rows["weights"].sum(), rtol=1e-6)


# -- host arithmetic, bitwise against JAX ----------------------------------

class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.125
        return self.t


def test_goodput_ledger_and_cadence_equal_jax_bitwise(monkeypatch):
    out = {}
    for pkg, mod in (("jax", jmetrics), ("torch", tmetrics)):
        monkeypatch.setattr(time, "perf_counter", FakeClock())
        led = mod.GoodputLedger()
        led.note("compile_s", 1.5)
        led.note("restore_s", 0.25)
        led.note("bogus", 9.0)
        led.note("fast_forward_s", -3.0)
        led.data_wait(0.375)
        led.data_wait(-1.0)
        with mod.paused(led):
            pass
        led.pause()
        led.note("ckpt_async_s", 0.5)
        led.close(10.0)
        led.close(99.0)
        d = led.as_dict()
        fin = mod.finish_ledger(d, 12.0)
        out[pkg] = (d, fin, mod.finish_ledger(None, 3.0),
                    mod.sum_ledgers([fin, mod.finish_ledger(d, 20.0)]),
                    mod.sum_ledgers([]), mod.ledger_metrics(fin),
                    mod.ledger_metrics(d))
    assert out["torch"] == out["jax"]
    assert tmetrics.LEDGER_TERMS == jmetrics.LEDGER_TERMS
    fin = out["torch"][1]
    assert sum(fin[t] for t in tmetrics.LEDGER_TERMS) == fin["wall_s"]
    for cfg in ({}, {"SAVE_STRATEGY": "epoch", "EVAL_STEPS_SFT": 7},
                {"SAVE_STRATEGY": "NO", "EVALUATION_STRATEGY_SFT": "epoch"},
                {"SAVE_STRATEGY": "bogus", "EVALUATION_STRATEGY_SFT": "no",
                 "SAVE_STEPS_SFT": "11"}):
        assert tconfig.cadence_from_config(cfg) == \
            jconfig.cadence_from_config(cfg), cfg


@pytest.mark.parametrize("trainable", ["lora", "full"])
def test_throughput_meter_snapshot_equals_jax_bitwise(monkeypatch,
                                                      trainable):
    jm = jmetrics.ThroughputMeter(jcfg.llama3_8b(), seq_len=1024,
                                  n_devices=2, trainable=trainable)
    tm = tmetrics.ThroughputMeter(tcfg.llama3_8b(), seq_len=1024,
                                  n_devices=2, trainable=trainable,
                                  device="cpu")
    assert tm.peak_flops == jm.peak_flops == 1e12
    snaps = {}
    for pkg, m in (("jax", jm), ("torch", tm)):
        monkeypatch.setattr(time, "perf_counter", FakeClock())
        m.reset()
        seq = []
        m.update(2048)
        m.data_wait(0.03)
        seq.append(m.snapshot())
        m.pause()
        seq.append(m.snapshot())            # mid-pause
        m.resume()
        m.pause()
        m.pause()                            # idempotent
        m.resume()
        m.update(4096)
        m.data_wait(-1.0)
        seq.append(m.snapshot())
        snaps[pkg] = seq
    assert snaps["torch"] == snaps["jax"]


def test_meter_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.ThroughputMeter(tcfg.tiny(), seq_len=128, n_devices=1)
    m = tmetrics.ThroughputMeter(tcfg.tiny(), seq_len=128, n_devices=1,
                                 peak_flops=5e12)
    assert m.peak_flops == 5e12
    assert tmetrics.peak_flops_per_device("NVIDIA H100 80GB HBM3") == 989e12


GUARD_STRINGS = ["", "0", "off", "false", "allow", "log", "disallow",
                 "LOG", " Disallow ", "bogus"]


@pytest.mark.parametrize("raw", GUARD_STRINGS)
def test_guard_knobs_parse_like_jax(monkeypatch, raw):
    assert tguards.transfer_guard_mode({"TRANSFER_GUARD": raw}) == \
        jguards.transfer_guard_mode({"TRANSFER_GUARD": raw})
    monkeypatch.setenv("TRANSFER_GUARD", raw)
    monkeypatch.setenv("DIVERGENCE_GUARD", raw)
    assert tguards.transfer_guard_mode() == jguards.transfer_guard_mode()
    assert tguards.divergence_guard_enabled() == \
        jguards.divergence_guard_enabled()
    tg, jg = tguards.RuntimeGuards.from_config(), \
        jguards.RuntimeGuards.from_config()
    assert (tg.transfer_mode, tg.divergence) == \
        (jg.transfer_mode, jg.divergence)


def test_plan_loop_knobs_match_jax_and_leave_the_fingerprint():
    env = {"PREFETCH_BATCHES": "3", "TRANSFER_GUARD": "Disallow",
           "DIVERGENCE_GUARD": "yes"}
    ours, theirs = ExecutionPlan.resolve(env=env), \
        jplan.ExecutionPlan.resolve(env=env)
    for f in ("prefetch", "transfer_guard", "divergence_guard"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ExecutionPlan.resolve(env={}).prefetch == \
        jplan.ExecutionPlan().prefetch == 2
    assert ExecutionPlan.resolve(config={"TRANSFER_GUARD": "off"},
                                 env={}).transfer_guard is None
    g = ours.runtime_guards()
    assert (g.transfer_mode, g.divergence) == ("disallow", True)
    assert ours.fingerprint() == ExecutionPlan().fingerprint()
    assert ExecutionPlan(grad_accum=2).fingerprint() != \
        ExecutionPlan().fingerprint()
    for bad in ({"PREFETCH_BATCHES": "-1"}, {"TRANSFER_GUARD": "bogus"},
                {"DIVERGENCE_GUARD": "maybe"}, {"PREFETCH_BATCHES": "x"}):
        with pytest.raises(PlanError):
            ExecutionPlan.resolve(env=bad)


def test_guards_on_cpu_and_the_multi_card_refusals(monkeypatch):
    """Without CUDA the transfer guard does nothing. In a world above 1
    (refused until it was ported) the divergence guard exchanges the
    step's identity and raises on a mismatch, and the loop asks the
    ranks to agree on preemption every PREEMPT_SYNC_EVERY boundaries
    only (the real collectives run in test_torch_port_multirank.py)."""
    with tguards.transfer_guard_ctx("disallow"), tguards.allow_transfers():
        pass
    g = tguards.RuntimeGuards(transfer_mode="disallow", divergence=True)
    assert g.check_divergence(None, None, None) is None   # one process
    state, step, batches, _ = _tiny_port()
    monkeypatch.setattr(tguards, "world_size", lambda: 2)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    mine = tguards.step_identity_text(step, state)
    monkeypatch.setattr(tguards, "_all_gather",
                        lambda v: [v, v])
    assert g.check_divergence(step, state, None) == \
        tguards.hashlib.sha256(mine.encode()).hexdigest()
    monkeypatch.setattr(tguards, "_all_gather",
                        lambda v: [v, "other " + v])
    with pytest.raises(tguards.StepDivergenceError, match="rank 1"):
        g.check_divergence(step, state, None)
    monkeypatch.setattr(tloop, "world_size", lambda: 2)
    asked = []
    monkeypatch.setattr(tloop, "agree_preempt",
                        lambda local: asked.append(local) or False)
    monkeypatch.setenv("PREEMPT_SYNC_EVERY", "2")
    tloop.run_training(state, step, batches, epochs=1)
    assert len(asked) >= 1 and not any(asked)


# -- the rest of the loop's hooks --------------------------------------------

def test_kernelcheck_knob_runs_quick_verify_with_a_log(monkeypatch):
    seen = []
    monkeypatch.setattr(tkc, "quick_verify",
                        lambda device=None, log=None: seen.append(
                            (device, log)))
    monkeypatch.setenv("KERNELCHECK", "1")
    state, step, batches, _ = _tiny_port()
    hb = []
    tloop.run_training(state, step, batches, epochs=1,
                       heartbeat_fn=lambda s, done=False: hb.append((s, done)))
    assert seen == [(torch.device("cpu"), tloop.logger.info)]
    assert hb == [(1, False), (2, False), (3, False), (4, False), (4, True)]


def test_quick_verify_logs_one_line_per_case():
    lines = []
    results = tkc.quick_verify(device="cpu",
                               log=lambda fmt, *a: lines.append(fmt % a))
    assert len(lines) == len(results) == len(treg.all_kernels())
    for r, line in zip(results, lines):
        assert line.startswith(f"KERNELCHECK: {r.kernel}/{r.case} on cpu")


def test_tb_writer_matches_jax_and_honors_report_to(tmp_path):
    """The port's writer parses back to what JAX's wrote; non-numbers
    are skipped and counted out."""
    logs = [(10, {"loss": 2.5, "learning_rate": 1e-4, "mfu": 0.41,
                  "note": "not-a-number", "flag": True}),
            (20, {"loss": 2.0, "eval_loss": 2.2})]
    got = {}
    for pkg, mod in (("jax", jtb), ("torch", ttb)):
        w = mod.TensorBoardWriter(str(tmp_path / pkg))
        for step, m in logs:
            w.log(step, m)
        if pkg == "torch":
            assert w.backend == "tensorboardX" and w.scalars == 5
        w.close()
        got[pkg] = _read_scalars(str(tmp_path / pkg))
    assert got["torch"] == got["jax"]
    assert [s for s, _ in got["torch"]["loss"]] == [10, 20]
    assert "note" not in got["torch"] and "flag" not in got["torch"]
    assert ttb.writer_from_config({}, str(tmp_path)) is None
    assert ttb.writer_from_config({"REPORT_TO": "wandb"},
                                  str(tmp_path)) is None
    assert ttb.writer_from_config({"REPORT_TO": "tensorboard"},
                                  str(tmp_path), is_host0=False) is None
    w = ttb.writer_from_config({"REPORT_TO": "tensorboard"},
                               str(tmp_path / "cfg"))
    assert w is not None

    class Registry:
        def snapshot(self):
            return {"labels": {"a": 1}, "goodput_frac": 0.5,
                    "lat": {"p50": 1.0, "p99": 2.0}}
    w.log_registry(3, Registry())
    w.close()
    assert sorted(_read_scalars(str(tmp_path / "cfg"))) == \
        ["obs/goodput_frac", "obs/lat_p50", "obs/lat_p99"]


def test_trace_profiler_writes_only_inside_its_window(tmp_path):
    """start_step 2, num_steps 2 over steps 1-6: tracing runs after step
    2 until step 4, active only then; one trace, none before or after."""
    logdir = str(tmp_path / "prof")
    prof = tprof.TraceProfiler(logdir, start_step=2, num_steps=2)
    x = torch.ones(64, 64)
    states = []
    for step in range(1, 7):
        x = x * 2 + 1
        prof.step(step)
        states.append((prof.active,
                       len(glob.glob(os.path.join(logdir, "*.json")))))
    prof.close()
    assert states == [(False, 0), (True, 0), (True, 0), (False, 1),
                      (False, 1), (False, 1)]
    assert prof.trace_path is not None and os.path.isfile(prof.trace_path)
    assert prof.trace_path.endswith(".pt.trace.json")
    assert tprof.profiler_from_config({}, str(tmp_path)) is None
    p = tprof.profiler_from_config({"PROFILE": True, "PROFILE_START_STEP": 3,
                                    "PROFILE_NUM_STEPS": 2}, str(tmp_path))
    assert p.start_step == 3 and p.stop_step == 5
    p2 = tprof.profiler_from_config({"PROFILE": str(tmp_path / "custom")},
                                    str(tmp_path))
    assert p2.logdir.endswith("custom")


def test_run_training_with_profiler_traces_the_step(tmp_path):
    state, step, batches, _ = _tiny_port()
    prof = tprof.TraceProfiler(str(tmp_path / "prof"), start_step=1,
                               num_steps=1)
    tloop.run_training(state, step, batches, epochs=1, log_every=2,
                       profiler=prof)
    assert prof._done and not prof.active
    import json
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in (n or "") or "mm" in (n or "") for n in names)


def test_debug_nans_turns_on_anomaly_detection():
    before = torch.is_anomaly_enabled()
    try:
        tprof.apply_debug_flags({})
        assert torch.is_anomaly_enabled() == before
        tprof.apply_debug_flags({"DEBUG_NANS": True})
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_loop_logs_meter_and_context(caplog):
    state, step, batches, _ = _tiny_port()
    meter = tmetrics.ThroughputMeter(tcfg.tiny(vocab_size=64, d_model=32,
                                               n_layers=1, n_heads=2,
                                               n_kv_heads=2, d_ff=64),
                                     seq_len=16, n_devices=1, device="cpu")
    with caplog.at_level(logging.INFO, logger=tloop.logger.name):
        _, last = tloop.run_training(state, step, batches, epochs=1,
                                     log_every=2, meter=meter)
    assert sum("tok/s/chip" in r.message for r in caplog.records) == 2
    led = get_context().goodput
    assert sorted(led) == sorted(tmetrics.LEDGER_TERMS)
    assert led["compile_s"] == last["compile_s"] > 0
    assert led["restore_s"] == 0 and led["lost_s"] == 0
    assert 0 <= last["data_stall_frac"] <= 1
