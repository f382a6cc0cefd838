"""The port's config surface (``gke_ray_train_tpu_torch/config.py``), the
H100 peak table and the GPU fine-tune entry
(``gke_ray_train_tpu_torch/fine_tune.py``) against the JAX package, on
the CPU:

- every repo config audits with no unknown key in both packages, and the
  TPU-only keys warn by name in the port;
- ``schedule_from_config`` equals optax's schedules at every step, for
  the four kinds and the fallback;
- ``optimizer_from_config`` takes the step optax takes, per kind;
  ``adafactor`` raises;
- ``quant_kind_from_config`` (and its ``BNB_4BIT_QUANT_TYPE`` fallback)
  answers as JAX's;
- the peak table: SXM, PCIe, NVL, and an unknown H100 variant warns;
- the port's ``train_loop_per_worker`` and JAX's (loaded as
  ``tests/test_entry_smoke.py`` loads it, on a one-device mesh) run the
  same smoke config from the same HF directory JAX's
  ``save_hf_checkpoint`` wrote: in full fine-tuning the per-step and eval
  losses agree within 1e-4 relative (fp32) and the exported tensors
  within one bf16 ulp; under LoRA the first step's loss agrees (B = 0;
  the adapters' initialisations differ by design);
- the port's entry preempted after step 3 and resumed ends on the
  checkpoint and export of an uninterrupted run, bitwise;
- ``INFERENCE`` and ``SERVE_AFTER_TRAIN``: each switch writes its file
  alone (``"0"`` in the environment keeps the smoke off); with both on,
  the full fine-tuning run above writes JAX's
  ``inference_comparison.json`` answers and ``serve_smoke.json`` counts,
  and the LoRA run JAX's base answers and the smoke's tenant counts (its
  tuned adapters start apart by design);
- ``main`` exits 1 without a card and prints the ``flagship_final``
  line last.
"""

import glob
import importlib.util
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import safetensors.torch as st_torch
import torch

from gke_ray_train_tpu import config as jconfig
from gke_ray_train_tpu.ckpt import hf_io as jhf
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch import fine_tune
from gke_ray_train_tpu_torch.ckpt import CheckpointManager
from gke_ray_train_tpu_torch.ckpt import hf_io as thf
from gke_ray_train_tpu_torch.rayint import get_context
from gke_ray_train_tpu_torch.train import metrics as tmetrics
from gke_ray_train_tpu_torch.train import preempt
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "ray-jobs", "*.json")))


# -- config surface ----------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_repo_configs_audit_clean_and_tpu_keys_warn(path, caplog):
    with open(path) as f:
        config = json.load(f)
    assert tconfig.KNOWN_KEYS == jconfig.KNOWN_KEYS
    assert tconfig.PLAN_SCOPED_KEYS == jconfig.PLAN_SCOPED_KEYS
    with caplog.at_level(logging.WARNING, logger="gke_ray_train_tpu_torch"):
        assert tconfig.audit_config(config) == []
    assert jconfig.audit_config(config) == []
    tpu = tconfig.tpu_only_keys(config)
    assert tpu and all(k in config for k in tpu)
    for k in tpu:
        assert any(k in r.getMessage() for r in caplog.records), k
    if "offline_8b" in path:
        # OVERLAP is the port's since train/overlap.py: read, not warned
        assert tpu == ["AOT_TRAIN_STEP", "COMPILE_CACHE_DIR", "MESH_DATA",
                       "MESH_FSDP", "TOPOLOGY"]
    assert "OVERLAP" not in tpu
    assert not any("OVERLAP" in r.getMessage() for r in caplog.records)


def test_entry_hands_the_plan_overlap_and_does_not_warn(
        tmp_path, monkeypatch, offline, caplog):
    """The shipped configs' ``OVERLAP: xla`` reaches the plan the entry
    hands ``make_train_step`` (whose first step on a mesh registers
    FSDP2's prefetch), and no warning names it; the run stops at the
    step's construction."""
    seen = {}

    class Built(Exception):
        pass

    def make_train_step(*a, plan=None, **kw):
        seen["plan"] = plan
        raise Built()
    monkeypatch.setattr(fine_tune, "make_train_step", make_train_step)
    with caplog.at_level(logging.WARNING, logger="gke_ray_train_tpu_torch"):
        with pytest.raises(Built):
            fine_tune.train_loop_per_worker(
                _smoke_config(tmp_path, OVERLAP="xla"), device="cpu")
    assert seen["plan"].overlap == "xla"
    assert "OVERLAP" not in caplog.text


def test_entry_reads_the_dcn_keys_and_does_not_warn(
        tmp_path, monkeypatch, offline, caplog):
    """``DCN_SYNC`` and ``DCN_COMPRESS`` reach the plan the entry hands
    ``make_train_step`` and no warning names them as TPU keys; one
    process ignores ``NUM_SLICES`` (it warns, and the plan runs one
    slice), a world above one reads it with the mesh keys."""
    seen = {}

    class Built(Exception):
        pass

    def make_train_step(*a, plan=None, **kw):
        seen["plan"] = plan
        raise Built()
    monkeypatch.setattr(fine_tune, "make_train_step", make_train_step)
    keys = dict(OVERLAP="xla", NUM_SLICES=2, DCN_SYNC="flat",
                DCN_COMPRESS="none")
    with caplog.at_level(logging.WARNING, logger="gke_ray_train_tpu_torch"):
        with pytest.raises(Built):
            fine_tune.train_loop_per_worker(
                _smoke_config(tmp_path, **keys), device="cpu")
    plan = seen["plan"]
    assert (plan.num_slices, plan.dcn_sync, plan.dcn_compress) == (
        1, "flat", "none")
    assert "DCN_SYNC" not in caplog.text
    assert "DCN_COMPRESS" not in caplog.text
    assert "NUM_SLICES" in caplog.text
    assert tconfig.tpu_only_keys(keys, world=4) == []


def test_audit_warns_unknown_keys_and_nested_quant(caplog):
    config = {"MODEL_ID": "x", "BOGUS": 1, "_comment": "c",
              "USE_NESTED_QUANT": True, "AUTOTUNE": 1, "ELASTIC": True}
    with caplog.at_level(logging.WARNING, logger="gke_ray_train_tpu_torch"):
        assert tconfig.audit_config(config) == ["BOGUS"] == \
            jconfig.audit_config(config)
    text = caplog.text
    assert "BOGUS" in text and "USE_NESTED_QUANT" in text
    # AUTOTUNE is the TPU's; ELASTIC the port honours (rayint/elastic.py)
    assert "AUTOTUNE" in text and "ELASTIC" not in text


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant",
                                  "constant_with_warmup", "bogus"])
def test_schedule_from_config_equals_optax(kind):
    for total, ratio in ((125, 0.03), (10, 0.2), (1, 0.05)):
        config = {"LEARNING_RATE": 3e-4, "WARMUP_RATIO": ratio,
                  "LR_SCHEDULER_TYPE": kind}
        want = jconfig.schedule_from_config(config, total)
        got = tconfig.schedule_from_config(config, total)
        for step in range(total + 5):
            # optax forms the value in fp32: a few of its ulps at the LR
            assert abs(got(step) - float(want(step))) <= 2e-7 * 3e-4, \
                (total, step)


@pytest.mark.parametrize("name", ["adamw", "adam", "paged_adamw_32bit",
                                  "sgd", "bogus"])
def test_optimizer_from_config_takes_optax_step(name):
    config = {"OPTIM": name, "WEIGHT_DECAY": 0.05, "MAX_GRAD_NORM": 0.5}
    jsched = jconfig.schedule_from_config({"LR_SCHEDULER_TYPE": "constant",
                                           "LEARNING_RATE": 1e-2}, 10)
    r = np.random.default_rng(0)
    init = {"wq": r.standard_normal((6, 5)).astype(np.float32),
            "attn_norm": r.standard_normal(5).astype(np.float32)}
    jopt = jconfig.optimizer_from_config(config, jsched)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    spec = tconfig.optimizer_from_config(config, lambda c: 1e-2)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in init.items()}
    topt = spec.build(tparams.items())
    for step in range(3):
        grads = {k: r.standard_normal(v.shape).astype(np.float32)
                 for k, v in init.items()}
        upd, jstate = jopt.update({k: jnp.asarray(g)
                                   for k, g in grads.items()}, jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
        for k in init:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-7,
                                       rtol=0, err_msg=f"{name} {k} {step}")
    assert spec.kind == ("sgd" if name == "sgd" else "adamw")


def test_adafactor_raises_naming_the_roadmap():
    """OPTIM=adafactor raised until it was ported; it now builds the
    clip + adafactor chain JAX's config builds (optax's defaults, the
    decay rate WEIGHT_DECAY or none), tested against optax in
    test_torch_port_remat_adafactor.py."""
    spec = tconfig.optimizer_from_config({"OPTIM": "adafactor"}, 1e-3)
    assert (spec.kind, spec.eps, spec.clip_norm, spec.weight_decay) == (
        "adafactor", 1e-30, 0.3, 0.001)
    assert (spec.decay_rate, spec.min_dim_size_to_factor,
            spec.clipping_threshold, spec.multiply_by_parameter_scale) == (
        0.8, 128, 1.0, True)
    spec = tconfig.optimizer_from_config(
        {"OPTIM": "adafactor", "WEIGHT_DECAY": 0.0}, 1e-3)
    assert spec.weight_decay == 0.0


@pytest.mark.parametrize("config", [
    {}, {"QUANT_KIND": "int8"}, {"QUANT_KIND": "NF4"},
    {"BNB_4BIT_QUANT_TYPE": "nf4"}, {"BNB_4BIT_QUANT_TYPE": "int8"},
    {"BNB_4BIT_QUANT_TYPE": "nf4", "QUANT_KIND": "none"}])
def test_quant_kind_from_config_matches_jax(config):
    for use_lora in (True, False):
        assert tconfig.quant_kind_from_config(config, use_lora) == \
            jconfig.quant_kind_from_config(config, use_lora)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", 756e12), ("NVIDIA H100 NVL", 835e12),
    ("cpu", 1e12)])
def test_peak_table_has_each_h100_variant(name, peak):
    assert tmetrics.peak_flops_per_device(name) == peak


def test_unknown_h100_variant_warns_once(monkeypatch, caplog):
    from gke_ray_train_tpu_torch import logging_utils
    monkeypatch.setattr(logging_utils, "_seen", set())
    with caplog.at_level(logging.WARNING):
        assert tmetrics.peak_flops_per_device("NVIDIA H100 96GB") == 989e12
        assert tmetrics.peak_flops_per_device("NVIDIA H100 96GB") == 989e12
    assert caplog.text.count("matches no PEAK_FLOPS entry") == 1


# -- the entry against JAX's --------------------------------------------------

V, SEQ = 260, 384   # ByteTokenizer's vocab; SQL rows are ~300 byte tokens


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "fine_tune_entry_port_test",
        os.path.join(REPO, "ray-jobs", "fine_tune_llama_ray.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_config(out, **over):
    cfg = {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
           "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": SEQ,
           "NUM_TRAIN_SAMPLES": 12, "NUM_EVAL_SAMPLES": 4,
           "PER_DEVICE_TRAIN_BATCH_SIZE": 1,
           "GRADIENT_ACCUMULATION_STEPS": 2, "NUM_TRAIN_EPOCHS": 1,
           "LEARNING_RATE": 1e-3, "LORA_DROPOUT": 0.0,
           "MESH_DATA": 1, "MESH_FSDP": 1, "SAVE_STRATEGY": "no",
           "EVALUATION_STRATEGY_SFT": "epoch", "LOGGING_STEPS": 1,
           "REPORT_TO": "tensorboard", "OUTPUT_DIR_BASE": str(out),
           "INFERENCE": False}
    cfg.update(over)
    return cfg


def _read_scalars(logdir):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util
    out = {}
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        for event in EventFileLoader(path).Load():
            for v in getattr(event.summary, "value", []):
                val = (float(tensor_util.make_ndarray(v.tensor))
                       if v.HasField("tensor") else v.simple_value)
                out.setdefault(v.tag, {})[event.step] = val
    return out


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A random tiny model at the smoke config's shape, written by JAX's
    ``save_hf_checkpoint`` in fp32."""
    d = tmp_path_factory.mktemp("pretrained")
    jc = jcfg.tiny(vocab_size=V, max_seq_len=SEQ, dtype="float32",
                   param_dtype="float32", n_layers=2)
    jhf.save_hf_checkpoint(jtr.init_params(jc, jax.random.key(3)), jc,
                           str(d), dtype="float32")
    return str(d)


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    mr.clear_rendezvous(monkeypatch)
    for k in ("ASYNC_CKPT", "PEER_REPLICATION", "FAULT_SPEC", "KERNELCHECK",
              "SERVE_AFTER_TRAIN", "TRANSFER_GUARD"):
        monkeypatch.delenv(k, raising=False)


def _both(tmp_path, monkeypatch, **over):
    """(JAX metrics, port metrics, JAX out dir, port out dir)."""
    import gke_ray_train_tpu.rayint.elastic as elastic
    monkeypatch.setattr(elastic, "maybe_replan",
                        lambda plan, config=None, log=None:
                        (plan, jax.devices()[:1]))
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jm = _jax_entry().train_loop_per_worker(_smoke_config(jout, **over))
    tm = fine_tune.train_loop_per_worker(_smoke_config(tout, **over),
                                         device="cpu")
    return jm, tm, jout, tout


def _bf16_ulp(x):
    # the spacing of bf16 at |x|: fp32's, 16 mantissa bits coarser
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


# both post-training switches, answers cut to 32 new tokens
INFER = {"NUM_EVAL_SAMPLES_INFERENCE": 2,
         "MAX_NEW_GENERATION_TOKENS_INFERENCE": 32,
         "INFERENCE": True, "SERVE_AFTER_TRAIN": True}
SMOKE_COUNTS = ("completed", "pending", "adapter_requests", "adapter_hits",
                "adapter_misses", "adapter_evictions", "adapter_resident")


def _same_comparison_and_smoke(jout, tout, lora):
    """The two entries' ``inference_comparison.json`` and
    ``serve_smoke.json``: the same rows (the window-function filter) and
    base answers; in full fine-tuning (trained alike, 1e-4) the same tuned
    answers and smoke stream; a LoRA run's smoke serves every prompt
    through the pool under the tenant tag, as JAX's (its tuned adapters
    start apart by design)."""
    docs = {}
    for side, d in (("jax", jout), ("port", tout)):
        with open(d / "inference_comparison.json") as f, \
                open(d / "serve_smoke.json") as g:
            docs[side] = (json.load(f), json.load(g))
    (jrows, jsmoke), (trows, tsmoke) = docs["jax"], docs["port"]
    assert len(trows) == len(jrows) == 2
    keys = ["index", "question", "reference_answer", "base_model_answer"]
    if not lora:
        keys.append("finetuned_model_answer")
    for a, b in zip(trows, jrows):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    counts = SMOKE_COUNTS + (() if lora else ("generated_tokens",
                                             "iterations"))
    assert {k: tsmoke.get(k) for k in counts} == \
        {k: jsmoke.get(k) for k in counts}
    assert tsmoke["completed"] == 2
    assert tsmoke["adapter_requests"] == (2 if lora else 0)


def test_entry_full_ft_matches_jax(tmp_path, monkeypatch, offline, hf_dir):
    jm, tm, jout, tout = _both(tmp_path, monkeypatch,
                               PRETRAINED_CHECKPOINT_DIR=hf_dir, **INFER)
    assert tm["step"] == jm["step"] == 6
    js = _read_scalars(str(jout / "tensorboard"))["loss"]
    ts = _read_scalars(str(tout / "tensorboard"))["loss"]
    assert sorted(ts) == sorted(js) == list(range(1, 7))
    np.testing.assert_allclose([ts[s] for s in range(1, 7)],
                               [js[s] for s in range(1, 7)], rtol=1e-4)
    np.testing.assert_allclose(tm["eval_loss"], jm["eval_loss"], rtol=1e-4)
    a = thf.ShardedReader(str(jout / "full"))
    b = thf.ShardedReader(str(tout / "full"))
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        x = a.get_tensor(k).float().numpy()
        y = b.get_tensor(k).float().numpy()
        assert b.get_tensor(k).dtype == torch.bfloat16
        assert (np.abs(x - y) <= _bf16_ulp(np.maximum(np.abs(x),
                                                      np.abs(y)))).all(), k
    for name in ("config.json", "graft_tokenizer.json"):
        with open(jout / "full" / name) as f, open(tout / "full" / name) as g:
            assert json.load(f) == json.load(g), name
    _same_comparison_and_smoke(jout, tout, lora=False)


def test_entry_lora_first_step_matches_jax(tmp_path, monkeypatch, offline,
                                           hf_dir):
    jm, tm, jout, tout = _both(
        tmp_path, monkeypatch, PRETRAINED_CHECKPOINT_DIR=hf_dir,
        USE_QLORA=True, LORA_R=4, LORA_ALPHA=8,
        EVALUATION_STRATEGY_SFT="no", NUM_TRAIN_SAMPLES=4, **INFER)
    js = _read_scalars(str(jout / "tensorboard"))["loss"]
    ts = _read_scalars(str(tout / "tensorboard"))["loss"]
    assert sorted(ts) == sorted(js) == [1, 2]
    np.testing.assert_allclose(ts[1], js[1], rtol=1e-4)
    assert os.path.exists(tout / "merged" / thf.SINGLE_FILE)
    _same_comparison_and_smoke(jout, tout, lora=True)


def _flat_checkpoint(d, step):
    """Every tensor of a saved step, through dcp's reader."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.format_utils import (
        _EmptyStateDictLoadPlanner)
    from torch.distributed.checkpoint.state_dict_loader import (
        _load_state_dict)
    sd = {}
    _load_state_dict(sd, storage_reader=FileSystemReader(
        os.path.join(d, str(step))), planner=_EmptyStateDictLoadPlanner(),
        no_dist=True)
    return sd


def test_entry_preempted_and_resumed_matches_uninterrupted(
        tmp_path, offline):
    """The CPU rehearsal of chip_smoke's entry phase: A uninterrupted; B
    preempted after step 3 by a SIGTERM from the context's heartbeat
    sink (the loop force-saves and raises ``Preempted``), with the async
    commit; C resumes B's directory, restores step 3 and trains 4-6. C's
    last checkpoint and export equal A's, bitwise."""
    over = dict(USE_QLORA=True, LORA_R=4, LORA_ALPHA=8, SAVE_STEPS_SFT=2,
                SAVE_STRATEGY="steps", EVALUATION_STRATEGY_SFT="steps",
                EVAL_STEPS_SFT=2, REPORT_TO="none")
    a = fine_tune.train_loop_per_worker(
        _smoke_config(tmp_path / "a", **over), device="cpu")
    ctx = get_context()

    def sink(rank, step, done):
        if step == 3 and not done:
            os.kill(os.getpid(), __import__("signal").SIGTERM)
    preempt.reset()
    assert preempt.install()
    ctx.set_heartbeat_sink(sink)
    try:
        with pytest.raises(preempt.Preempted) as ei:
            fine_tune.train_loop_per_worker(
                _smoke_config(tmp_path / "b", ASYNC_CKPT=1, **over),
                device="cpu")
    finally:
        ctx.set_heartbeat_sink(None)
        preempt.uninstall()
        preempt.reset()
    assert ei.value.step == 3
    c = fine_tune.train_loop_per_worker(
        _smoke_config(tmp_path / "b", **over), device="cpu")
    assert ctx.resumed_step == 3 and c["step"] == a["step"] == 6
    assert c["loss"] == a["loss"]
    sa = CheckpointManager(str(tmp_path / "a" / "sft")).latest_step()
    sc = CheckpointManager(str(tmp_path / "b" / "sft")).latest_step()
    assert sa == sc == 6
    fa = _flat_checkpoint(str(tmp_path / "a" / "sft"), 6)
    fc = _flat_checkpoint(str(tmp_path / "b" / "sft"), 6)
    assert sorted(fa) == sorted(fc)
    assert not any(k.startswith("params/") for k in fa)
    for k in fa:
        assert (torch.equal(fa[k], fc[k]) if torch.is_tensor(fa[k])
                else fa[k] == fc[k]), k
    ea, ec = (st_torch.load_file(str(tmp_path / r / "merged" /
                                     thf.SINGLE_FILE)) for r in "ab")
    for k in ea:
        assert torch.equal(ea[k], ec[k]), k


@pytest.mark.parametrize("key", ["INFERENCE", "SERVE_AFTER_TRAIN"])
def test_inference_and_serve_after_train_raise(tmp_path, monkeypatch,
                                               offline, key):
    """Each switch alone, where the entry raised before they were
    ported: the run ends and writes that switch's file and not the
    other's; SERVE_AFTER_TRAIN=0 in the environment keeps the smoke
    off."""
    monkeypatch.setenv("SERVE_AFTER_TRAIN", "0")
    config = _smoke_config(tmp_path, **INFER)
    del config["SERVE_AFTER_TRAIN"]
    config["INFERENCE"] = False
    config[key] = True
    fine_tune.train_loop_per_worker(config, device="cpu")
    files = {"INFERENCE": "inference_comparison.json",
             "SERVE_AFTER_TRAIN": "serve_smoke.json"}
    for k, name in files.items():
        assert os.path.exists(tmp_path / name) == (k == key), name
    with open(tmp_path / files[key]) as f:
        out = json.load(f)
    if key == "INFERENCE":
        assert len(out) == 2 and all(
            set(r) == {"index", "question", "reference_answer",
                       "base_model_answer", "finetuned_model_answer"}
            for r in out)
    else:
        assert out["completed"] == 2 and out["adapter_requests"] == 0


def test_main_exit_codes_and_last_line(tmp_path, monkeypatch, capsys,
                                       offline):
    path = tmp_path / "c.json"
    path.write_text(json.dumps(_smoke_config(tmp_path / "out")))
    monkeypatch.setenv("FINE_TUNE_CONFIG", str(path))
    # no card: the entry refuses rather than carry on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fine_tune.main() == 1
    monkeypatch.setenv("FINE_TUNE_CONFIG", str(tmp_path / "missing.json"))
    assert fine_tune.main() == 1
    monkeypatch.setenv("FINE_TUNE_CONFIG", str(path))
    monkeypatch.setattr(fine_tune, "train_loop_per_worker",
                        lambda config: {"loss": 1.5, "step": 6, "x": "s"})
    capsys.readouterr()
    assert fine_tune.main() == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"metric": "flagship_final", "attempts": 1,
                                "preemptions": 0, "loss": 1.5, "step": 6}
