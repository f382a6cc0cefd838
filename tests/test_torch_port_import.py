"""Import hygiene of the port: ``gke_ray_train_tpu_torch`` needs neither
JAX nor the JAX package, keeps its own copy of the model configs (held
equal to the JAX package's here), and runs nowhere but on CUDA unless
asked for the CPU.
"""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import gke_ray_train_tpu_torch
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu_torch.models import config as tcfg

PKG_DIR = os.path.dirname(gke_ray_train_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="gke_ray_train_tpu_torch."))


def _is_forbidden(name: str) -> bool:
    # exact names or dotted prefixes: gke_ray_train_tpu_torch itself
    # begins with the string "gke_ray_train_tpu"
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "gke_ray_train_tpu"))


def test_forbidden_name_rule():
    assert _is_forbidden("jax.numpy") and _is_forbidden("gke_ray_train_tpu")
    assert _is_forbidden("gke_ray_train_tpu.models.config")
    assert not _is_forbidden("gke_ray_train_tpu_torch.models")
    assert not _is_forbidden("jaxtyping_like")


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter where importing jax (or the JAX package)
    fails imports every module of the port."""
    mods = _modules()
    for m in ("serve.engine", "ops.quant", "models.qinit", "train.lora",
              "train.optim", "train.metrics", "train.step", "interop",
              "ops.fused_norm_rope", "ops.fused_ce", "data.packing",
              "data.tokenizer", "data.sft", "data.lm_dataset",
              "data.prepare", "data.prefetch",
              "ops.registry", "analysis.kernelcheck", "analysis.__main__",
              "analysis.guards", "config", "rayint.context",
              "train.loop", "train.evaluate", "train.preempt", "train.tb",
              "train.profiling", "ckpt", "ckpt.manager", "ckpt.hf_io",
              "fine_tune", "serve.adapters", "ops.lora_batched",
              "inference", "parallel", "parallel.mesh",
              "parallel.sharding", "parallel.placement", "ckpt.convert",
              "testing", "testing.faults", "rayint", "rayint.trainer",
              "rayint.supervisor", "rayint.elastic", "rayint.serving",
              "pretrain", "plan", "ops.ring_attention",
              "ops.a2a_attention", "ops.dispatch"):
        assert f"gke_ray_train_tpu_torch.{m}" in mods, m
    code = textwrap.dedent(f"""
        import importlib, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "jaxlib", "gke_ray_train_tpu") or \\
                        name.startswith(("jax.", "jaxlib.",
                                         "gke_ray_train_tpu.")):
                    raise ImportError("blocked: " + name)
                return None
        for m in list(sys.modules):
            if m == "jax" or m.startswith("jax."):
                del sys.modules[m]
        sys.meta_path.insert(0, Block())
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules if m in ("jax", "gke_ray_train_tpu")
               or m.startswith(("jax.", "gke_ray_train_tpu."))]
        assert not bad, bad
        print("ok", len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(mods)}"


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                offenders += [f"{path}: {n}" for n in names
                              if _is_forbidden(n)]
    assert not offenders, offenders


def test_model_config_equals_the_jax_package():
    ours = [(f.name, f.default) for f in dataclasses.fields(tcfg.ModelConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jcfg.ModelConfig)]
    assert ours == theirs
    assert tcfg.PROJ_TARGETS == jcfg.PROJ_TARGETS
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name in jcfg.PRESETS:
        assert tcfg.PRESETS[name]().to_dict() == \
            jcfg.PRESETS[name]().to_dict(), name
    for mid in ("meta-llama/Llama-3.1-8B-Instruct", "meta-llama/Meta-Llama-3-8B",
                "meta-llama/Llama-2-13b-hf", "mistralai/Mistral-7B-v0.1",
                "mistralai/Mixtral-8x7B-v0.1", "google/gemma-2-9b",
                "Qwen/Qwen2.5-7B"):
        assert tcfg.preset_for_model_id(mid).to_dict() == \
            jcfg.preset_for_model_id(mid).to_dict(), mid
    tiny = tcfg.tiny(vocab_size=97)
    assert tiny.to_dict() == jcfg.tiny(vocab_size=97).to_dict()
    assert tcfg.ModelConfig.from_dict(tiny.to_dict()) == tiny
    assert tiny.resolved_attn_impl(torch.device("cpu")) == "xla"
    assert tiny.resolved_attn_impl(torch.device("cuda")) == "flash"


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    from gke_ray_train_tpu_torch.models import (
        greedy_generate, greedy_generate_cached, init_params)
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, init_lora, make_eval_step, make_optimizer,
        make_train_state, make_train_step)
    cfg = tcfg.tiny(vocab_size=97, max_seq_len=128)
    plan = ExecutionPlan(decode_buckets="128")
    model = init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = np.zeros((1, 128), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchEngine(model, cfg, plan=plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, seed=0)
    for fn in (greedy_generate, greedy_generate_cached):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(model, buf, [3], cfg, max_new_tokens=2)
    spec = make_optimizer(1e-3)
    lcfg = LoraConfig(r=4)
    for call in (lambda: init_quantized_params(cfg, seed=0),
                 lambda: init_lora(cfg, lcfg),
                 lambda: make_train_state(cfg, spec, params=model),
                 lambda: make_train_step(cfg, spec),
                 lambda: make_eval_step(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state = make_train_state(cfg, spec, lora_cfg=lcfg,
                             params=init_quantized_params(cfg, device="cpu"),
                             device="cpu")
    assert state.lora[0]["wq"]["a"].device.type == "cpu"
    make_train_step(cfg, spec, lora_cfg=lcfg, device="cpu")
    make_eval_step(cfg, lora_cfg=lcfg, device="cpu")
    # asked for the CPU, they run there; a model on another device than
    # the one named is refused rather than moved
    BatchEngine(model, cfg, plan=plan, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        BatchEngine(model, cfg, plan=plan, device="meta")


def test_trainer_and_pretrain_entry_default_to_cuda(monkeypatch, tmp_path):
    """The pre-train worker, and the trainer running it, need a card
    unless asked for the CPU; the testing and rayint modules import no
    torch of their own at module level beyond what the package needs."""
    import functools
    from gke_ray_train_tpu_torch import pretrain
    from gke_ray_train_tpu_torch.rayint import TorchTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    # one process of rank 0, whatever rank an earlier test in this
    # interpreter left in the environment
    for name in ("RANK", "PROCESS_ID", "WORLD_SIZE", "NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    config = {"d_model": 32, "n_layers": 1, "n_heads": 2, "d_ff": 64,
              "dataset_seq_len": 16, "model_max_seq_len": 32,
              "batch_size_per_device": 2, "max_samples": 4,
              "dtype": "float32", "prefetch_batches": 0,
              "data_dir": str(tmp_path / "data"),
              "storage_path": str(tmp_path / "runs")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain.train_loop_per_worker(config)
    res = TorchTrainer(pretrain.train_loop_per_worker,
                       train_loop_config=config, use_ray=False).fit()
    assert res.status == "failed" and "device='cpu'" in res.error
    res = TorchTrainer(functools.partial(pretrain.train_loop_per_worker,
                                         device="cpu"),
                       train_loop_config=config, use_ray=False).fit()
    assert res.error is None and res.metrics["step"] == 2
