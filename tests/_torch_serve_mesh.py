"""Serving across ranks: gloo worlds on the CPU, one process a rank,
started and awaited as ``tests/_torch_multirank.py`` starts its own
(torchrun's environment, one shared deadline, ``RANK_OK <rank>``).

- ``serve2`` (2 ranks): the decode cases at fsdp 2 and at model 2, the
  adapter-pool engine at model 2, the refusals of ``SPEC_DRAFT`` /
  ``SERVE_QUANT``, then both entries with ``INFERENCE`` /
  ``SERVE_AFTER_TRAIN`` (and the pre-train entry once more under a
  ``LOCAL_WORLD_SIZE`` below the world).
- ``serve4`` (4 ranks): the decode cases at fsdp 2 × model 2, data 2 ×
  fsdp 2 and fsdp 2 × context 2.
- ``servepp2`` (2 ranks, ``tests/test_torch_port_serve_pipe.py``): the
  decode cases at pipe 2 (virtual 1 and 2) with each stage's cache, the
  adapter-pool engine and its smoke at pipe 2, the refusals, then both
  entries at ``MESH_PIPE`` 2 with ``INFERENCE`` / ``SERVE_AFTER_TRAIN``.
- ``servepp4`` (4 ranks): the decode cases at pipe 2 × model 2.

Each rank reads ``<out>/inputs.pt`` and writes ``<out>/<scenario>_<rank>
.pt``; the parent test compares. :func:`run_decode` is what a rank runs
on each case, and what the parent runs on one process.
"""

import json
import os
import subprocess
import sys

from tests import _torch_multirank as mr

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_serve_mesh as h
h.run_scenario({name!r}, {out!r})
"""


def start(name: str, out: str, *, n: int):
    """Start the ``n`` ranks of scenario ``name``; returns the Popens
    (awaited with ``_torch_multirank.wait``)."""
    port = mr.free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "RANK": str(rank), "WORLD_SIZE": str(n),
                    "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n),
                    "OMP_NUM_THREADS": "1", "HF_HUB_OFFLINE": "1",
                    "PYTHONPATH": mr.REPO + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CODE.format(
                tests=mr.TESTS, repo=mr.REPO, name=name, out=out)],
            env=env, cwd=mr.REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def run_scenario(name: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import distributed_init
    torch.set_num_threads(1)
    distributed_init("cpu")
    try:
        res = SCENARIOS[name](out)
        torch.save(res, os.path.join(out, f"{name}_{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()
    print("RANK_OK", os.environ["RANK"], flush=True)


def model_of(case: dict):
    """(the port model of ``case``, its config): built on the CPU from
    the case's state dict."""
    import torch
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.models.transformer import Transformer
    cfg = ModelConfig.from_dict(case["cfg"])
    params = Transformer(cfg, device=torch.device("cpu"),
                         dtype=torch.float32)
    params.load_state_dict(case["params"])
    return params, cfg


def prefill_width(L: int, max_new: int) -> int:
    """``greedy_generate_cached``'s prefill width."""
    Lp = max(L - max_new, 1)
    if L % 128 == 0 and Lp > 1:
        Lp = min(L, ((Lp + 127) // 128) * 128)
    return Lp


def run_decode(params, cfg, case: dict, keep_cache: bool = False) -> dict:
    """The prefill's logits, the first pick, the next step's logits (of
    this rank's vocab shard under TP; empty on a pipeline stage without
    the head), the cache's KV heads, and the tokens
    ``greedy_generate_cached`` returns; with ``keep_cache`` the cache
    after the first step, by global layer."""
    import torch
    from gke_ray_train_tpu_torch.models.kvcache import (
        forward_step, greedy_generate_cached, greedy_pick, init_cache,
        model_shards)
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    prompt = torch.as_tensor(case["prompt"])
    plen = torch.as_tensor(case["plen"])
    B, L = prompt.shape
    Lp = prefill_width(L, case["max_new"])
    cache = init_cache(cfg, B, L, device="cpu", model=model_shards(params),
                       layers=len(params.blocks))
    with torch.no_grad():
        pre, cache = forward_step(params, prompt[:, :Lp].contiguous(), cfg,
                                  cache, torch.zeros(B, dtype=torch.int32))
        first = greedy_pick(pre[torch.arange(B), (plen - 1).long()],
                            params, cfg)
        dec, _ = forward_step(params, first[:, None], cfg, cache, plen)
    tokens = greedy_generate_cached(params, prompt, plen, cfg,
                                    max_new_tokens=case["max_new"],
                                    device="cpu")
    out = {"prefill": pre, "first": first, "decode": dec[:, 0],
           "tokens": tokens, "kv_heads": cache["k"].shape[3]}
    if keep_cache:
        out["cache"] = {i: (cache["k"][n].clone(), cache["v"][n].clone())
                        for n, i in enumerate(layer_ids(params))}
    return out


def _mesh(**kw):
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(**kw), device_type="cpu")


def _decode_cases(inputs: dict, shape: str, kw: dict,
                  virtual: int = 1) -> dict:
    import dataclasses
    from gke_ray_train_tpu_torch.parallel import model_rank, pipe_rank
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    mesh = _mesh(**kw)
    res = {"model_rank": model_rank(mesh), "pipe_rank": pipe_rank(mesh)}
    for name in inputs["meshes"][shape]:
        params, cfg = model_of(inputs["cases"][name])
        if virtual > 1:
            cfg = params.cfg = dataclasses.replace(cfg, pipe_virtual=virtual)
        shard_model(params, mesh)
        res[name] = run_decode(params, cfg, inputs["cases"][name],
                               keep_cache=kw.get("pipe", 1) > 1)
    return res


def run_engine(params, cfg, job: dict) -> dict:
    """The adapter-pool engine over ``job``'s tagged requests: every
    completion's tokens and the stats (None off rank 0 for the smoke).
    On a pipeline stage the pool of the whole model's tenants holds every
    layer, of which the stage's decode reads its own."""
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import (
        AdapterPool, BatchEngine, Request, post_train_smoke)
    plan = ExecutionPlan.from_kwargs(max_batch=2, decode_buckets="128")
    # one tenant slot and a loader: the two tenants miss, evict and wait
    # on each other's pins
    pool = AdapterPool.from_template(job["tenants"]["t1"], max_adapters=1,
                                     loader=job["tenants"].__getitem__)
    eng = BatchEngine(params, cfg, plan=plan, adapters=pool,
                      lora_scale=job["scale"], eos_ids=(job["eos"],),
                      device="cpu")
    comps = eng.run_until_drained([
        Request(rid=f"r{i}", token_ids=ids, max_new_tokens=n,
                adapter_id=tag)
        for i, (ids, n, tag) in enumerate(job["requests"])])
    stats = eng.stats()
    smoke = post_train_smoke(
        params, cfg, plan, [ids for ids, _, _ in job["requests"][:2]],
        eos_ids=(job["eos"],), lora=job["tenants"]["t1"],
        lora_scale=job["scale"], adapter_ids=["tuned", None],
        max_new_tokens=6, device="cpu")
    return {"tokens": [c.tokens for c in comps],
            "lengths": [c.length for c in comps],
            "stats": {k: v for k, v in stats.items()
                      if not k.startswith(("p50", "p99"))},
            "smoke": None if smoke is None else (
                [c.tokens for c in smoke[0]],
                {k: smoke[1][k] for k in ("generated_tokens", "completed",
                                          "adapter_requests",
                                          "adapter_hits")})}


def _refusals(params, cfg) -> dict:
    """What ``SPEC_DRAFT`` and ``SERVE_QUANT`` raise on a sharded
    model."""
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    out = {}
    for key, kw in (("SPEC_DRAFT", dict(spec_draft="self")),
                    ("SERVE_QUANT", dict(serve_quant="int8"))):
        plan = ExecutionPlan.from_kwargs(max_batch=2, decode_buckets="128",
                                         **kw)
        try:
            BatchEngine(params, cfg, plan=plan, device="cpu")
            out[key] = None
        except NotImplementedError as e:
            out[key] = str(e)
    return out


class _Writes:
    """Record the files ``json.dump`` writes in this process."""

    def __enter__(self):
        self.paths, self.orig = [], json.dump

        def dump(obj, fp, *a, **kw):
            self.paths.append(os.path.basename(getattr(fp, "name", "")))
            return self.orig(obj, fp, *a, **kw)
        json.dump = dump
        return self

    def __exit__(self, *exc):
        json.dump = self.orig


def run_fine_tune(config: dict) -> dict:
    """The fine-tune entry's worker on ``config``: its metrics, the
    files this process wrote, the comparison's records."""
    from gke_ray_train_tpu_torch import fine_tune
    with _Writes() as w:
        metrics = fine_tune.train_loop_per_worker(config, device="cpu")
    path = os.path.join(config["OUTPUT_DIR_BASE"],
                        "inference_comparison.json")
    records = None
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    return {"loss": metrics.get("loss"), "wrote": w.paths,
            "records": records}


def run_pretrain(config: dict, env: dict) -> dict:
    """The pre-train entry's worker on ``config`` under ``env``: what
    each ``post_train_smoke`` call returned (its stats) and the
    warnings logged."""
    import logging
    from gke_ray_train_tpu_torch import pretrain
    smokes, warned = [], []
    orig = pretrain.post_train_smoke

    def smoke(*a, **kw):
        out = orig(*a, **kw)
        smokes.append(None if out is None else out[1]["generated_tokens"])
        return out

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())
    handler = Catch(logging.WARNING)
    pretrain.logger.addHandler(handler)
    pretrain.post_train_smoke = smoke
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        pretrain.train_loop_per_worker(config, device="cpu")
    finally:
        pretrain.post_train_smoke = orig
        pretrain.logger.removeHandler(handler)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"smokes": smokes,
            "skipped": any("single-node" in m for m in warned)}


def scenario_serve2(out: str) -> dict:
    import torch
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = {"fsdp2": _decode_cases(inputs, "fsdp2", dict(fsdp=2)),
           "model2": _decode_cases(inputs, "model2", dict(fsdp=1, model=2))}
    params, cfg = model_of(inputs["cases"]["llama"])
    shard_model(params, _mesh(fsdp=1, model=2))
    res["engine"] = run_engine(params, cfg, inputs["engine"])
    res["refusals"] = _refusals(params, cfg)
    del params
    res["fine_tune"] = run_fine_tune(inputs["fine_tune"])
    env = {"DECODE_BUCKETS": "128"}
    res["pretrain"] = run_pretrain(inputs["pretrain"], env)
    res["pretrain_nodes"] = run_pretrain(
        dict(inputs["pretrain"], storage_path=inputs["pretrain"][
            "storage_path"] + "_nodes"), dict(env, LOCAL_WORLD_SIZE="1"))
    return res


def scenario_serve4(out: str) -> dict:
    import torch
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    return {shape: _decode_cases(inputs, shape, kw)
            for shape, kw in inputs["world4"].items()}


def scenario_servepp2(out: str) -> dict:
    import torch
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    kw = dict(fsdp=1, pipe=2)
    res = {"pipe2": _decode_cases(inputs, "pipe2", kw),
           "pipe2_v2": _decode_cases(inputs, "pipe2_v2", kw, virtual=2)}
    params, cfg = model_of(inputs["cases"]["llama"])
    shard_model(params, _mesh(**kw))
    res["layers"] = list(layer_ids(params))
    res["engine"] = run_engine(params, cfg, inputs["engine"])
    res["refusals"] = _refusals(params, cfg)
    del params
    res["fine_tune"] = run_fine_tune(inputs["fine_tune"])
    res["pretrain"] = run_pretrain(inputs["pretrain"],
                                   {"DECODE_BUCKETS": "128"})
    return res


def scenario_servepp4(out: str) -> dict:
    import torch
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    return {"pipe2_model2": _decode_cases(inputs, "pipe2_model2",
                                          dict(fsdp=1, model=2, pipe=2))}


SCENARIOS = {"serve2": scenario_serve2, "serve4": scenario_serve4,
             "servepp2": scenario_servepp2, "servepp4": scenario_servepp4}
