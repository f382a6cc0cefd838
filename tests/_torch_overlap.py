"""``OVERLAP`` scenarios of the port's tests: gloo worlds on the CPU, one
process a rank, started and awaited as ``tests/_torch_multirank.py``
starts its own (torchrun's environment, one shared deadline, ``RANK_OK
<rank>``).

- ``fsdp2`` (2 ranks): data 1 × fsdp 2;
- ``hsdp`` (4 ranks): data 2 × fsdp 2.

Each world runs every case of ``<out>/inputs.pt`` under ``off``, ``xla``
and ``manual`` from the same start, each rank fed its block of every
microbatch of the global batches: the loss and grad-norm streams, the
trained tensors whole (rank 0), the bytes
``dist.all_gather_into_tensor`` gathered and the manual path's own tally
(``train/overlap.py::COUNTS``) in the last step, and the parameters'
placements. ``fsdp2`` then runs the fine-tune entry's worker on
``<out>/entry.json`` under ``OVERLAP`` ``xla`` and ``manual`` (its
metrics), and at ``MESH_MODEL`` 2 under ``manual`` (what it raises), and
the drill case under ``off`` and ``xla`` at model 2 and at pipe 2 (the
streams). Each rank writes ``<out>/<world>_<rank>.pt``; the parent test
compares. """

import os
import subprocess
import sys

from tests import _torch_multirank as mr

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_overlap as h
h.run_scenario({name!r}, {out!r})
"""

WORLDS = {"fsdp2": dict(data=1, fsdp=2), "hsdp": dict(data=2, fsdp=2)}
MODES = ("off", "xla", "manual")


def start(name: str, out: str):
    """Start the ranks of world ``name``; returns the Popens (awaited
    with ``_torch_multirank.wait``)."""
    n = WORLDS[name]["data"] * WORLDS[name]["fsdp"]
    port = mr.free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "RANK": str(rank), "WORLD_SIZE": str(n),
                    "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
                    "HF_HUB_OFFLINE": "1",
                    "PYTHONPATH": mr.REPO + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, "-W", "ignore", "-c", _CODE.format(
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
        res = scenario(name, out)
        torch.save(res, os.path.join(out, f"{name}_{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()
    print("RANK_OK", os.environ["RANK"], flush=True)


def rank_rows(batch: dict, accum: int, rank: int, n: int) -> dict:
    """This batch rank's rows of a global batch: its block of each of the
    ``accum`` microbatches (the JAX step's ``reshape(accum, B / accum)``),
    in microbatch order, so its step cuts them into the same
    microbatches."""
    import numpy as np
    out = {}
    for k, v in batch.items():
        micro = v.reshape(accum, -1, *v.shape[1:])
        b = micro.shape[1] // n
        out[k] = np.concatenate([m[rank * b:(rank + 1) * b] for m in micro])
    return out


def _gathered_bytes():
    """Patch the all-gathers into one tensor (``dist.all_gather_single``,
    which FSDP2 calls on torch 2.13 and ``all_gather_into_tensor`` calls
    there, and ``all_gather_into_tensor``, which both call on 2.11) to
    add up the bytes they gather, each call once; returns the tally."""
    import torch.distributed as dist
    tally = {"bytes": 0, "depth": 0}

    def counting(orig):
        def counted(*a, **kw):
            out = kw.get("output_tensor", a[0] if a else None)
            if tally["depth"] == 0:
                tally["bytes"] += out.numel() * out.element_size()
            tally["depth"] += 1
            try:
                return orig(*a, **kw)
            finally:
                tally["depth"] -= 1
        return counted
    for name in ("all_gather_single", "all_gather_into_tensor"):
        if hasattr(dist, name):
            setattr(dist, name, counting(getattr(dist, name)))
    return tally


def scenario(name: str, out: str) -> dict:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.models import init_params
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    from gke_ray_train_tpu_torch.parallel.mesh import batch_rank
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        make_optimizer, make_train_state, make_train_step,
        warmup_cosine_schedule)
    from gke_ray_train_tpu_torch.train import overlap as tov
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    mesh = build_mesh(MeshConfig(**WORLDS[name]))
    rank, br = dist.get_rank(), batch_rank(mesh)
    nb = WORLDS[name]["data"] * WORLDS[name]["fsdp"]
    tally = _gathered_bytes()
    res = {}
    for case_name, case in inputs["cases"].items():
        cfg = ModelConfig.from_dict(case["cfg"])
        for mode in MODES:
            params = init_params(cfg, seed=0, device="cpu")
            params.load_state_dict(case["params"], strict=True)
            spec = make_optimizer(warmup_cosine_schedule(
                case["lr"], case["total"], warmup_frac=0.2))
            state = make_train_state(cfg, spec, params=params, device="cpu",
                                     mesh=mesh)
            plan = ExecutionPlan(overlap=mode, grad_accum=case["accum"],
                                 fused_ops=case["fused"])
            step = make_train_step(cfg, spec, plan=plan, device="cpu",
                                   mesh=mesh)
            streams = {"loss": [], "grad_norm": []}
            for batch in case["batches"]:
                tally["bytes"] = 0
                tov.reset_counts()
                state, m = step(state, rank_rows(batch, case["accum"], br,
                                                 nb))
                streams["loss"].append(float(m["loss"]))
                streams["grad_norm"].append(float(m["grad_norm"]))
            r = {"streams": streams, "gathered_bytes": tally["bytes"],
                 "manual_counts": dict(tov.COUNTS),
                 "placements": {n: tuple(str(x) for x in p.placements)
                                for n, p in state.params.named_parameters()}}
            # whole tensors: a collective every rank joins
            trained = mr.trained_tensors(state)
            if rank == 0:
                r["trained"] = trained
            res[(case_name, mode)] = r
    if name == "fsdp2":
        res["entry"] = entry_runs(out)
        for kw in ({"fsdp": 1, "model": 2}, {"fsdp": 1, "pipe": 2}):
            res[("xla_composes", tuple(kw.items()))] = {
                mode: _streams(inputs["cases"]["drill"], mode,
                               build_mesh(MeshConfig(**kw)))
                for mode in ("off", "xla")}
    return res


def _streams(case, mode, mesh):
    """The loss and grad-norm streams of ``case`` under ``mode`` on
    ``mesh``, each batch rank fed its rows."""
    from gke_ray_train_tpu_torch.models import init_params
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.parallel.mesh import (
        batch_group_size, batch_rank)
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        make_optimizer, make_train_state, make_train_step,
        warmup_cosine_schedule)
    cfg = ModelConfig.from_dict(case["cfg"])
    params = init_params(cfg, seed=0, device="cpu")
    params.load_state_dict(case["params"], strict=True)
    spec = make_optimizer(warmup_cosine_schedule(
        case["lr"], case["total"], warmup_frac=0.2))
    state = make_train_state(cfg, spec, params=params, device="cpu",
                             mesh=mesh)
    step = make_train_step(cfg, spec, device="cpu", mesh=mesh,
                           plan=ExecutionPlan(overlap=mode,
                                              grad_accum=case["accum"]))
    out = []
    for batch in case["batches"]:
        state, m = step(state, rank_rows(batch, case["accum"],
                                         batch_rank(mesh),
                                         batch_group_size(mesh)))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def entry_runs(out: str) -> dict:
    """The entry's worker on ``<out>/entry.json`` (full fine-tuning at
    fsdp 2) under ``OVERLAP`` ``xla`` and ``manual``: the numbers of its
    last metrics and every eval loss it computed; at ``MESH_MODEL`` 2
    under ``manual``: the type and message of what it raised."""
    import json
    from gke_ray_train_tpu_torch import fine_tune
    with open(os.path.join(out, "entry.json")) as f:
        config = json.load(f)
    res = {}
    orig = fine_tune.sharded_eval_loss
    for mode in ("xla", "manual"):
        evals = []

        def recorded(*a, **kw):
            evals.append(orig(*a, **kw))
            return evals[-1]
        fine_tune.sharded_eval_loss = recorded
        try:
            metrics = fine_tune.train_loop_per_worker(
                dict(config, OVERLAP=mode,
                     OUTPUT_DIR_BASE=os.path.join(out, f"entry_{mode}")),
                device="cpu")
        finally:
            fine_tune.sharded_eval_loss = orig
        res[mode] = dict({k: v for k, v in metrics.items()
                          if isinstance(v, (int, float))}, evals=evals)
    try:
        fine_tune.train_loop_per_worker(
            dict(config, OVERLAP="manual", MESH_FSDP=1, MESH_MODEL=2,
                 OUTPUT_DIR_BASE=os.path.join(out, "entry_model2")),
            device="cpu")
        res["model2"] = None
    except Exception as e:  # noqa: BLE001 - the parent reads what it was
        res["model2"] = (type(e).__name__, str(e))
    return res
