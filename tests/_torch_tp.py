"""Tensor-parallel scenarios of the port's tests: gloo worlds on the CPU,
one process a rank, started and awaited as ``tests/_torch_multirank.py``
starts its own (torchrun's environment, one shared deadline, ``RANK_OK
<rank>``), with that module's state helpers.

- ``tp2`` (2 ranks): model 2 × fsdp 1 — four training cases, the
  sharded-vocab fused cross-entropy, the LoRA dropout masks at model 2,
  and at fsdp 2 × model 1 (two batch ranks).
- ``tp4`` (4 ranks): data 2 × fsdp 2 (HSDP) and fsdp 2 × model 2 — the
  training cases, the dropout masks, the sharded eval sums, a save of
  the trained full-FT state, the world-1 save restored, and the sharded
  export of the QLoRA start.

Each rank reads ``<out>/inputs.pt`` and writes ``<out>/<scenario>_<rank>
.pt``; the parent test compares.
"""

import os
import subprocess
import sys

from tests import _torch_multirank as mr

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_tp as h
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
                    "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
                    "HF_HUB_OFFLINE": "1",
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


def _mesh(**kw):
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(**kw))


def build_state(case: dict, mesh=None, dropout: float = 0.0):
    """``_torch_multirank.build_state`` with the case's plan
    (``FUSED_OPS`` from ``case["fused"]``) and a LoRA dropout rate."""
    import dataclasses
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import make_train_step
    state, fn, cfg, lcfg = mr.build_state(case, mesh)
    if lcfg is not None:
        lcfg = dataclasses.replace(lcfg, dropout=dropout)
    fn = make_train_step(
        cfg, state.opt_state.spec, lora_cfg=lcfg,
        schedule=state.opt_state.spec.schedule,
        plan=ExecutionPlan(grad_accum=case["accum"],
                           fused_ops=case["fused"]),
        device="cpu", mesh=mesh)
    return state, fn, cfg, lcfg


def train(case: dict, mesh, rows=None) -> dict:
    """3 steps of ``case`` on ``mesh``: the streams, the trained tensors
    whole, the parameters' placements; ``rows`` (count, index): this
    rank's row block of each batch."""
    from gke_ray_train_tpu_torch.parallel.sharding import is_sharded
    state, fn, _, _ = build_state(case, mesh)
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for batch in case["batches"]:
        b = batch if rows is None else mr.local_rows(batch, rows[1], rows[0])
        state, m = fn(state, b)
        for k in streams:
            streams[k].append(float(m[k]))
    placements = {n: tuple(str(x) for x in p.placements)
                  for n, p in state.params.named_parameters()
                  if is_sharded(p)}
    return {"streams": streams, "trained": mr.trained_tensors(state),
            "placements": placements, "state": state}


def dropout_masks(case: dict, mesh, rows) -> dict:
    """One step of ``case`` at LORA_DROPOUT 0.1: the first mask drawn for
    each projection (layer 0, microbatch 0), and the step's loss."""
    from gke_ray_train_tpu_torch.models import transformer as tr
    state, fn, _, _ = build_state(case, mesh, dropout=0.1)
    masks = {}
    tr.dropout_hook = lambda name, mask: masks.setdefault(name, mask.clone())
    try:
        b = case["batches"][0]
        state, m = fn(state, mr.local_rows(b, rows[1], rows[0]))
    finally:
        tr.dropout_hook = None
    return {"masks": masks, "loss": float(m["loss"])}


def _layout(mesh) -> dict:
    from gke_ray_train_tpu_torch.parallel import batch_rank, model_rank
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    return {"batch_rank": batch_rank(mesh), "model_rank": model_rank(mesh),
            "input_shard_layout": input_shard_layout(mesh)}


def scenario_tp2(out: str) -> dict:
    import torch
    from gke_ray_train_tpu_torch.ops.fused_ce import fused_cross_entropy
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    mesh = _mesh(fsdp=1, model=2)
    res = {"layout": _layout(mesh)}
    for name in inputs["tp2_cases"]:
        r = train(inputs[name], mesh)
        del r["state"]
        res[name] = r
    # the sharded-vocab fused cross-entropy: this rank's head shard
    ce = inputs["ce"]
    rank = mesh["model"].get_local_rank()
    x = ce["x"].clone().requires_grad_(True)
    head = ce["head"].chunk(2, dim=1)[rank].clone().requires_grad_(True)
    nll, w = fused_cross_entropy(x, head, ce["targets"], ce["weights"],
                                 mesh=mesh)
    nll.backward()
    res["ce"] = {"nll": nll.detach(), "w": w, "dx": x.grad,
                 "dhead": head.grad}
    res["drop_model2"] = dropout_masks(inputs["qlora_f0"], mesh, (1, 0))
    # the same world as fsdp 2 x model 1: two batch ranks
    fsdp2 = _mesh(fsdp=2)
    res["drop_fsdp2"] = dropout_masks(inputs["qlora_f0"], fsdp2,
                                      (2, _layout(fsdp2)["batch_rank"]))
    return res


def scenario_tp4(out: str) -> dict:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.ckpt.convert import (
        save_export, write_sidecar)
    from gke_ray_train_tpu_torch.train import (
        make_eval_step, sharded_eval_sums)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank = dist.get_rank()
    res = {}
    for shape, kw in (("hsdp", dict(data=2, fsdp=2)),
                      ("fsdp_model", dict(fsdp=2, model=2))):
        mesh = _mesh(**kw)
        lay = _layout(mesh)
        res[shape] = {"layout": lay}
        rows = lay["input_shard_layout"]
        for name in inputs["tp4_cases"][shape]:
            case = dict(inputs[name], accum=inputs[name]["accum"] // 2)
            r = train(case, mesh, rows)
            st = r.pop("state")
            res[shape][name] = r
            if shape == "fsdp_model" and name in ("full_f1", "qlora_f1"):
                # a trained state of 2-D DTensors (a QLoRA one with its
                # frozen NF4 codes and scales) saved at world 4
                mgr = CheckpointManager(os.path.join(out, f"ckpt_{name}_w4"),
                                        score_attribute=None)
                mgr.save(st.step, st, force=True)
                mgr.close()
                res[f"{name}_saved"] = mr.full_state(st)
            if shape == "fsdp_model" and name == "qlora_f1":
                from gke_ray_train_tpu_torch.train import LoraConfig
                lcfg = LoraConfig(r=case["lora_r"], alpha=case["lora_alpha"])
                ev = make_eval_step(st.params.cfg, lora_cfg=lcfg,
                                    device="cpu", mesh=mesh)
                res["eval_sums"] = sharded_eval_sums(
                    st, ev, inputs["eval_rows"], host_batch=2,
                    in_shards=rows[0], in_shard_id=rows[1], mesh=mesh)
            del st
        if shape != "fsdp_model":
            continue
        res["drop"] = dropout_masks(inputs["qlora_f0"], mesh, rows)
        # the world-1 save, restored into this mesh's placements
        template = build_state(inputs["full_f1"], mesh)[0]
        mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                                score_attribute=None)
        mgr.restore_resharded(template)
        res["resharded"] = tuple(mgr.last_restore_resharded)
        res["full_restored"] = mr.full_state(template)
        mgr.close()
        # the sharded export of the QLoRA start
        st, _, cfg, lcfg = build_state(inputs["qlora_f1"], mesh)
        save_export(st.params, cfg, os.path.join(out, "export_w4"), 0,
                    lora=st.lora, lora_scale=lcfg.scale)
        if rank == 0:
            write_sidecar(cfg, os.path.join(out, "export_w4"))
    return res


SCENARIOS = {"tp2": scenario_tp2, "tp4": scenario_tp4}
