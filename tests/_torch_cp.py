"""Context-parallel scenarios of the port's tests: gloo worlds on the CPU,
one process a rank, started and awaited as ``tests/_torch_multirank.py``
starts its own (torchrun's environment, one shared deadline, ``RANK_OK
<rank>``), with that module's state helpers.

- ``cp2`` (2 ranks): fsdp 1 × context 2 — the training cases, the
  attention alone (ring and a2a, forward and gradients, each rank its
  token shard), the a2a fallback to the ring, the impls that raise, the
  LoRA dropout masks, the sharded eval sums, the fused
  cross-entropy's ``mesh=`` sums, and the entry's worker on
  ``<out>/entry.json`` (MESH_CONTEXT 2).
- ``cp4`` (4 ranks): fsdp 2 × context 2 — the training cases, a save of
  the trained full fine-tuning state and the sharded export of the QLoRA
  start, the dropout masks; then fsdp 1 × context 4 on the same world:
  the attention alone.

Each rank reads ``<out>/inputs.pt`` and writes ``<out>/<scenario>_<rank>
.pt``; the parent test compares.
"""

import json
import os
import subprocess
import sys

from tests import _torch_multirank as mr
from tests import _torch_tp as tp

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_cp as h
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


def _layout(mesh) -> dict:
    from gke_ray_train_tpu_torch.parallel import (
        batch_rank, context_rank, context_size)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    return {"batch_rank": batch_rank(mesh),
            "context_rank": context_rank(mesh),
            "context_size": context_size(mesh),
            "input_shard_layout": input_shard_layout(mesh)}


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch, then its tokens of them."""
    from gke_ray_train_tpu_torch.parallel.placement import context_slice
    shards, shard = _layout(mesh)["input_shard_layout"]
    return context_slice(mr.local_rows(batch, shard, shards), mesh)


def train(case: dict, mesh) -> dict:
    """3 steps of ``case`` on ``mesh``, each rank fed its rows and
    tokens: the streams, the trained tensors whole, the placements."""
    from gke_ray_train_tpu_torch.parallel.sharding import is_sharded
    state, fn, _, _ = tp.build_state(case, mesh)
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for batch in case["batches"]:
        state, m = fn(state, local_batch(batch, mesh))
        for k in streams:
            streams[k].append(float(m[k]))
    placements = {n: tuple(str(x) for x in p.placements)
                  for n, p in state.params.named_parameters()
                  if is_sharded(p)}
    return {"streams": streams, "trained": mr.trained_tensors(state),
            "placements": placements, "state": state}


def attention_alone(att: dict, mesh) -> dict:
    """Every case of ``att`` (global q, k, v, the output gradient and the
    mask inputs) through ``attention_dispatch`` on this rank's token
    shard: {(impl, case): (out, dq, dk, dv)} of the shard."""
    import torch
    from gke_ray_train_tpu_torch.ops.dispatch import attention_dispatch
    from gke_ray_train_tpu_torch.parallel import context_rank, context_size
    C, c = context_size(mesh), context_rank(mesh)
    res = {}
    for name, a in att.items():
        S = a["q"].shape[1]
        sl = slice(c * S // C, (c + 1) * S // C)

        def part(key):
            t = a.get(key)
            return None if t is None else t[:, sl].contiguous()
        for impl in a["impls"]:
            q, k, v = (part(x).requires_grad_(True) for x in "qkv")
            out = attention_dispatch(
                impl, q, k, v, q_positions=part("positions"),
                kv_positions=part("positions"),
                q_segment_ids=part("segment_ids"),
                kv_segment_ids=part("segment_ids"), causal=True,
                sliding_window=a.get("window"),
                logit_softcap=a.get("softcap"), mesh=mesh)
            torch.sum(out * part("do")).backward()
            res[(impl, name)] = tuple(t.detach() for t in
                                      (out, q.grad, k.grad, v.grad))
    return res


def dropout_masks(case: dict, mesh) -> dict:
    """One step of ``case`` at LORA_DROPOUT 0.1 on this rank's rows and
    tokens: the first mask drawn for each projection, and the loss."""
    from gke_ray_train_tpu_torch.models import transformer as tr
    state, fn, _, _ = tp.build_state(case, mesh, dropout=0.1)
    masks = {}
    tr.dropout_hook = lambda name, mask: masks.setdefault(name, mask.clone())
    try:
        state, m = fn(state, local_batch(case["batches"][0], mesh))
    finally:
        tr.dropout_hook = None
    return {"masks": masks, "loss": float(m["loss"])}


def _raises(case: dict, mesh) -> dict:
    """The message each impl other than ring / a2a raises with at a
    context above 1 (a forward of the case's model on its first batch),
    or None where it ran."""
    import dataclasses
    import torch
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    state = tp.build_state(case, mesh)[0]
    b = local_batch(case["batches"][0], mesh)
    got = {}
    for impl in ("flash", "xla", "auto"):
        cfg = dataclasses.replace(ModelConfig.from_dict(case["cfg"]),
                                  attn_impl=impl)
        try:
            with torch.no_grad():
                state.params(torch.as_tensor(b["inputs"]), cfg, mesh=mesh)
            got[impl] = None
        except ValueError as e:
            got[impl] = str(e)
    return got


def _train_cases(inputs, names, mesh, res, *, accum_div=1):
    for name in names:
        case = dict(inputs[name], accum=inputs[name]["accum"] // accum_div)
        r = train(case, mesh)
        res[name] = r
    return res


def scenario_cp2(out: str) -> dict:
    import torch
    from gke_ray_train_tpu_torch.ops.fused_ce import fused_cross_entropy
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_eval_step, sharded_eval_sums)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    mesh = tp._mesh(fsdp=1, context=2)
    res = {"layout": _layout(mesh)}
    _train_cases(inputs, inputs["cases"], mesh, res)
    # the sharded eval sums of the trained QLoRA state, each context rank
    # its tokens of every eval row
    st = res[inputs["eval_case"]]["state"]
    lcfg = LoraConfig(r=8, alpha=16)
    ev = make_eval_step(st.params.cfg, lora_cfg=lcfg, device="cpu",
                        mesh=mesh)
    from gke_ray_train_tpu_torch.parallel.placement import context_slice
    res["eval_sums"] = sharded_eval_sums(
        st, ev, inputs["eval_rows"], host_batch=3,
        place_batch=lambda b: {k: torch.from_numpy(v.copy()) for k, v in
                               context_slice(b, mesh).items()},
        mesh=mesh)
    for r in list(res.values()):
        if isinstance(r, dict):
            r.pop("state", None)
    res["attn"] = attention_alone(inputs["attn2"], mesh)
    res["raises"] = _raises(inputs["llama_unpacked"], mesh)
    res["drop"] = dropout_masks(inputs["llama_unpacked"], mesh)
    # the fused cross-entropy's mesh= sums: this rank's tokens, summed
    # over context
    ce = inputs["ce"]
    S = ce["x"].shape[1]
    c = mesh["context"].get_local_rank()
    sl = slice(c * S // 2, (c + 1) * S // 2)
    x = ce["x"][:, sl].clone().requires_grad_(True)
    nll, w = fused_cross_entropy(x, ce["head"], ce["targets"][:, sl],
                                 ce["weights"][:, sl], mesh=mesh)
    nll.backward()
    res["ce"] = {"nll": nll.detach(), "w": w, "dx": x.grad}
    # the entry's worker at fsdp 1 x context 2 (MESH_CONTEXT 2, ring)
    with open(os.path.join(out, "entry.json")) as f:
        config = json.load(f)
    metrics, evals = entry_run(config)
    res["entry"] = dict(metrics, evals=evals)
    return res


def entry_run(config: dict):
    """The entry's worker on ``config`` on the CPU: (its numeric last
    metrics, every eval loss it computed)."""
    from gke_ray_train_tpu_torch import fine_tune
    evals = []
    orig = fine_tune.sharded_eval_loss

    def recorded(*a, **kw):
        evals.append(orig(*a, **kw))
        return evals[-1]
    fine_tune.sharded_eval_loss = recorded
    try:
        metrics = fine_tune.train_loop_per_worker(config, device="cpu")
    finally:
        fine_tune.sharded_eval_loss = orig
    return {k: v for k, v in metrics.items()
            if isinstance(v, (int, float))}, evals


def scenario_cp4(out: str) -> dict:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.ckpt.convert import (
        save_export, write_sidecar)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank = dist.get_rank()
    mesh = tp._mesh(fsdp=2, context=2)
    res = {"layout": _layout(mesh)}
    _train_cases(inputs, inputs["cases"], mesh, res, accum_div=2)
    # a trained full fine-tuning state (HSDP over context) saved here
    name = inputs["save_case"]
    st = res[name]["state"]
    mgr = CheckpointManager(os.path.join(out, "ckpt_cp4"),
                            score_attribute=None)
    mgr.save(st.step, st, force=True)
    mgr.close()
    res["saved"] = mr.full_state(st)
    for r in list(res.values()):
        if isinstance(r, dict):
            r.pop("state", None)
    res["drop"] = dropout_masks(
        dict(inputs["llama_unpacked"],
             accum=inputs["llama_unpacked"]["accum"] // 2), mesh)
    # the sharded export of the QLoRA start
    st, _, cfg, lcfg = tp.build_state(inputs["llama_unpacked"], mesh)
    save_export(st.params, cfg, os.path.join(out, "export_cp4"), 0,
                lora=st.lora, lora_scale=lcfg.scale)
    if rank == 0:
        write_sidecar(cfg, os.path.join(out, "export_cp4"))
    del st
    res["attn"] = attention_alone(inputs["attn4"],
                                  tp._mesh(fsdp=1, context=4))
    return res


SCENARIOS = {"cp2": scenario_cp2, "cp4": scenario_cp4}
