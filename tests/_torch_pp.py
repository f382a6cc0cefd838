"""Pipeline-parallel scenarios of the port's tests: gloo worlds on the CPU,
one process a rank, started and awaited as ``tests/_torch_multirank.py``
starts its own.

- ``pp2`` (2 ranks): pipe 2 — a tiny Llama's forward logits, 3 QLoRA and
  3 full fine-tuning steps at grad-accum 2 x pipe microbatches 2, the
  packed-segments batch, a tiny Gemma-2 (sliding / global, softcaps,
  post-norms, tied embedding) and a tiny Mixtral (router aux); the same
  Llama at virtual 2; the stage's layers of a sharded quantized init; a
  save of the trained full-FT state, the world-1 save restored, the
  sharded export of the QLoRA start; the divergence guard, healthy and
  diverged; the error gates; the refusals of a pipelined engine; the
  fine-tune entry at ``MESH_PIPE`` 2, run twice (the second resumes from
  the first's saves for a second epoch).
- ``pp4`` (4 ranks): pipe 2 x fsdp 2, pipe 2 x data 2 (forward, QLoRA
  and full fine-tuning), then pipe 2 x context 2 with ring and a2a
  attention at virtual 1 and 2 (forward and QLoRA).
- ``pptp4`` (4 ranks, ``tests/test_torch_port_pipe_tp.py``): pipe 2 x
  model 2 — the tiny Llama's forward, 3 QLoRA and 3 full fine-tuning
  steps, the Gemma-2's forward and 3 full fine-tuning steps, the
  Mixtral's forward and the experts a rank holds; a save of the trained
  full-FT state, the world-1 save restored, the sharded export of the
  QLoRA start, the sharded quantized init, the dropout gate.

Each rank reads ``<out>/inputs.pt`` and writes ``<out>/<scenario>_<rank>
.pt``; the parent test compares. The scenarios import torch and the port
only.
"""

import os
import subprocess
import sys

from tests import _torch_multirank as mr

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_pp as h
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


def _cfg(case: dict, virtual: int = 1, **kw):
    import dataclasses
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    return dataclasses.replace(ModelConfig.from_dict(case["cfg"]),
                               pipe_virtual=virtual, **kw)


def build_state(case: dict, mesh=None, virtual: int = 1, **cfg_kw):
    """A train state from ``case`` (``inputs.pt``'s entry, as
    ``_torch_multirank.build_state`` reads it) at ``virtual`` groups a
    stage, sharded over ``mesh``; its step at the case's grad-accum and
    pipe microbatches (one process: ``accum x M`` microbatches, the same
    rows in the same order). Returns (state, step_fn, cfg, lora_cfg)."""
    import torch
    from gke_ray_train_tpu_torch.models import (
        init_params, init_quantized_params)
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_size
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_optimizer, make_train_state, make_train_step,
        warmup_cosine_schedule)
    cfg = _cfg(case, virtual, **cfg_kw)
    if case["quant"]:
        params = init_quantized_params(cfg, seed=0, group=case["group"],
                                       device="cpu")
    else:
        params = init_params(cfg, seed=0, device="cpu")
    params.load_state_dict(case["params"], strict=True)
    lcfg = (LoraConfig(r=case["lora_r"], alpha=case["lora_alpha"])
            if case["lora"] is not None else None)
    sched = warmup_cosine_schedule(case["lr"], case["total"],
                                   warmup_frac=0.2)
    spec = make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = make_train_state(cfg, spec, lora_cfg=lcfg, params=params,
                             device="cpu", mesh=mesh)
    if lcfg is not None:
        ids = getattr(state.lora, "layer_ids", range(len(state.lora)))
        with torch.no_grad():
            for i, ours in zip(ids, state.lora):
                for t in ours:
                    for ab in ("a", "b"):
                        ours[t][ab].copy_(case["lora"][i][t][ab])
    piped = pipe_size(mesh) > 1
    fn = make_train_step(
        cfg, spec, lora_cfg=lcfg, schedule=sched, device="cpu", mesh=mesh,
        grad_accum=case["accum"] * (1 if piped else case["M"]),
        pipe_microbatches=case["M"])
    return state, fn, cfg, lcfg


def train(case: dict, mesh, virtual: int = 1, keep=None, **cfg_kw) -> dict:
    """3 steps of ``case``: the streams and the trained tensors this rank
    holds, whole (a stage's layers and the root); each rank its rows
    (and at a ``context`` above 1 its tokens) of each batch."""
    from gke_ray_train_tpu_torch.parallel.placement import (
        context_slice, input_shard_layout)
    state, fn, _, _ = build_state(case, mesh, virtual, **cfg_kw)
    n, i = input_shard_layout(mesh)
    streams = {"loss": [], "grad_norm": [], "tokens": []}
    for batch in case["batches"]:
        b = mr.local_rows(batch, i, n)
        if mesh is not None:
            b = context_slice(b, mesh)
        state, m = fn(state, b)
        for k in streams:
            streams[k].append(float(m[k]))
    out = {"streams": streams, "trained": mr.trained_tensors(state)}
    if keep is not None:
        keep(state)
    return out


def forward(case: dict, mesh, tokens, virtual: int = 1, segment_ids=None,
            **cfg_kw) -> dict:
    """The forward logits of ``case``'s start (its adapters on a QLoRA
    base) over this rank's tokens, and the router aux, without autograd;
    the layers the rank holds."""
    import torch
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    from gke_ray_train_tpu_torch.parallel.placement import context_slice
    from gke_ray_train_tpu_torch.parallel.sharding import release_root
    state, _, cfg, lcfg = build_state(case, mesh, virtual, **cfg_kw)
    b = {"inputs": tokens}
    if segment_ids is not None:
        b["segment_ids"] = segment_ids
    if mesh is not None:
        b = context_slice(b, mesh)
    with torch.no_grad():
        logits, aux = state.params(
            torch.as_tensor(b["inputs"]), cfg, lora=state.lora,
            lora_scale=lcfg.scale if lcfg else 1.0, with_aux=True,
            segment_ids=(torch.as_tensor(b["segment_ids"])
                         if "segment_ids" in b else None), mesh=mesh)
    release_root(state.params)
    return {"logits": logits, "aux": float(aux["router_aux"]),
            "layers": list(layer_ids(state.params))}


def _ranks(mesh) -> dict:
    from gke_ray_train_tpu_torch.parallel import (
        batch_rank, context_rank, pipe_rank)
    return {"batch": batch_rank(mesh), "context": context_rank(mesh),
            "pipe": pipe_rank(mesh)}


def gates(inputs, mesh) -> dict:
    """Each error gate of the pipeline: {name: the message raised}."""
    import dataclasses
    import torch
    from gke_ray_train_tpu_torch.train import make_train_step
    case = inputs["llama_qlora"]
    out = {}

    def caught(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the message is compared
            out[name] = f"{type(e).__name__}: {e}"
        else:
            out[name] = None
    state, _, cfg, lcfg = build_state(case, mesh)
    b = {k: v[:4] for k, v in case["batches"][0].items()}

    def step(M=2, lcfg=lcfg):
        fn = make_train_step(cfg, state.opt_state.spec, lora_cfg=lcfg,
                             device="cpu", mesh=mesh, pipe_microbatches=M)
        fn(state, b)
    caught("microbatches", lambda: step(M=1))
    caught("divisible", lambda: step(M=3))
    caught("dropout", lambda: step(lcfg=dataclasses.replace(
        lcfg, dropout=0.1)))
    caught("n_repeats", lambda: build_state(case, mesh, virtual=4))
    caught("virtual", lambda: build_state(case, mesh, virtual=0))
    with torch.enable_grad():
        caught("autograd forward", lambda: state.params(
            torch.as_tensor(b["inputs"]), cfg, mesh=mesh))
    return out


def guard(inputs, mesh) -> dict:
    """The divergence guard on a pipelined state: quiet while every stage
    holds its own layers of one model; raising when one stage's adapters
    have another rank."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.analysis.guards import (
        StepDivergenceError, check_step_agreement)
    case = inputs["llama_qlora"]
    state, fn, _, _ = build_state(case, mesh)
    out = {"healthy": check_step_agreement(fn, state)}
    if dist.get_rank() == 1:
        diverged = dict(case, lora_r=case["lora_r"] // 2,
                        lora=[{t: {"a": ab["a"][:, :case["lora_r"] // 2],
                                   "b": ab["b"][:case["lora_r"] // 2]}
                               for t, ab in layer.items()}
                              for layer in case["lora"]])
        state, fn, _, _ = build_state(diverged, mesh)
    try:
        check_step_agreement(fn, state)
        out["diverged"] = None
    except StepDivergenceError as e:
        out["diverged"] = str(e)
    return out


# the entry's model at pipe 2: a tiny Llama of 4 layers at ByteTokenizer's
# vocab, long enough for the job's byte-rendered SQL rows
ENTRY_LLAMA = dict(vocab_size=260, d_model=64, d_ff=128, n_heads=4,
                   n_kv_heads=2, n_layers=4, max_seq_len=384,
                   name="llama-tiny")


def run_entry(config: dict) -> dict:
    """The fine-tune entry's worker on ``config`` with the preset cut to
    ``ENTRY_LLAMA``: its last loss and step, and each eval loss (through
    the pipelined forward)."""
    from gke_ray_train_tpu_torch import fine_tune
    from gke_ray_train_tpu_torch.models import config as mc
    orig, orig_eval = fine_tune.preset_for_model_id, \
        fine_tune.sharded_eval_loss
    evals = []

    def sharded_eval_loss(*a, **kw):
        evals.append(float(orig_eval(*a, **kw)))
        return evals[-1]
    fine_tune.preset_for_model_id = lambda model_id, **kw: mc.tiny(
        **{**ENTRY_LLAMA, **kw})
    fine_tune.sharded_eval_loss = sharded_eval_loss
    try:
        metrics = fine_tune.train_loop_per_worker(config, device="cpu")
    finally:
        fine_tune.preset_for_model_id = orig
        fine_tune.sharded_eval_loss = orig_eval
    return {"loss": float(metrics["loss"]), "step": int(metrics["step"]),
            "evals": evals}


def scenario_pp2(out: str) -> dict:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.ckpt.convert import (
        save_export, write_sidecar)
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.parallel.sharding import as_dtype
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank = dist.get_rank()
    mesh = _mesh(fsdp=1, pipe=2)
    fwd = inputs["fwd"]
    res = {"ranks": _ranks(mesh), "v1": {}, "v2": {}}

    def save(st):
        # the trained full-FT state at virtual 1
        mgr = CheckpointManager(os.path.join(out, "ckpt_pp2"),
                                score_attribute=None)
        mgr.save(st.step, st, force=True)
        mgr.close()
        res["full_saved"] = mr.full_state(st)
    for v in (1, 2):
        res[f"v{v}"]["forward"] = forward(inputs["llama_full"], mesh,
                                          fwd["inputs"], v)
        for name in ("llama_qlora", "llama_full"):
            res[f"v{v}"][name] = train(
                inputs[name], mesh, v,
                keep=save if (v, name) == (1, "llama_full") else None)
    res["packed"] = {
        "forward": forward(inputs["llama_full"], mesh, fwd["inputs"],
                           segment_ids=fwd["segment_ids"]),
        "train": train(inputs["llama_packed"], mesh)}
    res["gemma"] = {"forward": forward(inputs["gemma_full"], mesh,
                                       fwd["inputs"]),
                    "train": train(inputs["gemma_full"], mesh)}
    res["moe"] = {"forward": forward(inputs["moe_full"], mesh,
                                     fwd["inputs"]),
                  "train": train(inputs["moe_qlora"], mesh)}
    # the world-1 save restored into the stages
    template = build_state(inputs["llama_full"], mesh)[0]
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    res["resharded"] = tuple(mgr.last_restore_resharded)
    res["full_restored"] = mr.full_state(template)
    mgr.close()
    # the sharded export of the QLoRA start
    st, _, qcfg, lcfg = build_state(inputs["llama_qlora"], mesh)
    save_export(st.params, qcfg, os.path.join(out, "export_pp2"), 0,
                lora=st.lora, lora_scale=lcfg.scale)
    if rank == 0:
        write_sidecar(qcfg, os.path.join(out, "export_pp2"))
    # what an engine on the pipelined model still refuses
    import _torch_serve_mesh
    res["refusals"] = _torch_serve_mesh._refusals(st.params, qcfg)
    # a sharded quantized init: the stage's blocks only, one process's
    qcfg = _cfg(inputs["llama_qlora"])
    q = init_quantized_params(qcfg, seed=5, group=inputs["group"],
                              device="cpu", mesh=mesh)
    res["qinit"] = {k: mr._whole(as_dtype(t, torch.int8)
                                 if k.endswith(".codes") else t)
                    for k, t in list(q.named_parameters())
                    + list(q.named_buffers())}
    res["guard"] = guard(inputs, mesh)
    res["gates"] = gates(inputs, mesh)
    # the entry at MESH_PIPE 2: trains and exports, then, asked for a
    # second epoch, resumes from its last save, trains it and exports
    # again (the first export moved aside)
    import glob
    import shutil
    res["entry"] = [run_entry(inputs["entry"])]
    dist.barrier()
    if rank == 0:
        for d in glob.glob(os.path.join(
                inputs["entry"]["OUTPUT_DIR_BASE"], "*_dcp")):
            shutil.move(d, d + ".first")
    dist.barrier()
    res["entry"].append(run_entry(dict(inputs["entry"], NUM_TRAIN_EPOCHS=2)))
    return res


def scenario_pp4(out: str) -> dict:
    import torch
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    fwd = inputs["fwd"]
    res = {}
    for name, kw in (("fsdp", dict(fsdp=2, pipe=2)),
                     ("data", dict(data=2, fsdp=1, pipe=2))):
        mesh = _mesh(**kw)
        res[name] = {"ranks": _ranks(mesh),
                     "forward": forward(inputs["llama_full"], mesh,
                                        fwd["inputs"])}
        for case in ("llama_qlora", "llama_full"):
            res[name][case] = train(inputs[case], mesh)
    mesh = _mesh(fsdp=1, context=2, pipe=2)
    for impl in ("ring", "a2a"):
        for v in (1, 2):
            key = f"{impl}_v{v}"
            res[key] = {"ranks": _ranks(mesh),
                        "forward": forward(inputs["llama_full"], mesh,
                                           fwd["inputs"], v,
                                           attn_impl=impl),
                        "llama_qlora": train(inputs["llama_qlora"], mesh, v,
                                             attn_impl=impl)}
    return res


def held_experts(params) -> dict:
    """{layer: the experts of its ``w_gate`` this rank holds (the local
    part's leading dim)} of an MoE model."""
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    from gke_ray_train_tpu_torch.parallel.sharding import local
    return {i: local(blk.w_gate).shape[0]
            for i, blk in zip(layer_ids(params), params.blocks)}


def scenario_pptp4(out: str) -> dict:
    import dataclasses
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.ckpt.convert import (
        save_export, write_sidecar)
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.parallel import model_rank
    from gke_ray_train_tpu_torch.parallel.sharding import as_dtype, local
    from gke_ray_train_tpu_torch.train import make_train_step
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank = dist.get_rank()
    mesh = _mesh(fsdp=1, model=2, pipe=2)
    fwd = inputs["fwd"]
    res = {"ranks": dict(_ranks(mesh), model=model_rank(mesh))}

    def save(st):
        mgr = CheckpointManager(os.path.join(out, "ckpt_pptp"),
                                score_attribute=None)
        mgr.save(st.step, st, force=True)
        mgr.close()
        res["full_saved"] = mr.full_state(st)
    res["forward"] = forward(inputs["llama_full"], mesh, fwd["inputs"])
    res["llama_qlora"] = train(inputs["llama_qlora"], mesh)
    res["llama_full"] = train(inputs["llama_full"], mesh, keep=save)
    res["gemma"] = {"forward": forward(inputs["gemma_full"], mesh,
                                       fwd["inputs"]),
                    "train": train(inputs["gemma_full"], mesh)}
    st = build_state(inputs["moe_full"], mesh)[0]
    res["moe"] = {"forward": forward(inputs["moe_full"], mesh,
                                     fwd["inputs"]),
                  "experts": held_experts(st.params)}
    # the world-1 save restored into the stages' shards
    template = build_state(inputs["llama_full"], mesh)[0]
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    res["resharded"] = tuple(mgr.last_restore_resharded)
    res["full_restored"] = mr.full_state(template)
    mgr.close()
    # the sharded export of the QLoRA start
    st, _, qcfg, lcfg = build_state(inputs["llama_qlora"], mesh)
    save_export(st.params, qcfg, os.path.join(out, "export_pptp"), 0,
                lora=st.lora, lora_scale=lcfg.scale)
    if rank == 0:
        write_sidecar(qcfg, os.path.join(out, "export_pptp"))
    # the sharded quantized init: whole tensors and this rank's parts
    q = init_quantized_params(_cfg(inputs["llama_qlora"]), seed=5,
                              group=inputs["group"], device="cpu",
                              mesh=mesh)
    named = list(q.named_parameters()) + list(q.named_buffers())
    res["qinit"] = {k: mr._whole(as_dtype(t, torch.int8)
                                 if k.endswith(".codes") else t)
                    for k, t in named}
    res["qinit_local"] = {k: local(as_dtype(t, torch.int8)
                                   if k.endswith(".codes") else t).clone()
                          for k, t in named}
    # LoRA dropout on the pipelined mesh
    state, _, cfg, lcfg = build_state(inputs["llama_qlora"], mesh)
    fn = make_train_step(cfg, state.opt_state.spec, device="cpu", mesh=mesh,
                         lora_cfg=dataclasses.replace(lcfg, dropout=0.1),
                         pipe_microbatches=2)
    try:
        fn(state, {k: v[:4] for k, v in
                   inputs["llama_qlora"]["batches"][0].items()})
        res["dropout"] = None
    except NotImplementedError as e:
        res["dropout"] = str(e)
    return res


SCENARIOS = {"pp2": scenario_pp2, "pp4": scenario_pp4,
             "pptp4": scenario_pptp4}
