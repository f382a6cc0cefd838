"""Multi-rank harness of the port's tests: real ``torch.distributed``
worlds of gloo ranks on the CPU, one process a rank.

:func:`spawn` starts the ranks of one scenario (a function of this
module, run by name) with torchrun's environment, under ONE shared
deadline: a hang is the failure mode of a multi-rank bug, so it fails
the test rather than stalling the suite (the pattern of
``tests/_multihost.py``). Each rank must exit 0 printing ``RANK_OK
<rank>``. The scenarios import torch and the port only (no JAX: the
parent test computes the references), read their inputs from
``<out>/inputs.pt`` and write what the parent compares under ``<out>``.
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_multirank as h
h.run_scenario({name!r}, {out!r})
"""


# a rank's rendezvous env (torchrun's, and JAX's COORDINATOR_ADDRESS /
# NUM_PROCESSES / PROCESS_ID): another test of the same worker process may
# leave it behind, and a one-process test clears it
RENDEZVOUS_ENV = ("NUM_PROCESSES", "COORDINATOR_ADDRESS", "PROCESS_ID",
                  "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT")


def one_torch_thread():
    """The body of a module-scoped autouse fixture: torch's CPU ops on one
    thread for the module's tests, the count restored after. Under
    pytest-xdist (six workers on eight cores) torch's default of one
    OpenMP thread per core has every worker's pool spin against the
    others: a tiny model's entry run takes ~110 s instead of ~11."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def clear_rendezvous(monkeypatch) -> None:
    for key in RENDEZVOUS_ENV:
        monkeypatch.delenv(key, raising=False)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(name: str, out: str, *, n: int = 2, extra_env=None):
    """Start the ``n`` ranks of scenario ``name``; returns the Popens."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "RANK": str(rank), "WORLD_SIZE": str(n),
                    "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
                    "HF_HUB_OFFLINE": "1",
                    "PYTHONPATH": REPO + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CODE.format(tests=TESTS, repo=REPO,
                                                name=name, out=out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def wait(procs, *, timeout: float = 120.0) -> list:
    """Wait for every rank under one deadline; kill stragglers; assert
    each exited 0 printing its token. Returns the outputs."""
    deadline = time.monotonic() + timeout
    outs, hung = [], []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(rank)
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert not hung, (f"rank(s) {hung} hung past {timeout}s:\n"
                      + "\n---\n".join(o[-3000:] for o in outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {rank} failed (rc={p.returncode}):\n{out[-5000:]}")
        assert f"RANK_OK {rank}" in out, out[-3000:]
    return outs


def spawn(name: str, out: str, *, n: int = 2, timeout: float = 120.0,
          extra_env=None) -> list:
    return wait(start(name, out, n=n, extra_env=extra_env),
                timeout=timeout)


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def run_scenario(name: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import distributed_init
    torch.set_num_threads(1)
    distributed_init("cpu")
    try:
        SCENARIOS[name](out)
    finally:
        dist.destroy_process_group()
    print("RANK_OK", os.environ["RANK"], flush=True)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _whole(t):
    t = t.detach()
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).clone()


def _mesh(data: int = 1):
    """data 1 x fsdp (world), or with ``data`` the world's ranks over
    ``data`` first (data 2 x fsdp 1 at world 2: HSDP)."""
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(data=data, fsdp=-1))


def build_state(case: dict, mesh=None):
    """A train state from ``case`` (``inputs.pt``'s entry): the model
    config, the params' state dict, the adapters, the optimizer and
    schedule settings; sharded over ``mesh`` when given. Returns (state,
    step_fn, cfg, lora_cfg)."""
    import torch
    from gke_ray_train_tpu_torch.models import (
        init_params, init_quantized_params)
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_adafactor, make_optimizer, make_train_state,
        make_train_step, warmup_cosine_schedule)
    cfg = ModelConfig.from_dict(case["cfg"])
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
    if case.get("optim") == "adafactor":
        spec = make_adafactor(sched, clip_norm=0.5, weight_decay_rate=0.01)
    else:
        spec = make_optimizer(sched, weight_decay=0.01, clip_norm=0.5)
    state = make_train_state(cfg, spec, lora_cfg=lcfg, params=params,
                             device="cpu", mesh=mesh)
    if lcfg is not None:
        with torch.no_grad():
            for ours, theirs in zip(state.lora, case["lora"]):
                for t in ours:
                    for ab in ("a", "b"):
                        ours[t][ab].copy_(theirs[t][ab])
    fn = make_train_step(cfg, spec, lora_cfg=lcfg, grad_accum=case["accum"],
                         schedule=sched, device="cpu", mesh=mesh)
    return state, fn, cfg, lcfg


def trained_tensors(state) -> dict:
    """{name: whole tensor} of what the optimizer trains."""
    from gke_ray_train_tpu_torch.train.step import trainable_tensors
    return {n: _whole(t) for n, t in
            trainable_tensors(state.params, state.lora)}


def full_state(state) -> dict:
    """{key: whole tensor or number} of a state's checkpoint."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    return {k: (_whole(v) if hasattr(v, "shape") else v)
            for k, v in flat_state(state).items()}


def local_rows(batch: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s contiguous block of a global batch (``rank`` its
    index among the batch axes, ``parallel/placement.py``)."""
    b = len(batch["inputs"]) // n
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def scenario_train(out: str) -> None:
    """QLoRA, full fine-tuning (AdamW and adafactor) and a tiny MoE over
    data 1 x fsdp 2, 3 steps each; QLoRA and full fine-tuning again over
    data 2 x fsdp 1 (HSDP); the sharded eval sums; a world-2 save
    of the trained full-FT state; a world-1 save restored here; a
    world-2 export of the initial QLoRA weights; the quantized init
    meshed and not."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.ckpt.convert import (
        save_export, write_sidecar)
    from gke_ray_train_tpu_torch.parallel.sharding import is_sharded
    from gke_ray_train_tpu_torch.train import (
        make_eval_step, sharded_eval_sums)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank, n = _rank(), dist.get_world_size()
    mesh = _mesh()
    res = {}
    for name in ("qlora", "full", "moe", "adafactor"):
        case = inputs[name]
        state, fn, cfg, lcfg = build_state(case, mesh)
        sharded = all(is_sharded(p) for p in state.params.parameters())
        if name == "qlora":
            save_export(state.params, cfg, os.path.join(out, "export_w2"),
                        0, lora=state.lora, lora_scale=lcfg.scale)
            if rank == 0:
                write_sidecar(cfg, os.path.join(out, "export_w2"))
        streams = {"loss": [], "grad_norm": [], "tokens": []}
        for batch in case["batches"]:
            state, m = fn(state, local_rows(batch, rank, n))
            for k in streams:
                streams[k].append(float(m[k]))
        res[name] = {"streams": streams, "sharded": sharded,
                     "trained": trained_tensors(state)}
        if name == "qlora":
            ev = make_eval_step(cfg, lora_cfg=lcfg, device="cpu", mesh=mesh)
            res[name]["eval_sums"] = sharded_eval_sums(
                state, ev, inputs["eval_rows"], host_batch=2, in_shards=n,
                in_shard_id=rank)
        if name == "full":
            mgr = CheckpointManager(os.path.join(out, "ckpt_w2"),
                                    score_attribute=None)
            mgr.save(state.step, state, force=True)
            mgr.close()
            res["full_saved"] = full_state(state)
            # the parent's world-1 save, restored into this world's
            # placements
            template, _, _, _ = build_state(inputs["full"], mesh)
            mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                                    score_attribute=None)
            mgr.restore_resharded(template)
            res["resharded"] = mgr.last_restore_resharded
            res["full_restored"] = full_state(template)
            mgr.close()
    # data 2 x fsdp 1: each unit replicated over data, its fsdp shard the
    # whole tensor; each rank its batch-axes tile of the rows
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    hsdp = _mesh(data=2)
    shards, shard_id = input_shard_layout(hsdp)
    for name in ("qlora", "full"):
        state, fn, cfg, lcfg = build_state(inputs[name], hsdp)
        placements = {tuple(str(x) for x in p.placements)
                      for p in state.params.parameters()}
        streams = {"loss": [], "grad_norm": [], "tokens": []}
        for batch in inputs[name]["batches"]:
            state, m = fn(state, local_rows(batch, shard_id, shards))
            for k in streams:
                streams[k].append(float(m[k]))
        res[f"{name}_data2"] = {
            "streams": streams, "placements": placements,
            "layout": (shards, shard_id), "trained": trained_tensors(state)}
    # the quantized init on the mesh: the same draws, each rank its shard
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    qcfg = ModelConfig.from_dict(inputs["qlora"]["cfg"])
    meshed = shard_model(init_quantized_params(
        qcfg, seed=5, group=inputs["qlora"]["group"], device="cpu",
        mesh=mesh), mesh)
    plain = init_quantized_params(qcfg, seed=5,
                                  group=inputs["qlora"]["group"],
                                  device="cpu")
    want = {**dict(plain.named_parameters()), **dict(plain.named_buffers())}
    from gke_ray_train_tpu_torch.parallel.sharding import as_dtype
    got = {k: (as_dtype(t, torch.int8) if k.endswith(".codes") else t)
           for k, t in meshed.named_parameters()}
    res["qinit"] = {"same_keys": set(got) == set(want),
                    "sharded": all(is_sharded(t) for t in got.values()),
                    "equal": all(torch.equal(_whole(t), want[k])
                                 for k, t in got.items() if k in want),
                    "local_codes_rows": meshed.blocks[0].wq.codes
                    .to_local().shape[0]}
    if rank == 0:
        torch.save(res, os.path.join(out, "train_w2.pt"))


def scenario_agree(out: str) -> None:
    """Rank agreement: a preemption flag raised on rank 1 only exits
    both ranks at the same boundary with a durable save; a plan that
    differs on rank 1 trips DIVERGENCE_GUARD on both; then two ranks of
    the entry's worker complete the smoke config of ``entry.json``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.analysis.guards import (
        RuntimeGuards, StepDivergenceError)
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.train import preempt
    from gke_ray_train_tpu_torch.train.loop import run_training
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank, n = _rank(), dist.get_world_size()
    mesh = _mesh()
    case = inputs["qlora"]
    batches = [local_rows(b, rank, n) for b in inputs["long_batches"]]
    res = {}

    # preemption on rank 1 only, raised after its 3rd step
    state, fn, _, _ = build_state(case, mesh)
    calls = [0]

    def step(st, b):
        st, m = fn(st, b)
        calls[0] += 1
        if rank == 1 and calls[0] == 3:
            preempt.request("test")
        return st, m
    mgr = CheckpointManager(os.path.join(out, "preempt"), max_to_keep=3,
                            score_attribute=None)
    try:
        run_training(state, step, lambda epoch: iter(batches), epochs=1,
                     ckpt_manager=mgr, log_every=100,
                     is_host0=rank == 0)
        res["preempted_at"] = None
    except preempt.Preempted as e:
        res["preempted_at"] = e.step
    finally:
        preempt.reset()
    res["steps_run"] = calls[0]
    res["saved"] = mgr.all_steps()
    mgr.close()

    # a plan that differs on rank 1
    state, fn, cfg, lcfg = build_state(case, mesh)
    if rank == 1:
        from gke_ray_train_tpu_torch.plan import ExecutionPlan
        from gke_ray_train_tpu_torch.train import make_train_step
        fn = make_train_step(cfg, state.opt_state.spec, lora_cfg=lcfg,
                             plan=ExecutionPlan(grad_accum=1,
                                                fused_ops=True),
                             device="cpu", mesh=mesh)
    try:
        run_training(state, fn, lambda epoch: iter(batches[:2]), epochs=1,
                     guards=RuntimeGuards(divergence=True),
                     is_host0=rank == 0)
        res["divergence"] = None
    except StepDivergenceError as e:
        res["divergence"] = str(e)

    # the entry's worker, two ranks on gloo
    from gke_ray_train_tpu_torch import fine_tune
    with open(os.path.join(out, "entry.json")) as f:
        config = json.load(f)
    metrics = fine_tune.train_loop_per_worker(config, device="cpu")
    res["entry"] = {k: v for k, v in metrics.items()
                    if isinstance(v, (int, float))}
    with open(os.path.join(out, f"agree_{rank}.json"), "w") as f:
        json.dump(res, f)


def scenario_pretrain(out: str) -> None:
    """The pre-train entry's worker through ``TorchTrainer.fit()`` (one
    in-process worker a rank), on the job of ``<out>/job.json``:
    {"label", "config", "env" (set first: FAULT_SPEC, ...),
    "max_failures", "max_preemptions", "elastic", "ckpt_every" (a save
    every that many steps, passed to ``run_training``)}; with
    "worker_env" the rank is instead one worker of the trainer's Ray
    path, an attempt that ``rayint/trainer.py::_run_worker`` starts with
    that env (the pool notice of an elastic attempt). Writes
    ``<out>/<label>_<rank>.json``:
    the Result, every step's loss (hex) and rows this rank fed, each
    checkpoint manager's commit log, and the plan of each step built
    (its slices, ``DCN_SYNC`` / ``DCN_COMPRESS``, fingerprint, and the
    fingerprint of its ``flat`` twin)."""
    import functools
    from gke_ray_train_tpu_torch import pretrain
    from gke_ray_train_tpu_torch.rayint import (
        FailureConfig, RunConfig, TorchTrainer)
    with open(os.path.join(out, "job.json")) as f:
        job = json.load(f)
    os.environ.update(job.get("env", {}))
    rank = _rank()
    rec = {"losses": {}, "rows": {}, "managers": [], "plans": []}
    orig_step, orig_mgr = pretrain.make_train_step, pretrain.CheckpointManager
    orig_run = pretrain.run_training

    def make_train_step(*a, **kw):
        import dataclasses
        step = orig_step(*a, **kw)
        plan = kw.get("plan")
        if plan is not None:
            rec["plans"].append({
                "num_slices": plan.num_slices, "dcn_sync": plan.dcn_sync,
                "dcn_compress": plan.dcn_compress,
                "fingerprint": plan.fingerprint(),
                "flat_twin": dataclasses.replace(
                    plan, dcn_sync="flat", dcn_compress="none").fingerprint()})

        def recorded(st, batch):
            st, m = step(st, batch)
            rec["losses"][int(st.step)] = float(m["loss"]).hex()
            rec["rows"][int(st.step)] = int(batch["inputs"].shape[0])
            return st, m
        return recorded

    class Manager(orig_mgr):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["managers"].append(self)
    pretrain.make_train_step, pretrain.CheckpointManager = \
        make_train_step, Manager
    if job.get("ckpt_every"):
        pretrain.run_training = functools.partial(
            orig_run, ckpt_every=job["ckpt_every"])
    fn = functools.partial(pretrain.train_loop_per_worker, device="cpu")
    try:
        if "worker_env" in job:
            from gke_ray_train_tpu_torch.rayint.trainer import (
                Result, _run_worker)
            got = _run_worker(fn, job["config"], job["worker_env"])
            res = Result(metrics=got["metrics"], attempt_log=[
                {"status": "ok", "resumed_step": got["resumed_step"]}])
        else:
            res = TorchTrainer(
                fn, train_loop_config=job["config"],
                run_config=RunConfig(
                    elastic=job.get("elastic"), retry_backoff_s=0.0,
                    failure_config=FailureConfig(
                        max_failures=job.get("max_failures", 0),
                        max_preemptions=job.get("max_preemptions", 8))),
                use_ray=False).fit()
    finally:
        pretrain.make_train_step, pretrain.CheckpointManager = \
            orig_step, orig_mgr
        pretrain.run_training = orig_run
    res_out = {"status": res.status, "error": res.error,
               "attempts": res.attempts, "preemptions": res.preemptions,
               "log": [{k: v for k, v in e.items() if k != "goodput"}
                       for e in res.attempt_log],
               "losses": rec["losses"], "rows": rec["rows"],
               "plans": rec["plans"],
               "commits": [{"async": m.async_commit,
                            "own_group": m._commit_group is not None,
                            "log": m.commit_log,
                            "resharded": m.last_restore_resharded}
                           for m in rec["managers"]]}
    with open(os.path.join(out, f"{job['label']}_{rank}.json"), "w") as f:
        json.dump(res_out, f)


SCENARIOS = {"train": scenario_train, "agree": scenario_agree,
             "pretrain": scenario_pretrain}
