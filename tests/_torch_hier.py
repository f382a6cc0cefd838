"""Multi-slice scenarios of the port's tests (``NUM_SLICES``,
``DCN_SYNC``, ``DCN_COMPRESS``): gloo worlds of four ranks on the CPU,
one process a rank, started and awaited as ``tests/_torch_overlap.py``
starts its own.

- ``hier22``: data 2 × fsdp 2 over two slices (ranks {0, 1} and {2, 3});
- ``hier41``: data 4 × fsdp 1 over two slices (the intra-slice ``data``
  scatter: slice groups {0, 1} / {2, 3}, cross groups {0, 2} / {1, 3}).

Each world runs every case of ``<out>/inputs.pt`` from the same start,
each rank fed its block of every microbatch: ``manual`` under the three
arms on the two-slice mesh (``flat``, ``hier``, ``hier`` + ``bf16``),
``off``, ``xla`` and ``manual`` on the one-slice mesh of the same shape,
and ``off`` and ``xla`` on the two-slice mesh; per run the loss and
grad-norm streams, the manual path's tally of the last step
(``train/overlap.py::COUNTS``) and the trained tensors whole (rank 0).
Then the sums of ``parallel/hierarchical.py`` on the world's groups
(``ops``); ``hier22`` also runs the fine-tune entry at ``NUM_SLICES`` 2
under ``DCN_SYNC`` ``hier`` and ``flat`` (``entry``). Each rank writes
``<out>/<world>_<rank>.pt``; the parent test compares. """

import os
import subprocess
import sys

from tests import _torch_multirank as mr

_CODE = """
import sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
import _torch_hier as h
h.run_scenario({name!r}, {out!r})
"""

WORLDS = {"hier22": dict(data=2, fsdp=2), "hier41": dict(data=4, fsdp=1)}
SLICES = 2
# arm: (DCN_SYNC, DCN_COMPRESS)
ARMS = {"flat": ("flat", "none"), "hier": ("hier", "none"),
        "bf16": ("hier", "bf16")}


def start(name: str, out: str):
    """Start the four ranks of world ``name``; returns the Popens
    (awaited with ``_torch_multirank.wait``)."""
    port = mr.free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "RANK": str(rank), "WORLD_SIZE": "4",
                    "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
                    "HF_HUB_OFFLINE": "1",
                    "PYTHONPATH": mr.REPO + os.pathsep
                    + env.get("PYTHONPATH", "")})
        env.pop("LOCAL_WORLD_SIZE", None)
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


def _run(case, mesh, mode, slices=1, sync="flat", compress="none"):
    """One run of ``case`` on ``mesh`` under ``mode`` (and the arm):
    the streams, the last step's manual tally and the trained tensors
    (rank 0; every rank joins the gathers)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.models import init_params
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.parallel.mesh import (
        batch_group_size, batch_rank)
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        make_optimizer, make_train_state, make_train_step,
        warmup_cosine_schedule)
    from gke_ray_train_tpu_torch.train import overlap as tov
    from tests._torch_overlap import rank_rows
    cfg = ModelConfig.from_dict(case["cfg"])
    params = init_params(cfg, seed=0, device="cpu")
    params.load_state_dict(case["params"], strict=True)
    spec = make_optimizer(warmup_cosine_schedule(
        case["lr"], case["total"], warmup_frac=0.2))
    state = make_train_state(cfg, spec, params=params, device="cpu",
                             mesh=mesh)
    plan = ExecutionPlan(overlap=mode, grad_accum=case["accum"],
                         num_slices=slices, dcn_sync=sync,
                         dcn_compress=compress)
    step = make_train_step(cfg, spec, plan=plan, device="cpu", mesh=mesh)
    streams = {"loss": [], "grad_norm": []}
    for batch in case["batches"]:
        tov.reset_counts()
        state, m = step(state, rank_rows(batch, case["accum"],
                                         batch_rank(mesh),
                                         batch_group_size(mesh)))
        streams["loss"].append(float(m["loss"]))
        streams["grad_norm"].append(float(m["grad_norm"]))
    r = {"streams": streams, "counts": dict(tov.COUNTS)}
    trained = mr.trained_tensors(state)
    if dist.get_rank() == 0:
        r["trained"] = trained
    return r


def scenario(name: str, out: str) -> dict:
    import torch
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    from gke_ray_train_tpu_torch.parallel.mesh import slice_groups
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    kw = WORLDS[name]
    sliced = build_mesh(MeshConfig(num_slices=SLICES, **kw))
    single = build_mesh(MeshConfig(**kw))
    import torch.distributed as dist
    intra, cross = slice_groups(sliced)
    res = {"groups": {
        "intra": None if intra is None
        else dist.get_process_group_ranks(intra),
        "cross": dist.get_process_group_ranks(cross)}}
    for case_name, case in inputs["cases"].items():
        for arm, (sync, compress) in ARMS.items():
            res[(case_name, "manual", SLICES, arm)] = _run(
                case, sliced, "manual", SLICES, sync, compress)
        for mode in ("off", "xla", "manual"):
            res[(case_name, mode, 1, None)] = _run(case, single, mode)
        for mode in ("off", "xla"):
            res[(case_name, mode, SLICES, None)] = _run(case, sliced, mode,
                                                        SLICES)
    res["ops"] = ops(sliced)
    if name == "hier22":
        res["entry"] = entry_runs(out)
    return res


def _rank_input(rank: int, shape, seed: int):
    import torch
    g = torch.Generator().manual_seed(seed + rank)
    return torch.randn(shape, generator=g)


def ops(mesh) -> dict:
    """The sums of ``parallel/hierarchical.py`` on this world's groups,
    on inputs every rank can make for every rank: ``staged_psum`` and
    ``hier_reduce_full`` of a [8, 6] tensor (and along dim 1 of a
    [6, 8]), both ``hier_psum`` modes with their backward, the shard
    sums of one fsdp-sharded leaf, and ``compressed_cross_psum`` against
    the sum of every cross peer's bf16 value; each with its tally."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import hierarchical as hr
    rank, world = dist.get_rank(), dist.get_world_size()
    topo = hr.slice_topology(mesh, SLICES)
    out = {"topology": (topo.num_slices, topo.data, topo.fsdp,
                        topo.ici_size)}
    for label, shape, dim in (("rows", (8, 6), None), ("cols", (6, 8), 1)):
        xs = [_rank_input(r, shape, 0) for r in range(world)]
        want = xs[0].clone()
        for x in xs[1:]:
            want = want + x
        t_flat = {"cross_reductions": 0, "cross_bytes": 0}
        t_hier = dict(t_flat)
        flat = hr.staged_psum(xs[rank].clone(), topo, t_flat)
        hier = hr.hier_reduce_full(xs[rank].clone(), topo, dim, t_hier)
        out[label] = {"bitwise": torch.equal(flat, hier),
                      "err": float((flat - want).abs().max()),
                      "flat_tally": t_flat, "hier_tally": t_hier}
    for mode in ("flat", "hier"):
        x = _rank_input(rank, (8, 6), 1).requires_grad_(True)
        y = hr.hier_psum(x, topo, mode=mode)
        (y * 3.0).sum().backward()
        out[f"psum_{mode}"] = {
            "value": y.detach(), "grad_all_3": bool((x.grad == 3.0).all()),
            "input_kept": torch.equal(x.detach(),
                                      _rank_input(rank, (8, 6), 1))}
    # one fsdp-sharded leaf [8, 6] on dim 0: the flat, hier and intra
    # arms, each this rank's shard
    ct = _rank_input(rank, (8, 6), 2)
    out["shard"] = {
        "flat": hr.flat_reduce_shard(ct.clone(), topo, 0),
        "hier": hr.hier_reduce_shard(ct.clone(), topo, 0),
        "intra": hr.intra_reduce_shard(ct.clone(), topo, 0)}
    # the compressed hop: each rank's partial, its residual zero, then
    # the residual fed back
    p = _rank_input(rank, (5, 3), 3)
    tally = {"cross_reductions": 0, "cross_bytes": 0}
    s, err = hr.compressed_cross_psum(p, torch.zeros_like(p), topo,
                                      tally=tally)
    peers = dist.get_process_group_ranks(topo.cross_group)
    want = None
    for r in peers:
        q = _rank_input(r, (5, 3), 3).to(torch.bfloat16)
        want = q if want is None else want + q
    s2, err2 = hr.compressed_cross_psum(p, err, topo)
    x2 = p + err
    out["compressed"] = {
        "sum_is_peers_bf16": torch.equal(s, want.float()),
        "err_is_cast_error": torch.equal(
            err, p - p.to(torch.bfloat16).float()),
        "second_err": torch.equal(err2, x2 - x2.to(torch.bfloat16).float()),
        "dtypes": (str(s.dtype), str(err.dtype), str(s2.dtype)),
        "tally": tally}
    try:
        hr.compressed_cross_psum(p, err, topo, compress="fp8")
        out["fp8"] = None
    except hr.HierSyncUnsupported as e:
        out["fp8"] = str(e)
    return out


# the fine-tune entry's smoke config, full fine-tuning at data 2 × fsdp 2
# over two slices (DCN_SYNC set per run)
ENTRY = {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
         "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": 384,
         "NUM_TRAIN_SAMPLES": 8, "NUM_EVAL_SAMPLES": 2,
         "PER_DEVICE_TRAIN_BATCH_SIZE": 1, "GRADIENT_ACCUMULATION_STEPS": 1,
         "NUM_TRAIN_EPOCHS": 1, "LEARNING_RATE": 1e-3,
         "MESH_DATA": 2, "MESH_FSDP": 2, "NUM_SLICES": 2,
         "OVERLAP": "manual", "SAVE_STRATEGY": "no",
         "EVALUATION_STRATEGY_SFT": "no", "LOGGING_STEPS": 1,
         "REPORT_TO": "none", "INFERENCE": False}


def entry_runs(out: str) -> dict:
    """The fine-tune entry's worker at ``NUM_SLICES`` 2 under
    ``DCN_SYNC`` ``hier`` and ``flat``: the numbers of its last metrics
    and the cross-slice bytes of its last step."""
    from gke_ray_train_tpu_torch import fine_tune
    from gke_ray_train_tpu_torch.train import overlap as tov
    res = {}
    for sync in ("hier", "flat"):
        tov.reset_counts()
        metrics = fine_tune.train_loop_per_worker(
            dict(ENTRY, DCN_SYNC=sync,
                 OUTPUT_DIR_BASE=os.path.join(out, f"entry_{sync}")),
            device="cpu")
        res[sync] = dict({k: v for k, v in metrics.items()
                          if isinstance(v, (int, float))},
                         counts=dict(tov.COUNTS))
    return res
