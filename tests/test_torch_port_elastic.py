"""Elastic re-formation in the port (``plan.py::replan``,
``rayint/elastic.py``, the trainer's pool classification) against the
JAX package's, on the CPU:

- ``replan`` over a grid of declared (data, fsdp, model), declared pool,
  surviving pool and per-device batch: the same mesh and per-device
  batch as JAX's ``plan.replan``, or a ``PlanError`` from both;
- ``elastic_devices`` / ``maybe_replan`` read the trainer's notice and
  nothing else;
- a gloo drill through ``tests/_torch_multirank.py``: the pre-train
  worker at world 4 (fsdp 4) shrunk by ``FAULT_SPEC`` ``pool_shrink`` to
  2 (a preemption carrying the pool: the trainer records a shrink), then
  world 2, its two workers started as the trainer's Ray path starts an
  elastic attempt (``_run_worker`` with the pool notice), re-forms at fsdp 2 with the per-device batch doubled (the
  global batch kept), restores the world-4 checkpoint resharded and
  trains on; its losses within 1e-5 relative of an uninterrupted world-4
  run (sums over another partition of the rows).
"""

import json
import os

import pytest

from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu_torch import plan as tplan
from gke_ray_train_tpu_torch.parallel.mesh import MeshConfig
from gke_ray_train_tpu_torch.rayint import elastic
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


def _jax(data, fsdp, model, chips, n, pdb):
    try:
        plan = jplan.ExecutionPlan(data=data, fsdp=fsdp, model=model,
                                   per_device_batch=pdb,
                                   topology=f"cpu-{chips}")
        new = jplan.replan(plan, n)
    except jplan.PlanError:
        return "PlanError"
    return new.resolved_sizes(), new.per_device_batch


def _port(data, fsdp, model, chips, n, pdb):
    try:
        new, b = tplan.replan(MeshConfig(data=data, fsdp=fsdp, model=model),
                              n, chips=chips, per_device_batch=pdb)
    except tplan.PlanError:
        return "PlanError"
    return {a: getattr(new, a) for a in
            ("data", "fsdp", "model", "context", "pipe")}, b


@pytest.mark.parametrize("chips,model", [(4, 1), (8, 1), (8, 2), (16, 4)])
def test_replan_matches_the_jax_package(chips, model):
    errors = 0
    for data in (1, 2, 4, -1):
        for fsdp in (-1, 1, 2, 4):
            for n in (1, 2, 3, 4, 6, 8, 12, 16):
                for pdb in (1, 3, 4):
                    args = (data, fsdp, model, chips, n, pdb)
                    want = _jax(*args)
                    got = _port(*args)
                    if want != "PlanError":
                        want = ({a: want[0][a] for a in got[0]}, want[1]) \
                            if got != "PlanError" else want
                    assert got == want, args
                    errors += want == "PlanError"
    assert errors  # the grid reaches the PlanErrors too


def test_elastic_knobs_read_the_notice_only(monkeypatch):
    for k in ("ELASTIC", "MIN_DEVICES", elastic.POOL_ENV,
              elastic.FULL_POOL_ENV):
        monkeypatch.delenv(k, raising=False)
    mesh = MeshConfig(data=1, fsdp=-1)
    assert elastic.elastic_devices(4) == 4
    # no notice: the declaration over the world, whatever ELASTIC says
    monkeypatch.setenv("ELASTIC", "1")
    assert elastic.maybe_replan(mesh, 2, world=4) == (mesh.resolve(4), 2)
    monkeypatch.setenv(elastic.POOL_ENV, "2")
    monkeypatch.setenv(elastic.FULL_POOL_ENV, "4")
    assert elastic.elastic_devices(4) == 2
    got, pdb = elastic.maybe_replan(MeshConfig(data=1, fsdp=4), 2, world=2)
    assert (got.data, got.fsdp, pdb) == (1, 2, 4)
    monkeypatch.setenv("ELASTIC", "0")
    with pytest.raises(ValueError):
        elastic.maybe_replan(MeshConfig(data=1, fsdp=4), 2, world=2)
    assert elastic.min_devices({"MIN_DEVICES": "3"}) == 3
    assert elastic.min_devices({"MIN_DEVICES": "x"}) == 1


def _job(out, label, storage, env=None, **kw):
    os.makedirs(out, exist_ok=True)
    config = {"d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 128,
              "dataset_seq_len": 32, "model_max_seq_len": 64,
              "batch_size_per_device": 2, "max_samples": 64, "lr": 1e-3,
              "warmup_frac": 0.25, "log_every": 1, "prefetch_batches": 0,
              "dtype": "float32", "data_dir": storage + "/data",
              "storage_path": storage, "run_name": "lm", "MESH_FSDP": 4}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(dict(label=label, config=config, env=env or {},
                       ckpt_every=2, **kw), f)
    return out


def _read(out, label, n):
    return [json.load(open(os.path.join(out, f"{label}_{r}.json")))
            for r in range(n)]


def test_gloo_drill_shrinks_four_ranks_to_two(tmp_path):
    env = {"PREEMPT_SYNC_EVERY": "1", "PYTHONHASHSEED": "0"}
    ref = _job(str(tmp_path / "ref"), "U", str(tmp_path / "u"))
    shr = _job(str(tmp_path / "shrink"), "S", str(tmp_path / "s"),
               env={"FAULT_SPEC": "kind=pool_shrink:step=2:to=2"},
               elastic=True, max_preemptions=0)
    procs = [mr.start("pretrain", out, n=4, extra_env=env)
             for out in (ref, shr)]
    for p in procs:
        mr.wait(p, timeout=180)
    u, s = _read(ref, "U", 4), _read(shr, "S", 4)
    assert all(r["status"] == "ok" for r in u)
    for r in s:
        assert r["status"] == "preempted" and r["attempts"] == 1
        assert r["log"][0]["event"] == "shrink" and r["log"][0]["pool"] == 2
        assert r["log"][0]["step"] == 2
    # the next attempt as the trainer's Ray path starts it: two workers,
    # told the pool in their env
    res = _job(str(tmp_path / "resume"), "R", str(tmp_path / "s"),
               worker_env={"ELASTIC": "1", "ELASTIC_N_DEVICES": "2",
                           "ELASTIC_FULL_POOL": "4"})
    mr.wait(mr.start("pretrain", res, n=2, extra_env=env), timeout=180)
    r = _read(res, "R", 2)
    for rank in r:
        assert rank["status"] == "ok"
        assert rank["log"][0]["resumed_step"] == 2
        assert rank["commits"][0]["resharded"] == [4, 2]
        # the global batch kept: twice the rows a rank on half the ranks
        assert {int(k): v for k, v in rank["rows"].items()} == \
            {s: 2 * u[0]["rows"][str(s)] for s in range(3, 9)}
    for s_ in range(3, 9):
        want = float.fromhex(u[0]["losses"][str(s_)])
        for rank in r:
            got = float.fromhex(rank["losses"][str(s_)])
            assert abs(got - want) <= 1e-5 * abs(want), (s_, got, want)
