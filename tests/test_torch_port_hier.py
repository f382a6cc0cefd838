"""Multi-slice training on the port (``NUM_SLICES``, the slice groups of
``parallel/mesh.py``, ``parallel/hierarchical.py``, ``DCN_SYNC`` /
``DCN_COMPRESS`` on ``OVERLAP=manual``, slice identity in the trainer
and ``FAULT_SPEC`` ``slice_evict``) against the JAX package on the CPU.

- ``SliceTopology`` / ``slice_topology`` against JAX's over a grid of
  (data, fsdp, model, context, pipe, num_slices): groups, ``ici_size``
  and refusals; ``slice_assignments`` against JAX's contract;
  ``leaf_payload_split`` against JAX's on Llama-3.1-8B's and the tiny
  drill model's leaf shapes.
- The plan: ``NUM_SLICES`` × ``OVERLAP`` × ``DCN_SYNC`` ×
  ``DCN_COMPRESS`` in the config and env dialects against JAX's plan
  (outcome, downgrade, its warning, a downgraded plan fingerprinting as
  ``flat``), ``replan`` keeping whole slices as JAX's does, the node
  check under ``LOCAL_WORLD_SIZE``.
- Two gloo worlds of four ranks (``tests/_torch_hier.py``): data 2 ×
  fsdp 2 and data 4 × fsdp 1, two slices each, JAX's drill config (fp32,
  3 steps of 2 microbatches) from JAX's init: ``flat`` and ``hier`` bit
  for bit in losses, grad norms and trained tensors; each arm within
  rtol 1e-6 of JAX's same arm on a JAX mesh of the same shape
  (``bf16``: 1e-4, the port compresses the norms JAX replicates; the
  gap is stated in ``test_arms_match_jax``); ``bf16`` close to ``hier``
  (rtol 2e-2, JAX's ``test_compressed_arm_close_not_bitwise``) and not
  bit for bit at fsdp 2, and at fsdp 1, where no leaf is fsdp-sharded,
  bit for bit ``hier`` as JAX's is; the cross-slice bytes each rank
  sends, reckoned from the shapes; ``off`` and ``xla`` at two slices bit
  for bit their one-slice runs, and one slice's ``manual`` bit for bit
  ``off``; the sums on the groups; the fine-tune entry at two slices.
- ``slice_evict``: the pool from the slice layout and the refusals, as
  JAX's injector; a gloo drill of the pre-train entry from four ranks
  (two slices, ``DCN_SYNC=hier``) to two, resuming on the downgraded
  ``flat`` plan within 1e-5 of an uninterrupted run.
- The trainer's rank → slice map reaching the supervisor (the fake Ray),
  a stall on one slice classified as that slice's loss.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gke_ray_train_tpu import plan as jplan
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.parallel import hierarchical as jhier
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.testing import faults as jfaults
from gke_ray_train_tpu.train import (
    make_optimizer, make_train_state, make_train_step)
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import preempt as jpreempt
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch import plan as tplan
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models.transformer import proj_shapes
from gke_ray_train_tpu_torch.parallel import hierarchical as thier
from gke_ray_train_tpu_torch.parallel import mesh as tmesh
from gke_ray_train_tpu_torch.rayint import serving as tserving
from gke_ray_train_tpu_torch.rayint import supervisor as tsup
from gke_ray_train_tpu_torch.rayint import trainer as ttrainer
from gke_ray_train_tpu_torch.testing import faults as tfaults
from gke_ray_train_tpu_torch.train import preempt as tpreempt
from tests import _torch_fake_ray as fake
from tests import _torch_hier as hw
from tests import _torch_multirank as mr

LR, TOTAL = 1e-3, 10
JAX_RTOL = 1e-6          # flat / hier against JAX's same arm
BF16_JAX_RTOL = 1e-4     # bf16 against JAX's bf16 (norms compress here)
BF16_HIER_RTOL = 2e-2    # JAX's test_compressed_arm_close_not_bitwise
DRILL = dict(d_model=64, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=128,
             vocab_size=256, max_seq_len=64, remat=True)
# name: (config over the drill's, steps, grad_accum)
CASES = {"accum2": ({}, 3, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


def _cfgs(over):
    kw = dict(DRILL, **over)
    return jcfg.tiny(**kw), tcfg.tiny(**kw)


def _batches(cfg, steps, accum, seed):
    r = np.random.default_rng(seed)
    B, S = 8 * accum, cfg.max_seq_len
    return [{"inputs": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": r.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "weights": r.uniform(0.5, 1.5, (B, S)).astype(np.float32)}
            for _ in range(steps)]


def _jax_arm(jc, params, batches, accum, world, arm):
    """JAX's manual path at ``arm`` on a JAX mesh of ``world``'s shape
    over two slices (4 fake devices): the streams and trained params."""
    sync, compress = hw.ARMS[arm]
    shape = hw.WORLDS[world]
    plan = jplan.ExecutionPlan.from_kwargs(
        num_slices=hw.SLICES, per_device_batch=2, grad_accum=accum,
        max_seq_len=jc.max_seq_len, overlap="manual", dcn_sync=sync,
        dcn_compress=compress, donate_state=False, donate_batch=False,
        compile_cache=False, aot_train_step=False, obs=False,
        topology="cpu-4", **shape)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(num_slices=hw.SLICES, **shape),
                            jax.devices()[:4])
    opt = make_optimizer(joptim.warmup_cosine_schedule(LR, TOTAL,
                                                       warmup_frac=0.2))
    state = make_train_state(jc, opt, jax.random.key(1), mesh=mesh,
                             params=params)
    step = make_train_step(jc, opt, mesh=mesh, plan=plan)
    streams = {"loss": [], "grad_norm": []}
    for b in batches:
        state, m = step(state, jax.device_put(
            {k: jnp.asarray(v) for k, v in b.items()},
            plan.batch_shardings(mesh)))
        streams["loss"].append(float(m["loss"]))
        streams["grad_norm"].append(float(m["grad_norm"]))
    return streams, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hier"))
    cases, starts = {}, {}
    for i, (name, (over, steps, accum)) in enumerate(CASES.items()):
        jc, tc = _cfgs(over)
        params = jtr.init_params(jc, jax.random.key(20 + i))
        starts[name] = params
        cases[name] = {
            "cfg": tc.to_dict(), "lr": LR, "total": TOTAL, "accum": accum,
            "params": interop.params_from_numpy(
                jax.tree.map(np.asarray, params), tc,
                device="cpu").state_dict(),
            "batches": _batches(jc, steps, accum, 300 + 10 * i)}
    import torch
    torch.save({"cases": cases}, os.path.join(out, "inputs.pt"))
    procs = {w: hw.start(w, out) for w in hw.WORLDS}
    jax_runs = {}
    for name, (over, _, accum) in CASES.items():
        jc, _ = _cfgs(over)
        for world in hw.WORLDS:
            for arm in hw.ARMS:
                jax_runs[(name, world, arm)] = _jax_arm(
                    jc, starts[name], cases[name]["batches"], accum, world,
                    arm)
    for w in hw.WORLDS:
        mr.wait(procs[w], timeout=400)
    ranks = {w: [torch.load(os.path.join(out, f"{w}_{r}.pt"),
                            weights_only=False) for r in range(4)]
             for w in hw.WORLDS}
    return {"jax": jax_runs, "ranks": ranks, "cases": cases}


def _jax_trained(jparams, tc):
    p = interop.params_from_numpy(jparams, tc, device="cpu")
    return {n: t.detach().numpy() for n, t in p.named_parameters()}


def _outcome(fn):
    """(the result, None) or (None, (exception type name, the message up
    to its first " — ")): the port words a refusal's tail for its own
    paths."""
    try:
        return fn(), None
    except (tplan.PlanError, jplan.PlanError, ValueError,
            RuntimeError) as e:
        return None, (type(e).__name__, str(e).split(" — ")[0])


# ---------------------------------------------------------------------------
# topology, slice identity, the byte arithmetic
# ---------------------------------------------------------------------------

class _Shape:
    """A mesh by its axis sizes (what both ``slice_topology`` read)."""

    def __init__(self, **sizes):
        self.shape = sizes


# (data, fsdp, model, context, pipe, num_slices)
TOPO_GRID = [(2, 2, 1, 1, 1, 2), (4, 1, 1, 1, 1, 2), (4, 2, 1, 1, 1, 2),
             (8, 1, 1, 1, 1, 4), (2, 4, 1, 1, 1, 2), (6, 1, 1, 1, 1, 3),
             (2, 2, 1, 1, 1, 1), (3, 2, 1, 1, 1, 2), (1, 4, 1, 1, 1, 2),
             (2, 1, 2, 1, 1, 2), (2, 1, 1, 2, 1, 2), (2, 2, 1, 1, 2, 2)]


@pytest.mark.parametrize("grid", TOPO_GRID)
def test_slice_topology_matches_jax(grid):
    data, fsdp, model, context, pipe, ns = grid
    sizes = dict(data=data, fsdp=fsdp, model=model, context=context,
                 pipe=pipe)

    def view(mod, mesh):
        t = mod.slice_topology(mesh, ns)
        if t is None:
            return None
        return (t.num_slices, t.data, t.fsdp, t.data_intra, t.ici_size,
                t.intra_groups, t.cross_groups)
    want = _outcome(lambda: view(jhier, _Shape(**sizes)))
    for mesh in (_Shape(**sizes), tmesh.MeshConfig(num_slices=ns, **sizes)):
        assert _outcome(lambda: view(thier, mesh)) == want, mesh
    refused = data % ns if ns > 1 else 0
    refused = refused or (ns > 1 and (model, context, pipe) != (1, 1, 1))
    assert (want[1] is not None) == bool(refused)
    if want[1] is not None:
        assert want[1][0] == "HierSyncUnsupported"


def test_slice_assignments_match_the_jax_contract(monkeypatch):
    """JAX's ``test_slice_assignments_contract`` on ranks: contiguous
    blocks, one domain where the count does not tile, ``NUM_SLICES`` the
    default, the last slice lost when the pool is truncated."""
    devs = jax.devices()
    for n in (8, 4, 6, 2, 1, 0):
        for ns in (None, 1, 2, 3, 4):
            if ns is None:
                monkeypatch.setenv("NUM_SLICES", "2")
            assert tmesh.slice_assignments(range(n), ns) == \
                jmesh.slice_assignments(devs[:n], ns), (n, ns)
    monkeypatch.delenv("NUM_SLICES")
    assert tmesh.slice_assignments(list(range(8))) == [0] * 8
    assert tmesh.slice_assignments(range(8), 2) == [0, 0, 0, 0, 1, 1, 1, 1]
    assert tmesh.slice_assignments(range(8), 3) == [0] * 8
    assert tmesh.slice_assignments(range(4), 2) == [0, 0, 1, 1]


def _leaf_shapes(cfg):
    """A model's per-layer leaf shapes, the port's (no stacked layer
    dim): each block's projections and two norms, then the root."""
    block = list(proj_shapes(cfg).values()) + [(cfg.d_model,)] * 2
    root = [(cfg.vocab_size, cfg.d_model), (cfg.d_model,)]
    if not cfg.tie_embeddings:
        root.append((cfg.d_model, cfg.vocab_size))
    return block * cfg.n_layers + root


@pytest.mark.parametrize("model", ["llama3_8b", "drill"])
@pytest.mark.parametrize("topo", [(2, 2, 2), (2, 4, 1), (2, 4, 2),
                                  (4, 8, 4), (2, 2, 8)])
def test_leaf_payload_split_matches_jax(model, topo):
    cfg = (tcfg.llama3_8b() if model == "llama3_8b"
           else _cfgs({})[1])
    shapes = _leaf_shapes(cfg)
    ns, data, fsdp = topo
    got = thier.leaf_payload_split(shapes, thier.SliceTopology(ns, data,
                                                               fsdp))
    want = jhier.leaf_payload_split(shapes, jhier.SliceTopology(ns, data,
                                                                fsdp))
    assert got == want
    t = thier.SliceTopology(ns, data, fsdp)
    assert got[1] <= (1 / t.ici_size + 0.01) * got[0]
    assert thier.peer_replication_elems(shapes, ns) == \
        jhier.peer_replication_elems(shapes, ns)


# ---------------------------------------------------------------------------
# the plan, the mesh checks, replan
# ---------------------------------------------------------------------------

def _plan_view(p):
    return (p.num_slices, p.overlap, p.dcn_sync, p.dcn_compress)


@pytest.mark.parametrize("num_slices", [0, 1, 2])
@pytest.mark.parametrize("overlap", ["off", "xla", "manual"])
def test_plan_grid_matches_jax(num_slices, overlap, caplog):
    """Every ``DCN_SYNC`` × ``DCN_COMPRESS`` in both dialects: the port's
    plan and JAX's agree on the outcome (the fields, or the refusal),
    log the same downgrade warnings, and a downgraded plan fingerprints
    as its ``flat`` twin in each package."""
    for sync in ("flat", "hier"):
        for compress in ("none", "bf16"):
            keys = {"NUM_SLICES": num_slices, "OVERLAP": overlap,
                    "DCN_SYNC": sync, "DCN_COMPRESS": compress}
            env = {k: str(v) for k, v in keys.items()}
            for dialect in ("config", "env"):
                caplog.clear()
                with caplog.at_level(logging.WARNING):
                    if dialect == "config":
                        gp = _outcome(lambda: tplan.ExecutionPlan
                                      .from_config(keys))
                        jp = _outcome(lambda: jplan.ExecutionPlan
                                      .from_config(keys))
                    else:
                        gp = _outcome(lambda: tplan.ExecutionPlan.resolve(
                            env=env))
                        jp = _outcome(lambda: jplan.ExecutionPlan
                                      .from_env(env))
                what = (sync, compress, dialect)
                assert (gp[1] is None) == (jp[1] is None), (what, gp, jp)
                if gp[1] is not None:
                    assert gp[1] == jp[1], what
                    continue
                assert _plan_view(gp[0]) == _plan_view(jp[0]), what
                logged = {n: [r.getMessage() for r in caplog.records
                              if r.name == n]
                          for n in ("gke_ray_train_tpu_torch.plan",
                                    "gke_ray_train_tpu.plan")}
                assert logged["gke_ray_train_tpu_torch.plan"] == \
                    logged["gke_ray_train_tpu.plan"], what
                downgraded = sync == "hier" and num_slices == 1
                assert bool(logged["gke_ray_train_tpu.plan"]) == \
                    downgraded, what
                if downgraded:
                    for p, cls in ((gp[0], tplan.ExecutionPlan),
                                   (jp[0], jplan.ExecutionPlan)):
                        twin = cls.from_config(dict(
                            keys, DCN_SYNC="flat", DCN_COMPRESS="none"))
                        assert p.fingerprint() == twin.fingerprint(), what


def test_plan_fields_and_config_surface():
    """``NUM_SLICES`` is a plan field under JAX's key, its value moves
    the fingerprint; ``DCN_SYNC`` / ``DCN_COMPRESS`` are read at any
    world and never warned as TPU keys; ``NUM_SLICES`` warns at one
    process only."""
    assert tplan.CONFIG_KEYS["num_slices"] == \
        jplan.CONFIG_KEYS["num_slices"] == "NUM_SLICES"
    a = tplan.ExecutionPlan(num_slices=2, overlap="manual", dcn_sync="hier")
    assert a.fingerprint() != dataclasses.replace(
        a, dcn_sync="flat").fingerprint()
    assert a.fingerprint() != dataclasses.replace(
        a, num_slices=4).fingerprint()
    keys = {"NUM_SLICES": 2, "DCN_SYNC": "hier", "DCN_COMPRESS": "bf16"}
    assert tconfig.tpu_only_keys(keys) == ["NUM_SLICES"]
    assert tconfig.tpu_only_keys(keys, world=4) == []
    assert {"DCN_SYNC", "DCN_COMPRESS"}.isdisjoint(tconfig.TPU_ONLY_KEYS)


@pytest.mark.parametrize("world,per_node,num_slices,ok", [
    (8, 4, 2, True), (8, 4, 4, False), (8, 2, 4, True), (16, 4, 2, True),
    (16, 8, 4, False), (8, 8, 2, True), (8, 0, 2, True), (4, 2, 2, True)])
def test_slices_must_be_whole_nodes(world, per_node, num_slices, ok,
                                    monkeypatch, caplog):
    """Where ``LOCAL_WORLD_SIZE`` shows more than one node, each slice
    must be whole nodes; on one node (or without the variable) the
    slices are emulated with JAX's warning."""
    if per_node:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(per_node))
    else:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    config = tmesh.MeshConfig(data=num_slices, fsdp=-1,
                              num_slices=num_slices).resolve(world)
    with caplog.at_level(logging.WARNING):
        got = _outcome(lambda: tmesh._check_slices_on_nodes(config, world))
    if ok:
        assert got == (None, None)
        emulated = per_node in (0, world) or per_node > world
        assert ("emulating the %d-slice hybrid mesh" % num_slices
                in caplog.text) == emulated
    else:
        assert got[1][0] == "ValueError" and "whole number of nodes" \
            in got[1][1]


@pytest.mark.parametrize("chips", [4, 8, 16])
def test_replan_keeps_whole_slices_as_jax(chips):
    """``replan`` with ``num_slices``: whole-slice evictions keep the
    slices in proportion, anything else one slice; the same meshes and
    per-device batch as JAX's ``plan.replan``."""
    checked = 0
    for data in (2, 4, -1):
        for ns in (1, 2, 4):
            for n in range(1, chips + 1):
                try:
                    plan = jplan.ExecutionPlan(
                        data=data, fsdp=-1, num_slices=ns,
                        per_device_batch=2, topology=f"cpu-{chips}")
                    new = jplan.replan(plan, n)
                    want = ({**new.resolved_sizes(),
                             "num_slices": new.num_slices},
                            new.per_device_batch)
                except jplan.PlanError:
                    want = "PlanError"
                try:
                    mc, pdb = tplan.replan(
                        tmesh.MeshConfig(data=data, fsdp=-1, num_slices=ns),
                        n, chips=chips, per_device_batch=2)
                    got = ({a: getattr(mc, a) for a in
                            tmesh.MESH_AXES + ("num_slices",)}, pdb)
                except tplan.PlanError:
                    got = "PlanError"
                assert got == want, (data, ns, n)
                checked += 1
    assert checked


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def _run(worlds, world, case, mode, slices, arm=None, rank=0):
    return worlds["ranks"][world][rank][(case, mode, slices, arm)]


@pytest.mark.parametrize("world", list(hw.WORLDS))
def test_flat_and_hier_agree_bit_for_bit(worlds, world):
    """Per rank the loss and grad-norm streams of ``flat`` and ``hier``
    are equal, and so are the trained tensors; every rank's streams are
    the same; the groups are the slices' (intra {0, 1} / {2, 3} at data
    4, cross {0, 2})."""
    for case in CASES:
        for r, res in enumerate(worlds["ranks"][world]):
            flat = res[(case, "manual", 2, "flat")]
            hier = res[(case, "manual", 2, "hier")]
            assert flat["streams"] == hier["streams"], (r, flat, hier)
            assert hier["streams"] == _run(worlds, world, case, "manual", 2,
                                           "hier")["streams"]
        flat = _run(worlds, world, case, "manual", 2, "flat")
        hier = _run(worlds, world, case, "manual", 2, "hier")
        for k, v in flat["trained"].items():
            assert np.array_equal(v.numpy(), hier["trained"][k].numpy()), k
    groups = worlds["ranks"][world][0]["groups"]
    assert groups["cross"] == [0, 2]
    assert groups["intra"] == ([0, 1] if world == "hier41" else None)


@pytest.mark.parametrize("world", list(hw.WORLDS))
@pytest.mark.parametrize("arm", list(hw.ARMS))
def test_arms_match_jax(worlds, world, arm, record_property):
    """Each arm's streams and trained tensors (each leaf's difference's
    norm over its norm) within ``JAX_RTOL`` of JAX's same arm on a JAX
    mesh of the world's shape over two slices, ``bf16`` within
    ``BF16_JAX_RTOL``: the port compresses the norms' cross-slice hop
    too (FSDP2 shards them), JAX carries them in fp32. The largest gap
    is recorded (``max_rel_gap``)."""
    tol = BF16_JAX_RTOL if arm == "bf16" else JAX_RTOL
    gaps = []
    for case, (over, _, _) in CASES.items():
        _, tc = _cfgs(over)
        jstreams, jparams = worlds["jax"][(case, world, arm)]
        got = _run(worlds, world, case, "manual", 2, arm)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["streams"][k], jstreams[k],
                                       rtol=tol, atol=0, err_msg=k)
            gaps += [abs(a - b) / abs(b)
                     for a, b in zip(got["streams"][k], jstreams[k])]
        jt = _jax_trained(jparams, tc)
        for name, t in got["trained"].items():
            gap = np.linalg.norm(t.numpy() - jt[name]) / np.linalg.norm(
                jt[name])
            gaps.append(gap)
            assert gap <= tol, (name, gap)
    # a plain float: pytest-xdist serializes the property to the parent
    record_property("max_rel_gap", float(max(gaps)))


@pytest.mark.parametrize("world", list(hw.WORLDS))
def test_bf16_is_close_to_hier_not_bitwise(worlds, world):
    """At fsdp 2 the compressed arm's losses are not ``hier``'s bit for
    bit and within rtol 2e-2 of them, as JAX's are; at fsdp 1 no leaf is
    fsdp-sharded, so nothing compresses and ``bf16`` is ``hier`` bit for
    bit, in JAX's package as in the port."""
    for case in CASES:
        bf16 = _run(worlds, world, case, "manual", 2, "bf16")["streams"]
        hier = _run(worlds, world, case, "manual", 2, "hier")["streams"]
        jbf16 = worlds["jax"][(case, world, "bf16")][0]
        jhier_ = worlds["jax"][(case, world, "hier")][0]
        if world == "hier41":
            assert bf16 == hier
            assert jbf16 == jhier_
            continue
        assert bf16["loss"] != hier["loss"]
        assert jbf16["loss"] != jhier_["loss"]
        np.testing.assert_allclose(bf16["loss"], hier["loss"],
                                   rtol=BF16_HIER_RTOL)


def _reckoned(trained, world, arm, accum):
    """The cross-slice bytes one rank sends in a step, from the leaves'
    shapes: the full fp32 payload (``flat``), ``leaf_payload_split``'s
    hier elements (``hier``), and under ``bf16`` each microbatch's
    fsdp shard in bf16 (at fsdp 1 nothing compresses: the hier hop each
    microbatch)."""
    shape = hw.WORLDS[world]
    topo = thier.SliceTopology(hw.SLICES, shape["data"], shape["fsdp"])
    shapes = [tuple(t.shape) for t in trained.values()]
    flat, hier = thier.leaf_payload_split(shapes, topo)
    assert (flat, hier) == jhier.leaf_payload_split(
        shapes, jhier.SliceTopology(hw.SLICES, shape["data"],
                                    shape["fsdp"]))
    if arm == "flat":
        return 4 * flat
    if arm == "hier":
        return 4 * hier
    if topo.fsdp == 1:
        return accum * 4 * hier
    return accum * 2 * sum(int(np.prod(s)) // topo.fsdp for s in shapes)


@pytest.mark.parametrize("world", list(hw.WORLDS))
@pytest.mark.parametrize("arm", list(hw.ARMS))
def test_cross_slice_bytes_are_reckoned(worlds, world, arm):
    """Every rank's last step's cross-slice bytes (the manual path's
    tally) equal the reckoning from the shapes; ``hier`` sends at most
    (1 / ici_size + 0.01) of ``flat``."""
    for case, (_, _, accum) in CASES.items():
        trained = _run(worlds, world, case, "manual", 2, arm)["trained"]
        want = _reckoned(trained, world, arm, accum)
        for res in worlds["ranks"][world]:
            assert res[(case, "manual", 2, arm)]["counts"][
                "cross_bytes"] == want
    flat = _reckoned(trained, world, "flat", 2)
    hier = _reckoned(trained, world, "hier", 2)
    assert hier <= (1 / 2 + 0.01) * flat


@pytest.mark.parametrize("world", list(hw.WORLDS))
def test_one_slice_paths_unchanged(worlds, world):
    """``off`` and ``xla`` at two slices are their one-slice runs bit for
    bit (FSDP2 sums as before: only slice identity changes), one slice's
    ``xla`` and ``manual`` are ``off`` bit for bit (the one-slice manual
    path unchanged), and no one-slice run sends a cross-slice byte."""
    for case in CASES:
        for res in worlds["ranks"][world]:
            off1 = res[(case, "off", 1, None)]["streams"]
            for key in ((case, "off", 2, None), (case, "xla", 2, None),
                        (case, "xla", 1, None), (case, "manual", 1, None)):
                assert res[key]["streams"] == off1, key
            assert res[(case, "manual", 1, None)]["counts"][
                "cross_bytes"] == 0
        t0 = _run(worlds, world, case, "off", 1)["trained"]
        for mode, slices in (("off", 2), ("xla", 2), ("manual", 1)):
            got = _run(worlds, world, case, mode, slices)["trained"]
            for k, v in got.items():
                assert np.array_equal(v.numpy(), t0[k].numpy()), (mode, k)


@pytest.mark.parametrize("world", list(hw.WORLDS))
def test_sums_on_the_slice_groups(worlds, world):
    """``parallel/hierarchical.py`` on the world's groups: ``staged_psum``
    and ``hier_reduce_full`` agree bit for bit (along dim 0 and dim 1)
    and with the plain sum, the hier hop sending half the bytes;
    ``hier_psum``'s backward passes the cotangent unchanged and leaves
    its input alone; the shard arms agree bit for bit; the compressed
    hop sums every cross peer's bf16 value and keeps the cast error as
    the residual, refusing another dtype in JAX's words."""
    with pytest.raises(jhier.HierSyncUnsupported) as want:
        jhier.compressed_cross_psum(None, None, None, "fp8")
    for res in worlds["ranks"][world]:
        ops = res["ops"]
        shape = hw.WORLDS[world]
        assert ops["topology"] == (2, shape["data"], shape["fsdp"], 2)
        for label in ("rows", "cols"):
            o = ops[label]
            assert o["bitwise"] and o["err"] < 1e-5, o
            assert o["flat_tally"] == {"cross_reductions": 1,
                                       "cross_bytes": 8 * 6 * 4}
            assert o["hier_tally"] == {"cross_reductions": 1,
                                       "cross_bytes": 8 * 6 * 2}
        for mode in ("flat", "hier"):
            p = ops[f"psum_{mode}"]
            assert p["grad_all_3"] and p["input_kept"]
        import torch
        assert torch.equal(ops["psum_flat"]["value"],
                           ops["psum_hier"]["value"])
        sh = ops["shard"]
        assert torch.equal(sh["flat"], sh["hier"])
        assert tuple(sh["flat"].shape) == (8 // shape["fsdp"], 6)
        c = ops["compressed"]
        assert c["sum_is_peers_bf16"] and c["err_is_cast_error"] \
            and c["second_err"]
        assert c["dtypes"] == ("torch.float32",) * 3
        assert c["tally"] == {"cross_reductions": 1, "cross_bytes": 30}
        assert ops["fp8"] == str(want.value)


def test_entry_trains_at_two_slices(worlds):
    """The fine-tune entry at data 2 × fsdp 2 over two slices with
    ``OVERLAP=manual``: ``DCN_SYNC=hier`` trains its 2 steps to the loss
    and grad norm of ``flat`` bit for bit, sending half the cross-slice
    bytes."""
    for res in worlds["ranks"]["hier22"]:
        e = res["entry"]
        assert e["hier"]["step"] == e["flat"]["step"] == 2
        assert e["hier"]["loss"] == e["flat"]["loss"]
        assert e["hier"]["grad_norm"] == e["flat"]["grad_norm"]
        assert np.isfinite(e["hier"]["loss"])
        hb, fb = (e[s]["counts"]["cross_bytes"] for s in ("hier", "flat"))
        assert 0 < hb and 2 * hb == fb


# ---------------------------------------------------------------------------
# slice_evict and the trainer's slice map
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_faults(monkeypatch):
    for mod in (tfaults, jfaults):
        mod.reset_fired()
        mod.reset_pool()
    tpreempt.reset()
    jpreempt.reset()
    yield
    for mod in (tfaults, jfaults):
        mod.reset_fired()
        mod.reset_pool()
    tpreempt.reset()
    jpreempt.reset()


def test_slice_evict_derives_pool_from_slice_layout(monkeypatch,
                                                    clean_faults):
    """JAX's ``test_slice_evict_derives_pool_from_slice_layout``: 8 ranks
    (JAX: 8 fake devices) in 2 slices, the last evicted, leaves 4; slice
    0 evicted leaves 4 too."""
    monkeypatch.setenv("NUM_SLICES", "2")
    monkeypatch.setenv("WORLD_SIZE", "8")
    for spec in ("rank=0:kind=slice_evict:step=1",
                 "rank=0:kind=slice_evict:step=1:slice=0"):
        got = []
        for mod, pre in ((tfaults, tpreempt), (jfaults, jpreempt)):
            mod.FaultInjector(mod.parse_fault_spec(spec), rank=0) \
                .on_step(1)
            got.append((pre.pool_target(), mod.current_pool()))
            mod.reset_fired()
            mod.reset_pool()
            pre.reset()
        assert got[0] == got[1] == (4, 4), spec


@pytest.mark.parametrize("num_slices,spec", [
    ("2", "kind=slice_evict:step=1:slice=2"),
    ("1", "kind=slice_evict:step=1"),
    ("3", "kind=slice_evict:step=1")])
def test_slice_evict_refusals_match_jax(num_slices, spec, monkeypatch,
                                        clean_faults):
    """A slice that does not exist, and evicting the only domain (one
    slice, or a count that does not tile the pool), raise in JAX's
    words."""
    monkeypatch.setenv("NUM_SLICES", num_slices)
    monkeypatch.setenv("WORLD_SIZE", "8")
    errs = []
    for mod in (tfaults, jfaults):
        with pytest.raises(RuntimeError) as e:
            mod.FaultInjector(mod.parse_fault_spec(spec)).on_step(1)
        errs.append(str(e.value))
        mod.reset_fired()
    assert errs[0] == errs[1]
    assert ("does not exist" if spec.endswith("slice=2")
            else "ENTIRE pool") in errs[0]


def _job(out, label, storage, env=None, **kw):
    os.makedirs(out, exist_ok=True)
    config = {"d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 128,
              "dataset_seq_len": 32, "model_max_seq_len": 64,
              "batch_size_per_device": 2, "max_samples": 64, "lr": 1e-3,
              "warmup_frac": 0.25, "log_every": 1, "prefetch_batches": 0,
              "dtype": "float32", "data_dir": storage + "/data",
              "storage_path": storage, "run_name": "lm", "MESH_DATA": 2,
              "MESH_FSDP": 2}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(dict(label=label, config=config, env=env or {},
                       ckpt_every=2, **kw), f)
    return out


def _read(out, label, n):
    return [json.load(open(os.path.join(out, f"{label}_{r}.json")))
            for r in range(n)]


def test_gloo_drill_slice_evict_four_ranks_to_two(tmp_path):
    """The pre-train entry at data 2 × fsdp 2 over two slices,
    ``OVERLAP=manual``, ``DCN_SYNC=hier``: ``FAULT_SPEC`` ``slice_evict``
    at step 2 evicts slice 1 (ranks 2 and 3), recorded as a shrink to 2
    that burns the preemption budget, not the failure budget; the next
    attempt (two workers, started as the trainer's Ray path starts an
    elastic attempt) re-forms on one slice at fsdp 2, where its plan is
    the downgraded ``flat`` (its fingerprint the ``flat`` twin's),
    restores the four-rank checkpoint resharded and trains on, its
    losses within 1e-5 relative of an uninterrupted two-slice run's."""
    env = {"PREEMPT_SYNC_EVERY": "1", "PYTHONHASHSEED": "0",
           "NUM_SLICES": "2", "DCN_SYNC": "hier", "OVERLAP": "manual"}
    ref = _job(str(tmp_path / "ref"), "U", str(tmp_path / "u"))
    evict = _job(str(tmp_path / "evict"), "S", str(tmp_path / "s"),
                 env={"FAULT_SPEC": "kind=slice_evict:step=2"},
                 elastic=True, max_preemptions=0)
    procs = [mr.start("pretrain", out, n=4, extra_env=env)
             for out in (ref, evict)]
    for p in procs:
        mr.wait(p, timeout=240)
    u, s = _read(ref, "U", 4), _read(evict, "S", 4)
    for r in u:
        assert r["status"] == "ok"
        assert {(p["num_slices"], p["dcn_sync"]) for p in r["plans"]} == \
            {(2, "hier")}
    for r in s:
        assert r["status"] == "preempted" and r["attempts"] == 1
        log = r["log"][0]
        assert (log["event"], log["pool"], log["step"]) == ("shrink", 2, 2)
    res = _job(str(tmp_path / "resume"), "R", str(tmp_path / "s"),
               worker_env={"ELASTIC": "1", "ELASTIC_N_DEVICES": "2",
                           "ELASTIC_FULL_POOL": "4"})
    mr.wait(mr.start("pretrain", res, n=2, extra_env=env), timeout=240)
    for rank in _read(res, "R", 2):
        assert rank["status"] == "ok"
        assert rank["log"][0]["resumed_step"] == 2
        assert rank["commits"][0]["resharded"] == [4, 2]
        plan = rank["plans"][-1]
        assert (plan["num_slices"], plan["dcn_sync"],
                plan["dcn_compress"]) == (1, "flat", "none")
        assert plan["fingerprint"] == plan["flat_twin"]
        for step in range(3, 9):
            want = float.fromhex(u[0]["losses"][str(step)])
            got = float.fromhex(rank["losses"][str(step)])
            assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)


@pytest.fixture
def fake_ray(monkeypatch):
    return fake.install(monkeypatch, ttrainer, tserving)


def test_trainer_hands_the_slice_map_to_the_supervisor(
        fake_ray, monkeypatch, clean_faults):
    """The Ray path with ``NUM_SLICES`` 2 in the config and four workers
    hands the supervisor {rank: slice} (JAX's trainer :604-630); a stall
    of ranks 2 and 3 is reported as slice 1's loss and, the job being
    elastic, classified as a shrink to the other slice's two workers,
    which the next attempt runs (preemption budget, not failures)."""
    monkeypatch.delenv("NUM_SLICES", raising=False)
    calls = {"n": 0}

    def stalled(self, timeout_s):
        calls["n"] += 1
        return [(2, 5, 9.9), (3, 5, 9.9)] if calls["n"] == 1 else []
    monkeypatch.setattr(tsup.Supervisor, "stalled", stalled)
    seen = []

    def worker(config):
        seen.append(os.environ["WORLD_SIZE"])
        return "HANG" if len(seen) <= 4 else {"ok": 1}
    saved = dict(os.environ)
    try:
        res = ttrainer.TorchTrainer(
            worker, train_loop_config={"NUM_SLICES": 2},
            scaling_config=ttrainer.ScalingConfig(num_workers=4),
            run_config=ttrainer.RunConfig(
                elastic=True, heartbeat_timeout_s=0.05,
                failure_config=ttrainer.FailureConfig(max_failures=0)),
            use_ray=True).fit()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    sups = [a for a in fake_ray["actors"] if isinstance(a, tsup.Supervisor)]
    assert sups[0]._board.slice_map() == {0: 0, 1: 0, 2: 1, 3: 1}
    first = res.attempt_log[0]
    assert "slice-loss signature" in first["error"]
    assert (first["slice"], first["event"], first["pool"]) == (1, "shrink", 2)
    assert res.error is None and res.preemptions == 1
    assert seen == ["4"] * 4 + ["2"] * 2
