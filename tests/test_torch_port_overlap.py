"""``OVERLAP`` on the port (``gke_ray_train_tpu_torch/train/overlap.py``,
the plan's ``overlap`` field, ``parallel/sharding.py::set_prefetch``)
against the JAX package on the CPU.

- The plan and config surface, case by case against JAX's
  ``ExecutionPlan``: the three modes, a bad mode, the off spellings of
  the env dialect, ``manual`` refused at ``model`` / ``context`` /
  ``pipe`` 2 in JAX's words (the port's ``check_mesh`` takes the mesh the
  port resolves from ``MESH_*`` and the world size, where JAX's plan
  carries the axes and a topology), a ``-1`` fill that resolves to 1
  accepted and one that resolves to 2 refused; ``DCN_SYNC=hier`` on one
  slice downgraded to ``flat`` and ``DCN_COMPRESS=bf16`` without ``hier``
  refused, as JAX's plan does (the grid is in
  ``test_torch_port_hier.py``); ``OVERLAP`` read by the plan, not warned
  about as a TPU key.
- ``check_manual_support`` against JAX's: no mesh, a ``model`` axis of
  2, LoRA, MoE, the same messages.
- Two gloo worlds (``tests/_torch_overlap.py``): data 1 × fsdp 2 and
  data 2 × fsdp 2, on JAX's drill config (``tests/test_overlap.py``:
  d_model 64, 2 layers, 2 / 2 heads, d_ff 128, vocab 256, 64 tokens,
  remat; fp32), weights from JAX's init through
  ``interop.params_from_numpy`` and batches from a numpy seed, each
  running ``off``, ``xla`` and ``manual``: 3 steps at 8 rows, 3 steps of
  2 microbatches, JAX's deeper GQA case (4 layers, 4 / 2 heads, d_ff
  256, vocab 1,024, 128 tokens) and ``FUSED_OPS=1`` (JAX's
  ``test_fused_manual_compose``: 128 tokens, 2 steps). ``xla`` and
  ``manual`` equal ``off`` bit for bit (losses, grad norms, trained
  tensors); ``manual`` gathers exactly the bytes FSDP2 gathers (each
  block once in the forward and once in its recomputation, the root
  once); every step's loss and grad norm, and each trained tensor (its
  difference's norm over its norm), are within rtol 1e-6 of JAX's
  ``manual`` on its 8-device mesh (data 2 × fsdp 4) on the same global
  batches, both trained by AdamW on the port tests' warm-up cosine
  schedule (``test_torch_port_train.py``). Not bitwise against JAX: the two
  packages sum in different orders, and JAX's own ``off`` and ``manual``
  drift 8.6e-8 apart on jax 0.9.0 (``tests/test_overlap.py::
  test_bitwise_loss_equivalence_off_xla_manual``). The fused case is
  held at JAX's own fused-path tolerance, 1e-4 relative.
"""

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
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.train import (
    make_optimizer, make_train_state, make_train_step)
from gke_ray_train_tpu.train import optim as joptim
from gke_ray_train_tpu.train import overlap as jov
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch import plan as tplan
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.parallel import MeshConfig
from gke_ray_train_tpu_torch.train import overlap as tov
from tests import _torch_multirank as mr
from tests import _torch_overlap as ov

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port tests' schedule (test_torch_port_train.py): AdamW warmed up
# over the first 2 of 10 steps, then cosine
LR, TOTAL = 1e-3, 10
JAX_RTOL = 1e-6          # against JAX's manual, loss / grad norm / tensors
FUSED_RTOL = 1e-4        # JAX's test_fused_manual_compose
DRILL = dict(d_model=64, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=128,
             vocab_size=256, max_seq_len=64, remat=True)
# name: (config over the drill's, steps, grad_accum, FUSED_OPS)
CASES = {"drill": ({}, 3, 1, False),
         "accum2": ({}, 3, 2, False),
         "gqa_deeper": (dict(n_layers=4, n_heads=4, n_kv_heads=2,
                             d_ff=256, vocab_size=1024, max_seq_len=128),
                        3, 1, False),
         "fused": (dict(max_seq_len=128), 2, 1, True)}
# the entry's smoke config, full fine-tuning at fsdp 2 (OVERLAP is set per
# run)
ENTRY = {"SMOKE_TEST": True, "MODEL_ID": "offline/none",
         "DATASET_NAME": "offline/none", "MAX_SEQ_LENGTH": 384,
         "NUM_TRAIN_SAMPLES": 4, "NUM_EVAL_SAMPLES": 2,
         "PER_DEVICE_TRAIN_BATCH_SIZE": 1, "GRADIENT_ACCUMULATION_STEPS": 1,
         "NUM_TRAIN_EPOCHS": 1, "LEARNING_RATE": 1e-3,
         "MESH_DATA": 1, "MESH_FSDP": 2, "SAVE_STRATEGY": "no",
         "EVALUATION_STRATEGY_SFT": "steps", "EVAL_STEPS_SFT": 1,
         "LOGGING_STEPS": 1,
         "REPORT_TO": "none", "INFERENCE": False}


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


def _jax_plan(**kw):
    base = dict(data=2, fsdp=4, per_device_batch=1, donate_state=False,
                donate_batch=False, compile_cache=False,
                aot_train_step=False, obs=False, topology="cpu-8")
    base.update(kw)
    return jplan.ExecutionPlan.from_kwargs(**base)


def _jax_manual(jc, params, batches, accum, fused):
    """JAX's manual path on the 8 fake devices (data 2 × fsdp 4): the
    streams and the trained params as numpy."""
    plan = _jax_plan(overlap="manual", grad_accum=accum,
                     max_seq_len=jc.max_seq_len, fused_ops=fused)
    mesh = plan.build_mesh(jax.devices())
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
    out = str(tmp_path_factory.mktemp("overlap"))
    cases, starts = {}, {}
    for i, (name, (over, steps, accum, fused)) in enumerate(CASES.items()):
        jc, tc = _cfgs(over)
        params = jtr.init_params(jc, jax.random.key(i))
        starts[name] = params
        np_params = jax.tree.map(np.asarray, params)
        cases[name] = {
            "cfg": tc.to_dict(), "lr": LR, "total": TOTAL, "accum": accum,
            "fused": fused,
            "params": interop.params_from_numpy(np_params, tc,
                                                device="cpu").state_dict(),
            "batches": _batches(jc, steps, accum, 100 + 10 * i)}
    import torch
    torch.save({"cases": cases}, os.path.join(out, "inputs.pt"))
    with open(os.path.join(out, "entry.json"), "w") as f:
        json.dump(ENTRY, f)
    procs = {w: ov.start(w, out) for w in ov.WORLDS}
    jax_runs = {}
    for name, (over, _, accum, fused) in CASES.items():
        jc, _ = _cfgs(over)
        jax_runs[name] = _jax_manual(jc, starts[name],
                                     cases[name]["batches"], accum, fused)
    for w in ov.WORLDS:
        mr.wait(procs[w], timeout=300)
    ranks = {w: [torch.load(os.path.join(out, f"{w}_{r}.pt"),
                            weights_only=False)
                 for r in range(c["data"] * c["fsdp"])]
             for w, c in ov.WORLDS.items()}
    return {"jax": jax_runs, "ranks": ranks, "cases": cases}


def _port_trained(trained, tc):
    return {k: v.numpy() for k, v in trained.items()}


def _jax_trained(jparams, tc):
    p = interop.params_from_numpy(jparams, tc, device="cpu")
    return {n: t.detach().numpy() for n, t in p.named_parameters()}


# ---------------------------------------------------------------------------
# the plan and the config surface
# ---------------------------------------------------------------------------

def _outcome(fn):
    """(the result, None) or (None, (exception type name, message))."""
    try:
        return fn(), None
    except (tplan.PlanError, jplan.PlanError, ValueError,
            NotImplementedError) as e:
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("mode", ["off", "xla", "manual", "MANUAL", "Xla",
                                  "bogus"])
def test_modes_and_bad_mode_match_jax(mode):
    got, gerr = _outcome(lambda: tplan.ExecutionPlan.from_kwargs(
        overlap=mode).overlap)
    want, werr = _outcome(lambda: jplan.ExecutionPlan.from_kwargs(
        overlap=mode).overlap)
    assert got == want
    assert (gerr is None) == (werr is None)
    if gerr:
        assert gerr[1] == werr[1] == (
            f"overlap={mode.lower()!r} not in ('off', 'xla', 'manual')")


@pytest.mark.parametrize("spelling", ["", "0", "false", "no", "off", "OFF",
                                      " manual ", "xla"])
def test_env_and_config_dialect_match_jax(spelling):
    for dialect in ("config", "env"):
        if dialect == "config":
            got = tplan.ExecutionPlan.from_config({"OVERLAP": spelling})
            want = jplan.ExecutionPlan.from_config({"OVERLAP": spelling})
        else:
            got = tplan.ExecutionPlan.resolve(env={"OVERLAP": spelling})
            want = jplan.ExecutionPlan.from_env({"OVERLAP": spelling})
        assert got.overlap == want.overlap, dialect


# (data, fsdp, model, context, pipe) on 8 ranks
MESH_CASES = {"model2": (1, 4, 2, 1, 1), "context2": (1, 4, 1, 2, 1),
              "pipe2": (1, 4, 1, 1, 2), "fill_to_one": (2, 4, -1, 1, 1),
              "fill_to_two": (2, 2, -1, 1, 1), "data_fsdp": (2, 4, 1, 1, 1)}


@pytest.mark.parametrize("name", list(MESH_CASES))
@pytest.mark.parametrize("mode", ["manual", "xla"])
def test_manual_refused_on_structural_axes_in_jax_words(name, mode):
    d, f, m, c, p = MESH_CASES[name]
    got, gerr = _outcome(lambda: tplan.ExecutionPlan.from_kwargs(
        overlap=mode).check_mesh(MeshConfig(data=d, fsdp=f, model=m,
                                            context=c, pipe=p), 8).overlap)
    want, werr = _outcome(lambda: _jax_plan(
        data=d, fsdp=f, model=m, context=c, pipe=p, overlap=mode,
        max_seq_len=128).overlap)
    assert (got, gerr) == (want, werr)
    refused = mode == "manual" and name not in ("fill_to_one", "data_fsdp")
    assert (gerr is not None) == refused, gerr
    if refused:
        assert gerr[0] == "PlanError" and "supports data/fsdp meshes" \
            in gerr[1]


@pytest.mark.parametrize("key, value", [("DCN_SYNC", "hier"),
                                        ("DCN_COMPRESS", "bf16")])
def test_hier_and_bf16_raise_naming_item_8(key, value, caplog):
    """On one slice (``NUM_SLICES`` unset) ``DCN_SYNC=hier`` is
    downgraded to ``flat`` with JAX's warning, and ``DCN_COMPRESS=bf16``
    without ``hier`` is refused in JAX's words: the outcome of JAX's
    plan on the same keys."""
    keys = {key: value, "OVERLAP": "manual"}
    with caplog.at_level(logging.WARNING):
        got = _outcome(lambda: (lambda p: (p.dcn_sync, p.dcn_compress))(
            tplan.ExecutionPlan.from_config(keys)))
        want = _outcome(lambda: (lambda p: (p.dcn_sync, p.dcn_compress))(
            jplan.ExecutionPlan.from_config(keys)))
    assert got == want
    if key == "DCN_SYNC":
        assert got == (("flat", "none"), None)
        assert [r.getMessage() for r in caplog.records
                if r.name == "gke_ray_train_tpu_torch.plan"] == \
            [r.getMessage() for r in caplog.records
             if r.name == "gke_ray_train_tpu.plan"] != []
    else:
        assert got[1][0] == "PlanError" and "set DCN_SYNC=hier" in got[1][1]
    # the first arms stay the defaults, as JAX's
    plan = tplan.ExecutionPlan.from_config({"DCN_SYNC": "flat",
                                            "DCN_COMPRESS": "none"})
    assert (plan.dcn_sync, plan.dcn_compress) == (
        jplan.ExecutionPlan().dcn_sync, jplan.ExecutionPlan().dcn_compress)


def test_overlap_is_read_not_warned(caplog):
    assert "OVERLAP" in tplan.CONFIG_KEYS.values()
    assert "OVERLAP" not in tconfig.TPU_ONLY_KEYS
    with open(os.path.join(REPO, "ray-jobs", "fine_tune_config.json")) as f:
        config = json.load(f)
    with caplog.at_level(logging.WARNING, logger="gke_ray_train_tpu_torch"):
        tconfig.audit_config(config)
    assert "OVERLAP" not in caplog.text
    assert tplan.ExecutionPlan.resolve(config, env={}).overlap == "xla"
    assert tplan.ExecutionPlan().fingerprint() != \
        tplan.ExecutionPlan(overlap="manual").fingerprint()


# ---------------------------------------------------------------------------
# check_manual_support against JAX's
# ---------------------------------------------------------------------------

class _PortMesh:
    """A stand-in for the port's DeviceMesh: its five axes' sizes."""
    mesh_dim_names = ("data", "fsdp", "model", "context", "pipe")

    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, i):
        return self.sizes[i]


@pytest.mark.parametrize("what", ["no_mesh", "model2", "lora", "moe",
                                  "dense"])
def test_check_manual_support_matches_jax(what):
    jc, tc = _cfgs({})
    jmesh_, tmesh = (jmesh.build_mesh(jmesh.MeshConfig(data=2, fsdp=4),
                                      jax.devices()), _PortMesh(2, 4, 1, 1, 1))
    lora = what == "lora"
    if what == "no_mesh":
        jmesh_, tmesh = None, None
    if what == "model2":
        jmesh_ = jmesh.build_mesh(jmesh.MeshConfig(fsdp=4, model=2),
                                  jax.devices())
        tmesh = _PortMesh(1, 4, 2, 1, 1)
    if what == "moe":
        jc, tc = _cfgs(dict(n_experts=4, expert_top_k=2))
    errs = []
    for mod, cfg, mesh in ((jov, jc, jmesh_), (tov, tc, tmesh)):
        try:
            mod.check_manual_support(cfg, mesh, lora=lora)
            errs.append(None)
        except mod.ManualOverlapUnsupported as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[1] is None) == (what == "dense")


def test_step_without_a_mesh_raises_in_jax_words():
    from gke_ray_train_tpu_torch.train import make_optimizer as tmake
    from gke_ray_train_tpu_torch.train import make_train_step as tstep
    _, tc = _cfgs({})
    with pytest.raises(tov.ManualOverlapUnsupported, match="needs a mesh"):
        tstep(tc, tmake(LR), device="cpu",
              plan=tplan.ExecutionPlan(overlap="manual"))


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", list(ov.WORLDS))
@pytest.mark.parametrize("case", list(CASES))
def test_xla_and_manual_are_off_bit_for_bit(worlds, world, case):
    """Per rank: the loss and grad-norm streams and the trained tensors
    of ``xla`` and ``manual`` equal ``off``'s exactly; every rank's
    streams are the same; the parameters stay placed as FSDP2 placed
    them."""
    ranks = worlds["ranks"][world]
    for r in ranks:
        off = r[(case, "off")]
        for mode in ("xla", "manual"):
            got = r[(case, mode)]
            assert got["streams"] == off["streams"], (mode, got, off)
            assert got["placements"] == off["placements"], mode
        assert r[(case, "off")]["streams"] == \
            ranks[0][(case, "off")]["streams"]
    t0 = ranks[0]
    for mode in ("xla", "manual"):
        for k, v in t0[(case, mode)]["trained"].items():
            assert np.array_equal(v.numpy(),
                                  t0[(case, "off")]["trained"][k].numpy()), \
                (mode, k)


@pytest.mark.parametrize("world", list(ov.WORLDS))
def test_manual_gathers_each_leaf_once_a_pass(worlds, world):
    """The last step's all-gathered bytes: ``manual``'s equal FSDP2's
    under ``off`` (and ``xla``'s): the root once a microbatch, each block
    once in the forward and once in its recomputation, nothing twice;
    the manual path's own tally says the same, reckoned from the shapes
    (fp32, every rank's shards)."""
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    for case, (_, _, accum, _) in CASES.items():
        tc = ModelConfig.from_dict(worlds["cases"][case]["cfg"])
        block = sum(int(np.prod(s)) for s in proj_shapes(tc).values()) \
            + 2 * tc.d_model
        root = 2 * tc.vocab_size * tc.d_model + tc.d_model
        want = 4 * accum * (root + 2 * tc.n_layers * block)
        for r in worlds["ranks"][world]:
            got = {m: r[(case, m)]["gathered_bytes"] for m in ov.MODES}
            assert got == {"off": want, "xla": want, "manual": want}, \
                (case, got, want)
            counts = r[(case, "manual")]["manual_counts"]
            assert counts["gather_bytes"] == want
            assert counts["gathers"] == accum * (1 + 2 * tc.n_layers)
            assert counts["reductions"] == 1 + tc.n_layers


@pytest.mark.parametrize("case", list(CASES))
def test_manual_matches_jax_manual(worlds, case):
    """Both worlds' ``manual`` streams and trained tensors against JAX's
    ``manual`` on data 2 × fsdp 4, on the same global batches."""
    over, _, _, fused = CASES[case]
    _, tc = _cfgs(over)
    jstreams, jparams = worlds["jax"][case]
    jt = _jax_trained(jparams, tc)
    tol = FUSED_RTOL if fused else JAX_RTOL
    for world, ranks in worlds["ranks"].items():
        got = ranks[0][(case, "manual")]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["streams"][k], jstreams[k],
                                       rtol=tol, atol=0,
                                       err_msg=f"{world} {k}")
        for name, t in _port_trained(got["trained"], tc).items():
            # leaf by leaf, relative to the leaf's norm: AdamW divides each
            # element's gradient by its own scale, so an element whose
            # gradient is near zero moves on rounding alone
            gap = np.linalg.norm(t - jt[name]) / np.linalg.norm(jt[name])
            assert gap <= tol, (world, name, gap)


def test_entry_reads_overlap_across_ranks(worlds):
    """The fine-tune entry at fsdp 2: ``OVERLAP`` ``xla`` and ``manual``
    both train, to the same loss bit for bit, and evaluate after each
    step through the sharded root (the same eval loss); ``manual`` at
    ``MESH_MODEL`` 2 raises ``PlanError`` in JAX's words before any
    weight is built."""
    for r in worlds["ranks"]["fsdp2"]:
        e = r["entry"]
        assert e["xla"]["step"] == e["manual"]["step"] == 2
        assert e["xla"]["loss"] == e["manual"]["loss"]
        assert len(e["manual"]["evals"]) == 2
        assert e["xla"]["evals"] == e["manual"]["evals"]
        want = _outcome(lambda: _jax_plan(
            data=1, fsdp=4, model=2, overlap="manual",
            max_seq_len=128))[1]
        assert e["model2"] == ("PlanError", want[1])


@pytest.mark.parametrize("axis", ["model", "pipe"])
def test_xla_composes_with_model_and_pipe(worlds, axis):
    """FSDP2's prefetch on the units of a tensor-parallel model and of a
    pipeline stage (``StageBlocks``): ``xla``'s streams equal ``off``'s
    at model 2 and at pipe 2."""
    key = ("xla_composes", (("fsdp", 1), (axis, 2)))
    for r in worlds["ranks"]["fsdp2"]:
        runs = r[key]
        assert runs["xla"] == runs["off"] and len(runs["off"]) == 3
