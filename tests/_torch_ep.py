"""Expert-parallel scenarios of the port's tests: gloo worlds on the CPU,
one process a rank, started and awaited as ``tests/_torch_multirank.py``
starts its own, training through ``tests/_torch_tp.py``'s helpers.

- ``ep2`` (2 ranks): model 2 × fsdp 1 — a tiny Mixtral's forward
  (logits shard, router aux), its full-FT gradients, 3 QLoRA and 3 full
  fine-tuning steps, cached greedy decode, the bank shards of a carried
  JAX tree and of a sharded quantized init; the fine-tune entry on the
  Mixtral job at ``MESH_MODEL`` 2 with its serving switches.
- ``ep4`` (4 ranks): fsdp 2 × model 2 — the forward, 3 QLoRA and 3 full
  fine-tuning steps (rows split over the two batch ranks), a save of the
  trained full-FT state, the world-1 save restored, the sharded export of
  the QLoRA start, the 2-D bank shards; then context 2 × model 2.
- ``cp_moe`` (2 ranks): fsdp 1 × context 2 — ``moe_mlp`` and ``route``
  on an input whose shards overflow unlike the whole row, and the
  model's forward on tokens made to overflow so.

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
import _torch_ep as h
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


def _ranks(mesh) -> dict:
    from gke_ray_train_tpu_torch.parallel import batch_rank, model_rank
    from gke_ray_train_tpu_torch.parallel.mesh import context_rank
    return {"batch": batch_rank(mesh), "model": model_rank(mesh),
            "context": context_rank(mesh)}


def model(inputs, mesh, key="params", cfg_key="cfg", trainable=False):
    """The tiny Mixtral of ``inputs[key]`` (a carried JAX tree's state
    dict) at ``inputs[cfg_key]``, sharded over ``mesh`` (one process's
    without one)."""
    from gke_ray_train_tpu_torch.models import init_params
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    cfg = ModelConfig.from_dict(inputs[cfg_key])
    params = init_params(cfg, seed=0, device="cpu")
    params.load_state_dict(inputs[key], strict=True)
    for p in params.parameters():
        p.requires_grad_(trainable)
    return (params if mesh is None else shard_model(params, mesh)), cfg


def forward(params, cfg, mesh, tokens, weights):
    """Logits (this rank's vocab shard of its tokens) and router aux."""
    import torch
    from gke_ray_train_tpu_torch.parallel.placement import context_slice
    from gke_ray_train_tpu_torch.parallel.sharding import release_root
    b = context_slice({"inputs": tokens, "weights": weights}, mesh)
    with torch.no_grad():
        logits, aux = params(torch.as_tensor(b["inputs"]), cfg,
                             with_aux=True,
                             token_weights=torch.as_tensor(b["weights"]),
                             mesh=mesh)
    release_root(params)
    return {"logits": logits, "aux": float(aux["router_aux"])}


def bank_shards(params) -> dict:
    """{name: (local tensor, placements)} of every block's expert bank
    (a ``QTensor``'s codes as int8 and scales)."""
    from gke_ray_train_tpu_torch.ops.quant import is_qtensor
    from gke_ray_train_tpu_torch.parallel.sharding import (
        as_dtype, is_sharded, local)
    out = {}
    for i, blk in enumerate(params.blocks):
        for key in ("w_gate", "w_up", "w_down"):
            w = getattr(blk, key)
            parts = ({"codes": as_dtype(w.codes, w.code_dtype),
                      "scales": w.scales} if is_qtensor(w) else {"": w})
            for sub, t in parts.items():
                name = f"blocks.{i}.{key}" + (f".{sub}" if sub else "")
                out[name] = (local(t).detach().clone(), tuple(
                    str(p) for p in t.placements) if is_sharded(t) else ())
    return out


def gradients(inputs, mesh, cfg_key="cfg") -> dict:
    """One forward and backward of the full-FT model at
    ``inputs[cfg_key]`` on the gradient batch (NLL plus
    ``router_aux_coef`` × aux × the weight sum, as a microbatch of the
    train step): every router and bank gradient whole, FSDP2 having
    summed it over the batch ranks."""
    import torch
    from gke_ray_train_tpu_torch.train.step import model_nll
    params, cfg = model(inputs, mesh, cfg_key=cfg_key, trainable=True)
    g = inputs["grad"]
    tokens, targets = torch.as_tensor(g["inputs"]), torch.as_tensor(
        g["targets"])
    w = torch.as_tensor(g["weights"])
    (nll, wsum), aux = params(
        tokens, cfg, with_aux=True, token_weights=w, mesh=mesh,
        loss_fn=lambda out, p: model_nll(out, p, cfg, targets, w))
    (nll + cfg.router_aux_coef * aux["router_aux"] * wsum).backward()
    return {n: mr._whole(p.grad) for n, p in params.named_parameters()
            if n.split(".")[-1] in ("router", "w_gate", "w_up", "w_down")}


def decode(inputs, mesh) -> dict:
    import torch
    from gke_ray_train_tpu_torch.models.kvcache import (
        greedy_generate_cached)
    params, cfg = model(inputs, mesh)
    d = inputs["decode"]
    tokens = greedy_generate_cached(
        params, torch.as_tensor(d["prompt"]), torch.as_tensor(d["plen"]),
        cfg, max_new_tokens=d["max_new"], device="cpu")
    return {"tokens": tokens}


def qinit(inputs, mesh) -> dict:
    """The sharded quantized init's bank shards (local tensors)."""
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig.from_dict(inputs["cfg"])
    params = init_quantized_params(cfg, seed=0, group=inputs["group"],
                                   device="cpu", mesh=mesh)
    return bank_shards(params)


def lean(inputs, mesh) -> dict:
    """``moe_mlp`` and ``route`` on this context rank's shard of the lean
    input, and the model's forward on the lean tokens."""
    import torch
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    from gke_ray_train_tpu_torch.ops import moe
    from gke_ray_train_tpu_torch.parallel.mesh import (
        context_group, context_rank, context_size)
    L = inputs["lean"]
    cfg = ModelConfig.from_dict(inputs["cfg"])
    n, c = context_size(mesh), context_rank(mesh)
    x = torch.as_tensor(L["x"]).chunk(n, dim=1)[c].contiguous()
    banks = [torch.as_tensor(L[k]) for k in ("w_gate", "w_up", "w_down")]
    router = torch.as_tensor(L["router"])
    y, aux = moe.moe_mlp(x, router, *banks, cfg, torch.float32, mesh=mesh)
    r = moe.route(x, router, cfg, context=context_group(mesh))
    params, mcfg = model(inputs, mesh, key="lean_params", cfg_key="ring_cfg")
    fwd = forward(params, mcfg, mesh, L["tokens"], L["weights"])
    return {"ranks": _ranks(mesh), "y": y, "aux": float(aux),
            "keep": r.keep, "pos": r.pos, "forward": fwd}


def train_both(inputs, mesh, rows=None, keep=None) -> dict:
    """3 QLoRA and 3 full fine-tuning steps (``_torch_tp.train``)."""
    from tests import _torch_tp as tp
    res = {}
    for name in ("qlora", "full"):
        case = inputs[name]
        if rows is not None:
            case = dict(case, accum=case["accum"] // rows[0])
        r = tp.train(case, mesh, rows)
        st = r.pop("state")
        if keep is not None:
            keep(name, st)
        del st
        res[name] = r
    return res


# the entry's model at model 2: a tiny Mixtral wide enough that the NF4
# groups of ``wo`` split over two model ranks, ByteTokenizer's vocab
ENTRY_MOE = dict(vocab_size=260, d_model=128, d_ff=128, n_heads=4,
                 n_kv_heads=2, n_layers=2, n_experts=4, expert_top_k=2,
                 capacity_factor=1.25, max_seq_len=384, name="mixtral-tiny")


def entry_model_cfg(**kw):
    """``ENTRY_MOE`` as the entry's ``preset_for_model_id`` would give it
    (dtype, param_dtype, attn_impl, remat_policy from the config)."""
    from gke_ray_train_tpu_torch.models import config as mc
    return mc.tiny(**{**ENTRY_MOE, **kw})


def run_entry(config: dict) -> dict:
    """The fine-tune entry's worker on the Mixtral job of ``config``
    with the preset cut to ``ENTRY_MOE``: its metrics."""
    from gke_ray_train_tpu_torch import fine_tune
    orig = fine_tune.preset_for_model_id
    fine_tune.preset_for_model_id = lambda model_id, **kw: \
        entry_model_cfg(**kw)
    try:
        metrics = fine_tune.train_loop_per_worker(config, device="cpu")
    finally:
        fine_tune.preset_for_model_id = orig
    return {"loss": metrics.get("loss"), "step": metrics.get("step")}


def scenario_ep2(out: str) -> dict:
    import torch
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    mesh = _mesh(fsdp=1, model=2)
    params, cfg = model(inputs, mesh)
    res = {"ranks": _ranks(mesh), "banks": bank_shards(params),
           "forward": forward(params, cfg, mesh, inputs["fwd"]["inputs"],
                              inputs["fwd"]["weights"])}
    del params
    res["grads"] = gradients(inputs, mesh)
    res["grads_dots"] = gradients(inputs, mesh, cfg_key="dots_cfg")
    res["train"] = train_both(inputs, mesh)
    res["decode"] = decode(inputs, mesh)
    res["qinit"] = qinit(inputs, mesh)
    res["entry"] = run_entry(inputs["entry"])
    return res


def scenario_cp_moe(out: str) -> dict:
    import torch
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    return lean(inputs, _mesh(fsdp=1, context=2))


def scenario_ep4(out: str) -> dict:
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.ckpt.convert import (
        save_export, write_sidecar)
    from tests import _torch_tp as tp
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    rank = dist.get_rank()
    mesh = _mesh(fsdp=2, model=2)
    params, cfg = model(inputs, mesh)
    res = {"ranks": _ranks(mesh), "banks": bank_shards(params),
           "forward": forward(params, cfg, mesh, inputs["fwd"]["inputs"],
                              inputs["fwd"]["weights"])}
    del params
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)

    def keep(name, st):
        if name != "full":
            return
        mgr = CheckpointManager(os.path.join(out, "ckpt_full_w4"),
                                score_attribute=None)
        mgr.save(st.step, st, force=True)
        mgr.close()
        res["full_saved"] = mr.full_state(st)
    res["train"] = train_both(inputs, mesh, input_shard_layout(mesh), keep)
    # the world-1 save, restored into this mesh's placements
    template = tp.build_state(inputs["full"], mesh)[0]
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    res["resharded"] = tuple(mgr.last_restore_resharded)
    res["full_restored"] = mr.full_state(template)
    mgr.close()
    del template
    # the sharded export of the QLoRA start
    st, _, qcfg, lcfg = tp.build_state(inputs["qlora"], mesh)
    save_export(st.params, qcfg, os.path.join(out, "export_w4"), 0,
                lora=st.lora, lora_scale=lcfg.scale)
    if rank == 0:
        write_sidecar(qcfg, os.path.join(out, "export_w4"))
    del st
    cm = _mesh(fsdp=1, model=2, context=2)
    params, cfg = model(inputs, cm, key="lean_params", cfg_key="ring_cfg")
    res["cm"] = {"ranks": _ranks(cm), "forward": forward(
        params, cfg, cm, inputs["lean"]["tokens"], inputs["lean"]["weights"])}
    return res


SCENARIOS = {"ep2": scenario_ep2, "ep4": scenario_ep4,
             "cp_moe": scenario_cp_moe}


# ---------------------------------------------------------------------------
# the lean inputs (numpy; the parent builds them, JAX and the port read
# the same arrays)
# ---------------------------------------------------------------------------

def lean_moe_inputs(seed: int, B: int, S: int, D: int, F: int, E: int,
                    lean: float = 12.0) -> dict:
    """``moe_mlp``'s inputs where the first half of every row leans to
    expert 0 and the second half to expert 1, then 0: a half's shard
    overflows its first choice on its own, while the whole row keeps
    every first choice and drops second ones to expert 0."""
    import numpy as np
    r = np.random.default_rng(seed)
    f = np.float32
    router = (r.standard_normal((D, E)) * 0.5).astype(f)
    x = r.standard_normal((B, S, D)).astype(f)
    u = [router[:, e] / np.dot(router[:, e], router[:, e]) for e in (0, 1)]
    x[:, :S // 2] += (lean * u[0]).astype(f)
    x[:, S // 2:] += (lean * u[1] + 0.5 * lean * u[0]).astype(f)
    return dict(x=x, router=router,
                w_gate=(r.standard_normal((E, D, F)) * 0.1).astype(f),
                w_up=(r.standard_normal((E, D, F)) * 0.1).astype(f),
                w_down=(r.standard_normal((E, F, D)) * 0.1).astype(f))


def lean_tree(np_params: dict, lean: float = 4.0) -> dict:
    """A copy of a JAX MoE tree whose embedding rows lean along the
    first layer's router columns: ids below V / 2 to expert 0, the rest
    to expert 1."""
    import copy
    import numpy as np
    tree = copy.deepcopy(np_params)
    r0 = np.asarray(tree["blocks"][0]["router"])[0]           # [D, E]
    emb = np.array(tree["embed"])
    V = emb.shape[0]
    for rows, e in ((slice(0, V // 2), 0), (slice(V // 2, V), 1)):
        col = r0[:, e]
        emb[rows] += (lean * col / np.linalg.norm(col)).astype(emb.dtype)
    tree["embed"] = emb
    return tree


def lean_tokens(seed: int, B: int, S: int, V: int):
    """Rows whose first half are ids below V / 2 and second half the
    rest (``lean_tree``'s two leans), and their weights."""
    import numpy as np
    r = np.random.default_rng(seed)
    t = np.concatenate([r.integers(0, V // 2, (B, S // 2)),
                        r.integers(V // 2, V, (B, S - S // 2))], axis=1)
    return t.astype(np.int32), np.ones((B, S), np.float32)
