"""Parameter sharding over the ``model`` and ``fsdp`` axes: DTensors for
tensor parallelism, then FSDP2 (the port's counterpart of
``gke_ray_train_tpu/models/transformer.py::param_specs`` and
``parallel/sharding.py``).

:func:`param_specs` is the JAX package's PartitionSpec table over the
port's per-layer parameter names (no stacked repeat dim, so no ``pipe``
entry). :func:`shard_model` turns it into placements, ``model`` first:
with ``model`` above 1 every parameter whose spec names ``model``
becomes a DTensor of the mesh's ``model`` submesh, sharded on that dim
(the output dim of ``wq`` ``wk`` ``wv`` ``w_gate`` ``w_up`` and the
q/k/v biases, the input dim of ``wo`` and ``w_down``, the vocab of
``embed`` and ``lm_head``); the rest (the norms) stays a plain tensor,
the same on every model rank. Then FSDP2 over the ``fsdp`` submesh
(``data`` × ``fsdp`` for HSDP) shards them all, both from one
``init_device_mesh``, so a model-sharded parameter ends 2-D (FSDP2
over TP): each ``Block`` is one ``fully_shard`` unit and the root holds the
embedding, final norm and head, every parameter sharded on the dim its
spec puts on ``fsdp``. A ``QTensor``'s codes and scales follow their
weight's ``model`` dim: the quantization groups run along the input dim,
so a column-parallel weight shards both on dim 1 and a row-parallel one
both on dim 0 (its scales ``[D / group, F]``, so ``D / model`` must
divide by the group; uint4 packs two codes of one input row a byte,
along the output dim, which a row-parallel cut leaves whole). An MoE
model's expert banks (``[E, d_in, d_out]``) shard on the expert dim over
``model`` (expert parallelism), their codes and scales with them, and
over ``fsdp`` on the bank's own ``fsdp`` dim; the router stays whole on
every model rank, as JAX's ``P("fsdp", None)`` has it. Two
departures, recorded in ROADMAP.md's known divergences: FSDP2 shards
every parameter it manages, so the norms (and the biases off ``model``)
that JAX replicates are sharded on dim 0; and where the ``fsdp`` dim
does not divide by the shard count FSDP2 takes dim 0 (it shards unevenly
only there). A QLoRA base's NF4 / int8 codes and scales are sharded too:
FSDP2 shards parameters, not buffers, so they become frozen parameters
(``requires_grad=False``) of their ``QTensor`` first, on the weight's
fsdp dim; the codes' bytes are held as ``CODE_CONTAINER``, a one-byte
float dtype, because FSDP2 (torch 2.11) makes each sharded parameter
able to take a gradient, which an integer tensor cannot
(``QTensor.code_tensor`` reads them back).

Over ``pipe`` each rank holds its stage's blocks only
(``models/pipeline.py::stage_layers``), each placed as above inside the
stage: DTensors of the stage's ``model`` submesh first (its heads, ffn
columns or experts), then an FSDP2 unit on the stage's own fsdp (or
HSDP) submesh, both slices of the one mesh (at ``context`` above 1 of
:func:`_context_root`, which makes every stage's groups). The root
(embedding, final norm, head) is replicated over ``pipe``: each stage's
root is the same, vocab-sharded alike over its ``model`` ranks and
sharded alike over its fsdp ranks, and the train step sums its
gradients over the pipe group, which joins the ranks of one ``model``
coordinate (one shard).

Gradients are summed over the batch ranks, not averaged (the train step
divides by the global token weight), and a ``data`` or ``context`` axis
above 1 makes the units HSDP: replicated over ``data`` × ``context``,
sharded over ``fsdp`` (:func:`fsdp_mesh`).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from gke_ray_train_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT, AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_PIPE)

if TYPE_CHECKING:   # models/ imports this module (qinit)
    from gke_ray_train_tpu_torch.models.config import ModelConfig

Spec = Tuple[Optional[str], ...]

# the one-byte float dtype sharded codes are held in (bit for bit)
CODE_CONTAINER = torch.float8_e4m3fn


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """The logical sharding of every parameter, by its leaf name: a
    block's tensors by their attribute name, the root's as ``embed`` /
    ``final_norm`` / ``lm_head`` (JAX ``param_specs`` without the
    leading ``pipe`` dim)."""
    s: Dict[str, Spec] = {
        "attn_norm": (None,),
        "wq": (AXIS_FSDP, AXIS_MODEL),
        "wk": (AXIS_FSDP, AXIS_MODEL),
        "wv": (AXIS_FSDP, AXIS_MODEL),
        "wo": (AXIS_MODEL, AXIS_FSDP),
        "mlp_norm": (None,),
    }
    if cfg.attn_qkv_bias:
        s.update(bq=(AXIS_MODEL,), bk=(AXIS_MODEL,), bv=(AXIS_MODEL,))
    if cfg.n_experts:
        s.update(router=(AXIS_FSDP, None),
                 w_gate=(AXIS_MODEL, AXIS_FSDP, None),
                 w_up=(AXIS_MODEL, AXIS_FSDP, None),
                 w_down=(AXIS_MODEL, None, AXIS_FSDP))
    else:
        s.update(w_gate=(AXIS_FSDP, AXIS_MODEL),
                 w_up=(AXIS_FSDP, AXIS_MODEL),
                 w_down=(AXIS_MODEL, AXIS_FSDP))
    if cfg.post_block_norm:
        s.update(attn_post_norm=(None,), mlp_post_norm=(None,))
    s.update(embed=(AXIS_MODEL, AXIS_FSDP), final_norm=(None,))
    if not cfg.tie_embeddings:
        s["lm_head"] = (AXIS_FSDP, AXIS_MODEL)
    return s


def _leaf_key(name: str) -> str:
    """``wq`` for ``wq`` / ``wq.codes`` / ``wq.scales`` (a QTensor's
    tensors follow their weight's spec)."""
    parts = name.split(".")
    if parts[-1] in ("codes", "scales") and len(parts) > 1:
        return parts[-2]
    return parts[-1]


def shard_dim(cfg: ModelConfig, name: str, shape: torch.Size,
              n_shards: int) -> int:
    """The dim FSDP2 shards parameter ``name`` on: its spec's ``fsdp``
    dim when the spec has one and it divides by ``n_shards``, else 0."""
    spec = param_specs(cfg).get(_leaf_key(name))
    if spec is None or AXIS_FSDP not in spec:
        return 0
    d = spec.index(AXIS_FSDP)
    if d >= len(shape) or shape[d] % n_shards:
        return 0
    return d


def fsdp_mesh(mesh):
    """The mesh FSDP2 runs on: ``fsdp`` alone, or HSDP (a replicate dim,
    then ``fsdp``) where ``data`` × ``context`` exceeds 1: (``data``,
    ``fsdp``) without context, else the ``data`` × ``context`` ranks
    flattened into one replicate dim. Parameters are replicated over
    ``context`` (each context rank holds the same weights, and its
    tokens give a part of every gradient), so FSDP2 sums their gradients
    over it as over ``data``."""
    if mesh[AXIS_CONTEXT].size() > 1:
        root = _context_root(mesh)
        return root if root.ndim == 2 else root["replicate", AXIS_FSDP]
    if mesh[AXIS_DATA].size() > 1:
        return mesh[AXIS_DATA, AXIS_FSDP]
    return mesh[AXIS_FSDP]


def model_mesh(mesh):
    """The ``model`` submesh parameters sharded over ``model`` are
    DTensors of: ``mesh``'s, or where ``context`` exceeds 1 the ``model``
    dim of the mesh :func:`fsdp_mesh` slices (FSDP2 over TP takes both
    meshes from one root)."""
    if mesh[AXIS_CONTEXT].size() > 1 and mesh[AXIS_MODEL].size() > 1:
        return _context_root(mesh)[AXIS_MODEL]
    return mesh[AXIS_MODEL]


def _context_root(mesh):
    """The (``replicate``, ``fsdp``) mesh whose replicate dim is
    ``data`` × ``context`` (data-major), with a ``model`` dim after them
    where ``model`` exceeds 1, made once per mesh: a process group for
    each replicate set (every rank makes every group, in one order),
    this rank's with the mesh's own ``fsdp`` (and ``model``) groups as a
    ``DeviceMesh`` (``DeviceMesh.from_group``: torch 2.11's
    ``DeviceMesh`` refuses to slice data × context). It is kept on the
    mesh object, so it goes with the mesh."""
    root = getattr(mesh, "_context_hsdp", None)
    if root is None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from gke_ray_train_tpu_torch.parallel.mesh import MESH_AXES
        order = [MESH_AXES.index(a) for a in (
            AXIS_PIPE, AXIS_DATA, AXIS_CONTEXT, AXIS_FSDP, AXIS_MODEL)]
        ranks = mesh.mesh.permute(*order)    # [pipe, data, ctx, fsdp, model]
        me = dist.get_rank()
        mine = None
        # every stage's groups, in one order on every rank
        for stage in ranks:
            grid = stage.reshape(-1, ranks.shape[3], ranks.shape[4])
            for row in grid.permute(1, 2, 0).reshape(
                    -1, grid.shape[0]).tolist():
                group = dist.new_group(row)
                if me in row:
                    mine = group
        # [data*ctx, fsdp, model] of this rank's stage
        grid = ranks[mesh[AXIS_PIPE].get_local_rank()].reshape(
            -1, ranks.shape[3], ranks.shape[4])
        groups = [mine, mesh[AXIS_FSDP].get_group()]
        names = ("replicate", AXIS_FSDP)
        if grid.shape[2] > 1:
            groups.append(mesh[AXIS_MODEL].get_group())
            names += (AXIS_MODEL,)
        else:
            grid = grid[..., 0]
        root = DeviceMesh.from_group(groups, mesh.device_type,
                                     mesh=grid.contiguous(),
                                     mesh_dim_names=names)
        mesh._context_hsdp = root
    return root


def _quant_tensors_as_params(module: nn.Module) -> None:
    """Make each ``QTensor``'s codes and scales frozen parameters in
    place of buffers (FSDP2 shards parameters only), the codes' bytes
    held as :data:`CODE_CONTAINER`."""
    from gke_ray_train_tpu_torch.ops.quant import is_qtensor
    for m in module.modules():
        if not is_qtensor(m):
            continue
        for key in ("codes", "scales"):
            t = m._buffers.pop(key, None)
            if t is not None:
                if key == "codes":
                    t = t.view(CODE_CONTAINER)
                m.register_parameter(key, nn.Parameter(
                    t, requires_grad=False))


def as_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t``'s bytes as ``dtype`` of the same size, a view (a DTensor's
    local part viewed, placed as ``t`` is)."""
    if t.dtype == dtype:
        return t
    if not is_sharded(t):
        return t.view(dtype)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local().view(dtype), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def _sum_gradients(module: nn.Module) -> None:
    """FSDP2 averages gradients over the ranks by default; make it sum
    (a divide factor of 1, reduced with a plain sum: gloo has no
    pre-multiplied sum)."""
    setter = getattr(module, "set_gradient_divide_factor", None) or \
        getattr(module, "set_reduce_scatter_divide_factor")
    setter(1.0)
    force_sum = getattr(module, "set_force_sum_reduction_for_comms", None)
    if force_sum is not None:
        force_sum(True)


def _model_dim(cfg: ModelConfig, name: str) -> Optional[int]:
    """The dim parameter ``name`` is sharded on over ``model``: its
    spec's ``model`` dim (a ``QTensor``'s codes and scales take their
    weight's), None where the spec has none."""
    spec = param_specs(cfg).get(_leaf_key(name))
    if spec is None or AXIS_MODEL not in spec:
        return None
    return spec.index(AXIS_MODEL)


def _place_on_model(module: nn.Module, cfg: ModelConfig, mesh) -> None:
    """Make each parameter of ``module`` whose spec names ``model`` a
    DTensor of the ``model`` submesh sharded on that dim, in place (each
    rank keeps its chunk of the full tensor it holds: no collective).
    Parameters that are already DTensors (a unit sharded before) are
    left as they are; a dim ``model`` does not divide raises."""
    from torch.distributed.tensor import DTensor, Shard
    tp_mesh = model_mesh(mesh)
    m, r = tp_mesh.size(), tp_mesh.get_local_rank()
    for mod_name, mod in module.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            if isinstance(p, DTensor):
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            d = _model_dim(cfg, full)
            if d is None:
                continue
            if p.shape[d] % m:
                raise ValueError(
                    f"param {full} dim {d} (size {p.shape[d]}) is not "
                    f"divisible by mesh axes ('{AXIS_MODEL}',) (size {m})")
            part = p.detach().chunk(m, dim=d)[r].contiguous()
            mod.register_parameter(pname, nn.Parameter(
                DTensor.from_local(part, tp_mesh, [Shard(d)],
                                   run_check=False, shape=p.shape,
                                   stride=p.stride()),
                requires_grad=p.requires_grad))


def shard_unit(module: nn.Module, cfg: ModelConfig, mesh, *,
               reshard_after_forward: bool = True) -> nn.Module:
    """Place one unit (a ``Block``, or the root after its blocks) on
    ``model`` (when above 1) and ``fully_shard`` it on ``param_specs``'
    fsdp dims."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    fm = fsdp_mesh(mesh)
    n = mesh[AXIS_FSDP].size()
    _quant_tensors_as_params(module)
    if mesh[AXIS_MODEL].size() > 1:
        check_model_on_mesh(cfg, mesh[AXIS_MODEL].size())
        _place_on_model(module, cfg, mesh)
    dims = {}
    for name, p in module.named_parameters():
        dims[id(p)] = shard_dim(cfg, name, p.shape, n)
    fully_shard(module, mesh=fm,
                reshard_after_forward=reshard_after_forward,
                shard_placement_fn=lambda p: Shard(dims.get(id(p), 0)))
    _sum_gradients(module)
    return module


def check_model_on_mesh(cfg: ModelConfig, model: int) -> None:
    """Raise where ``cfg`` cannot run at ``model`` ways of tensor (and,
    on an MoE model, expert) parallelism: heads, experts or a sharded
    dim that ``model`` does not divide (``plan.py::model_findings``)."""
    if model <= 1:
        return
    from gke_ray_train_tpu_torch.plan import model_findings
    found = model_findings(cfg, model=model)
    if found:
        from gke_ray_train_tpu_torch.plan import PlanError
        raise PlanError("; ".join(found))


def place_local_experts(qt, mesh, n_experts: int) -> None:
    """Make a ``QTensor`` that holds only this rank's experts of a bank
    (``[n_experts / model, ...]``, made so by a sharded init) the frozen
    DTensor parameters ``_place_on_model`` would have cut from the whole
    bank: its codes (as :data:`CODE_CONTAINER`) and scales sharded on
    dim 0 of the ``model`` submesh, of ``n_experts`` experts in all."""
    from torch.distributed.tensor import DTensor, Shard
    tp_mesh = model_mesh(mesh)
    for key in ("codes", "scales"):
        t = qt._buffers.pop(key)
        if key == "codes":
            t = t.view(CODE_CONTAINER)
        t = t.contiguous()
        # a contiguous bank's strides do not depend on its leading dim
        qt.register_parameter(key, nn.Parameter(
            DTensor.from_local(t, tp_mesh, [Shard(0)], run_check=False,
                               shape=(n_experts,) + tuple(t.shape[1:]),
                               stride=t.stride()),
            requires_grad=False))


def shard_model(params: nn.Module, mesh) -> nn.Module:
    """Shard a ``Transformer`` over ``mesh``'s model and fsdp axes in
    place (module doc; on a pipelined mesh a model holding every layer
    first drops the other stages' blocks): each
    block is a unit (gathered before its forward and again in the
    backward, freed after each), the root holds the rest. Blocks that are
    already units (:func:`shard_unit` during a sharded init) are left
    as they are. Returns ``params``."""
    from torch.distributed.fsdp import FSDPModule
    from gke_ray_train_tpu_torch.models.pipeline import mesh_stage
    from gke_ray_train_tpu_torch.models.transformer import (
        layer_ids, to_stage)
    cfg = params.cfg
    stage = mesh_stage(cfg, mesh)
    if stage is not None and list(layer_ids(params)) != stage:
        # a pipeline stage keeps its own layers only
        to_stage(params, stage)
    if stage is not None:
        # where the decode finds its stages (models/kvcache.py)
        params.blocks.mesh = mesh
    for blk in params.blocks:
        if not isinstance(blk, FSDPModule):
            shard_unit(blk, cfg, mesh)
    # the root's embedding and head are needed again first thing in the
    # backward: kept gathered between forward and backward
    shard_unit(params, cfg, mesh, reshard_after_forward=False)
    return params


def set_prefetch(params: nn.Module) -> None:
    """``OVERLAP=xla``, the port's counterpart of JAX's latency-hiding
    scheduler flags (registered by the train step's first call):
    FSDP2's explicit prefetch over a sharded ``Transformer``'s units in
    layer order (a pipeline stage's blocks,
    ``StageBlocks``, in theirs). The root's forward gathers the first
    block, each block's forward the next one's and each block's backward
    the one before, so a unit's all-gather is in flight while the unit
    before it (after it, in the backward) computes. It moves when a
    gather is issued, never what is computed: the numbers are ``off``'s."""
    blocks = list(params.blocks)
    if blocks:
        params.set_modules_to_forward_prefetch(blocks[:1])
    for i, blk in enumerate(blocks):
        blk.set_modules_to_forward_prefetch(blocks[i + 1:i + 2])
        blk.set_modules_to_backward_prefetch(blocks[max(i - 1, 0):i])


def release_root(params: nn.Module) -> None:
    """Free a sharded root's gathered weights after a forward that has
    no backward to keep them for (an eval, a decode step): FSDP2 leaves
    the root gathered after its forward (``shard_model``). Nothing for
    an unsharded model."""
    from torch.distributed.fsdp import FSDPModule
    if isinstance(params, FSDPModule):
        params.reshard()


# ---------------------------------------------------------------------------
# local views of sharded tensors, and the reductions over their shards
# ---------------------------------------------------------------------------

def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t`` (``t`` itself when not a DTensor); a
    view that in-place updates write through."""
    return t.to_local() if is_sharded(t) else t


def sharded_dims(t) -> List[Tuple[int, object]]:
    """[(tensor dim, process group)] of the dims ``t`` is sharded on."""
    if not is_sharded(t):
        return []
    out = []
    for mdim, pl in enumerate(t.placements):
        if pl.is_shard():
            out.append((pl.dim, t.device_mesh.get_group(mdim)))
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """In place over ``group``; returns ``x``."""
    import torch.distributed as dist
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def global_sum(x: torch.Tensor, like, dims: Optional[Iterable[int]] = None,
               keepdim: bool = False) -> torch.Tensor:
    """The sum over ``dims`` (all when None) of the full tensor whose
    local part is ``x`` and whose placement ``like`` has: the local sum,
    all-reduced over each sharded dim that is summed over."""
    nd = x.dim()
    dims = tuple(range(nd)) if dims is None else tuple(d % nd for d in dims)
    s = torch.sum(x, dim=dims, keepdim=keepdim) if dims else x
    for d, group in sharded_dims(like):
        if d in dims:
            s = all_reduce_sum(s.contiguous(), group)
    return s


def global_mean(x: torch.Tensor, like, dims: Optional[Iterable[int]] = None,
                keepdim: bool = False) -> torch.Tensor:
    """:func:`global_sum` over the global element count of ``dims``."""
    shape = like.shape
    nd = len(shape)
    dims = tuple(range(nd)) if dims is None else tuple(d % nd for d in dims)
    if not any(d in dims for d, _ in sharded_dims(like)):
        return torch.mean(x, dim=dims, keepdim=keepdim) if dims else x
    count = math.prod(shape[d] for d in dims)
    return global_sum(x, like, dims, keepdim) / count


def like_placed(local_t: torch.Tensor, like, shape: Tuple[int, ...],
                dropped: Tuple[int, ...] = ()) -> torch.Tensor:
    """A DTensor of global ``shape`` whose local part is ``local_t``,
    placed as ``like`` is with the tensor dims in ``dropped`` removed
    (a reduction's output: sharded where ``like``'s sharded dim
    survives, else replicated); ``local_t`` itself when ``like`` is not
    sharded."""
    if not is_sharded(like):
        return local_t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pls = []
    for pl in like.placements:
        if pl.is_shard() and pl.dim not in dropped:
            pls.append(Shard(pl.dim - sum(1 for d in dropped if d < pl.dim)))
        else:
            pls.append(Replicate())
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local_t, like.device_mesh, pls,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))

