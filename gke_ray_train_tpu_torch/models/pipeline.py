"""Pipeline parallelism over the ``pipe`` mesh axis (counterpart of
``gke_ray_train_tpu/models/pipeline.py``).

JAX runs the pipeline as one traced scan: the stacked blocks ``[R, ...]``
viewed as ``[R/(P·v), v, P, ...]`` over ``pipe``, a stage buffer rolled
one hop a tick for ``T = M + v·P - 1`` ticks, every slot computing
whether it holds a microbatch or not, and autodiff mirroring the scan.
The port runs stage processes instead:

- A rank on pipe coordinate ``p`` holds only its own layers: the blocks
  of its groups ``{j·P + p}`` (``j < v``, ``v = cfg.pipe_virtual``), each
  ``R/(P·v)`` repeats of the block pattern (:func:`stage_layers`), under
  FSDP2 on its stage's fsdp submesh (``parallel/sharding.py``). Group
  ``g`` is hop ``g`` of a microbatch's trip, so hop order is layer order
  and ``v > 1`` is JAX's circular schedule.
- The forward (:func:`run_forward`) takes the same ``T`` ticks
  (:class:`Schedule`). At tick ``t`` a rank runs each of its slots (group
  ``j``, microbatch ``m = t - (j·P + p)`` in ``[0, M)``): the input is the
  embedded microbatch at hop 0, else what the previous hop sent, and the
  output goes to the next hop (or, at the last hop, to the final norm and
  head). Each boundary between ticks is one ``batch_isend_irecv`` over
  the pipe group, a rank's sends to ``p + 1`` paired with its receives
  from ``p - 1``, so no two ranks wait on each other
  (``ops/ring_attention.py::send_recv``: under gloo, several ranks of one
  card, CUDA tensors are staged through page-locked host memory; NCCL
  sends in place).
- The backward (:func:`run_backward`) takes as many ticks, mirrored: the
  last hop starts from its microbatch's loss, every other slot from the
  output gradient the next hop sent, runs ``torch.autograd.backward``
  over the slot and sends the input gradient back. Microbatch 0 goes
  back first, so a layer's gradients add up in one process's order.

Under tensor or expert parallelism inside a stage (``model`` above 1) a
block's output is whole on every model rank, so each model rank sends
it to its counterpart on the next stage (the pipe group joins the ranks
of one ``model`` coordinate), and the input gradient it sends back is
whole too: the gradient of the column-parallel projections' input is
summed over ``model`` (``copy_to_model``) before the norm and the
residual add it up. The model
group's all-reduces run inside a slot and the pipe exchange between
ticks, so every rank of a stage makes them in one order.

A decode step (``models/kvcache.py``) runs the same hops without a
schedule (:func:`run_hops`): the first stage embeds, each hop's rank
runs its layers and sends ``[B, T, D]`` on, the last applies the head.

Unlike JAX the port computes nothing in the warm-up and drain ticks: a
rank idles there (ROADMAP "Known divergences"); the tick count is JAX's,
and a rank makes ``M·v`` stage passes a step. The MoE router aux of a
slot covers its microbatch only, so the model's aux is JAX's pipelined
one: the mean over microbatches of the sum over layers of per-microbatch
means, not one mean over the whole batch (held to the unpipelined aux
at JAX's own ``rtol=1e-2``). LoRA dropout raises on a pipelined mesh, as
JAX's does. ``ring`` and ``a2a`` at ``context`` 1 run the flash kernel
(:func:`resolve_impl`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gke_ray_train_tpu_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)


def stage_layers(cfg: ModelConfig, pipe: int, virtual: int,
                 rank: int) -> List[int]:
    """The global layer indices stage ``rank`` of ``pipe`` holds at
    ``virtual`` groups a stage, ascending: for each ``j < virtual`` the
    layers of repeats ``[g·Rg, (g + 1)·Rg)``, ``g = j·pipe + rank``,
    ``Rg = n_repeats / (pipe·virtual)``."""
    check_depth(cfg, pipe, virtual)
    n_pat = len(cfg.block_pattern)
    per = cfg.n_repeats // (pipe * virtual)
    out = []
    for j in range(virtual):
        g = j * pipe + rank
        out.extend(range(g * per * n_pat, (g + 1) * per * n_pat))
    return out


def check_depth(cfg: ModelConfig, pipe: int, virtual: int) -> None:
    """JAX's depth gate (``pipeline.py:333-337``)."""
    if virtual < 1:
        raise ValueError(f"pipe_virtual={virtual} must be >= 1")
    if cfg.n_repeats % (pipe * virtual):
        raise ValueError(
            f"n_repeats={cfg.n_repeats} must be divisible by pipe axis x "
            f"virtual stages ({pipe} x {virtual})")


def mesh_stage(cfg: ModelConfig, mesh) -> Optional[List[int]]:
    """This rank's layers on ``mesh`` (:func:`stage_layers`), None when
    the mesh has no ``pipe`` axis above 1."""
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_rank, pipe_size
    P = pipe_size(mesh)
    if P <= 1:
        return None
    return stage_layers(cfg, P, cfg.pipe_virtual, pipe_rank(mesh))


def resolve_impl(cfg: ModelConfig, mesh, S: int, device) -> str:
    """The attention a pipelined sequence of length S runs: ``ring`` and
    ``a2a`` at ``context`` 1 remap to ``flash`` (JAX
    ``resolve_seq_impl``), then ``models/transformer.py::
    resolve_seq_impl``. Raises JAX's "unknown attn impl"."""
    import dataclasses as dc
    from gke_ray_train_tpu_torch.models.transformer import resolve_seq_impl
    from gke_ray_train_tpu_torch.parallel.mesh import context_size
    C = context_size(mesh)
    impl = cfg.resolved_attn_impl(device)
    if impl not in ("xla", "flash", "ring", "a2a"):
        raise ValueError(f"unknown attn impl {impl!r}")
    if impl in ("ring", "a2a") and C == 1:
        cfg = dc.replace(cfg, attn_impl="flash")
    return resolve_seq_impl(cfg, S, device, C)


def check_microbatches(M: int, pipe: int, virtual: int, rows: int,
                       batch_par: int) -> None:
    """JAX's microbatch gates (``pipeline.py:350-365``) on this rank's
    ``rows`` of a batch sharded over ``batch_par`` batch ranks (JAX's
    global batch is ``rows·batch_par``)."""
    B = rows * batch_par
    if M < pipe:
        raise ValueError(
            f"pipeline microbatches ({M}) must be >= pipe stages ({pipe})")
    if M < virtual * pipe:
        from gke_ray_train_tpu_torch.logging_utils import warn_once
        depth = virtual * pipe
        warn_once(
            logger, ("shallow_microbatches", M, virtual, pipe),
            "pipeline has %d microbatches for depth %d (pipe=%d x "
            "virtual=%d): %d of %d ticks are idle warm-up or drain — "
            "raise PIPE_MICROBATCHES to amortize", M, depth, pipe,
            virtual, depth - 1, M + depth - 1)
    if B % M:
        raise ValueError(
            f"batch {B} not divisible by {M} pipeline microbatches")
    if rows % M:
        raise ValueError(
            f"pipeline microbatch size {B / M:g} (= batch {B} / {M}) must "
            f"stay divisible by the batch-parallel extent {batch_par}; "
            "lower pipe_microbatches or raise the batch")


def check_run(cfg: ModelConfig, mesh, microbatches: Optional[int],
              rows: int, dropout: bool = False) -> int:
    """The gates of one pipelined pass over this rank's ``rows``: LoRA
    dropout raises as JAX's does (``transformer.py:466-470``), then
    :func:`check_microbatches`. Returns the microbatch count (default
    one a hop, ``pipe_virtual × pipe``)."""
    from gke_ray_train_tpu_torch.parallel.mesh import (
        batch_group_size, pipe_size)
    if dropout:
        raise NotImplementedError(
            "LoRA dropout is not supported on a pipelined mesh; set "
            "LORA_DROPOUT=0 or pipe=1")
    P = pipe_size(mesh)
    M = microbatches or cfg.pipe_virtual * P
    check_microbatches(M, P, cfg.pipe_virtual, rows, batch_group_size(mesh))
    return M


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The GPipe ticks of stage ``rank`` of ``pipe`` at ``virtual`` groups
    a stage and ``microbatches`` microbatches: ``ticks = M + v·P - 1``;
    at tick ``t`` the slots ``(j, m)`` with ``m = t - (j·P + rank)`` in
    ``[0, M)``, ascending in ``j``."""
    pipe: int
    virtual: int
    microbatches: int
    rank: int

    @property
    def depth(self) -> int:
        """Hops a microbatch makes: ``v·P``."""
        return self.virtual * self.pipe

    @property
    def ticks(self) -> int:
        return self.microbatches + self.depth - 1

    def hop(self, j: int) -> int:
        return j * self.pipe + self.rank

    def slots(self, t: int) -> List[Tuple[int, int]]:
        out = []
        for j in range(self.virtual):
            m = t - self.hop(j)
            if 0 <= m < self.microbatches:
                out.append((j, m))
        return out

    @property
    def passes(self) -> int:
        """Stage passes this rank makes: one a (group, microbatch)."""
        return sum(len(self.slots(t)) for t in range(self.ticks))


def schedule_of(cfg: ModelConfig, mesh, microbatches: int) -> Schedule:
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_rank, pipe_size
    return Schedule(pipe_size(mesh), cfg.pipe_virtual, microbatches,
                    pipe_rank(mesh))


def _warm(mesh, group) -> None:
    """One all-reduce over the pipe group before its first point-to-point
    call, which NCCL wants every rank of a new communicator to join."""
    if getattr(mesh, "_pipe_warm", False):
        return
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel.mesh import collective_device
    dist.all_reduce(torch.zeros(1, device=collective_device()), group=group)
    mesh._pipe_warm = True


def _exchange(sends: List[torch.Tensor], n_recv: int, like: torch.Tensor,
              group, *, forward: bool) -> List[torch.Tensor]:
    """One tick boundary: ``sends`` to the next hop and ``n_recv``
    tensors shaped as ``like`` from the previous one (the reverse in the
    backward)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops.ring_attention import send_recv
    P = dist.get_world_size(group)
    p = dist.get_rank(group)
    nxt, prv = (p + 1) % P, (p - 1) % P
    dst, src = (nxt, prv) if forward else (prv, nxt)
    recv_like = [torch.empty(like.shape, dtype=like.dtype,
                             device=like.device) for _ in range(n_recv)]
    if not sends and not recv_like:
        return []
    return send_recv(sends, dst, recv_like, src, group)


@dataclasses.dataclass
class Run:
    """One pass of the forward ticks: each slot's received input (None at
    hop 0), output and router aux; the last hop's outputs by microbatch,
    and what a ``head`` made of them."""
    schedule: Schedule
    like: torch.Tensor          # an empty [Bm, S, D] of the activations
    slots: Dict[Tuple[int, int], tuple]
    outputs: Dict[int, torch.Tensor]
    heads: Dict[int, object]


def run_forward(blocks, cfg: ModelConfig, mesh, *, schedule: Schedule,
                micro: List[dict], inputs: Optional[List[torch.Tensor]],
                shape: tuple, dtype: torch.dtype, device: torch.device,
                impl: str, rope, lora=None, lora_scale: float = 1.0,
                fused_ops: bool = False,
                head: Optional[Callable] = None) -> Run:
    """The forward ticks on this stage: ``blocks`` its blocks (ascending
    global layer, ``v`` equal groups), ``micro[m]`` microbatch ``m``'s
    ``positions`` / ``segment_ids`` / ``masks`` / ``weights`` (the MoE
    aux's), ``inputs[m]`` its embedded ``[Bm, S, D]`` (the first stage
    only), ``shape`` that ``[Bm, S, D]``; ``lora`` this stage's adapters,
    one dict a block. Under autograd a received input requires a gradient
    and each slot is kept for :func:`run_backward`. ``head(m, y)`` runs
    on the last hop's output of microbatch ``m`` as it comes (the loss);
    its result is kept in ``Run.heads``."""
    from gke_ray_train_tpu_torch.models.transformer import run_block_stack
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_group
    group = pipe_group(mesh)
    _warm(mesh, group)
    grad = torch.is_grad_enabled()
    sch = schedule
    per = len(blocks) // sch.virtual
    like = torch.empty(shape, dtype=dtype, device=device)
    run = Run(sch, like, {}, {}, {})
    outgoing: List[torch.Tensor] = []
    for t in range(sch.ticks):
        slots = sch.slots(t)
        incoming = _exchange(
            outgoing, sum(1 for j, _ in slots if sch.hop(j) > 0), like,
            group, forward=True) if t else []
        outgoing = []
        for j, m in slots:
            h = sch.hop(j)
            if h == 0:
                x_in, x = None, inputs[m]
            else:
                x_in = x = incoming.pop(0).requires_grad_(grad)
            mb = micro[m]
            y, aux = run_block_stack(
                x, [blocks[i] for i in range(j * per, (j + 1) * per)], cfg,
                impl, dtype, rope, mb["positions"], mb["masks"],
                mb["segment_ids"],
                lora=(lora[j * per:(j + 1) * per] if lora is not None
                      else None),
                lora_scale=lora_scale, fused_ops=fused_ops,
                token_weights=mb["weights"] if cfg.n_experts else None,
                mesh=mesh)
            if grad:
                run.slots[(j, m)] = (x_in, y, aux)
            elif aux is not None:
                run.slots[(j, m)] = (None, None, aux)
            if h == sch.depth - 1:
                run.outputs[m] = y
                if head is not None:
                    run.heads[m] = head(m, y)
            else:
                outgoing.append(y)
    return run


def run_backward(run: Run, mesh, *, loss: Callable,
                 aux_scale=None,
                 before_last: Optional[Callable] = None) -> None:
    """The backward ticks of :func:`run_forward`'s ``run``, mirrored: at
    backward tick ``u`` a rank runs its slots ``(j, m)`` with ``m = u -
    (depth - 1 - hop)``, so microbatch 0 goes back first and every
    layer's gradients add up over the microbatches in the order one
    process adds them. The last hop's slots start from ``loss(m)`` (a
    scalar whose graph reaches that slot's output), the others from the
    output gradient the next hop sent; a slot's router aux enters times
    ``aux_scale``. The input gradient goes back to the previous hop.
    ``before_last()`` runs just before this rank's last ``backward``
    call of the step (where the train step lets FSDP2 reduce)."""
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_group
    group = pipe_group(mesh)
    sch = run.schedule
    last_hop = sch.depth - 1

    def slots(u):
        return [(j, u - (last_hop - sch.hop(j))) for j in range(sch.virtual)
                if 0 <= u - (last_hop - sch.hop(j)) < sch.microbatches]
    order = [s for u in range(sch.ticks) for s in slots(u)]
    last = order[-1] if order else None
    outgoing: List[torch.Tensor] = []
    for u in range(sch.ticks):
        here = slots(u)
        incoming = _exchange(
            outgoing, sum(1 for j, _ in here if sch.hop(j) < last_hop),
            run.like, group, forward=False) if u else []
        outgoing = []
        for j, m in here:
            h = sch.hop(j)
            x_in, y, aux = run.slots.pop((j, m))
            if h == last_hop:
                tensors, grads = [loss(m)], [None]
            else:
                tensors, grads = [y], [incoming.pop(0)]
            if aux is not None and aux_scale is not None:
                tensors.append(aux * aux_scale)
                grads.append(None)
            if (j, m) == last and before_last is not None:
                before_last()
            torch.autograd.backward(tensors, grads)
            if h > 0:
                outgoing.append(x_in.grad)


def stage_mesh(params):
    """The pipelined mesh ``params`` (a ``Transformer``) holds one stage
    of, as ``parallel/sharding.py::shard_model`` recorded it; None for a
    model that holds every layer."""
    return getattr(params.blocks, "mesh", None)


def token_source(mesh) -> int:
    """The global rank a decode's picked tokens are agreed from on a
    pipelined mesh: the last stage's first rank (coordinate 0 on every
    other axis), which holds the logits."""
    from gke_ray_train_tpu_torch.parallel.mesh import AXIS_PIPE, MESH_AXES
    ranks = mesh.mesh.movedim(MESH_AXES.index(AXIS_PIPE), 0)
    return int(ranks[-1].reshape(-1)[0])


def run_hops(cfg: ModelConfig, mesh, x: Optional[torch.Tensor],
             like: torch.Tensor, n_blocks: int,
             layer: Callable) -> Optional[torch.Tensor]:
    """One decode step's trip through the stages, without a schedule
    (JAX's decode has none): ``v·P`` hops in layer order, hop ``h`` on
    pipe rank ``h % P`` running its group ``h // P`` of the stage's
    ``n_blocks`` blocks (``layer(x, i)`` for each stage-local index
    ``i`` in order), its output handed to the next hop's rank in one
    ``send_recv`` over the pipe group (each ``model`` rank to its
    counterpart: under tensor parallelism a block's output is whole on
    every model rank). ``x`` is the embedded input on the first stage
    (None elsewhere) and ``like`` an empty ``[B, T, D]`` of the
    activations. Returns the last hop's output on the last stage, None
    on the others."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops.ring_attention import send_recv
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_group
    group = pipe_group(mesh)
    _warm(mesh, group)
    P, p = dist.get_world_size(group), dist.get_rank(group)
    v = cfg.pipe_virtual
    per = n_blocks // v
    for h in range(v * P):
        src, dst = (h - 1) % P, h % P
        if h and p == src:
            send_recv([x], dst, [], dst, group)
            x = None
        elif h and p == dst:
            x = send_recv([], src, [like], src, group)[0]
        if p == dst:
            j = h // P
            for i in range(j * per, (j + 1) * per):
                x = layer(x, i)
    return x if p == P - 1 else None


def gather_outputs(run: Run, mesh, shape: tuple, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The last stage's outputs, the microbatches in order (``[B, S,
    D]``), broadcast to every stage of the pipe group."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_group
    group = pipe_group(mesh)
    P = dist.get_world_size(group)
    if dist.get_rank(group) == P - 1:
        out = torch.cat([run.outputs[m] for m in range(len(run.outputs))])
    else:
        out = torch.empty(shape, dtype=dtype, device=device)
    dist.broadcast(out, src=dist.get_global_rank(group, P - 1), group=group)
    return out


def stage_aux(run: Run, device: torch.device) -> torch.Tensor:
    """This stage's slots' router aux summed over its layers and
    microbatches (fp32; 0 on a dense model)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for _, _, aux in run.slots.values():
        if aux is not None:
            total = total + aux
    return total
