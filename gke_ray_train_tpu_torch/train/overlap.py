"""Manual communication / compute overlap, ``OVERLAP=manual`` (counterpart
of ``gke_ray_train_tpu/train/overlap.py``).

The off path leaves every fsdp collective where FSDP2 puts it: a block's
all-gather is issued in its pre-forward hook (again in its recomputation
under remat), its gradients' reduce-scatter in its post-backward hook.
This module places them by hand, as JAX's ``shard_map`` pipeline does:

- every fsdp-sharded parameter is gathered through a collective this
  module issues, one unit at a time (a ``Block``, or the root's
  embedding, final norm and head), flattened into one all-gather over
  the fsdp group as FSDP2 flattens a unit's;
- the layer loop double-buffers the gather: layer *k+1*'s all-gather is
  issued before layer *k*'s compute and waited on (a CUDA event) just
  before layer *k+1* uses it. JAX pins that order with an
  ``optimization_barrier``; here a communication stream carries the
  collectives and the compute stream waits on each gather's event;
- under remat the gather sits inside the layer's remat region, so a
  layer's gathered weights are freed after its forward and gathered
  again in its recomputation, where layer *k−1*'s gather is issued
  while layer *k*'s backward runs. JAX's ``jax.checkpoint`` around a
  body that carries the gathered weights keeps every layer's alive as
  scan residuals; the port does not (ROADMAP, known divergences);
- the root is gathered once a microbatch (JAX ``_gather_full``) and held
  until its backward, as FSDP2 holds the sharded root;
- the per-layer math is ``models/transformer.py::_layer``, the function
  ``run_block_stack`` reaches on the off path, run on :class:`Gathered`
  views through ``forward``'s ``layer_call``: the two paths cannot
  fork, and no FSDP2 hook runs, so nothing is gathered twice;
- the gradient reduction copies the off path's grouping, as JAX's copies
  GSPMD's: the gradients of a unit are summed over the microbatches of
  the step in full (FSDP2's unsynced accumulation), then on the last one
  reduce-scattered over ``fsdp`` (a sum, ``parallel/sharding.py::
  _sum_gradients``) and, for HSDP, all-reduced over the replicate group,
  in the parameter dtype. They land in the sharded parameters' ``.grad``
  as DTensors placed as FSDP2 places them, so the optimizer, the global
  norm, clipping, the checkpoint manager and the export run unchanged.
  At fsdp 2 and data 2 × fsdp 2 each element is a sum of two partial
  sums taken in one order, so fp32 losses equal the off path's bit for
  bit.

Under NCCL the collectives run in place on a dedicated stream; under
gloo (tests on the CPU, or several ranks of one card) they are
synchronous, and CUDA tensors stage through page-locked host memory
(``ops/ring_attention.py``'s helpers), where the gather and the
reduce-scatter run as all-reduces of the whole buffer
(:func:`_all_gather`). Scope, as JAX's: data / fsdp meshes, dense
blocks, full fine-tuning (:func:`check_manual_support`).

On a mesh of more than one slice (``num_slices`` above 1, the ``data``
axis split into slices: ``parallel/mesh.py``) the reduction is staged at
the slice boundary (``parallel/hierarchical.py``), leaf by leaf: fsdp,
then the ``data`` ranks inside a slice, then across slices. ``flat``
sends the full leaf across (``flat_reduce_shard``), ``hier`` the
intra-slice scattered shard (``hier_reduce_shard``): the same sums, bit
for bit where each stage's group has two members. As on one slice they
run once a step, on the step's sum. ``DCN_COMPRESS=bf16`` instead runs
the intra-slice half and the bf16 cross-slice hop on every microbatch
(``intra_reduce_shard``, ``compressed_cross_psum``), each microbatch's
quantization error carried into the next by the step (JAX carries it
through its grad-accumulation scan); the reduced shards are summed over
the microbatches. Only fsdp-sharded leaves compress: at fsdp 1 every
leaf is whole on each rank, as JAX's replicated leaves, and rides the
hier hop uncompressed (``hier_reduce_full``). FSDP2 shards the norms
JAX replicates, so here they take the sharded arms too. The one-slice
path is unchanged.

:data:`COUNTS` tallies the gathers and reductions this module issues
and their bytes, and the cross-slice hops and the bytes this rank sends
into them (what the algorithm sends, not what gloo's staging moves). """

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gke_ray_train_tpu_torch.models.config import ModelConfig

# what the manual path issued since the last reset: all-gathers and their
# gathered bytes (every rank's shards), reduce-scatters and their input
# bytes, and the cross-slice hops and the bytes this rank sent into them
COUNTS = {"gathers": 0, "gather_bytes": 0, "reductions": 0,
          "reduce_bytes": 0, "cross_reductions": 0, "cross_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class ManualOverlapUnsupported(ValueError):
    """The model/mesh combination has no manual-overlap path."""


def check_manual_support(cfg: ModelConfig, mesh, *,
                         lora: bool = False) -> None:
    """Raise :class:`ManualOverlapUnsupported` where the manual path
    cannot run, in the JAX package's words (its :72-93): no mesh, a
    ``model``, ``context`` or ``pipe`` axis above 1, LoRA, MoE."""
    if mesh is None:
        raise ManualOverlapUnsupported(
            "overlap='manual' needs a mesh — the whole point is placing "
            "the mesh collectives by hand")
    from gke_ray_train_tpu_torch.parallel.mesh import mesh_config_of
    sizes = mesh_config_of(mesh)
    for axis in ("model", "context", "pipe"):
        if getattr(sizes, axis) != 1:
            raise ManualOverlapUnsupported(
                f"overlap='manual' supports data/fsdp meshes only "
                f"(mesh has {axis}={getattr(sizes, axis)}); use "
                "overlap='xla' there")
    if lora:
        raise ManualOverlapUnsupported(
            "overlap='manual' does not support LoRA (the adapter grads "
            "flow outside the fsdp gather structure); set OVERLAP=off "
            "or =xla for adapter runs")
    if cfg.n_experts > 0:
        raise ManualOverlapUnsupported(
            "overlap='manual' does not support MoE blocks (expert "
            "dispatch needs its own manual all-to-alls); set "
            "OVERLAP=off or =xla")


# ---------------------------------------------------------------------------
# one unit's leaves, and their collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Leaf:
    name: str
    param: torch.Tensor            # the FSDP2-sharded DTensor parameter
    dim: int                       # the dim it is sharded on over fsdp
    shape: torch.Size              # whole
    local_shape: torch.Size


@dataclasses.dataclass
class _Unit:
    """A ``Block`` or the root: its sharded leaves (one dtype), the fsdp
    group they are sharded over and the replicate groups (HSDP) their
    gradients are summed over after it; ``acc`` the full gradients summed
    over the step's microbatches so far (``shard_acc``: their reduced
    shards, where each microbatch is reduced)."""
    module: torch.nn.Module
    leaves: List[_Leaf]
    group: object
    n: int
    replicate: List[object]
    acc: Optional[List[torch.Tensor]] = None
    shard_acc: Optional[torch.Tensor] = None

    @property
    def numel(self) -> int:
        return sum(math.prod(lf.local_shape) for lf in self.leaves)


def _unit_of(module: torch.nn.Module) -> _Unit:
    """The unit of a sharded module's own parameters (not its children's:
    the root's blocks are units of their own)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    leaves, groups, n, replicate = [], set(), None, None
    for name, p in module._parameters.items():
        if p is None:
            continue
        if not isinstance(p, DTensor):
            raise ManualOverlapUnsupported(
                f"overlap='manual' gathers FSDP2-sharded parameters; "
                f"{name} is not one (shard the model with "
                "parallel/sharding.py::shard_model)")
        shard = [(i, pl) for i, pl in enumerate(p.placements)
                 if pl.is_shard()]
        if len(shard) != 1:
            raise ManualOverlapUnsupported(
                f"overlap='manual' supports data/fsdp meshes only "
                f"({name} is placed {p.placements})")
        mdim, pl = shard[0]
        size = p.device_mesh.size(mdim)
        if p.shape[pl.dim] % size:
            raise ManualOverlapUnsupported(
                f"overlap='manual' gathers even shards; {name} dim "
                f"{pl.dim} (size {p.shape[pl.dim]}) does not divide by "
                f"fsdp={size}")
        # by its ranks: a mesh built again in one process may hand an
        # equal layout's parameters another group object of the same
        # ranks (DeviceMesh caches submeshes by layout)
        groups.add(tuple(dist.get_process_group_ranks(
            p.device_mesh.get_group(mdim))))
        if n is None:
            n = size
            group = p.device_mesh.get_group(mdim)
            replicate = [p.device_mesh.get_group(i)
                         for i, q in enumerate(p.placements)
                         if q.is_replicate()]
        leaves.append(_Leaf(name, p, pl.dim, p.shape, p.to_local().shape))
    if len(groups) > 1 or len({lf.param.dtype for lf in leaves}) > 1:
        raise ManualOverlapUnsupported(
            "overlap='manual' gathers a unit's parameters in one "
            "collective: one fsdp group and one dtype a unit")
    return _Unit(module, leaves, group, n, replicate)


# Under gloo CUDA tensors stage through page-locked host memory, and the
# gather and the reduce-scatter run as all-reduces of the whole buffer:
# gloo's all-gather and reduce-scatter into one tensor take about twice
# its all-reduce's time for the same bytes. A gather is the sum of each
# rank's shard in its own row of zeros (x + 0 is x); a reduce-scatter
# keeps this rank's chunk of the summed buffer, each element the sum of
# the same partials as the reduce-scatter's.


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops import ring_attention as ra
    if ra._staged(group, inp):
        n = out.numel() // inp.numel()
        h = torch.zeros((n, inp.numel()), dtype=out.dtype, pin_memory=True)
        h[dist.get_rank(group)].copy_(inp.reshape(-1), non_blocking=True)
        torch.cuda.current_stream(inp.device).synchronize()
        dist.all_reduce(h, group=group)
        out.copy_(ra._from_host(h.view(-1), out.device))
    else:
        dist.all_gather_into_tensor(out, inp, group=group)


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group,
                    replicate) -> None:
    """``out`` = this rank's chunk of the sum of ``inp`` over ``group``,
    then summed over each of ``replicate`` (FSDP2's HSDP order)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops import ring_attention as ra
    if ra._staged(group, inp):
        h = ra._to_host([inp])[0]
        dist.all_reduce(h, group=group)
        k = out.numel()
        mine = h[dist.get_rank(group) * k:(dist.get_rank(group) + 1) * k]
        for g in replicate:
            dist.all_reduce(mine, group=g)
        out.copy_(ra._from_host(mine, out.device))
    else:
        dist.reduce_scatter_tensor(out, inp, group=group)
        for g in replicate:
            dist.all_reduce(out, group=g)


_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _comm_stream(dev: torch.device):
    """The stream the collectives of ``dev`` run on: a dedicated one for
    a card (made once), None on the CPU."""
    if dev.type != "cuda":
        return None
    s = _STREAMS.get(dev)
    if s is None:
        s = _STREAMS[dev] = torch.cuda.Stream(device=dev)
    return s


class _Handle:
    """A unit's gathered tensors, and the event the compute stream waits
    on before it reads them (None where the gather was synchronous)."""

    def __init__(self, fulls: List[torch.Tensor], event=None):
        self.fulls = fulls
        self.event = event

    def wait(self) -> List[torch.Tensor]:
        if self.event is not None:
            cur = torch.cuda.current_stream(self.fulls[0].device)
            cur.wait_event(self.event)
            for f in self.fulls:
                # made on the communication stream, read on this one
                f.record_stream(cur)
        return self.fulls


@torch.no_grad()
def _issue_gather(unit: _Unit) -> _Handle:
    """All-gather every leaf of ``unit`` in one collective over its fsdp
    group, on the communication stream where there is one: one flat
    buffer of this rank's shards, each leaf's whole tensor copied out of
    the gathered rows and stitched along its shard dim."""
    locals_ = [lf.param.to_local() for lf in unit.leaves]
    dev = locals_[0].device
    comm = _comm_stream(dev)
    n, total = unit.n, unit.numel
    COUNTS["gathers"] += 1
    COUNTS["gather_bytes"] += n * total * locals_[0].element_size()
    if comm is not None:
        # the shards are the compute stream's (the optimizer writes them)
        comm.wait_stream(torch.cuda.current_stream(dev))
    with _on(comm):
        flat = torch.cat([t.reshape(-1) for t in locals_])
        out = torch.empty(n * total, dtype=flat.dtype, device=dev)
        _all_gather(out, flat, unit.group)
        rows = out.view(n, total)
        fulls, off = [], 0
        for lf in unit.leaves:
            k = math.prod(lf.local_shape)
            part = rows[:, off:off + k].reshape(n, *lf.local_shape)
            fulls.append(part.movedim(0, lf.dim).reshape(lf.shape))
            off += k
        event = None
        if comm is not None:
            event = torch.cuda.Event()
            event.record(comm)
    return _Handle(fulls, event)


def _on(stream):
    """Run the block on ``stream`` (the current one where it is None)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


@dataclasses.dataclass
class _Pending:
    unit: _Unit
    out: torch.Tensor
    event: object


@torch.no_grad()
def _issue_reduce(unit: _Unit, grads: List[torch.Tensor],
                  hop: Optional[Callable] = None) -> _Pending:
    """Reduce-scatter a unit's whole gradients over fsdp (then sum over
    its replicate groups) in one collective: rank r's chunk of every leaf
    at row r of one ``[n, numel]`` buffer, as FSDP2 lays out its
    reduce-scatter input. On more than one slice each leaf is reduced by
    ``hop(grad, leaf, i) -> this rank's shard`` instead (``i`` its index
    in the unit), the shards laid out as the one-slice path lays out its
    output."""
    dev = grads[0].device
    comm = _comm_stream(dev)
    n = unit.n
    COUNTS["reductions"] += 1
    COUNTS["reduce_bytes"] += n * unit.numel * grads[0].element_size()
    if comm is not None:
        comm.wait_stream(torch.cuda.current_stream(dev))
    with _on(comm):
        if hop is not None:
            out = torch.cat([
                hop(g, lf, i).to(g.dtype).reshape(-1)
                for i, (g, lf) in enumerate(zip(grads, unit.leaves))])
        else:
            flat = torch.cat([
                g.unflatten(lf.dim, (n, lf.local_shape[lf.dim]))
                .movedim(lf.dim, 0).reshape(n, -1)
                for g, lf in zip(grads, unit.leaves)], dim=1).reshape(-1)
            out = torch.empty(unit.numel, dtype=flat.dtype, device=dev)
            _reduce_scatter(out, flat, unit.group, unit.replicate)
        event = None
        if comm is not None:
            event = torch.cuda.Event()
            event.record(comm)
    if comm is not None:
        # read on the communication stream: not reused before it is done
        for g in grads:
            g.record_stream(comm)
    return _Pending(unit, out, event)


def _wait(p: _Pending) -> torch.Tensor:
    """The reduced shards of ``p``, readable on the current stream."""
    if p.event is not None:
        cur = torch.cuda.current_stream(p.out.device)
        cur.wait_event(p.event)
        p.out.record_stream(cur)
    return p.out


def _land(unit: _Unit, out: torch.Tensor) -> None:
    """Set each leaf's ``.grad`` to its reduced shard in ``out``, a
    DTensor placed as its parameter (FSDP2's)."""
    from torch.distributed.tensor import DTensor
    off = 0
    for lf in unit.leaves:
        k = math.prod(lf.local_shape)
        g = out[off:off + k].view(lf.local_shape)
        off += k
        lf.param.grad = DTensor.from_local(
            g, lf.param.device_mesh, lf.param.placements, run_check=False,
            shape=lf.shape, stride=lf.param.stride())


# ---------------------------------------------------------------------------
# the gather as an autograd Function, and the schedule of one microbatch
# ---------------------------------------------------------------------------

class _GatherUnit(torch.autograd.Function):
    """Forward: a unit's whole tensors (taken from the schedule: the
    prefetched gather waited on, or a gather now). Backward: the unit's
    gradients accumulated over the step's microbatches and, on its last,
    reduced (:func:`_issue_reduce`); the parameters' ``.grad`` are set
    once the reduction is waited on (:meth:`_Schedule.finish`), so the
    Function hands autograd no gradient of its own."""

    @staticmethod
    def forward(ctx, sched, idx, *params):
        ctx.sched, ctx.idx = sched, idx
        return tuple(sched.take(idx))

    @staticmethod
    def backward(ctx, *grads):
        ctx.sched.reduce(ctx.idx, list(grads))
        return (None, None) + (None,) * len(grads)


class _Schedule:
    """One microbatch's gathers and reductions over the units (index -1
    the root, ``i`` block ``i``): which gathers are in flight, in which
    order the layers take their weights in the forward and in the
    recomputation, and the reductions to land at the end."""

    def __init__(self, units: List[_Unit], root: _Unit, remat_group: int,
                 last: bool, hop: Optional[Callable] = None,
                 each_microbatch: bool = False):
        self.units, self.root, self.last = units, root, last
        # the multi-slice leaf reduction, and whether it runs on every
        # microbatch (the compressed arm) or on the step's sum
        self.hop, self.each_microbatch = hop, each_microbatch
        L = len(units)
        self.order = {"forward": list(range(L)),
                      # remat regions last first, a region's layers in
                      # order (run_block_stack's recomputation)
                      "backward": [i for r in range(
                          (L - 1) // remat_group * remat_group, -1,
                          -remat_group)
                          for i in range(r, min(r + remat_group, L))]}
        self.phase = "forward"
        self.ready: Dict[int, _Handle] = {}
        self.pending: List[_Pending] = []

    def _unit(self, idx: int) -> _Unit:
        return self.root if idx < 0 else self.units[idx]

    def prefetch(self, idx: Optional[int]) -> None:
        if idx is not None and idx not in self.ready:
            self.ready[idx] = _issue_gather(self._unit(idx))

    def _next(self, idx: int) -> Optional[int]:
        order = self.order[self.phase]
        j = order.index(idx) + 1
        return order[j] if j < len(order) else None

    def take(self, idx: int) -> List[torch.Tensor]:
        """Unit ``idx``'s whole tensors: its prefetched gather (else one
        issued now) waited on; the next layer of this phase's order is
        issued first, so it is in flight while this one computes."""
        handle = self.ready.pop(idx, None)
        if handle is None:
            handle = _issue_gather(self._unit(idx))
        if idx >= 0:
            self.prefetch(self._next(idx))
        return handle.wait()

    def gathered(self, idx: int):
        """A :class:`Gathered` view of unit ``idx`` on its whole tensors,
        through :class:`_GatherUnit`."""
        from gke_ray_train_tpu_torch.models.transformer import Gathered
        unit = self._unit(idx)
        fulls = _GatherUnit.apply(self, idx,
                                  *[lf.param for lf in unit.leaves])
        return Gathered(unit.module, {lf.name: t for lf, t
                                      in zip(unit.leaves, fulls)})

    def layer_call(self, i: int, x, *args):
        from gke_ray_train_tpu_torch.models.transformer import _layer
        return _layer(x, self.gathered(i), *args)

    def reduce(self, idx: int, grads: List[torch.Tensor]) -> None:
        """Unit ``idx``'s whole gradients of this microbatch: added to the
        step's sum (in FSDP2's order: the earlier microbatches' first),
        and on the step's last microbatch reduced; under compression
        reduced at once, every microbatch."""
        unit = self._unit(idx)
        hop = (None if self.hop is None
               else functools.partial(self.hop, idx))
        if self.each_microbatch:
            self.pending.append(_issue_reduce(unit, grads, hop))
            return
        if unit.acc is not None:
            for a, g in zip(unit.acc, grads):
                a.add_(g)
            grads, unit.acc = unit.acc, None
        if not self.last:
            unit.acc = [g.detach().clone() if g.requires_grad else g
                        for g in grads]
            return
        self.pending.append(_issue_reduce(unit, grads, hop))

    def finish(self) -> None:
        """After the backward: the reductions waited on and landed (under
        compression added to the step's sum of the reduced shards, which
        lands on the last microbatch)."""
        self.ready.clear()
        for p in self.pending:
            out = _wait(p)
            unit = p.unit
            if self.each_microbatch:
                if unit.shard_acc is not None:
                    out = unit.shard_acc.add_(out)
                unit.shard_acc = None if self.last else out
                if not self.last:
                    continue
            _land(unit, out)
        self.pending = []


# ---------------------------------------------------------------------------
# the grad function
# ---------------------------------------------------------------------------

def _units_of(params) -> Tuple[_Unit, List[_Unit]]:
    """(root unit, block units) of a sharded ``Transformer``, made once
    and kept on it; units left gathered (a root after a forward) are
    resharded first."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor
    for m in [params] + list(params.blocks):
        if isinstance(m, FSDPModule) and not all(
                isinstance(p, DTensor) for p in m._parameters.values()
                if p is not None):
            m.reshard()
    units = getattr(params, "_manual_units", None)
    if units is None:
        units = (_unit_of(params), [_unit_of(b) for b in params.blocks])
        params._manual_units = units
    return units


def make_manual_grad_fn(cfg: ModelConfig, mesh, *,
                        fused_ops: bool = False,
                        use_fused_ce: bool = False,
                        num_slices: int = 1,
                        dcn_sync: str = "flat",
                        dcn_compress: str = "none") -> Callable:
    """Build ``grad_fn(params, micro, loss_fn, *, last) -> (nll_sum,
    w_sum)``, the manual counterpart of one microbatch's forward and
    backward on the off path (``train/step.py``): ``params`` the sharded
    ``Transformer``, ``micro`` this rank's rows, ``loss_fn(out, view)``
    the step's loss on the final hidden state (``use_fused_ce``: the
    final-normed state for the fused cross-entropy, else the logits) and
    a :class:`Gathered` root; ``last``: the step's last microbatch, on
    which the gradients are reduced and land in ``.grad``. Returns this
    rank's sums, detached (the step sums them over the batch ranks, as
    on the off path).

    ``num_slices`` / ``dcn_sync`` / ``dcn_compress``: the cross-slice
    arms (module doc; ``num_slices`` that of the mesh, which
    ``parallel/mesh.py::build_mesh`` made for it). ``hier`` on one slice
    runs ``flat``, as JAX's. With compression the signature grows JAX's
    error-feedback residual: ``grad_fn(params, micro, loss_fn, *, last,
    residual) -> (nll_sum, w_sum, new_residual)``, the residual None at
    the step's first microbatch and each one's fed to the next, and the
    returned fn carries ``grad_fn.compressed = True``."""
    from gke_ray_train_tpu_torch.models.transformer import forward
    from gke_ray_train_tpu_torch.parallel import hierarchical as hr
    check_manual_support(cfg, mesh)
    group = len(cfg.block_pattern)
    topo = hr.slice_topology(mesh, num_slices)
    compressed = dcn_compress != "none" and topo is not None
    if dcn_sync == "hier" and topo is None:
        dcn_sync = "flat"

    def hop(residual, idx, g, lf, i):
        """Leaf ``i`` of unit ``idx`` reduced to this rank's shard; under
        compression its residual updated in ``residual``."""
        if topo.fsdp == 1:
            # whole on every rank: JAX's replicated leaf
            return (hr.hier_reduce_full(g, topo, tally=COUNTS)
                    if dcn_sync == "hier"
                    else hr.staged_psum(g, topo, tally=COUNTS))
        if compressed:
            p = hr.intra_reduce_shard(g, topo, lf.dim)
            s, err = hr.compressed_cross_psum(
                p, residual["in"].get((idx, i)), topo, dcn_compress,
                tally=COUNTS)
            if residual["keep"]:
                # the step drops its last microbatch's residual: not held
                residual["out"][(idx, i)] = err
            return s
        if dcn_sync == "hier":
            return hr.hier_reduce_shard(g, topo, lf.dim, tally=COUNTS)
        return hr.flat_reduce_shard(g, topo, lf.dim, tally=COUNTS)

    def grad_fn(params, micro: Dict[str, torch.Tensor], loss_fn, *,
                last: bool, residual=None):
        root, blocks = _units_of(params)
        remat = cfg.remat and torch.is_grad_enabled()
        res = {"in": residual or {}, "out": {}, "keep": not last}
        sched = _Schedule(blocks, root, group, last,
                          hop=(functools.partial(hop, res)
                               if topo is not None else None),
                          each_microbatch=compressed)
        view = sched.gathered(-1)
        sched.prefetch(0 if blocks else None)
        nll, w = forward(
            view, micro["inputs"], cfg, positions=micro.get("positions"),
            segment_ids=micro.get("segment_ids"), fused_ops=fused_ops,
            return_pre_unembed=use_fused_ce, loss_fn=loss_fn, mesh=mesh,
            layer_call=sched.layer_call)
        # the root's whole tensors live on only where the graph saved
        # them (the head, for the loss's backward): not through to the
        # root's reduction at the end of the backward
        del view
        sched.phase = "backward"
        if remat and blocks:
            # the last region's first layer, in flight under the head's
            # backward
            sched.prefetch(sched.order["backward"][0])
        nll.backward()
        sched.finish()
        if compressed:
            return nll.detach(), w, res["out"]
        return nll.detach(), w

    grad_fn.compressed = compressed
    return grad_fn
