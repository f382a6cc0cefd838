"""Cross-slice gradient sums, ``DCN_SYNC`` and ``DCN_COMPRESS``
(counterpart of ``gke_ray_train_tpu/parallel/hierarchical.py``, function
for function).

On a mesh of more than one slice the ``data`` axis, and only it, spans
slices (``parallel/mesh.py``: slices are contiguous blocks of ``data``,
``data`` outermost). On GPUs a slice is a node: NVLink inside it, the
network between nodes. A gradient summed over ``data`` × ``fsdp`` in one
all-reduce sends its full payload between slices. Decomposed, only
``1 / ici_size`` of the bytes leave a slice:

    intra-slice reduce-scatter
      → cross-slice all-reduce of the scattered shard
        → intra-slice all-gather

:class:`SliceTopology` factors ``data`` into its cross-slice and
intra-slice parts and carries this rank's process groups of each
(``parallel/mesh.py::slice_groups``); the sums below express both
``DCN_SYNC`` arms on them:

- ``flat``: the full payload crosses (:func:`staged_psum`,
  :func:`flat_reduce_shard`);
- ``hier``: the scattered shard crosses (:func:`hier_reduce_full`,
  :func:`hier_reduce_shard`).

Both arms stage the sum at the slice boundary: fsdp first, then the
``data`` ranks inside a slice, then across slices. Where every stage's
group has two members each stage's sum is ``a + b``, so the arms agree
bit for bit: the scatter only changes where each partial sum lands.

``DCN_COMPRESS=bf16`` casts the cross-slice hop of the ``hier`` arm to
bf16, with the quantization error of one microbatch added back into the
next (:func:`compressed_cross_psum`); not bit for bit. Only fsdp-sharded
gradients compress.

JAX's functions run inside ``shard_map`` and name axes; these take
tensors and run ``torch.distributed`` collectives on the topology's
groups, each summing in place where it can (an input's storage may be
reused). Under gloo, CUDA tensors are staged through page-locked host
memory (``ops/ring_attention.py``'s helpers). A ``tally`` dict, where
given, counts each cross-slice hop (``cross_reductions``) and the bytes
this rank sends into it (``cross_bytes``)."""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

import torch

_DATA = "data"
_FSDP = "fsdp"


class HierSyncUnsupported(ValueError):
    """The mesh/plan combination has no hierarchical sync path."""


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """The cross-slice factoring of a data/fsdp mesh: ``data`` =
    ``num_slices`` (outermost) × ``data_intra`` (inside a slice).
    ``ici_size`` is the intra-slice reduction width, the factor the hier
    hop divides the cross-slice payload by. The groups are this rank's
    (None for a group of one, or a topology made from sizes alone)."""
    num_slices: int
    data: int
    fsdp: int
    fsdp_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)
    intra_group: object = dataclasses.field(default=None, compare=False,
                                            repr=False)
    cross_group: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    @property
    def data_intra(self) -> int:
        return self.data // self.num_slices

    @property
    def ici_size(self) -> int:
        return self.data_intra * self.fsdp

    @property
    def intra_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """``data`` indices within each slice (contiguous blocks)."""
        di = self.data_intra
        return tuple(tuple(s * di + j for j in range(di))
                     for s in range(self.num_slices))

    @property
    def cross_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """``data`` indices across slices (the same position in every
        slice: the cross-slice hop's peers)."""
        di = self.data_intra
        return tuple(tuple(s * di + j for s in range(self.num_slices))
                     for j in range(di))


def _sizes(mesh) -> dict:
    """The axis sizes of a ``DeviceMesh``, a ``MeshConfig`` or anything
    with a ``shape`` mapping (JAX's mesh)."""
    from gke_ray_train_tpu_torch.parallel.mesh import MESH_AXES, MeshConfig
    if isinstance(mesh, MeshConfig):
        return {a: getattr(mesh, a) for a in MESH_AXES}
    if hasattr(mesh, "mesh_dim_names"):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    raise TypeError(f"no axis sizes on {type(mesh).__name__}")


def slice_topology(mesh, num_slices: int) -> Optional[SliceTopology]:
    """The mesh's :class:`SliceTopology`, or None on one slice. The
    ``data`` axis, and only it, spans slices: ``data`` must divide by
    ``num_slices`` and ``model``, ``context`` and ``pipe`` must be 1.
    On a ``DeviceMesh`` the topology carries this rank's groups, which
    :func:`parallel.mesh.build_mesh` made for ``num_slices``."""
    if num_slices <= 1:
        return None
    sizes = _sizes(mesh)
    data = int(sizes.get(_DATA, 1))
    fsdp = int(sizes.get(_FSDP, 1))
    if data % num_slices:
        raise HierSyncUnsupported(
            f"data axis ({data}) must be divisible by num_slices "
            f"({num_slices}) — the data axis is the only axis that "
            "spans slices (the hybrid-mesh contract)")
    for axis in ("model", "context", "pipe"):
        if int(sizes.get(axis, 1)) != 1:
            raise HierSyncUnsupported(
                f"hierarchical DCN sync supports data/fsdp meshes only "
                f"(mesh has {axis}={sizes[axis]}); structural axes "
                "are never touched")
    if not hasattr(mesh, "mesh_dim_names"):
        return SliceTopology(num_slices=num_slices, data=data, fsdp=fsdp)
    from gke_ray_train_tpu_torch.parallel.mesh import (
        num_slices_of, slice_groups)
    if num_slices_of(mesh) != num_slices:
        raise HierSyncUnsupported(
            f"the mesh was built with num_slices={num_slices_of(mesh)}, "
            f"not {num_slices}: build it with MeshConfig(num_slices=...)")
    intra, cross = slice_groups(mesh)
    return SliceTopology(
        num_slices=num_slices, data=data, fsdp=fsdp,
        fsdp_group=mesh[_FSDP].get_group() if fsdp > 1 else None,
        intra_group=intra, cross_group=cross)


# ---------------------------------------------------------------------------
# collectives on a group, along dim 0
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (``x`` itself when it is None)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops import ring_attention as ra
    if group is None:
        return x
    if ra._staged(group, x):
        h = ra._to_host([x])[0]
        dist.all_reduce(h, group=group)
        return ra._from_host(h, x.device)
    dist.all_reduce(x, group=group)
    return x


def _reduce_scatter0(y: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows of ``y`` (contiguous) summed over
    ``group``; under gloo's host staging the whole buffer is all-reduced
    and the block kept (the same sum of the same partials)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops import ring_attention as ra
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = y.shape[0] // n
    if ra._staged(group, y):
        return _all_reduce(y, group)[r * k:(r + 1) * k]
    out = torch.empty((k,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    dist.reduce_scatter_tensor(out, y, group=group)
    return out


def _all_gather0(y: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``y`` of ``group``, stacked along dim 0 in group
    order; under gloo's host staging an all-reduce of each rank's block
    in a buffer of zeros (``x + 0`` is ``x``)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ops import ring_attention as ra
    n, r = dist.get_world_size(group), dist.get_rank(group)
    shape = (n * y.shape[0],) + tuple(y.shape[1:])
    if ra._staged(group, y):
        h = torch.zeros((n,) + tuple(y.shape), dtype=y.dtype,
                        pin_memory=True)
        h[r].copy_(y, non_blocking=True)
        torch.cuda.current_stream(y.device).synchronize()
        dist.all_reduce(h, group=group)
        return ra._from_host(h.view(shape), y.device)
    out = torch.empty(shape, dtype=y.dtype, device=y.device)
    dist.all_gather_into_tensor(out, y.contiguous(), group=group)
    return out


def _cross(x: torch.Tensor, topo: SliceTopology, tally) -> torch.Tensor:
    """The cross-slice hop: ``x`` summed over the slices, counted."""
    if tally is not None:
        tally["cross_reductions"] += 1
        tally["cross_bytes"] += x.numel() * x.element_size()
    return _all_reduce(x, topo.cross_group)


def _to0(x: torch.Tensor, dim: int) -> torch.Tensor:
    return (x.movedim(dim, 0) if dim else x).contiguous()


def _from0(y: torch.Tensor, dim: int) -> torch.Tensor:
    return y.movedim(0, dim) if dim else y


# ---------------------------------------------------------------------------
# staged reductions
# ---------------------------------------------------------------------------

def staged_psum(x: torch.Tensor, topo: SliceTopology,
                tally: Optional[dict] = None) -> torch.Tensor:
    """Full-payload sum with the slice-staged fold: fsdp → data inside
    the slice → data across slices. The association both arms share;
    the flat arm's traffic (the full leaf crosses)."""
    if topo.fsdp > 1:
        x = _all_reduce(x, topo.fsdp_group)
    if topo.data_intra > 1:
        x = _all_reduce(x, topo.intra_group)
    return _cross(x, topo, tally)


def _scatter_axes(shape: Tuple[int, ...], topo: SliceTopology,
                  dim: Optional[int] = None
                  ) -> Optional[Tuple[int, bool]]:
    """(dim, also_scatter_intra_data): the dim the hier path scatters
    along, or None when no dim tiles the fsdp width (the leaf rides the
    staged full-payload path)."""
    dims = range(len(shape)) if dim is None else (dim,)
    for d in dims:
        if topo.fsdp > 1 and shape[d] % topo.fsdp == 0 and shape[d] > 0:
            per = shape[d] // topo.fsdp
            return d, (topo.data_intra > 1
                       and per % topo.data_intra == 0)
        if topo.fsdp == 1 and topo.data_intra > 1 \
                and shape[d] % topo.data_intra == 0 and shape[d] > 0:
            return d, True
    return None


def hier_reduce_full(x: torch.Tensor, topo: SliceTopology,
                     dim: Optional[int] = None,
                     tally: Optional[dict] = None) -> torch.Tensor:
    """The hierarchical sum of a whole (replicated-result) leaf:
    reduce-scatter over the intra-slice axes → cross-slice all-reduce of
    the shard (``1 / ici_size`` of the bytes) → all-gather back. The
    same values as :func:`staged_psum`; falls back to it where no dim
    tiles."""
    plan = _scatter_axes(tuple(x.shape), topo, dim)
    if plan is None:
        return staged_psum(x, topo, tally)
    d, scatter_intra = plan
    p = _to0(x, d)
    if topo.fsdp > 1:
        p = _reduce_scatter0(p, topo.fsdp_group)
    if topo.data_intra > 1:
        p = (_reduce_scatter0(p, topo.intra_group) if scatter_intra
             else _all_reduce(p, topo.intra_group))
    p = _cross(p, topo, tally)
    if topo.data_intra > 1 and scatter_intra:
        p = _all_gather0(p, topo.intra_group)
    if topo.fsdp > 1:
        p = _all_gather0(p, topo.fsdp_group)
    return _from0(p, d)


def _fsdp_index(topo: SliceTopology) -> int:
    import torch.distributed as dist
    return dist.get_rank(topo.fsdp_group) if topo.fsdp > 1 else 0


def flat_reduce_shard(ct: torch.Tensor, topo: SliceTopology, dim: int,
                      tally: Optional[dict] = None) -> torch.Tensor:
    """FLAT arm, fsdp-sharded leaf: the staged full-payload sum of the
    whole gradient (the full leaf crosses between slices), then this
    rank's fsdp shard along ``dim``."""
    full = staged_psum(ct, topo, tally)
    shard = ct.shape[dim] // topo.fsdp
    return full.narrow(dim, _fsdp_index(topo) * shard, shard)


def hier_reduce_shard(ct: torch.Tensor, topo: SliceTopology, dim: int,
                      tally: Optional[dict] = None) -> torch.Tensor:
    """HIER arm, fsdp-sharded leaf: reduce-scatter over fsdp (and the
    slice's part of ``data`` where the shard tiles it) → cross-slice
    all-reduce of the scattered shard → gathered back to this rank's
    fsdp shard. The same values as :func:`flat_reduce_shard`."""
    p = _to0(ct, dim)
    if topo.fsdp > 1:
        p = _reduce_scatter0(p, topo.fsdp_group)
    scatter_intra = (topo.data_intra > 1
                     and p.shape[0] % topo.data_intra == 0)
    if topo.data_intra > 1:
        p = (_reduce_scatter0(p, topo.intra_group) if scatter_intra
             else _all_reduce(p, topo.intra_group))
    p = _cross(p, topo, tally)
    if scatter_intra:
        p = _all_gather0(p, topo.intra_group)
    return _from0(p, dim)


def intra_reduce_shard(ct: torch.Tensor, topo: SliceTopology,
                       dim: int) -> torch.Tensor:
    """The intra-slice half of the sharded-leaf sum (compressed arm):
    reduce-scatter over fsdp, then the slice's ``data`` sum, stopping
    before the cross-slice hop (:func:`compressed_cross_psum`)."""
    p = _to0(ct, dim)
    if topo.fsdp > 1:
        p = _reduce_scatter0(p, topo.fsdp_group)
    if topo.data_intra > 1:
        p = _all_reduce(p, topo.intra_group)
    return _from0(p, dim)


def compressed_cross_psum(p: torch.Tensor,
                          residual: Optional[torch.Tensor],
                          topo: SliceTopology, compress: str = "bf16",
                          tally: Optional[dict] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed cross-slice hop with error feedback: the
    intra-slice partial plus the previous microbatch's residual (None:
    zero, the step's first microbatch), cast to bf16 and summed across
    slices (half the bytes); the local quantization error is the next
    microbatch's residual. The returned sum is a function of the
    cross-slice sum alone, so every slice applies the same update; the
    residual is slice-local. Returns ``(reduced, new_residual)``, both
    fp32."""
    if compress != "bf16":
        raise HierSyncUnsupported(
            f"DCN_COMPRESS={compress!r} not supported (only 'bf16')")
    x = p.float() if residual is None else p.float() + residual
    q = x.to(torch.bfloat16)
    err = x - q.float()
    s = _cross(q.contiguous(), topo, tally)
    return s.float(), err


# ---------------------------------------------------------------------------
# hier_psum: the sum as an autograd Function
# ---------------------------------------------------------------------------

class _HierPsum(torch.autograd.Function):
    """Forward: the staged sum (``flat``) or the hierarchical one
    (``hier``) of a copy of ``x``. Backward: the cotangent unchanged
    (each participant's partial enters the replicated sum linearly)."""

    @staticmethod
    def forward(ctx, x, topo, mode, dim):
        x = x.detach().clone()
        if mode == "flat":
            return staged_psum(x, topo)
        return hier_reduce_full(x, topo, dim)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None, None


def hier_psum(x: torch.Tensor, topo: SliceTopology, *, mode: str = "hier",
              dim: Optional[int] = None) -> torch.Tensor:
    """Slice-staged sum of ``x`` over this rank's {data × fsdp} peers:
    ``mode="flat"`` sends the full payload across slices
    (:func:`staged_psum`), ``mode="hier"`` the scattered shard
    (:func:`hier_reduce_full`): the same values, ``1 / ici_size`` of the
    cross-slice bytes. Its backward passes the cotangent through
    unchanged."""
    if mode not in ("flat", "hier"):
        raise HierSyncUnsupported(f"mode={mode!r} not in ('flat','hier')")
    return _HierPsum.apply(x, topo, mode, dim)


def leaf_payload_split(shapes: List[Tuple[int, ...]],
                       topo: SliceTopology) -> Tuple[int, int]:
    """(flat_dcn_elems, hier_dcn_elems) a gradient tree of the given leaf
    shapes sends across slices per reduction: the arithmetic behind the
    ``hier <= (1 / ici_size + eps) × flat`` bound."""
    flat = 0
    hier = 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        flat += n
        plan = _scatter_axes(shape, topo)
        if plan is None:
            hier += n
        else:
            d, scatter_intra = plan
            denom = topo.fsdp * (topo.data_intra if scatter_intra else 1)
            hier += n // max(denom, 1)
    return flat, hier


def peer_replication_elems(shapes: List[Tuple[int, ...]],
                           num_slices: int) -> int:
    """Elements one peer-replication round sends across slices: every
    slice streams its full state replica to its ring neighbour, so the
    round moves ``num_slices`` × the replica size."""
    per_replica = 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        per_replica += n
    return max(int(num_slices), 1) * per_replica
