"""Topology and process-group init (counterpart of
``gke_ray_train_tpu/parallel/mesh.py``).

The JAX package names five mesh axes and lets GSPMD derive the
collectives from sharding specs. Here the same axis vocabulary names the
dims of a ``torch.distributed`` ``DeviceMesh`` over the world's ranks,
one rank per card, and the collectives are NCCL's (gloo when a caller
asks for the CPU):

==========  ========================================================
axis        what is sharded over it
==========  ========================================================
``data``    the batch only (replicas of the sharded model: HSDP)
``fsdp``    the batch AND the parameters (FSDP2, ``parallel/sharding.py``)
``model``   tensor parallelism on dense models (``parallel/tensor.py``)
``context`` the sequence (ring and all-to-all attention,
            ``ops/ring_attention.py``, ``ops/a2a_attention.py``)
``pipe``    the depth: pipeline stages, each rank its layers
            (``models/pipeline.py``)
==========  ========================================================

``pipe`` composes with every other axis: a stage's blocks are sharded
over its own ``data``, ``fsdp``, ``model`` and ``context`` ranks.

Slices (``num_slices`` above 1) split the ``data`` axis, and only it,
into contiguous blocks: JAX's hybrid layout, ``data`` outermost, so a
slice is a contiguous block of ranks, as a node's ranks are under
torchrun. On GPUs a slice is a node (NVLink inside it, the network
between nodes). :func:`build_mesh` makes the ``data`` axis's
intra-slice and cross-slice process groups
(``parallel/hierarchical.py`` sums over them) and keeps the slice count
on the mesh (:func:`num_slices_of`); :func:`slice_assignments` is the
one rank → slice contract.

:func:`distributed_init` reads the rendezvous that torchrun and Ray Train
set (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``); :func:`build_mesh` resolves a :class:`MeshConfig` over
the world and returns the ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Optional

import torch

from gke_ray_train_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"
AXIS_PIPE = "pipe"
MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_CONTEXT, AXIS_PIPE)

# the batch is sharded over both data-parallel axes
BATCH_AXES = (AXIS_DATA, AXIS_FSDP)

# the ROADMAP item that ports each axis the port cannot shard over yet
# (every axis is ported)
UNPORTED_AXES: dict = {}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape; any one axis may be -1 ("fill with what
    remains"). ``num_slices`` counts the slices (nodes) the ``data``
    axis spans; it must divide ``data``."""

    data: int = 1
    fsdp: int = -1
    model: int = 1
    context: int = 1
    pipe: int = 1
    num_slices: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        """Resolve -1 entries so the product equals ``n_devices``."""
        sizes = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                 if f.name in MESH_AXES}
        fills = [k for k, v in sizes.items() if v == -1]
        if len(fills) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {fills}")
        bad = {k: v for k, v in sizes.items() if v != -1 and v < 1}
        if bad:
            raise ValueError(f"mesh axis sizes must be >=1 (or -1): {bad}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if fills:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"cannot fill axis {fills[0]}: {n_devices} devices not "
                    f"divisible by fixed product {fixed} ({sizes})")
            sizes[fills[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} has {math.prod(sizes.values())} slots but "
                f"{n_devices} devices are present")
        return dataclasses.replace(self, **sizes)

    @property
    def shape(self) -> tuple:
        return (self.data, self.fsdp, self.model, self.context, self.pipe)

    @staticmethod
    def from_dict(cfg: dict) -> "MeshConfig":
        """From the flat UPPER_CASE config keys (``MESH_DATA`` ...
        ``NUM_SLICES``)."""
        return MeshConfig(
            data=int(cfg.get("MESH_DATA", 1)),
            fsdp=int(cfg.get("MESH_FSDP", -1)),
            model=int(cfg.get("MESH_MODEL", 1)),
            context=int(cfg.get("MESH_CONTEXT", 1)),
            pipe=int(cfg.get("MESH_PIPE", 1)),
            num_slices=int(cfg.get("NUM_SLICES", 1)),
        )

    def check_ported(self) -> "MeshConfig":
        """Raise on a layout the port cannot run; returns ``self``. A
        resolved ``data`` axis that ``num_slices`` does not divide raises
        ``ValueError`` in the JAX package's words (its ``build_mesh``).
        Whether a model tiles ``model`` is checked where the mesh meets
        the model config (``plan.py::check_model_on_mesh``), whether it
        tiles ``pipe`` where the pipeline meets it
        (``models/pipeline.py::check_stages``)."""
        if self.num_slices > 1 and self.data != -1 and \
                self.data % self.num_slices:
            raise ValueError(
                f"data axis ({self.data}) must be divisible by "
                f"num_slices ({self.num_slices})")
        for axis, what in UNPORTED_AXES.items():
            size = getattr(self, axis)
            if size > 1:
                raise NotImplementedError(
                    f"MESH_{axis.upper()}={size}: {what} is not ported yet; "
                    "the port shards over data, fsdp, model and context "
                    "only")
        return self


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def local_rank() -> int:
    """This process's card index on its host (``LOCAL_RANK``, 0 when
    unset)."""
    return _env_int("LOCAL_RANK", 0)


def is_distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def collective_device() -> torch.device:
    """Where a small tensor for a collective of the default group lives:
    this rank's card under NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def distributed_init(device: DeviceLike = None, *,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``world_size`` / ``rank`` default to ``WORLD_SIZE`` / ``RANK``;
    ``init_method`` to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).
    With a world of one and no ``world_size`` passed no group is made,
    and the device resolves as ``device.py`` does. Otherwise the group
    uses NCCL on ``cuda:LOCAL_RANK`` (the card is made current), or gloo
    when ``device`` is ``"cpu"``: nothing gives way to gloo on the card.
    A group already initialized is reused."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.device import resolve_device
    asked = world_size is not None
    world = world_size if asked else _env_int("WORLD_SIZE", 1)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        torch.cuda.set_device(local_rank())
    if world <= 1 and not asked and not is_distributed():
        return resolve_device(device)
    if not is_distributed():
        dist.init_process_group(
            backend="gloo" if cpu else "nccl",
            init_method=init_method or "env://", world_size=world,
            rank=rank if rank is not None else _env_int("RANK", 0))
        logger.info("process group up: rank %d of %d (%s)",
                    dist.get_rank(), dist.get_world_size(),
                    dist.get_backend())
    elif dist.get_backend() != ("gloo" if cpu else "nccl"):
        raise RuntimeError(
            f"the process group runs {dist.get_backend()!r}; "
            f"{'gloo' if cpu else 'nccl'} is needed on "
            f"{'the CPU' if cpu else 'the card'}")
    return torch.device("cpu") if cpu else resolve_device(None)


def build_mesh(config: Optional[MeshConfig] = None, *,
               device_type: Optional[str] = None):
    """The five-axis ``DeviceMesh`` of the world's ranks, ``config``
    (default ``MeshConfig()``: all ranks on fsdp) resolved over the
    world size and checked (:meth:`MeshConfig.check_ported`). Needs an
    initialized process group; ``device_type`` defaults to the group's
    (``cuda`` under NCCL, ``cpu`` under gloo). With ``num_slices``
    above 1 every rank makes the slice groups of the ``data`` axis
    (:func:`slice_groups`); ranks are data-major, so a slice is a
    contiguous block of them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not is_distributed():
        raise RuntimeError("build_mesh needs a process group "
                           "(parallel/mesh.py::distributed_init)")
    config = (config or MeshConfig()).resolve(dist.get_world_size())
    config.check_ported()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if config.num_slices > 1:
        _check_slices_on_nodes(config, dist.get_world_size())
    mesh = init_device_mesh(device_type, config.shape,
                            mesh_dim_names=MESH_AXES)
    mesh._num_slices = config.num_slices
    if config.num_slices > 1:
        _make_slice_groups(mesh, config)
    return mesh


def _check_slices_on_nodes(config: MeshConfig, world: int) -> None:
    """Where ``LOCAL_WORLD_SIZE`` shows more than one node, each slice
    must be whole nodes (a slice's ranks are contiguous, as a node's are
    under torchrun), else raise: a config error, as JAX's real-hardware
    branch surfaces one. On one node the slices are emulated, with JAX's
    warning."""
    per_node = _env_int("LOCAL_WORLD_SIZE", 0)
    if 0 < per_node < world:
        per_slice = world // config.num_slices
        if per_slice % per_node:
            raise ValueError(
                f"num_slices={config.num_slices} over {world} ranks gives "
                f"slices of {per_slice} ranks, not a whole number of "
                f"nodes of {per_node} (LOCAL_WORLD_SIZE): a slice must "
                "be whole nodes")
        return
    logger.warning(
        "devices report no slice_index (fake/CPU backend); emulating the "
        "%d-slice hybrid mesh row-major", config.num_slices)


def _make_slice_groups(mesh, config: MeshConfig) -> None:
    """The ``data`` axis's groups within a slice (data indices ``s *
    data_intra + j`` over ``j``) and across slices (over ``s``), for
    every coordinate of the other axes: every rank makes every group, in
    one order, and keeps its own two on the mesh (None for a group of
    one)."""
    import torch.distributed as dist
    di = config.data // config.num_slices
    me = dist.get_rank()
    rows = mesh.mesh.movedim(MESH_AXES.index(AXIS_DATA), -1)
    rows = rows.reshape(-1, config.data).tolist()
    intra = cross = None
    for row in rows:
        for s in range(config.num_slices):
            ranks = row[s * di:(s + 1) * di]
            g = dist.new_group(ranks) if di > 1 else None
            if me in ranks:
                intra = g
        for j in range(di):
            ranks = row[j::di]
            g = dist.new_group(ranks)
            if me in ranks:
                cross = g
    mesh._slice_groups = (intra, cross)


def num_slices_of(mesh) -> int:
    """The slices ``mesh`` was built with (1 without a mesh)."""
    return 1 if mesh is None else getattr(mesh, "_num_slices", 1)


def slice_groups(mesh) -> tuple:
    """(intra-slice, cross-slice) process groups of this rank's ``data``
    peers on a mesh of more than one slice (the first None where a slice
    holds one data index), else (None, None)."""
    return getattr(mesh, "_slice_groups", (None, None))


def slice_assignments(ranks, num_slices: Optional[int] = None) -> list:
    """Slice identity per rank, the one ``slice_index`` contract (JAX's
    ``parallel/mesh.py::slice_assignments``): contiguous blocks of
    ``ranks`` form the slices, so rank ``i`` of ``n`` is on slice ``i //
    (n // num_slices)``; a count that does not tile the ranks is one
    domain. ``num_slices`` defaults to ``$NUM_SLICES`` (1 when unset).
    Shrinking the pool truncates it: the last slice is the one lost."""
    n = len(list(ranks))
    ns = int(num_slices if num_slices is not None
             else os.environ.get("NUM_SLICES", "1"))
    if ns <= 1 or n == 0 or n % ns:
        return [0] * n
    per_slice = n // ns
    return [i // per_slice for i in range(n)]


def mesh_config_of(mesh) -> MeshConfig:
    """The resolved ``MeshConfig`` of a mesh :func:`build_mesh` made,
    its slice count included."""
    return MeshConfig(num_slices=num_slices_of(mesh),
                      **{a: mesh.size(i) for i, a in enumerate(MESH_AXES)})


def batch_group_size(mesh) -> int:
    """Ranks over the batch axes (data × fsdp)."""
    return math.prod(mesh[a].size() for a in BATCH_AXES)


def batch_rank(mesh) -> int:
    """This rank's index among the batch axes' tiles, data-major (the
    order of the JAX package's ``P(("data", "fsdp"))``)."""
    return (mesh[AXIS_DATA].get_local_rank() * mesh[AXIS_FSDP].size()
            + mesh[AXIS_FSDP].get_local_rank())


def batch_groups(mesh) -> list:
    """The process groups of the batch axes above size 1, data first: a
    sum over them is a sum over every input shard once (the ``model``
    ranks of one batch rank hold the same rows)."""
    return [mesh[a].get_group() for a in BATCH_AXES if mesh[a].size() > 1]


def context_size(mesh) -> int:
    """Ranks on the ``context`` axis (1 without a mesh): the shards one
    sequence is cut into."""
    return 1 if mesh is None else mesh[AXIS_CONTEXT].size()


def context_rank(mesh) -> int:
    """This rank's index on the ``context`` axis (0 when it is 1): it
    holds tokens ``[rank * S / C, (rank + 1) * S / C)`` of every row."""
    return 0 if mesh is None else mesh[AXIS_CONTEXT].get_local_rank()


def context_group(mesh):
    """The process group of this rank's ``context`` peers (the same batch
    rows and heads, the other shards of the sequence); None when the
    axis is 1."""
    if context_size(mesh) <= 1:
        return None
    return mesh[AXIS_CONTEXT].get_group()


def token_groups(mesh) -> list:
    """:func:`batch_groups` and the ``context`` group when it is above
    1: a sum over them is a sum over every token of the global batch
    once (JAX's ``(*BATCH_AXES, AXIS_CONTEXT)``)."""
    groups = batch_groups(mesh)
    if context_size(mesh) > 1:
        groups.append(context_group(mesh))
    return groups


def model_rank(mesh) -> int:
    """This rank's index on the ``model`` axis (0 when it is 1): the
    vocab, head and ffn shard it holds."""
    return mesh[AXIS_MODEL].get_local_rank()


def pipe_size(mesh) -> int:
    """Ranks on the ``pipe`` axis (1 without a mesh): the stages the
    layers are split over."""
    return 1 if mesh is None else mesh[AXIS_PIPE].size()


def pipe_rank(mesh) -> int:
    """This rank's stage on the ``pipe`` axis (0 when it is 1)."""
    return 0 if mesh is None else mesh[AXIS_PIPE].get_local_rank()


def pipe_group(mesh):
    """The process group of this rank's ``pipe`` peers (the same rows
    and the same ``model`` shard, the other stages of the model: a model
    rank's activations go to its own counterpart on the next stage);
    None when the axis is 1."""
    if pipe_size(mesh) <= 1:
        return None
    return mesh[AXIS_PIPE].get_group()


def stage_group(mesh):
    """The process group of the ranks that hold this rank's stage: every
    rank of its ``pipe`` coordinate (over data, fsdp, model and
    context); the default group when ``pipe`` is 1. Made once per mesh,
    every rank making every stage's group in stage order, and kept on
    the mesh object."""
    if pipe_size(mesh) <= 1:
        return None
    groups = getattr(mesh, "_stage_groups", None)
    if groups is None:
        import torch.distributed as dist
        ranks = mesh.mesh.movedim(MESH_AXES.index(AXIS_PIPE), 0)
        groups = [dist.new_group(row.reshape(-1).tolist())
                  for row in ranks]
        mesh._stage_groups = groups
    return groups[pipe_rank(mesh)]
