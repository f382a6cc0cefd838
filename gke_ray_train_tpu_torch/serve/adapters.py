"""Bounded multi-tenant adapter pool, the S-LoRA cache (counterpart of
``gke_ray_train_tpu/serve/adapters.py``).

A QLoRA fine-tune is an adapter factory: production traffic is many LoRA
tenants over one frozen base. The pool holds one stacked tensor per
adapter leaf, ``blocks[i][name] = {"a": [A, d_in, r], "b": [A, r,
d_out]}`` (the layout ``ops/lora_batched.py`` gathers from), with
host-side LRU admission and eviction over ``MAX_ADAPTERS`` tenant slots.
Its shape is fixed at construction; tenants churn by overwriting slots in
place.

Slot 0 is the reserved zero adapter (A = B = 0): a request without an
``adapter_id`` routes there and gets the base model's output exactly,
since adding an exact-zero delta cannot change an argmax.

Pinning: the engine ``acquire``s a tenant at admission and ``release``s
it at retirement; eviction takes only an unpinned slot, so a tenant's
weights are never overwritten while one of its requests decodes.

A pool holds the layers of its template: a pipeline stage's adapters
(``StageLora``) give a pool of the stage's layers, a whole model's give
every layer, of which a stage's decode reads its own.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.transformer import (
    Lora, StageLora, lora_layer_ids)

logger = logging.getLogger(__name__)

PoolBlocks = List[Dict[str, Dict[str, torch.Tensor]]]


class AdapterPoolPinned(RuntimeError):
    """Every resident slot is pinned by an in-flight request: the
    admission path retries next iteration."""


def _stack_template(template: Lora, n_slots: int) -> PoolBlocks:
    """A zeroed pool shaped like ``n_slots`` copies of a single adapter,
    stacked on a leading axis, on the template's device and dtype."""
    return [{name: {ab: torch.zeros((n_slots, *t.shape), dtype=t.dtype,
                                    device=t.device)
                    for ab, t in leaf.items()}
             for name, leaf in layer.items()}
            for layer in template]


class AdapterPool:
    """Bounded adapter pool with LRU eviction.

    ``loader(adapter_id) -> single adapter`` backfills misses (for example
    :func:`adapter_from_checkpoint`); without one an unknown id raises
    ``KeyError``. ``template`` is any single adapter of the right shapes
    (the just-trained ``state.lora``, ``train.lora.init_lora``'s): only
    its shapes, dtypes and device are read; ``blocks`` holds the
    template's layers."""

    def __init__(self, template: Lora, *, max_adapters: int,
                 loader: Optional[Callable[[str], Lora]] = None):
        if max_adapters < 1:
            raise ValueError(f"max_adapters={max_adapters} must be >= 1")
        self.max_adapters = int(max_adapters)
        self.n_slots = self.max_adapters + 1   # + the zero slot 0
        # slot 0 stays all-zero forever (the base tenant)
        self.blocks = StageLora(_stack_template(template, self.n_slots),
                                lora_layer_ids(template))
        self._loader = loader
        self._slots: "OrderedDict[str, int]" = OrderedDict()  # LRU order
        self._free = list(range(1, self.n_slots))
        self._pins: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @classmethod
    def from_template(cls, template: Lora, *, max_adapters: int,
                      loader: Optional[Callable[[str], Lora]] = None
                      ) -> "AdapterPool":
        return cls(template, max_adapters=max_adapters, loader=loader)

    # -- residency -----------------------------------------------------

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._slots

    def resident(self) -> Dict[str, int]:
        """adapter_id -> slot, LRU-oldest first."""
        return dict(self._slots)

    def slot_of(self, adapter_id: Optional[str]) -> Optional[int]:
        if adapter_id is None:
            return 0
        return self._slots.get(adapter_id)

    def nbytes(self) -> int:
        """Bytes the pool's stacked tensors hold."""
        return sum(t.numel() * t.element_size() for layer in self.blocks
                   for leaf in layer.values() for t in leaf.values())

    @torch.no_grad()
    def _write(self, slot: int, tree: Lora) -> None:
        """Admission-path write of one adapter into ``slot``, in place
        (never inside the decode loop). A layer count, target set or
        shape that differs from the template's fails here."""
        if len(tree) != len(self.blocks):
            raise ValueError(f"adapter has {len(tree)} layers, the pool "
                             f"{len(self.blocks)}")
        for i, (layer, pool_layer) in enumerate(zip(tree, self.blocks)):
            if set(layer) != set(pool_layer):
                raise ValueError(f"layer {i}: adapter targets "
                                 f"{sorted(layer)} != the pool's "
                                 f"{sorted(pool_layer)}")
            for name, leaf in layer.items():
                for ab, t in leaf.items():
                    dst = pool_layer[name][ab]
                    if tuple(t.shape) != tuple(dst.shape[1:]):
                        raise ValueError(
                            f"layer {i} {name}.{ab}: shape "
                            f"{tuple(t.shape)} != the pool's "
                            f"{tuple(dst.shape[1:])}")
                    dst[slot].copy_(t)

    def register(self, adapter_id: str, tree: Lora) -> int:
        """Make ``adapter_id`` resident with the given adapter. Ids are
        immutable by contract (the engine's prefix memo keys on them):
        re-registering an id raises."""
        if not adapter_id:
            raise ValueError("adapter_id must be a non-empty string")
        if adapter_id in self._slots:
            raise ValueError(
                f"adapter {adapter_id!r} already resident — adapter ids "
                "are immutable (the prefix cache keys on them); use a "
                "new id for new weights")
        slot = self._take_slot()
        self._write(slot, tree)
        self._slots[adapter_id] = slot
        return slot

    def _pinned_out(self) -> AdapterPoolPinned:
        return AdapterPoolPinned(
            f"all {self.max_adapters} adapter slots are pinned by "
            "in-flight requests — raise MAX_ADAPTERS or drain first")

    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop(0)
        for aid in self._slots:            # LRU-oldest first
            if not self._pins.get(aid):
                slot = self._slots.pop(aid)
                self.evictions += 1
                logger.info("adapter pool: evicted %r from slot %d",
                            aid, slot)
                return slot
        raise self._pinned_out()

    def acquire(self, adapter_id: Optional[str]) -> int:
        """A request's adapter slot, pinned for the request's lifetime
        (the engine calls this at admission and :meth:`release` at
        retirement). ``None`` → the zero slot, never pinned or evicted."""
        if adapter_id is None:
            return 0
        slot = self._slots.get(adapter_id)
        if slot is not None:
            self.hits += 1
            self._slots.move_to_end(adapter_id)
        else:
            if self._loader is None:
                raise KeyError(
                    f"adapter {adapter_id!r} is not resident and the "
                    "pool has no loader")
            if not self._free and not any(
                    not self._pins.get(a) for a in self._slots):
                # raise before paying the loader: the engine retries a
                # pinned-out admission every step, and a retry that loads
                # nothing must not read a checkpoint or count as a miss
                raise self._pinned_out()
            slot = self.register(adapter_id, self._loader(adapter_id))
            self.misses += 1
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1
        return slot

    def release(self, adapter_id: Optional[str]) -> None:
        if adapter_id is None:
            return
        n = self._pins.get(adapter_id, 0)
        if n <= 1:
            self._pins.pop(adapter_id, None)
        else:
            self._pins[adapter_id] = n - 1

    def stats(self) -> Dict[str, Any]:
        return {"adapter_hits": self.hits,
                "adapter_misses": self.misses,
                "adapter_evictions": self.evictions,
                "adapter_resident": len(self._slots)}


def adapter_from_checkpoint(directory: str, step: Optional[int] = None, *,
                            device: DeviceLike = None) -> Lora:
    """A trained adapter from a train-state checkpoint
    (``ckpt/manager.py``), read topology-free by ``restore_raw`` and
    placed on ``device`` (default ``cuda``). Use as an
    :class:`AdapterPool` loader: ``loader=lambda aid:
    adapter_from_checkpoint(dirs[aid])``."""
    from gke_ray_train_tpu_torch.ckpt.manager import CheckpointManager
    raw = CheckpointManager(directory).restore_raw(step)
    lora = raw.get("lora")
    if lora is None:
        raise ValueError(
            f"checkpoint at {directory} has no 'lora' subtree — was the "
            "run trained with USE_LORA/USE_QLORA?")
    dev = resolve_device(device)
    return [{name: {ab: t.to(dev) for ab, t in leaf.items()}
             for name, leaf in layer.items()} for layer in lora]
