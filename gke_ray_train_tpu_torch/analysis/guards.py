"""Runtime guards of the training loop (counterpart of the part of
``gke_ray_train_tpu/analysis/guards.py`` that ``run_training`` uses).

- ``TRANSFER_GUARD=log|disallow`` runs the hot loop under
  ``torch.cuda.set_sync_debug_mode("warn" | "error")``: a call that makes
  the host wait for the card (``.item()``, ``float(t)``, ``.cpu()``, a
  pageable host-to-device copy, a boolean-mask index) warns or raises at
  its call site instead of silently serializing the step pipeline. The
  loop's sanctioned waits (the batched metrics fetch, the first step's
  synchronize, eval, checkpoint saves) run inside :func:`allow_transfers`.
  Two differences from JAX's ``transfer_guard_device_to_host``: the mode
  is process-wide, not thread-local, so the prefetch thread runs under
  it too (its pinned ``non_blocking`` copies, ``wait_event`` and
  ``record_stream`` do not synchronize; a pageable copy would be flagged
  as it would be on the loop's thread); and it flags host waits in both
  directions, since a synchronous host-to-device copy stalls the host
  the same way. Without CUDA the guard does nothing, as JAX's does on
  its CPU backend.
- ``DIVERGENCE_GUARD=1`` checks that every rank runs the same step
  program before the first step. A single process has nothing to compare
  (JAX returns at one process too). JAX fingerprints the lowered HLO;
  eager PyTorch lowers nothing, so the port's identity of the step
  (:func:`step_identity_text`) is the step's settings (the model config,
  the plan's fingerprint, the optimizer, LoRA and mesh), the module
  tree's names, shapes, dtypes and placements, the batch's shapes, and
  the hash of every kernel source. The ranks exchange its hash with
  ``all_gather_object``; on a mismatch every rank raises
  :class:`StepDivergenceError` with the diff against a disagreeing peer.
- ``RECOMPILE_LIMIT`` has no counterpart: the port runs eagerly and
  compiles nothing.
"""

from __future__ import annotations

import contextlib
import difflib
import glob
import hashlib
import json
import logging
import os
from typing import Optional

from gke_ray_train_tpu_torch.device import world_size

logger = logging.getLogger(__name__)


class StepDivergenceError(RuntimeError):
    """Ranks would run DIFFERENT step programs — their collectives would
    wedge (JAX's ``HloDivergenceError``)."""

# TRANSFER_GUARD mode -> torch.cuda.set_sync_debug_mode argument
_SYNC_DEBUG_MODES = {"log": "warn", "disallow": "error"}


def _knob(name: str, config: Optional[dict] = None) -> Optional[str]:
    """Config key wins over env (the precedence of every other knob)."""
    if config is not None and name in config:
        return str(config[name])
    return os.environ.get(name)


# ---------------------------------------------------------------------------
# transfer guard
# ---------------------------------------------------------------------------

def transfer_guard_mode(config: Optional[dict] = None) -> Optional[str]:
    raw = (_knob("TRANSFER_GUARD", config) or "").strip().lower()
    if raw in ("", "0", "off", "false", "allow"):
        return None
    if raw in ("log", "disallow"):
        return raw
    logger.warning("TRANSFER_GUARD=%r not recognized "
                   "(expected log|disallow|off); guard disabled", raw)
    return None


@contextlib.contextmanager
def _sync_debug_mode(mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, then the
    previous mode again; nothing without CUDA."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def transfer_guard_ctx(mode: Optional[str]):
    """Context manager enforcing ``mode`` (None, "log" or "disallow") on
    host waits for the card, process-wide."""
    if mode is None:
        return contextlib.nullcontext()
    return _sync_debug_mode(_SYNC_DEBUG_MODES[mode])


def allow_transfers():
    """The allow-list: wrap the loop's sanctioned waits on the card
    (batched metrics fetch, synchronize, eval, checkpoint save)."""
    return _sync_debug_mode("default")


# ---------------------------------------------------------------------------
# divergence guard
# ---------------------------------------------------------------------------

def divergence_guard_enabled(config: Optional[dict] = None) -> bool:
    raw = (_knob("DIVERGENCE_GUARD", config) or "").strip().lower()
    return raw not in ("", "0", "off", "false")


# ---------------------------------------------------------------------------
# the bundle run_training consumes
# ---------------------------------------------------------------------------

class RuntimeGuards:
    """Resolved guard configuration for one training run."""

    def __init__(self, *, transfer_mode: Optional[str] = None,
                 divergence: bool = False):
        self.transfer_mode = transfer_mode
        self.divergence = divergence

    @staticmethod
    def from_config(config: Optional[dict] = None) -> "RuntimeGuards":
        """Env / config resolution (config key wins); the default
        ``run_training`` builds when handed no guards."""
        return RuntimeGuards(
            transfer_mode=transfer_guard_mode(config),
            divergence=divergence_guard_enabled(config))

    def transfer_ctx(self):
        return transfer_guard_ctx(self.transfer_mode)

    def check_divergence(self, step_fn, state, batch,
                         label: str = "train_step") -> Optional[str]:
        if self.divergence and world_size() > 1:
            return check_step_agreement(step_fn, state, batch, label=label)
        return None

    def __repr__(self) -> str:  # pragma: no cover - logging nicety
        return (f"RuntimeGuards(transfer={self.transfer_mode or 'off'}, "
                f"divergence={'on' if self.divergence else 'off'})")


# ---------------------------------------------------------------------------
# the identity of the step, and its agreement across ranks
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
# the per-rank text a mismatch ships for the diff is capped
_DIFF_TEXT_CAP = 200_000


def _placement(t) -> str:
    pls = getattr(t, "placements", None)
    return "local" if pls is None else ",".join(str(p) for p in pls)


def _tensor_line(name: str, t) -> str:
    return (f"{name} {tuple(t.shape)} {str(t.dtype).replace('torch.', '')} "
            f"{_placement(t)}")


def kernel_sources_digest() -> str:
    """sha256 over every kernel source in ``csrc/`` (name and bytes)."""
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def step_identity_text(step_fn, state, batch=None) -> str:
    """The text the divergence guard hashes: ``step_fn``'s
    ``step_identity`` (its settings, set by ``train/step.py``), every
    tensor of the state (the model's parameters and buffers, the
    adapters) by name, shape, dtype and placement, the batch's keys,
    shapes and dtypes, and the kernel sources' digest. A pipeline stage,
    which holds its own layers only, lists the whole model's layers by
    their global names (:func:`_stage_lines`), so every stage of a
    healthy run hashes the same text."""
    lines = ["step " + json.dumps(getattr(step_fn, "step_identity", None),
                                  sort_keys=True, default=str)]
    params = getattr(state, "params", None)
    stage = _stage_layers(params) if params is not None else None
    if stage is not None:
        lines += _stage_lines(params, stage, state)
    else:
        if params is not None:
            for name, t in params.named_parameters():
                lines.append(_tensor_line("param " + name, t))
            for name, t in params.named_buffers():
                lines.append(_tensor_line("buffer " + name, t))
        for i, layer in enumerate(getattr(state, "lora", None) or ()):
            for target in sorted(layer):
                for k in sorted(layer[target]):
                    lines.append(_tensor_line(f"lora {i}.{target}.{k}",
                                              layer[target][k]))
    for k in sorted(batch or {}):
        v = batch[k]
        lines.append(f"batch {k} {tuple(v.shape)} "
                     f"{str(v.dtype).replace('torch.', '')}")
    lines.append("kernels " + kernel_sources_digest())
    return "\n".join(lines)


def _stage_layers(params):
    """A pipeline stage's global layer indices, None for a whole model."""
    return getattr(params.blocks, "layer_ids", None)


def _stage_lines(params, stage, state) -> list:
    """The lines of a pipeline stage's model as the whole model's: the
    root's tensors, then every layer of the model by its global name,
    each drawn from this stage's block (and adapters) at the same
    position of the block pattern. The stages of a healthy run give the
    same text; a stage whose layers differ in kind, shape, dtype or
    placement from another's does not."""
    cfg = params.cfg
    n_pat = len(cfg.block_pattern)
    lines = []
    for name, t in params.named_parameters():
        if not name.startswith("blocks."):
            lines.append(_tensor_line("param " + name, t))
    for name, t in params.named_buffers():
        if not name.startswith("blocks."):
            lines.append(_tensor_line("buffer " + name, t))
    template = {}
    lora = getattr(state, "lora", None)
    for pos, (i, blk) in enumerate(zip(stage, params.blocks)):
        template.setdefault(i % n_pat,
                            (blk, lora[pos] if lora is not None else None))
    for i in range(cfg.n_layers):
        blk, layer = template[i % n_pat]
        lines.append(f"block {i} {blk.kind}")
        for name, t in blk.named_parameters():
            lines.append(_tensor_line(f"param blocks.{i}.{name}", t))
        for name, t in blk.named_buffers():
            lines.append(_tensor_line(f"buffer blocks.{i}.{name}", t))
        for target in sorted(layer or ()):
            for k in sorted(layer[target]):
                lines.append(_tensor_line(f"lora {i}.{target}.{k}",
                                          layer[target][k]))
    return lines


def _all_gather(value):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def check_step_agreement(step_fn, state, batch=None, *,
                         label: str = "train_step") -> str:
    """Exchange this rank's step identity hash; return it when every
    rank agrees, else raise :class:`StepDivergenceError` on every rank
    with the per-rank hashes and the diff against a disagreeing peer."""
    import torch.distributed as dist
    text = step_identity_text(step_fn, state, batch)
    digest = hashlib.sha256(text.encode()).hexdigest()
    with allow_transfers():
        digests = _all_gather(digest)
        if len(set(digests)) == 1:
            logger.info("divergence guard: %d ranks agree on %s (%s)",
                        len(digests), label, digest[:12])
            return digest
        # every rank saw the same verdict: the second exchange is
        # symmetric
        texts = _all_gather(text[:_DIFF_TEXT_CAP])
    rank = dist.get_rank()
    per_rank = ", ".join(f"rank {i}: {d[:12]}" for i, d in enumerate(digests))
    peer = next((i for i, d in enumerate(digests) if d != digest), None)
    diff = list(difflib.unified_diff(
        texts[rank].splitlines(), texts[peer].splitlines(), lineterm="",
        fromfile=f"rank {rank} (this rank)", tofile=f"rank {peer}"))[:40]
    raise StepDivergenceError(
        f"ranks would run DIFFERENT {label} programs — the collectives "
        f"they launch would wedge, not train. Identities: {per_rank}.\n"
        "Likely causes: per-rank config or plan drift, a different "
        "checkout, or a different model.\n" + "\n".join(diff))
