"""The ported fields of the execution plan (counterpart of the serving
part, ``grad_accum``, the input pipeline and the runtime guards of
``gke_ray_train_tpu/plan.py::ExecutionPlan``).

Twenty-one knobs, read from the same environment / config keys as the
JAX package: ``MAX_BATCH`` (slots of the continuous-batching engine),
``DECODE_BUCKETS`` (request length buckets), ``PREFIX_CACHE``
(whole-prompt prefill reuse), ``SERVE_QUANT`` (the served weights'
encoding), ``MAX_ADAPTERS`` (tenant slots of the adapter pool),
``SPEC_DRAFT`` / ``SPEC_K`` (speculative decoding),
``PER_DEVICE_TRAIN_BATCH_SIZE``,
``MAX_SEQ_LENGTH`` and ``PACKING`` (the train batch's shape),
``GRADIENT_ACCUMULATION_STEPS`` (microbatches per optimizer step),
``PIPE_MICROBATCHES`` / ``PIPE_VIRTUAL_STAGES`` (the pipeline's
microbatches in each of them, 0 for one a hop, and its groups a stage,
``models/pipeline.py``), ``FUSED_OPS`` (the train step's
fused rms_norm / q-k RoPE kernels, and the fused cross-entropy where the
config has no logit softcap), ``OVERLAP`` (how the train step's fsdp
gathers meet its compute: ``off``, ``xla`` FSDP2's explicit prefetch,
``parallel/sharding.py``, or ``manual`` the hand-placed double-buffered
gathers of ``train/overlap.py``; :meth:`ExecutionPlan.check_mesh` refuses
``manual`` on a mesh with ``model``, ``context`` or ``pipe`` above 1, in
the JAX plan's words), ``NUM_SLICES`` (the slices the ``data`` axis
spans, ``parallel/mesh.py``; the entries set it from the mesh they
build) and ``DCN_SYNC`` / ``DCN_COMPRESS`` (the cross-slice gradient
sums of ``manual``, ``parallel/hierarchical.py``, with JAX's rules: a
``hier`` plan on one slice is downgraded to ``flat`` with a warning and
fingerprints as ``flat``, ``hier`` needs ``manual`` and ``bf16`` needs
``hier``), ``PREFETCH_BATCHES``
(the loop's prefetch depth), ``TRANSFER_GUARD`` and
``DIVERGENCE_GUARD`` (the loop's runtime guards,
``analysis/guards.py``). The last three are operational: they
change no result, so :meth:`ExecutionPlan.fingerprint` leaves them out.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple


class PlanError(ValueError):
    """An ExecutionPlan field failed validation."""


CONFIG_KEYS: Dict[str, str] = {
    "max_batch": "MAX_BATCH",
    "decode_buckets": "DECODE_BUCKETS",
    "prefix_cache": "PREFIX_CACHE",
    "serve_quant": "SERVE_QUANT",
    "max_adapters": "MAX_ADAPTERS",
    "spec_draft": "SPEC_DRAFT",
    "spec_k": "SPEC_K",
    "per_device_batch": "PER_DEVICE_TRAIN_BATCH_SIZE",
    "grad_accum": "GRADIENT_ACCUMULATION_STEPS",
    "pipe_microbatches": "PIPE_MICROBATCHES",
    "pipe_virtual_stages": "PIPE_VIRTUAL_STAGES",
    "max_seq_len": "MAX_SEQ_LENGTH",
    "packing": "PACKING",
    "fused_ops": "FUSED_OPS",
    "overlap": "OVERLAP",
    "num_slices": "NUM_SLICES",
    "dcn_sync": "DCN_SYNC",
    "dcn_compress": "DCN_COMPRESS",
    "prefetch": "PREFETCH_BATCHES",
    "transfer_guard": "TRANSFER_GUARD",
    "divergence_guard": "DIVERGENCE_GUARD",
}

_TRANSFER_GUARD_MODES = (None, "log", "disallow")

SPEC_DRAFT_MODES = ("none", "self", "distilled")

# how the train step's fsdp gathers meet its compute (JAX plan.py:69)
OVERLAP_MODES = ("off", "xla", "manual")

# the cross-slice gradient sums and their compression (JAX plan.py:73-74)
DCN_SYNC_MODES = ("flat", "hier")
DCN_COMPRESS_MODES = ("none", "bf16")


def _serve_quant_kinds() -> Tuple[str, ...]:
    """``ops/quant.py`` owns the serving quantization vocabulary; imported
    at validation time only."""
    from gke_ray_train_tpu_torch.ops.quant import SERVE_QUANT_KINDS
    return tuple(SERVE_QUANT_KINDS)

# knobs that change how a run executes, never what it computes: kept out
# of the fingerprint, as the JAX package keeps them out of its compile
# fingerprints
OPERATIONAL_FIELDS = ("prefetch", "transfer_guard", "divergence_guard")


def _coerce(field: str, value: Any) -> Any:
    """One coercion for env strings, JSON values and python kwargs."""
    if field in ("max_batch", "per_device_batch", "grad_accum",
                 "max_seq_len", "prefetch", "max_adapters", "spec_k",
                 "pipe_microbatches", "pipe_virtual_stages",
                 "num_slices"):
        try:
            return int(value)
        except (TypeError, ValueError):
            raise PlanError(f"{field}={value!r} is not an int") from None
    if field == "transfer_guard":
        v = (str(value).strip().lower() if value is not None else None)
        if v in ("", "0", "off", "false", "allow", None):
            return None
        return v
    if field in ("serve_quant", "spec_draft", "dcn_compress"):
        # "", "0", "false" and "off" spell the disabled arm (the env
        # dialect needs one: ``env SPEC_DRAFT= python ...``)
        v = str(value).strip().lower()
        return "none" if v in ("", "0", "false", "no", "off") else v
    if field == "overlap":
        # "", "0", "false" and "no" mean the plain step (JAX's dialect:
        # ``env OVERLAP= python ...``)
        v = str(value).strip().lower()
        return "off" if v in ("", "0", "false", "no") else v
    if field == "dcn_sync":
        v = str(value).strip().lower()
        return "flat" if v in ("", "0", "false", "no", "off") else v
    if field in ("prefix_cache", "packing", "fused_ops",
                 "divergence_guard"):
        if isinstance(value, (bool, int, float)):
            return bool(value)
        s = str(value).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off", ""):
            return False
        raise PlanError(f"{field}={value!r} is not a boolean")
    if field == "decode_buckets":
        toks = (value if isinstance(value, (list, tuple))
                else str(value).split(","))
        try:
            vals = sorted({int(str(t).strip()) for t in toks
                           if str(t).strip()})
        except ValueError:
            raise PlanError(f"decode_buckets={value!r} is not a "
                            "comma-separated int list") from None
        return ",".join(str(v) for v in vals)
    raise PlanError(f"unknown plan field {field!r}; valid: "
                    f"{sorted(CONFIG_KEYS)}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    # slot count of the continuous-batching engine: every decode step
    # runs at exactly [max_batch, 1]
    max_batch: int = 8
    # request length buckets (comma string, normalized ascending): a
    # request lands in the smallest bucket >= prompt_len + max_new.
    # 128-multiples keep the flash-prefill gate (models/kvcache.py) open.
    decode_buckets: str = "256,512"
    # whole-prompt prefix reuse: an identical (bucket, prompt)
    # re-submission reuses the first request's prefilled cache row and
    # first token instead of prefilling again
    prefix_cache: bool = False
    # weight quantization the engine serves: "none" | "int8" | "nf4"
    serve_quant: str = "none"
    # tenant slots of the adapter pool (serve/adapters.py), beside the
    # reserved zero adapter at slot 0
    max_adapters: int = 8
    # speculative decoding: "none" | "self" (the target drafts for
    # itself) | "distilled" (a small draft model handed to the engine);
    # spec_k draft tokens proposed per iteration
    spec_draft: str = "none"
    spec_k: int = 4
    # the train batch: rows per device and microbatch, sequence length,
    # and whether rows are packed (data/packing.py)
    per_device_batch: int = 2
    max_seq_len: int = 1024
    packing: bool = False
    # microbatches accumulated per optimizer step (train/step.py)
    grad_accum: int = 1
    # on a pipelined mesh: the pipe microbatches of each of them (0 = one
    # a hop, pipe_virtual_stages x pipe) and the groups a stage holds
    # (models/pipeline.py)
    pipe_microbatches: int = 0
    pipe_virtual_stages: int = 1
    # the train step's rms_norms and q/k RoPE through the fused kernels
    # (ops/fused_norm_rope.py) and, where the config has no logit
    # softcap, its loss through the fused cross-entropy (ops/fused_ce.py)
    fused_ops: bool = False
    # how the train step's fsdp gathers meet its compute: "off" (FSDP2's
    # own schedule), "xla" (FSDP2's explicit prefetch of the next block
    # in the forward and the previous one in the backward,
    # parallel/sharding.py; the numbers are off's) or "manual" (the
    # hand-placed double-buffered gathers of train/overlap.py, data /
    # fsdp meshes only: check_mesh)
    overlap: str = "off"
    # the slices the data axis spans (parallel/mesh.py) and, under
    # "manual", how a gradient crosses them (parallel/hierarchical.py):
    # "flat" the full payload, "hier" the intra-slice scattered shard;
    # "bf16" casts the hier hop, with error feedback across the
    # microbatches (not bit for bit)
    num_slices: int = 1
    dcn_sync: str = "flat"
    dcn_compress: str = "none"
    # queue depth of the loop's asynchronous input pipeline
    # (data/prefetch.py); 0 = synchronous
    prefetch: int = 2
    # runtime guards of the loop (analysis/guards.py)
    transfer_guard: Optional[str] = None      # None | "log" | "disallow"
    divergence_guard: bool = False

    def __post_init__(self):
        if self.num_slices < 1:
            raise PlanError(f"num_slices={self.num_slices} must be >= 1")
        if self.max_batch < 1:
            raise PlanError(f"max_batch={self.max_batch} must be >= 1")
        for field in ("per_device_batch", "grad_accum", "max_seq_len",
                      "pipe_virtual_stages", "max_adapters", "spec_k"):
            if getattr(self, field) < 1:
                raise PlanError(f"{field}={getattr(self, field)} must be "
                                ">= 1")
        for field in ("prefetch", "pipe_microbatches"):
            if getattr(self, field) < 0:
                raise PlanError(f"{field}={getattr(self, field)} must be "
                                ">= 0")
        if self.transfer_guard not in _TRANSFER_GUARD_MODES:
            raise PlanError(
                f"transfer_guard={self.transfer_guard!r} not in "
                f"{_TRANSFER_GUARD_MODES}")
        self.bucket_list()
        if self.serve_quant not in _serve_quant_kinds():
            raise PlanError(f"serve_quant={self.serve_quant!r} not in "
                            f"{_serve_quant_kinds()}")
        if self.spec_draft not in SPEC_DRAFT_MODES:
            raise PlanError(f"spec_draft={self.spec_draft!r} not in "
                            f"{SPEC_DRAFT_MODES}")
        if self.overlap not in OVERLAP_MODES:
            raise PlanError(f"overlap={self.overlap!r} not in "
                            f"{OVERLAP_MODES}")
        if self.dcn_sync not in DCN_SYNC_MODES:
            raise PlanError(f"dcn_sync={self.dcn_sync!r} not in "
                            f"{DCN_SYNC_MODES}")
        if self.dcn_compress not in DCN_COMPRESS_MODES:
            raise PlanError(f"dcn_compress={self.dcn_compress!r} not in "
                            f"{DCN_COMPRESS_MODES}")
        if self.dcn_sync == "hier" and self.num_slices <= 1:
            # a loud no-op, not a refusal (JAX plan.py:339-358): an
            # elastic replan that leaves one slice keeps its
            # DCN_SYNC=hier env; the downgraded plan fingerprints as flat
            import logging
            log = logging.getLogger(__name__)
            log.warning(
                "DCN_SYNC=hier on a single-slice plan (num_slices=1) is "
                "a no-op — downgrading to flat (no DCN hop to shrink)")
            object.__setattr__(self, "dcn_sync", "flat")
            if self.dcn_compress != "none":
                log.warning(
                    "DCN_COMPRESS=%s downgraded to none with it (it "
                    "compresses the hier DCN hop)", self.dcn_compress)
                object.__setattr__(self, "dcn_compress", "none")
        if self.dcn_sync == "hier" and self.overlap != "manual":
            raise PlanError(
                "dcn_sync='hier' needs overlap='manual' — the "
                "hierarchical reduction is hand-placed by the manual "
                "pipeline (train/overlap.py); the off and xla paths' "
                "gradient sums cannot be decomposed from outside")
        if self.dcn_compress != "none" and self.dcn_sync != "hier":
            raise PlanError(
                f"dcn_compress={self.dcn_compress!r} compresses the "
                "hier cross-slice hop; set DCN_SYNC=hier (compressing "
                "a full-payload flat hop is not supported)")

    def check_mesh(self, mesh, n_devices: int) -> "ExecutionPlan":
        """Raise :class:`PlanError` where ``overlap`` cannot run on
        ``mesh`` (a ``parallel/mesh.py::MeshConfig``) over ``n_devices``
        ranks, in the JAX plan's words (its :367-389): ``manual`` places
        the fsdp gathers by hand and needs ``model``, ``context`` and
        ``pipe`` of 1. A ``-1`` fill is resolved against ``n_devices``
        first, so a fill that resolves to 1 is a data / fsdp mesh; one
        that cannot be resolved keeps its raw value and is refused.
        Returns ``self``."""
        if self.overlap != "manual":
            return self
        try:
            mesh = mesh.resolve(n_devices)
        except ValueError:
            pass
        for axis in ("model", "context", "pipe"):
            size = getattr(mesh, axis)
            if size != 1:
                raise PlanError(
                    f"overlap='manual' supports data/fsdp meshes "
                    f"only; {axis}={size} — use "
                    "overlap='xla' (latency-hiding scheduler) on "
                    "structural-axis topologies")
        return self

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "ExecutionPlan":
        """From the flat UPPER_CASE dialect; unknown keys are ignored."""
        kw = {field: _coerce(field, config[key])
              for field, key in CONFIG_KEYS.items()
              if config.get(key) is not None}
        return cls(**kw)

    @classmethod
    def from_kwargs(cls, **kwargs: Any) -> "ExecutionPlan":
        return cls(**{k: _coerce(k, v) for k, v in kwargs.items()})

    @classmethod
    def resolve(cls, config: Optional[Mapping[str, Any]] = None,
                env: Optional[Mapping[str, str]] = None,
                **overrides: Any) -> "ExecutionPlan":
        """Env dialect overlaid by the config dialect, then kwarg
        overrides — the JAX package's precedence."""
        merged: Dict[str, Any] = dict(env if env is not None else os.environ)
        for k, v in (config or {}).items():
            if v is not None:
                merged[k] = v
        plan = cls.from_config(merged)
        if overrides:
            plan = dataclasses.replace(
                plan, **{k: _coerce(k, v) for k, v in overrides.items()})
        return plan

    def fingerprint(self) -> str:
        """Stable 16-hex-char identity of what the plan computes: every
        field but the :data:`OPERATIONAL_FIELDS`."""
        fields = {k: v for k, v in dataclasses.asdict(self).items()
                  if k not in OPERATIONAL_FIELDS}
        return hashlib.sha256(json.dumps(
            fields, sort_keys=True).encode()).hexdigest()[:16]

    def runtime_guards(self):
        """The resolved guard bundle ``run_training`` consumes."""
        from gke_ray_train_tpu_torch.analysis.guards import RuntimeGuards
        return RuntimeGuards(transfer_mode=self.transfer_guard,
                             divergence=self.divergence_guard)

    def bucket_list(self) -> Tuple[int, ...]:
        """``decode_buckets`` parsed to ascending unique ints."""
        try:
            vals = tuple(sorted({int(tok) for tok in
                                 str(self.decode_buckets).split(",")
                                 if str(tok).strip()}))
        except ValueError:
            raise PlanError(
                f"decode_buckets={self.decode_buckets!r} is not a "
                "comma-separated int list") from None
        if not vals or any(v < 1 for v in vals):
            raise PlanError(f"decode_buckets={self.decode_buckets!r} "
                            "must name at least one length >= 1")
        return vals


def model_findings(cfg, *, model: int, pipe: int = 1,
                   virtual: int = 1) -> list:
    """Why ``cfg`` (a ``ModelConfig``) cannot tile a ``model`` axis of
    ``model`` ranks, or a ``pipe`` axis of ``pipe`` stages at ``virtual``
    groups a stage, in the JAX plan's words (``ExecutionPlan.
    model_findings``): every parameter dim its spec puts on ``model``
    must divide by it, and so must ``n_heads`` and ``n_kv_heads``; the
    repeats of the block pattern must divide by ``pipe × virtual``. Empty
    when it tiles; read from the config alone, before any weight is
    built."""
    out = []
    if pipe > 1 and cfg.n_repeats % (pipe * virtual):
        out.append(
            f"n_repeats={cfg.n_repeats} is not divisible by pipe axis x "
            f"virtual stages ({pipe} x {virtual})")
    if model <= 1:
        return out
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    from gke_ray_train_tpu_torch.parallel.mesh import AXIS_MODEL
    from gke_ray_train_tpu_torch.parallel.sharding import param_specs
    hd = cfg.resolved_head_dim
    shapes = dict(proj_shapes(cfg))
    shapes.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                  bv=(cfg.n_kv_heads * hd,),
                  embed=(cfg.vocab_size, cfg.d_model),
                  lm_head=(cfg.d_model, cfg.vocab_size))
    for name, spec in param_specs(cfg).items():
        shape = shapes.get(name)
        if shape is None or AXIS_MODEL not in spec:
            continue
        d = spec.index(AXIS_MODEL)
        if shape[d] % model:
            out.append(
                f"param {name} dim {d} (size {shape[d]}) is not divisible "
                f"by mesh axes ('{AXIS_MODEL}',) (size {model})")
    for field in ("n_heads", "n_kv_heads"):
        heads = getattr(cfg, field)
        if heads % model:
            out.append(
                f"{field}={heads} is not divisible by the model axis "
                f"(size {model}) — attention heads cannot tile the "
                "tensor-parallel axis")
    return out


def context_findings(cfg, *, context: int, max_seq_len: int) -> list:
    """Why ``cfg`` cannot run sequences of ``max_seq_len`` tokens sharded
    over a ``context`` axis of ``context`` ranks; empty when it can (or
    ``context`` is 1). JAX's finding (:693): the axis must divide the
    length. The port's own: each shard's ``max_seq_len / context`` tokens
    must be a multiple of 128 for the flash kernels, since the dense
    fallback of an unaligned length (``models/transformer.py::
    resolve_seq_impl``) is not available at a context above 1; and
    ``attn_impl`` must be ``"ring"`` or ``"a2a"`` (``"auto"`` resolves
    to the flash kernel, which would drop attention across the
    shards)."""
    if context <= 1:
        return []
    out = []
    if max_seq_len % context:
        out.append(f"max_seq_len={max_seq_len} is not divisible by the "
                   f"context axis (size {context})")
    elif (max_seq_len // context) % 128:
        out.append(
            f"max_seq_len={max_seq_len} over the context axis (size "
            f"{context}) gives shards of {max_seq_len // context} tokens, "
            "not a multiple of 128: the flash kernels need one, and the "
            "dense fallback is not available at context > 1")
    if cfg.attn_impl not in ("ring", "a2a"):
        out.append(f"attn_impl={cfg.attn_impl!r} at context={context} "
                   "would drop attention across the sequence shards; set "
                   "ATTN_IMPL to 'ring' or 'a2a'")
    return out


# ---------------------------------------------------------------------------
# elastic replan: re-resolve the mesh against a changed pool of ranks
# ---------------------------------------------------------------------------

def replan(mesh, n_devices: int, *, chips: int, per_device_batch: int,
           model_cfg=None, preserve_global_batch: bool = True):
    """The mesh and per-device batch for ``n_devices`` surviving ranks
    (counterpart of ``gke_ray_train_tpu/plan.py::replan``, whose plan
    carries the mesh axes and its topology's chip count; here the
    declared ``parallel/mesh.py::MeshConfig``, the pool ``chips`` it was
    declared for and the per-device batch). Returns ``(MeshConfig,
    per_device_batch)``.

    The JAX package's rules: the structural axes (model, context, pipe)
    are never reflowed, and a pool that cannot tile them raises
    :class:`PlanError`; data and fsdp reflow, preferring the assignment
    closest to the declared data:fsdp ratio (ties: larger fsdp); whole-
    slice evictions keep ``num_slices`` in proportion, anything else
    collapses to one slice; the global batch is kept when it divides
    evenly over the new data-parallel width. With ``model_cfg`` each
    candidate must also tile the model (:func:`model_findings`). A pool
    equal to ``chips`` returns the declared mesh resolved."""
    import math

    if n_devices < 1:
        raise PlanError(f"replan: n_devices={n_devices} must be >= 1")
    try:
        base = mesh.resolve(chips)
    except ValueError as e:
        raise PlanError("replan: the declared plan does not tile its "
                        f"own topology: {e}") from None
    if n_devices == chips:
        return base, per_device_batch
    structural = base.model * base.context * base.pipe
    if n_devices % structural:
        raise PlanError(
            f"replan: {n_devices} surviving devices cannot tile the "
            f"structural axes (model={base.model} x "
            f"context={base.context} x pipe={base.pipe} = "
            f"{structural}); structural axes are never reflowed — only "
            "data/fsdp")
    remaining = n_devices // structural
    global_rows = per_device_batch * base.data * base.fsdp
    ratio0 = math.log(base.data / base.fsdp)
    candidates = sorted(
        ((d, remaining // d) for d in range(1, remaining + 1)
         if remaining % d == 0),
        key=lambda df: (abs(math.log(df[0] / df[1]) - ratio0), -df[1]))
    if base.num_slices > 1 and (base.num_slices * n_devices) % chips == 0:
        surviving_slices = max(base.num_slices * n_devices // chips, 1)
    else:
        surviving_slices = 1
    rejections: list = []
    for data, fsdp in candidates:
        slices = surviving_slices if data % surviving_slices == 0 else 1
        pdb = per_device_batch
        if preserve_global_batch and global_rows % (data * fsdp) == 0:
            pdb = max(global_rows // (data * fsdp), 1)
        cand = dataclasses.replace(base, data=data, fsdp=fsdp,
                                   num_slices=slices)
        findings = (model_findings(model_cfg, model=cand.model,
                                   pipe=cand.pipe)
                    if model_cfg is not None else [])
        if not findings:
            return cand, pdb
        rejections.extend(f"data={data} fsdp={fsdp}: {m}"
                          for m in findings[:2])
    raise PlanError(
        f"replan: no feasible data/fsdp assignment on {n_devices} "
        f"devices (structural axes model={base.model} "
        f"context={base.context} pipe={base.pipe} kept): "
        + "; ".join(rejections[:6]))
