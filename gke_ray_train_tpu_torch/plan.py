"""The ported fields of the execution plan (counterpart of the serving
part and of ``grad_accum`` in ``gke_ray_train_tpu/plan.py::ExecutionPlan``).

Five knobs, read from the same environment / config keys as the JAX
package: ``MAX_BATCH`` (slots of the continuous-batching engine),
``DECODE_BUCKETS`` (request length buckets), ``PREFIX_CACHE``
(whole-prompt prefill reuse), ``GRADIENT_ACCUMULATION_STEPS``
(microbatches per optimizer step) and ``FUSED_OPS`` (the train step's
fused rms_norm / q-k RoPE kernels, and the fused cross-entropy where the
config has no logit softcap).
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
    "grad_accum": "GRADIENT_ACCUMULATION_STEPS",
    "fused_ops": "FUSED_OPS",
}


def _coerce(field: str, value: Any) -> Any:
    """One coercion for env strings, JSON values and python kwargs."""
    if field in ("max_batch", "grad_accum"):
        try:
            return int(value)
        except (TypeError, ValueError):
            raise PlanError(f"{field}={value!r} is not an int") from None
    if field in ("prefix_cache", "fused_ops"):
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
    # microbatches accumulated per optimizer step (train/step.py)
    grad_accum: int = 1
    # the train step's rms_norms and q/k RoPE through the fused kernels
    # (ops/fused_norm_rope.py) and, where the config has no logit
    # softcap, its loss through the fused cross-entropy (ops/fused_ce.py)
    fused_ops: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise PlanError(f"max_batch={self.max_batch} must be >= 1")
        if self.grad_accum < 1:
            raise PlanError(f"grad_accum={self.grad_accum} must be >= 1")
        self.bucket_list()

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
        """Stable 16-hex-char identity of the plan."""
        return hashlib.sha256(json.dumps(
            dataclasses.asdict(self), sort_keys=True).encode()
        ).hexdigest()[:16]

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
