"""Config surface: the key audit and the factories of the honoured keys
(counterpart of ``gke_ray_train_tpu/config.py``, the port's own copy).

A job config is a flat UPPER_CASE JSON (``ray-jobs/*.json``). Every key
is either honoured (in :data:`KNOWN_KEYS`) or warned about, never
silently ignored. The same key sets as the JAX package, so a config
audits alike in both; on top of that, the keys that only mean something
on a TPU mesh (:data:`TPU_ONLY_KEYS`: mesh axes, topology, the compile
cache and AOT sidecar, autotune) warn by name, because the port ignores
them. ``OVERLAP`` is the port's: the plan reads it (``plan.py``; ``xla``
is FSDP2's explicit prefetch, ``manual`` the hand-placed gathers of
``train/overlap.py``), and so are ``DCN_SYNC`` and ``DCN_COMPRESS``
(the cross-slice sums of ``manual``, ``parallel/hierarchical.py``),
which the plan reads at any world. ``ELASTIC`` and ``MIN_DEVICES`` are
the port's own (``rayint/elastic.py``). The mesh keys are the exception
under a ``torch.distributed`` world above one: there ``MESH_DATA`` /
``MESH_FSDP`` ... ``NUM_SLICES`` shape the mesh
(``rayint/elastic.py::maybe_replan``, ``MeshConfig.check_ported``); on
one card they warn and are ignored, as before.

The learning-rate schedules are plain functions of the step count, equal
to optax's at every step; the optimizers are the port's
``train/optim.py`` specs.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List

from gke_ray_train_tpu_torch.train.optim import (
    OptimizerSpec, Schedule, make_adafactor, make_optimizer, make_sgd,
    warmup_cosine_schedule)

logger = logging.getLogger(__name__)

# config keys owned by the JAX package's declarative ExecutionPlan (mesh
# topology, batch shape, donation, input pipeline, compile-once policy,
# runtime guards, serving shape, observability, autotune, kernel and
# overlap path, DCN sync, identity) — the same set as JAX's
PLAN_SCOPED_KEYS = frozenset({
    "MESH_DATA", "MESH_FSDP", "MESH_MODEL", "MESH_CONTEXT", "MESH_PIPE",
    "NUM_SLICES", "PIPE_MICROBATCHES", "PIPE_VIRTUAL_STAGES",
    "PER_DEVICE_TRAIN_BATCH_SIZE", "GRADIENT_ACCUMULATION_STEPS",
    "MAX_SEQ_LENGTH", "PACKING",
    "DONATE_STATE", "DONATE_BATCH",
    "PREFETCH_BATCHES",
    "COMPILE_CACHE", "COMPILE_CACHE_DIR", "AOT_TRAIN_STEP",
    "TRANSFER_GUARD", "RECOMPILE_LIMIT", "DIVERGENCE_GUARD",
    "MAX_BATCH", "DECODE_BUCKETS", "SERVE_QUANT",
    "MAX_ADAPTERS", "PREFIX_CACHE", "SPEC_DRAFT", "SPEC_K",
    "OBS", "OBS_DIR", "OBS_CAPTURE", "OBS_CAPTURE_BUDGET", "TRACE",
    "AUTOTUNE", "AUTOTUNE_INGEST",
    "OVERLAP", "FUSED_OPS",
    "DCN_SYNC", "DCN_COMPRESS",
    "TOPOLOGY", "BUDGET_PRESET",
})

# every key the fine-tune entry honours — the same set as JAX's
KNOWN_KEYS = frozenset({
    # model / data / output
    "MODEL_ID", "DATASET_NAME", "OUTPUT_DIR_BASE",
    "PRETRAINED_CHECKPOINT_DIR",
    "NUM_TRAIN_SAMPLES", "NUM_EVAL_SAMPLES",
    "SFT_SUBDIR_NAME", "MERGED_MODEL_SUBDIR_NAME",
    "FULL_FT_MODEL_SUBDIR_NAME",
    # LoRA / quantization
    "USE_QLORA", "LORA_ALPHA", "LORA_DROPOUT", "LORA_R",
    "LLAMA_TARGET_MODULES", "QUANT_KIND",
    "BNB_4BIT_COMPUTE_DTYPE", "BNB_4BIT_QUANT_TYPE", "USE_NESTED_QUANT",
    # optimization
    "NUM_TRAIN_EPOCHS", "LEARNING_RATE", "WEIGHT_DECAY",
    "OPTIM", "LR_SCHEDULER_TYPE", "MAX_GRAD_NORM", "WARMUP_RATIO",
    # cadences / reporting
    "LOGGING_STEPS", "SAVE_STRATEGY", "SAVE_STEPS_SFT",
    "EVALUATION_STRATEGY_SFT", "EVAL_STEPS_SFT", "REPORT_TO",
    "GROUP_BY_LENGTH",
    # inference comparison and post-train serving
    "INFERENCE", "NUM_EVAL_SAMPLES_INFERENCE",
    "MAX_NEW_GENERATION_TOKENS_INFERENCE", "SERVE_AFTER_TRAIN",
    # elastic training
    "ELASTIC", "MIN_DEVICES",
    # goodput knobs (ckpt/manager.py)
    "ASYNC_CKPT", "PEER_REPLICATION", "CKPT_COMMIT_TIMEOUT_S",
    "CKPT_STORAGE_DELAY_S",
    # autotune registry / search
    "AUTOTUNE_DIR", "AUTOTUNE_BUDGET", "AUTOTUNE_DRIFT_BAND",
    # kernelcheck
    "KERNELCHECK", "TOLERANCE_UPDATE",
    # model numerics
    "TRAIN_DTYPE", "PARAM_DTYPE", "ATTN_IMPL", "REMAT_POLICY",
    "SMOKE_TEST",
    # profiling / debug (train/profiling.py)
    "PROFILE", "PROFILE_START_STEP", "PROFILE_NUM_STEPS", "DEBUG_NANS",
}) | PLAN_SCOPED_KEYS

# keys that configure a TPU mesh or XLA and that the one-card port
# ignores; each present one warns by name
TPU_ONLY_KEYS = frozenset({
    "COMPILE_CACHE", "COMPILE_CACHE_DIR", "AOT_TRAIN_STEP", "TOPOLOGY",
    "AUTOTUNE", "AUTOTUNE_INGEST", "AUTOTUNE_DIR",
    "AUTOTUNE_BUDGET", "AUTOTUNE_DRIFT_BAND", "NUM_SLICES", "BUDGET_PRESET",
})
TPU_ONLY_PREFIXES = ("MESH_", "PIPE_")
# the mesh keys a world above one process reads (parallel/mesh.py), and
# the pipeline's (models/pipeline.py, through plan.py)
MESH_KEYS = frozenset({"MESH_DATA", "MESH_FSDP", "MESH_MODEL",
                       "MESH_CONTEXT", "MESH_PIPE", "NUM_SLICES",
                       "PIPE_MICROBATCHES", "PIPE_VIRTUAL_STAGES"})


def tpu_only_keys(config: dict, world: int = 1) -> List[str]:
    """The keys of ``config`` that only a TPU mesh or XLA reads; at a
    ``world`` above 1 the mesh and pipeline keys are the port's too."""
    return sorted(k for k in config
                  if (k in TPU_ONLY_KEYS or k.startswith(TPU_ONLY_PREFIXES))
                  and not (world > 1 and k in MESH_KEYS))


def checkpoint_knobs_from_config(config: dict) -> dict:
    """The entries' ``CheckpointManager`` knobs, config first, then the
    environment: ``ASYNC_CKPT``, ``CKPT_COMMIT_TIMEOUT_S`` and
    ``PEER_REPLICATION`` (which the manager refuses, ROADMAP queue 1
    item 8). "0", "false", "no" and "" are off."""
    def flag(key):
        return str(config.get(key, os.environ.get(key, "0"))).strip() \
            .lower() not in ("", "0", "false", "no")
    return {"async_commit": flag("ASYNC_CKPT"),
            "commit_timeout_s": float(config.get(
                "CKPT_COMMIT_TIMEOUT_S",
                os.environ.get("CKPT_COMMIT_TIMEOUT_S", "120"))),
            "peer": True if flag("PEER_REPLICATION") else None}


def audit_config(config: dict, *, known=KNOWN_KEYS,
                 extra_known=(), world: int = 1) -> list:
    """Warn about unknown keys and return them; keys starting with "_"
    are comments. TPU-only keys warn by name (the port ignores them; at
    a ``world`` above 1 it reads the mesh keys), and so does
    ``USE_NESTED_QUANT``."""
    unknown = sorted(k for k in config
                     if k not in known and k not in extra_known
                     and not k.startswith("_"))
    if unknown:
        logger.warning("config keys not recognized (ignored): %s", unknown)
    for k in tpu_only_keys(config, world):
        logger.warning("config key %s=%r configures a TPU mesh or XLA; "
                       "the port ignores it", k, config[k])
    if bool(config.get("USE_NESTED_QUANT", False)):
        logger.warning("USE_NESTED_QUANT: nested/double quantization is "
                       "not implemented; using single-level %s",
                       config.get("QUANT_KIND", "nf4"))
    return unknown


def quant_kind_from_config(config: dict, use_lora: bool) -> str:
    """QUANT_KIND, defaulting through the reference's
    BNB_4BIT_QUANT_TYPE so reference configs quantize the same way."""
    default = (config.get("BNB_4BIT_QUANT_TYPE", "nf4")
               if use_lora else "none")
    return str(config.get("QUANT_KIND", default)).lower()


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule(init, end, steps)``."""
    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return schedule


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule,
    counted from that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for s, b in zip(schedules[1:], boundaries):
            if count >= b:
                out = s(count - b)
        return out
    return schedule


def schedule_from_config(config: dict, total_steps: int) -> Schedule:
    """LR_SCHEDULER_TYPE (HF Trainer semantics): cosine (default),
    linear (decay to 0), constant, constant_with_warmup; unknown names
    warn and fall back to cosine."""
    base_lr = float(config.get("LEARNING_RATE", 2e-4))
    warmup_frac = float(config.get("WARMUP_RATIO", 0.03))
    kind = str(config.get("LR_SCHEDULER_TYPE", "cosine")).lower()
    warmup_steps = max(1, int(total_steps * warmup_frac))
    if kind == "cosine":
        return warmup_cosine_schedule(base_lr, total_steps,
                                      warmup_frac=warmup_frac)
    if kind == "linear":
        return _join([_linear(0.0, base_lr, warmup_steps),
                      _linear(base_lr, 0.0,
                              max(total_steps - warmup_steps, 1))],
                     [warmup_steps])
    if kind == "constant":
        # HF semantics: flat LR from step 0, no warmup
        return lambda count: base_lr
    if kind == "constant_with_warmup":
        return _join([_linear(0.0, base_lr, warmup_steps),
                      lambda count: base_lr], [warmup_steps])
    logger.warning("LR_SCHEDULER_TYPE=%r not recognized; using cosine", kind)
    return warmup_cosine_schedule(base_lr, total_steps,
                                  warmup_frac=warmup_frac)


def optimizer_from_config(config: dict, schedule: Callable) -> OptimizerSpec:
    """OPTIM: the adamw family (and ``adam``) -> clip + AdamW;
    ``adafactor`` -> clip + Adafactor (optax's defaults, decay rate
    ``WEIGHT_DECAY`` or none); ``sgd`` -> clip + SGD with momentum 0.9;
    unknown names warn and fall back to adamw."""
    name = str(config.get("OPTIM", "adamw")).lower()
    wd = float(config.get("WEIGHT_DECAY", 0.001))
    clip = float(config.get("MAX_GRAD_NORM", 0.3))
    if "adamw" in name or name == "adam":
        return make_optimizer(schedule, weight_decay=wd, clip_norm=clip)
    if "adafactor" in name:
        return make_adafactor(schedule, clip_norm=clip,
                              weight_decay_rate=wd or None)
    if name == "sgd":
        return make_sgd(schedule, clip_norm=clip, momentum=0.9)
    logger.warning("OPTIM=%r not recognized; using adamw", name)
    return make_optimizer(schedule, weight_decay=wd, clip_norm=clip)


def cadence_from_config(config: dict) -> dict:
    """Resolve SAVE_STRATEGY / EVALUATION_STRATEGY_SFT (HF Trainer
    semantics: "steps" | "epoch" | "no") into ``run_training``
    arguments."""
    save_strat = str(config.get("SAVE_STRATEGY", "steps")).lower()
    eval_strat = str(config.get("EVALUATION_STRATEGY_SFT", "steps")).lower()
    if save_strat not in ("steps", "epoch", "no"):
        logger.warning("SAVE_STRATEGY=%r not recognized; using 'steps'",
                       save_strat)
        save_strat = "steps"
    if eval_strat not in ("steps", "epoch", "no"):
        logger.warning("EVALUATION_STRATEGY_SFT=%r not recognized; "
                       "using 'steps'", eval_strat)
        eval_strat = "steps"
    return {
        "save_enabled": save_strat != "no",
        "ckpt_every": (int(config.get("SAVE_STEPS_SFT", 50))
                       if save_strat == "steps" else None),
        "eval_enabled": eval_strat != "no",
        "eval_every": (int(config.get("EVAL_STEPS_SFT", 50))
                       if eval_strat == "steps" else None),
        "eval_at_epoch_end": eval_strat == "epoch",
    }
