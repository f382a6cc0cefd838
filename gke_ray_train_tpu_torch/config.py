"""Job-config resolution (counterpart of the stdlib part of
``gke_ray_train_tpu/config.py``): the save / eval cadence. The rest of
the JAX module (config loading, the optimizer from a config) belongs to
the port's entry script, ROADMAP queue 1 item 3.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


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
