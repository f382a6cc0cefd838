"""TensorBoard scalar reporting (counterpart of
``gke_ray_train_tpu/train/tb.py``).

``REPORT_TO: "tensorboard"`` (``ray-jobs/fine_tune_config.json``) gets
the scalar curves of the loop (loss, learning_rate, grad_norm,
eval_loss, tokens/s per card, MFU, the goodput terms) from host 0. The
writer is ``tensorboardX``'s, else ``torch.utils.tensorboard``'s (which
needs the ``tensorboard`` package); with neither it warns and does
nothing: training must not depend on a dashboard library.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


class TensorBoardWriter:
    """Host-0 scalar event writer; numeric metrics only, the rest is
    skipped. ``backend`` names the module writing ("tensorboardX",
    "torch.utils.tensorboard") or is None; ``scalars`` counts the
    scalars handed to it."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.backend: Optional[str] = None
        self.scalars = 0
        self._w = None
        try:
            from tensorboardX import SummaryWriter
            self._w = SummaryWriter(logdir)
            self.backend = "tensorboardX"
        except Exception:  # noqa: BLE001
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._w = SummaryWriter(logdir)
                self.backend = "torch.utils.tensorboard"
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "REPORT_TO=tensorboard but no writer backend "
                    "importable (%s); scalars will not be logged",
                    type(e).__name__)

    def log(self, step: int, metrics: dict) -> None:
        if self._w is None:
            return
        for k, v in metrics.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self._w.add_scalar(k, float(v), global_step=step)
            self.scalars += 1

    def log_registry(self, step: int, registry) -> None:
        """Publish ``registry.snapshot()`` as ``obs/<name>`` scalars (any
        object with a ``snapshot()`` method; a histogram entry, a dict,
        publishes its p50 / p99)."""
        if self._w is None or registry is None:
            return
        snap = registry.snapshot()
        snap.pop("labels", None)
        flat = {}
        for k, v in snap.items():
            if isinstance(v, dict):          # histogram snapshot
                flat[f"obs/{k}_p50"] = v.get("p50")
                flat[f"obs/{k}_p99"] = v.get("p99")
            else:
                flat[f"obs/{k}"] = v
        self.log(step, {k: v for k, v in flat.items() if v is not None})

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


def writer_from_config(config: dict, default_dir: str,
                       is_host0: bool = True) -> Optional[TensorBoardWriter]:
    """Honor REPORT_TO: 'tensorboard' -> a host-0 writer under
    ``default_dir``; 'none' / absent -> None."""
    report_to = str(config.get("REPORT_TO", "none")).lower()
    if report_to in ("none", "", "null"):
        return None
    if report_to != "tensorboard":
        logger.warning("REPORT_TO=%r not supported (only 'tensorboard' / "
                       "'none'); disabling reporting", report_to)
        return None
    if not is_host0:
        return None
    return TensorBoardWriter(default_dir)
