"""rayint/ — the worker's train context (``context.py``); the trainer,
supervisor and elastic modules come with ROADMAP queue 1 item 6."""

from gke_ray_train_tpu_torch.rayint.context import (  # noqa: F401
    TrainContext, get_context, report)
