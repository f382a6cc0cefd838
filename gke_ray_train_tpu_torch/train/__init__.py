"""train/ — the fine-tuning step: LoRA adapters, optimizer and schedule,
the microbatched train step and the eval step."""

from gke_ray_train_tpu_torch.train.lora import (  # noqa: F401
    LoraConfig, init_lora, merge_lora)
from gke_ray_train_tpu_torch.train.metrics import (  # noqa: F401
    peak_flops_per_device, train_flops_per_token)
from gke_ray_train_tpu_torch.train.optim import (  # noqa: F401
    AdamW, OptimizerSpec, default_weight_decay_mask, make_optimizer,
    warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.step import (  # noqa: F401
    TrainState, make_eval_step, make_train_state, make_train_step,
    token_nll)
