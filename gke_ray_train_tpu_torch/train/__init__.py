"""train/ — the fine-tuning step (LoRA adapters, optimizer and schedule,
the microbatched train step and the eval step), the loop around it
(``loop.py::run_training``) with its meter and goodput ledger
(``metrics.py``), the eval walk, preemption, TensorBoard and the
profiler hooks."""

from gke_ray_train_tpu_torch.train.evaluate import (  # noqa: F401
    sharded_eval_loss, sharded_eval_sums)
from gke_ray_train_tpu_torch.train.lora import (  # noqa: F401
    LoraConfig, init_lora, merge_lora)
from gke_ray_train_tpu_torch.train.metrics import (  # noqa: F401
    ThroughputMeter, peak_flops_per_device, train_flops_per_token)
from gke_ray_train_tpu_torch.train.optim import (  # noqa: F401
    SGD, Adafactor, AdamW, OptimizerSpec, default_weight_decay_mask,
    make_adafactor, make_optimizer, make_sgd, warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.step import (  # noqa: F401
    TrainState, make_eval_step, make_train_state, make_train_step,
    token_nll)
