"""rayint/ — Ray Train style orchestration of the port's workers: the
trainer with its retry and preemption budgets (``trainer.py``), heartbeat
supervision (``supervisor.py``), elastic re-formation (``elastic.py``),
serving replicas (``serving.py``) and the worker's train context
(``context.py``)."""

from gke_ray_train_tpu_torch.rayint.trainer import (  # noqa: F401
    TorchTrainer, ScalingConfig, RunConfig, FailureConfig, Result)
from gke_ray_train_tpu_torch.rayint.context import (  # noqa: F401
    TrainContext, get_context, report)
from gke_ray_train_tpu_torch.rayint.supervisor import (  # noqa: F401
    HeartbeatBoard, HeartbeatTimeout, Supervisor, Watchdog)
from gke_ray_train_tpu_torch.rayint.serving import (  # noqa: F401
    ServeDeployment, ServeReplica)
