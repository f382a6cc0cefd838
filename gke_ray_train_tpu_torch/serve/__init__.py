"""serve/ — the continuous-batching engine over the KV-cache step."""

from gke_ray_train_tpu_torch.serve.bucketing import (  # noqa: F401
    form_prompt_buffer, pick_bucket, prompt_bucket, truncate_prompt)
from gke_ray_train_tpu_torch.serve.engine import (  # noqa: F401
    BatchEngine, Completion, Request, serve_plan)
