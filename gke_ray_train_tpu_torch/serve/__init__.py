"""serve/ — the continuous-batching engine over the KV-cache step, with
the multi-tenant adapter pool and speculative decoding."""

from gke_ray_train_tpu_torch.serve.adapters import (  # noqa: F401
    AdapterPool, AdapterPoolPinned, adapter_from_checkpoint)
from gke_ray_train_tpu_torch.serve.bucketing import (  # noqa: F401
    form_prompt_buffer, pick_bucket, prompt_bucket, truncate_prompt)
from gke_ray_train_tpu_torch.serve.engine import (  # noqa: F401
    BatchEngine, Completion, Request, post_train_smoke, serve_plan)
