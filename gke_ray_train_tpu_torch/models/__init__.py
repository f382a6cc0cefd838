from gke_ray_train_tpu_torch.models.config import (  # noqa: F401
    ModelConfig, llama2_7b, llama2_13b, llama2_70b, llama3_8b, llama3_70b,
    mistral_7b, mixtral_8x7b, gemma2_9b, qwen2_7b, basic_lm, tiny, PRESETS,
    PROJ_TARGETS, preset_for_model_id)
from gke_ray_train_tpu_torch.models.transformer import (  # noqa: F401
    Block, Transformer, forward, init_params)
from gke_ray_train_tpu_torch.models.decode import greedy_generate  # noqa: F401
from gke_ray_train_tpu_torch.models.qinit import (  # noqa: F401
    init_quantized_params)
from gke_ray_train_tpu_torch.models.kvcache import (  # noqa: F401
    forward_step, greedy_generate_cached, init_cache)
