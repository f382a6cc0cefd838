from gke_ray_train_tpu_torch.ops.norms import rms_norm  # noqa: F401
from gke_ray_train_tpu_torch.ops.rope import (  # noqa: F401
    apply_rope, rope_frequencies, sinusoidal_positions)
from gke_ray_train_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF, dot_product_attention, make_attention_mask)
from gke_ray_train_tpu_torch.ops.quant import (  # noqa: F401
    QTensor, dequantize, maybe_dequantize, quantize_params, quantize_tensor)
