"""Training FLOPs and the card's peak rate (counterpart of the MFU part
of ``gke_ray_train_tpu/train/metrics.py``).

MFU = tokens/s x ``train_flops_per_token`` / ``peak_flops_per_device``,
the formula ``bench.py`` uses.
"""

from __future__ import annotations

import logging

from gke_ray_train_tpu_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)

# dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts, no
# sparsity), by a lower-case substring of torch.cuda.get_device_name()
PEAK_FLOPS = {
    "h100": 989e12,
}
DEFAULT_PEAK_FLOPS = 989e12


def peak_flops_per_device(device_name: str) -> float:
    """The bf16 peak of the card named ``device_name``; an unknown card
    warns once and gets the H100's rate."""
    kind = device_name.lower()
    for k, v in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if k in kind:
            return v
    from gke_ray_train_tpu_torch.logging_utils import warn_once
    warn_once(logger, ("peak_flops", kind),
              "device %r matches no PEAK_FLOPS entry; MFU uses %.0f "
              "TFLOP/s", device_name, DEFAULT_PEAK_FLOPS / 1e12)
    return DEFAULT_PEAK_FLOPS


def train_flops_per_token(cfg: ModelConfig, seq_len: int, *,
                          trainable: str = "full") -> float:
    """Dense matmuls: forward 2N plus backward 4N (2N weight grads + 2N
    activation grads), plus 12 * n_layers * d_attn * seq for attention
    (QK^T and PV, forward and backward), halved for the causal mask.

    ``trainable="lora"``: the frozen base skips its weight-grad products
    (4N instead of 6N; the adapters' FLOPs are negligible at r << d).
    Recomputation under remat is not counted (the usual MFU
    convention). MoE configs bill their active params (router and top-k
    experts, ``ModelConfig.active_param_count``), as the JAX package
    does."""
    n = cfg.active_param_count()
    dense = (4.0 if trainable == "lora" else 6.0) * n
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    attn = 12 * cfg.n_layers * d_attn * seq_len * 0.5
    return dense + attn
