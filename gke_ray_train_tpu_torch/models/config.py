"""Model configuration — one config dataclass drives every model family.

A copy of ``gke_ray_train_tpu/models/config.py``: the same fields, the
same defaults and the same presets (a test holds the two equal), so a
configuration means one model in both packages. The one difference is
``resolved_attn_impl``, which resolves ``"auto"`` by the device the
tensors lie on instead of by the JAX backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# The seven projection matrices of every decoder block — the canonical
# target list for LoRA adapters.
PROJ_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    max_seq_len: int = 2048
    norm_eps: float = 1e-5

    # positional encoding
    positional: str = "rope"                # "rope" | "sinusoidal"
    rope_theta: float = 10000.0
    # llama-3.1 NTK-by-parts params; dicts are normalized to sorted
    # (key, value) tuples in __post_init__ so the config stays hashable
    rope_scaling: Optional[object] = None

    # block structure; n_layers must divide by len(block_pattern).
    # "global" = full causal attention, "sliding" = windowed causal.
    block_pattern: Tuple[str, ...] = ("global",)
    sliding_window: Optional[int] = None

    activation: str = "silu"                # "silu" | "gelu_tanh"

    # Mixture-of-Experts (ops/moe.py): 0 is a dense MLP
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    tie_embeddings: bool = False
    embed_scale: bool = False               # x *= sqrt(d_model) after embed
    attn_qkv_bias: bool = False             # Qwen-2: bias on q/k/v proj only
    norm_scale_plus_one: bool = False       # Gemma (1 + scale) RMSNorm
    post_block_norm: bool = False           # Gemma-2 post-attn/post-mlp norms
    attn_softcap: Optional[float] = None    # Gemma-2: 50.0
    logit_softcap: Optional[float] = None   # Gemma-2: 30.0
    attn_scale: Optional[float] = None      # override head_dim**-0.5

    # numerics / execution
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"              # "full" | "dots"
    attn_impl: str = "auto"     # "auto" | "xla" | "flash" | "ring" | "a2a"
    # "auto" resolves by device: the flash kernel on CUDA, the dense
    # ("xla") path on the CPU
    pipe_virtual: int = 1

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))
        if isinstance(self.block_pattern, list):
            object.__setattr__(self, "block_pattern",
                               tuple(self.block_pattern))
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"n_layers={self.n_layers} not divisible by block pattern "
                f"length {len(self.block_pattern)}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        unknown = set(self.block_pattern) - {"global", "sliding"}
        if unknown:
            raise ValueError(f"unknown block kinds {unknown}; "
                             "valid: global, sliding")
        if "sliding" in self.block_pattern and self.sliding_window is None:
            raise ValueError("block_pattern contains 'sliding' but "
                             "sliding_window is None — that would silently "
                             "run full global attention")
        if self.attn_impl not in ("auto", "xla", "flash", "ring", "a2a"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.pipe_virtual < 1:
            raise ValueError(f"pipe_virtual={self.pipe_virtual} must be >= 1")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ModelConfig":
        d = dict(d)
        if isinstance(d.get("rope_scaling"), list):
            d["rope_scaling"] = tuple(
                tuple(x) for x in d["rope_scaling"])
        return ModelConfig(**d)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def resolved_attn_impl(self, device: torch.device) -> str:
        """``attn_impl`` with ``"auto"`` resolved for tensors on
        ``device``: the flash kernel on CUDA, the dense path on the CPU."""
        if self.attn_impl != "auto":
            return self.attn_impl
        return "flash" if torch.device(device).type == "cuda" else "xla"

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def param_count(self) -> int:
        """Exact total param count (for MoE every expert and the router
        count). FLOP counts use ``active_param_count``."""
        return self._count_params(self.n_experts)

    def active_param_count(self) -> int:
        """Params a token touches: for MoE the router and the top-k
        experts only, the count ``train/metrics.py`` bills FLOPs for."""
        return self._count_params(min(self.expert_top_k, self.n_experts)
                                  if self.n_experts else 0)

    def _count_params(self, experts_counted: int) -> int:
        hd = self.resolved_head_dim
        attn = (self.d_model * self.n_heads * hd
                + 2 * self.d_model * self.n_kv_heads * hd
                + self.n_heads * hd * self.d_model)
        if self.attn_qkv_bias:
            attn += self.n_heads * hd + 2 * self.n_kv_heads * hd
        ffn = 3 * self.d_model * self.d_ff
        mlp = (self.d_model * self.n_experts + experts_counted * ffn
               if self.n_experts else ffn)
        norms = 2 * self.d_model + (2 * self.d_model if self.post_block_norm
                                    else 0)
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return (self.n_layers * (attn + mlp + norms) + embed + head
                + self.d_model)


# ---------------------------------------------------------------------------
# Family presets (the JAX package's, field for field).
# ---------------------------------------------------------------------------

_LLAMA31_SCALING = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                        original_max_position_embeddings=8192)


def llama2_7b(**kw) -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, d_ff=11008, max_seq_len=4096,
        rope_theta=10000.0,
        **kw)


def llama2_13b(**kw) -> ModelConfig:
    return ModelConfig(
        name="llama2-13b", vocab_size=32000, d_model=5120, n_layers=40,
        n_heads=40, n_kv_heads=40, d_ff=13824, max_seq_len=4096,
        rope_theta=10000.0,
        **kw)


def llama2_70b(**kw) -> ModelConfig:
    return ModelConfig(
        name="llama2-70b", vocab_size=32000, d_model=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, d_ff=28672, max_seq_len=4096,
        rope_theta=10000.0,
        **kw)


def llama3_8b(**kw) -> ModelConfig:
    kw.setdefault("rope_scaling", _LLAMA31_SCALING)
    return ModelConfig(
        name="llama3-8b", vocab_size=128256, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, max_seq_len=8192,
        rope_theta=500000.0,
        **kw)


def llama3_70b(**kw) -> ModelConfig:
    kw.setdefault("rope_scaling", _LLAMA31_SCALING)
    return ModelConfig(
        name="llama3-70b", vocab_size=128256, d_model=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, d_ff=28672, max_seq_len=8192,
        rope_theta=500000.0,
        **kw)


def mistral_7b(**kw) -> ModelConfig:
    kw.setdefault("vocab_size", 32768)
    return ModelConfig(
        name="mistral-7b", d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, max_seq_len=4096,
        rope_theta=10000.0, block_pattern=("sliding",), sliding_window=4096,
        **kw)


def mixtral_8x7b(**kw) -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, max_seq_len=4096,
        rope_theta=1e6, n_experts=8, expert_top_k=2,
        **kw)


def qwen2_7b(**kw) -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", vocab_size=152064, d_model=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, d_ff=18944, max_seq_len=32768,
        rope_theta=1e6, attn_qkv_bias=True, norm_eps=1e-6,
        **kw)


def gemma2_9b(**kw) -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", vocab_size=256128, d_model=3584, n_layers=42,
        n_heads=16, n_kv_heads=8, d_ff=14336, head_dim=256, max_seq_len=8192,
        rope_theta=10000.0, block_pattern=("sliding", "global"),
        sliding_window=4096, activation="gelu_tanh", tie_embeddings=True,
        embed_scale=True, norm_scale_plus_one=True, post_block_norm=True,
        attn_softcap=50.0, logit_softcap=30.0,
        attn_scale=256 ** -0.5,
        norm_eps=1e-6,
        **kw)


def basic_lm(vocab_size: int, *, d_model: int = 2048, n_layers: int = 24,
             n_heads: int = 16, d_ff: int = 8192, max_seq_len: int = 1024,
             **kw) -> ModelConfig:
    return ModelConfig(
        name="basic-lm", vocab_size=vocab_size, d_model=d_model,
        n_layers=n_layers, n_heads=n_heads, n_kv_heads=n_heads, d_ff=d_ff,
        max_seq_len=max_seq_len, **kw)


def tiny(vocab_size: int = 256, **kw) -> ModelConfig:
    """Test-scale config."""
    defaults = dict(
        name="tiny", vocab_size=vocab_size, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
        dtype="float32", param_dtype="float32", remat=False)
    defaults.update(kw)
    return ModelConfig(**defaults)


PRESETS = {
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama2-70b": llama2_70b,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "mistral-7b": mistral_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "gemma2-9b": gemma2_9b,
    "qwen2-7b": qwen2_7b,
}


def preset_for_model_id(model_id: str, **kw) -> ModelConfig:
    """Map an HF-style MODEL_ID to a preset."""
    mid = model_id.lower()
    is_31 = any(t in mid for t in ("llama-3.1", "llama-3_1", "llama3.1"))
    if "llama-2" in mid or "llama2" in mid:
        if "70b" in mid:
            return llama2_70b(**kw)
        if "13b" in mid:
            return llama2_13b(**kw)
        return llama2_7b(**kw)
    if "llama-3" in mid or "llama3" in mid:
        fn = llama3_70b if "70b" in mid else llama3_8b
        # NTK rope scaling is a Llama-3.1 feature
        kw.setdefault("rope_scaling", _LLAMA31_SCALING if is_31 else None)
        return fn(**kw)
    if "mixtral" in mid:
        return mixtral_8x7b(**kw)
    if "mistral" in mid:
        if any(t in mid for t in ("v0.1", "v0.2")):
            kw.setdefault("vocab_size", 32000)
        return mistral_7b(**kw)
    if "gemma-2" in mid or "gemma2" in mid:
        return gemma2_9b(**kw)
    if "qwen" in mid:
        return qwen2_7b(**kw)
    raise ValueError(f"no preset for MODEL_ID={model_id!r}; "
                     f"known families: {sorted(PRESETS)}")
