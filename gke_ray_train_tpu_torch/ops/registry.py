"""Kernel registry — every accelerated op of the port declares its oracle
and domain (counterpart of ``gke_ray_train_tpu/ops/registry.py``).

Each registered op names

- its **reference oracle**, an independent implementation of the same
  math (the dense-mask attention, a complex-plane RoPE rotation, a
  one-hot cache select, the materialized-logits loss, ...), so that "the
  kernel is right" is a checkable differential claim;
- its **domain**: the shapes and dtypes it supports, each a named
  :class:`KernelCase`, with the device types a case runs on;
- whether its **gradients** are part of the contract.

``analysis/kernelcheck.py`` consumes the registry: value and gradient
sweeps against the port's tolerance ledger
(``analysis/tolerances/*.json``, one pin per case and device type).
Case names and sizes are the JAX package's, so the two registries can be
held against each other on the same inputs. The JAX package's sharded
cases and the ops the port lacks (ring and all-to-all attention, the
hierarchical psum) wait for their modules.

Inputs are built on the CPU from a ``torch.Generator`` seeded by the
sweep (``zlib.crc32("<spec>/<case>")``), then moved to the device, so a
CPU sweep and a CUDA sweep see the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

DEVICE_TYPES = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One point of a kernel's supported domain.

    ``grads``: the gradients are part of the differential contract.
    ``exact``: the oracle must match bitwise (pure data movement).
    ``devices``: the device types the case runs on (the full-width cases
    run on the card only)."""
    name: str
    dtype: str = "float32"
    grads: bool = True
    exact: bool = False
    devices: Tuple[str, ...] = DEVICE_TYPES
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    def kw(self) -> Dict[str, Any]:
        return dict(self.kwargs)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered kernel: build inputs, run kernel, run oracle.

    ``build(case, generator) -> (args, diff_argnums)``: inputs on the CPU
    plus which positional args take part in the gradient check.
    ``kernel`` / ``oracle``: ``(case, *args) -> tree`` (a tensor, or
    dicts / tuples of tensors), the two sides of the differential
    claim."""
    name: str
    build: Callable[[KernelCase, torch.Generator],
                    Tuple[tuple, Tuple[int, ...]]]
    kernel: Callable[..., Any]
    oracle: Callable[..., Any]
    cases: Tuple[KernelCase, ...]


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} registered twice")
    _REGISTRY[spec.name] = spec
    return spec


def all_kernels() -> List[KernelSpec]:
    """Registered kernels, sorted — the kernelcheck sweep order."""
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get(name: str) -> KernelSpec:
    return _REGISTRY[name]


def _normal(g: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32) * scale


# -- flash attention --------------------------------------------------------

def _attn_inputs(case: KernelCase, g: torch.Generator,
                 B=2, S=256, H=4, K=2, dh=64):
    dt = case.torch_dtype
    q = _normal(g, (B, S, H, dh), 0.5).to(dt)
    k = _normal(g, (B, S, K, dh), 0.5).to(dt)
    v = _normal(g, (B, S, K, dh), 0.5).to(dt)
    ar = torch.arange(S, dtype=torch.int32)
    if case.kw().get("packed"):
        # two documents per row, then padding: segment ids 1,1,...,2,2,0
        seg = torch.where(ar < S // 2, 1, torch.where(ar < 7 * S // 8, 2, 0))
        segment_ids = seg.to(torch.int32).expand(B, S).contiguous()
        # packed rows restart positions per document
        positions = torch.where(segment_ids == 2, ar - S // 2, ar)
    else:
        segment_ids = torch.ones((B, S), dtype=torch.int32)
        positions = ar.expand(B, S)
    return (q, k, v, positions.to(torch.int32).contiguous(),
            segment_ids), (0, 1, 2)


def _mask_padding_rows(out, segment_ids):
    """Padding-row (segment 0) outputs are don't-care by contract: the
    dense oracle's fully masked softmax is a uniform average where the
    flash kernel gives zeros, and the loss masks both."""
    return out * (segment_ids != 0).to(out.dtype)[..., None, None]


def _attn_oracle(case: KernelCase, q, k, v, positions, segment_ids):
    """The dense-mask semantics (``ops/attention.py``)."""
    from gke_ray_train_tpu_torch.ops.attention import (
        dot_product_attention, make_attention_mask)
    kw = case.kw()
    mask = make_attention_mask(
        positions, positions, segment_ids, segment_ids, causal=True,
        sliding_window=kw.get("sliding_window"))
    out = dot_product_attention(q, k, v, mask,
                                logit_softcap=kw.get("logit_softcap"))
    return _mask_padding_rows(out, segment_ids)


def _flash_kernel(case: KernelCase, q, k, v, positions, segment_ids):
    from gke_ray_train_tpu_torch.ops.dispatch import attention_dispatch
    kw = case.kw()
    out = attention_dispatch(
        "flash", q, k, v, q_positions=positions, kv_positions=positions,
        q_segment_ids=segment_ids, kv_segment_ids=segment_ids, causal=True,
        sliding_window=kw.get("sliding_window"),
        logit_softcap=kw.get("logit_softcap"))
    return _mask_padding_rows(out, segment_ids)


register(KernelSpec(
    name="flash_attention",
    build=_attn_inputs,
    kernel=_flash_kernel,
    oracle=_attn_oracle,
    cases=(
        KernelCase("causal_f32"),
        KernelCase("causal_bf16", dtype="bfloat16"),
        KernelCase("window_softcap_f32",
                   kwargs=(("sliding_window", 64), ("logit_softcap", 30.0))),
        KernelCase("packed_f32", kwargs=(("packed", True),)),
    ),
))


# -- quantization codec + dequant matmul ------------------------------------

def _quant_inputs(case: KernelCase, g: torch.Generator, D=128, F=64, B=4):
    x = _normal(g, (B, D))
    w = _normal(g, (D, F), 0.02)
    return (x, w), ()


def _quant_kernel(case: KernelCase, x, w):
    from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
    from gke_ray_train_tpu_torch.ops.quant import dequantize, quantize_tensor
    deq = dequantize(quantize_tensor(w, case.kw()["kind"]), torch.float32)
    if case.kw().get("device_vs_cpu"):
        return deq
    return matmul_f32(x, deq)


def _quant_oracle(case: KernelCase, x, w):
    from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
    from gke_ray_train_tpu_torch.ops.quant import dequantize, quantize_tensor
    if case.kw().get("device_vs_cpu"):
        # the codec on the CPU: the card must serve the very weights the
        # host-side merge and export see
        return dequantize(quantize_tensor(w.cpu(), case.kw()["kind"]),
                          torch.float32)
    # full-precision product: the differential error is the codec's
    # resolution (absmax-scaled nf4 codebook / int8 grid), pinned in the
    # ledger, so a codebook or scaling regression moves it
    return matmul_f32(x, w)


register(KernelSpec(
    name="quant_matmul",
    build=_quant_inputs,
    kernel=_quant_kernel,
    oracle=_quant_oracle,
    cases=(
        KernelCase("nf4", grads=False, kwargs=(("kind", "nf4"),)),
        KernelCase("int8", grads=False, kwargs=(("kind", "int8"),)),
        KernelCase("nf4_cuda_vs_cpu", grads=False, exact=True,
                   kwargs=(("kind", "nf4"), ("device_vs_cpu", True))),
    ),
))


# -- MoE dispatch -----------------------------------------------------------

def _moe_cfg():
    from gke_ray_train_tpu_torch.models.config import ModelConfig
    return ModelConfig(name="moe_oracle", d_model=16, n_layers=1,
                       n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=64,
                       max_seq_len=32, n_experts=4, expert_top_k=2,
                       capacity_factor=1.25)


def _moe_inputs(case: KernelCase, g: torch.Generator, B=2, S=32):
    cfg = _moe_cfg()
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = case.torch_dtype
    x = _normal(g, (B, S, D)).to(dt)
    router = _normal(g, (D, E), 0.1)
    w_gate = _normal(g, (E, D, F), 0.1).to(dt)
    w_up = _normal(g, (E, D, F), 0.1).to(dt)
    w_down = _normal(g, (E, F, D), 0.1).to(dt)
    return (x, router, w_gate, w_up, w_down), (0, 2)


def _moe_kernel(case: KernelCase, x, router, w_gate, w_up, w_down):
    from gke_ray_train_tpu_torch.ops.moe import moe_mlp
    y, aux = moe_mlp(x, router, w_gate, w_up, w_down, _moe_cfg(),
                     case.torch_dtype)
    return {"y": y, "aux": aux}


def _moe_oracle(case: KernelCase, x, router, w_gate, w_up, w_down):
    """Per-token gather MoE (JAX's oracle): the same routing and capacity
    semantics, which are part of the spec, but each token's expert FFN
    through a one-hot gather of that expert's weights, in fp32: no
    dispatch buffer and no combine, so both are cross-checked."""
    from gke_ray_train_tpu_torch.ops.moe import route
    cfg = _moe_cfg()
    dt = case.torch_dtype
    E, K = cfg.n_experts, cfg.expert_top_k
    r = route(x, router, cfg)
    f32 = torch.float32
    y = torch.zeros(x.shape, dtype=f32, device=x.device)
    xin = x.to(dt).to(f32)
    for k in range(K):
        oh = torch.nn.functional.one_hot(r.expert[..., k], E).to(f32)
        wg = torch.einsum("bse,edf->bsdf", oh, w_gate.to(f32))
        wu = torch.einsum("bse,edf->bsdf", oh, w_up.to(f32))
        wd = torch.einsum("bse,efd->bsfd", oh, w_down.to(f32))
        gt = torch.einsum("bsd,bsdf->bsf", xin, wg)
        up = torch.einsum("bsd,bsdf->bsf", xin, wu)
        act = (torch.nn.functional.silu(gt) if cfg.activation == "silu"
               else torch.nn.functional.gelu(gt, approximate="tanh"))
        h = torch.einsum("bsf,bsfd->bsd", act * up, wd)
        gate = (r.keep[..., k].to(f32) * r.gate[..., k]).to(dt).to(f32)
        y = y + h * gate[..., None]
    return {"y": y.to(dt), "aux": r.aux}


register(KernelSpec(
    name="moe_dispatch",
    build=_moe_inputs,
    kernel=_moe_kernel,
    oracle=_moe_oracle,
    cases=(
        KernelCase("top2_f32"),
        KernelCase("top2_bf16", dtype="bfloat16"),
    ),
))


# -- RoPE -------------------------------------------------------------------

def _rope_inputs(case: KernelCase, g: torch.Generator, B=2, S=64, H=2,
                 dh=32):
    x = _normal(g, (B, S, H, dh)).to(case.torch_dtype)
    positions = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    return (x, positions), (0,)


def _rope_freqs(case: KernelCase, x: torch.Tensor) -> torch.Tensor:
    from gke_ray_train_tpu_torch.ops.rope import rope_frequencies
    return torch.from_numpy(rope_frequencies(
        x.shape[-1], llama3_scaling=case.kw().get("llama3"))).to(x.device)


def _rope_kernel(case: KernelCase, x, positions):
    from gke_ray_train_tpu_torch.ops.rope import apply_rope
    return apply_rope(x, positions, _rope_freqs(case, x))


def _rope_oracle(case: KernelCase, x, positions):
    """Complex-plane oracle: the split halves are (re, im) of z, and RoPE
    is z * exp(i * pos * freq) — one rotation, no trig identity shared
    with the kernel's cos / sin formulation."""
    half = x.shape[-1] // 2
    x32 = x.float()
    z = torch.complex(x32[..., :half], x32[..., half:])
    angle = positions[..., :, None].float() * _rope_freqs(case, x)
    rot = z * torch.exp(1j * angle)[..., None, :]
    return torch.cat([rot.real, rot.imag], dim=-1).to(x.dtype)


register(KernelSpec(
    name="rope",
    build=_rope_inputs,
    kernel=_rope_kernel,
    oracle=_rope_oracle,
    cases=(
        KernelCase("f32"),
        KernelCase("bf16", dtype="bfloat16"),
        KernelCase("llama3_scaled_f32", kwargs=(
            ("llama3", (("factor", 8.0), ("low_freq_factor", 1.0),
                        ("high_freq_factor", 4.0),
                        ("original_max_position_embeddings", 32))),)),
    ),
))


# -- KV-cache slot insert ---------------------------------------------------

def _kvcache_inputs(case: KernelCase, g: torch.Generator):
    from gke_ray_train_tpu_torch.models.config import tiny
    from gke_ray_train_tpu_torch.models.kvcache import init_cache
    cfg = tiny(d_model=32, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=64,
               vocab_size=64, max_seq_len=32)

    def filled(batch):
        return {n: _normal(g, t.shape).to(t.dtype) for n, t in
                init_cache(cfg, batch=batch, max_len=32,
                           device="cpu").items()}
    pool, row = filled(4), filled(1)
    slot = torch.tensor(case.kw().get("slot", 2), dtype=torch.int32)
    return (pool, row, slot), ()


def _kvcache_kernel(case: KernelCase, pool, row, slot):
    from gke_ray_train_tpu_torch.models.kvcache import insert_cache_slot
    # the insert writes its pool in place: give it a copy, so the oracle
    # sees the pool as built
    return insert_cache_slot({n: t.clone() for n, t in pool.items()},
                             int(slot), row)


def _kvcache_oracle(case: KernelCase, pool, row, slot):
    """One-hot masked select over the batch axis, no indexed write: must
    match bitwise."""
    out = {}
    for n, p in pool.items():
        onehot = torch.arange(p.shape[1], device=p.device) == slot
        out[n] = torch.where(onehot[None, :, None, None, None],
                             row[n].to(p.dtype), p)
    return out


register(KernelSpec(
    name="kvcache_insert",
    build=_kvcache_inputs,
    kernel=_kvcache_kernel,
    oracle=_kvcache_oracle,
    cases=(
        KernelCase("slot2", grads=False, exact=True),
        KernelCase("slot0", grads=False, exact=True, kwargs=(("slot", 0),)),
        KernelCase("last_slot", grads=False, exact=True,
                   kwargs=(("slot", 3),)),
    ),
))


# -- fused epilogue kernels (plan knob FUSED_OPS) ---------------------------

def _restarting_positions(B: int, S: int, docs: int) -> torch.Tensor:
    """[B, S] positions that restart at 0 at each of ``docs`` equal
    documents, as a packed row's do."""
    ar = torch.arange(S, dtype=torch.int32)
    doc_len = -(-S // docs)
    return (ar % doc_len).expand(B, S).contiguous()


def _fnr_inputs(case: KernelCase, g: torch.Generator, B=2, S=128, H=4, K=2,
                dh=32, D=64):
    kw = case.kw()
    mode = kw.get("mode", "composed")
    dt = case.torch_dtype
    if "shape" in kw:
        B, S, H, dh = kw["shape"]
    positions = _restarting_positions(B, S, kw.get("docs", 1))
    if mode == "norm":
        x = _normal(g, (B, S, D)).to(dt)
        scale = _normal(g, (D,), 0.1) + 1.0
        return (x, scale), (0, 1)
    if mode == "rope_qk":
        q = _normal(g, (B, S, H, dh)).to(dt)
        k = _normal(g, (B, S, K, dh)).to(dt)
        return (q, k, positions), (0, 1)
    x = _normal(g, (B, S, H, dh)).to(dt)
    # (1 + scale) is the weight under Gemma's parameterization
    scale = _normal(g, (dh,), 0.1) + (0.0 if kw.get("scale_plus_one")
                                      else 1.0)
    return (x, scale, positions), (0, 1)


def _fnr_freqs(dh: int, device) -> torch.Tensor:
    from gke_ray_train_tpu_torch.ops.rope import rope_frequencies
    return torch.from_numpy(rope_frequencies(dh)).to(device)


def _norm_kw(case: KernelCase) -> Dict[str, Any]:
    kw = case.kw()
    return dict(eps=kw.get("eps", 1e-5),
                scale_plus_one=kw.get("scale_plus_one", False))


def _fnr_kernel(case: KernelCase, *args):
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm, fused_rmsnorm_rope, fused_rope_qk)
    mode = case.kw().get("mode", "composed")
    if mode == "norm":
        x, scale = args
        return fused_rmsnorm(x, scale, **_norm_kw(case))
    if mode == "rope_qk":
        q, k, positions = args
        qr, kr = fused_rope_qk(q, k, positions,
                               _fnr_freqs(q.shape[-1], q.device))
        return {"q": qr, "k": kr}
    x, scale, positions = args
    return fused_rmsnorm_rope(x, scale, positions,
                              _fnr_freqs(x.shape[-1], x.device),
                              **_norm_kw(case))


def _fnr_oracle(case: KernelCase, *args):
    """The separate ops the kernels fuse, ``ops/norms.py`` then
    ``ops/rope.py``, each rounding to the input dtype: in bf16 the
    composition rounds y once more than the one-pass kernel does."""
    from gke_ray_train_tpu_torch.ops.norms import rms_norm
    from gke_ray_train_tpu_torch.ops.rope import apply_rope
    mode = case.kw().get("mode", "composed")
    if mode == "norm":
        x, scale = args
        return rms_norm(x, scale, **_norm_kw(case))
    if mode == "rope_qk":
        q, k, positions = args
        freqs = _fnr_freqs(q.shape[-1], q.device)
        return {"q": apply_rope(q, positions, freqs),
                "k": apply_rope(k, positions, freqs)}
    x, scale, positions = args
    return apply_rope(rms_norm(x, scale, **_norm_kw(case)), positions,
                      _fnr_freqs(x.shape[-1], x.device))


register(KernelSpec(
    name="fused_norm_rope",
    build=_fnr_inputs,
    kernel=_fnr_kernel,
    oracle=_fnr_oracle,
    cases=(
        KernelCase("norm_f32", kwargs=(("mode", "norm"),)),
        KernelCase("norm_bf16", dtype="bfloat16", kwargs=(("mode", "norm"),)),
        KernelCase("rope_qk_f32", kwargs=(("mode", "rope_qk"),)),
        KernelCase("composed_f32"),
        KernelCase("composed_bf16", dtype="bfloat16"),
        # full width, on the card only: the Llama-3.1-8B q of the training
        # microbatch, and the Gemma-2-9B q of one packed row of 4,096 (7
        # documents, Gemma's (1 + scale) and eps)
        KernelCase("composed_bf16_llama3_8b", dtype="bfloat16",
                   devices=("cuda",),
                   kwargs=(("shape", (2, 1024, 32, 128)),)),
        KernelCase("composed_bf16_gemma2_9b", dtype="bfloat16",
                   devices=("cuda",),
                   kwargs=(("shape", (1, 4096, 16, 256)), ("docs", 7),
                           ("scale_plus_one", True), ("eps", 1e-6))),
    ),
))


# -- fused cross-entropy ----------------------------------------------------

def _fce_inputs(case: KernelCase, g: torch.Generator, B=2, S=128, D=64,
                V=256):
    dt = case.torch_dtype
    x = _normal(g, (B, S, D), 0.5).to(dt)
    head = _normal(g, (D, V), 0.05).to(dt)
    targets = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    # padding rows ride along: weight-0 rows must not move the loss
    weights = (torch.rand((B, S), generator=g) > 0.2).float()
    return (x, head, targets, weights), (0, 1)


def _fce_kernel(case: KernelCase, x, head, targets, weights):
    from gke_ray_train_tpu_torch.ops.fused_ce import fused_cross_entropy
    kw = {"block_v": case.kw()["block_v"]} if "block_v" in case.kw() else {}
    nll, w = fused_cross_entropy(x, head, targets, weights, **kw)
    return {"nll": nll, "w": w}


def _fce_oracle(case: KernelCase, x, head, targets, weights):
    """The unfused loss path: materialized fp32 logits, then
    ``token_nll``. The product runs on fp32 copies of x and head, so the
    logits' gradient stays fp32 until the one cast back to x's dtype; the
    bf16 case then measures the kernels' bf16 dlogits against it (on the
    card, the train step's ``matmul_f32`` rounds that gradient to bf16 at
    the kernels' own point, and would read 0)."""
    from gke_ray_train_tpu_torch.train.step import token_nll
    B, S, D = x.shape
    logits = (x.reshape(B * S, D).float() @ head.float()).reshape(B, S, -1)
    nll, w = token_nll(logits, targets, weights)
    return {"nll": nll, "w": w}


register(KernelSpec(
    name="fused_cross_entropy",
    build=_fce_inputs,
    kernel=_fce_kernel,
    oracle=_fce_oracle,
    cases=(
        KernelCase("f32"),
        KernelCase("bf16", dtype="bfloat16"),
        # V = 256 in vocab chunks of 128: the backward crosses a chunk
        # boundary, not just the one-chunk degenerate case
        KernelCase("vocab_tiled_f32", kwargs=(("block_v", 128),)),
    ),
))


# -- batched multi-LoRA matmul (multi-tenant serving) ----------------------

def _lora_batched_inputs(case: KernelCase, g: torch.Generator, B=4, d_in=32,
                         d_out=48, r=4, A=3):
    T = case.kw().get("T", 1)
    x = _normal(g, (B, T, d_in), 0.5).to(case.torch_dtype)
    # pools stay fp32 like the trained adapters; slot 0 is the reserved
    # zero adapter (the no-LoRA tenant, serve/adapters.py)
    a_pool = _normal(g, (A, d_in, r)) / math.sqrt(r)
    b_pool = _normal(g, (A, r, d_out), 0.5)
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    aslot = torch.randint(0, A, (B,), generator=g, dtype=torch.int32)
    return (x, a_pool, b_pool, aslot), ()


def _lora_batched_kernel(case: KernelCase, x, a_pool, b_pool, aslot):
    from gke_ray_train_tpu_torch.ops.lora_batched import lora_batched_matmul
    return lora_batched_matmul(x, a_pool, b_pool, aslot, scale=0.5,
                               dtype=case.torch_dtype)


def _lora_batched_oracle(case: KernelCase, x, a_pool, b_pool, aslot):
    """The per-request sequential single-adapter loop: each row alone
    through ``_proj``'s single-adapter products, concatenated. Bitwise in
    JAX; in torch a batched product and a batch-1 one may round apart at
    T = 1 (fp32 ~1e-7), which the ledger pins."""
    dt = case.torch_dtype
    rows = []
    for i in range(x.shape[0]):
        s = int(aslot[i])
        xa = x[i:i + 1].to(dt) @ a_pool[s].to(dt)
        rows.append((xa @ b_pool[s].to(dt))
                    * torch.full((), 0.5, dtype=dt, device=x.device))
    return torch.cat(rows, dim=0)


register(KernelSpec(
    name="lora_batched",
    build=_lora_batched_inputs,
    kernel=_lora_batched_kernel,
    oracle=_lora_batched_oracle,
    # serving is forward-only: a value-only contract
    cases=(
        KernelCase("decode_f32", grads=False),
        KernelCase("prefill_f32", grads=False, kwargs=(("T", 8),)),
        KernelCase("decode_bf16", dtype="bfloat16", grads=False),
    ),
))
