#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gke_ray_train_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — nvidia-smi name and power limit, torch / CUDA versions.
2. build   — compile every CUDA kernel of the port from ``csrc/`` with
             nvcc for sm_90a (all sources at once); the line carries
             ptxas's registers and spills per entry, those of the dQ and
             fused cross-entropy wgmma kernels also on their own, and
             fails if one of those spills.
3. kernels — hold each kernel (flash forward, dQ, dK/dV, fused rms_norm,
             fused q/k RoPE, per-head rms_norm + RoPE, fused
             cross-entropy row statistics, dx and dhead) against its
             plain PyTorch version on the card over the
             listed cases, and time kernel, plain version and the PyTorch
             library call at the serving shapes (forward), the Llama
             training shape (the flash and the cross-entropy kernels; for
             the latter the unfused route, matmul_f32 then
             F.cross_entropy, forward and backward) and the Gemma-2
             training shape (the fused rms_norm / RoPE): device time from
             torch.profiler, per-call time between CUDA events beside it
             at the serving shapes. The flash kernels are also held and
             timed at the Gemma-2 training shape (one packed row of
             4,096, head dim 256, softcap, with and without the window),
             and timed at one 4,096-token document a row; the dQ and
             dK/dV kernels must repeat bitwise. dQ + dK/dV are timed
             against SDPA's whole backward in alternated turns. At the Llama
             shape the cross-entropy row statistics, dx and dhead must
             take the wgmma body, which is also timed against the
             mma.sync body it replaced, in alternated turns; the row
             statistics must repeat bitwise. The fused rms_norm is timed
             against F.rms_norm in alternated turns at Gemma-2's shape.
             The per-head rms_norm + RoPE is timed at the Llama-3.1-8B q
             of the training microbatch and the Gemma-2-9B q of one
             packed row.
4. serve   — Llama-3.1-8B at full width and depth (bf16, random weights
             from a seed) through ``BatchEngine``: 24 requests over the
             256 and 512 buckets; the flash kernel must have run once per
             layer per prefill.
5. parity  — the same widths in float32 at 4 layers: flash-path prefill
             logits against the dense path, and every engine completion
             token-identical to the sequential ``greedy_generate_cached``.
6. train   — QLoRA fine-tune steps of Llama-3.1-8B at full width and
             depth with ray-jobs/fine_tune_config.json's settings (NF4
             base, r 64, microbatch 2 x grad-accum 4 at 1024 tokens):
             one warm-up and 5 timed steps; finite loss and grad_norm,
             the adapters change, and per step the forward kernel runs
             2 x 32 x 4 times (forward and remat recomputation), dQ and
             dK/dV 32 x 4 times.
7. train_parity — float32, 4 layers at full width: QLoRA and full
             fine-tuning through the kernels against the dense attention
             path, 3 steps each: loss / grad_norm streams and the trained
             tensors agree.
8. train_fused — QLoRA fine-tune steps of Gemma-2-9B at full width and
             depth with ray-jobs/fine_tune_config_gemma2_4k.json's
             settings plus FUSED_OPS=1 (NF4 base, r 32, microbatch 1 x
             grad-accum 4 at 4,096 tokens, packed rows): one warm-up and 2
             timed steps; finite loss and grad_norm, the adapters change,
             and per step the fused rms_norm runs 4 x 42 x 4 x 2 times, the
             fused RoPE 42 x 4 x 3 times (forward, recomputation,
             backward), the flash forward 2 x 42 x 4 and dQ, dK/dV 42 x 4
             times.
9. train_fused_parity — float32, Gemma-2 at full width and 4 layers:
             FUSED_OPS=1 against FUSED_OPS=0, both through the flash
             kernels, for QLoRA and full fine-tuning, 3 steps each on
             packed rows: loss / grad_norm streams and the trained tensors
             agree.
10. train_fused_ce — the train phase's Llama-3.1-8B QLoRA job at full
             width and depth with FUSED_OPS=1: the loss through the fused
             cross-entropy (no [2 x 1,024, 128,256] fp32 logits); per step
             row statistics and dx 4 times (dhead 0: the head is frozen),
             row statistics and dx on the wgmma body, the fused
             rms_norm 2 x 32 x 4 x 2 and RoPE 32 x 4 x 3 times.
11. train_fused_ce_parity — float32, Llama at full width and 4 layers:
             FUSED_OPS=1 against FUSED_OPS=0, both through the flash
             kernels, QLoRA and full fine-tuning (where dhead launches and
             the lm_head trains, held alike on both sides by the
             trained-tensor check); dx and dhead on the fp32 body.
12. kernelcheck — run right after the kernels phase: the port's kernel
             sweep (``analysis/kernelcheck.py`` over
             ``ops/registry.py``) on the card: every registered case
             that runs there, values and gradients, held within its
             committed CUDA pin (``analysis/tolerances/*.json``), the
             full-width per-head rms_norm + RoPE cases among them; the
             sweep's launches count as a driven path's.

The second-to-last line is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16
H100_F32_FLOPS = 67e12              # fp32 outside the tensor cores

# kernel-vs-plain tolerances (absolute), by dtype. float32: both sides
# accumulate in fp32 in different orders. bfloat16: probabilities are
# rounded to bf16 against the running (kernel) or final (plain) row max,
# up to 2^-9 relative each, and out is rounded to bf16 (2^-8 relative).
TOL = {"float32": {"out": 2e-5, "lse": 2e-5},
       "bfloat16": {"out": 2e-2, "lse": 1e-4}}
# backward kernels against flash_attention_bwd_reference: max |error| of
# dq, dk and dv relative to max(1, max |reference|). float32: fp32 sums
# in other orders (dK/dV sums up to G * S products). bfloat16: the
# recomputed P and dS round to bf16 at the same points on both sides, but
# a last-bit difference in fp32 can round either way (2^-8 relative on
# that term), and the outputs round to bf16 (2^-8).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# fp32 logits of the flash prefill path against the dense path, 4 layers
PARITY_LOGITS_TOL = 1e-3
# train-parity phase: flash against dense attention at fp32, 4 layers.
# loss and grad_norm streams: relative; trained tensors: the change each
# run made, ||d_flash - d_dense|| / ||d_dense|| (an element whose
# gradient sits at rounding level may take Adam's step of +-lr on one
# side and the opposite on the other, so elementwise limits do not fit)
TRAIN_PARITY_RTOL = 1e-4
TRAIN_PARITY_DELTA_RTOL = 1e-3
# fused rms_norm / RoPE kernels against their plain versions: max |error|
# relative to max(1, max |reference|). Both sides compute in fp32 and
# round once; the fp32 sum order and rsqrtf may move the last fp32 bit,
# which can round a bf16 output to its neighbour (2^-8 relative)
FUSED_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# fused cross-entropy kernels against their plain versions. "stats": lse
# and the target logit, max |error| relative to max(1, max |reference|):
# fp32 sums over D and the vocab in other orders (bf16 products are
# exact in fp32). "grads": dx and dhead, max |error| relative to
# max |reference|: bf16 rounds dl to bf16 (2^-9 relative) before the
# products where the plain version keeps fp32, and both sides round the
# outputs (a neighbour is 2^-7 relative). The one-hot term sets that
# scale when labels are in range, so each case runs a second time with
# every label out of range: dl is then the softmax term alone, held on
# its own scale
CE_TOL = {"float32": {"stats": 2e-5, "grads": 1e-4},
          "bfloat16": {"stats": 1e-4, "grads": 1e-2}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around ``iters`` calls:
    device time plus any host launch overhead the device waits on."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# how many device_ms calls each timer served; once the profiler records
# no device time in a process (CUPTI tracing unavailable to it), every
# later call times with CUDA events
TIMER_CALLS = {"profiler": 0, "cuda_events": 0}


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: the summed time of every kernel
    ``fn`` launches (torch.profiler / CUPTI), without the host gaps
    between them. Where the profiler records no device time, the time
    between CUDA events around ``iters`` calls (``cuda_ms``) stands in,
    host launch gaps included, and ``TIMER_CALLS`` counts it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if TIMER_CALLS["cuda_events"] == 0:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == cuda)
        if us > 0:
            TIMER_CALLS["profiler"] += 1
            return us / iters / 1e3
        print("device_ms: the profiler recorded no device time; timing "
              "with CUDA events from here on", file=sys.stderr, flush=True)
    TIMER_CALLS["cuda_events"] += 1
    return cuda_ms(fn, iters, warmup)


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def _attn_inputs(case, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(case.get("seed", 0))
    dt = getattr(torch, case["dtype"])
    B, S, T, H, K, dh = (case[x] for x in ("B", "S", "T", "H", "K", "dh"))
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(dt)
    k = torch.randn((B, T, K, dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, T, K, dh), generator=g, device=dev).to(dt)
    qp = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    qs = torch.ones((B, S), dtype=torch.int32, device=dev)
    ks = torch.ones((B, T), dtype=torch.int32, device=dev)
    if case.get("packed"):
        # two packed documents and trailing padding (segment 0)
        third = T // 3
        seg = torch.cat([torch.full((third,), 1), torch.full((third,), 2),
                         torch.zeros(T - 2 * third)]).to(torch.int32)
        qs = ks = seg.to(dev).expand(B, T)
    if case.get("packed_rows"):
        # segment ids and positions of the train_fused phase's first
        # packed rows (S = T)
        from gke_ray_train_tpu_torch.models import gemma2_9b
        rows = _packed_batch(B, T, gemma2_9b().vocab_size,
                             np.random.default_rng(1234))
        qs = ks = torch.as_tensor(rows["segment_ids"], device=dev)
        qp = kp = torch.as_tensor(rows["positions"], device=dev)
    if case.get("masked_rows"):
        # rows 5..9 carry a segment no key has: they attend nothing
        qs = qs.clone()
        qs[:, 5:10] = 7
    kw = dict(q_positions=qp.contiguous(), kv_positions=kp.contiguous(),
              q_segment_ids=qs.contiguous(), kv_segment_ids=ks.contiguous(),
              causal=case.get("causal", True),
              sliding_window=case.get("window"),
              scale=dh ** -0.5, logit_softcap=case.get("softcap"))
    return q, k, v, kw


KERNEL_CASES = {
    "causal_bf16": dict(B=2, S=256, T=256, H=8, K=2, dh=128,
                        dtype="bfloat16"),
    "causal_f32": dict(B=2, S=256, T=256, H=8, K=2, dh=128,
                       dtype="float32"),
    "gqa_32_8": dict(B=1, S=384, T=384, H=32, K=8, dh=128,
                     dtype="bfloat16"),
    "packed_padding": dict(B=2, S=255, T=255, H=4, K=4, dh=64,
                           dtype="float32", packed=True),
    "window_softcap_dh256": dict(B=1, S=320, T=320, H=4, K=2, dh=256,
                                 dtype="float32", window=64, softcap=50.0),
    "window_softcap_dh256_bf16": dict(B=1, S=320, T=320, H=4, K=2, dh=256,
                                      dtype="bfloat16", window=64,
                                      softcap=50.0),
    "ragged_T": dict(B=1, S=130, T=200, H=4, K=2, dh=128, dtype="float32",
                     causal=False),
    "fully_masked_rows": dict(B=1, S=128, T=128, H=4, K=2, dh=64,
                              dtype="float32", masked_rows=True),
    # the bf16 tensor-core body (dh 64 / 128) through the same cases
    "packed_padding_bf16": dict(B=2, S=255, T=255, H=4, K=4, dh=64,
                                dtype="bfloat16", packed=True),
    "window_softcap_bf16": dict(B=1, S=320, T=320, H=4, K=2, dh=128,
                                dtype="bfloat16", window=64, softcap=50.0),
    "ragged_T_bf16": dict(B=1, S=130, T=200, H=4, K=2, dh=128,
                          dtype="bfloat16", causal=False),
    "fully_masked_rows_bf16": dict(B=1, S=128, T=128, H=4, K=2, dh=64,
                                   dtype="bfloat16", masked_rows=True),
    # the edges of the bf16 wgmma bodies: TMA tails with S < T, a
    # cluster of 7 query heads (Qwen2's 28 / 4) and of 1 (MHA), dh 256
    # with packed documents, window, softcap and rows that attend
    # nothing, and a row of interior tiles only (one segment, not causal)
    "tail_s_lt_t_bf16": dict(B=2, S=77, T=333, H=8, K=2, dh=128,
                             dtype="bfloat16"),
    "gqa7_bf16": dict(B=1, S=300, T=300, H=14, K=2, dh=128,
                      dtype="bfloat16"),
    "mha_dh64_bf16": dict(B=2, S=256, T=256, H=4, K=4, dh=64,
                          dtype="bfloat16"),
    "packed_window_softcap_dh256_bf16": dict(
        B=1, S=700, T=700, H=4, K=2, dh=256, dtype="bfloat16", packed=True,
        window=128, softcap=50.0, masked_rows=True),
    "interior_bf16": dict(B=1, S=512, T=512, H=4, K=2, dh=128,
                          dtype="bfloat16", causal=False),
}

# the serving path's prefill shapes: Llama-3.1-8B, one prompt per prefill
SERVE_SHAPES = {f"llama3_8b_prefill_{n}": dict(B=1, S=n, T=n, H=32, K=8,
                                               dh=128, dtype="bfloat16")
                for n in (256, 512)}
# the train phase's attention shape: Llama-3.1-8B, microbatch 2 x 1024
TRAIN_SHAPE = dict(B=2, S=1024, T=1024, H=32, K=8, dh=128, dtype="bfloat16")
# the train_fused phase's attention: Gemma-2-9B, one packed row of 4,096
# (its segments and positions), bf16, softcap 50, scale 256^-0.5; the
# sliding layers' window of 4,096 and the global layers' none
GEMMA_ATTN_SHAPE = dict(B=1, S=4096, T=4096, H=16, K=8, dh=256,
                        dtype="bfloat16", softcap=50.0, packed_rows=True)
GEMMA_ATTN_CASES = {
    "gemma2_9b_train_4096_sliding": dict(GEMMA_ATTN_SHAPE, window=4096),
    "gemma2_9b_train_4096_global": GEMMA_ATTN_SHAPE,
}
# the other committed length mix: one 4,096-token document a row
GEMMA_ONE_DOC_SHAPE = dict(GEMMA_ATTN_SHAPE, packed_rows=False)


def _check_case(name, case, dev):
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    q, k, v, kw = _attn_inputs(case, dev)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_reference(
        q, k, v, kw["q_positions"], kw["kv_positions"],
        kw["q_segment_ids"], kw["kv_segment_ids"], causal=kw["causal"],
        sliding_window=kw["sliding_window"], scale=kw["scale"],
        logit_softcap=kw["logit_softcap"])
    err_out = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol = TOL[case["dtype"]]
    row = {"case": name, "max_abs_err_out": err_out,
           "max_abs_err_lse": err_lse, "tol_out": tol["out"],
           "tol_lse": tol["lse"],
           "ok": err_out <= tol["out"] and err_lse <= tol["lse"]
           and bool(torch.isfinite(out.float()).all())}
    if case.get("masked_rows"):
        dead_out = float(out[:, 5:10].float().abs().max())
        dead_lse = lse[:, :, 5:10]
        row["masked_rows_ok"] = (dead_out == 0.0
                                 and bool((dead_lse == -2.0e38).all()))
        row["ok"] = row["ok"] and row["masked_rows_ok"]
    return row, (q, k, v, kw)


def _mask_kw(kw):
    return {k: kw[k] for k in ("causal", "sliding_window", "scale",
                               "logit_softcap")}


def _mask_args(kw):
    return (kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
            kw["kv_segment_ids"])


def _bwd_inputs(q, k, v, kw, seed):
    """(out, lse) from the forward kernel, an output gradient dO and
    D = rowsum(dO * O) [B, H, S] fp32, as FlashAttention.backward forms
    them."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    g = torch.Generator(device=q.device)
    g.manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    dvec = torch.sum(do.float() * out.float(), dim=-1).transpose(
        1, 2).contiguous()
    return out, lse, do, dvec


def _check_bwd_case(name, case, dev):
    """Both backward kernels against flash_attention_bwd_reference on the
    same (q, k, v, out, lse, dO)."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference, flash_bwd_dkv, flash_bwd_dq)
    q, k, v, kw = _attn_inputs(case, dev)
    out, lse, do, dvec = _bwd_inputs(q, k, v, kw, case.get("seed", 0))
    args = (q, k, v, do, lse, dvec) + _mask_args(kw)
    dq = flash_bwd_dq(*args, **_mask_kw(kw))
    dk, dv = flash_bwd_dkv(*args, **_mask_kw(kw))
    torch.cuda.synchronize()
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                        *_mask_args(kw), **_mask_kw(kw))
    row = {"case": name, "dtype": case["dtype"],
           "tol_rel": BWD_TOL[case["dtype"]], "ok": True}
    for nm, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        row[f"max_abs_err_{nm}"] = err
        row[f"max_abs_ref_{nm}"] = scale
        row["ok"] = (row["ok"] and err <= BWD_TOL[case["dtype"]] * scale
                     and bool(torch.isfinite(got.float()).all()))
    if case.get("masked_rows"):
        row["masked_rows_ok"] = float(dq[:, 5:10].float().abs().max()) == 0.0
        row["ok"] = row["ok"] and row["masked_rows_ok"]
    # every dQ element and the GQA group sum have a fixed order (no
    # atomics): a second launch gives the same bits
    again = flash_bwd_dkv(*args, **_mask_kw(kw))
    row["dkv_bitwise_repeat"] = all(bool(torch.equal(a, b))
                                    for a, b in zip((dk, dv), again))
    row["dq_bitwise_repeat"] = bool(torch.equal(
        dq, flash_bwd_dq(*args, **_mask_kw(kw))))
    row["ok"] = (row["ok"] and row["dkv_bitwise_repeat"]
                 and row["dq_bitwise_repeat"])
    return row


def _bound(nbytes, flops, dtype):
    """(bound ms, what bounds it): bytes over the memory rate against
    FLOPs over the peak rate of the input type."""
    import torch
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _live_pairs(kw):
    """Unmasked (q, kv) pairs of these inputs, summed over batch rows."""
    from gke_ray_train_tpu_torch.ops.attention import make_attention_mask
    return int(make_attention_mask(*_mask_args(kw), causal=kw["causal"],
                                   sliding_window=kw["sliding_window"]).sum())


def _bound_ms(q, k, v, kw):
    """Least time for the forward on these inputs: bytes each input read
    once and each output written once, against the FLOPs of the (q, kv)
    pairs these inputs' mask keeps (QK^T and PV, 2 FLOPs a MAC)."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es \
        + B * H * S * 4 + 4 * 2 * B * (S + T)
    flops = 4.0 * dh * H * _live_pairs(kw)
    return _bound(nbytes, flops, q.dtype) + (nbytes, flops)


def _bwd_bounds(q, k, v, kw):
    """{kernel: (bound ms, by, bytes, flops)} of the two backward kernels:
    dQ reads q, k, v, dO, lse, D and writes dQ, with 3 products (S, dP,
    dS K) over the live pairs; dK/dV reads the same and writes dK, dV,
    with 4 (S, dP, P^T dO, dS^T Q)."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    es = q.element_size()
    ins = (2 * q.numel() + k.numel() + v.numel()) * es + 2 * 4 * B * H * S \
        + 4 * 2 * B * (S + T)
    pairs = _live_pairs(kw)
    out = {}
    for name, n_out, n_mm in (("flash_bwd_dq", q.numel(), 3),
                              ("flash_bwd_dkv", k.numel() + v.numel(), 4)):
        nbytes = ins + n_out * es
        flops = 2.0 * dh * H * pairs * n_mm
        out[name] = _bound(nbytes, flops, q.dtype) + (nbytes, flops)
    return out


def _turns(plain, kernel, library, iters: int = 20):
    """Device ms in turns plain, kernel, kernel, plain, library (None
    where there is no library call), all on one timer."""
    fns = (plain, kernel, kernel, plain) + (
        (library,) if library is not None else ())
    profiled = TIMER_CALLS["cuda_events"] == 0
    ms = [device_ms(f, iters) for f in fns]
    if profiled and TIMER_CALLS["cuda_events"]:
        # the profiler gave out part-way: every turn again on CUDA events
        ms = [device_ms(f, iters) for f in fns]
    plain_a, kern_a, kern_b, plain_b = ms[:4]
    lib = ms[4] if library is not None else None
    return {"kernel_ms": min(kern_a, kern_b), "kernel_ms_runs": [kern_a,
                                                                  kern_b],
            "plain_ms": min(plain_a, plain_b),
            "plain_ms_runs": [plain_a, plain_b], "library_ms": lib}


def _alternated(a, b, fa, fb, pairs: int = 2, iters: int = 3,
                warmup: int = 1):
    """Device ms of ``fa`` (named ``a``) and ``fb`` (``b``) in one
    process, in alternated turns a, b, b, a, ``pairs`` times (``iters``
    calls a turn): per name the best turn, every turn, and the spread
    (max - min) / min over its turns."""
    runs = {a: [], b: []}
    for _ in range(pairs):
        for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
            runs[name].append(device_ms(fn, iters=iters, warmup=warmup))
    return {name: {"ms": min(r), "spread": (max(r) - min(r)) / min(r),
                   "ms_runs": r} for name, r in runs.items()}


def _time_routes(wrapper, launch, old, bound, flops, pairs: int = 2,
                 iters: int = 3):
    """The wgmma body of a routed kernel against the body ``old`` it
    replaced, on the same inputs (``launch(route)``), in alternated turns
    (``_alternated``): both times and spreads, TFLOP/s, the share of the
    bound, the speed-up, and the launches per route on ``wrapper``."""
    before = dict(wrapper.routes)
    out = _alternated(old, "wgmma", lambda: launch(old),
                      lambda: launch("wgmma"), pairs, iters)
    for r in out.values():
        r.update({"tflops_per_s": flops / r["ms"] / 1e9,
                  "bound_share": bound / r["ms"]})
    out["speedup"] = out[old]["ms"] / out["wgmma"]["ms"]
    out["launches"] = {r: n - before[r] for r, n in wrapper.routes.items()}
    return out


def _time_train_shape(dev):
    """The three kernels at the training shape (TRAIN_SHAPE), each
    against its plain version and a PyTorch library call: SDPA forward
    for flash_fwd, and for both backward kernels the device time of the
    kernels SDPA's backward launches (dQ, dK and dV together). Then the
    like-for-like backward: dQ and dK/dV together against SDPA's whole
    backward (``bwd_vs_sdpa``), in alternated turns."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_reference,
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dq)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case = TRAIN_SHAPE
    q, k, v, kw = _attn_inputs(case, dev)
    mkw, margs = _mask_kw(kw), _mask_args(kw)
    out, lse, do, dvec = _bwd_inputs(q, k, v, kw, 0)
    args = (q, k, v, do, lse, dvec) + margs
    ref_out, _ = flash_attention_reference(q, k, v, *margs, **mkw)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do, *margs, **mkw)
    dq = flash_bwd_dq(*args, **mkw)
    dk, dv = flash_bwd_dkv(*args, **mkw)
    torch.cuda.synchronize()

    def err(a, b):
        return float((a.float() - b.float()).abs().max())
    errs = {"flash_fwd": err(out, ref_out), "flash_bwd_dq": err(dq, ref[0]),
            "flash_bwd_dkv": max(err(dk, ref[1]), err(dv, ref[2]))}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, scale=mkw["scale"],
                   enable_gqa=True)
    do_t = do.transpose(1, 2).contiguous()

    def lib_fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, scale=mkw["scale"],
                        enable_gqa=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), do_t,
                                   retain_graph=True)

    def plain_bwd():
        return flash_attention_bwd_reference(q, k, v, out, lse, do, *margs,
                                             **mkw)
    runs = {
        "flash_fwd": _turns(
            lambda: flash_attention_reference(q, k, v, *margs, **mkw),
            lambda: flash_attention(q, k, v, **kw), lib_fwd),
        "flash_bwd_dq": _turns(plain_bwd,
                               lambda: flash_bwd_dq(*args, **mkw), lib_bwd),
        "flash_bwd_dkv": _turns(plain_bwd,
                                lambda: flash_bwd_dkv(*args, **mkw),
                                lib_bwd),
    }
    bounds = _bwd_bounds(q, k, v, kw)
    bounds["flash_fwd"] = _bound_ms(q, k, v, kw)
    for name, r in runs.items():
        bound, by, nbytes, flops = bounds[name]
        r.update({"shape": "llama3_8b_train_1024", "bound_ms": bound,
                  "bound_by": by, "bytes": nbytes, "flops": flops,
                  "max_abs_err": errs[name]})
    def ours_bwd():
        return flash_bwd_dq(*args, **mkw), flash_bwd_dkv(*args, **mkw)
    both = _alternated("sdpa_backward", "dq_plus_dkv", lib_bwd, ours_bwd,
                       iters=10)
    both["ratio"] = both["dq_plus_dkv"]["ms"] / both["sdpa_backward"]["ms"]
    runs["flash_bwd_dq"]["bwd_vs_sdpa"] = both
    return runs


def _time_gemma_attn(dev):
    """Device ms of the three kernels at the train_fused phase's attention
    (the global layers' case of GEMMA_ATTN_CASES; the sliding layers'
    window of 4,096 masks no pair more on rows of documents up to 1,024
    tokens), with the live pairs of that packed row and each kernel's
    bound on them; then the same at one 4,096-token document a row
    (GEMMA_ONE_DOC_SHAPE), the other length mix the numbers hold for."""
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    mixes = {"stand_in_mix": GEMMA_ATTN_CASES["gemma2_9b_train_4096_global"],
             "one_doc": GEMMA_ONE_DOC_SHAPE}
    res = {}
    for mix, case in mixes.items():
        q, k, v, kw = _attn_inputs(case, dev)
        mkw = _mask_kw(kw)
        out, lse, do, dvec = _bwd_inputs(q, k, v, kw, 0)
        args = (q, k, v, do, lse, dvec) + _mask_args(kw)
        bounds = _bwd_bounds(q, k, v, kw)
        bounds["flash_fwd"] = _bound_ms(q, k, v, kw)
        fns = {"flash_fwd": lambda: flash_attention(q, k, v, **kw),
               "flash_bwd_dq": lambda: flash_bwd_dq(*args, **mkw),
               "flash_bwd_dkv": lambda: flash_bwd_dkv(*args, **mkw)}
        rows = {}
        for name, fn in fns.items():
            bound, by, nbytes, flops = bounds[name]
            ms = device_ms(fn)
            rows[name] = {"shape": f"gemma2_9b_train_4096_{mix}",
                          "kernel_ms": ms, "bound_ms": bound, "bound_by": by,
                          "flops": flops, "tflops_per_s": flops / ms / 1e9}
        res[mix] = {"live_pairs_per_head": _live_pairs(kw),
                    "all_causal_pairs": q.shape[1] * (q.shape[1] + 1) // 2,
                    "kernels": rows}
    return res


# fused rms_norm cases: rows (3 x 37) that no block divides, D of the
# small tests, Gemma-2 (3,584, not a power of two) and Llama (4,096)
NORM_CASES = [dict(D=D, dtype=dt, scale_plus_one=sp1)
              for dt in ("float32", "bfloat16") for D in (64, 3584, 4096)
              for sp1 in (False, True)]
# fused RoPE cases (B, S, H, K, dh): tiny, Gemma-2's training shape, Llama's
ROPE_CASES = [dict(shape=shp, dtype=dt) for dt in ("float32", "bfloat16")
              for shp in ((1, 128, 4, 2, 32), (1, 4096, 16, 8, 256),
                          (2, 1024, 32, 8, 128))]
# the train_fused phase's shapes: Gemma-2-9B, one packed row of 4,096
GEMMA_NORM_SHAPE = (1, 4096, 3584)
GEMMA_ROPE_SHAPE = (1, 4096, 16, 8, 256)


def _rel_err(got, want):
    """(max |got - want|, max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, max(1.0, float(want.float().abs().max()))


def _packed_rope_positions(B, S, dev, g):
    """Positions that restart at S // 3 (a second document), and over the
    last third of the last row random positions up to 8,191."""
    import torch
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    pos[:, S // 3:] -= S // 3
    tail = S - 2 * S // 3
    pos[-1, -tail:] = torch.randint(0, 8192, (tail,), generator=g,
                                    device=dev, dtype=torch.int32)
    return pos


def _rope_freqs(dh, dev):
    import torch
    from gke_ray_train_tpu_torch.ops.rope import rope_frequencies
    return torch.from_numpy(rope_frequencies(dh)).to(dev)


def _check_fused_cases(dev):
    """Both fused kernels against their plain versions over NORM_CASES and
    ROPE_CASES; RoPE forward and its negated-frequency backward launch."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm, fused_rmsnorm_reference, fused_rope_qk,
        fused_rope_qk_reference)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for c in NORM_CASES:
        dt = getattr(torch, c["dtype"])
        sp1 = c["scale_plus_one"]
        x = torch.randn((3, 37, c["D"]), generator=g, device=dev).to(dt)
        s = (torch.randn((c["D"],), generator=g, device=dev) * 0.1
             + (0.0 if sp1 else 1.0)).to(dt)
        y = fused_rmsnorm(x, s, eps=1e-6, scale_plus_one=sp1)
        torch.cuda.synchronize()
        err, scale = _rel_err(y, fused_rmsnorm_reference(
            x, s, eps=1e-6, scale_plus_one=sp1))
        tol = FUSED_TOL[c["dtype"]]
        rows.append({"kernel": "fused_rmsnorm", **c, "max_abs_err": err,
                     "max_abs_ref": scale, "tol_rel": tol,
                     "ok": err <= tol * scale
                     and bool(torch.isfinite(y.float()).all())})
    for c in ROPE_CASES:
        dt = getattr(torch, c["dtype"])
        B, S, H, K, dh = c["shape"]
        q = torch.randn((B, S, H, dh), generator=g, device=dev).to(dt)
        k = torch.randn((B, S, K, dh), generator=g, device=dev).to(dt)
        pos = _packed_rope_positions(B, S, dev, g)
        f = _rope_freqs(dh, dev)
        oq, ok = fused_rope_qk(q, k, pos, f)
        bq, bk = fused_rope_qk(oq, ok, pos, -f)      # the backward launch
        torch.cuda.synchronize()
        tol = FUSED_TOL[c["dtype"]]
        row = {"kernel": "fused_rope_qk", **c, "tol_rel": tol, "ok": True}
        outs = zip(("q", "k", "dq", "dk"), (oq, ok, bq, bk),
                   fused_rope_qk_reference(q, k, pos, f)
                   + fused_rope_qk_reference(oq, ok, pos, -f))
        for name, got, want in outs:
            err, scale = _rel_err(got, want)
            row[f"max_abs_err_{name}"] = err
            row["ok"] = (row["ok"] and err <= tol * scale
                         and bool(torch.isfinite(got.float()).all()))
        rows.append(row)
    return rows


def _time_fused_gemma_shape(dev):
    """Both fused kernels at the train_fused phase's Gemma-2-9B shapes
    (bf16), against their plain versions and, for rms_norm,
    ``torch.nn.functional.rms_norm`` with the weight 1 + scale formed
    beforehand (RoPE has no single PyTorch call). Bounds: bytes of each
    input read once and each output written once over the memory rate,
    against fp32 FLOPs (the arithmetic runs in fp32 outside the tensor
    cores) over the fp32 rate."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm, fused_rmsnorm_reference, fused_rope_qk,
        fused_rope_qk_reference)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(GEMMA_NORM_SHAPE, generator=g, device=dev).to(bf)
    D = x.shape[-1]
    s = (torch.randn((D,), generator=g, device=dev) * 0.1).to(bf)
    w = (1.0 + s.float()).to(bf)
    nkw = dict(eps=1e-6, scale_plus_one=True)
    tol = FUSED_TOL["bfloat16"]
    y = fused_rmsnorm(x, s, **nkw)
    norm_err, norm_ref = _rel_err(y, fused_rmsnorm_reference(x, s, **nkw))
    norm_ok = (norm_err <= tol * norm_ref
               and bool(torch.isfinite(y.float()).all()))
    norm = _turns(lambda: fused_rmsnorm_reference(x, s, **nkw),
                  lambda: fused_rmsnorm(x, s, **nkw),
                  lambda: torch.nn.functional.rms_norm(x, (D,), w, 1e-6))
    nbytes = 2 * x.numel() * x.element_size() + D * s.element_size()
    flops = 4.0 * x.numel()          # square-add, x * r, times s
    norm.update({"shape": "gemma2_9b_train_4096", "max_abs_err": norm_err,
                 "max_abs_ref": norm_ref, "tol_rel": tol, "ok": norm_ok,
                 "bytes": nbytes, "flops": flops,
                 "library": "torch.nn.functional.rms_norm"})
    norm["bound_ms"], norm["bound_by"] = _bound(nbytes, flops, torch.float32)
    # whether the kernel truly loses to the library call: alternated
    # turns with their spread
    vs = _alternated("library", "kernel",
                     lambda: torch.nn.functional.rms_norm(x, (D,), w, 1e-6),
                     lambda: fused_rmsnorm(x, s, **nkw), pairs=3, iters=50)
    vs["ratio"] = vs["kernel"]["ms"] / vs["library"]["ms"]
    norm["kernel_vs_library"] = vs

    B, S, H, K, dh = GEMMA_ROPE_SHAPE
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, K, dh), generator=g, device=dev).to(bf)
    pos = _packed_rope_positions(B, S, dev, g)
    f = _rope_freqs(dh, dev)
    got = fused_rope_qk(q, k, pos, f)
    want = fused_rope_qk_reference(q, k, pos, f)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    rope_err = max(e for e, _ in errs)
    rope_ok = (all(e <= tol * r for e, r in errs)
               and all(bool(torch.isfinite(a.float()).all()) for a in got))
    rope = _turns(lambda: fused_rope_qk_reference(q, k, pos, f),
                  lambda: fused_rope_qk(q, k, pos, f), None)
    nbytes = (2 * (q.numel() + k.numel()) * q.element_size()
              + pos.numel() * 4 + f.numel() * 4)
    # 6 FLOPs a rotated pair, and one sincosf per (row, frequency) counted
    # as 2
    flops = 3.0 * (q.numel() + k.numel()) + 2.0 * B * S * dh // 2
    rope.update({"shape": "gemma2_9b_train_4096", "max_abs_err": rope_err,
                 "max_abs_ref": max(r for _, r in errs), "tol_rel": tol,
                 "ok": rope_ok, "bytes": nbytes, "flops": flops,
                 "library": None})
    rope["bound_ms"], rope["bound_by"] = _bound(nbytes, flops, torch.float32)
    return {"fused_rmsnorm": norm, "fused_rope_qk": rope}


# per-head rms_norm + RoPE cases: every head dim of the shipped families
# (32 for the small tests), both dtypes and scale parameterizations, 37
# sequence rows (no 8-row tile divides them)
NORM_ROPE_CASES = [dict(shape=(2, 37, 4, dh), dtype=dt, scale_plus_one=sp1)
                   for dt in ("float32", "bfloat16")
                   for dh in (32, 64, 128, 256) for sp1 in (False, True)]
# the registry's full-width cases: the Llama-3.1-8B q of the training
# microbatch, the Gemma-2-9B q of one packed row
NORM_ROPE_SHAPES = {"llama3_8b_train_2x1024": ((2, 1024, 32, 128), False),
                    "gemma2_9b_train_4096": ((1, 4096, 16, 256), True)}


def _norm_rope_inputs(shape, dtype, sp1, dev, g, unaligned=False):
    """x, scale, positions (restarting per document, and the last row's
    last third from 4,095 down), frequencies. ``unaligned``: x is a
    contiguous view 4 bytes past a 16-byte boundary."""
    import torch
    B, S, H, dh = shape
    dt = getattr(torch, dtype)
    n = B * S * H * dh
    flat = torch.randn((n + 8,), generator=g, device=dev).to(dt)
    off = 4 // flat.element_size() if unaligned else 0
    x = flat[off:off + n].view(shape)
    s = (torch.randn((dh,), generator=g, device=dev) * 0.1
         + (0.0 if sp1 else 1.0)).to(dt)
    pos = _packed_rope_positions(B, S, dev, g)
    tail = S - 2 * S // 3
    pos[-1, -tail:] = 4095 - torch.arange(tail, dtype=torch.int32,
                                          device=dev)
    return x, s, pos, _rope_freqs(dh, dev)


def _norm_rope_errors(x, s, pos, f, kw):
    """(max |error|, its scale) of the kernel against its plain version
    on these inputs: the value and the gradients of x and scale under a
    random probe, the plain version's by autograd."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm_rope, fused_rmsnorm_rope_reference)
    g = torch.Generator(device=x.device)
    g.manual_seed(5)
    probe = torch.randn(x.shape, generator=g, device=x.device)
    outs = []
    for fn in (fused_rmsnorm_rope, fused_rmsnorm_rope_reference):
        # the value from x itself (a clone would realign an unaligned
        # view), the gradients from a leaf copy
        y = fn(x, s, pos, f, **kw)
        xg = x.detach().clone().requires_grad_(True)
        sg = s.detach().clone().requires_grad_(True)
        (fn(xg, sg, pos, f, **kw).float() * probe).sum().backward()
        outs.append((y, xg.grad, sg.grad))
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("value", "dx", "dscale"), *outs):
        e = float((got.float() - want.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            e = float("inf")
        scale = float(want.float().abs().max())
        errs[name] = (e, scale if name != "value" else max(1.0, scale))
    return errs


def _check_norm_rope_cases(dev):
    """The per-head rms_norm + RoPE kernel against its plain version over
    NORM_ROPE_CASES (values, dx and dscale), and once on an unaligned
    view of x per dtype (the scalar path)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    cases = NORM_ROPE_CASES + [
        dict(shape=(2, 37, 4, 64), dtype=dt, scale_plus_one=False,
             unaligned=True) for dt in ("float32", "bfloat16")]
    rows = []
    for c in cases:
        x, s, pos, f = _norm_rope_inputs(c["shape"], c["dtype"],
                                         c["scale_plus_one"], dev, g,
                                         c.get("unaligned", False))
        if c.get("unaligned") and not (x.is_contiguous()
                                       and x.data_ptr() % 16):
            raise SystemExit("kernel phase: the unaligned norm + rope case "
                             "got an aligned or strided view")
        kw = dict(eps=1e-6, scale_plus_one=c["scale_plus_one"])
        tol = FUSED_TOL[c["dtype"]]
        row = {"kernel": "fused_rmsnorm_rope", **c, "tol_rel": tol,
               "ok": True}
        for name, (e, scale) in _norm_rope_errors(x, s, pos, f,
                                                  kw).items():
            row[f"max_abs_err_{name}"] = e
            row["ok"] = row["ok"] and e <= tol * scale
        rows.append(row)
    return rows


def _time_norm_rope(dev):
    """The per-head rms_norm + RoPE at NORM_ROPE_SHAPES (bf16), held
    against its plain version and timed against it (no single PyTorch
    call computes it). Bound: x read once and y written once (plus the
    positions, frequencies and scale) over the memory rate, against fp32
    FLOPs (7 an element: square-add, two scalings, half a rotated pair's
    6; and a sincosf per (row, frequency) counted as 2) over the fp32
    rate."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm_rope, fused_rmsnorm_rope_reference)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    tol = FUSED_TOL["bfloat16"]
    out = {}
    for name, (shape, sp1) in NORM_ROPE_SHAPES.items():
        x, s, pos, f = _norm_rope_inputs(shape, "bfloat16", sp1, dev, g)
        kw = dict(eps=1e-6 if sp1 else 1e-5, scale_plus_one=sp1)
        errs = _norm_rope_errors(x, s, pos, f, kw)
        r = _turns(lambda: fused_rmsnorm_rope_reference(x, s, pos, f, **kw),
                   lambda: fused_rmsnorm_rope(x, s, pos, f, **kw), None)
        B, S, H, dh = shape
        nbytes = (2 * x.numel() * x.element_size() + s.numel()
                  * s.element_size() + pos.numel() * 4 + f.numel() * 4)
        flops = 7.0 * x.numel() + 2.0 * B * S * dh // 2
        bound, by = _bound(nbytes, flops, torch.float32)
        r.update({"shape": name, "dims": list(shape),
                  "max_abs_err": errs["value"][0],
                  "max_abs_ref": errs["value"][1],
                  "grad_errs": {k: list(v) for k, v in errs.items()
                                if k != "value"},
                  "tol_rel": tol,
                  "ok": all(e <= tol * sc for e, sc in errs.values()),
                  "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                  "flops": flops, "library": None,
                  "bound_share": bound / r["kernel_ms"]})
        out[name] = r
        del x, s, pos
        torch.cuda.empty_cache()
    return out


# fused cross-entropy cases (N rows, D, V): ragged row tiles (300), the
# hidden widths of the small tests, Gemma-2 and Llama, the vocab sizes of
# Llama-2 / Mistral (32,000) and Llama-3 (128,256) and one no tile
# divides; then odd D and V (no 16-byte rows), and V = 1
CE_CASES = ([dict(N=300, D=D, V=V, dtype=dt)
             for dt in ("float32", "bfloat16") for D in (64, 3584, 4096)
             for V in (1000, 32000, 128256)]
            + [dict(N=130, D=100, V=1001, dtype=dt)
               for dt in ("float32", "bfloat16")]
            + [dict(N=5, D=64, V=1, dtype="bfloat16")])
# the train_fused_ce phase's microbatch: Llama-3.1-8B, 2 x 1,024 rows
CE_LLAMA_SHAPE = dict(N=2048, D=4096, V=128256, dtype="bfloat16")


def _ce_inputs(case, dev, seed=0, in_range=False):
    """Hidden rows of unit scale, a head of std 0.05 (logits of std
    0.05 sqrt(D): 0.4 at D 64, 3.2 at D 4,096), random labels and weights
    in [0.5, 1.5]; unless ``in_range``, one label V + 5, one -1 and five
    weight-0 rows."""
    import torch
    N, D, V = case["N"], case["D"], case["V"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = getattr(torch, case["dtype"])
    x = torch.randn((N, D), generator=g, device=dev).to(dt)
    head = (torch.randn((D, V), generator=g, device=dev) * 0.05).to(dt)
    t = torch.randint(0, V, (N,), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand((N,), generator=g, device=dev) + 0.5
    if not in_range:
        t[min(3, N - 1)] = V + 5
        t[N // 2] = -1
        w[N // 3:N // 3 + 5] = 0.0
    return x, head, t, w


def _ce_errors(case, x, head, t, w):
    """Each cross-entropy kernel against its plain version on these
    inputs (dx and dhead from the plain version's lse), and dx and dhead
    again with every label out of range (``..._softmax``: dl is the
    softmax term alone): ({check: (max |error|, its scale, tolerance)},
    the kernel's target logits, its dx)."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_grads_reference,
        fused_ce_row_stats, fused_ce_row_stats_reference)
    tol = CE_TOL[case["dtype"]]

    def err(got, want, floor):
        e = float((got.float() - want.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            e = float("inf")
        return e, max(floor, float(want.float().abs().max()))
    lse, tgt = fused_ce_row_stats(x, head, t)
    ref_lse, ref_tgt = fused_ce_row_stats_reference(x, head, t)
    (e_l, s_l), (e_t, s_t) = err(lse, ref_lse, 1.0), err(tgt, ref_tgt, 1.0)
    errs = {"fused_ce_row_stats": (max(e_l, e_t), max(s_l, s_t),
                                   tol["stats"])}
    V = head.shape[1]
    off = torch.where(torch.arange(len(t), device=t.device) % 2 == 0,
                      V + 5, -1).to(torch.int32)
    for labels, suffix in ((t, ""), (off, "_softmax")):
        dx = fused_ce_dx(x, head, labels, w, ref_lse)
        dh = fused_ce_dhead(x, head, labels, w, ref_lse)
        torch.cuda.synchronize()
        ref_dx, ref_dh = fused_ce_grads_reference(x, head, labels, w,
                                                  ref_lse)
        errs["fused_ce_dx" + suffix] = err(dx, ref_dx, 0.0) + (tol["grads"],)
        errs["fused_ce_dhead" + suffix] = (err(dh, ref_dh, 0.0)
                                           + (tol["grads"],))
        if not suffix:
            dx_labelled = dx
        del dh, ref_dx, ref_dh
    return errs, tgt, dx_labelled


def _check_ce_cases(dev):
    """The three cross-entropy kernels against their plain versions over
    CE_CASES (dx and dhead also with the softmax term alone, see
    ``_ce_errors``); out-of-range labels give a target logit of 0 and
    weight-0 rows a dx of 0."""
    import torch
    rows = []
    for c in CE_CASES:
        x, head, t, w = _ce_inputs(c, dev)
        errs, tgt, dx = _ce_errors(c, x, head, t, w)
        row = {"kernel": "fused_ce", **c, "ok": True}
        for name, (e, scale, tol) in errs.items():
            row[f"max_abs_err_{name}"] = e
            row[f"scale_{name}"] = scale
            row[f"tol_rel_{name}"] = tol
            row["ok"] = row["ok"] and e <= tol * scale
        N = c["N"]
        row["label_rule_ok"] = (float(tgt[min(3, N - 1)]) == 0.0
                                and float(tgt[N // 2]) == 0.0)
        row["weight0_ok"] = float(
            dx[N // 3:N // 3 + 5].float().abs().max()) == 0.0
        row["ok"] = row["ok"] and row["label_rule_ok"] and row["weight0_ok"]
        rows.append(row)
        del x, head, t, w, tgt, dx
        torch.cuda.empty_cache()
    return rows


def _time_ce_llama_shape(dev):
    """The three cross-entropy kernels at the train_fused_ce phase's
    microbatch (CE_LLAMA_SHAPE, in-range labels), each held against its
    plain version (the bf16 kernels' dl rounding against fp32 dl; dx and
    dhead also with the softmax term alone, see ``_ce_errors``) and
    timed against it and against the unfused route: ``matmul_f32`` to
    fp32 logits, then ``F.cross_entropy`` — two calls — forward (row
    statistics) and its backward to x (dx) or to the head (dhead). Bounds:
    each input read once and each output written once, against 2 N D V
    bf16 FLOPs for the row statistics and 4 N D V (the recompute and the
    gradient product) for dx and dhead. The public calls here must all
    take the wgmma body (``routes``), which is also timed against the
    mma.sync body it replaced, in alternated turns
    (``wgmma_vs_mma_sync``); the row statistics must repeat bitwise."""
    import torch
    import torch.nn.functional as F
    from gke_ray_train_tpu_torch.ops import fused_ce
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_grads_reference,
        fused_ce_row_stats, fused_ce_row_stats_reference)
    from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
    case = CE_LLAMA_SHAPE
    x, head, t, w = _ce_inputs(case, dev, seed=4, in_range=True)
    routes_before = _route_counts()
    errs = _ce_errors(case, x, head, t, w)[0]
    lse, tgt = fused_ce_row_stats(x, head, t)
    again = fused_ce_row_stats(x, head, t)
    stats_repeat = bool(torch.equal(lse, again[0])
                        and torch.equal(tgt, again[1]))
    del again
    N, D, V = case["N"], case["D"], case["V"]
    tl = t.long()

    def unfused_nll(xx, hh):
        return torch.sum(F.cross_entropy(matmul_f32(xx, hh), tl,
                                         reduction="none") * w)
    xg = x.clone().requires_grad_(True)
    hg = head.clone().requires_grad_(True)
    nll_x = unfused_nll(xg, head)
    nll_h = unfused_nll(x, hg)

    def lib_fwd():
        with torch.no_grad():
            return unfused_nll(x, head)
    runs = {
        "fused_ce_row_stats": _turns(
            lambda: fused_ce_row_stats_reference(x, head, t),
            lambda: fused_ce_row_stats(x, head, t), lib_fwd, iters=5),
        "fused_ce_dx": _turns(
            lambda: fused_ce_grads_reference(x, head, t, w, lse),
            lambda: fused_ce_dx(x, head, t, w, lse),
            lambda: torch.autograd.grad(nll_x, xg, retain_graph=True),
            iters=5),
        "fused_ce_dhead": _turns(
            lambda: fused_ce_grads_reference(x, head, t, w, lse),
            lambda: fused_ce_dhead(x, head, t, w, lse),
            lambda: torch.autograd.grad(nll_h, hg, retain_graph=True),
            iters=5),
    }
    # the bodies the public calls above took at this shape
    taken = {k: {r: n - routes_before[k][r] for r, n in v.items()}
             for k, v in _route_counts().items()}
    es = x.element_size()
    ins = (N * D + D * V) * es + 4 * N
    work = {"fused_ce_row_stats": (ins + 8 * N, 2.0 * N * D * V),
            "fused_ce_dx": (ins + 8 * N + N * D * es, 4.0 * N * D * V),
            "fused_ce_dhead": (ins + 8 * N + D * V * es, 4.0 * N * D * V)}
    for name, r in runs.items():
        nbytes, flops = work[name]
        bound, by = _bound(nbytes, flops, x.dtype)
        e, scale, tol = errs[name]
        if name + "_softmax" in errs:
            es_, ss_, _ = errs[name + "_softmax"]
            r.update({"max_abs_err_softmax": es_, "max_abs_ref_softmax": ss_,
                      "ok_softmax": es_ <= tol * ss_})
        r.update({"shape": "llama3_8b_train_2x1024", "bound_ms": bound,
                  "bound_by": by, "bytes": nbytes, "flops": flops,
                  "tflops_per_s": flops / r["kernel_ms"] / 1e9,
                  "max_abs_err": e, "max_abs_ref": scale, "tol_rel": tol,
                  "ok": e <= tol * scale and r.get("ok_softmax", True),
                  "library": "matmul_f32 + F.cross_entropy (two calls"
                  + (", forward)" if name == "fused_ce_row_stats"
                     else ", their backward)")})
        # every public call at this shape went through the wgmma body
        r["routes"] = taken[name]
        r["ok"] = r["ok"] and taken[name]["wgmma"] > 0 and sum(
            taken[name].values()) == taken[name]["wgmma"]
        if name == "fused_ce_row_stats":
            launch = functools.partial(fused_ce._row_stats_launch, x, head,
                                       t)
            r["bitwise_repeat"] = stats_repeat
            r["ok"] = r["ok"] and stats_repeat
        else:
            launch = functools.partial(fused_ce._grad_launch, name, x, head,
                                       t, w, lse)
        r["wgmma_vs_mma_sync"] = _time_routes(
            getattr(fused_ce, name), lambda route: launch(route=route),
            "mma_sync", r["bound_ms"], flops)
    del nll_x, nll_h, xg, hg
    torch.cuda.empty_cache()
    return runs


def phase_kernels(dev):
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = [_check_case(n, c, dev)[0] for n, c in KERNEL_CASES.items()]
    bwd_rows = [_check_bwd_case(n, c, dev) for n, c in KERNEL_CASES.items()]
    bwd_rows.append(_check_bwd_case("llama3_8b_train_1024", TRAIN_SHAPE, dev))
    for n, c in GEMMA_ATTN_CASES.items():
        rows.append(_check_case(n, c, dev)[0])
        bwd_rows.append(_check_bwd_case(n, c, dev))
    timings = []
    for name, case in SERVE_SHAPES.items():
        row, (q, k, v, kw) = _check_case(name, case, dev)
        rows.append(row)
        ref_args = (q, k, v, kw["q_positions"], kw["kv_positions"],
                    kw["q_segment_ids"], kw["kv_segment_ids"])
        ref_kw = dict(causal=kw["causal"],
                      sliding_window=kw["sliding_window"],
                      scale=kw["scale"], logit_softcap=kw["logit_softcap"])
        # the library yardstick: SDPA with the same boolean mask
        from gke_ray_train_tpu_torch.ops.attention import (
            make_attention_mask)
        mask = make_attention_mask(
            kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
            kw["kv_segment_ids"], causal=kw["causal"],
            sliding_window=kw["sliding_window"])[:, None]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def plain():
            return flash_attention_reference(*ref_args, **ref_kw)

        def kernel():
            return flash_attention(q, k, v, **kw)

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                        enable_gqa=True)
        # device time, in turns: plain, kernel, kernel, plain, library
        t = _turns(plain, kernel, library)
        bound, bound_by, nbytes, flops = _bound_ms(q, k, v, kw)
        t.update({"shape": name, "bound_ms": bound, "bound_by": bound_by,
                  "bytes": nbytes, "flops": flops,
                  # per call between CUDA events, host overhead in
                  "call_ms": {"kernel": cuda_ms(kernel),
                              "plain": cuda_ms(plain),
                              "library": cuda_ms(library)},
                  "max_abs_err_out": row["max_abs_err_out"]})
        timings.append(t)
    train = _time_train_shape(dev)
    gemma_attn = _time_gemma_attn(dev)
    fused_rows = _check_fused_cases(dev)
    fused = _time_fused_gemma_shape(dev)
    norm_rope_rows = _check_norm_rope_cases(dev)
    norm_rope = _time_norm_rope(dev)
    ce_rows = _check_ce_cases(dev)
    ce = _time_ce_llama_shape(dev)
    ok = all(r["ok"] for r in rows + bwd_rows + fused_rows + norm_rope_rows
             + ce_rows + list(fused.values()) + list(norm_rope.values())
             + list(ce.values()))
    emit({"phase": "kernels", "ok": ok, "cases": rows, "bwd_cases": bwd_rows,
          "fused_cases": fused_rows, "norm_rope_cases": norm_rope_rows,
          "ce_cases": ce_rows, "timings": timings, "train_shape": train,
          "gemma_train_shape": fused, "gemma_attn_shape": gemma_attn,
          "norm_rope_shapes": norm_rope, "llama_ce_shape": ce,
          "device_ms_timer_calls": dict(TIMER_CALLS)})
    if not ok:
        raise SystemExit("kernel phase: a case disagrees with the plain "
                         "version beyond its tolerance")
    # the summary line carries the Llama shape
    return {**train, **fused, **ce,
            "fused_rmsnorm_rope": norm_rope["llama3_8b_train_2x1024"]}


# ---------------------------------------------------------------------------
# kernelcheck
# ---------------------------------------------------------------------------

def phase_kernelcheck(dev):
    """The port's kernel sweep on the card against the committed CUDA
    pins, with the launch counts at 0 just before it; fails on any
    finding. Returns the sweep's launches per kernel."""
    from gke_ray_train_tpu_torch.analysis import kernelcheck
    _reset_launch_counts()
    t0 = time.perf_counter()
    results = kernelcheck.sweep(device=dev)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    findings = (kernelcheck.registration_findings()
                + kernelcheck.ledger_findings(results, "cuda"))
    cases = []
    for r in results:
        pins = kernelcheck.pinned(r, "cuda") or {}
        cases.append({"kernel": r.kernel, "case": r.case,
                      "value_err": r.value_err, "grad_err": r.grad_err,
                      "pin_value": pins.get("value"),
                      "pin_grad": pins.get("grad"), "seconds": r.seconds})
    emit({"phase": "kernelcheck", "ok": not findings, "seconds": seconds,
          "cases": cases, "findings": [str(f) for f in findings],
          "launches": launches})
    if findings:
        raise SystemExit(f"kernelcheck phase: {len(findings)} finding(s)")
    return launches


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def _requests(n, vocab, seed, plen=(16, 400), new=(16, 64)):
    from gke_ray_train_tpu_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}",
                    token_ids=rng.integers(0, vocab, size=int(
                        rng.integers(plen[0], plen[1] + 1))).astype(np.int32),
                    max_new_tokens=int(rng.integers(new[0], new[1] + 1)))
            for i in range(n)]


def phase_serve(dev):
    import torch
    from gke_ray_train_tpu_torch.models import init_params, llama3_8b
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    cfg = dataclasses.replace(
        llama3_8b(param_dtype="bfloat16", dtype="bfloat16", remat=False),
        max_seq_len=512)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = ExecutionPlan.resolve(env={"MAX_BATCH": "8",
                                      "DECODE_BUCKETS": "256,512"})
    eos = (128001, 128009)
    # warm-up: one short request per bucket on a throwaway engine
    warm = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    warm.run_until_drained(_requests(2, cfg.vocab_size, seed=7,
                                     plen=(100, 300), new=(4, 4)))
    del warm

    reqs = _requests(24, cfg.vocab_size, seed=1234)
    engine = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    comps = engine.run_until_drained(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    stats = engine.stats()

    buckets = sorted({c.bucket for c in comps})
    gen = [c.length - c.prompt_len for c in comps]
    problems = []
    for r, c in zip(reqs, comps):
        g = c.generated
        if not (1 <= len(g) <= r.max_new_tokens):
            problems.append(f"{r.rid}: {len(g)} tokens generated")
        if c.finish_reason == "length" and len(g) != r.max_new_tokens:
            problems.append(f"{r.rid}: length stop after {len(g)}")
        if len(g) and (g.min() < 0 or g.max() >= cfg.vocab_size):
            problems.append(f"{r.rid}: token out of vocab")
        if not np.array_equal(c.tokens[:c.prompt_len], r.token_ids):
            problems.append(f"{r.rid}: prompt region changed")
    if len(comps) != 24 or stats["completed"] != 24:
        problems.append(f"{stats['completed']} of 24 completed")
    if buckets != [256, 512]:
        problems.append(f"buckets used {buckets}, want [256, 512]")
    if stats["refills"] < 1:
        problems.append("no mid-batch refill happened")
    if stats["prefills"] != 24 or launches != cfg.n_layers * 24:
        problems.append(f"flash launches {launches} != n_layers "
                        f"{cfg.n_layers} x prefills {stats['prefills']}")
    ttft = sorted(c.first_token_s for c in comps)
    row = {"phase": "serve", "ok": not problems, "problems": problems,
           "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "init_s": init_s, "requests": len(comps),
           "generated_tokens": int(sum(gen)), "wall_s": wall,
           "tokens_per_s": sum(gen) / wall,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "ttft_max_s": ttft[-1],
           "token_latency_p50_s": stats["p50_token_latency_s"],
           "token_latency_p99_s": stats["p99_token_latency_s"],
           "batch_occupancy": stats["batch_occupancy"],
           "iterations": stats["iterations"], "refills": stats["refills"],
           "prefills": stats["prefills"], "flash_launches": launches,
           "buckets": buckets,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    if problems:
        raise SystemExit("serve phase failed: " + "; ".join(problems))
    del model, engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 5: parity
# ---------------------------------------------------------------------------

def phase_parity(dev):
    import torch
    from gke_ray_train_tpu_torch.models import (
        forward_step, greedy_generate_cached, init_cache, init_params,
        llama3_8b)
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine, form_prompt_buffer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        llama3_8b(dtype="float32", param_dtype="float32", remat=False),
        max_seq_len=512, n_layers=4)
    model = init_params(cfg, seed=1, device=dev)
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                             dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        before = flash_attention.launches
        lf, cf = forward_step(model, prompt,
                              dataclasses.replace(cfg, attn_impl="flash"),
                              init_cache(cfg, 1, 512, device=dev), zero)
        flash_used = flash_attention.launches - before
        lx, cx = forward_step(model, prompt,
                              dataclasses.replace(cfg, attn_impl="xla"),
                              init_cache(cfg, 1, 512, device=dev), zero)
    torch.cuda.synchronize()
    logits_err = float((lf - lx).abs().max())
    cache_err = float(max((cf[n] - cx[n]).abs().max() for n in ("k", "v")))
    finite = bool(torch.isfinite(lf).all())

    plan = ExecutionPlan.from_kwargs(max_batch=4, decode_buckets="256,512")
    eos = (128001, 128009)
    reqs = _requests(10, cfg.vocab_size, seed=99, new=(8, 32))
    engine = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    comps = engine.run_until_drained(reqs)
    mismatched = []
    for r, c in zip(reqs, comps):
        buf, plen = form_prompt_buffer(r.token_ids, c.bucket)
        ref = greedy_generate_cached(
            model, buf, [plen], cfg, max_new_tokens=r.max_new_tokens,
            eos_ids=eos, device=dev)
        if not np.array_equal(ref[0].cpu().numpy(), c.tokens):
            mismatched.append(r.rid)
    stats = engine.stats()
    ok = (logits_err <= PARITY_LOGITS_TOL and finite and not mismatched
          and flash_used == cfg.n_layers and stats["refills"] >= 1)
    emit({"phase": "parity", "ok": ok, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "prefill_logits_max_abs_err": logits_err,
          "tol": PARITY_LOGITS_TOL, "prefill_cache_max_abs_err": cache_err,
          "flash_launches_in_prefill": flash_used,
          "engine_requests": len(comps), "refills": stats["refills"],
          "buckets": sorted({c.bucket for c in comps}),
          "token_identical_to_sequential": not mismatched,
          "mismatched": mismatched})
    if not ok:
        raise SystemExit("parity phase failed")


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

FINE_TUNE_CONFIG = os.path.join(HERE, "ray-jobs", "fine_tune_config.json")
GEMMA2_CONFIG = os.path.join(HERE, "ray-jobs",
                             "fine_tune_config_gemma2_4k.json")


def _sft_batch(n_rows, seq, vocab, rng):
    """Random SFT rows, not packed: each row a real length in
    [seq / 4, seq] of random token ids, then a padding tail of weight 0;
    targets are the inputs shifted by one."""
    toks = rng.integers(0, vocab, (n_rows, seq + 1)).astype(np.int32)
    weights = np.zeros((n_rows, seq), np.float32)
    for i, n in enumerate(rng.integers(seq // 4, seq + 1, n_rows)):
        weights[i, :n] = 1.0
        toks[i, n + 1:] = 0
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "weights": weights}


def _packed_batch(n_rows, seq, vocab, rng):
    """``n_rows`` packed rows (``data/packing.py``) of random documents:
    lengths uniform over 64-1,024 tokens, random ids, the first quarter
    of each a prompt of loss weight 0. A stand-in mix: no length or
    prompt-share statistic of the Gemma-2 job's dataset (tatsu-lab/alpaca
    under the Gemma tokenizer) is in the repository, and the mix sets
    how many documents share a row, so the share of attention tiles that
    are live."""
    from gke_ray_train_tpu_torch.data import pack_examples

    def docs():
        while True:
            n = int(rng.integers(64, 1025))
            w = np.ones(n, np.float32)
            w[:n // 4] = 0.0
            yield {"input_ids": rng.integers(0, vocab, n).astype(np.int32),
                   "loss_weights": w}
    rows = []
    for row in pack_examples(docs(), seq):
        rows.append(row)
        if len(rows) == n_rows:
            return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _counted():
    """{kernel name: its wrapper, which counts its launches}."""
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_row_stats)
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm, fused_rmsnorm_rope, fused_rope_qk)
    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "fused_rmsnorm": fused_rmsnorm,
            "fused_rope_qk": fused_rope_qk,
            "fused_rmsnorm_rope": fused_rmsnorm_rope,
            "fused_ce_row_stats": fused_ce_row_stats,
            "fused_ce_dx": fused_ce_dx, "fused_ce_dhead": fused_ce_dhead}


def _launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


# the kernels that count launches per body: the cross-entropy entries
# (``ops/fused_ce.py::ROUTES``)
_ROUTED = ("fused_ce_row_stats", "fused_ce_dx", "fused_ce_dhead")


def _route_counts():
    """{routed kernel: {route: launches}}."""
    counted = _counted()
    return {name: dict(counted[name].routes) for name in _ROUTED}


def _reset_launch_counts():
    for name, fn in _counted().items():
        fn.launches = 0
        if name in _ROUTED:
            fn.routes = dict.fromkeys(fn.routes, 0)


def _expected_routes(cfg, launches):
    """The route counts of the routed kernels' ``launches`` on ``cfg``'s
    model: every cross-entropy launch on the body ``grad_route`` picks for
    its dtype, d_model and vocab (the train step's operands are fresh,
    aligned allocations)."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_ce import ROUTES, grad_route
    ce = grad_route(getattr(torch, cfg.dtype), cfg.d_model, cfg.vocab_size)
    return {name: {r: launches[name] if r == ce else 0 for r in ROUTES}
            for name in _ROUTED}


def _fine_tune_setup(dev, cfg, n_batches, config=None, **plan_overrides):
    """The QLoRA job of ``config`` (default ray-jobs/fine_tune_config.json)
    at ``cfg`` (default the job's MODEL_ID preset, bf16, remat): NF4 base
    from seed 0, adapters, optimizer and schedule, the step function with
    the job's plan and ``plan_overrides``, and ``n_batches`` batches from
    numpy seed 1234, packed where the job packs."""
    import torch
    from gke_ray_train_tpu_torch.models import (
        init_quantized_params, preset_for_model_id)
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_optimizer, make_train_state, make_train_step,
        warmup_cosine_schedule)
    with open(config or FINE_TUNE_CONFIG) as f:
        ft = json.load(f)
    seq = int(ft["MAX_SEQ_LENGTH"])
    if cfg is None:
        cfg = dataclasses.replace(
            preset_for_model_id(ft["MODEL_ID"], dtype="bfloat16",
                                param_dtype="bfloat16", remat=True),
            max_seq_len=seq)
    plan = ExecutionPlan.resolve(config=ft, env={}, **plan_overrides)
    micro = int(ft["PER_DEVICE_TRAIN_BATCH_SIZE"])
    batch_rows = micro * plan.grad_accum
    # the job's length: NUM_TRAIN_SAMPLES over the global batch
    total = -(-int(ft["NUM_TRAIN_SAMPLES"]) // batch_rows)
    schedule = warmup_cosine_schedule(
        float(ft["LEARNING_RATE"]), total,
        warmup_frac=float(ft["WARMUP_RATIO"]))
    spec = make_optimizer(schedule, weight_decay=float(ft["WEIGHT_DECAY"]),
                          clip_norm=float(ft["MAX_GRAD_NORM"]))
    lcfg = LoraConfig.from_dict(ft)
    t0 = time.perf_counter()
    params = init_quantized_params(cfg, seed=0, kind=ft["QUANT_KIND"],
                                   device=dev)
    state = make_train_state(cfg, spec, seed=0, lora_cfg=lcfg, params=params,
                             device=dev)
    step_fn = make_train_step(cfg, spec, lora_cfg=lcfg, schedule=schedule,
                              plan=plan, device=dev)
    torch.cuda.synchronize()
    rng = np.random.default_rng(1234)
    make = _packed_batch if ft.get("PACKING") else _sft_batch
    batches = [make(batch_rows, seq, cfg.vocab_size, rng)
               for _ in range(n_batches)]
    return dict(cfg=cfg, ft=ft, plan=plan, lcfg=lcfg, micro=micro,
                batch_rows=batch_rows, seq=seq, state=state, step_fn=step_fn,
                batches=batches, init_s=time.perf_counter() - t0)


def expected_launches(cfg, grad_accum: int, fused_ops: bool,
                      full_ft: bool = False) -> dict:
    """Kernel launches of one train step: under remat each block's
    forward runs twice (forward and recomputation), its backward once.
    Per layer and microbatch: flash forward once a forward, dQ and dK/dV
    once; with ``fused_ops`` the 2 (4 with post-block norms) rms_norms
    once a forward (their backward is plain torch) and the RoPE once a
    forward and once in the backward. Per microbatch, with ``fused_ops``
    on a config without a logit softcap: the cross-entropy's row
    statistics and dx once (each entry walks every vocab chunk), dhead
    once in full fine-tuning (the head is frozen under LoRA). The
    per-head rms_norm + RoPE never: no model family calls it."""
    runs = 2 if cfg.remat else 1
    lm = cfg.n_layers * grad_accum
    norms = 4 if cfg.post_block_norm else 2
    ce = grad_accum if fused_ops and cfg.logit_softcap is None else 0
    return {"flash_fwd": runs * lm, "flash_bwd_dq": lm, "flash_bwd_dkv": lm,
            "fused_rmsnorm": norms * runs * lm if fused_ops else 0,
            "fused_rope_qk": (runs + 1) * lm if fused_ops else 0,
            "fused_rmsnorm_rope": 0,
            "fused_ce_row_stats": ce, "fused_ce_dx": ce,
            "fused_ce_dhead": ce if full_ft else 0}


def phase_train(dev, cfg=None, steps: int = 5, config=None,
                phase: str = "train", **plan_overrides):
    """QLoRA fine-tune steps at full width and depth with the settings of
    a job config; by default Llama-3.1-8B with
    ray-jobs/fine_tune_config.json: NF4 base, LoRA r 64 / alpha 16 /
    dropout 0.1 on all projections, microbatch 2 x grad-accum 4 at 1024
    tokens, AdamW (lr 2e-4, wd 0.001) with warmup-cosine and clip 0.3.
    One warm-up step, then ``steps`` timed ones; the launch counts of the
    kernels, and the routes of the cross-entropy's launches, are read over
    the timed steps."""
    import torch
    from gke_ray_train_tpu_torch.train import (
        peak_flops_per_device, train_flops_per_token)
    job = _fine_tune_setup(dev, cfg, steps + 1, config, **plan_overrides)
    cfg, ft, plan, lcfg = job["cfg"], job["ft"], job["plan"], job["lcfg"]
    micro, batch_rows, seq = job["micro"], job["batch_rows"], job["seq"]
    state, step_fn, batches = job["state"], job["step_fn"], job["batches"]
    init_s = job["init_s"]
    del job
    watch = state.lora[0]["wq"]["b"]
    before = watch.detach().clone()

    def one(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, m = step_fn(state, batch)
        m = {k: float(v) for k, v in m.items()}      # waits for the card
        return st, m, time.perf_counter() - t

    state, m, warm_s = one(batches[0])
    emit({"phase": f"{phase}_step", "step": 0, "warmup": True,
          "seconds": warm_s, **m})
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    times, rows = [], [m]
    for i in range(1, steps + 1):
        state, m, dt = one(batches[i])
        times.append(dt)
        rows.append(m)
        emit({"phase": f"{phase}_step", "step": i, "seconds": dt, **m})
    launches = _launch_counts()
    routes = _route_counts()
    per_step = {k: v / steps for k, v in launches.items()}
    want = expected_launches(cfg, plan.grad_accum, plan.fused_ops)
    p50 = sorted(times)[len(times) // 2]
    tokens = batch_rows * seq
    name = torch.cuda.get_device_name(dev)
    flops_tok = train_flops_per_token(cfg, seq, trainable="lora")
    problems = []
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows):
        problems.append("non-finite loss or grad_norm")
    if per_step != want:
        problems.append(f"launches per step {per_step} != {want}")
    if routes != _expected_routes(cfg, launches):
        problems.append(f"routes {routes} != "
                        f"{_expected_routes(cfg, launches)}")
    if torch.equal(before, watch.detach()):
        problems.append("the adapters did not change")
    row = {"phase": phase, "ok": not problems, "problems": problems,
           "nvidia_smi": nvidia_smi_line(),
           "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "fused_ops": plan.fused_ops, "packed": bool(ft.get("PACKING")),
           "quant": ft["QUANT_KIND"], "lora_r": lcfg.r,
           "lora_alpha": lcfg.alpha, "lora_dropout": lcfg.dropout,
           "trainable_params": sum(
               t.numel() for layer in state.lora for ab in layer.values()
               for t in ab.values()),
           "microbatch": micro, "grad_accum": plan.grad_accum, "seq": seq,
           "init_s": init_s, "warmup_step_s": warm_s, "steps": steps,
           "step_s": times, "step_s_p50": p50,
           "tokens_per_s": tokens / p50,
           "real_tokens_per_s": float(np.median(
               [r["tokens"] for r in rows[1:]])) / p50,
           "mfu": tokens / p50 * flops_tok / peak_flops_per_device(name),
           "train_flops_per_token": flops_tok,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_per_step": per_step,
           "routes": routes,
           "losses": [r["loss"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows]}
    emit(row)
    if problems:
        raise SystemExit(f"{phase} phase failed: " + "; ".join(problems))
    del state
    torch.cuda.empty_cache()
    # the launches of the kernels this path runs
    return {k: n for k, n in launches.items() if want[k]}


def phase_train_fused(dev, cfg=None, steps: int = 2):
    """QLoRA steps of Gemma-2-9B at full width and depth (42 layers, d_model
    3,584, vocab 256,128, head dim 256) with the settings of
    ray-jobs/fine_tune_config_gemma2_4k.json plus FUSED_OPS=1: NF4 base,
    LoRA r 32 / alpha 16 / dropout 0.05, microbatch 1 x grad-accum 4 at
    4,096 tokens of packed documents, AdamW (lr 2e-4, wd 0.001),
    warmup-cosine, clip 0.3. The job's v5e-16 mesh becomes one card and
    its ATTN_IMPL a2a the flash kernels (``auto``)."""
    return phase_train(dev, cfg, steps, config=GEMMA2_CONFIG,
                       phase="train_fused", fused_ops=True)


def phase_train_profile(dev, cfg=None, config=None,
                        phase: str = "train_profile", **plan_overrides):
    """Where a QLoRA step's time goes: torch.profiler over one step of the
    train phase's job (or ``config``'s) after one warm-up step. Device
    busy share = summed kernel time over the step's wall time (one
    stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    job = _fine_tune_setup(dev, cfg, 2, config, **plan_overrides)
    state, step_fn = job["state"], job["step_fn"]
    state, m = step_fn(state, job["batches"][0])
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, job["batches"][1])
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    # kernels only: a user annotation (Optimizer.step) spans kernels that
    # are counted on their own
    kern = [e for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    busy_us = sum(e.self_device_time_total for e in kern)
    groups = {"gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
              "flash_kernels": ("flash_fwd", "flash_bwd"),
              "fused_norm_rope": ("rmsnorm_kernel", "rope_qk_kernel"),
              "fused_ce": ("row_stats_kernel", "merge_kernel",
                           "dlogits_kernel", "dx_kernel", "dhead_kernel",
                           "ce_wgmma_kernel"),
              "nf4_lookup": ("index_elementwise",)}
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for e in kern:
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), "other")
        by_group[g] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:25]
    emit({"phase": phase, "ok": busy_us > 0, "wall_s": wall,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall,
          "kernel_launches": sum(e.count for e in kern),
          "device_ms_by_group": by_group,
          "top_kernels": [{"name": e.key[:90],
                           "ms": e.self_device_time_total / 1e3,
                           "calls": e.count} for e in top]})
    if busy_us <= 0:
        raise SystemExit(f"{phase} phase: the trace shows no device time")
    del state, job
    torch.cuda.empty_cache()


def phase_train_fused_profile(dev, cfg=None):
    """The profile of ``phase_train_profile`` over one step of the
    train_fused phase's job."""
    phase_train_profile(dev, cfg, GEMMA2_CONFIG, phase="train_fused_profile",
                        fused_ops=True)


# ---------------------------------------------------------------------------
# phase 7: train-parity
# ---------------------------------------------------------------------------

def _train_run(cfg, mode, impl, dev, steps, batches, fused_ops=False):
    """``steps`` steps of full fine-tuning or QLoRA with attention
    through ``impl`` (and with ``fused_ops`` the fused rms_norm / RoPE
    kernels, and the fused cross-entropy where the config has no logit
    softcap); returns the metric streams and {name: the change that
    trained tensor underwent}."""
    import torch
    from gke_ray_train_tpu_torch.models import init_params
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_optimizer, make_train_state, make_train_step,
        warmup_cosine_schedule)
    from gke_ray_train_tpu_torch.train.step import trainable_tensors
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    lcfg = LoraConfig(r=64, alpha=16) if mode == "qlora" else None
    params = (init_quantized_params(cfg, seed=3, device=dev)
              if mode == "qlora" else init_params(cfg, seed=3, device=dev))
    sched = warmup_cosine_schedule(2e-4, 10, warmup_frac=0.1)
    spec = make_optimizer(sched, weight_decay=0.001, clip_norm=0.3)
    state = make_train_state(cfg, spec, seed=3, lora_cfg=lcfg,
                             params=params, device=dev)
    start = {n: t.detach().clone() for n, t in
             trainable_tensors(state.params, state.lora)}
    fn = make_train_step(cfg, spec, lora_cfg=lcfg, schedule=sched,
                         plan=ExecutionPlan(grad_accum=2,
                                            fused_ops=fused_ops),
                         device=dev)
    streams = {"loss": [], "grad_norm": []}
    for b in batches[:steps]:
        state, m = fn(state, b)
        for k in streams:
            streams[k].append(float(m[k]))
    deltas = {n: t.detach() - start[n] for n, t in
              trainable_tensors(state.params, state.lora)}
    del state, params, start
    torch.cuda.empty_cache()
    return streams, deltas


def _parity_runs(cfg, dev, steps, batches, kernel, plain):
    """For QLoRA and full fine-tuning: the ``kernel`` run (keyword
    arguments of ``_train_run``) against the ``plain`` one — relative
    errors of the loss / grad_norm streams, the relative error of the
    trained tensors' change, and the kernel run's launches against
    ``expected_launches`` (2 microbatches a step), and the cross-entropy
    routed kernels' launches against ``_expected_routes``. Full
    fine-tuning also reports the lm_head's change on each side
    (``lm_head_delta_norm``)."""
    import torch
    rows, ok = [], True
    for mode in ("qlora", "full"):
        before, routes_before = _launch_counts(), _route_counts()
        got, d_got = _train_run(cfg, mode, dev=dev, steps=steps,
                                batches=batches, **kernel)
        used = {k: v - before[k] for k, v in _launch_counts().items()}
        routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
                  for k, v in _route_counts().items()}
        ref, d_ref = _train_run(cfg, mode, dev=dev, steps=steps,
                                batches=batches, **plain)
        num = sum(float(torch.sum((d_got[n] - b) ** 2))
                  for n, b in d_ref.items())
        den = sum(float(torch.sum(b ** 2)) for b in d_ref.values())
        delta_rel = (num / den) ** 0.5 if den > 0 else float("inf")
        rel = {k: max(abs(a - b) / abs(b) for a, b in zip(got[k], ref[k]))
               for k in got}
        want = {k: v * steps for k, v in expected_launches(
            cfg, 2, kernel.get("fused_ops", False),
            full_ft=mode == "full").items()}
        row_ok = (all(v <= TRAIN_PARITY_RTOL for v in rel.values())
                  and delta_rel <= TRAIN_PARITY_DELTA_RTOL
                  and used == want
                  and routes == _expected_routes(cfg, used)
                  and all(np.isfinite(got["loss"] + ref["loss"])))
        ok = ok and row_ok
        rows.append({"mode": mode, "ok": row_ok, "kernel_run": got,
                     "plain_run": ref, "max_rel_err": rel,
                     "delta_rel_err": delta_rel, "launches": used,
                     "routes": routes})
        if "lm_head" in d_ref:
            rows[-1]["lm_head_delta_norm"] = [
                float(torch.linalg.vector_norm(d["lm_head"]))
                for d in (d_got, d_ref)]
        del d_got, d_ref
    return rows, ok


def phase_train_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), 4 layers at full width, dropout 0: QLoRA and full
    fine-tuning, each with attention through the kernels (flash) and
    through the dense path (xla), hold each other's loss and grad_norm
    streams and trained tensors."""
    import torch
    from gke_ray_train_tpu_torch.models import llama3_8b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            llama3_8b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(77)
    batches = [_sft_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    rows, ok = _parity_runs(cfg, dev, steps, batches, dict(impl="flash"),
                            dict(impl="xla"))
    emit({"phase": "train_parity", "ok": ok, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "steps": steps,
          "kernel_run": "flash", "plain_run": "xla",
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL, "runs": rows})
    if not ok:
        raise SystemExit("train-parity phase failed")


def phase_train_fused_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), Gemma-2 at full width and 4 layers, dropout 0,
    packed rows of 1,024 tokens: QLoRA and full fine-tuning with
    FUSED_OPS=1 against FUSED_OPS=0, attention through the flash kernels
    on both sides, hold each other's loss and grad_norm streams (the
    1e-4 relative bound of the JAX package's tests/test_overlap.py) and
    trained tensors."""
    import torch
    from gke_ray_train_tpu_torch.models import gemma2_9b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            gemma2_9b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(78)
    batches = [_packed_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    rows, ok = _parity_runs(cfg, dev, steps, batches,
                            dict(impl="flash", fused_ops=True),
                            dict(impl="flash", fused_ops=False))
    emit({"phase": "train_fused_parity", "ok": ok, "dtype": "float32",
          "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "steps": steps,
          "kernel_run": "FUSED_OPS=1", "plain_run": "FUSED_OPS=0",
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL, "runs": rows})
    if not ok:
        raise SystemExit("train-fused-parity phase failed")


def phase_train_fused_ce(dev, cfg=None, steps: int = 5):
    """The train phase's job (Llama-3.1-8B QLoRA with
    ray-jobs/fine_tune_config.json's settings, full width and depth) with
    FUSED_OPS=1: Llama has no logit softcap, so the loss runs through the
    fused cross-entropy on the final-normed hidden state, and the blocks'
    rms_norms and q/k RoPE through the fused kernels."""
    return phase_train(dev, cfg, steps, phase="train_fused_ce",
                       fused_ops=True)


def phase_train_fused_ce_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), Llama-3.1-8B at full width (vocab 128,256) and 4
    layers, dropout 0: QLoRA and full fine-tuning with FUSED_OPS=1 (the
    fused cross-entropy, rms_norm and RoPE) against FUSED_OPS=0, attention
    through the flash kernels on both sides, hold each other's loss and
    grad_norm streams and trained tensors (the lm_head among them in full
    fine-tuning, where it must move). Returns the dhead
    launches of the fused full fine-tuning run, the one path that forms
    dhead."""
    import torch
    from gke_ray_train_tpu_torch.models import llama3_8b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            llama3_8b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(79)
    batches = [_sft_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    rows, ok = _parity_runs(cfg, dev, steps, batches,
                            dict(impl="flash", fused_ops=True),
                            dict(impl="flash", fused_ops=False))
    for row in rows:
        if row["mode"] == "full":
            # the delta check holds the lm_head's change alike on both
            # sides; this holds that there is one
            row["ok"] = row["ok"] and min(row["lm_head_delta_norm"]) > 0
            ok = ok and row["ok"]
    emit({"phase": "train_fused_ce_parity", "ok": ok, "dtype": "float32",
          "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "steps": steps,
          "kernel_run": "FUSED_OPS=1", "plain_run": "FUSED_OPS=0",
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL, "runs": rows})
    if not ok:
        raise SystemExit("train-fused-ce-parity phase failed")
    return {"fused_ce_dhead": next(r["launches"]["fused_ce_dhead"]
                                   for r in rows if r["mode"] == "full")}


def phase_train_fused_ce_profile(dev, cfg=None):
    """The profile of ``phase_train_profile`` over one step of the
    train_fused_ce phase's job."""
    phase_train_profile(dev, cfg, phase="train_fused_ce_profile",
                        fused_ops=True)


# ---------------------------------------------------------------------------
# optional phase: profile (not run by default)
# ---------------------------------------------------------------------------

def phase_profile(dev, steps: int = 10):
    """Where a decode iteration's time goes at the serve phase's model:
    torch.profiler over ``steps`` pure-decode iterations of a full batch
    (8 slots, bucket 512). Device busy share = summed kernel time over
    the window's wall time (one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gke_ray_train_tpu_torch.models import init_params, llama3_8b
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    cfg = dataclasses.replace(
        llama3_8b(param_dtype="bfloat16", dtype="bfloat16", remat=False),
        max_seq_len=512)
    model = init_params(cfg, seed=0, device=dev)
    plan = ExecutionPlan.from_kwargs(max_batch=8, decode_buckets="512")
    engine = BatchEngine(model, cfg, plan=plan, device=dev)
    for r in _requests(8, cfg.vocab_size, seed=3, plen=(300, 400),
                       new=(64, 64)):
        engine.submit(r)
    for _ in range(3):              # admits all 8, then decodes
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "ok": busy_us > 0, "steps": steps,
          "batch": 8, "bucket": 512, "wall_s": wall,
          "wall_ms_per_step": wall / steps * 1e3,
          "device_busy_ms_per_step": busy_us / steps / 1e3,
          "device_busy_share": busy_us / 1e6 / wall,
          "kernel_launches_per_step": launches / steps,
          "top_kernels": [{"name": e.key[:80],
                           "ms_per_step": e.self_device_time_total
                           / steps / 1e3,
                           "calls_per_step": e.count / steps}
                          for e in top]})
    if busy_us <= 0:
        raise SystemExit("profile phase: the trace shows no device time")


# ---------------------------------------------------------------------------

PHASES = ("device", "build", "kernels", "kernelcheck", "serve", "parity",
          "train", "train_parity", "train_fused", "train_fused_parity",
          "train_fused_ce", "train_fused_ce_parity", "profile",
          "train_profile", "train_fused_profile", "train_fused_ce_profile")
DEFAULT_PHASES = PHASES[:-4]

KERNEL_SOURCES = {
    "flash_fwd": ("gke_ray_train_tpu_torch/csrc/flash_fwd.cu",
                  "gke_ray_train_tpu/ops/flash_attention.py:175"),
    "flash_bwd_dq": ("gke_ray_train_tpu_torch/csrc/flash_bwd.cu",
                     "gke_ray_train_tpu/ops/flash_attention.py:303"),
    "flash_bwd_dkv": ("gke_ray_train_tpu_torch/csrc/flash_bwd.cu",
                      "gke_ray_train_tpu/ops/flash_attention.py:339"),
    "fused_rmsnorm": ("gke_ray_train_tpu_torch/csrc/fused_norm_rope.cu",
                      "gke_ray_train_tpu/ops/fused_norm_rope.py:96"),
    "fused_rope_qk": ("gke_ray_train_tpu_torch/csrc/fused_norm_rope.cu",
                      "gke_ray_train_tpu/ops/fused_norm_rope.py:103"),
    "fused_rmsnorm_rope": ("gke_ray_train_tpu_torch/csrc/fused_norm_rope.cu",
                           "gke_ray_train_tpu/ops/fused_norm_rope.py:112"),
    "fused_ce_row_stats": ("gke_ray_train_tpu_torch/csrc/fused_ce.cu",
                           "gke_ray_train_tpu/ops/fused_ce.py:70"),
    "fused_ce_dx": ("gke_ray_train_tpu_torch/csrc/fused_ce.cu",
                    "gke_ray_train_tpu/ops/fused_ce.py:106"),
    "fused_ce_dhead": ("gke_ray_train_tpu_torch/csrc/fused_ce.cu",
                       "gke_ray_train_tpu/ops/fused_ce.py:133"),
}


# the wgmma entries the build line reports on their own: (source, entry
# pattern, {template argument: name})
_WGMMA_ENTRIES = (
    ("flash_bwd", r"flash_bwd_dq_wgmma_kernelILi(\d+)E",
     {"64": "dq_dh64", "128": "dq_dh128", "256": "dq_dh256"}),
    ("fused_ce", r"ce_wgmma_kernelILi(\d)E",
     {"0": "dlogits", "1": "dx", "2": "dhead", "3": "row_stats"}),
)


def _wgmma_ptxas(report):
    """The dQ and fused cross-entropy wgmma entries from the build report:
    {source: {name: {"registers", "stack", "spill_stores",
    "spill_loads"}}}, and ptxas's warnings on those sources."""
    out = {}
    for source, pattern, names in _WGMMA_ENTRIES:
        rows = out.setdefault(source, {})
        for e in report.get(source, {}).get("ptxas", []):
            m = re.search(pattern, e.get("entry", ""))
            if m:
                rows[names[m.group(1)]] = {k: v for k, v in e.items()
                                           if k != "entry"}
            elif "warning" in e:
                rows.setdefault("warnings", []).append(e["warning"])
    return out


def _spills(wgmma_ptxas):
    """The reported wgmma entries that spill ("source/name")."""
    return sorted(f"{src}/{name}" for src, rows in wgmma_ptxas.items()
                  for name, e in rows.items() if name != "warnings"
                  and (e.get("spill_stores") or e.get("spill_loads")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all but the four profiles)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gke_ray_train_tpu_torch import kernels

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "ok": True, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    report = kernels.build()
    wgmma = _wgmma_ptxas(report)
    spills = _spills(wgmma)
    emit({"phase": "build", "ok": not spills,
          "seconds": time.perf_counter() - t0, "wgmma_ptxas": wgmma,
          "spills": spills, "kernels": report})
    if spills:
        raise SystemExit(f"build phase: wgmma kernels spill: {spills}")

    # launches on the main paths: each path driven with the counts at 0
    launches = {name: None for name in KERNEL_SOURCES}
    seconds = {}

    def run(phase, fn):
        if phase not in phases:
            return None
        t = time.perf_counter()
        out = fn(dev)
        seconds[phase] = time.perf_counter() - t
        return out

    def add(counts):
        for name, n in (counts or {}).items():
            launches[name] = (launches[name] or 0) + n
    timings = run("kernels", phase_kernels) or {}
    add(run("kernelcheck", phase_kernelcheck))
    serve = run("serve", phase_serve)
    add({"flash_fwd": serve} if serve is not None else None)
    run("parity", phase_parity)
    add(run("train", phase_train))
    run("train_parity", phase_train_parity)
    add(run("train_fused", phase_train_fused))
    run("train_fused_parity", phase_train_fused_parity)
    add(run("train_fused_ce", phase_train_fused_ce))
    add(run("train_fused_ce_parity", phase_train_fused_ce_parity))
    run("profile", phase_profile)
    run("train_profile", phase_train_profile)
    run("train_fused_profile", phase_train_fused_profile)
    run("train_fused_ce_profile", phase_train_fused_ce_profile)
    emit({"phase": "seconds", "ok": True, "seconds": seconds})
    idle = sorted(name for name, n in launches.items() if n == 0)
    if idle:
        raise SystemExit(f"kernels of a driven path never launched: {idle}")

    entries = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        t = timings.get(name, {})
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": t.get("max_abs_err"),
                        "ms": t.get("kernel_ms"),
                        "plain_ms": t.get("plain_ms"),
                        "bound_ms": t.get("bound_ms"),
                        "bound_by": t.get("bound_by"),
                        "library_ms": t.get("library_ms")})
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
