#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gke_ray_train_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — nvidia-smi name and power limit, torch / CUDA versions.
2. build   — compile every CUDA kernel of the port from ``csrc/`` with
             nvcc for sm_90a (all sources at once).
3. kernels — hold each kernel against its plain PyTorch version on the
             card over the listed cases, and time kernel, plain version
             and the PyTorch library call at the serving shapes (device
             time from torch.profiler; per-call time between CUDA events
             beside it).
4. serve   — Llama-3.1-8B at full width and depth (bf16, random weights
             from a seed) through ``BatchEngine``: 24 requests over the
             256 and 512 buckets; the flash kernel must have run once per
             layer per prefill.
5. parity  — the same widths in float32 at 4 layers: flash-path prefill
             logits against the dense path, and every engine completion
             token-identical to the sequential ``greedy_generate_cached``.

The second-to-last line is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
# fp32 logits of the flash prefill path against the dense path, 4 layers
PARITY_LOGITS_TOL = 1e-3


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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: the summed time of every kernel
    ``fn`` launches (torch.profiler / CUPTI), without the host gaps
    between them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    if us <= 0:
        raise SystemExit("device_ms: the profiler recorded no device time")
    return us / iters / 1e3


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
}

# the serving path's prefill shapes: Llama-3.1-8B, one prompt per prefill
SERVE_SHAPES = {f"llama3_8b_prefill_{n}": dict(B=1, S=n, T=n, H=32, K=8,
                                               dh=128, dtype="bfloat16")
                for n in (256, 512)}


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


def _bound_ms(q, k, v, kw):
    """Least time for the function on these inputs: bytes each input read
    once and each output written once over the memory rate, against the
    FLOPs of the (q, kv) pairs these inputs' mask keeps over the peak
    rate of the input type."""
    import torch
    from gke_ray_train_tpu_torch.ops.attention import make_attention_mask
    B, S, H, dh = q.shape
    T = k.shape[1]
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es \
        + B * H * S * 4 + 4 * 2 * B * (S + T)
    mask = make_attention_mask(kw["q_positions"], kw["kv_positions"],
                               kw["q_segment_ids"], kw["kv_segment_ids"],
                               causal=kw["causal"],
                               sliding_window=kw["sliding_window"])
    pairs = int(mask.sum())                 # per batch row, summed
    flops = 4.0 * dh * H * pairs            # QK^T and PV, 2 FLOPs a MAC
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernels(dev):
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = [_check_case(n, c, dev)[0] for n, c in KERNEL_CASES.items()]
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
        plain_a, kern_a, kern_b, plain_b, lib = (
            device_ms(f) for f in (plain, kernel, kernel, plain, library))
        bound, bound_by, nbytes, flops = _bound_ms(q, k, v, kw)
        timings.append({"shape": name, "kernel_ms": min(kern_a, kern_b),
                        "kernel_ms_runs": [kern_a, kern_b],
                        "plain_ms": min(plain_a, plain_b),
                        "plain_ms_runs": [plain_a, plain_b],
                        "library_ms": lib, "bound_ms": bound,
                        "bound_by": bound_by, "bytes": nbytes,
                        "flops": flops,
                        # per call between CUDA events, host overhead in
                        "call_ms": {"kernel": cuda_ms(kernel),
                                    "plain": cuda_ms(plain),
                                    "library": cuda_ms(library)},
                        "max_abs_err_out": row["max_abs_err_out"]})
    ok = all(r["ok"] for r in rows)
    emit({"phase": "kernels", "ok": ok, "cases": rows, "timings": timings})
    if not ok:
        raise SystemExit("kernel phase: a case disagrees with the plain "
                         "version beyond its tolerance")
    return timings


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
    flash_attention.launches = 0
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

PHASES = ("device", "build", "kernels", "serve", "parity", "profile")
DEFAULT_PHASES = PHASES[:-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all but profile)")
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
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "kernels": report})

    timings = phase_kernels(dev) if "kernels" in phases else []
    launches = phase_serve(dev) if "serve" in phases else None
    if "parity" in phases:
        phase_parity(dev)
    if "profile" in phases:
        phase_profile(dev)

    main_shape = next((t for t in timings
                       if t["shape"] == "llama3_8b_prefill_512"), None)
    entry = {"name": "flash_fwd", "route": "cuda",
             "source": "gke_ray_train_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "gke_ray_train_tpu/ops/flash_attention.py:175",
             "launches": launches,
             "max_abs_err": main_shape and main_shape["max_abs_err_out"],
             "ms": main_shape and main_shape["kernel_ms"],
             "plain_ms": main_shape and main_shape["plain_ms"],
             "bound_ms": main_shape and main_shape["bound_ms"],
             "bound_by": main_shape and main_shape["bound_by"],
             "library_ms": main_shape and main_shape["library_ms"]}
    print(smi, flush=True)
    emit({"kernels": [entry]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
