"""The port's CUDA kernels and its serving and training paths on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: the kernels have no CPU mode. The file imports neither JAX nor the
JAX package, so on the GPU machine it runs without them:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

Tolerances (absolute, kernel against ``flash_attention_reference`` on
the same inputs): float32 2e-5 for out and lse (fp32 accumulation in
another order); bfloat16 2e-2 for out (probabilities rounded to bf16
against the running row max instead of the final one, output rounded to
bf16) and 1e-4 for lse (fp32 from unrounded probabilities). The
backward kernels against ``flash_attention_bwd_reference``: max |error|
of dq, dk, dv relative to max(1, max |reference|), 1e-4 in float32 and
2e-2 in bfloat16 (P and dS round to bf16 at the same points on both
sides; a last-bit fp32 difference may round either way). The fused
rms_norm and q/k RoPE kernels against their plain versions: max |error|
relative to max(1, max |reference|), 1e-5 in float32 and 8e-3 in
bfloat16 (both sides compute in fp32 and round once; the fp32 sum order
and ``rsqrtf`` may move the last bit, which can round a bf16 output to
its neighbour); the same for the per-head rms_norm + RoPE kernel's
values, and its gradients within those limits of max |reference| (the
backward is fp32 torch on both sides). The kernel sweep
(``analysis/kernelcheck.py``) holds every registered case within its
committed CUDA pin. The fused cross-entropy kernels against their plain
versions: lse and the target logit within 2e-5 (float32) / 1e-4
(bfloat16) of max(1, max |reference|) (fp32 sums over D and the vocab in
other orders; bf16 products are exact in fp32); dx and dhead within 1e-4
(float32) / 1e-2 (bfloat16) of max |reference| (bf16 rounds dl to bf16,
2^-9 relative, before the products, and the outputs to bf16). Batches
placed on the card (``data/prefetch.py::make_place_batch``) equal their
numpy arrays exactly, and a tiny model's losses are bitwise the same with
and without prefetching.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gke_ray_train_tpu_torch.models import (
    greedy_generate_cached, init_params, init_quantized_params, llama3_8b,
    tiny)
from gke_ray_train_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_reference, flash_attention_reference,
    flash_bwd_dkv, flash_bwd_dq)
from gke_ray_train_tpu_torch.ops.fused_ce import (
    _CHUNK, _grad_launch, _row_stats_launch, fused_ce_dhead, fused_ce_dx,
    fused_ce_grads_reference, fused_ce_row_stats,
    fused_ce_row_stats_reference, fused_cross_entropy, grad_route)
from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
    _rmsnorm_launch, fused_rmsnorm, fused_rmsnorm_reference,
    fused_rmsnorm_rope, fused_rmsnorm_rope_reference, fused_rope_qk,
    fused_rope_qk_reference, norm_route)
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.serve import (
    BatchEngine, Request, form_prompt_buffer)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 1e-4)}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

CASES = {
    # dh 64: packed documents, trailing padding, a ragged length
    "packed_dh64": dict(B=2, S=200, T=200, H=4, K=4, dh=64, packed=True),
    # dh 128: GQA 32/8, causal, a ragged kv tail, rows that attend nothing
    "gqa_dh128": dict(B=1, S=130, T=200, H=32, K=8, dh=128, dead_rows=True),
    # dh 256 (Gemma-2): sliding window and logit softcap
    "window_softcap_dh256": dict(B=1, S=192, T=192, H=4, K=2, dh=256,
                                 window=48, softcap=50.0),
    # the edges of the bf16 wgmma bodies: TMA tails (S, T not multiples
    # of 64 or 128) with S < T; a cluster of 7 query heads (Qwen2's
    # 28 / 4) and of 1 (MHA); dh 256 with window, softcap, packed
    # documents and rows that attend nothing; a row of interior tiles
    # only (one segment, not causal: no tile runs the mask)
    "tail_s_lt_t_dh128": dict(B=2, S=77, T=333, H=8, K=2, dh=128),
    "gqa7_dh128": dict(B=1, S=300, T=300, H=14, K=2, dh=128),
    "mha_dh64": dict(B=2, S=256, T=256, H=4, K=4, dh=64),
    "packed_window_softcap_dh256": dict(B=1, S=700, T=700, H=4, K=2,
                                        dh=256, window=128, softcap=50.0,
                                        packed=True, dead_rows=True),
    "interior_dh128": dict(B=1, S=512, T=512, H=4, K=2, dh=128,
                           causal=False),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, dtype, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, S, T, H, K, dh = (case[x] for x in ("B", "S", "T", "H", "K", "dh"))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    qp = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    qs = torch.ones((B, S), dtype=torch.int32, device=dev)
    ks = torch.ones((B, T), dtype=torch.int32, device=dev)
    if case.get("packed"):
        seg = torch.ones((T,), dtype=torch.int32, device=dev)
        seg[T // 3:2 * T // 3] = 2
        seg[2 * T // 3:] = 0
        qs = ks = seg.expand(B, T)
    if case.get("dead_rows"):
        qs = qs.clone()
        qs[:, 3:7] = 9                       # no key carries segment 9
    kw = dict(q_positions=qp.contiguous(), kv_positions=kp.contiguous(),
              q_segment_ids=qs.contiguous(), kv_segment_ids=ks.contiguous(),
              causal=case.get("causal", True),
              sliding_window=case.get("window"),
              scale=dh ** -0.5, logit_softcap=case.get("softcap"))
    return randn(B, S, H, dh), randn(B, T, K, dh), randn(B, T, K, dh), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_plain_version(dev, case, dtype):
    q, k, v, kw = _inputs(CASES[case], dtype, dev)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(
        q, k, v, kw["q_positions"], kw["kv_positions"],
        kw["q_segment_ids"], kw["kv_segment_ids"], causal=kw["causal"],
        sliding_window=kw["sliding_window"], scale=kw["scale"],
        logit_softcap=kw["logit_softcap"])
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert float((out.float() - ref.float()).abs().max()) <= tol_out
    assert float((lse - ref_lse).abs().max()) <= tol_lse
    if CASES[case].get("dead_rows"):
        assert float(out[:, 3:7].float().abs().max()) == 0.0
        assert bool((lse[:, :, 3:7] == -2.0e38).all())


def test_flash_kernel_refuses_what_it_cannot_take(dev):
    q = torch.zeros((1, 128, 4, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    h = torch.zeros((1, 128, 4, 64), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(h, h, h)
    flat = torch.zeros(128 * 4 * 64 + 1, dtype=torch.bfloat16, device=dev)
    odd = flat[1:].view(1, 128, 4, 64)           # 2 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(odd, odd, odd)


def test_engine_on_card_matches_sequential_greedy(dev):
    """fp32 tiny model on the card through the flash prefill: the engine's
    completions equal batch-1 greedy, token for token, and the kernel ran
    once per layer per prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        tiny(vocab_size=512, d_model=128, n_heads=2, n_kv_heads=1,
             n_layers=2, d_ff=256), max_seq_len=256)
    assert cfg.resolved_attn_impl(dev) == "flash"
    model = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}", rng.integers(1, 512, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(10, 20), (90, 30), (150, 40),
                                        (40, 12), (5, 8)])]
    eng = BatchEngine(model, cfg, plan=ExecutionPlan(
        max_batch=2, decode_buckets="128,256"), device=dev)
    before = flash_attention.launches
    comps = eng.run_until_drained(reqs)
    assert flash_attention.launches - before == \
        cfg.n_layers * eng.stats()["prefills"] == cfg.n_layers * len(reqs)
    assert eng.refills >= 1 and {c.bucket for c in comps} == {128, 256}
    for r, c in zip(reqs, comps):
        buf, plen = form_prompt_buffer(r.token_ids, c.bucket)
        want = greedy_generate_cached(model, buf, [plen], cfg,
                                      max_new_tokens=r.max_new_tokens,
                                      device=dev)
        np.testing.assert_array_equal(c.tokens, want[0].cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_backward_kernels_match_plain_version(dev, case, dtype):
    q, k, v, kw = _inputs(CASES[case], dtype, dev)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev).to(dtype)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    mask = (kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
            kw["kv_segment_ids"])
    mkw = {n: kw[n] for n in ("causal", "sliding_window", "scale",
                              "logit_softcap")}
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, do, lse, dvec, *mask, **mkw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec, *mask, **mkw)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do, *mask, **mkw)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= \
            BWD_TOL[dtype] * scale
    if CASES[case].get("dead_rows"):
        assert float(dq[:, 3:7].float().abs().max()) == 0.0


def test_dkv_kernel_is_deterministic(dev):
    """The bf16 dK/dV kernel sums the GQA group in a fixed order (a
    cluster reduction, no atomics): two launches agree bitwise."""
    q, k, v, kw = _inputs(CASES["gqa7_dh128"], torch.bfloat16, dev)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev).to(torch.bfloat16)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, dvec, kw["q_positions"], kw["kv_positions"],
            kw["q_segment_ids"], kw["kv_segment_ids"])
    mkw = {n: kw[n] for n in ("causal", "sliding_window", "scale",
                              "logit_softcap")}
    first = flash_bwd_dkv(*args, **mkw)
    second = flash_bwd_dkv(*args, **mkw)
    torch.cuda.synchronize()
    assert all(bool(torch.equal(a, b)) for a, b in zip(first, second))


# dQ on the wgmma body: every head dim; causal, window + softcap, packed
# documents and rows that attend nothing; S and T that no tile divides
# (S < T too); GQA groups of 1, 2, 4 and 8; a row of interior tiles only
DQ_CASES = {
    "g1_dh64_packed": dict(B=2, S=200, T=200, H=4, K=4, dh=64, packed=True),
    "g2_dh128_ragged_dead_rows": dict(B=1, S=130, T=200, H=8, K=4, dh=128,
                                      dead_rows=True),
    "g4_dh128_window_softcap": dict(B=1, S=300, T=300, H=16, K=4, dh=128,
                                    window=48, softcap=50.0),
    "g8_dh256_packed_window_softcap": dict(B=1, S=190, T=190, H=16, K=2,
                                           dh=256, window=64, softcap=50.0,
                                           packed=True, dead_rows=True),
    "g8_dh256_causal": dict(B=2, S=129, T=129, H=8, K=1, dh=256),
    "g2_dh256_tail_s_lt_t": dict(B=2, S=77, T=333, H=4, K=2, dh=256),
    "g2_dh64_interior": dict(B=1, S=512, T=512, H=4, K=2, dh=64,
                             causal=False),
}


def _dq_inputs(case, dtype, dev):
    """(kernel arguments, mask keywords, plain dQ) of a DQ_CASES case."""
    q, k, v, kw = _inputs(case, dtype, dev)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev).to(dtype)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    mask = (kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
            kw["kv_segment_ids"])
    mkw = {n: kw[n] for n in ("causal", "sliding_window", "scale",
                              "logit_softcap")}
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do, *mask,
                                        **mkw)[0]
    return (q, k, v, do, lse, dvec) + mask, mkw, ref


def _assert_dq(got, want, case):
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= \
        BWD_TOL[got.dtype] * scale
    if case.get("dead_rows"):
        assert float(got[:, 3:7].float().abs().max()) == 0.0


@pytest.mark.parametrize("case", DQ_CASES)
def test_dq_wgmma_body_matches_plain_version(dev, case):
    """The dQ entry's bf16 (wgmma) body, launched and counted once, within
    BWD_TOL of the plain version."""
    args, mkw, ref = _dq_inputs(DQ_CASES[case], torch.bfloat16, dev)
    before = flash_bwd_dq.launches
    dq = flash_bwd_dq(*args, **mkw)
    torch.cuda.synchronize()
    assert flash_bwd_dq.launches == before + 1
    _assert_dq(dq, ref, DQ_CASES[case])


@pytest.mark.parametrize("case", ["g4_dh128_window_softcap",
                                  "g8_dh256_packed_window_softcap"])
def test_dq_wgmma_body_repeats_bitwise(dev, case):
    """Every dQ element is summed by one CTA in kv order (no atomics): two
    launches agree bitwise."""
    args, mkw, _ = _dq_inputs(DQ_CASES[case], torch.bfloat16, dev)
    first = flash_bwd_dq(*args, **mkw)
    again = flash_bwd_dq(*args, **mkw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_dkv_kernel_refuses_a_group_past_its_cluster(dev):
    q = torch.zeros((1, 128, 9, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 128, 1, 64), dtype=torch.bfloat16, device=dev)
    lse = torch.zeros((1, 9, 128), device=dev)
    pos = torch.arange(128, dtype=torch.int32, device=dev)[None]
    seg = torch.ones((1, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="cluster"):
        flash_bwd_dkv(q, kv, kv, q, lse, lse, pos, pos, seg, seg,
                      causal=True, sliding_window=None, scale=0.125,
                      logit_softcap=None)


def test_autograd_reaches_the_backward_kernels(dev):
    q, k, v, kw = _inputs(CASES["gqa_dh128"], torch.float32, dev)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    flash_attention(q, k, v, **kw).square().sum().backward()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))


def test_qlora_step_at_full_width_on_card(dev):
    """Two layers of Llama-3.1-8B at full width, NF4 base, bf16: one
    QLoRA step with grad-accum 2 through the kernels."""
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_optimizer, make_train_state, make_train_step)
    cfg = dataclasses.replace(
        llama3_8b(dtype="bfloat16", param_dtype="bfloat16"),
        n_layers=2, max_seq_len=512)
    lcfg = LoraConfig(r=64, alpha=16, dropout=0.1)
    spec = make_optimizer(2e-4, weight_decay=0.001, clip_norm=0.3)
    state = make_train_state(cfg, spec, lora_cfg=lcfg,
                             params=init_quantized_params(cfg, device=dev),
                             device=dev)
    step = make_train_step(cfg, spec, lora_cfg=lcfg, grad_accum=2,
                           device=dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 513)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "weights": np.ones((4, 512), np.float32)}
    before = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    b0 = state.lora[1]["w_down"]["b"].detach().clone()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx(np.log(cfg.vocab_size), rel=0.1)
    # remat: forward and recomputation per layer and microbatch
    assert (flash_attention.launches - before[0],
            flash_bwd_dq.launches - before[1],
            flash_bwd_dkv.launches - before[2]) == (8, 4, 4)
    assert not torch.equal(b0, state.lora[1]["w_down"]["b"].detach())


FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= \
        FUSED_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 3584, 4096, 100])
def test_fused_rmsnorm_kernel_matches_plain_version(dev, D, dtype):
    """Rows that no block size divides, D that is not a power of two (and
    one that no 16-byte vector divides), both scale parameterizations;
    the gradient reaches x and scale."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((3, 37, D), generator=g, device=dev).to(dtype)
    for sp1 in (False, True):
        s = (torch.randn((D,), generator=g, device=dev) * 0.1
             + (0.0 if sp1 else 1.0)).to(dtype)
        before = fused_rmsnorm.launches
        y = fused_rmsnorm(x, s, eps=1e-6, scale_plus_one=sp1)
        torch.cuda.synchronize()
        assert fused_rmsnorm.launches == before + 1
        _close(y, fused_rmsnorm_reference(x, s, eps=1e-6,
                                          scale_plus_one=sp1), dtype)
    xg = x.clone().requires_grad_(True)
    sg = s.clone().requires_grad_(True)
    fused_rmsnorm(xg, sg, eps=1e-6, scale_plus_one=True).float().square(
        ).sum().backward()
    assert bool(torch.isfinite(xg.grad.float()).all())
    assert sg.grad is not None and sg.grad.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 4, 2, 32), (1, 4096, 16, 8, 256),
                                   (2, 1024, 32, 8, 128), (1, 50, 2, 1, 6)])
def test_fused_rope_qk_kernel_matches_plain_version(dev, shape, dtype):
    """Packed positions that restart, and positions up to 8,191; the
    negated-frequency launch (the backward) against the plain version
    and as the inverse rotation."""
    B, S, H, K, dh = shape
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, K, dh), generator=g, device=dev).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    pos[:, S // 3:] -= S // 3                    # a second document
    tail = S - 2 * S // 3                        # then positions to 8,191
    pos[-1, -tail:] = torch.randint(0, 8192, (tail,), generator=g,
                                    device=dev, dtype=torch.int32)
    freqs = (1.0 / 10000.0 ** (torch.arange(0, dh, 2, dtype=torch.float64)
                               / dh)).float().to(dev)
    before = fused_rope_qk.launches
    oq, ok = fused_rope_qk(q, k, pos, freqs)
    bq, bk = fused_rope_qk(oq, ok, pos, -freqs)
    torch.cuda.synchronize()
    assert fused_rope_qk.launches == before + 2
    for got, want in zip((oq, ok), fused_rope_qk_reference(q, k, pos, freqs)):
        _close(got, want, dtype)
    for got, want in zip((bq, bk),
                         fused_rope_qk_reference(oq, ok, pos, -freqs)):
        _close(got, want, dtype)
    if dtype == torch.float32:
        _close(bq, q, dtype)
        _close(bk, k, dtype)


def test_fused_kernels_refuse_what_they_cannot_take(dev):
    x = torch.zeros((4, 64, 8), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rmsnorm(x.transpose(1, 2), torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        fused_rmsnorm(x.half(), torch.ones(8, device=dev))
    q = torch.zeros((1, 16, 4, 8), device=dev)
    pos = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    f = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="k:"):
        fused_rope_qk(q, q.bfloat16(), pos, f)
    with pytest.raises(ValueError, match="inv_freqs"):
        fused_rope_qk(q, q, pos, f.double())


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [3584, 4096, 5120, 8192])
def test_fused_rmsnorm_registers_body_matches_plain_version(
        dev, D, dtype, scale_dtype):
    """The row-in-registers body at every width it is built for, bf16 /
    fp32 x under a bf16 / fp32 scale, both scale forms, over 3 x 37 rows
    (no group of 4 or 2 rows a CTA divides them); it repeats bitwise."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((3, 37, D), generator=g, device=dev) * 3).to(dtype)
    for sp1 in (False, True):
        s = (torch.randn((D,), generator=g, device=dev) * 0.1
             + (0.0 if sp1 else 1.0)).to(scale_dtype)
        before = dict(fused_rmsnorm.routes)
        y = fused_rmsnorm(x, s, eps=1e-6, scale_plus_one=sp1)
        again = fused_rmsnorm(x, s, eps=1e-6, scale_plus_one=sp1)
        torch.cuda.synchronize()
        assert fused_rmsnorm.routes["registers"] == before["registers"] + 2
        assert fused_rmsnorm.routes["two_pass"] == before["two_pass"]
        _close(y, fused_rmsnorm_reference(x, s, eps=1e-6,
                                          scale_plus_one=sp1), dtype)
        assert torch.equal(y, again)
        old = _rmsnorm_launch(x, s, 1e-6, sp1, route="two_pass")
        _close(y, old, dtype)


def test_fused_rmsnorm_refuses_a_route_the_shape_does_not_fit(dev):
    """The C entry refuses the registers body at a width it is not built
    for, and for an operand 2 bytes past an aligned base; the wrapper an
    unknown route; the public call takes the two-pass body there."""
    bf16 = torch.bfloat16
    x = torch.randn((5, 64), device=dev).to(bf16)
    s = torch.ones(64, dtype=bf16, device=dev)
    with pytest.raises(RuntimeError, match="registers route"):
        _rmsnorm_launch(x, s, 1e-6, False, route="registers")
    buf = torch.randn(5 * 4096 + 1, device=dev).to(bf16)
    xm = buf[1:].view(5, 4096)
    s4 = torch.ones(4096, dtype=bf16, device=dev)
    with pytest.raises(RuntimeError, match="registers route"):
        _rmsnorm_launch(xm, s4, 1e-6, False, route="registers")
    sm = torch.ones(4097, dtype=bf16, device=dev)[1:]
    with pytest.raises(RuntimeError, match="registers route"):
        _rmsnorm_launch(xm.contiguous(), sm, 1e-6, False, route="registers")
    with pytest.raises(ValueError, match="route"):
        _rmsnorm_launch(x, s, 1e-6, False, route="shared_memory")
    assert norm_route(bf16, 4096, (xm.data_ptr(), s4.data_ptr())) == \
        "two_pass"
    before = dict(fused_rmsnorm.routes)
    y = fused_rmsnorm(xm, s4, eps=1e-6)
    torch.cuda.synchronize()
    assert fused_rmsnorm.routes["two_pass"] == before["two_pass"] + 1
    _close(y, fused_rmsnorm_reference(xm, s4, eps=1e-6,
                                      scale_plus_one=False), bf16)


def test_place_batch_on_card_equals_the_numpy_batch(dev):
    """Pinned copies on a side stream, delivered through the inline and
    the prefetching source: every tensor on the card equals its array."""
    from gke_ray_train_tpu_torch.data import (
        PlacedBatch, make_batch_source, make_place_batch)
    rng = np.random.default_rng(0)
    batches = [{"inputs": rng.integers(0, 1000, (4, 256)).astype(np.int32),
                "weights": rng.random((4, 256)).astype(np.float32)}
               for _ in range(6)]
    for depth in (0, 2):
        src = make_batch_source(iter(batches),
                                place_fn=make_place_batch(dev), depth=depth)
        got = list(src)
        src.close()
        assert len(got) == len(batches)
        for placed, want in zip(got, batches):
            assert isinstance(placed, PlacedBatch)
            for k, v in want.items():
                assert placed[k].device.type == "cuda"
                assert np.array_equal(placed[k].cpu().numpy(), v)


def test_tiny_model_losses_equal_with_and_without_prefetch_on_card(dev):
    """Three steps of a tiny model on the offline SFT rows, batches placed
    on the card inline (depth 0) and by two prefetch workers (depth 2):
    the losses are bitwise equal."""
    from gke_ray_train_tpu_torch.data import (
        ByteTokenizer, format_gretel_sql_example, make_batch_source,
        make_place_batch, pad_sft_rows, sft_epoch_batches,
        synthetic_sql_rows, tokenize_sft_example)
    from gke_ray_train_tpu_torch.train import (
        make_optimizer, make_train_state, make_train_step)
    seq = 320
    cfg = tiny(vocab_size=260, max_seq_len=seq)
    tok = ByteTokenizer()
    rows = pad_sft_rows([tokenize_sft_example(
        tok, format_gretel_sql_example(r), max_len=seq + 1)
        for r in synthetic_sql_rows(12, seed=0)], seq)
    runs = []
    for depth in (0, 2):
        spec = make_optimizer(1e-3)
        state = make_train_state(cfg, spec, params=init_params(
            cfg, seed=0, device=dev), device=dev)
        step = make_train_step(cfg, spec, device=dev)
        src = make_batch_source(sft_epoch_batches(rows, 4),
                                place_fn=make_place_batch(dev), depth=depth)
        losses = []
        for batch in src:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        src.close()
        runs.append(losses)
    assert len(runs[0]) == 3 and all(np.isfinite(runs[0]))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 32, 128), (1, 4096, 16, 256),
                                   (1, 37, 3, 64), (2, 13, 5, 32),
                                   (1, 9, 2, 6)])
def test_fused_rmsnorm_rope_kernel_matches_plain_version(dev, shape, dtype):
    """Per-head rms_norm + RoPE: the two full-width shapes, S that no row
    tile divides, head dims of 16-byte vectors and one (6) of none,
    positions that restart per document and reach 4,095, both scale
    parameterizations; values and the gradients of x and scale."""
    B, S, H, dh = shape
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    pos[:, S // 2:] -= S // 2                    # a second document
    pos[0, -1] = 4095
    freqs = (1.0 / 10000.0 ** (torch.arange(0, dh, 2, dtype=torch.float64)
                               / dh)).float().to(dev)
    for sp1 in (False, True):
        s = (torch.randn((dh,), generator=g, device=dev) * 0.1
             + (0.0 if sp1 else 1.0)).to(dtype)
        kw = dict(eps=1e-6, scale_plus_one=sp1)
        before = fused_rmsnorm_rope.launches
        y = fused_rmsnorm_rope(x, s, pos, freqs, **kw)
        torch.cuda.synchronize()
        assert fused_rmsnorm_rope.launches == before + 1
        _close(y, fused_rmsnorm_rope_reference(x, s, pos, freqs, **kw),
               dtype)
    probe = torch.randn(shape, generator=g, device=dev).to(dtype)
    grads = []
    for fn in (fused_rmsnorm_rope, fused_rmsnorm_rope_reference):
        xg = x.clone().requires_grad_(True)
        sg = s.clone().requires_grad_(True)
        (fn(xg, sg, pos, freqs, **kw).float() * probe.float()).sum(
            ).backward()
        grads.append((xg.grad, sg.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == dtype
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            FUSED_TOL[dtype] * scale


def test_fused_rmsnorm_rope_unaligned_view_takes_the_scalar_path(dev):
    """A contiguous view 4 bytes past a 16-byte boundary: the kernel reads
    it with scalar accesses and agrees with the plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        shape = (2, 40, 4, 64)
        n = int(np.prod(shape))
        g = torch.Generator(device=dev).manual_seed(3)
        base = torch.randn((n + 8,), generator=g, device=dev).to(dtype)
        off = 4 // base.element_size()
        x = base[off:off + n].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16
        pos = torch.arange(40, dtype=torch.int32, device=dev).repeat(2, 1)
        freqs = (1.0 / 10000.0 ** (torch.arange(0, 64, 2,
                                                dtype=torch.float64) / 64)
                 ).float().to(dev)
        s = torch.randn((64,), generator=g, device=dev).to(dtype)
        y = fused_rmsnorm_rope(x, s, pos, freqs)
        torch.cuda.synchronize()
        _close(y, fused_rmsnorm_rope_reference(
            x, s, pos, freqs, eps=1e-5, scale_plus_one=False), dtype)


def test_fused_rmsnorm_rope_refuses_what_it_cannot_take(dev):
    x = torch.zeros((1, 8, 2, 64), device=dev)
    pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    f = torch.ones(32, device=dev)
    s = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rmsnorm_rope(x.transpose(1, 2).contiguous().transpose(1, 2),
                           s, pos, f)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        fused_rmsnorm_rope(x.half(), s, pos, f)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        fused_rmsnorm_rope(torch.zeros((1, 8, 2, 512), device=dev),
                           torch.ones(512, device=dev), pos,
                           torch.ones(256, device=dev))
    with pytest.raises(ValueError, match="inv_freqs"):
        fused_rmsnorm_rope(x, s, pos, f.double())


def test_kernelcheck_sweep_on_card_is_clean(dev):
    """Every registered case that runs on the card, the two full-width
    norm + rope cases among them, lies inside its committed CUDA pin;
    the sweep launches every kernel it covers."""
    from gke_ray_train_tpu_torch.analysis import kernelcheck
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    counted = (flash_attention, flash_bwd_dq, flash_bwd_dkv, fused_rmsnorm,
               fused_rope_qk, fused_rmsnorm_rope, fused_ce_row_stats,
               fused_ce_dx, fused_ce_dhead)
    before = [fn.launches for fn in counted]
    results = kernelcheck.sweep(device=dev)
    assert {(r.kernel, r.case) for r in results} >= {
        ("fused_norm_rope", "composed_bf16_llama3_8b"),
        ("fused_norm_rope", "composed_bf16_gemma2_9b")}
    findings = (kernelcheck.registration_findings()
                + kernelcheck.ledger_findings(results, "cuda"))
    assert not findings, "\n".join(map(str, findings))
    assert all(fn.launches > b for fn, b in zip(counted, before))


# chip_smoke.py's CE_TOL: (lse and target logit, dx and dhead)
CE_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-4, 1e-2)}


def _ce_inputs(N, D, V, dtype, dev, seed=0):
    """Hidden rows of unit scale, a head of std 0.05 (logits of std
    0.05 sqrt(D)), labels with one of them V + 5 and one -1, weights with
    zeros."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, D), generator=g, device=dev).to(dtype)
    head = (torch.randn((D, V), generator=g, device=dev) * 0.05).to(dtype)
    t = torch.randint(0, V, (N,), generator=g, device=dev,
                      dtype=torch.int32)
    t[min(3, N - 1)] = V + 5
    t[N // 2] = -1
    w = torch.rand((N,), generator=g, device=dev) + 0.5
    w[N // 3:N // 3 + 5] = 0.0
    return x, head, t, w


# (N, D, V, vocab chunk; None: the default). The last crosses two chunk
# boundaries of 4,096 with a ragged last chunk (808) and ragged rows
CE_SHAPES = [(37, 64, 1000, None), (130, 100, 1001, None),
             (200, 256, 9000, None), (5, 64, 1, None), (300, 128, 9000, 4096)]


def _ce_routes(dtype, D, V):
    """The routes a shape admits: the one ``grad_route`` picks (fresh
    allocations are aligned) and, beside wgmma, the mma_sync body it
    replaced."""
    chosen = grad_route(dtype, D, V)
    return [chosen] + (["mma_sync"] if chosen == "wgmma" else [])


CE_PARAMS = [pytest.param(shape, dtype, route, id="x".join(
                 map(str, shape[:3])) + (f"-chunk{shape[3]}" if shape[3]
                                         else "")
                 + f"-{str(dtype)[6:]}-{route}")
             for dtype in (torch.float32, torch.bfloat16)
             for shape in CE_SHAPES
             for route in _ce_routes(dtype, shape[1], shape[2])]


def _ce_grads(x, head, t, w, lse, chunk, route, public):
    """dx and dhead through the public wrappers (``public``) or through
    ``_grad_launch`` on ``route`` with a vocab chunk of ``chunk``."""
    if public:
        return fused_ce_dx(x, head, t, w, lse), fused_ce_dhead(x, head, t,
                                                                w, lse)
    return tuple(_grad_launch(e, x, head, t, w, lse, chunk or _CHUNK, route)
                 for e in ("fused_ce_dx", "fused_ce_dhead"))


@pytest.mark.parametrize("shape, dtype, route", CE_PARAMS)
def test_fused_ce_kernels_match_plain_version(dev, shape, dtype, route):
    """Ragged row tiles, a V no tile divides and an odd one, D that no
    16-byte vector divides, two backward chunks, V = 1; out-of-range
    labels and weight-0 rows; each shape on every route it admits (the
    public wrappers where that is the route they pick). dx and dhead run
    twice: with the labels, and with every label out of range, so that the
    softmax term, which the one-hot term dwarfs, is held on its own
    scale. The route counters move on the route taken only."""
    N, D, V, chunk = shape
    x, head, t, w = _ce_inputs(N, D, V, dtype, dev)
    public = chunk is None and route == grad_route(
        dtype, D, V, (x.data_ptr(), head.data_ptr()))
    before = (fused_ce_row_stats.launches, fused_ce_dx.launches,
              fused_ce_dhead.launches)
    routes_before = (dict(fused_ce_dx.routes), dict(fused_ce_dhead.routes))
    lse, tgt = fused_ce_row_stats(x, head, t)
    ref_lse, ref_tgt = fused_ce_row_stats_reference(x, head, t)
    dx, dh = _ce_grads(x, head, t, w, ref_lse, chunk, route, public)
    torch.cuda.synchronize()
    assert (fused_ce_row_stats.launches, fused_ce_dx.launches,
            fused_ce_dhead.launches) == tuple(b + 1 for b in before)
    ref_dx, ref_dh = fused_ce_grads_reference(x, head, t, w, ref_lse)
    tol_stats, tol_grads = CE_TOL[dtype]
    for got, want in ((lse, ref_lse), (tgt, ref_tgt)):
        assert float((got - want).abs().max()) <= \
            tol_stats * max(1.0, float(want.abs().max()))
    assert float(tgt[min(3, N - 1)]) == 0.0 and float(tgt[N // 2]) == 0.0
    off = torch.where(torch.arange(N, device=dev) % 2 == 0, V + 5,
                      -1).to(torch.int32)
    soft = _ce_grads(x, head, off, w, ref_lse, chunk, route, public)
    ref_soft = fused_ce_grads_reference(x, head, off, w, ref_lse)
    assert all(float(r.float().abs().max()) > 0.0 for r in ref_soft)
    for got, want in zip((dx, dh) + soft, (ref_dx, ref_dh) + ref_soft):
        assert got.dtype == dtype and got.shape == want.shape
        assert float((got.float() - want.float()).abs().max()) <= \
            tol_grads * float(want.float().abs().max())
    assert float(dx[N // 3:N // 3 + 5].float().abs().max()) == 0.0
    for wrapper, was in zip((fused_ce_dx, fused_ce_dhead), routes_before):
        moved = {r: n - was[r] for r, n in wrapper.routes.items()}
        assert moved == {r: 2 if r == route else 0 for r in moved}


@pytest.mark.parametrize("shape", [(300, 128, 9000, 4096),
                                   (1024, 1024, 32000, 8192)])
def test_fused_ce_wgmma_grads_repeat_bitwise(dev, shape):
    """Every dx and dhead element is summed by one CTA in a fixed order
    (no split-K, no atomics): two runs on the same inputs agree bitwise."""
    N, D, V, chunk = shape
    x, head, t, w = _ce_inputs(N, D, V, torch.bfloat16, dev, seed=2)
    lse, _ = fused_ce_row_stats_reference(x, head, t)
    first = _ce_grads(x, head, t, w, lse, chunk, "wgmma", False)
    again = _ce_grads(x, head, t, w, lse, chunk, "wgmma", False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# row statistics on the wgmma body: ragged N, V a multiple of 8 but not
# of 256 (the last vocab tile's zero-filled columns), labels V + 5 and -1
ROW_STATS_SHAPES = [(300, 128, 9000), (37, 64, 1000), (2053, 512, 32008),
                    (5, 64, 8), (130, 256, 1000)]


@pytest.mark.parametrize("shape", ROW_STATS_SHAPES,
                         ids=["x".join(map(str, s)) for s in ROW_STATS_SHAPES])
def test_fused_ce_row_stats_wgmma_body_matches_plain_version(dev, shape):
    """The public row statistics take the wgmma body for bf16 rows TMA can
    address (the launch counted on that route only): lse and the target
    logit within CE_TOL of the plain version, a target logit of 0 for
    labels out of range, and two launches bitwise equal."""
    N, D, V = shape
    x, head, t, _ = _ce_inputs(N, D, V, torch.bfloat16, dev, seed=3)
    before = dict(fused_ce_row_stats.routes)
    lse, tgt = fused_ce_row_stats(x, head, t)
    again = _row_stats_launch(x, head, t, route="wgmma")
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fused_ce_row_stats.routes.items()} \
        == {r: 2 * int(r == "wgmma") for r in before}
    ref_lse, ref_tgt = fused_ce_row_stats_reference(x, head, t)
    tol = CE_TOL[torch.bfloat16][0]
    for got, want in ((lse, ref_lse), (tgt, ref_tgt)):
        assert float((got - want).abs().max()) <= \
            tol * max(1.0, float(want.abs().max()))
    assert float(tgt[min(3, N - 1)]) == 0.0 and float(tgt[N // 2]) == 0.0
    assert torch.equal(lse, again[0]) and torch.equal(tgt, again[1])


def test_fused_ce_row_stats_refuse_a_route_the_shape_does_not_fit(dev):
    """The row statistics' C entry refuses wgmma where a row is no
    multiple of 16 bytes or a base is misaligned, and a route of the other
    dtype; the wrapper an unknown route; nothing falls back."""
    bf16 = torch.bfloat16
    x, head, t, _ = _ce_inputs(64, 100, 1000, bf16, dev)
    x2, head2, t2, _ = _ce_inputs(64, 64, 1000, bf16, dev)
    buf = torch.zeros(64 * 64 + 1, dtype=bf16, device=dev)
    x3 = buf[1:].view(64, 64)                  # 2 bytes past an aligned base
    x3.copy_(x2)
    for args in ((x, head, t), (x3, head2, t2), (x2.float(), head2.float(),
                                                 t2)):
        with pytest.raises(RuntimeError, match="wgmma route"):
            _row_stats_launch(*args, route="wgmma")
    with pytest.raises(RuntimeError, match="fp32 route"):
        _row_stats_launch(x2, head2, t2, route="fp32")
    with pytest.raises(RuntimeError, match="mma_sync route"):
        _row_stats_launch(x2.float(), head2.float(), t2, route="mma_sync")
    with pytest.raises(ValueError, match="route"):
        _row_stats_launch(x2, head2, t2, route="tensor_cores")
    # the public call routes a misaligned view to the mma.sync body
    assert grad_route(bf16, 64, 1000, (x3.data_ptr(), head2.data_ptr())) \
        == "mma_sync"
    lse, tgt = fused_ce_row_stats(x3, head2, t2)
    ref_lse, _ = fused_ce_row_stats_reference(x3, head2, t2)
    torch.cuda.synchronize()
    assert float((lse - ref_lse).abs().max()) <= \
        CE_TOL[bf16][0] * max(1.0, float(ref_lse.abs().max()))


def test_fused_ce_wgmma_route_refuses_what_tma_cannot_take(dev):
    """The C entry refuses the wgmma route where a row is no multiple of
    16 bytes (D 100, V 1,001) or a base is not 16-byte aligned, and a
    route of the other dtype; nothing falls back."""
    bf16 = torch.bfloat16
    x, head, t, w = _ce_inputs(64, 100, 1000, bf16, dev)
    lse, _ = fused_ce_row_stats_reference(x, head, t)
    x2, head2, t2, w2 = _ce_inputs(64, 64, 1001, bf16, dev)
    lse2, _ = fused_ce_row_stats_reference(x2, head2, t2)
    buf = torch.zeros(64 * 64 + 1, dtype=bf16, device=dev)
    x3 = buf[1:].view(64, 64)                  # 2 bytes past an aligned base
    x3.copy_(x2)
    head3 = head2[:, :1000].contiguous()
    for entry in ("fused_ce_dx", "fused_ce_dhead"):
        for args in ((x, head, t, w, lse), (x2, head2, t2, w2, lse2),
                     (x3, head3, t2, w2, lse2)):
            with pytest.raises(RuntimeError, match="wgmma route"):
                _grad_launch(entry, *args, route="wgmma")
        with pytest.raises(RuntimeError, match="fp32 route"):
            _grad_launch(entry, x2, head3, t2, w2, lse2, route="fp32")
        with pytest.raises(RuntimeError, match="wgmma route"):
            _grad_launch(entry, x2.float(), head3.float(), t2, w2, lse2,
                         route="wgmma")
    assert grad_route(bf16, 64, 1000, (x3.data_ptr(), head3.data_ptr())) \
        == "mma_sync"


def test_fused_cross_entropy_autograd_reaches_the_kernels(dev):
    """dhead launches only where the head takes a gradient; both on the
    wgmma body."""
    x, head, t, w = _ce_inputs(64, 128, 3000, torch.bfloat16, dev, seed=1)
    for head_grad, n_dhead in ((True, 1), (False, 0)):
        xg = x.clone().requires_grad_(True)
        hg = head.clone().requires_grad_(head_grad)
        before = (fused_ce_row_stats.launches, fused_ce_dx.launches,
                  fused_ce_dhead.launches)
        wgmma = (fused_ce_dx.routes["wgmma"],
                 fused_ce_dhead.routes["wgmma"])
        nll, ws = fused_cross_entropy(xg[None], hg, t[None], w[None])
        nll.backward()
        assert (fused_ce_row_stats.launches - before[0],
                fused_ce_dx.launches - before[1],
                fused_ce_dhead.launches - before[2]) == (1, 1, n_dhead)
        # D 128 and V 3,000 in bf16: the wgmma body
        assert (fused_ce_dx.routes["wgmma"] - wgmma[0],
                fused_ce_dhead.routes["wgmma"] - wgmma[1]) == (1, n_dhead)
        assert bool(torch.isfinite(xg.grad.float()).all())
        assert (hg.grad is not None) == head_grad
        assert float(ws) == pytest.approx(float(w.sum()))


def test_fused_ce_kernels_refuse_what_they_cannot_take(dev):
    x = torch.zeros((8, 16), device=dev)
    head = torch.zeros((16, 32), device=dev)
    t = torch.zeros((8,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_ce_row_stats(x.half(), head.half(), t)
    with pytest.raises(TypeError, match="one dtype"):
        fused_ce_row_stats(x, head.bfloat16(), t)
    with pytest.raises(ValueError, match="targets"):
        fused_ce_row_stats(x, head, t.long())
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce_row_stats(x, head.T.contiguous().T, t)


# -- the training loop on the card: no host sync in the hot loop -------------

LOOP_SEQ = 384      # byte-rendered SQL rows are ~300 tokens


def _loop_job(dev, family="llama", fused_ops=False):
    """A QLoRA job at tiny widths (head dim 64, so the flash kernels run;
    bf16, remat) on the offline SQL rows: cfg, state, step, eval step,
    rows and the card placement."""
    from gke_ray_train_tpu_torch.data import (
        ByteTokenizer, format_gretel_sql_example, make_place_batch,
        pad_sft_rows, synthetic_sql_rows, tokenize_sft_example)
    from gke_ray_train_tpu_torch.models import gemma2_9b
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_eval_step, make_optimizer, make_train_state,
        make_train_step, warmup_cosine_schedule)
    widths = dict(vocab_size=260, d_model=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=512, max_seq_len=LOOP_SEQ,
                  dtype="bfloat16", param_dtype="bfloat16", remat=True)
    cfg = (dataclasses.replace(gemma2_9b(), head_dim=64, sliding_window=128,
                               attn_scale=64 ** -0.5, **widths)
           if family == "gemma" else tiny(**widths))
    tok = ByteTokenizer()
    rows = pad_sft_rows([tokenize_sft_example(
        tok, format_gretel_sql_example(r), max_len=LOOP_SEQ + 1)
        for r in synthetic_sql_rows(12, seed=0)], LOOP_SEQ)
    sched = warmup_cosine_schedule(1e-3, 10)
    spec = make_optimizer(sched)
    lcfg = LoraConfig(r=8, alpha=16)
    state = make_train_state(cfg, spec, lora_cfg=lcfg,
                             params=init_quantized_params(cfg, device=dev),
                             device=dev)
    step = make_train_step(cfg, spec, lora_cfg=lcfg, schedule=sched,
                           plan=ExecutionPlan(grad_accum=2,
                                              fused_ops=fused_ops),
                           device=dev)
    return dict(cfg=cfg, state=state, step=step, rows=rows,
                eval_step=make_eval_step(cfg, lora_cfg=lcfg, device=dev),
                place=make_place_batch(dev))


def _clear_device_tables():
    """Drop the RoPE / sinusoidal tables and NF4 codebooks made on the
    card, so the next step makes them again."""
    from gke_ray_train_tpu_torch.models import transformer
    from gke_ray_train_tpu_torch.ops import quant
    transformer._TABLES.clear()
    quant._BOOKS.clear()


@pytest.mark.parametrize("fused_ops", [False, True])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_qlora_step_makes_no_host_sync(dev, family, fused_ops):
    """Two QLoRA steps on batches placed by ``make_place_batch``, with the
    device tables cleared first, under ``set_sync_debug_mode("error")``:
    nothing waits for the card. Before the repair the RoPE frequencies
    were copied from pageable memory in every forward, the NF4 codebook
    on its first use and Gemma's embedding scale made on the card in
    every forward: each a host wait."""
    from gke_ray_train_tpu_torch.data import sft_epoch_batches
    job = _loop_job(dev, family, fused_ops)
    batches = [job["place"](b).wait()
               for b in sft_epoch_batches(job["rows"], 4)][:2]
    torch.cuda.synchronize()
    _clear_device_tables()
    state, launches = job["state"], flash_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            state, m = job["step"](state, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert flash_attention.launches - launches == 2 * 2 * 2 * 2
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("fused_ops", [False, True])
def test_run_training_on_card_under_transfer_guard_flags_nothing(
        dev, fused_ops, prefetch):
    """``run_training`` with TRANSFER_GUARD=disallow, the batches placed
    on the card (inline or by the prefetcher), a meter, eval (every 2
    steps and at the epoch's end) and a log line every step: the guard
    raises nothing and is lifted after."""
    from gke_ray_train_tpu_torch.analysis.guards import RuntimeGuards
    from gke_ray_train_tpu_torch.data import sft_epoch_batches
    from gke_ray_train_tpu_torch.train import (
        ThroughputMeter, sharded_eval_loss)
    from gke_ray_train_tpu_torch.train.loop import run_training
    job = _loop_job(dev, fused_ops=fused_ops)
    rows = job["rows"]
    before = flash_attention.launches
    state, last = run_training(
        job["state"], job["step"], lambda e: sft_epoch_batches(rows, 4),
        epochs=1, log_every=1, prefetch=prefetch, place_batch=job["place"],
        meter=ThroughputMeter(job["cfg"], seq_len=LOOP_SEQ, n_devices=1,
                              device=dev),
        eval_fn=lambda st: {"eval_loss": sharded_eval_loss(
            st, job["eval_step"], rows, host_batch=4,
            place_batch=job["place"])},
        eval_every=2, eval_at_epoch_end=True,
        guards=RuntimeGuards(transfer_mode="disallow"))
    assert torch.cuda.get_sync_debug_mode() == 0
    assert last["step"] == 3 and np.isfinite(last["loss"])
    assert np.isfinite(last["eval_loss"])
    # 3 steps x 2 microbatches x 2 layers x 2 (forward, recomputation),
    # and two eval passes (step 2, epoch end) of 3 batches x 2 layers
    assert flash_attention.launches - before == 3 * 2 * 2 * 2 + 2 * 3 * 2


def test_planted_item_raises_under_transfer_guard(dev):
    """A step that reads its loss with ``.item()`` raises under
    TRANSFER_GUARD=disallow, at the call; the guard is lifted after."""
    from gke_ray_train_tpu_torch.analysis.guards import RuntimeGuards
    from gke_ray_train_tpu_torch.data import sft_epoch_batches
    from gke_ray_train_tpu_torch.train.loop import run_training
    job = _loop_job(dev)

    def leaky_step(state, batch):
        state, m = job["step"](state, batch)
        m["loss"].item()
        return state, m
    with pytest.raises(RuntimeError, match="synchronizing"):
        run_training(job["state"], leaky_step,
                     lambda e: sft_epoch_batches(job["rows"], 4),
                     epochs=1, prefetch=2, place_batch=job["place"],
                     guards=RuntimeGuards(transfer_mode="disallow"))
    assert torch.cuda.get_sync_debug_mode() == 0
