"""The port's kernel-verification entry point (``analysis/kernelcheck.py``
over ``ops/registry.py``) and the per-head rms_norm + RoPE (the last TPU
kernel, ``ops/fused_norm_rope.py::fused_rmsnorm_rope``), on the CPU at
small sizes, against the JAX package on the same numpy inputs.

Tolerances: the norm + rope plain version against the JAX Pallas kernel
in interpret mode, relative to max |reference|: float32 1e-6 for values
and 1e-5 for gradients (fp32 reductions over dh in another order), bf16
8e-3 (both round once from fp32, and a last-bit fp32 difference may
round to the neighbouring bf16 value, 2^-8 relative). The registry cases
both packages hold: the port's kernel and oracle outputs against JAX's
within 1e-5 relative in float32 and 2e-2 in bf16 (one bf16 ulp, 2^-8,
and the bf16 rounding of attention probabilities), bitwise where the
case is exact; the port's kernel-vs-oracle error at most 4x JAX's pin
(the ledger's own band) plus 1e-9. ``lora_batched`` (the batched
multi-LoRA matmul) is held against JAX's kernel and oracle within the
same bounds, and within the port's own pins: JAX's are 0, its batched
einsum and per-row loop lowering alike, where torch's CPU bmm and a
batch-1 mm round apart by ~1e-7 at T = 1.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from gke_ray_train_tpu.analysis import kernelcheck as jkc
from gke_ray_train_tpu.ops import fused_norm_rope as jfnr
from gke_ray_train_tpu.ops import registry as jreg
from gke_ray_train_tpu.ops.rope import rope_frequencies
from gke_ray_train_tpu_torch.analysis import __main__ as cli
from gke_ray_train_tpu_torch.analysis import kernelcheck as kc
from gke_ray_train_tpu_torch.ops import fused_norm_rope as tfnr
from gke_ray_train_tpu_torch.ops import registry as treg
from gke_ray_train_tpu_torch.ops.norms import rms_norm
from gke_ray_train_tpu_torch.ops.rope import apply_rope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LEDGER = os.path.join(REPO, "tests", "tolerances")

NR_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (8e-3, 8e-3)}
SHARED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    # the first multi-threaded torch.exp of a fresh process can be off by
    # ~1.5e-4 (kernelcheck.warm_cpu_exp); the JAX comparisons here must
    # not depend on which test of the worker calls it first
    kc.warm_cpu_exp()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _np(a) -> np.ndarray:
    """A JAX or torch array as float64 numpy (exact for bf16 and f32)."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _restarting_positions(B, S, r):
    """[B, S] positions restarting at 0 at two random document starts."""
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        edges = [0, *np.sort(r.choice(np.arange(1, S), 2, replace=False)),
                 S]
        for lo, hi in zip(edges[:-1], edges[1:]):
            pos[b, lo:hi] = np.arange(hi - lo)
    return pos


# -- row 9 against JAX ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_fused_rmsnorm_rope_matches_jax(dtype, dh):
    """Values and the gradients of x and scale, both scale
    parameterizations, over [2, 24, 4, dh] with restarting positions."""
    r = np.random.default_rng(dh)
    x = r.standard_normal((2, 24, 4, dh)).astype(np.float32)
    pos = _restarting_positions(2, 24, r)
    probe = r.standard_normal(x.shape).astype(np.float32)
    freqs = rope_frequencies(dh)
    vtol, gtol = NR_TOL[dtype]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for sp1 in (False, True):
        s = (r.standard_normal(dh) * 0.1 + (0.0 if sp1 else 1.0)
             ).astype(np.float32)
        kw = dict(eps=1e-6, scale_plus_one=sp1)

        def jloss(xx, ss):
            out = jfnr.fused_rmsnorm_rope(xx, ss, jnp.asarray(pos),
                                          jnp.asarray(freqs), interpret=True,
                                          **kw)
            return jnp.sum(out.astype(jnp.float32) * probe), out
        (_, jout), (jdx, jds) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
                jnp.asarray(x).astype(jdt), jnp.asarray(s).astype(jdt))

        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        ts = torch.from_numpy(s).to(tdt).requires_grad_(True)
        tout = tfnr.fused_rmsnorm_rope(tx, ts, torch.from_numpy(pos),
                                       torch.from_numpy(freqs), **kw)
        assert tout.dtype == tdt and tout.shape == x.shape
        (tout.float() * torch.from_numpy(probe)).sum().backward()
        assert tx.grad.dtype == ts.grad.dtype == tdt
        assert _rel(_np(tout), _np(jout)) <= vtol, sp1
        assert _rel(_np(tx.grad), _np(jdx)) <= gtol, sp1
        assert _rel(_np(ts.grad), _np(jds)) <= gtol, sp1


def test_fused_rmsnorm_rope_rounds_once():
    """The bf16 plain output is the fp32 composition cast once, bitwise,
    and not the two-call composition, which rounds y in between."""
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((2, 24, 4, 64)).astype(
        np.float32)).bfloat16()
    s = torch.from_numpy((r.standard_normal(64) * 0.1 + 1.0).astype(
        np.float32))
    pos = torch.from_numpy(_restarting_positions(2, 24, r))
    freqs = torch.from_numpy(rope_frequencies(64))
    got = tfnr.fused_rmsnorm_rope(x, s, pos, freqs, eps=1e-6)
    once = apply_rope(rms_norm(x.float(), s, eps=1e-6), pos, freqs)
    assert torch.equal(got, once.bfloat16())
    twice = tfnr.fused_rope_qk_reference(
        tfnr.fused_rmsnorm_reference(x, s, eps=1e-6, scale_plus_one=False),
        x, pos, freqs)[0]
    assert not torch.equal(got, twice)


def test_fused_rmsnorm_rope_cpu_counts_no_launch_and_checks_shapes():
    x = torch.zeros((1, 8, 2, 16))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    before = tfnr.fused_rmsnorm_rope.launches
    tfnr.fused_rmsnorm_rope(x, torch.ones(16), pos, torch.ones(8))
    assert tfnr.fused_rmsnorm_rope.launches == before
    with pytest.raises(ValueError, match="scale"):
        tfnr.fused_rmsnorm_rope(x, torch.ones(8), pos, torch.ones(8))
    with pytest.raises(ValueError, match="positions"):
        tfnr.fused_rmsnorm_rope(x, torch.ones(16), pos[:, :4], torch.ones(8))


# -- the registry cases both packages hold ----------------------------------

# JAX's MoE kernel asks XLA's CPU backend for a bf16 x bf16 -> f32 dot,
# which this jaxlib refuses ("Unsupported element type for
# DotThunk::Execute"; JAX's own tests/test_moe.py::
# test_moe_bf16_combine_close_to_fp32 fails the same way): that case is
# held against JAX's oracle alone (test_moe_bf16_case_matches_jax_oracle)
JAX_KERNEL_OFF_CPU = {("moe_dispatch", "top2_bf16")}
# held within the port's own pins, not JAX's (see the module docstring):
# test_lora_batched_case_matches_jax
JAX_PIN_APART = {("lora_batched", c)
                 for c in ("decode_f32", "prefill_f32", "decode_bf16")}


def _shared_cases():
    port = {s.name: {c.name for c in s.cases} for s in treg.all_kernels()}
    return [(s.name, c.name) for s in jreg.all_kernels()
            if s.name in port for c in s.cases
            if c.mesh_axes is None and c.name in port[s.name]
            and (s.name, c.name) not in JAX_KERNEL_OFF_CPU | JAX_PIN_APART]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch_tree(t) for t in tree)
    a = jnp.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _port_layout(name, tree):
    """The JAX cache pytree ({"blocks": [{"k", "v"}]}, one block kind in
    the registry's config) in the port's layout ({"k", "v"})."""
    if name == "kvcache_insert" and isinstance(tree, dict) \
            and "blocks" in tree:
        (block,) = tree["blocks"]
        return block
    return tree


def test_shared_case_list_covers_every_port_case_but_its_own():
    own = {("quant_matmul", "nf4_cuda_vs_cpu"),
           ("fused_norm_rope", "composed_bf16_llama3_8b"),
           ("fused_norm_rope", "composed_bf16_gemma2_9b")}
    port = {(s.name, c.name) for s in treg.all_kernels() for c in s.cases}
    assert port - set(_shared_cases()) == (own | JAX_KERNEL_OFF_CPU
                                           | JAX_PIN_APART)
    assert len(_shared_cases()) == 21


@pytest.mark.parametrize("name,case", _shared_cases())
def test_registry_case_matches_jax(name, case):
    jspec = jreg.get(name)
    jcase = next(c for c in jspec.cases if c.name == case)
    tspec = treg.get(name)
    tcase = next(c for c in tspec.cases if c.name == case)
    jargs, diff = jspec.build(jcase, jkc._case_key(name, case))
    targs = tuple(_port_layout(name, _torch_tree(a)) for a in jargs)

    with torch.no_grad():
        port = {"kernel": tspec.kernel(tcase, *targs),
                "oracle": tspec.oracle(tcase, *targs)}
    ref = {"kernel": _port_layout(name, jspec.kernel(jcase, None, *jargs)),
           "oracle": _port_layout(name, jspec.oracle(jcase, None, *jargs))}
    for side in ("kernel", "oracle"):
        got, want = port[side], _torch_tree(ref[side])
        for g, w in kc._matched_leaves(got, want):
            if tcase.exact:
                assert g.dtype == w.dtype and torch.equal(g, w), side
            else:
                assert _rel(_np(g), _np(w)) <= SHARED_TOL[tcase.dtype], side

    res = kc.run_case(tspec, tcase, "cpu", built=(targs, diff))
    with open(os.path.join(JAX_LEDGER, f"{name}.json")) as f:
        pins = json.load(f)["cases"][case]
    for metric, observed in res.metrics().items():
        assert observed <= kc.LEDGER_SLACK * pins[metric] + 1e-9, metric


def test_moe_bf16_case_matches_jax_oracle():
    """``moe_dispatch/top2_bf16`` on JAX's inputs: the port's kernel and
    oracle against JAX's oracle (its kernel cannot run on this CPU, see
    ``JAX_KERNEL_OFF_CPU``) within the bf16 bound, and the port's
    kernel-vs-oracle error within the ledger's band of JAX's pin."""
    name, case = "moe_dispatch", "top2_bf16"
    jspec, tspec = jreg.get(name), treg.get(name)
    jcase = next(c for c in jspec.cases if c.name == case)
    tcase = next(c for c in tspec.cases if c.name == case)
    jargs, diff = jspec.build(jcase, jkc._case_key(name, case))
    targs = tuple(_torch_tree(a) for a in jargs)
    want = _torch_tree(jspec.oracle(jcase, None, *jargs))
    with torch.no_grad():
        for side in (tspec.kernel(tcase, *targs), tspec.oracle(tcase, *targs)):
            for g, w in kc._matched_leaves(side, want):
                assert _rel(_np(g), _np(w)) <= SHARED_TOL["bfloat16"]
    res = kc.run_case(tspec, tcase, "cpu", built=(targs, diff))
    with open(os.path.join(JAX_LEDGER, f"{name}.json")) as f:
        pins = json.load(f)["cases"][case]
    for metric, observed in res.metrics().items():
        assert observed <= kc.LEDGER_SLACK * pins[metric] + 1e-9, metric


@pytest.mark.parametrize("case", sorted(c for _, c in JAX_PIN_APART))
def test_lora_batched_case_matches_jax(case):
    """``lora_batched`` on JAX's inputs: the port's kernel and oracle
    against JAX's kernel and oracle within the shared bounds, zero-slot
    rows exactly zero, and the port's kernel-vs-oracle error within its
    committed CPU pin's band."""
    name = "lora_batched"
    jspec, tspec = jreg.get(name), treg.get(name)
    jcase = next(c for c in jspec.cases if c.name == case)
    tcase = next(c for c in tspec.cases if c.name == case)
    jargs, diff = jspec.build(jcase, jkc._case_key(name, case))
    targs = tuple(_torch_tree(a) for a in jargs)
    refs = [_torch_tree(jspec.kernel(jcase, None, *jargs)),
            _torch_tree(jspec.oracle(jcase, None, *jargs))]
    with torch.no_grad():
        for side in (tspec.kernel(tcase, *targs),
                     tspec.oracle(tcase, *targs)):
            assert side.dtype == tcase.torch_dtype
            assert not side[targs[3] == 0].any()
            for want in refs:
                assert _rel(_np(side), _np(want)) <= SHARED_TOL[tcase.dtype]
    res = kc.run_case(tspec, tcase, "cpu", built=(targs, diff))
    pin = kc.load_ledger(name)["cases"][case]["cpu"]["value"]
    assert res.value_err <= max(kc.LEDGER_SLACK * pin, kc.LEDGER_FLOOR)


# -- the sweep and the ledger -----------------------------------------------

def test_cpu_sweep_is_clean_against_the_committed_ledger():
    results = kc.sweep(device="cpu")
    ran = {(r.kernel, r.case) for r in results}
    assert ran == {(s.name, c.name) for s in treg.all_kernels()
                   for c in s.cases if "cpu" in c.devices}
    findings = kc.registration_findings() + kc.ledger_findings(results,
                                                               "cpu")
    assert not findings, "\n".join(map(str, findings))
    # every case has a committed CUDA pin beside its CPU pin
    for s in treg.all_kernels():
        cases = kc.load_ledger(s.name)["cases"]
        for c in s.cases:
            for dev in c.devices:
                assert dev in cases[c.name], (s.name, c.name, dev)


@pytest.fixture
def ledger_copy(tmp_path):
    for f in os.listdir(kc.TOLERANCE_DIR):
        shutil.copy(os.path.join(kc.TOLERANCE_DIR, f), tmp_path)
    return tmp_path


def _edit_pin(ledger_dir, kernel, case, fn):
    path = os.path.join(ledger_dir, f"{kernel}.json")
    with open(path) as f:
        doc = json.load(f)
    fn(doc["cases"])
    with open(path, "w") as f:
        json.dump(doc, f)


def test_ledger_round_trip_keeps_the_other_device(tmp_path):
    results = kc.sweep(["rope", "kvcache_insert"], device="cpu")
    kc.record_ledger(results, "cpu", str(tmp_path))
    assert kc.ledger_findings(results, "cpu", str(tmp_path)) == []
    fake = [dataclasses.replace(r, value_err=r.value_err * 2)
            for r in results]
    kc.record_ledger(fake, "cuda", str(tmp_path), device_name="card, 1 W")
    doc = kc.load_ledger("rope", str(tmp_path))
    assert doc["_cuda_device"] == "card, 1 W"
    assert doc["cases"]["f32"]["cpu"]["value"] * 2 == pytest.approx(
        doc["cases"]["f32"]["cuda"]["value"], rel=1e-2)
    assert kc.ledger_findings(results, "cpu", str(tmp_path)) == []
    assert kc.ledger_findings(results, "cuda", str(tmp_path)) == []


def test_planted_error_fires_ker101(monkeypatch):
    spec = treg.get("rope")

    def off_by_one_percent(case, x, positions):
        out = spec.kernel(case, x, positions)
        return out + 0.01 * out.abs().max()
    monkeypatch.setitem(treg._REGISTRY, "rope", dataclasses.replace(
        spec, kernel=off_by_one_percent))
    findings = kc.ledger_findings(kc.sweep(["rope"], device="cpu"), "cpu")
    assert "rope/f32[cpu]:value" in {
        f.subject for f in findings if f.rule == "KER101"}


def test_loosened_pin_fires_ker102_and_missing_case_ker100(ledger_copy):
    results = kc.sweep(["rope"], device="cpu")
    assert kc.ledger_findings(results, "cpu", str(ledger_copy)) == []

    def loosen(cases):
        cases["f32"]["cpu"]["value"] *= 10
    _edit_pin(ledger_copy, "rope", "f32", loosen)
    findings = kc.ledger_findings(results, "cpu", str(ledger_copy))
    assert [(f.rule, f.subject) for f in findings] == [
        ("KER102", "rope/f32[cpu]:value")]

    _edit_pin(ledger_copy, "rope", "bf16", lambda c: c.pop("bf16"))
    rules = {f.subject: f.rule for f in kc.ledger_findings(
        results, "cpu", str(ledger_copy))}
    assert rules["rope/bf16[cpu]"] == "KER100"


def test_removed_registration_fires_ker006(monkeypatch):
    assert kc.registration_findings() == []
    monkeypatch.delitem(treg._REGISTRY, "fused_norm_rope")
    findings = kc.registration_findings()
    assert [(f.rule, f.subject) for f in findings] == [
        ("KER006", "fused_norm_rope")]


def test_unknown_name_and_tree_mismatch_raise(monkeypatch):
    with pytest.raises(kc.KernelCheckError, match="unknown kernel"):
        kc.sweep(["rope", "no_such_kernel"], device="cpu")
    t = torch.zeros(3)
    with pytest.raises(kc.KernelCheckError, match="tree structures"):
        kc._matched_leaves({"a": t}, {"b": t})
    spec = treg.get("rope")
    bad = dataclasses.replace(
        spec, kernel=lambda case, x, p: {"x": spec.kernel(case, x, p)})
    with pytest.raises(kc.KernelCheckError, match="tree structures"):
        kc.run_case(bad, spec.cases[0], "cpu")


@pytest.mark.parametrize("entry", ["sweep", "run_case", "quick_verify",
                                   "main_check"])
def test_entry_points_need_a_card_unless_told_cpu(entry, monkeypatch):
    """No device given means cuda: without a card each entry point raises
    and sweeps nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = treg.get("rope")
    call = {"sweep": lambda: kc.sweep(["rope"]),
            "run_case": lambda: kc.run_case(spec, spec.cases[0]),
            "quick_verify": kc.quick_verify,
            "main_check": lambda: kc.main_check(["rope"])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_exact_case_holds_dtype_and_bits(monkeypatch):
    spec = treg.get("kvcache_insert")
    case = spec.cases[0]
    assert case.exact
    upcast = dataclasses.replace(spec, kernel=lambda c, *a: tree_map(
        lambda t: t.double(), spec.kernel(c, *a)))
    with pytest.raises(kc.KernelCheckError, match="exact case"):
        kc.run_case(upcast, case, "cpu")
    nudged = dataclasses.replace(spec, kernel=lambda c, *a: tree_map(
        lambda t: t + 1e-3 * t.abs().max(), spec.kernel(c, *a)))
    res = kc.run_case(nudged, case, "cpu")
    assert res.value_err > 0
    assert {f.rule for f in kc.ledger_findings([res], "cpu")} == {"KER101"}


def test_non_finite_output_fires_ker101_and_is_never_pinned(tmp_path):
    spec = treg.get("rope")

    def with_nan(case, x, positions):
        out = spec.kernel(case, x, positions).clone()
        out.view(-1)[0] = float("nan")
        return out
    res = kc.run_case(dataclasses.replace(spec, kernel=with_nan),
                      spec.cases[0], "cpu")
    assert res.value_err == float("inf")
    assert {f.subject: f.rule for f in kc.ledger_findings([res], "cpu")
            }["rope/f32[cpu]:value"] == "KER101"
    with pytest.raises(kc.KernelCheckError, match="non-finite"):
        kc.record_ledger([res], "cpu", str(tmp_path))


def test_quick_verify_passes_and_raises_on_a_fault(monkeypatch):
    results = kc.quick_verify("cpu")
    assert len(results) == len(treg.all_kernels())
    spec = treg.get("quant_matmul")
    monkeypatch.setitem(treg._REGISTRY, "quant_matmul", dataclasses.replace(
        spec, kernel=lambda case, x, w: spec.oracle(case, x, w) * 1.5))
    with pytest.raises(kc.KernelCheckError, match="KER101"):
        kc.quick_verify("cpu")


# -- the CLI ----------------------------------------------------------------

def test_cli_return_codes(ledger_copy, monkeypatch, capsys):
    assert cli.main(["kernelcheck", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fused_norm_rope/composed_bf16 [cpu] value" in out
    assert out.strip().splitlines()[-1].startswith("kernelcheck: clean")

    _edit_pin(ledger_copy, "rope", "f32",
              lambda c: c["f32"]["cpu"].update(value=1.0))
    assert cli.main(["kernelcheck", "rope", "--device", "cpu",
                     "--ledger-dir", str(ledger_copy)]) == 1
    assert "FINDING KER102 rope/f32[cpu]:value" in capsys.readouterr().out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["kernelcheck"]) != 0
    assert cli.main(["kernelcheck", "--static-only"]) == 0


def test_cli_without_a_card_exits_non_zero():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "gke_ray_train_tpu_torch.analysis",
         "kernelcheck"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "differential case" not in out.stdout
