"""kernelcheck — differential kernel verification against a tolerance
ledger (counterpart of ``gke_ray_train_tpu/analysis/kernelcheck.py``,
its differential layer and ledger, :475-755).

Every op registered in ``ops/registry.py`` runs against its oracle on the
same inputs, values and gradients, and the observed errors are held
against the port's ledger (``analysis/tolerances/<kernel>.json``), one pin
per case and device type (``cpu``, ``cuda``). The pins are two-sided:

========  ==========================================================
rule      what it catches
========  ==========================================================
KER006    an op required to be registered is missing from the
          registry: an unregistered kernel has no oracle, no domain
          and no pin, so nothing can verify it
KER100    a case has no pin for this device type: record it
KER101    the observed error is above ``LEDGER_SLACK`` times the pin:
          a precision regression against the oracle
KER102    the pin is more than ``LEDGER_SLACK`` times the observed
          error: an over-loose pin that would hide the next regression
========  ==========================================================

``--record`` re-records the pins of the device swept; review the JSON
diff like code. Only the CUDA sweep launches the kernels; the CPU sweep
runs their plain versions, which the CPU tests hold against the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device

TOLERANCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tolerances")

# two-sided band: observed may not exceed pin * SLACK, nor the pin exceed
# observed * SLACK; errors below FLOOR count as zero on both sides
LEDGER_SLACK = 4.0
LEDGER_FLOOR = 1e-9

# the ops every build of the port must register (KER006)
REQUIRED_KERNELS = frozenset({
    "flash_attention", "rope", "kvcache_insert", "quant_matmul",
    "fused_norm_rope", "fused_cross_entropy"})


class KernelCheckError(AssertionError):
    """A kernel disagreed with its oracle beyond the pinned tolerance, or
    a differential claim is ill-formed."""


@dataclasses.dataclass(frozen=True)
class KernelFinding:
    rule: str
    subject: str
    message: str

    def __str__(self) -> str:
        return f"{self.rule} {self.subject}: {self.message}"


@dataclasses.dataclass
class CaseResult:
    kernel: str
    case: str
    value_err: float
    grad_err: Optional[float] = None
    seconds: float = 0.0

    def metrics(self) -> Dict[str, float]:
        out = {"value": self.value_err}
        if self.grad_err is not None:
            out["grad"] = self.grad_err
        return out


# -- trees of tensors ---------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float64 on the host; ``inf`` where
    either side is not finite, so that no comparison with a pin can pass
    a NaN."""
    a, b = _host(a), _host(b)
    if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
        return float("inf")
    denom = max(float(np.max(np.abs(b))), 1e-30)
    return float(np.max(np.abs(a - b))) / denom


def _matched_leaves(got, want) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Leaf pairs, with the tree structures held equal first: a kernel /
    oracle mismatch is a loud error, never a truncated comparison that
    reports clean on leaves it skipped."""
    got_l, got_s = tree_flatten(got)
    want_l, want_s = tree_flatten(want)
    if got_s != want_s:
        raise KernelCheckError(
            f"kernel and oracle outputs have different tree structures "
            f"({got_s} vs {want_s}): the differential claim is "
            "ill-formed; fix the registration")
    for g, w in zip(got_l, want_l):
        if not (isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor)):
            raise KernelCheckError(
                f"kernel and oracle leaves must be tensors, not "
                f"{type(g).__name__} / {type(w).__name__}")
        if g.shape != w.shape:
            raise KernelCheckError(
                f"kernel and oracle leaves differ in shape: "
                f"{tuple(g.shape)} vs {tuple(w.shape)}")
    return list(zip(got_l, want_l))


def _tree_err(got, want) -> float:
    return max(_rel_err(g, w) for g, w in _matched_leaves(got, want))


def _exact_err(got, want) -> float:
    """0 when every leaf is bitwise equal, else the relative error. A
    dtype change raises: equal values in another dtype are not an exact
    result, and their relative error would read 0."""
    pairs = _matched_leaves(got, want)
    for g, w in pairs:
        if g.dtype != w.dtype:
            raise KernelCheckError(
                f"exact case: the kernel returns {g.dtype} where the oracle "
                f"returns {w.dtype}")
    if all(torch.equal(g.cpu(), w.cpu()) for g, w in pairs):
        return 0.0
    return _tree_err(got, want)


def _probe(tree):
    """Deterministic cotangent for the gradient check: a cos ramp of
    step 0.7 over each leaf, in the leaf's dtype."""
    def one(x):
        flat = torch.cos(torch.arange(x.numel(), dtype=torch.float32,
                                      device=x.device) * 0.7)
        return flat.reshape(x.shape).to(x.dtype)
    return tree_map(one, tree)


# -- the sweep ----------------------------------------------------------------

def case_generator(spec_name: str, case_name: str) -> torch.Generator:
    """The CPU generator a case's inputs come from: seeded with
    crc32("<spec>/<case>"), as the JAX package keys its cases."""
    g = torch.Generator(device="cpu")
    g.manual_seed(zlib.crc32(f"{spec_name}/{case_name}".encode()))
    return g


@contextlib.contextmanager
def _full_fp32():
    """fp32 products in full fp32 on the card (no TF32) while a sweep
    runs: the oracles' precision is part of every pin."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def warm_cpu_exp() -> None:
    """One large ``torch.exp`` on the CPU. In a fresh process the first
    multi-threaded ``torch.exp`` of this torch build (2.13, AVX512) can
    be off by ~1.5e-4 relative on part of its input (seen in about one
    fresh process in ten: exp(-0.3465) read 0.70705), and every later
    call is right; a CPU pin must measure the port, not that."""
    torch.exp(-torch.rand(1 << 20))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(spec, case, device: DeviceLike = None, built=None
             ) -> CaseResult:
    """One differential point: values (and gradients) of kernel against
    oracle on ``device`` (default ``cuda``, which must exist). ``built``:
    ``(args, diff_argnums)`` to use in place of the case's own inputs."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    if built is None:
        built = spec.build(case, case_generator(spec.name, case.name))
    args, diff_argnums = built
    args = tuple(tree_map(lambda t: t.to(device), a) for a in args)

    with torch.no_grad():
        out_k = spec.kernel(case, *args)
        out_o = spec.oracle(case, *args)
    _sync(device)
    if case.exact:
        return CaseResult(spec.name, case.name, _exact_err(out_k, out_o),
                          seconds=time.perf_counter() - t0)
    value_err = _tree_err(out_k, out_o)

    grad_err = None
    if case.grads and diff_argnums:
        probe = _probe(out_k)
        del out_k, out_o

        def grads(run):
            full = list(args)
            dargs = []
            for i in diff_argnums:
                full[i] = args[i].detach().clone().requires_grad_(True)
                dargs.append(full[i])
            out = run(case, *full)
            loss = sum(torch.sum(o.float() * p.float()) for o, p in
                       _matched_leaves(out, probe))
            return tuple(torch.autograd.grad(loss, dargs))

        g_k = grads(spec.kernel)
        g_o = grads(spec.oracle)
        _sync(device)
        grad_err = _tree_err(g_k, g_o)
    return CaseResult(spec.name, case.name, value_err, grad_err,
                      seconds=time.perf_counter() - t0)


def _selected(names: Optional[List[str]]):
    from gke_ray_train_tpu_torch.ops import registry
    specs = registry.all_kernels()
    if names:
        unknown = set(names) - {s.name for s in specs}
        if unknown:
            # a typo'd name must not shrink the sweep to nothing and
            # report clean, having verified zero kernels
            raise KernelCheckError(
                f"unknown kernel(s) {sorted(unknown)}; registered: "
                f"{[s.name for s in specs]}")
        specs = [s for s in specs if s.name in set(names)]
    return specs


def sweep(names: Optional[List[str]] = None, device: DeviceLike = None
          ) -> List[CaseResult]:
    """Every registered kernel's cases that run on ``device``'s type (or
    those of ``names``); ``device`` defaults to ``cuda``, which must
    exist."""
    device = resolve_device(device)
    results: List[CaseResult] = []
    if device.type == "cpu":
        warm_cpu_exp()
    with _full_fp32():
        for spec in _selected(names):
            for case in spec.cases:
                if device.type in case.devices:
                    results.append(run_case(spec, case, device))
    return results


# -- tolerance ledger ---------------------------------------------------------

def ledger_path(kernel: str, ledger_dir: Optional[str] = None) -> str:
    return os.path.join(ledger_dir or TOLERANCE_DIR, f"{kernel}.json")


def load_ledger(kernel: str, ledger_dir: Optional[str] = None
                ) -> Optional[Dict[str, Any]]:
    path = ledger_path(kernel, ledger_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def record_ledger(results: List[CaseResult], device_type: str,
                  ledger_dir: Optional[str] = None,
                  device_name: Optional[str] = None) -> List[str]:
    """Pin the observed errors of ``results`` as ``device_type``'s pins,
    keeping every other device's pins and every case not in ``results``.
    Values are rounded to 3 significant digits, so that a bitwise-stable
    re-record survives last-ulp drift in the error measurement.
    ``device_name``: the card's name and power limit, kept beside the
    CUDA pins."""
    by_kernel: Dict[str, Dict[str, Dict[str, float]]] = {}
    for r in results:
        if not all(np.isfinite(v) for v in r.metrics().values()):
            raise KernelCheckError(
                f"{r.kernel}/{r.case}: a non-finite error cannot be pinned")
        by_kernel.setdefault(r.kernel, {})[r.case] = {
            k: float(f"{v:.3g}") for k, v in r.metrics().items()}
    written = []
    for kernel in sorted(by_kernel):
        doc = load_ledger(kernel, ledger_dir) or {}
        doc["_kernel"] = kernel
        doc["_note"] = (
            "observed kernel-vs-oracle error per case and device type, "
            "pinned two-sided; re-record with python -m "
            "gke_ray_train_tpu_torch.analysis kernelcheck --record "
            "[--device cpu] and review the diff like code")
        if device_type == "cuda" and device_name:
            doc["_cuda_device"] = device_name
        cases = doc.setdefault("cases", {})
        for case, metrics in by_kernel[kernel].items():
            cases.setdefault(case, {})[device_type] = metrics
        path = ledger_path(kernel, ledger_dir)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        written.append(path)
    return written


def pinned(r: CaseResult, device_type: str,
           ledger_dir: Optional[str] = None) -> Optional[Dict[str, float]]:
    doc = load_ledger(r.kernel, ledger_dir) or {}
    return doc.get("cases", {}).get(r.case, {}).get(device_type)


def ledger_findings(results: List[CaseResult], device_type: str,
                    ledger_dir: Optional[str] = None
                    ) -> List[KernelFinding]:
    """KER100 / 101 / 102: the two-sided comparator. A regression (error
    above the pinned band) and an over-loosened pin (pin far above the
    error, e.g. a hand-edited ledger hiding a regression behind slack)
    both fail."""
    out: List[KernelFinding] = []
    for r in results:
        pins = pinned(r, device_type, ledger_dir)
        subject = f"{r.kernel}/{r.case}[{device_type}]"
        if pins is None:
            out.append(KernelFinding(
                "KER100", subject,
                "no pinned tolerance for this case on this device type: "
                "record the ledger (--record) and review the new pin"))
            continue
        for metric, observed in r.metrics().items():
            pin = pins.get(metric)
            if pin is None:
                out.append(KernelFinding(
                    "KER100", f"{subject}:{metric}",
                    "metric unpinned in the ledger: re-record"))
                continue
            if observed > max(pin * LEDGER_SLACK, LEDGER_FLOOR):
                out.append(KernelFinding(
                    "KER101", f"{subject}:{metric}",
                    f"observed error {observed:.3g} vs pinned {pin:.3g} "
                    f"(> {LEDGER_SLACK:g}x band): precision regression "
                    "against the oracle; if the change is intended, "
                    "re-record with --record"))
            elif pin > max(observed * LEDGER_SLACK, LEDGER_FLOOR):
                out.append(KernelFinding(
                    "KER102", f"{subject}:{metric}",
                    f"pinned tolerance {pin:.3g} is > {LEDGER_SLACK:g}x "
                    f"looser than the observed error {observed:.3g}: an "
                    "over-loose pin would hide the next regression; "
                    "re-record to tighten"))
    return out


def registration_findings() -> List[KernelFinding]:
    """KER006: every required op is registered."""
    from gke_ray_train_tpu_torch.ops import registry
    have = {s.name for s in registry.all_kernels()}
    return [KernelFinding(
        "KER006", name,
        "required kernel has no entry in ops/registry.py: an unregistered "
        "kernel has no oracle, no domain and no pinned tolerance, so "
        "nothing can verify it")
        for name in sorted(REQUIRED_KERNELS - have)]


def quick_verify(device: DeviceLike = None) -> List[CaseResult]:
    """The worker-start probe: the first case of every registered kernel
    that runs on ``device``'s type, values only, against the shipped
    ledger. Raises on a regression (KER100 / KER101): a worker whose
    kernels disagree with their oracles must not train."""
    from gke_ray_train_tpu_torch.ops import registry
    device = resolve_device(device)
    results = []
    if device.type == "cpu":
        warm_cpu_exp()
    with _full_fp32():
        for spec in registry.all_kernels():
            case = next((c for c in spec.cases
                         if device.type in c.devices), None)
            if case is not None:
                results.append(run_case(
                    spec, dataclasses.replace(case, grads=False), device))
    findings = [f for f in ledger_findings(results, device.type)
                if f.rule != "KER102"]   # a start gate: regressions only
    if findings:
        raise KernelCheckError(
            "kernel verification at start failed:\n  "
            + "\n  ".join(str(f) for f in findings))
    return results


# -- the CLI body -------------------------------------------------------------

def _fmt(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.3g}"


def main_check(names: Optional[List[str]] = None, *,
               device: DeviceLike = None,
               static_only: bool = False, record: bool = False,
               ledger_dir: Optional[str] = None,
               device_name: Optional[str] = None) -> int:
    """KER006, then (unless ``static_only``) the sweep on ``device``
    against its pins, or recorded as its pins. Prints one line per case
    and one per finding; returns 0 when clean, 1 on any finding."""
    findings = registration_findings()
    results: List[CaseResult] = []
    seconds = 0.0
    if not static_only:
        device = resolve_device(device)
        t0 = time.perf_counter()
        results = sweep(names, device)
        seconds = time.perf_counter() - t0
        if record:
            for path in record_ledger(results, device.type, ledger_dir,
                                      device_name):
                print(f"recorded {path}")
        else:
            findings.extend(ledger_findings(results, device.type,
                                            ledger_dir))
        for r in results:
            pins = pinned(r, device.type, ledger_dir) or {}
            print(f"{r.kernel}/{r.case} [{device.type}] value "
                  f"{_fmt(r.value_err)} (pin {_fmt(pins.get('value'))}) "
                  f"grad {_fmt(r.grad_err)} (pin {_fmt(pins.get('grad'))})"
                  f" {r.seconds:.2f}s")
    for f in findings:
        print(f"FINDING {f}")
    if findings:
        print(f"kernelcheck: {len(findings)} finding(s)")
        return 1
    parts = ["KER006 clean"]
    if results:
        worst = max(r.value_err for r in results)
        parts.append(f"{len(results)} differential case(s) on "
                     f"{device.type} "
                     f"{'recorded' if record else 'within the pinned ledger'}"
                     f", worst value error {worst:.3g}, {seconds:.1f}s")
    print("kernelcheck: clean (" + "; ".join(parts) + ")")
    return 0
