"""Build and load the port's CUDA kernels.

Each CUDA C++ source under ``csrc/`` holds one or more kernels behind
plain C entry points (the flash sources share ``csrc/hopper.cuh``). At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``_build/`` (listed in ``.gitignore``), named by a hash of
its source, the shared headers and the compiler flags, and loaded with
``ctypes``.
A build or load failure raises; nothing falls back.

``build()`` starts one ``nvcc`` per source, all at once, and waits for
them all — the form ``chip_smoke.py`` uses to build everything up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the shape, mask and stream arguments every flash entry ends with:
# B, S, T, H, K, dh, dtype, causal, use_window, window, scale, softcap,
# stream
_FLASH_TAIL = (_I,) * 10 + (_F, _F, _P)

# source name (csrc/<name>.cu) -> {C entry point: its argtypes}; every
# entry returns a cudaError_t
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    # q, k, v, qpos, kvpos, qseg, kvseg, out, lse
    "flash_fwd": {"flash_fwd": (_P,) * 9 + _FLASH_TAIL},
    # q, k, v, do, lse, dvec, qpos, kvpos, qseg, kvseg, then dq (dq
    # entry) or dk, dv (dkv entry)
    "flash_bwd": {"flash_bwd_dq": (_P,) * 11 + _FLASH_TAIL,
                  "flash_bwd_dkv": (_P,) * 12 + _FLASH_TAIL},
    # fused_rmsnorm: x, scale, y, rows, D, dtype, scale dtype, eps,
    # scale_plus_one, route, stream; fused_rope_qk: q, k, positions, inv_freqs,
    # out q, out k, B, S, H, K, dh, dtype, stream; fused_rmsnorm_rope: x,
    # scale, positions, inv_freqs, y, B, S, H, dh, dtype, scale dtype,
    # eps, scale_plus_one, stream
    "fused_norm_rope": {"fused_rmsnorm": (_P,) * 3 + (_I,) * 4
                        + (_F, _I, _I, _P),
                        "fused_rope_qk": (_P,) * 6 + (_I,) * 6 + (_P,),
                        "fused_rmsnorm_rope": (_P,) * 5 + (_I,) * 6
                        + (_F, _I, _P)},
    # fused_ce_row_stats: x, head, targets, partials, lse, tgt, N, D, V,
    # ctas, dtype, route, stream; fused_ce_dx: x, head, targets, wg, lse,
    # dl, acc, dx, N, D, V, chunk, dtype, route, stream; fused_ce_dhead:
    # the same with dhead in place of acc, dx
    "fused_ce": {"fused_ce_row_stats": (_P,) * 6 + (_I,) * 6 + (_P,),
                 "fused_ce_dx": (_P,) * 8 + (_I,) * 6 + (_P,),
                 "fused_ce_dhead": (_P,) * 7 + (_I,) * 6 + (_P,)},
}

_loaded: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    """The library's path, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the compiler flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return found


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_entries(log: str) -> List[dict]:
    """Per entry function in ``nvcc -Xptxas -v`` output, ``{"entry":
    mangled name, "registers", "stack", "spill_stores", "spill_loads"}``
    (bytes); a ptxas warning line as ``{"warning": line}``."""
    out: List[dict] = []
    for ln in log.splitlines():
        if "warning" in ln and "ptxas" in ln:
            out.append({"warning": ln.strip()})
        elif (m := _ENTRY.search(ln)):
            out.append({"entry": m.group(1)})
        elif out and "entry" in out[-1] and (m := _FRAME.search(ln)):
            out[-1].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif out and "entry" in out[-1] and (m := _REGS.search(ln)):
            out[-1]["registers"] = int(m.group(1))
    return out


def _read_ptxas(path: str) -> List[dict]:
    """The ptxas entries kept beside a built library (none if missing)."""
    try:
        with open(f"{path}.ptxas.json") as f:
            return json.load(f)
    except OSError:
        return []


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, all in
    parallel. Returns per kernel ``{"seconds", "cached", "ptxas"}``
    (``ptxas``: ``ptxas_entries`` of the compiler's output, kept beside
    the library for a cached build)."""
    names = list(SIGNATURES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    report: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            report[name] = {"seconds": 0.0, "cached": True,
                            "ptxas": _read_ptxas(path)}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        entries = ptxas_entries(log)
        with open(f"{path}.ptxas.json", "w") as f:
            json.dump(entries, f)
        os.replace(tmp, path)
        report[name] = {
            "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": entries}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        build([name])
    lib = ctypes.CDLL(path)
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
