"""Throughput, MFU and the goodput ledger (counterpart of
``gke_ray_train_tpu/train/metrics.py``).

MFU = tokens/s x ``train_flops_per_token`` / ``peak_flops_per_device``,
the formula ``bench.py`` uses. :class:`ThroughputMeter` measures the
training window on the host clock; :class:`GoodputLedger` decomposes one
attempt's wall clock into :data:`LEDGER_TERMS`. Both are host arithmetic:
nothing here touches the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Optional

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def paused(meter):
    """Book the enclosed block as stall time of ``meter`` (a
    :class:`ThroughputMeter` or :class:`GoodputLedger`; nothing when
    None). Exception-safe: the meter is never left paused."""
    if meter is None:
        yield
        return
    meter.pause()
    try:
        yield
    finally:
        meter.resume()


# ---------------------------------------------------------------------------
# goodput ledger: one attempt's wall clock, decomposed
# ---------------------------------------------------------------------------

# every attempt's wall clock splits into exactly these terms.
# ckpt_async_s is the blocking part of an async-commit save (the
# serialize-to-storage tail runs in the background); peer_restore_s a
# restore served from a live peer instead of storage; a sync save books
# eval_ckpt_stall_s and a storage restore restore_s.
LEDGER_TERMS = ("compile_s", "restore_s", "fast_forward_s",
                "data_stall_s", "eval_ckpt_stall_s", "ckpt_async_s",
                "peer_restore_s", "step_s", "lost_s")


@dataclasses.dataclass
class GoodputLedger:
    """Accumulates one training attempt's wall-clock decomposition.

    ``run_training`` feeds it: restore and the first step are timed
    directly (in eager PyTorch the first step's ``compile_s`` is its
    wall time: kernel libraries loaded, cuBLAS and the allocator warmed,
    nothing traced), fast-forward is the remainder of the restart
    window, input waits arrive through :meth:`data_wait`, and eval /
    checkpoint stalls through :meth:`pause` / :meth:`resume` (the
    protocol of :class:`ThroughputMeter`, so ``paused(ledger)`` works).
    :meth:`close` books the unattributed rest as ``step_s``. ``lost_s``
    is not set here: the caller sets it to the attempt-wall residual
    (:func:`finish_ledger`), so the terms sum to the attempt's wall
    clock by construction.
    """
    compile_s: float = 0.0
    restore_s: float = 0.0
    fast_forward_s: float = 0.0
    data_stall_s: float = 0.0
    eval_ckpt_stall_s: float = 0.0
    ckpt_async_s: float = 0.0
    peer_restore_s: float = 0.0
    step_s: float = 0.0
    lost_s: float = 0.0
    _pause_t0: Optional[float] = None
    _closed: bool = False

    def note(self, term: str, seconds: Optional[float]) -> None:
        if seconds is None or term not in LEDGER_TERMS:
            return
        setattr(self, term, getattr(self, term) + max(float(seconds), 0.0))

    def data_wait(self, seconds: float) -> None:
        self.data_stall_s += max(float(seconds), 0.0)

    def pause(self) -> None:
        if self._pause_t0 is None:
            self._pause_t0 = time.perf_counter()

    def resume(self) -> None:
        if self._pause_t0 is not None:
            self.eval_ckpt_stall_s += time.perf_counter() - self._pause_t0
            self._pause_t0 = None

    def close(self, loop_wall_s: float) -> None:
        """Book the unaccounted rest of the loop's wall clock as
        ``step_s``. Idempotent: the preemption exit closes early (the
        ledger rides the exception) and the loop's ``finally`` again."""
        if self._closed:
            return
        self.resume()
        covered = (self.compile_s + self.restore_s + self.fast_forward_s
                   + self.data_stall_s + self.eval_ckpt_stall_s
                   + self.ckpt_async_s + self.peer_restore_s)
        self.step_s = max(float(loop_wall_s) - covered, 0.0)
        self._closed = True

    def as_dict(self) -> dict:
        return {t: float(getattr(self, t)) for t in LEDGER_TERMS}


def finish_ledger(led: Optional[dict], wall_s: float) -> dict:
    """One attempt's final ledger: the loop's terms (none when the
    attempt died outside the loop), ``lost_s`` set to the attempt-wall
    residual and ``wall_s`` recorded, so ``sum(LEDGER_TERMS) == wall_s``
    whenever the loop's terms do not exceed the wall."""
    out = {t: float((led or {}).get(t, 0.0)) for t in LEDGER_TERMS}
    covered = sum(v for k, v in out.items() if k != "lost_s")
    out["lost_s"] = max(float(wall_s) - covered, 0.0)
    out["wall_s"] = float(wall_s)
    return out


def sum_ledgers(ledgers) -> dict:
    """Element-wise sum of per-attempt ledgers plus ``goodput_frac`` =
    step time / total wall."""
    keys = LEDGER_TERMS + ("wall_s",)
    total = {k: float(sum(led.get(k, 0.0) for led in ledgers))
             for k in keys}
    total["goodput_frac"] = (total["step_s"] / total["wall_s"]
                             if total["wall_s"] > 0 else 0.0)
    return total


def ledger_metrics(led: dict) -> dict:
    """One ledger dict as the ``goodput_*`` metric names the TensorBoard
    writer publishes."""
    out = {f"goodput_{t}": float(led.get(t, 0.0)) for t in LEDGER_TERMS}
    if "wall_s" in led:
        out["goodput_wall_s"] = float(led["wall_s"])
        if led["wall_s"] > 0:
            out["goodput_frac"] = float(led.get("step_s", 0.0)) \
                / float(led["wall_s"])
    return out


# ---------------------------------------------------------------------------
# FLOPs, peak rate, the throughput meter
# ---------------------------------------------------------------------------

# dense bf16 tensor-core peaks (NVIDIA data sheets, no sparsity), by a
# lower-case substring of torch.cuda.get_device_name(), one entry per
# H100 variant: the SXM part ("NVIDIA H100 80GB HBM3"), the PCIe card and
# the NVL card; "cpu" is nominal, so MFU stays finite in CPU tests
PEAK_FLOPS = {
    "h100 80gb hbm3": 989e12,
    "h100 sxm": 989e12,
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
    "cpu": 1e12,
}
DEFAULT_PEAK_FLOPS = 989e12


def peak_flops_per_device(device_name: str) -> float:
    """The bf16 peak of the card named ``device_name``, longest matching
    key first; a card that matches no entry (an H100 variant not in the
    table among them) warns once and gets the H100 SXM's rate."""
    kind = device_name.lower()
    for k, v in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if k in kind:
            return v
    from gke_ray_train_tpu_torch.logging_utils import warn_once
    warn_once(logger, ("peak_flops", kind),
              "device %r matches no PEAK_FLOPS entry; MFU uses %.0f "
              "TFLOP/s", device_name, DEFAULT_PEAK_FLOPS / 1e12)
    return DEFAULT_PEAK_FLOPS


def device_name(device: DeviceLike = None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (default ``cuda``,
    which must exist); ``"cpu"`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(dev)


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


@dataclasses.dataclass
class ThroughputMeter:
    """Host-clock tokens/s per card and MFU over a window of steps.

    ``trainable`` is "lora" for (Q)LoRA runs (the 4N count). The loop
    calls :meth:`pause` / :meth:`resume` around eval and checkpoint
    saves, so ``mfu`` / ``tokens_per_sec*`` measure the training window;
    ``*_incl_stalls`` keep the stall-inclusive view. ``peak_flops``
    defaults to the peak of ``device`` (default ``cuda``, which must
    exist; ``"cpu"`` gets the nominal 1 TFLOP/s)."""
    cfg: ModelConfig
    seq_len: int
    n_devices: int
    peak_flops: Optional[float] = None
    trainable: str = "full"
    device: DeviceLike = None
    _t0: float = dataclasses.field(default_factory=time.perf_counter)
    _tokens: float = 0.0
    _steps: int = 0
    _paused_total: float = 0.0
    _pause_t0: Optional[float] = None
    _data_wait: float = 0.0

    def __post_init__(self):
        if self.peak_flops is None:
            self.peak_flops = peak_flops_per_device(device_name(self.device))

    def update(self, tokens_this_step: float) -> None:
        self._tokens += float(tokens_this_step)
        self._steps += 1

    def data_wait(self, seconds: float) -> None:
        """Book host seconds the loop spent blocked on the input pipeline;
        feeds ``data_stall_frac``."""
        self._data_wait += max(float(seconds), 0.0)

    def pause(self) -> None:
        """Mark the start of a non-training stall (eval, ckpt save)."""
        if self._pause_t0 is None:
            self._pause_t0 = time.perf_counter()

    def resume(self) -> None:
        if self._pause_t0 is not None:
            self._paused_total += time.perf_counter() - self._pause_t0
            self._pause_t0 = None

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._tokens = 0.0
        self._steps = 0
        self._paused_total = 0.0
        self._pause_t0 = None
        self._data_wait = 0.0

    def snapshot(self) -> dict:
        now = time.perf_counter()
        dt_wall = max(now - self._t0, 1e-9)
        paused_s = self._paused_total + (
            now - self._pause_t0 if self._pause_t0 is not None else 0.0)
        dt = max(dt_wall - paused_s, 1e-9)

        def rates(denom):
            tps = self._tokens / denom
            flops = tps * train_flops_per_token(self.cfg, self.seq_len,
                                                trainable=self.trainable)
            return tps, flops / (self.peak_flops * max(self.n_devices, 1))

        tps, mfu = rates(dt)
        tps_wall, mfu_wall = rates(dt_wall)
        return {
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps / max(self.n_devices, 1),
            "mfu": mfu,
            "steps_per_sec": self._steps / dt,
            # share of the training window the loop sat blocked on the
            # next placed batch
            "data_stall_frac": min(self._data_wait / dt, 1.0),
            # cumulative, stall-inclusive view
            "tokens_per_sec_per_chip_incl_stalls":
                tps_wall / max(self.n_devices, 1),
            "mfu_incl_stalls": mfu_wall,
        }
