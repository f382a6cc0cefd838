"""gke_ray_train_tpu_torch — the PyTorch/CUDA port of ``gke_ray_train_tpu``.

Paths of the JAX package, rewritten in PyTorch for one NVIDIA H100:

- serving: the continuous-batching engine (``serve/engine.py``) over the
  KV-cache step (``models/kvcache.py``);
- fine-tuning: the (Q)LoRA and full fine-tune step (``train/step.py``)
  with its optimizer (``train/optim.py``), adapters (``train/lora.py``)
  and the NF4 / int8 base (``ops/quant.py``, ``models/qinit.py``).

Both run the decoder core (``models/transformer.py``) and the ops under
it; the fine-tune step also runs with ``FUSED_OPS=1`` (on packed rows,
``data/packing.py``; without a logit softcap the loss through the fused
cross-entropy, ``ops/fused_ce.py``). A third path, kernel verification
(``python -m gke_ray_train_tpu_torch.analysis kernelcheck``), runs every
op of the kernel registry (``ops/registry.py``) against its oracle and a
tolerance ledger. The Pallas kernels on those paths — the
flash-attention forward, its dQ and dK/dV backward, the fused rms_norm
and q/k RoPE, the per-head rms_norm + RoPE, and the fused
cross-entropy's row statistics, dx and dhead — are CUDA C++ kernels
written for Hopper
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/fused_norm_rope.cu``, ``csrc/fused_ce.cu``), built with ``nvcc``
at first use.

Module paths and public names mirror the JAX package so a reader finds
each counterpart; the JAX package stays the reference the port's tests
hold it against. This package imports ``torch`` and never ``jax`` nor
anything of ``gke_ray_train_tpu``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.py``).
"""

__version__ = "0.1.0"
