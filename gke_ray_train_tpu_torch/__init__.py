"""gke_ray_train_tpu_torch — the PyTorch/CUDA port of ``gke_ray_train_tpu``.

The serving path of the JAX package, rewritten in PyTorch for one
NVIDIA H100: the continuous-batching engine (``serve/engine.py``), the
KV-cache step (``models/kvcache.py``), the decoder core
(``models/transformer.py``) and the ops under it. The one Pallas kernel
on that path, the flash-attention forward, is a CUDA C++ kernel written
for Hopper (``csrc/flash_fwd.cu``), built with ``nvcc`` at first use.

Module paths and public names mirror the JAX package so a reader finds
each counterpart; the JAX package stays the reference the port's tests
hold it against. This package imports ``torch`` and never ``jax`` nor
anything of ``gke_ray_train_tpu``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.py``).
"""

__version__ = "0.1.0"
