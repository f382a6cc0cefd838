"""ckpt/ — checkpointing and HF interop (counterpart of
``gke_ray_train_tpu/ckpt/``): the resume manager on
``torch.distributed.checkpoint`` (``manager.py``, sharded across ranks
too), HF safetensors io (``hf_io.py``) over the ``safetensors`` package,
and the multi-rank export with its offline converter (``convert.py``).
The hub download (``hub.py``) and peer replication (``peer.py``) are not
ported (ROADMAP queue 1 items 3 and 8)."""

from gke_ray_train_tpu_torch.ckpt.manager import (  # noqa: F401
    CheckpointCommitError, CheckpointManager, flat_state)
from gke_ray_train_tpu_torch.ckpt.hf_io import (  # noqa: F401
    hf_tensor, load_hf_checkpoint, save_hf_checkpoint, write_hf_config)
