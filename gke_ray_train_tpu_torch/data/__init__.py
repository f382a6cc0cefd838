"""data/ — the input side of training. So far sequence packing
(``packing.py``); the tokenizer, datasets and prefetch come later."""

from gke_ray_train_tpu_torch.data.packing import (  # noqa: F401
    batch_packed, pack_examples)
