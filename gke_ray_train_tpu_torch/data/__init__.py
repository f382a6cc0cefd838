"""data/ — the input side of training (counterpart of
``gke_ray_train_tpu/data/``, the port's own copies; the JAX package's
exports, plus ``make_place_batch`` and ``PlacedBatch``, the single-card
placement onto the card)."""

from gke_ray_train_tpu_torch.data.tokenizer import (  # noqa: F401
    CharTokenizer, ByteTokenizer, load_hf_tokenizer,
    load_saved_tokenizer, save_tokenizer,
    PAD_ID, BOS_ID, EOS_ID, UNK_ID)
from gke_ray_train_tpu_torch.data.lm_dataset import (  # noqa: F401
    SlidingWindowDataset, ShardedBatches)
from gke_ray_train_tpu_torch.data.sft import (  # noqa: F401
    format_gretel_sql_example, render_chat, tokenize_sft_example, downsample,
    pad_sft_rows, sft_epoch_batches, synthetic_sql_rows)
from gke_ray_train_tpu_torch.data.packing import (  # noqa: F401
    pack_examples, batch_packed)
from gke_ray_train_tpu_torch.data.prepare import prepare_wikitext2  # noqa: F401
from gke_ray_train_tpu_torch.data.prefetch import (  # noqa: F401
    PlacedBatch, Prefetcher, SyncBatchSource, make_batch_source,
    make_place_batch)
