"""Greedy decoding by full forward (counterpart of
``gke_ray_train_tpu/models/decode.py``): every step recomputes the whole
forward over the fixed buffer. It is the correctness oracle for the
KV-cache decode in ``models/kvcache.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from gke_ray_train_tpu_torch.device import DeviceLike, check_on, resolve_device
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.kvcache import as_device_ints
from gke_ray_train_tpu_torch.models.transformer import Lora, Params, forward


@torch.no_grad()
def greedy_generate(params: Params, prompt, prompt_len, cfg: ModelConfig, *,
                    max_new_tokens: int = 64,
                    eos_ids: Sequence[int] = (),
                    lora: Optional[Lora] = None,
                    lora_scale: float = 1.0,
                    device: DeviceLike = None) -> torch.Tensor:
    """prompt: [B, L] padded buffer with room for generation; prompt_len:
    [B]. Returns the buffer with generated tokens written after each
    prompt; finished rows (EOS emitted) stop growing."""
    dev = resolve_device(device)
    check_on(params.embed, dev, "params")
    buf = as_device_ints(prompt, dev)
    lens = as_device_ints(prompt_len, dev)
    B, L = buf.shape
    eos = torch.tensor(list(eos_ids) or [-1], dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    cols = torch.arange(L, device=dev)[None, :]
    for _ in range(max_new_tokens):
        if bool(done.all()):
            break
        logits = forward(params, buf, cfg, lora=lora, lora_scale=lora_scale)
        # the next token comes from the logit at each row's last token
        idx = (lens - 1).clamp(0, L - 1).long()
        next_tok = torch.argmax(logits[rows, idx], dim=-1).to(torch.int32)
        write_pos = lens.clamp(0, L - 1)
        buf = torch.where((~done)[:, None] & (cols == write_pos[:, None]),
                          next_tok[:, None], buf)
        now_eos = torch.any(next_tok[:, None] == eos[None, :], dim=-1)
        new_lens = torch.where(done | (lens >= L), lens, lens + 1)
        done = done | now_eos | (new_lens >= L)
        lens = new_lens
    return buf
