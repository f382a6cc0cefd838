"""Side-by-side base-vs-tuned inference comparison (counterpart of
``gke_ray_train_tpu/inference.py``).

After training: filter the test rows, greedy-generate from the original
and the fine-tuned weights with a shared prompt template, log the pairs
and write them as JSON. Both models generate through the KV-cached
prefill and step loop (``models/kvcache.py::greedy_generate_cached``),
with prompts bucketed to 128-multiples by the serving engine's helpers
(``serve/bucketing.py``), so the two paths cannot drift and the prefill
takes the flash kernel.

On a mesh (``mesh=``, the ``parallel/mesh.py::build_mesh`` mesh the
weights are sharded over) the comparison is collective, as the JAX
package's is: every rank enters every generate with the same prompt and
gets the same tokens (``models/kvcache.py``), and ``is_host0`` gates
only the log and the JSON.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from gke_ray_train_tpu_torch.data.sft import (
    format_gretel_sql_example, render_chat)
from gke_ray_train_tpu_torch.device import DeviceLike
from gke_ray_train_tpu_torch.models.config import ModelConfig
from gke_ray_train_tpu_torch.models.kvcache import greedy_generate_cached
from gke_ray_train_tpu_torch.models.transformer import Lora, Params
from gke_ray_train_tpu_torch.serve.bucketing import (
    form_prompt_buffer, prompt_bucket, truncate_prompt)

logger = logging.getLogger(__name__)


def clear_generate_cache() -> int:
    """The JAX package drops its cached replicated-generate executables
    here on mesh teardown. The port generates eagerly and caches nothing,
    so there is nothing to drop: returns 0, the number of entries
    dropped."""
    return 0


def _check_mesh(mesh: Any) -> None:
    """A ``mesh=`` must be a ``DeviceMesh`` (or None)."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= takes the torch DeviceMesh the weights are sharded "
            f"over (parallel/mesh.py::build_mesh), not "
            f"{type(mesh).__name__}")


def generate_answer(params: Params, cfg: ModelConfig, tokenizer,
                    prompt_text: str, *, max_new_tokens: int = 300,
                    lora: Optional[Lora] = None, lora_scale: float = 1.0,
                    mesh: Any = None, device: DeviceLike = None) -> str:
    """Greedy answer to one prompt on ``device`` (default ``cuda``); on a
    ``mesh`` every rank calls it with the same prompt and gets the same
    answer."""
    _check_mesh(mesh)
    ids = np.asarray(
        tokenizer(prompt_text, add_special_tokens=False)["input_ids"],
        np.int32)
    # an over-long prompt is truncated loudly (the head is dropped)
    max_prompt = max(cfg.max_seq_len - max_new_tokens, 1)
    ids = truncate_prompt(ids, max_prompt, label="generate_answer prompt")
    # the buffer width rounded to a 128 multiple: the KV-cache flash
    # prefill gates on the cache width tiling too (models/kvcache.py)
    L = min(prompt_bucket(len(ids) + max_new_tokens), cfg.max_seq_len)
    buf, _ = form_prompt_buffer(ids, L)
    eos_ids = []
    if getattr(tokenizer, "eos_token_id", None) is not None:
        eos_ids.append(int(tokenizer.eos_token_id))
    out = greedy_generate_cached(
        params, buf, [len(ids)], cfg, max_new_tokens=max_new_tokens,
        eos_ids=tuple(eos_ids), lora=lora, lora_scale=lora_scale,
        device=device)
    gen = out[0].cpu().numpy()[len(ids):]
    # trim at the first EOS; otherwise strip only trailing zeros (the
    # unwritten buffer tail): a generated token id 0 mid-answer stays
    stops = np.where(np.isin(gen, eos_ids))[0] if eos_ids else []
    if len(stops):
        gen = gen[: stops[0]]
    else:
        nz = np.nonzero(gen)[0]
        gen = gen[: nz[-1] + 1] if len(nz) else gen[:0]
    return tokenizer.decode(gen)


def run_inference_comparison(
        base_params: Params, tuned_params: Params, cfg: ModelConfig,
        tokenizer, test_rows: List[Dict], *,
        num_samples: int = 2, max_new_tokens: int = 300,
        output_path: Optional[str] = None,
        row_filter: Optional[Callable[[Dict], bool]] = None,
        format_example: Callable = format_gretel_sql_example,
        mesh: Any = None, is_host0: bool = True,
        tuned_lora: Optional[Lora] = None, lora_scale: float = 1.0,
        device: DeviceLike = None) -> List[Dict]:
    """The comparison records (question, reference, base and tuned
    answers) of the first ``num_samples`` rows that pass ``row_filter``;
    written as JSON to ``output_path`` when given. ``tuned_lora``: the
    tuned model is ``tuned_params`` plus these adapters applied at decode
    time — (Q)LoRA runs never build a merged copy of the base. On a
    ``mesh`` every rank calls it with the same rows (module doc) and
    gets the same records."""
    _check_mesh(mesh)
    if row_filter is not None:
        test_rows = [r for r in test_rows if row_filter(r)]
    test_rows = test_rows[:num_samples]
    results = []
    for i, row in enumerate(test_rows):
        msgs = format_example(row)
        prompt = render_chat(tokenizer, msgs, add_generation_prompt=True)
        record = {
            "index": i,
            "question": msgs["user"],
            "reference_answer": msgs["assistant"],
            "base_model_answer": generate_answer(
                base_params, cfg, tokenizer, prompt,
                max_new_tokens=max_new_tokens, mesh=mesh, device=device),
            "finetuned_model_answer": generate_answer(
                tuned_params, cfg, tokenizer, prompt,
                max_new_tokens=max_new_tokens, lora=tuned_lora,
                lora_scale=lora_scale, mesh=mesh, device=device),
        }
        if is_host0:
            logger.info("sample %d\n  Q: %s\n  base: %s\n  tuned: %s", i,
                        record["question"], record["base_model_answer"],
                        record["finetuned_model_answer"])
        results.append(record)
    if output_path and is_host0:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(results, f, indent=2)
        logger.info("wrote %d comparison records to %s", len(results),
                    output_path)
    return results
