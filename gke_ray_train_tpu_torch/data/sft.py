"""SFT data formatting — chat templates + prompt-masked tokenization
(counterpart of ``gke_ray_train_tpu/data/sft.py``, the port's own copy;
numpy only).

Parity with the reference's gretelai text-to-SQL formatter
(format_gretel_sql_for_sft_chat_template,
ray-jobs/fine_tune_llama_ray.py:257-273: system prompt from schema+context,
user question, assistant SQL answer) and the downsample-with-seed behavior
(:288-289, shuffle(seed=42) → select(N)).

Improvement over the reference: the reference's SFTTrainer trains on the
whole templated string (prompt included); here prompt tokens get weight 0
by default (``train_on_prompt=False``) — completion-only loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

SQL_SYSTEM_PROMPT = (
    "You are a text-to-SQL assistant. Given a database schema and a "
    "question, write the SQL query that answers the question.\n"
    "Schema:\n{schema}\nContext:\n{context}")


def format_gretel_sql_example(row: Dict) -> Dict[str, str]:
    """gretelai/synthetic_text_to_sql row → {system, user, assistant}."""
    return {
        "system": SQL_SYSTEM_PROMPT.format(
            schema=row.get("sql_context", ""),
            context=row.get("sql_task_type", "")),
        "user": row.get("sql_prompt", ""),
        "assistant": row.get("sql", ""),
    }


def render_chat(tokenizer, msgs: Dict[str, str],
                add_generation_prompt: bool = False) -> str:
    """Render via the tokenizer's own chat template when available (the
    reference relies on Llama-3's template; Mistral/Gemma templates come
    for free the same way), else a plain readable fallback."""
    chat = [{"role": "system", "content": msgs["system"]},
            {"role": "user", "content": msgs["user"]}]
    if not add_generation_prompt:
        chat.append({"role": "assistant", "content": msgs["assistant"]})
    if getattr(tokenizer, "chat_template", None):
        return tokenizer.apply_chat_template(
            chat, tokenize=False, add_generation_prompt=add_generation_prompt)
    parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in chat]
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


def tokenize_sft_example(tokenizer, msgs: Dict[str, str], *,
                         max_len: int,
                         train_on_prompt: bool = False) -> Dict[str, np.ndarray]:
    """→ {input_ids [L], loss_weights [L]} with prompt tokens masked.

    The prompt/completion split is computed by tokenizing the
    generation-prompt prefix separately — robust to any chat template.
    """
    full = render_chat(tokenizer, msgs, add_generation_prompt=False)
    prefix = render_chat(tokenizer, msgs, add_generation_prompt=True)
    full_ids = np.asarray(tokenizer(full, add_special_tokens=False)["input_ids"],
                          np.int32)[:max_len]
    prefix_ids = tokenizer(prefix, add_special_tokens=False)["input_ids"]
    n_prompt = min(len(prefix_ids), len(full_ids))
    weights = np.ones(len(full_ids), np.float32)
    if not train_on_prompt:
        weights[:n_prompt] = 0.0
    return {"input_ids": full_ids, "loss_weights": weights}


def pad_sft_rows(examples: List[Dict[str, np.ndarray]], seq_len: int,
                 *, pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Unpacked path: one example per row, right-padded to seq_len.
    → {inputs, targets, weights} each [N, seq_len]."""
    n = len(examples)
    inputs = np.full((n, seq_len), pad_id, np.int32)
    targets = np.full((n, seq_len), pad_id, np.int32)
    weights = np.zeros((n, seq_len), np.float32)
    for i, ex in enumerate(examples):
        ids = np.asarray(ex["input_ids"], np.int32)[: seq_len + 1]
        w = np.asarray(ex["loss_weights"], np.float32)[: seq_len + 1]
        L = len(ids) - 1
        if L < 1:
            continue
        inputs[i, :L] = ids[:-1]
        targets[i, :L] = ids[1:]
        weights[i, :L] = w[1:]
    return {"inputs": inputs, "targets": targets, "weights": weights}


def sft_epoch_batches(rows: Dict[str, np.ndarray], global_batch: int, *,
                      num_hosts: int = 1, host_id: int = 0, seed: int = 42,
                      epoch: int = 0, shuffle: bool = True,
                      group_by_length: bool = False):
    """Shuffle + shard + batch pre-padded SFT rows ([N, S] arrays).
    Mirrors ShardedBatches' host partitioning for the SFT path.

    ``group_by_length`` (reference GROUP_BY_LENGTH,
    fine_tune_config.json:29; HF LengthGroupedSampler semantics): batches
    are formed from similar-length examples (less padding waste), with
    the *batch order* reshuffled per epoch."""
    n = len(rows["inputs"])
    if group_by_length:
        lengths = np.count_nonzero(rows["inputs"], axis=1)
        by_len = np.argsort(lengths, kind="stable")[::-1]
        nb = max(n // global_batch, 0)
        batches = by_len[:nb * global_batch].reshape(nb, global_batch)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(batches, axis=0)
        # the tail joins at the end so no example is ever dropped
        order = np.concatenate([batches.reshape(-1),
                                by_len[nb * global_batch:]])
    else:
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
    host_batch = global_batch // num_hosts
    steps = n // global_batch
    for s in range(steps):
        chunk = order[s * global_batch:(s + 1) * global_batch]
        mine = chunk[host_id::num_hosts][:host_batch]
        yield {k: v[mine] for k, v in rows.items()}
    # tail: the last n % global_batch examples train too (HF Trainer's
    # dataloader keeps the final incomplete batch by default, and so did
    # the reference). The batch is padded to full host_batch with
    # zero-weight rows so the batch shape stays constant and every host
    # yields in lockstep.
    rem = order[steps * global_batch:]
    if len(rem):
        mine = rem[host_id::num_hosts][:host_batch]
        batch = {k: v[mine] for k, v in rows.items()}
        pad = host_batch - len(mine)
        if pad:
            batch = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in batch.items()}
        yield batch


def synthetic_sql_rows(n: int, seed: int = 0) -> List[Dict]:
    """Deterministic gretel-schema-shaped rows for offline/smoke runs."""
    rng = np.random.default_rng(seed)
    tables = ["users", "orders", "events", "products", "sessions"]
    cols = ["id", "name", "ts", "amount", "status", "region"]
    rows = []
    for _ in range(n):
        t = tables[int(rng.integers(len(tables)))]
        c = cols[int(rng.integers(len(cols)))]
        rows.append({
            "sql_context": f"CREATE TABLE {t} ({c} INT, value INT);",
            "sql_task_type": "analytics",
            "sql_prompt": f"total value by {c} in {t}",
            "sql": f"SELECT {c}, SUM(value) FROM {t} GROUP BY {c};",
            "sql_complexity": "window functions" if rng.random() < 0.3
            else "basic",
        })
    return rows


def downsample(rows: List, n: Optional[int], seed: int = 42) -> List:
    """shuffle(seed=42).select(range(n)) parity
    (fine_tune_llama_ray.py:288-289)."""
    if n is None or n >= len(rows):
        return list(rows)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(rows))[:n]
    return [rows[int(i)] for i in idx]
