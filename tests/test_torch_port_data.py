"""The port's input path (``gke_ray_train_tpu_torch/data/``) against the
JAX package's (``gke_ray_train_tpu/data/``), on the CPU.

Every comparison is bitwise: the same numpy inputs and seeds go through
both packages in one process (the synthetic corpus of ``prepare`` hashes
the split name, which agrees only within a process). The prefetch
contract of ``tests/test_prefetch.py`` (ordering, backpressure, skip,
exceptions, shutdown) is held on the port's classes, with batches placed
by ``make_place_batch("cpu")``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from gke_ray_train_tpu.data import lm_dataset as jlm
from gke_ray_train_tpu.data import prepare as jprep
from gke_ray_train_tpu.data import sft as jsft
from gke_ray_train_tpu.data import tokenizer as jtok
from gke_ray_train_tpu_torch import data as tdata
from gke_ray_train_tpu_torch.data import lm_dataset as tlm
from gke_ray_train_tpu_torch.data import prepare as tprep
from gke_ray_train_tpu_torch.data import sft as tsft
from gke_ray_train_tpu_torch.data import tokenizer as ttok
from gke_ray_train_tpu_torch.data.prefetch import (
    PlacedBatch, Prefetcher, SyncBatchSource, make_batch_source,
    make_place_batch)
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


TEXT = "SELECT name, SUM(value) FROM users GROUP BY name; -- é ü 字"


def _same(a, b):
    """Two batches (dicts of arrays or tensors) bitwise equal, key for
    key, dtype for dtype."""
    assert sorted(a) == sorted(b)
    for k in a:
        x = np.asarray(a[k])
        y = np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


# ---------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------

def test_exports_match_the_jax_package():
    import gke_ray_train_tpu.data as jdata
    ours = {n for n in dir(tdata) if not n.startswith("_")}
    theirs = {n for n in dir(jdata) if not n.startswith("_")}
    assert theirs - {"lm_dataset", "packing", "prefetch", "prepare", "sft",
                     "tokenizer"} <= ours
    assert (ttok.PAD_ID, ttok.BOS_ID, ttok.EOS_ID, ttok.UNK_ID) == \
        (jtok.PAD_ID, jtok.BOS_ID, jtok.EOS_ID, jtok.UNK_ID)
    assert ttok.GRAFT_TOKENIZER_FILE == jtok.GRAFT_TOKENIZER_FILE


def test_char_tokenizer_ids_and_decode_match():
    t, j = ttok.CharTokenizer.fit(TEXT), jtok.CharTokenizer.fit(TEXT)
    assert t.stoi == j.stoi and t.vocab_size == j.vocab_size
    probe = TEXT + " unseen: qZ~"
    ti, ji = t.encode(probe), j.encode(probe)
    assert ti.dtype == ji.dtype and np.array_equal(ti, ji)
    assert t.decode(ti) == j.decode(ji)
    assert t.decode([0, 1, 2, 3] + list(ti)) == j.decode([0, 1, 2, 3]
                                                         + list(ji))


def test_byte_tokenizer_ids_and_decode_match():
    t, j = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    assert t(TEXT) == j(TEXT)
    assert t(TEXT, add_special_tokens=True) == j(TEXT,
                                                  add_special_tokens=True)
    assert t.encode(TEXT) == j.encode(TEXT)
    # reserved ids and ids past the byte range are skipped alike
    ids = [0, 1, 2, 3] + t.encode(TEXT) + [260, 5000]
    assert t.decode(ids) == j.decode(ids) == TEXT
    assert t.decode(t.encode(TEXT)[:-1]) == j.decode(j.encode(TEXT)[:-1])
    assert (t.vocab_size, t.eos_token_id, t.pad_token_id,
            t.chat_template) == (j.vocab_size, j.eos_token_id,
                                 j.pad_token_id, j.chat_template)


@pytest.mark.parametrize("kind", ["char", "byte"])
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_saved_tokenizer_loads_in_the_other_package(tmp_path, kind,
                                                    saved_by):
    save_mod, load_mod = (jtok, ttok) if saved_by == "jax" else (ttok, jtok)
    tok = (save_mod.CharTokenizer.fit(TEXT) if kind == "char"
           else save_mod.ByteTokenizer())
    save_mod.save_tokenizer(tok, str(tmp_path))
    path = tmp_path / ttok.GRAFT_TOKENIZER_FILE
    other = load_mod.load_saved_tokenizer(str(tmp_path))
    same = save_mod.load_saved_tokenizer(str(tmp_path))
    assert type(other).__name__ == type(tok).__name__
    assert np.array_equal(np.asarray(other.encode(TEXT)),
                          np.asarray(same.encode(TEXT)))
    assert other.decode(other.encode(TEXT)) == same.decode(
        same.encode(TEXT))
    assert json.loads(path.read_text())["type"] == kind


def test_saved_tokenizer_refusals_match(tmp_path):
    path = tmp_path / ttok.GRAFT_TOKENIZER_FILE
    for payload in ({"type": "bpe"}, {"type": "char"}):
        path.write_text(json.dumps(payload))
        for mod in (ttok, jtok):
            with pytest.raises(ValueError):
                mod.load_saved_tokenizer(str(tmp_path))
    # legacy char files carry "stoi" without "type"
    path.write_text(json.dumps({"stoi": {"a": 4, "b": 5}}))
    assert ttok.load_saved_tokenizer(str(tmp_path)).stoi == \
        jtok.load_saved_tokenizer(str(tmp_path)).stoi
    with pytest.raises(TypeError):
        ttok.save_tokenizer(object(), str(tmp_path))


# ---------------------------------------------------------------------
# SFT rows
# ---------------------------------------------------------------------

@pytest.mark.parametrize("gen", [False, True])
def test_render_chat_matches(gen):
    for row in jsft.synthetic_sql_rows(4, seed=3):
        msgs = tsft.format_gretel_sql_example(row)
        assert msgs == jsft.format_gretel_sql_example(row)
        assert tsft.render_chat(ttok.ByteTokenizer(), msgs,
                                add_generation_prompt=gen) == \
            jsft.render_chat(jtok.ByteTokenizer(), msgs,
                             add_generation_prompt=gen)


@pytest.mark.parametrize("max_len", [40, 120, 1025])
@pytest.mark.parametrize("train_on_prompt", [False, True])
def test_tokenize_sft_example_matches(max_len, train_on_prompt):
    for row in tsft.synthetic_sql_rows(5, seed=1):
        got = tsft.tokenize_sft_example(
            ttok.ByteTokenizer(), tsft.format_gretel_sql_example(row),
            max_len=max_len, train_on_prompt=train_on_prompt)
        want = jsft.tokenize_sft_example(
            jtok.ByteTokenizer(), jsft.format_gretel_sql_example(row),
            max_len=max_len, train_on_prompt=train_on_prompt)
        _same(got, want)


def _examples(n, max_len, seed=0):
    rows = jsft.synthetic_sql_rows(n, seed=seed)
    return [jsft.tokenize_sft_example(
        jtok.ByteTokenizer(), jsft.format_gretel_sql_example(r),
        max_len=max_len) for r in rows]


@pytest.mark.parametrize("seq", [16, 64, 300])
def test_pad_sft_rows_matches(seq):
    exs = _examples(7, seq + 1)
    # an example of one token trains nothing: its row stays padding
    exs.append({"input_ids": np.array([9], np.int32),
                "loss_weights": np.ones(1, np.float32)})
    _same(tsft.pad_sft_rows(exs, seq, pad_id=0),
          jsft.pad_sft_rows(exs, seq, pad_id=0))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("group_by_length", [False, True])
@pytest.mark.parametrize("num_hosts", [1, 2])
def test_sft_epoch_batches_match(shuffle, group_by_length, num_hosts):
    rows = jsft.pad_sft_rows(_examples(23, 97), 96)   # 23 % 6: a tail
    for epoch in (0, 1):
        for host in range(num_hosts):
            kw = dict(num_hosts=num_hosts, host_id=host, seed=5,
                      epoch=epoch, shuffle=shuffle,
                      group_by_length=group_by_length)
            got = list(tsft.sft_epoch_batches(rows, 6, **kw))
            want = list(jsft.sft_epoch_batches(rows, 6, **kw))
            assert len(got) == len(want) == 4
            for a, b in zip(got, want):
                _same(a, b)
            # the zero-weight tail keeps the host batch's shape
            assert got[-1]["inputs"].shape == (6 // num_hosts, 96)


@pytest.mark.parametrize("n,seed", [(1, 0), (64, 0), (200, 7)])
def test_synthetic_sql_rows_and_downsample_match(n, seed):
    rows = tsft.synthetic_sql_rows(n, seed=seed)
    assert rows == jsft.synthetic_sql_rows(n, seed=seed)
    for k in (None, 0, 1, n // 2, n, n + 5):
        assert tsft.downsample(rows, k) == jsft.downsample(rows, k)
        assert tsft.downsample(rows, k, seed=3) == \
            jsft.downsample(rows, k, seed=3)


# ---------------------------------------------------------------------
# LM dataset
# ---------------------------------------------------------------------

def test_sliding_window_gather_matches():
    ids = np.random.default_rng(0).integers(0, 300, 500)
    t, j = tlm.SlidingWindowDataset(ids, 16), jlm.SlidingWindowDataset(
        ids, 16)
    assert len(t) == len(j) == 484
    starts = np.array([0, 5, 483, 100])
    _same(t.gather(starts), j.gather(starts))
    assert len(tlm.SlidingWindowDataset(ids[:10], 16)) == 0


@pytest.mark.parametrize("num_hosts,drop_last,max_samples",
                         [(1, True, None), (2, True, None),
                          (2, False, None), (1, False, 50),
                          (4, True, 37)])
def test_sharded_batches_iter_epoch_matches(num_hosts, drop_last,
                                            max_samples):
    ids = np.random.default_rng(1).integers(0, 300, 400)
    for host in range(num_hosts):
        kw = dict(global_batch=8, num_hosts=num_hosts, host_id=host,
                  seed=11, drop_last=drop_last, max_samples=max_samples)
        t = tlm.ShardedBatches(tlm.SlidingWindowDataset(ids, 12), **kw)
        j = jlm.ShardedBatches(jlm.SlidingWindowDataset(ids, 12), **kw)
        assert t.steps_per_epoch() == j.steps_per_epoch()
        for epoch in (0, 3):
            got, want = list(t.iter_epoch(epoch)), list(j.iter_epoch(epoch))
            assert len(got) == len(want) == t.steps_per_epoch()
            for a, b in zip(got, want):
                _same(a, b)
    with pytest.raises(ValueError):
        tlm.ShardedBatches(tlm.SlidingWindowDataset(ids, 12),
                           global_batch=6, num_hosts=4)


# ---------------------------------------------------------------------
# prepare
# ---------------------------------------------------------------------

@pytest.fixture
def offline(monkeypatch):
    """The hub probe reads these and opens no socket."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")


def test_hub_probe_offline_opens_no_socket(offline, monkeypatch):
    import socket

    def refuse(*a, **k):
        raise AssertionError("the probe opened a socket")
    monkeypatch.setattr(socket, "create_connection", refuse)
    assert tprep.hub_reachable() is False
    assert jprep.hub_reachable() is False


def test_prepare_wikitext2_synthetic_matches(tmp_path, offline):
    got = tprep.prepare_wikitext2(str(tmp_path / "t"), synthetic_fallback=True,
                                  synthetic_chars=5000)
    want = jprep.prepare_wikitext2(str(tmp_path / "j"),
                                   synthetic_fallback=True,
                                   synthetic_chars=5000)
    assert sorted(got) == sorted(want) == sorted(tprep.SPLITS)
    for split in tprep.SPLITS:
        assert os.path.basename(got[split]) == os.path.basename(want[split])
        with open(got[split]) as a, open(want[split]) as b:
            text = a.read()
            assert text == b.read()
        assert len(text) == (5000 if split == "train" else 500)
    assert tprep._synthetic_corpus(3, 2000) == jprep._synthetic_corpus(3,
                                                                       2000)


def test_prepare_wikitext2_keeps_an_existing_file(tmp_path, offline):
    out = tmp_path / "d"
    out.mkdir()
    (out / "wikitext2_train.txt").write_text("kept")
    paths = tprep.prepare_wikitext2(str(out), splits=("train", "test"),
                                    synthetic_fallback=True,
                                    synthetic_chars=1000)
    assert open(paths["train"]).read() == "kept"
    assert len(open(paths["test"]).read()) == 100
    # every file present: nothing to do, nothing rewritten
    assert tprep.prepare_wikitext2(str(out), splits=("train",)) == \
        {"train": paths["train"]}
    tprep.prepare_wikitext2(str(out), splits=("train",), force=True,
                            synthetic_fallback=True, synthetic_chars=1000)
    assert len(open(paths["train"]).read()) == 1000


# ---------------------------------------------------------------------
# prefetch: the contract of tests/test_prefetch.py on the port's classes
# ---------------------------------------------------------------------

def _batches(n):
    for i in range(n):
        yield {"inputs": np.full((2, 4), i, np.int32)}


def _first(b):
    return int(b["inputs"][0, 0])


PLACE_CPU = make_place_batch("cpu")


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_ordering_preserved(workers):
    placed = []

    def place(b):
        time.sleep(0.001 * (_first(b) % 3))
        placed.append(_first(b))
        return PLACE_CPU(b)

    src = Prefetcher(_batches(12), place_fn=place, depth=4, workers=workers)
    out = [b for b in src]
    assert [_first(b) for b in out] == list(range(12))
    assert all(isinstance(b["inputs"], torch.Tensor) for b in out)
    assert sorted(placed) == list(range(12))
    assert src.yielded == 12 and src.skipped == 0


@pytest.mark.parametrize("workers", [1, 2])
def test_queue_depth_bounded(workers):
    produced = []
    lock = threading.Lock()

    def place(b):
        with lock:
            produced.append(_first(b))
        return PLACE_CPU(b)

    depth = 2
    src = Prefetcher(_batches(50), place_fn=place, depth=depth,
                     workers=workers)
    try:
        next(iter(src))
        time.sleep(0.5)
        assert len(produced) <= 1 + depth + workers
    finally:
        src.close()


@pytest.mark.parametrize("workers", [1, 2])
def test_iterator_exception_reraised_after_good_batches(workers):
    def gen():
        yield from _batches(3)
        raise RuntimeError("tokenizer blew up")

    src = Prefetcher(gen(), place_fn=PLACE_CPU, depth=2, workers=workers)
    got = []
    with pytest.raises(RuntimeError, match="tokenizer blew up"):
        for b in src:
            got.append(_first(b))
    assert got == [0, 1, 2]
    for t in src._threads:
        t.join(timeout=5)
        assert not t.is_alive()


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_place_exception_reraised_in_order(workers):
    def place(b):
        if _first(b) == 2:
            raise ValueError("copy to the card failed")
        return PLACE_CPU(b)

    src = Prefetcher(_batches(6), place_fn=place, depth=3, workers=workers)
    got = []
    with pytest.raises(ValueError, match="copy to the card failed"):
        for b in src:
            got.append(_first(b))
    assert got == [0, 1]


@pytest.mark.parametrize("workers", [1, 2])
def test_shutdown_leaks_no_threads(workers):
    before = threading.active_count()

    def endless():
        i = 0
        while True:
            yield {"inputs": np.full((2, 4), i, np.int32)}
            i += 1

    src = Prefetcher(endless(), place_fn=PLACE_CPU, depth=2, workers=workers)
    next(iter(src))
    src.close()
    for t in src._threads:
        assert not t.is_alive()
    assert threading.active_count() <= before
    src.close()
    with pytest.raises(StopIteration):
        next(iter(src))


@pytest.mark.parametrize("workers", [1, 2])
def test_exhausted_source_joins_workers(workers):
    src = Prefetcher(_batches(3), place_fn=PLACE_CPU, depth=2,
                     workers=workers)
    assert [_first(b) for b in src] == [0, 1, 2]
    for t in src._threads:
        assert not t.is_alive()


@pytest.mark.parametrize("workers", [None, 1, 2])
def test_resume_skip_never_places(workers):
    placed = []

    def place(b):
        placed.append(_first(b))
        return PLACE_CPU(b)

    src = (SyncBatchSource(_batches(6), place_fn=place, skip=4)
           if workers is None else
           Prefetcher(_batches(6), place_fn=place, skip=4, depth=2,
                      workers=workers))
    assert [_first(b) for b in src] == [4, 5]
    assert sorted(placed) == [4, 5], "skipped batches never reach place_fn"
    assert src.yielded == 6 and src.skipped == 4


def test_make_batch_source_dispatch():
    assert isinstance(make_batch_source(_batches(1), depth=0),
                      SyncBatchSource)
    src = make_batch_source(_batches(1), depth=2)
    assert isinstance(src, Prefetcher)
    src.close()
    with pytest.raises(ValueError):
        Prefetcher(_batches(1), depth=0)


@pytest.mark.parametrize("depth", [0, 2])
def test_consume_wait_accumulates(depth):
    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield {"inputs": np.full((2, 4), i, np.int32)}

    src = make_batch_source(slow(), place_fn=PLACE_CPU, depth=depth)
    next(iter(src))
    assert src.consume_wait() >= 0.04
    assert src.consume_wait() == 0.0
    src.close()


def test_place_batch_on_cpu_copies_and_touches_no_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA was touched")
    for name in ("is_available", "Stream", "Event", "current_stream",
                 "current_device", "device", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    place = make_place_batch("cpu")
    batch = {"inputs": np.arange(12, dtype=np.int32).reshape(3, 4),
             "weights": np.ones((3, 4), np.float32)[:, ::2]}
    got = place(batch)
    assert not isinstance(got, PlacedBatch)
    assert {k: v.device.type for k, v in got.items()} == \
        {"inputs": "cpu", "weights": "cpu"}
    _same(got, batch)
    batch["inputs"][0, 0] = 99                  # a copy, not a view
    assert int(got["inputs"][0, 0]) == 0


def test_place_batch_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_place_batch()
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_place_batch("meta")


# ---------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------

def _job_rows(mod_sft, mod_tok, n, seq):
    """The offline unpacked SFT path of ray-jobs/fine_tune_llama_ray.py
    (:215-256): synthetic rows, downsample, ByteTokenizer, pad."""
    rows = mod_sft.downsample(mod_sft.synthetic_sql_rows(max(n, 64), seed=0),
                              n)
    tok = mod_tok.ByteTokenizer()
    exs = [mod_sft.tokenize_sft_example(
        tok, mod_sft.format_gretel_sql_example(r), max_len=seq + 1)
        for r in rows]
    return mod_sft.pad_sft_rows(exs, seq)


@pytest.mark.parametrize("depth", [0, 2])
def test_offline_sft_stream_matches_the_jax_package(depth):
    seq, batch_rows = 384, 8
    t_rows = _job_rows(tsft, ttok, 30, seq)
    j_rows = _job_rows(jsft, jtok, 30, seq)
    _same(t_rows, j_rows)
    src = make_batch_source(tsft.sft_epoch_batches(t_rows, batch_rows),
                            place_fn=PLACE_CPU, depth=depth)
    got = list(src)
    want = list(jsft.sft_epoch_batches(j_rows, batch_rows))
    assert len(got) == len(want) == 4          # 30 rows: 3 + the tail
    for a, b in zip(got, want):
        _same(a, b)
    # rendered by bytes, a row is about 300 tokens, its SQL answer about
    # 50 of them: the weight-1 share is small
    share = float(t_rows["weights"].sum()) / t_rows["weights"].size
    assert 0.05 < share < 0.25


def test_tiny_model_losses_equal_with_and_without_prefetch():
    """Three steps of a tiny model on the offline SFT stream: inline
    (depth 0) and prefetched (depth 2) losses are bitwise equal."""
    from gke_ray_train_tpu_torch.models import init_params, tiny
    from gke_ray_train_tpu_torch.train import (
        make_optimizer, make_train_state, make_train_step)
    seq = 320
    cfg = tiny(vocab_size=260, max_seq_len=seq)
    rows = _job_rows(tsft, ttok, 12, seq)
    runs = []
    for depth in (0, 2):
        spec = make_optimizer(1e-3)
        state = make_train_state(cfg, spec, params=init_params(
            cfg, seed=0, device="cpu"), device="cpu")
        step = make_train_step(cfg, spec, device="cpu")
        src = make_batch_source(tsft.sft_epoch_batches(rows, 4),
                                place_fn=make_place_batch("cpu"),
                                depth=depth)
        losses = []
        for batch in src:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        src.close()
        runs.append(losses)
    assert len(runs[0]) == 3 and all(np.isfinite(runs[0]))
    assert all(loss > 0 for loss in runs[0])
    assert runs[0] == runs[1]
