"""The port's base-vs-tuned inference comparison
(``gke_ray_train_tpu_torch/inference.py``) against the JAX package's, at
tiny dims on the CPU: the same weights (JAX's, carried over as numpy),
the same byte tokenizer vocabulary and the same SQL rows give the same
answers, token for token, with and without adapters, and the same JSON
file. A ``mesh=`` runs (on a world-1 gloo mesh, the same answers); one
that is not a ``DeviceMesh`` raises a clear error. Meshes of several
ranks are in ``tests/test_torch_port_serve_mesh.py``.
"""

import json

import jax
import numpy as np
import pytest

from gke_ray_train_tpu import inference as jinf
from gke_ray_train_tpu.data import ByteTokenizer as JByteTokenizer
from gke_ray_train_tpu.data.sft import synthetic_sql_rows
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.train.lora import LoraConfig, init_lora
from gke_ray_train_tpu_torch import inference as tinf
from gke_ray_train_tpu_torch.data import ByteTokenizer
from gke_ray_train_tpu_torch.interop import lora_from_numpy, params_from_numpy
from gke_ray_train_tpu_torch.models import config as tcfg
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


V, SEQ = 260, 256


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=64, max_seq_len=SEQ)
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    jp = jtr.init_params(jc, jax.random.key(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    lcfg = LoraConfig(r=4, alpha=8)
    t = init_lora(jc, lcfg, jax.random.key(5))
    leaves, td = jax.tree.flatten(t)
    ks = jax.random.split(jax.random.key(6), len(leaves))
    jl = jax.tree.unflatten(td, [0.2 * jax.random.normal(k, x.shape, x.dtype)
                                 for k, x in zip(ks, leaves)])
    tl = lora_from_numpy(jax.tree.map(np.asarray, jl), tc, device="cpu")
    return jc, jp, jl, tc, tp, tl, lcfg.scale


PROMPTS = ["<|user|>\nSELECT the window\n<|assistant|>\n",
           "x" * 300]       # longer than SEQ - max_new: truncated loudly


@pytest.mark.parametrize("adapted", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("max_new", [8, 40])
@pytest.mark.parametrize("prompt", range(len(PROMPTS)))
def test_generate_answer_matches_jax(setup, adapted, max_new, prompt):
    jc, jp, jl, tc, tp, tl, scale = setup
    kw = dict(lora_scale=scale) if adapted else {}
    want = jinf.generate_answer(jp, jc, JByteTokenizer(), PROMPTS[prompt],
                                max_new_tokens=max_new,
                                lora=jl if adapted else None, **kw)
    got = tinf.generate_answer(tp, tc, ByteTokenizer(), PROMPTS[prompt],
                               max_new_tokens=max_new,
                               lora=tl if adapted else None, device="cpu",
                               **kw)
    assert got == want


def test_adapters_change_the_answer(setup):
    """The comparison is not vacuous: the adapted model answers
    otherwise, with a non-empty answer."""
    jc, jp, jl, tc, tp, tl, scale = setup
    tok = ByteTokenizer()
    base = tinf.generate_answer(tp, tc, tok, PROMPTS[0], max_new_tokens=40,
                                device="cpu")
    tuned = tinf.generate_answer(tp, tc, tok, PROMPTS[0], max_new_tokens=40,
                                 lora=tl, lora_scale=scale, device="cpu")
    assert tuned and tuned != base


def test_run_inference_comparison_matches_jax(setup, tmp_path):
    """The window-function filter, the record fields, the base and tuned
    answers and the written JSON equal JAX's."""
    jc, jp, jl, tc, tp, tl, scale = setup
    rows = synthetic_sql_rows(12, seed=1)

    def window(r):
        return r.get("sql_complexity") == "window functions"
    kw = dict(num_samples=3, max_new_tokens=24, row_filter=window,
              lora_scale=scale)
    want = jinf.run_inference_comparison(
        jp, jp, jc, JByteTokenizer(), rows, tuned_lora=jl,
        output_path=str(tmp_path / "jax" / "cmp.json"), **kw)
    got = tinf.run_inference_comparison(
        tp, tp, tc, ByteTokenizer(), rows, tuned_lora=tl,
        output_path=str(tmp_path / "port" / "cmp.json"), device="cpu", **kw)
    assert got == want and len(got) == 3
    with open(tmp_path / "jax" / "cmp.json") as f, \
            open(tmp_path / "port" / "cmp.json") as g:
        assert json.load(g) == json.load(f)
    # no host-0: the same records, nothing written
    again = tinf.run_inference_comparison(
        tp, tp, tc, ByteTokenizer(), rows, tuned_lora=tl, is_host0=False,
        output_path=str(tmp_path / "none" / "cmp.json"), device="cpu", **kw)
    assert again == got and not (tmp_path / "none").exists()


@pytest.mark.parametrize("fn", ["generate_answer", "run_inference_comparison"])
def test_mesh_raises_naming_the_roadmap(setup, fn):
    """``mesh=`` now runs: on a world-1 gloo mesh the same answers as
    without one; a ``mesh=`` that is not a ``DeviceMesh`` raises,
    naming what it takes."""
    import socket

    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    jc, jp, jl, tc, tp, tl, scale = setup
    rows = synthetic_sql_rows(6, seed=2)
    args = {"generate_answer": (tp, tc, ByteTokenizer(), PROMPTS[0]),
            "run_inference_comparison": (tp, tp, tc, ByteTokenizer(), rows)}
    kw = dict(max_new_tokens=8, device="cpu")
    if fn == "run_inference_comparison":
        kw.update(num_samples=1, tuned_lora=tl, lora_scale=scale)
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(tinf, fn)(*args[fn], mesh=object(), **kw)
    want = getattr(tinf, fn)(*args[fn], **kw)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshConfig(fsdp=1), device_type="cpu")
        got = getattr(tinf, fn)(*args[fn], mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
    assert got == want and want


def test_clear_generate_cache_drops_nothing():
    assert tinf.clear_generate_cache() == 0
