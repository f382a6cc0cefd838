"""``QUANT_STORE=uint4`` in the port (``ops/quant.py``: two NF4 codes a
byte) against the JAX package's uint4 store, on the CPU.

JAX caches its store choice on first use (``ops/quant.py::
_nf4_store_dtype``), so these tests set its cached probe with
``monkeypatch``, which restores it afterwards; the port reads
``QUANT_STORE`` at each quantization. Codes, scales and dequantized
weights are compared bitwise (the same fp32 arithmetic); logits within
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.ops import quant as jquant
from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import transformer as ttr
from gke_ray_train_tpu_torch.models.qinit import init_quantized_params
from gke_ray_train_tpu_torch.ops import quant as tquant
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


SHAPES = {"matrix": (128, 64), "bank": (4, 128, 64)}


@pytest.fixture
def uint4(monkeypatch):
    monkeypatch.setattr(jquant, "_U4_PROBED", jnp.uint4)
    monkeypatch.setenv("QUANT_STORE", "uint4")


def _w(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.05).astype(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_codes_and_dequantize_equal_jax_uint4(uint4, shape):
    w = _w(SHAPES[shape])
    jq = jquant.quantize_tensor(jnp.asarray(w), "nf4")
    assert jq.codes.dtype == jnp.uint4
    q = tquant.quantize_tensor(torch.from_numpy(w), "nf4")
    assert q.store == "uint4" and q.codes.dtype == torch.uint8
    assert tuple(q.shape) == SHAPES[shape]
    assert q.codes.shape == SHAPES[shape][:-1] + (SHAPES[shape][-1] // 2,)
    np.testing.assert_array_equal(
        q.unpacked_codes().numpy(), np.asarray(jq.codes).astype(np.uint8))
    np.testing.assert_array_equal(q.scales.numpy(), np.asarray(jq.scales))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize(jq, jdt).astype(jnp.float32))
        got = tquant.dequantize(q, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_uint4_stores_half_the_bytes_of_the_same_codes(monkeypatch):
    w = torch.from_numpy(_w(SHAPES["bank"], seed=1))
    monkeypatch.setenv("QUANT_STORE", "int8")
    q8 = tquant.quantize_tensor(w, "nf4")
    monkeypatch.setenv("QUANT_STORE", "uint4")
    q4 = tquant.quantize_tensor(w, "nf4")
    assert (q8.store, q4.store) == ("int8", "uint4")
    nbytes = [q.codes.numel() * q.codes.element_size() for q in (q8, q4)]
    assert nbytes[1] * 2 == nbytes[0]
    assert torch.equal(q4.unpacked_codes().to(torch.int8), q8.codes)
    assert torch.equal(q4.scales, q8.scales)
    assert torch.equal(tquant.dequantize(q4, torch.float32),
                       tquant.dequantize(q8, torch.float32))
    # one expert of the bank: views of the packed codes
    one = q4.select(2)
    assert tuple(one.shape) == SHAPES["bank"][1:] and one.store == "uint4"
    assert torch.equal(tquant.dequantize(one, torch.float32),
                       tquant.dequantize(q8, torch.float32)[2])


def test_int8_kind_ignores_the_store_and_unknown_stores_raise(monkeypatch):
    """JAX's rule: QUANT_STORE picks the storage of NF4 codes only."""
    monkeypatch.setattr(jquant, "_U4_PROBED", jnp.uint4)
    monkeypatch.setenv("QUANT_STORE", "uint4")
    w = _w(SHAPES["matrix"], seed=2)
    jq = jquant.quantize_tensor(jnp.asarray(w), "int8")
    q = tquant.quantize_tensor(torch.from_numpy(w), "int8")
    assert q.store == "int8" and q.codes.dtype == torch.int8
    assert jq.codes.dtype == jnp.int8
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
    monkeypatch.setenv("QUANT_STORE", "int4")
    with pytest.raises(ValueError, match="QUANT_STORE"):
        tquant.quantize_tensor(torch.from_numpy(w), "nf4")
    with pytest.raises(ValueError, match="store"):
        tquant.QTensor(torch.zeros(4, 2, dtype=torch.uint8), torch.ones(1, 4),
                       "int8", 4, store="uint4")


def test_pack_unpack_round_trip():
    codes = torch.from_numpy(np.random.default_rng(3).integers(
        0, 16, (3, 8, 10)).astype(np.uint8))
    packed = tquant.pack_uint4(codes)
    assert packed.shape == (3, 8, 5)
    assert torch.equal(packed[..., 0], codes[..., 0] | (codes[..., 1] << 4))
    assert torch.equal(tquant.unpack_uint4(packed), codes)
    with pytest.raises(ValueError, match="even"):
        tquant.pack_uint4(codes[..., :3])


@pytest.mark.parametrize("moe", [False, True])
def test_qparams_from_numpy_carries_uint4_trees(uint4, moe):
    """A JAX tree quantized with uint4 codes (numpy sees ml_dtypes uint4)
    becomes the port's uint4 store with the same codes, and the same
    logits; dense and Mixtral-pattern (4-D expert banks)."""
    kw = dict(vocab_size=97, n_layers=2, d_model=64, d_ff=128,
              max_seq_len=64)
    if moe:
        kw.update(n_experts=4, expert_top_k=2, name="mixtral-tiny")
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    jp = jquant.quantize_params(jtr.init_params(jc, jax.random.key(0)),
                                kind="nf4")
    tree = jax.tree.map(np.asarray, jp)
    tp = interop.qparams_from_numpy(tree, tc, device="cpu")
    for name in ("wq", "w_gate", "w_down"):
        q, jq = getattr(tp.blocks[1], name), tree["blocks"][0][name]
        assert q.store == "uint4" and tuple(q.shape) == jq.codes.shape[1:]
        np.testing.assert_array_equal(q.unpacked_codes().numpy(),
                                      jq.codes[1].astype(np.uint8))
    toks = np.random.default_rng(4).integers(0, 97, (2, 24)).astype(np.int32)
    want = np.asarray(jtr.forward(jp, jnp.asarray(toks), jc))
    with torch.no_grad():
        got = ttr.forward(tp, torch.from_numpy(toks), tc).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_uint4_and_int8_bases_give_the_same_logits(monkeypatch):
    """The quantized init from one seed under either store: the same
    codes, so the same logits, bitwise (chip_smoke's train_moe_parity
    holds whole loss streams so on the card)."""
    tc = tcfg.tiny(vocab_size=97, d_model=128, d_ff=256, n_experts=4,
                   expert_top_k=2, max_seq_len=64)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 97, (1, 32)).astype(np.int32))
    out = {}
    for store in ("int8", "uint4"):
        monkeypatch.setenv("QUANT_STORE", store)
        q = init_quantized_params(tc, seed=3, device="cpu")
        assert q.blocks[0].w_up.store == store
        with torch.no_grad():
            out[store] = ttr.forward(q, toks, tc)
    assert torch.equal(out["int8"], out["uint4"])
