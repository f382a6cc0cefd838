"""The port's mesh arithmetic, sharding table, input partition and the
mesh keys of the config, held against the JAX package on the CPU in
this process (the collectives themselves run in
``tests/test_torch_port_multirank.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gke_ray_train_tpu.data import sft as jsft
from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.models import transformer as jtr
from gke_ray_train_tpu.parallel import mesh as jmesh
from gke_ray_train_tpu.parallel import placement as jplace
from gke_ray_train_tpu_torch import config as tconfig
from gke_ray_train_tpu_torch.analysis import guards as tguards
from gke_ray_train_tpu_torch.data import sft as tsft
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.models import init_params
from gke_ray_train_tpu_torch.parallel import mesh as tmesh
from gke_ray_train_tpu_torch.parallel import placement as tplace
from gke_ray_train_tpu_torch.parallel import sharding as tshard
from gke_ray_train_tpu_torch.train import (
    make_optimizer, make_train_state, make_train_step)
from tests import _torch_multirank as mr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


RESOLVE_CASES = [
    (dict(), 8), (dict(data=2), 8), (dict(data=2, fsdp=2, model=2), 8),
    (dict(fsdp=4, model=-1), 8), (dict(data=-1, fsdp=2), 6),
    (dict(fsdp=1), 1), (dict(data=3), 8),              # not divisible
    (dict(data=-1, fsdp=-1), 8),                       # two fills
    (dict(data=0), 4), (dict(fsdp=2), 8),              # < 1; too few
    (dict(data=2, fsdp=2, pipe=2, context=1), 8),
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw,n", RESOLVE_CASES)
def test_mesh_config_resolve_matches_jax(kw, n):
    """The same sizes, or the same error text, for every case."""
    got = _outcome(lambda: tmesh.MeshConfig(**kw).resolve(n).shape)
    want = _outcome(lambda: jmesh.MeshConfig(**kw).resolve(n).shape)
    assert got == want


@pytest.mark.parametrize("cfg", [
    {}, {"MESH_DATA": 2, "MESH_FSDP": -1}, {"MESH_FSDP": "4"},
    {"MESH_MODEL": 2, "MESH_CONTEXT": 2, "MESH_PIPE": 2, "NUM_SLICES": 2},
    {"MESH_DATA": 1, "MESH_FSDP": -1, "MESH_MODEL": 1, "MESH_CONTEXT": 1,
     "NUM_SLICES": 1}])
def test_mesh_config_from_dict_matches_jax(cfg):
    got = dataclasses.asdict(tmesh.MeshConfig.from_dict(cfg))
    assert got == dataclasses.asdict(jmesh.MeshConfig.from_dict(cfg))
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES


@pytest.mark.parametrize("kw,match", [
    (dict(model=2), None),
    (dict(context=2), None),
    (dict(pipe=2, model=2), None),
    (dict(num_slices=2), r"data axis \(1\) must be divisible by "
                         r"num_slices \(2\)")])
def test_axes_not_ported_raise_naming_their_item(kw, match):
    """Every layout is ported: ``model``, for an MoE model too (expert
    parallelism: Mixtral's experts over ``model`` pass where the mesh
    meets the model config), ``context``, ``pipe`` over ``model``
    (``match`` None: the checks pass) and slices, where a ``data`` axis
    that ``num_slices`` does not divide raises ``ValueError`` in the
    words of JAX's ``build_mesh`` on the same layout, and one that it
    divides passes."""
    mc = tmesh.MeshConfig(**{"fsdp": 1, **kw})
    if match is None:
        assert mc.check_ported() is mc
        tshard.check_model_on_mesh(tcfg.mixtral_8x7b(), mc.model)
        return
    with pytest.raises(ValueError, match=match) as got:
        mc.check_ported()
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(jmesh.MeshConfig(**{"fsdp": 1, **kw}),
                         jax.devices()[:1])
    assert str(got.value) == str(want.value)
    sliced = tmesh.MeshConfig(**{"fsdp": 1, **kw, "data": 2})
    assert sliced.check_ported() is sliced
    assert tmesh.MeshConfig(data=2, fsdp=4).check_ported().shape == \
        (2, 4, 1, 1, 1)
    assert tmesh.MeshConfig(fsdp=2, model=2).check_ported().shape == \
        (1, 2, 2, 1, 1)


def test_mesh_keys_of_the_config(monkeypatch):
    """One process ignores the mesh keys (they warn); a world reads them
    (``MESH_MODEL`` too) through the entries' ``maybe_replan``, and the
    axes not ported raise there."""
    from gke_ray_train_tpu_torch.rayint.elastic import POOL_ENV, maybe_replan
    monkeypatch.delenv(POOL_ENV, raising=False)

    def mesh_of(config, world):
        mc, pdb = maybe_replan(tmesh.MeshConfig.from_dict(config), 2,
                               world=world, config=config)
        assert pdb == 2
        return mc.check_ported()
    job = {"MESH_DATA": 1, "MESH_FSDP": -1, "MESH_MODEL": 1,
           "NUM_SLICES": 1, "TOPOLOGY": "v5e-16"}
    assert mesh_of(job, 1).shape == (1, 1, 1, 1, 1)
    assert mesh_of(job, 4).shape == (1, 4, 1, 1, 1)
    assert mesh_of(dict(job, MESH_DATA=2), 4).shape == (2, 2, 1, 1, 1)
    assert tconfig.tpu_only_keys(job) == sorted(job)
    assert tconfig.tpu_only_keys(job, world=4) == ["TOPOLOGY"]
    assert mesh_of(dict(job, MESH_MODEL=2), 4).shape == (1, 2, 2, 1, 1)
    # slices split data: refused where they do not divide it, in JAX's
    # build_mesh words
    with pytest.raises(ValueError, match=r"data axis \(1\) must be "
                       r"divisible by num_slices \(2\)"):
        mesh_of(dict(job, NUM_SLICES=2), 4)
    sliced = mesh_of(dict(job, MESH_DATA=2, NUM_SLICES=2), 4)
    assert (sliced.shape, sliced.num_slices) == ((2, 2, 1, 1, 1), 2)


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("group_by_length", [False, True])
def test_ranks_rows_union_is_jax_global_batch(n_ranks, group_by_length):
    """Every rank feeds ``sft_epoch_batches(num_hosts=N, host_id=r)``;
    per step the union of the ranks' rows is JAX's global batch, the
    tail batch's zero-weight padding included."""
    r = np.random.default_rng(5)
    n, S, gb = 37, 16, 8
    rows = {"inputs": r.integers(1, 50, (n, S)).astype(np.int32),
            "targets": r.integers(1, 50, (n, S)).astype(np.int32),
            "loss_weights": r.random((n, S)).astype(np.float32)}
    for i, k in enumerate(r.integers(2, S, n)):
        rows["inputs"][i, k:] = 0
    want = list(jsft.sft_epoch_batches(rows, gb, epoch=1,
                                       group_by_length=group_by_length))
    ranks = [list(tsft.sft_epoch_batches(
        rows, gb, num_hosts=n_ranks, host_id=h, epoch=1,
        group_by_length=group_by_length)) for h in range(n_ranks)]
    assert all(len(rk) == len(want) for rk in ranks)
    for s, batch in enumerate(want):
        def key(b, i):
            return b["inputs"][i].tobytes() + b["loss_weights"][i].tobytes()
        got = sorted(key(rk[s], i) for rk in ranks
                     for i in range(len(rk[s]["inputs"])))
        assert got == sorted(key(batch, i)
                             for i in range(len(batch["inputs"])))
        assert all(len(rk[s]["inputs"]) == gb // n_ranks for rk in ranks)


def test_host_batch_size_and_layout_match_jax():
    assert tplace.host_batch_size(16, num_shards=4) == \
        jplace.host_batch_size(16, num_shards=4) == 4
    with pytest.raises(TypeError, match="num_shards"):
        tplace.host_batch_size(16)
    with pytest.raises(TypeError, match="num_shards= or mesh="):
        jplace.host_batch_size(16)
    with pytest.raises(ValueError) as t:
        tplace.host_batch_size(10, num_shards=4)
    with pytest.raises(ValueError) as j:
        jplace.host_batch_size(10, num_shards=4)
    assert str(t.value) == str(j.value)
    assert tplace.input_shard_layout(None) == (1, 0)
    rows = {"inputs": np.arange(6, dtype=np.int32).reshape(2, 3)}
    placed = tplace.place_batch(rows, "cpu")
    assert torch.equal(placed["inputs"], torch.from_numpy(rows["inputs"]))


@pytest.mark.parametrize("family", ["llama3_8b", "gemma2_9b", "qwen2_7b",
                                    "mixtral_8x7b"])
def test_param_specs_are_jax_param_specs(family):
    """The port's table is JAX's ``param_specs`` without the stacked
    repeat dim (``pipe``), leaf for leaf."""
    jc = getattr(jcfg, family)()
    tc = getattr(tcfg, family)()
    want = jtr.param_specs(jc)
    got = tshard.param_specs(tc)
    flat = {k: tuple(v) for k, v in want.items() if k != "blocks"}
    for blk in want["blocks"]:
        for k, v in blk.items():
            assert v[0] == "pipe"
            flat[k] = tuple(v)[1:]
    assert got == flat


def test_shard_dims_follow_the_spec_where_they_divide():
    tc = tcfg.tiny(vocab_size=256, d_model=128, d_ff=256)
    assert tshard.shard_dim(tc, "blocks.0.wq", torch.Size((128, 128)), 2) == 0
    assert tshard.shard_dim(tc, "blocks.0.wo", torch.Size((128, 128)), 2) == 1
    assert tshard.shard_dim(tc, "blocks.1.w_down.codes",
                            torch.Size((256, 64)), 2) == 1
    assert tshard.shard_dim(tc, "blocks.1.w_down.scales",
                            torch.Size((8, 128)), 2) == 1
    assert tshard.shard_dim(tc, "embed", torch.Size((256, 128)), 2) == 1
    assert tshard.shard_dim(tc, "lm_head", torch.Size((128, 256)), 2) == 0
    # replicated in JAX, dim 0 under FSDP2; a dim that does not divide
    assert tshard.shard_dim(tc, "blocks.0.attn_norm",
                            torch.Size((128,)), 2) == 0
    assert tshard.shard_dim(tc, "blocks.0.wo", torch.Size((128, 129)), 2) == 0


def test_distributed_init_without_a_world_or_a_card(monkeypatch):
    """No WORLD_SIZE and the CPU asked for: no group, the CPU device;
    the card asked for without one: refused, never the CPU."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.distributed_init("cpu") == torch.device("cpu")
    assert not tmesh.is_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.distributed_init()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh()


def test_step_identity_names_what_would_make_ranks_diverge():
    """The guard's text holds the step's settings, each tensor's name,
    shape, dtype and placement, the batch and the kernel sources; a
    different plan or batch gives a different text, the same ones the
    same."""
    tc = tcfg.tiny(vocab_size=256)
    model = init_params(tc, seed=0, device="cpu")
    spec = make_optimizer(1e-3)
    state = make_train_state(tc, spec, params=model, device="cpu")
    batch = {"inputs": torch.zeros((2, 8), dtype=torch.int32)}

    def text(**kw):
        fn = make_train_step(tc, spec, device="cpu", **kw)
        return tguards.step_identity_text(fn, state, batch)
    a = text(grad_accum=2)
    assert a == text(grad_accum=2) and a != text(grad_accum=1)
    assert "param blocks.0.wq (64, 64) float32 local" in a
    assert "batch inputs (2, 8) int32" in a
    assert "kernels " + tguards.kernel_sources_digest() in a
    assert a != tguards.step_identity_text(
        make_train_step(tc, spec, device="cpu", grad_accum=2), state,
        {"inputs": torch.zeros((4, 8), dtype=torch.int32)})
