"""Pipe x model: tensor and expert parallelism inside each pipeline stage,
a 4-rank gloo world of the port on the CPU (``tests/_torch_pp.py``,
scenario ``pptp4``: pipe 2 x model 2) held against the one-process port
within 1e-6 and against the JAX package's pipelined mesh of the same
shape on the conftest's fake devices within 1e-5.

The tiny models of ``tests/test_torch_port_pipe.py`` (a Llama of 4
layers, a Gemma-2 with a tied embedding, a Mixtral-style MoE of 2 layers
and 4 experts; fp32, dense attention, S 32) and its batches: 3 steps of 8
rows as grad-accum 2 x pipe microbatches 2. A rank holds its stage's
layers and, within them, its half of the heads, ffn columns and vocab
(a Mixtral's 2 of 4 experts); its logits are its vocab shard. Checked:
the Llama's forward logits and 3 QLoRA and 3 full fine-tuning steps
(losses, grad_norms, trained tensors) against one process, the full
fine-tuning steps also against JAX's pipelined steps; the Gemma-2's forward and 3 full fine-tuning steps
(its tied embedding summed over pipe, on each model rank's vocab shard);
the Mixtral's forward against JAX's mesh, its router aux JAX's pipelined
aux, and the layers and experts each rank holds; a checkpoint across
pipe 2 x model 2 and world 1 both ways, bitwise; the sharded export
converted against the one-process export, file for file; the sharded
quantized init bitwise the stage's and the shard's part of one
process's; LoRA dropout refused in JAX's words.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from gke_ray_train_tpu_torch import interop
from gke_ray_train_tpu_torch.ckpt import CheckpointManager, save_hf_checkpoint
from gke_ray_train_tpu_torch.ckpt.convert import convert
from gke_ray_train_tpu_torch.models import config as tcfg
from tests import _torch_multirank as mr
from tests import _torch_pp as pp
from tests.test_torch_port_pipe import (
    GROUP, JAX_TOL, LLAMA, MOE, PORT_TOL, STEPS, _batch, _case, _close,
    _hold, _jax_forward, _jax_mesh, _jax_train, _merged, _np)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


MESH = dict(model=2, pipe=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pptp"))
    batches = [_batch(100 + i) for i in range(STEPS)]
    fwd = _batch(7, n=4)
    inputs = {"group": GROUP, "fwd": fwd,
              "llama_qlora": _case("llama", True, batches),
              "llama_full": _case("llama", False, batches),
              "gemma_full": _case("gemma", False, batches),
              "moe_full": _case("moe", False, batches)}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    # the world-1 save the stages restore
    state = pp.build_state(inputs["llama_full"])[0]
    mgr = CheckpointManager(os.path.join(out, "ckpt_w1"),
                            score_attribute=None)
    mgr.save(state.step, state, force=True)
    mgr.close()
    one = {"full_state": mr.full_state(state)}
    procs = pp.start("pptp4", out, n=4)
    # one process of the port while the ranks run: the same rows as
    # accum x M microbatches
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for name in ("llama_qlora", "llama_full", "gemma_full"):
            one[name] = pp.train(inputs[name], None)
        for name, case in (("llama", "llama_full"), ("gemma", "gemma_full"),
                           ("moe", "moe_full")):
            one[f"fwd_{name}"] = pp.forward(inputs[case], None,
                                            fwd["inputs"])
    finally:
        torch.set_num_threads(threads)
    # JAX's pipelined mesh of the same shape
    mesh = _jax_mesh(**MESH)
    jx = {name: _jax_forward(name, fwd["inputs"], mesh)
          for name in ("llama", "gemma", "moe")}
    jx["llama_full"] = _jax_train("llama", False, batches, mesh)
    # the one-process export of the QLoRA start
    st, _, qc, lcfg = pp.build_state(inputs["llama_qlora"])
    save_hf_checkpoint(st.params, qc, os.path.join(out, "hf_w1"),
                       lora=st.lora, lora_scale=lcfg.scale)
    mr.wait(procs, timeout=300)
    ranks = [torch.load(os.path.join(out, f"pptp4_{r}.pt"),
                        weights_only=False) for r in range(4)]
    return dict(out=out, inputs=inputs, one=one, jax=jx, ranks=ranks)


def _whole_logits(ranks, key):
    """Each pipe rank's logits over the whole vocab: its model group's
    shards in model-rank order (every stage holds the same)."""
    by = {}
    for r in ranks:
        by.setdefault(r["ranks"]["pipe"], {})[r["ranks"]["model"]] = \
            key(r)["logits"]
    return [torch.cat([shards[m] for m in sorted(shards)], dim=-1).numpy()
            for _, shards in sorted(by.items())]


@pytest.mark.parametrize("family", ["llama", "gemma", "moe"])
def test_forward_matches_one_process_and_jax_mesh(world, family):
    """The pipelined forward at pipe 2 x model 2 (each model rank's vocab
    shard of the logits, the same on both stages) against one process
    and JAX's pipelined mesh of the same shape; a rank holds half the
    vocab."""
    key = {"llama": lambda r: r["forward"],
           "gemma": lambda r: r["gemma"]["forward"],
           "moe": lambda r: r["moe"]["forward"]}[family]
    for r in world["ranks"]:
        assert key(r)["logits"].shape[-1] == LLAMA["vocab_size"] // 2
    for got in _whole_logits(world["ranks"], key):
        _close(got, world["one"][f"fwd_{family}"]["logits"].numpy(),
               PORT_TOL, "one process")
        _close(got, world["jax"][family]["logits"], JAX_TOL, "jax mesh")


@pytest.mark.parametrize("case", ["llama_qlora", "llama_full"])
def test_three_steps_match_one_process(world, case):
    """3 QLoRA or full fine-tuning steps: every rank's losses and
    grad_norms and its trained tensors (its stage's layers, whole over
    model, and the root) against one process within 1e-6; the stages'
    tensors together are the whole model's."""
    ranks = [r[case] for r in world["ranks"]]
    for r in ranks:
        _hold(r, world["one"][case])
    assert set(_merged(ranks)) == set(world["one"][case]["trained"])


def test_full_ft_steps_match_jax_pipelined_steps(world):
    """The full fine-tuning steps against JAX's pipelined step on its pipe
    2 x model 2 mesh within 1e-5: every rank's streams and the stages'
    trained tensors. (The QLoRA steps are held against one process
    above, whose pipe-2 steps ``tests/test_torch_port_pipe.py`` holds
    against JAX's.)"""
    ranks = [r["llama_full"] for r in world["ranks"]]
    jstate, streams = world["jax"]["llama_full"]
    for r in ranks:
        for k in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(r["streams"][k], streams[k],
                                       rtol=JAX_TOL, atol=1e-9, err_msg=k)
    want = interop.params_from_numpy(_np(jstate.params), tcfg.tiny(**LLAMA),
                                     device="cpu").state_dict()
    assert set(_merged(ranks)) == set(want)
    for name, t in _merged(ranks).items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=JAX_TOL, err_msg=name)


def test_gemma2_tied_embedding_sums_over_pipe_on_a_vocab_shard(world):
    """Gemma-2 (softcaps, post-norms, sliding / global, a tied embedding
    sharded on the vocab over model): 3 full fine-tuning steps against
    one process; the tied embedding the first stage's lookup's gradient
    plus the last stage's head's, the same on both stages."""
    ranks = world["ranks"]
    for r in ranks:
        _hold(r["gemma"]["train"], world["one"]["gemma_full"])
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["ranks"]["model"], []).append(
            r["gemma"]["train"]["trained"]["embed"])
    for shards in by_model.values():
        assert torch.equal(shards[0], shards[1])


def test_moe_stage_holds_its_layers_and_half_the_experts(world):
    """A tiny Mixtral at pipe 2 x model 2: each rank holds its stage's
    one layer and 2 of its 4 experts; the router aux equals JAX's
    pipelined aux on every rank."""
    want_aux = world["jax"]["moe"]["aux"]
    for r in world["ranks"]:
        p = r["ranks"]["pipe"]
        assert r["moe"]["forward"]["layers"] == [p]
        assert r["moe"]["experts"] == {p: MOE["n_experts"] // 2}
        assert abs(r["moe"]["forward"]["aux"] - want_aux) <= \
            JAX_TOL * abs(want_aux)


def test_each_rank_holds_its_stage_and_model_shard(world):
    """Pipe rank p holds layers 2p and 2p + 1 of the Llama, and the
    quantized init's local codes of a column-parallel projection are its
    half of the output columns."""
    d_ff = LLAMA["d_ff"]
    for r in world["ranks"]:
        p = r["ranks"]["pipe"]
        assert r["forward"]["layers"] == [2 * p, 2 * p + 1]
        codes = r["qinit_local"][f"blocks.{2 * p}.w_up.codes"]
        assert codes.shape[-1] == d_ff // 2


def test_checkpoint_pipe_tp_restores_bitwise_at_world1(world):
    """The four ranks' save of the trained full-FT state (each its
    stage's layers, sharded over model), read into a one-process
    template, equals the ranks' state bitwise."""
    from gke_ray_train_tpu_torch.ckpt.manager import flat_state
    template = pp.build_state(world["inputs"]["llama_full"])[0]
    mgr = CheckpointManager(os.path.join(world["out"], "ckpt_pptp"),
                            score_attribute=None)
    mgr.restore_resharded(template)
    assert mgr.last_restore_resharded == (4, 1)
    mgr.close()
    saved = {}
    for r in world["ranks"]:
        saved.update(r["full_saved"])
    got = flat_state(template)
    assert set(got) == set(saved)
    for k, v in saved.items():
        if torch.is_tensor(v):
            assert torch.equal(mr._whole(got[k]), v), k
        else:
            assert got[k] == v, k


def test_world1_save_restores_bitwise_at_pipe_tp(world):
    """The one-process save restored into each rank: its stage's layers
    and the root, whole over model, equal one process's bitwise."""
    want = world["one"]["full_state"]
    keys = set()
    for r in world["ranks"]:
        assert r["resharded"] == (1, 4)
        got = r["full_restored"]
        assert "opt/count" in got
        for k, v in got.items():
            if torch.is_tensor(v):
                assert torch.equal(v, want[k]), k
            else:
                assert v == want[k], k
        keys |= set(got)
    assert keys == set(want)


def test_sharded_export_converts_to_the_one_process_export(world,
                                                            tmp_path):
    """The ranks' export of the merged QLoRA start (each layer's shards
    written by the ranks of its stage), converted, equals the
    one-process HF export file for file."""
    hf = str(tmp_path / "hf_pptp")
    convert(os.path.join(world["out"], "export_pptp"), hf, dtype="bfloat16")
    hf_w1 = os.path.join(world["out"], "hf_w1")
    names = sorted(os.listdir(hf_w1))
    assert names == sorted(os.listdir(hf)) and any(
        n.endswith(".safetensors") for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(hf_w1, n), os.path.join(hf, n),
                           shallow=False), n


def test_sharded_quantized_init_is_the_stage_and_shard_bitwise(world):
    """``init_quantized_params(mesh=)`` at pipe 2 x model 2: a rank makes
    its stage's blocks only; their tensors, whole over model, and its
    local part of each block's, equal one process's (and its chunk on
    the ``model`` dim) bitwise."""
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.parallel.sharding import _model_dim
    cfg = tcfg.tiny(**LLAMA)
    one = init_quantized_params(cfg, seed=5, group=GROUP, device="cpu")
    want = {**dict(one.named_parameters()), **dict(one.named_buffers())}
    for r in world["ranks"]:
        p, m = r["ranks"]["pipe"], r["ranks"]["model"]
        got = r["qinit"]
        blocks = {int(k.split(".")[1]) for k in got if k.startswith("blocks.")}
        assert blocks == {2 * p, 2 * p + 1}
        for k, t in got.items():
            w = want[k]
            if k.endswith(".codes"):
                w = w.view(torch.int8) if w.dtype != torch.int8 else w
            assert torch.equal(t, w), k
            if k.startswith("blocks."):
                # the root is left whole for make_train_state to shard
                d = _model_dim(cfg, k)
                part = w if d is None else w.chunk(2, dim=d)[m]
                assert torch.equal(r["qinit_local"][k], part), k


def test_lora_dropout_raises_in_jax_words(world):
    for r in world["ranks"]:
        assert r["dropout"] and ("LoRA dropout is not supported on a "
                                 "pipelined mesh") in r["dropout"]
