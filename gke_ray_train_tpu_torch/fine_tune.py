"""The LLM fine-tune entry on one GPU or one rank per GPU (counterpart
of ``ray-jobs/fine_tune_llama_ray.py``: ``train_loop_per_worker`` and
its ``__main__``).

    FINE_TUNE_CONFIG=ray-jobs/fine_tune_config_offline_8b.json \\
        python -m gke_ray_train_tpu_torch.fine_tune
    torchrun --nproc-per-node N -m gke_ray_train_tpu_torch.fine_tune \\
        ray-jobs/fine_tune_config.json

``main`` reads the flat UPPER_CASE config named by ``FINE_TUNE_CONFIG``
(default ``ray-jobs/fine_tune_config.json``), runs
``train_loop_per_worker(config)`` through
``rayint/trainer.py::TorchTrainer.fit()`` (one in-process worker, a rank
of torchrun's world each; ``MAX_FAILURES``, ``MAX_PREEMPTIONS``,
``WORKER_TIMEOUT_S`` and ``HEARTBEAT_TIMEOUT_S`` set its budgets and
watchdogs, as in the JAX entry), and prints one JSON line, ``{"metric":
"flagship_final", ...}``, as the last line of stdout; it exits 1 on an
error ``Result``. The worker keeps the JAX
entry's names, config keys and order of steps: audit, plan and
tokenizer; the model config; the weights (``PRETRAINED_CHECKPOINT_DIR``
streamed and quantized on load, else random weights from seed 0 with a
loud warning); the dataset (synthetic SQL rows when the hub is
unreachable); rows, optimizer and schedule, state, step, eval step and
checkpoint manager; ``run_training``; then the export of a HF-layout
model (LoRA merged one projection at a time on the card) with the
tokenizer beside it; with ``INFERENCE`` the base and tuned models'
answers to the test rows (``inference_comparison.json``), and with
``SERVE_AFTER_TRAIN`` the tuned model served through the continuous-
batching engine, a LoRA run's adapter through an ``AdapterPool``
(``serve_smoke.json``).

Under a ``torch.distributed`` world above one (torchrun or Ray Train's
rendezvous env; ``parallel/mesh.py::distributed_init``: NCCL, one rank
per card, gloo only with ``device="cpu"``) the worker builds the mesh
from ``MESH_DATA`` / ``MESH_FSDP`` / ``MESH_MODEL`` / ``MESH_CONTEXT``
(a model that cannot tile ``model``, or a length or ``ATTN_IMPL`` that
cannot run sharded over ``context``, raises before any weight is built),
shards the model over ``model`` (tensor parallelism) and with FSDP2
(replicated over ``context``), feeds each batch rank its share of every
global batch (``PER_DEVICE_TRAIN_BATCH_SIZE × data × fsdp ×
GRADIENT_ACCUMULATION_STEPS`` rows; the ``model`` peers of a batch rank
feed the same rows, and its ``context`` peers each their ``S / C``
tokens of them, for the train steps and the eval alike), meters tokens/s
and MFU per card over the world, and exports through the checkpoint
manager (``<final dir>_dcp``, with the ``model_config.json`` sidecar and
the tokenizer from rank 0) for ``ckpt/convert.py`` to turn into the HF
layout. On one card the mesh keys are ignored (they warn), and
``ATTN_IMPL`` ``a2a`` / ``ring`` runs the flash kernels. ``INFERENCE``
and ``SERVE_AFTER_TRAIN`` run on the sharded model, every rank entering
the generate and the engine, rank 0 writing the files (a full
fine-tune's base is read back through :func:`load_pretrained`, sharded
as at the start); ``SERVE_AFTER_TRAIN`` warns and skips on more than
one node, as JAX's does. An MoE model at ``MESH_MODEL`` above 1 shards
its experts over ``model`` (expert parallelism, ``ops/moe.py``). At
``MESH_PIPE`` above 1 each rank holds its stage's layers and the train
step runs the pipeline (``models/pipeline.py``; ``PIPE_MICROBATCHES``
pipe microbatches in each grad-accum microbatch, ``PIPE_VIRTUAL_STAGES``
groups a stage, as JAX's job reads them), at any ``MESH_MODEL`` inside
a stage; the export is written by the ranks that hold each layer, and
``INFERENCE`` and ``SERVE_AFTER_TRAIN`` decode across the stages
(``models/kvcache.py``). ``OVERLAP`` (every shipped config sets
``xla``) is the plan's: ``xla`` registers FSDP2's explicit prefetch,
``manual`` trains through the hand-placed gathers of
``train/overlap.py`` and raises, before any weight is built, on a
``model`` / ``context`` / ``pipe`` axis above 1 (``PlanError``, the JAX
plan's words), without a mesh, under LoRA or on an MoE model.
``NUM_SLICES`` splits ``data`` into slices (``parallel/mesh.py``; the
plan's value, config over env), and ``DCN_SYNC`` / ``DCN_COMPRESS``
pick how ``manual``'s gradients cross them (``parallel/hierarchical.py``);
after an elastic shrink to one slice a ``hier`` plan runs ``flat``.
Peer replication is not ported (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys

import numpy as np

from gke_ray_train_tpu_torch.ckpt import (
    CheckpointManager, load_hf_checkpoint, save_hf_checkpoint)
from gke_ray_train_tpu_torch.ckpt.convert import (
    TOKENIZER_SUBDIR, save_export, write_sidecar)
from gke_ray_train_tpu_torch.config import (
    audit_config, cadence_from_config, checkpoint_knobs_from_config,
    optimizer_from_config, quant_kind_from_config, schedule_from_config)
from gke_ray_train_tpu_torch.data import (
    ByteTokenizer, downsample, format_gretel_sql_example, load_hf_tokenizer,
    make_place_batch, pack_examples, pad_sft_rows, save_tokenizer,
    sft_epoch_batches, synthetic_sql_rows, tokenize_sft_example)
from gke_ray_train_tpu_torch.data.sft import render_chat
from gke_ray_train_tpu_torch.device import DeviceLike, world_size
from gke_ray_train_tpu_torch.inference import run_inference_comparison
from gke_ray_train_tpu_torch.models import (
    init_params, init_quantized_params, preset_for_model_id, tiny)
from gke_ray_train_tpu_torch.parallel.mesh import (
    MeshConfig, build_mesh, distributed_init)
from gke_ray_train_tpu_torch.parallel.placement import (
    host_batch_size, input_shard_layout)
from gke_ray_train_tpu_torch.parallel.sharding import (
    check_model_on_mesh, shard_model, shard_unit)
from gke_ray_train_tpu_torch.plan import (
    ExecutionPlan, PlanError, context_findings, model_findings)
from gke_ray_train_tpu_torch.rayint import get_context
from gke_ray_train_tpu_torch.rayint.elastic import maybe_replan
from gke_ray_train_tpu_torch.train.overlap import check_manual_support
from gke_ray_train_tpu_torch.serve import post_train_smoke
from gke_ray_train_tpu_torch.train import (
    LoraConfig, ThroughputMeter, make_eval_step, make_train_state,
    make_train_step, sharded_eval_loss)
from gke_ray_train_tpu_torch.train.loop import run_training
from gke_ray_train_tpu_torch.train.profiling import (
    apply_debug_flags, profiler_from_config)
from gke_ray_train_tpu_torch.train.tb import writer_from_config

logger = logging.getLogger("fine_tune")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(REPO, "ray-jobs", "fine_tune_config.json")


def _hub_offline() -> bool:
    return any(os.environ.get(k, "").strip().lower() not in ("", "0", "false")
               for k in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"))


def _sql_datasets(config: dict, n_train: int, n_eval: int):
    """(train rows, test rows): the hub dataset, or synthetic gretel-
    shaped SQL rows (train seed 0, test seed 1) when it is unreachable.
    With ``HF_HUB_OFFLINE`` / ``HF_DATASETS_OFFLINE`` set the hub is not
    tried, so no socket opens."""
    if not _hub_offline():
        try:
            from datasets import load_dataset
            return (list(load_dataset(config["DATASET_NAME"], split="train")),
                    list(load_dataset(config["DATASET_NAME"], split="test")))
        except Exception as e:  # noqa: BLE001 - any hub failure falls back
            logger.warning("dataset hub unavailable (%s); synthetic SQL "
                           "rows", type(e).__name__)
    else:
        logger.warning("hub offline; synthetic SQL rows")
    return (synthetic_sql_rows(max(n_train, 64), seed=0),
            synthetic_sql_rows(max(n_eval, 16), seed=1))


def load_pretrained(ckpt_dir: str, cfg, *, quantize=None,
                    device: DeviceLike = None, mesh=None):
    """The HF model in ``ckpt_dir``: on one card read onto it; on a
    ``mesh`` a full-precision model is read into host memory and placed
    one unit at a time (each block moved to the card and sharded, then
    the root's own tensors moved; ``shard_model`` shards the root), so
    no card holds the whole model. A quantized (QLoRA) base is read onto
    the card, quantized on load. On a pipelined mesh only this rank's
    stage's layers are read."""
    from gke_ray_train_tpu_torch.models.pipeline import mesh_stage
    stage = mesh_stage(cfg, mesh)
    if mesh is None or quantize is not None:
        return load_hf_checkpoint(ckpt_dir, cfg, quantize=quantize,
                                  device=device, layers=stage)
    params = load_hf_checkpoint(ckpt_dir, cfg, device="cpu", layers=stage)
    for blk in params.blocks:
        shard_unit(blk.to(device), cfg, mesh)
    for name in ("embed", "final_norm", "lm_head"):
        p = getattr(params, name)
        if p is not None:
            p.data = p.data.to(device)
    return params


def train_loop_per_worker(config: dict, *, device: DeviceLike = None):
    """The worker: trains, checkpoints and resumes, exports; returns the
    loop's last metrics. Runs on ``device`` (default ``cuda``, which must
    exist; ``cuda:LOCAL_RANK`` on a rank of a world), joining the
    process group the environment names (module doc)."""
    dev = distributed_init(device)
    world = world_size()
    ctx = get_context()
    if ctx.is_host0():
        audit_config(config, world=world)
    plan = ExecutionPlan.resolve(config)
    apply_debug_flags(config)
    # the mesh axes not ported yet raise here, before any work (whether
    # the model tiles `model` is checked once its config is known); after
    # an elastic pool change the declared mesh re-forms on the survivors,
    # the global batch kept (rayint/elastic.py)
    mesh_cfg = None
    if world > 1:
        # the slices are the plan's NUM_SLICES (config over env)
        mesh_cfg, per_device = maybe_replan(
            dataclasses.replace(MeshConfig.from_dict(config),
                                num_slices=plan.num_slices),
            plan.per_device_batch, world=world, config=config, log=logger)
        mesh_cfg.check_ported()
        # OVERLAP=manual on a model, context or pipe axis raises here,
        # in the JAX plan's words
        plan.check_mesh(mesh_cfg, world)
        # the survivors' slices (a DCN_SYNC=hier plan left on one slice
        # runs flat, with the plan's warning)
        plan = dataclasses.replace(plan, per_device_batch=per_device,
                                   num_slices=mesh_cfg.num_slices)
        # the attempt runs under the re-formed plan
        ctx.plan_fingerprint = plan.fingerprint()
    elif plan.num_slices != 1:
        # one process ignores the mesh keys (they warn)
        plan = dataclasses.replace(plan, num_slices=1)
    mesh = build_mesh(mesh_cfg, device_type=dev.type) if world > 1 else None
    pipe = mesh_cfg.pipe if mesh_cfg is not None else 1
    smoke = bool(config.get("SMOKE_TEST", False))
    logger.info("worker on %s (world %d%s); plan %s", dev, world,
                f", mesh {mesh_cfg.shape}" if mesh_cfg else "",
                plan.fingerprint())

    # ---- tokenizer + model config ------------------------------------
    model_id = config["MODEL_ID"]
    hf_token = os.environ.get("HF_TOKEN")
    try:
        tokenizer = load_hf_tokenizer(model_id, hf_token)
    except Exception as e:  # noqa: BLE001 - any failure falls back
        logger.warning("HF tokenizer unavailable (%s); using ByteTokenizer",
                       type(e).__name__)
        tokenizer = ByteTokenizer()

    max_seq = plan.max_seq_len
    use_lora = bool(config.get("USE_QLORA", False))
    # a frozen (Q)LoRA base keeps its unquantized leaves in the compute
    # dtype; full fine-tuning defaults to fp32 master params
    train_dtype = config.get("TRAIN_DTYPE", "bfloat16")
    param_dtype = config.get("PARAM_DTYPE",
                             train_dtype if use_lora else "float32")
    if smoke:
        cfg = tiny(vocab_size=max(getattr(tokenizer, "vocab_size", 260), 260),
                   max_seq_len=max_seq,
                   dtype=config.get("TRAIN_DTYPE", "float32"),
                   param_dtype=config.get("PARAM_DTYPE", "float32"),
                   attn_impl=config.get("ATTN_IMPL", "auto"),
                   # deep enough for the pipeline's stages
                   n_layers=max(2, pipe * plan.pipe_virtual_stages))
    else:
        cfg = preset_for_model_id(
            model_id, dtype=train_dtype, param_dtype=param_dtype,
            attn_impl=config.get("ATTN_IMPL", "auto"),
            remat_policy=config.get("REMAT_POLICY", "full"))
    if "PIPE_VIRTUAL_STAGES" in config:
        cfg = dataclasses.replace(cfg, pipe_virtual=plan.pipe_virtual_stages)
    if mesh_cfg is not None:
        # a model that cannot tile the model or pipe axis, or sequences
        # that cannot shard over the context axis, raise here, before any
        # weight is built
        check_model_on_mesh(cfg, mesh_cfg.model)
        found = model_findings(cfg, model=1, pipe=pipe,
                               virtual=cfg.pipe_virtual)
        if found:
            raise PlanError("; ".join(found))
        found = context_findings(cfg, context=mesh_cfg.context,
                                 max_seq_len=plan.max_seq_len)
        if found:
            raise PlanError("; ".join(found))
    if plan.overlap == "manual":
        # no mesh, LoRA or MoE: refused before any weight is built
        check_manual_support(cfg, mesh, lora=use_lora)

    # ---- weights ------------------------------------------------------
    # a local HF directory, else random weights (the hub download,
    # ckpt/hub.py, is not ported)
    ckpt_dir = config.get("PRETRAINED_CHECKPOINT_DIR")
    have_local = bool(ckpt_dir and os.path.exists(str(ckpt_dir)))
    quant_kind = quant_kind_from_config(config, use_lora)
    load_quant = quant_kind if (use_lora and quant_kind != "none") else None
    if have_local:
        # a QLoRA base quantizes during the stream, one projection (one
        # expert of a bank) on the card at a time
        params = load_pretrained(str(ckpt_dir), cfg, quantize=load_quant,
                                 device=dev, mesh=mesh)
        logger.info("loaded pretrained weights from %s%s", ckpt_dir,
                    f" (quantized {load_quant} on load)" if load_quant
                    else "")
    else:
        if not smoke:
            logger.warning(
                "no local checkpoint (PRETRAINED_CHECKPOINT_DIR) and no "
                "hub download in the port; initializing RANDOM weights "
                "(fine-tuning semantics require a pretrained checkpoint)")
        if load_quant is not None:
            # quantized as it is drawn: the full-precision base (93 GB
            # of bf16 at Mixtral-8x7B) never exists; on a mesh each
            # block is sharded as soon as it is made
            params = init_quantized_params(cfg, seed=0, kind=load_quant,
                                           device=dev, mesh=mesh)
        else:
            params = init_params(cfg, seed=0, device=dev, mesh=mesh)

    # ---- dataset ------------------------------------------------------
    n_train = int(config.get("NUM_TRAIN_SAMPLES", 1000))
    n_eval = int(config.get("NUM_EVAL_SAMPLES", 200))
    ds_train, ds_test = _sql_datasets(config, n_train, n_eval)
    ds_train = downsample(ds_train, n_train)
    ds_test = downsample(ds_test, n_eval)

    def tokenize_rows(rows):
        return [tokenize_sft_example(
            tokenizer, format_gretel_sql_example(r), max_len=max_seq + 1)
            for r in rows]

    train_exs = tokenize_rows(ds_train)
    eval_exs = tokenize_rows(ds_test)
    n_dead = sum(1 for ex in train_exs if ex["loss_weights"].sum() == 0)
    if n_dead:
        logger.warning(
            "%d/%d train examples have ZERO trainable tokens — the prompt "
            "fills MAX_SEQ_LENGTH=%d and truncation drops the completion; "
            "raise MAX_SEQ_LENGTH or shorten prompts", n_dead,
            len(train_exs), max_seq)
    if n_dead == len(train_exs):
        raise ValueError("every train example truncated to zero trainable "
                         "tokens; training would silently learn nothing")

    # the global batch spans the batch axes; each input shard (one rank
    # a shard) feeds its share of the rows
    data_par = mesh_cfg.data * mesh_cfg.fsdp if mesh_cfg else 1
    global_batch = plan.per_device_batch * data_par * plan.grad_accum
    in_shards, in_shard_id = input_shard_layout(mesh)
    host_batch = host_batch_size(global_batch, num_shards=in_shards)
    if plan.packing:
        packed = list(pack_examples(train_exs, max_seq))
        train_rows = {k: np.stack([r[k] for r in packed])
                      for k in packed[0]}
    else:
        train_rows = pad_sft_rows(train_exs, max_seq)
    eval_rows = pad_sft_rows(eval_exs, max_seq)
    # ceil: the final partial batch trains too (zero-weight padded)
    steps_per_epoch = max(-(-len(train_rows["inputs"]) // global_batch), 1)
    epochs = int(config.get("NUM_TRAIN_EPOCHS", 1))
    total_steps = steps_per_epoch * epochs

    # ---- optimizer / adapters / state ---------------------------------
    lora_cfg = LoraConfig.from_dict(config) if use_lora else None
    schedule = schedule_from_config(config, total_steps)
    opt = optimizer_from_config(config, schedule)
    # the weights are handed in: no second random init
    state = make_train_state(cfg, opt, seed=0, lora_cfg=lora_cfg,
                             params=params, device=dev, mesh=mesh)
    step_fn = make_train_step(cfg, opt, lora_cfg=lora_cfg,
                              schedule=schedule, plan=plan, device=dev,
                              mesh=mesh)
    eval_step = make_eval_step(cfg, lora_cfg=lora_cfg, device=dev,
                               mesh=mesh)
    out_base = config.get("OUTPUT_DIR_BASE", "/tmp/grt_sft")
    sft_dir = os.path.join(out_base, config.get("SFT_SUBDIR_NAME", "sft"))
    cadence = cadence_from_config(config)
    mgr = None
    if cadence["save_enabled"]:
        # recency retention, keep 2: this manager exists to resume, and
        # the corrupt-checkpoint fallback needs an earlier step
        mgr = CheckpointManager(sft_dir, max_to_keep=2,
                                score_attribute=None,
                                **checkpoint_knobs_from_config(config))

    group_by_length = bool(config.get("GROUP_BY_LENGTH", False))
    if group_by_length and plan.packing:
        logger.warning("GROUP_BY_LENGTH is redundant under PACKING; "
                       "packed sequences have no padding to group away")
        group_by_length = False

    def epoch_batches(epoch):
        yield from sft_epoch_batches(train_rows, global_batch,
                                     num_hosts=in_shards,
                                     host_id=in_shard_id, epoch=epoch,
                                     group_by_length=group_by_length)

    # the built mesh decides, as in the JAX entry: each context rank
    # keeps its S / C tokens of the rows, for the train and eval batches
    place = make_place_batch(dev, mesh=mesh)

    def eval_fn(st):
        return {"eval_loss": sharded_eval_loss(
            st, eval_step, eval_rows, host_batch=host_batch,
            in_shards=in_shards, in_shard_id=in_shard_id,
            place_batch=place, mesh=mesh)}

    # LoRA runs bill the 4N FLOP count (the frozen base takes no
    # weight-grad products); tokens/s and MFU per card of the world
    meter = ThroughputMeter(cfg, seq_len=max_seq, n_devices=world,
                            trainable="lora" if use_lora else "full",
                            device=dev)
    # a LoRA checkpoint holds the adapters and the optimizer only: the
    # frozen base is rebuilt from the pretrained weights on resume
    ckpt_view = None
    if use_lora:
        ckpt_view = (
            lambda st: dataclasses.replace(st, params=None),
            lambda st, v: dataclasses.replace(v, params=st.params),
        )
    try:
        state, metrics = run_training(
            state, step_fn, epoch_batches,
            epochs=epochs,
            place_batch=place,
            guards=plan.runtime_guards(),
            prefetch=plan.prefetch,
            log_every=int(config.get("LOGGING_STEPS", 10)),
            meter=meter, ckpt_manager=mgr,
            report_fn=lambda m: ctx.report(m),
            eval_fn=eval_fn if cadence["eval_enabled"] else None,
            eval_every=cadence["eval_every"],
            eval_at_epoch_end=cadence["eval_at_epoch_end"],
            ckpt_every=cadence["ckpt_every"],
            ckpt_view=ckpt_view,
            heartbeat_fn=ctx.heartbeat,
            profiler=profiler_from_config(
                config, os.path.join(out_base, "profile")),
            tb_writer=writer_from_config(
                config, os.path.join(out_base, "tensorboard"),
                is_host0=ctx.is_host0()),
            is_host0=ctx.is_host0())
    finally:
        if mgr is not None:
            mgr.close()

    # ---- the final artifact: HF layout and the tokenizer --------------
    final_dir = os.path.join(
        out_base, config.get("MERGED_MODEL_SUBDIR_NAME", "merged")
        if use_lora else config.get("FULL_FT_MODEL_SUBDIR_NAME", "full"))
    if mesh is None and ctx.is_host0():
        # LoRA: merged one projection at a time on the card, streamed to
        # the writer; the trained state is left as it was
        save_hf_checkpoint(state.params, cfg, final_dir,
                           lora=state.lora if use_lora else None,
                           lora_scale=lora_cfg.scale if use_lora else 1.0)
        save_tokenizer(tokenizer, final_dir)
        logger.info("saved final model + tokenizer to %s", final_dir)
    elif mesh is not None:
        # every rank saves its shards of the merged model (one block
        # gathered at a time); rank 0 adds the sidecar and tokenizer,
        # and `python -m gke_ray_train_tpu_torch.ckpt.convert
        # <dir>_dcp <dir>` writes the HF layout offline
        export_dir = final_dir + "_dcp"
        save_export(state.params, cfg, export_dir, state.step,
                    lora=state.lora if use_lora else None,
                    lora_scale=lora_cfg.scale if use_lora else 1.0)
        if ctx.is_host0():
            write_sidecar(cfg, export_dir)
            save_tokenizer(tokenizer, os.path.join(export_dir,
                                                   TOKENIZER_SUBDIR))
            logger.info("saved the sharded export + tokenizer to %s",
                        export_dir)

    # ---- optional inference comparison --------------------------------
    if bool(config.get("INFERENCE", False)):
        # LoRA: the tuned model is the frozen base plus the adapters at
        # decode time, never a merged copy of the base
        if use_lora:
            base_params = tuned_params = state.params
        elif have_local:
            # the base as the start loaded it: on a mesh sharded as the
            # tuned weights are, never whole on one card
            base_params = load_pretrained(str(ckpt_dir), cfg, device=dev,
                                          mesh=mesh)
            if mesh is not None:
                shard_model(base_params, mesh)
            tuned_params = state.params
        else:
            if ctx.is_host0():
                logger.warning(
                    "full-FT smoke without a pretrained checkpoint: "
                    "comparing tuned model against itself")
            base_params = tuned_params = state.params
        run_inference_comparison(
            base_params, tuned_params, cfg, tokenizer, ds_test,
            num_samples=int(config.get("NUM_EVAL_SAMPLES_INFERENCE", 2)),
            max_new_tokens=int(
                config.get("MAX_NEW_GENERATION_TOKENS_INFERENCE", 300)),
            output_path=os.path.join(out_base, "inference_comparison.json"),
            row_filter=(lambda r: r.get("sql_complexity")
                        == "window functions"),
            mesh=mesh, is_host0=ctx.is_host0(),
            tuned_lora=state.lora if use_lora else None,
            lora_scale=lora_cfg.scale if use_lora else 1.0, device=dev)

    # ---- optional post-train serving smoke ----------------------------
    # config, then env; only "1" / "true" turn it on (JAX's rule: the
    # documented disable value "0" must disable)
    serve_flag = config.get("SERVE_AFTER_TRAIN",
                            os.environ.get("SERVE_AFTER_TRAIN", "0"))
    serve = str(serve_flag).strip().lower() in ("1", "true")
    if serve and world > int(os.environ.get("LOCAL_WORLD_SIZE", world)):
        # JAX's rule: the engine's host-side scheduler runs on one node
        # (a multi-node job serves through rayint/serving.py replicas)
        logger.warning("SERVE_AFTER_TRAIN is single-node only (deploy "
                       "rayint/serving.py replicas to serve across nodes);"
                       " skipping")
        serve = False
    if serve:
        # on a mesh every rank serves (the smoke is collective); rank 0
        # writes
        eos = ([int(tokenizer.eos_token_id)]
               if getattr(tokenizer, "eos_token_id", None) is not None
               else [])
        prompts = []
        for row in ds_test[:int(config.get("NUM_EVAL_SAMPLES_INFERENCE",
                                           2))]:
            text = render_chat(tokenizer, format_gretel_sql_example(row),
                               add_generation_prompt=True)
            prompts.append(np.asarray(
                tokenizer(text, add_special_tokens=False)["input_ids"],
                np.int32))
        # a LoRA run tags every prompt with the trained adapter's id, so
        # the smoke runs the multi-tenant batched-adapter decode
        out = post_train_smoke(
            state.params, cfg, plan, prompts, eos_ids=eos,
            lora=state.lora if use_lora else None,
            lora_scale=lora_cfg.scale if use_lora else 1.0,
            adapter_ids=["tuned"] * len(prompts) if use_lora else None,
            max_new_tokens=64, device=dev)
        if out is not None and ctx.is_host0():
            comps, stats = out
            for c in comps:
                logger.info("serve smoke %s (%s): %s", c.rid,
                            c.finish_reason, tokenizer.decode(c.generated))
            os.makedirs(out_base, exist_ok=True)
            with open(os.path.join(out_base, "serve_smoke.json"), "w") as f:
                json.dump(stats, f, indent=2)
    return metrics


def main(argv=None) -> int:
    """Run the worker through ``TorchTrainer.fit()`` on the config named
    by ``argv[0]`` (the command line's first argument), else by
    ``FINE_TUNE_CONFIG``, else the default; under torchrun every rank
    runs it and only rank 0 prints the last line."""
    from gke_ray_train_tpu_torch.rayint import (
        RunConfig, ScalingConfig, TorchTrainer)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = list(argv or ())
    path = args[0] if args else os.environ.get("FINE_TUNE_CONFIG",
                                               DEFAULT_CONFIG)
    try:
        with open(path) as f:
            config = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        logger.error("failed to load %s: %s", path, e)
        return 1
    try:
        result = TorchTrainer(
            train_loop_per_worker, train_loop_config=config,
            scaling_config=ScalingConfig.from_env(),
            run_config=RunConfig.from_env("llm-fine-tune"),
            # torchrun's ranks are each one in-process worker
            use_ray=False if "RANK" in os.environ else None).fit()
    finally:
        _leave_group()
    if result.error:
        logger.error("training %s after %d attempt(s) (%d preemption(s)):"
                     " %s", result.status, result.attempts,
                     result.preemptions, result.error)
        return 1
    metrics = result.metrics
    logger.info("final metrics: %s", metrics)
    if not get_context().is_host0():
        return 0
    # one machine-readable line, last on stdout (logging goes to stderr)
    print(json.dumps({"metric": "flagship_final",
                      "attempts": result.attempts,
                      "preemptions": result.preemptions, **{
                          k: v for k, v in (metrics or {}).items()
                          if isinstance(v, (int, float))}}), flush=True)
    return 0


def _leave_group() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
