"""The from-scratch LLM pre-train entry on one GPU or one rank per GPU
(counterpart of ``ray-jobs/pretrain_llm_ray.py``: ``train_loop_per_worker``
and its ``__main__``).

    SMOKE_TEST=1 python -m gke_ray_train_tpu_torch.pretrain
    torchrun --nproc-per-node N -m gke_ray_train_tpu_torch.pretrain

The reference's second job (``pytorch_llm_ray.py``): wikitext-2,
char-tokenized, trains a decoder-only transformer from random weights
(``models/config.py::basic_lm``, 2,048 d / 24 layers / 16 heads / 8,192
ff, about 1.61 G parameters) with warmup-cosine AdamW, grad clip 1.0,
rank-0 logging every 20 steps and a checkpoint a epoch (keep 2 by
recency, so a preemption's save and an earlier restorable step
survive). ``main`` runs the worker through
``rayint/trainer.py::TorchTrainer.fit()`` with the JAX entry's knobs:
``SMOKE_TEST``, ``MAX_SAMPLES``, ``MAX_FAILURES``, ``MAX_PREEMPTIONS``,
``WORKER_TIMEOUT_S``, ``HEARTBEAT_TIMEOUT_S``, ``MESH_FSDP``,
``MESH_DATA``, ``DATA_DIR``, ``STORAGE_PATH`` and ``PREFETCH_BATCHES``;
it exits 1 on an error ``Result``.

The worker keeps the JAX entry's config keys and order of steps. Rank 0
prepares the corpus (``prepare_wikitext2`` with its synthetic fallback;
the files are kept, so a retried attempt and the other ranks read the
same corpus) and a ``torch.distributed`` barrier stands in for
``sync_global_devices``. Under a world above one the mesh comes from
``MESH_DATA`` / ``MESH_FSDP`` (FSDP2; ``MESH_CONTEXT`` cuts each row
into the context ranks' token shards, as JAX's
``pretrain_llm_ray.py:210`` places them), re-formed on the survivors after
an elastic pool change (``rayint/elastic.py``), and the restore
reshards. ``PEER_REPLICATION`` raises (ROADMAP queue 1 item 8);
``SERVE_AFTER_TRAIN`` serves the trained model as it is sharded, every
rank of one node entering the engine, and warns and skips beyond one
node, as JAX does. ``MESH_PIPE`` above 1 trains the pipeline
(``models/pipeline.py``; ``PIPE_MICROBATCHES`` / ``PIPE_VIRTUAL_STAGES``
from the config), and ``SERVE_AFTER_TRAIN`` there decodes across the
stages (``models/kvcache.py``). ``OVERLAP``, ``NUM_SLICES``,
``DCN_SYNC`` and ``DCN_COMPRESS`` (config or environment) are read as
the fine-tune entry reads them (``train/overlap.py``,
``parallel/hierarchical.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

import numpy as np

from gke_ray_train_tpu_torch.ckpt import CheckpointManager
from gke_ray_train_tpu_torch.config import checkpoint_knobs_from_config
from gke_ray_train_tpu_torch.data import (
    CharTokenizer, ShardedBatches, SlidingWindowDataset, make_place_batch,
    prepare_wikitext2, save_tokenizer)
from gke_ray_train_tpu_torch.device import DeviceLike, world_size
from gke_ray_train_tpu_torch.models import basic_lm
from gke_ray_train_tpu_torch.parallel.mesh import (
    MeshConfig, build_mesh, distributed_init)
from gke_ray_train_tpu_torch.parallel.placement import input_shard_layout
from gke_ray_train_tpu_torch.plan import ExecutionPlan
from gke_ray_train_tpu_torch.rayint import get_context
from gke_ray_train_tpu_torch.rayint.elastic import maybe_replan
from gke_ray_train_tpu_torch.serve import post_train_smoke
from gke_ray_train_tpu_torch.train import (
    ThroughputMeter, make_optimizer, make_train_state, make_train_step,
    warmup_cosine_schedule)
from gke_ray_train_tpu_torch.train.loop import run_training
from gke_ray_train_tpu_torch.train.profiling import profiler_from_config

logger = logging.getLogger("pretrain")


def _barrier() -> None:
    if world_size() > 1:
        import torch.distributed as dist
        dist.barrier()


def train_loop_per_worker(config: dict, *, device: DeviceLike = None):
    """The worker: prepares the corpus, trains from random weights,
    checkpoints and resumes; returns the loop's last metrics. Runs on
    ``device`` (default ``cuda``, ``cuda:LOCAL_RANK`` on a rank)."""
    dev = distributed_init(device)
    world = world_size()
    ctx = get_context()
    seq_len = int(config.get("dataset_seq_len", 256))
    # the env supplies the guard and kernel knobs, the config the batch
    # shape, as in the JAX entry
    plan = ExecutionPlan.resolve(
        {k: config[k] for k in ("PIPE_MICROBATCHES", "PIPE_VIRTUAL_STAGES",
                                "OVERLAP", "NUM_SLICES", "DCN_SYNC",
                                "DCN_COMPRESS")
         if k in config},
        per_device_batch=int(config.get("batch_size_per_device", 16)),
        max_seq_len=seq_len,
        prefetch=int(config.get("prefetch_batches",
                                config.get("PREFETCH_BATCHES", 2))))
    # the mesh of a world above one, re-formed on the survivors of an
    # elastic pool change (global batch kept)
    mesh_cfg, per_device_batch = maybe_replan(
        dataclasses.replace(MeshConfig.from_dict(config),
                            num_slices=plan.num_slices if world > 1 else 1),
        plan.per_device_batch, world=world, config=config, log=logger)
    mesh = None
    if world > 1:
        mesh_cfg.check_ported()
        plan.check_mesh(mesh_cfg, world)
        mesh = build_mesh(mesh_cfg, device_type=dev.type)
    # the survivors' slices (a DCN_SYNC=hier plan left on one slice runs
    # flat, with the plan's warning); one process ignores NUM_SLICES
    plan = dataclasses.replace(plan, num_slices=mesh_cfg.num_slices)
    # the attempt ran under this plan, not the trainer's resolution of a
    # config without the plan keys
    ctx.plan_fingerprint = plan.fingerprint()
    logger.info("worker %d/%d on %s; mesh %s; plan %s",
                ctx.get_world_rank(), world, dev, mesh_cfg.shape,
                plan.fingerprint())

    data_dir = config.get("data_dir", "/mnt/pvc/data")
    tok_path = os.path.join(data_dir, "char_tokenizer.json")
    ids_path = os.path.join(data_dir, "wikitext2_train_ids.npy")

    # ---- rank-0 data prep + barrier -------------------------------------
    if ctx.is_host0() and not (os.path.exists(tok_path)
                               and os.path.exists(ids_path)):
        paths = prepare_wikitext2(data_dir, synthetic_fallback=True)
        with open(paths["train"]) as f:
            text = f.read()
        tok = CharTokenizer.fit(text)
        tok.save(tok_path)
        np.save(ids_path, tok.encode(text))
        logger.info("data prep done: %d tokens, vocab %d",
                    os.path.getsize(ids_path) // 4, tok.vocab_size)
    _barrier()

    tok = CharTokenizer.load(tok_path)
    ids = np.load(ids_path)
    dataset = SlidingWindowDataset(ids, seq_len)

    cfg = basic_lm(
        vocab_size=tok.vocab_size,
        d_model=int(config.get("d_model", 2048)),
        n_layers=int(config.get("n_layers", 24)),
        n_heads=int(config.get("n_heads", 16)),
        d_ff=int(config.get("d_ff", 8192)),
        max_seq_len=max(seq_len, int(config.get("model_max_seq_len", 1024))),
        dtype=config.get("dtype", "bfloat16"),
        remat_policy=config.get("remat_policy", "full"),
        pipe_virtual=plan.pipe_virtual_stages,
    )

    global_batch = per_device_batch * mesh_cfg.data * mesh_cfg.fsdp
    # test_run: at most 16k samples (pytorch_llm_ray.py:198-201);
    # "max_samples" cuts further
    max_samples = (int(config["max_samples"]) if "max_samples" in config
                   else (16_000 if config.get("test_run", True) else None))
    in_shards, in_shard_id = input_shard_layout(mesh)
    batches = ShardedBatches(
        dataset, global_batch, num_hosts=in_shards, host_id=in_shard_id,
        max_samples=max_samples)

    epochs = int(config.get("epochs", 1))
    total_steps = batches.steps_per_epoch() * epochs
    schedule = warmup_cosine_schedule(
        float(config.get("lr", 3e-4)), total_steps,
        warmup_frac=float(config.get("warmup_frac", 0.05)),
        min_lr_frac=float(config.get("min_lr_frac", 0.01)))
    opt = make_optimizer(schedule,
                         weight_decay=float(config.get("weight_decay", 0.01)),
                         clip_norm=float(config.get("grad_clip", 1.0)))
    state = make_train_state(cfg, opt, seed=0, device=dev, mesh=mesh)
    step_fn = make_train_step(cfg, opt, mesh=mesh, schedule=schedule,
                              plan=plan, device=dev)
    run_dir = os.path.join(
        config.get("storage_path", "/mnt/pvc/ray_llm_training_runs"),
        config.get("run_name", "basic_lm"))
    # recency retention, keep 2: this manager exists to resume, and the
    # corrupt-checkpoint fallback needs an earlier step
    mgr = CheckpointManager(run_dir, max_to_keep=2, score_attribute=None,
                            **checkpoint_knobs_from_config(config))
    if ctx.is_host0():
        # the run directory alone is enough to decode and resume
        save_tokenizer(tok, run_dir)

    meter = ThroughputMeter(cfg, seq_len=seq_len, n_devices=world,
                            device=dev)
    try:
        state, metrics = run_training(
            state, step_fn, lambda e: batches.iter_epoch(e),
            epochs=epochs,
            guards=plan.runtime_guards(),
            place_batch=make_place_batch(dev, mesh=mesh),
            prefetch=plan.prefetch,
            log_every=int(config.get("log_every", 20)),
            meter=meter, ckpt_manager=mgr,
            report_fn=lambda m: ctx.report(m),
            heartbeat_fn=ctx.heartbeat,
            profiler=profiler_from_config(
                config, os.path.join(config.get("storage_path", "/tmp"),
                                     "profile")),
            is_host0=ctx.is_host0())
    finally:
        mgr.close()

    # ---- optional post-train serving smoke ----------------------------
    serve_flag = config.get("SERVE_AFTER_TRAIN",
                            os.environ.get("SERVE_AFTER_TRAIN", "0"))
    if str(serve_flag).strip().lower() in ("1", "true"):
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        if world > local_world:
            logger.warning("SERVE_AFTER_TRAIN is single-node only; "
                           "skipping")
        else:
            # a few sliding-window prefixes of the corpus; pre-training
            # trains the full weights, so there is no adapter to tag. On
            # a mesh every rank serves the sharded model (collective);
            # rank 0 gets the stats
            prompts = [ids[i * 257:i * 257 + 48] for i in range(4)]
            out = post_train_smoke(state.params, cfg, plan, prompts,
                                   max_new_tokens=48, device=dev)
            if out is not None and ctx.is_host0():
                comps, stats = out
                for c in comps:
                    logger.info("serve smoke %s: %r", c.rid,
                                tok.decode(np.asarray(c.generated)))
                ctx.report({**metrics, "serve_smoke": stats})
    return metrics


def job_config(env=None) -> dict:
    """The JAX ``__main__``'s job config (pytorch_llm_ray.py:324-344),
    with its environment overrides."""
    env = os.environ if env is None else env
    smoke = env.get("SMOKE_TEST", "0") == "1"
    return {
        "d_model": 256 if smoke else 2048,
        "n_layers": 4 if smoke else 24,
        "n_heads": 8 if smoke else 16,
        "d_ff": 1024 if smoke else 8192,
        "dataset_seq_len": 128 if smoke else 256,
        "model_max_seq_len": 1024,
        "batch_size_per_device": 4 if smoke else 16,
        "lr": 3e-4, "weight_decay": 0.01,
        "warmup_frac": 0.05, "min_lr_frac": 0.01, "grad_clip": 1.0,
        "epochs": 1,
        "test_run": True,
        **({"max_samples": int(env.get("MAX_SAMPLES", "1600"))}
           if smoke else {}),
        "log_every": 20,
        "prefetch_batches": int(env.get("PREFETCH_BATCHES", "2")),
        "dtype": "float32" if smoke else "bfloat16",
        "data_dir": env.get("DATA_DIR", "/mnt/pvc/data"),
        "storage_path": env.get(
            "STORAGE_PATH", "/mnt/pvc/ray_llm_training_runs"),
        "run_name": "basic_lm_pretrain",
        "MESH_FSDP": int(env.get("MESH_FSDP", "-1")),
        "MESH_DATA": int(env.get("MESH_DATA", "1")),
    }


def main(argv=None) -> int:
    """Run the worker through ``TorchTrainer.fit()``; 1 on an error
    ``Result``. Under torchrun every rank is one in-process worker."""
    from gke_ray_train_tpu_torch.rayint import (
        RunConfig, ScalingConfig, TorchTrainer)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    config = job_config()
    trainer = TorchTrainer(
        train_loop_per_worker,
        train_loop_config=config,
        scaling_config=ScalingConfig.from_env(),
        run_config=RunConfig.from_env("basic-lm-pretrain",
                                      config["storage_path"]),
        # torchrun's ranks are each one in-process worker
        use_ray=False if "RANK" in os.environ else None)
    result = trainer.fit()
    if result.error:
        logger.error("training %s after %d attempt(s) "
                     "(%d preemption(s)): %s", result.status,
                     result.attempts, result.preemptions, result.error)
        return 1
    logger.info("final metrics: %s (attempts=%d preemptions=%d)",
                result.metrics, result.attempts, result.preemptions)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
