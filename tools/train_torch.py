"""Training driver of the PyTorch port (counterpart of ``tools/train.py``;
reference entry scripts: train_final_voc.py / train_final_coco.py).

    python tools/train_torch.py --dataset voc --data-folder /path/VOC2012 \
        --list-folder datasets/voc [--device cuda] [--resume]

One process a device (``--device``, a CUDA card unless told ``cpu``).  Under
``torchrun`` (one process per GPU, one node or several) the processes train
the recipe's global batch together: each rank loads its slice of every
global batch and the gradients are summed over the ranks
(``dupl_tpu_torch/parallel``); ``--fsdp`` also shards the parameters and the
Adam moments over the ranks.  ``--model-parallel N`` groups N neighbouring
ranks into a model group (tensor parallelism,
``dupl_tpu_torch/parallel/tensor_parallel.py``): its ranks hold the same
samples and each its share of every student's heads, MLP hidden units and
decoder channels, so the world is a grid of world / N data ranks x N, and
``--fsdp`` shards each rank's share over the data ranks; N must divide the
world (NCCL on a node with that many cards; the CPU tests run it over
gloo).  Rank 0 alone writes the run's files, with every tensor gathered to
the one-device layout, and validates, while the others wait::

    torchrun --nproc_per_node 8 tools/train_torch.py --data-folder VOC2012 ...
    torchrun --nproc_per_node 8 tools/train_torch.py --model-parallel 2 ...
    torchrun --nnodes 2 --nproc_per_node 8 --rdzv-endpoint HOST:29500 \
        tools/train_torch.py --multihost [--fsdp] [--model-parallel 2] ...

The loop: a ``PrefetchLoader`` decodes and augments batches on worker threads, a
``DeviceFeeder`` stages them on the device ahead of the step,
``Trainer.train_step`` runs the curriculum phase the host-side step count
falls in, an ``AverageMeter`` holds the step's device scalars until the log
boundary, and every ``eval_iters`` steps the run checkpoints its full state,
exports the weights as ``.npz`` and validates.  SIGTERM / SIGINT checkpoint
and exit 0; ``--resume`` continues from the latest checkpoint of
``--work-dir`` with the batches an uninterrupted run would have seen.

Inputs: a VOC or COCO directory tree (``--data-folder``; COCO trains on
``train`` and validates on ``val_part``), or packed ``.duplrec`` shards
(``--train-records`` with ``--val-records``, from
``tools/pack_records_torch.py``), which give the directory feed's samples
byte for byte.  ``--pretrained`` starts both students' encoders from a DeiT /
timm ``.pth``; a ``--resume`` that finds a checkpoint wins over it.

Writes under the run directory: ``train.log``, ``metrics.jsonl`` (one JSON
line per log, validation and end-of-run event), ``checkpoints/step_<n>.pt``
and ``checkpoints/weights.npz``.

Not ported yet: TensorBoard output and the MFU line are not written.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    p.add_argument("--data-folder", default=None, help="dataset directory tree")
    p.add_argument("--list-folder", default=None)
    p.add_argument("--train-records", default=None,
                   help="packed train shard, or a glob of shards "
                        "(with --val-records, in place of --data-folder)")
    p.add_argument("--val-records", default=None,
                   help="packed val shard, or a glob of shards")
    p.add_argument("--work-dir", default="work_dir")
    p.add_argument("--comment", default="")
    p.add_argument("--pretrained", default=None,
                   help="DeiT / timm .pth checkpoint for both students' "
                        "encoders (a checkpoint found by --resume wins)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card the tool "
                        "refuses to start unless told cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--samples-per-device", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks a model group (tensor parallelism, under "
                        "torchrun); must divide the world size")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters and Adam moments over the ranks "
                        "(under torchrun; one process has nothing to shard)")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in work-dir")
    p.add_argument("--eval-iters", type=int, default=None)
    p.add_argument("--log-iters", type=int, default=None)
    p.add_argument("--transfer-dtype", default="uint8",
                   choices=["uint8", "float32"],
                   help="train-batch wire format: uint8 ships the augmented "
                        "crop at 1/4 the bytes and normalises on the device "
                        "(same floats to <=1 ulp); float32 ships host-"
                        "normalised images (the reference's format)")
    p.add_argument("--val-transfer-dtype", default=None, choices=["bfloat16"],
                   help="round CAM tensors before a device->host copy during "
                        "validation (host post-processing only)")
    p.add_argument("--profile-iters", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"),
                   help="capture a torch.profiler trace between these steps")
    p.add_argument("--multihost", action="store_true",
                   help="require torchrun's environment and form the process "
                        "group even at one process (several nodes: every "
                        "node runs torchrun with --nnodes)")
    p.add_argument("--backbone", default=None,
                   help="override backbone (e.g. test_tiny_patch16 for smoke)")
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--cam-iters", type=int, default=None)
    p.add_argument("--gmm-iters", type=int, default=None)
    p.add_argument("--refine-switch-iters", type=int, default=None,
                   help="COCO aux->main refine-source switch boundary")
    p.add_argument("--cam-stream-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="residual-stream dtype for the no-grad CAM pass "
                        "(ModelConfig.cam_stream_dtype)")
    p.add_argument("--cam-merge-downscale", type=int, default=2,
                   help="merge training CAMs at input/this resolution "
                        "(0 = full-res, the reference semantics)")
    p.add_argument("--sync-debug", action="store_true",
                   help="run every step that is neither a log nor an eval "
                        "boundary under torch.cuda.set_sync_debug_mode"
                        "('error'): a host sync inside such a step raises")
    return p.parse_args(argv)


def check_inputs(args) -> None:
    """Exit unless the inputs are a directory tree or both record flags."""
    if not args.data_folder and not (args.train_records and args.val_records):
        raise SystemExit("either --data-folder or --train-records + "
                         "--val-records is required")
    if bool(args.train_records) != bool(args.val_records):
        raise SystemExit("--train-records and --val-records go together "
                         "(mixing a packed train feed with a directory val "
                         "feed is almost never intended)")


def build_datasets(args, cfg, list_folder):
    """(train dataset, val dataset) of the recipe: packed shards when the
    record flags are given, else the directory tree."""
    kw = dict(num_classes=cfg.num_classes, transfer_dtype=args.transfer_dtype)
    train_kw = dict(kw, crop_size=cfg.data.crop_size,
                    rescale_range=cfg.data.rescale_range,
                    ignore_index=cfg.ignore_index)
    if args.train_records:
        from dupl_tpu_torch.data import records

        coco = args.dataset == "coco"
        cls_ds = (records.RecordCocoClsDataset if coco
                  else records.RecordVocClsDataset)
        seg_ds = (records.RecordCocoSegDataset if coco
                  else records.RecordVocSegDataset)
        return cls_ds(args.train_records, **train_kw), seg_ds(
            args.val_records, **kw)
    if args.dataset == "voc":
        from dupl_tpu_torch.data.voc import VocClsDataset, VocSegDataset

        return (VocClsDataset(args.data_folder, list_folder,
                              cfg.data.train_split, **train_kw),
                VocSegDataset(args.data_folder, list_folder,
                              cfg.data.val_split, **kw))
    from dupl_tpu_torch.data.coco import CocoClsDataset, CocoSegDataset

    return (CocoClsDataset(args.data_folder, list_folder, "train", **train_kw),
            CocoSegDataset(args.data_folder, list_folder, "val_part", **kw))


def build_config(args):
    from dupl_tpu_torch.engine.train import production_config

    over = {"seed": args.seed}
    for name in ("max_iters", "samples_per_device", "eval_iters", "log_iters",
                 "cam_iters", "gmm_iters", "refine_switch_iters"):
        v = getattr(args, name)
        if v is not None:
            over[name] = v
    cfg = production_config(args.dataset, **over)
    model = dataclasses.replace(cfg.model,
                                cam_stream_dtype=args.cam_stream_dtype)
    if args.backbone:
        model = dataclasses.replace(model, backbone=args.backbone)
    cfg = dataclasses.replace(
        cfg, model=model, cam_merge_downscale=args.cam_merge_downscale or None)
    if args.crop_size:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, crop_size=args.crop_size))
    return cfg


def read_metrics(path: str):
    """The records of a ``metrics.jsonl``; a line that does not parse (the
    torn last line of a killed run) is skipped."""
    records = []
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return records


def main(argv=None) -> int:
    args = parse_args(argv)
    check_inputs(args)

    from dupl_tpu_torch.parallel.mesh import init_from_env
    from dupl_tpu_torch.utils.device import cli_device

    device = cli_device(args.device)
    try:
        dist, device = init_from_env(device, args.multihost,
                                     n_model=args.model_parallel)
    except ValueError as e:      # --model-parallel does not divide the world
        raise SystemExit(f"--model-parallel {args.model_parallel}: {e}")
    try:
        return _train(args, dist, device)
    finally:
        dist.close()


def _train(args, dist, device) -> int:
    import torch

    from dupl_tpu_torch.config import resolve_samples_per_device
    from dupl_tpu_torch.data.pipeline import DeviceFeeder, PrefetchLoader
    from dupl_tpu_torch.engine import checkpoint as ckpt
    from dupl_tpu_torch.engine.optimizer import current_lr
    from dupl_tpu_torch.engine.train import Trainer, phase_of
    from dupl_tpu_torch.engine.validate import Validator
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.models.pretrained import (install_pretrained_encoder,
                                                  load_deit_checkpoint)
    from dupl_tpu_torch.ops import cam as cam_ops
    from dupl_tpu_torch.parallel.data_parallel import (METRIC_KEYS,
                                                     reduce_window)
    from dupl_tpu_torch.parallel.mesh import shard_state
    from dupl_tpu_torch.utils.logging import AverageMeter, cal_eta, setup_logger

    on_card = device.type == "cuda"
    main_rank = dist.is_main
    cfg = build_config(args)
    list_folder = args.list_folder or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "datasets", args.dataset)

    if args.resume:
        # resume in place: --work-dir points at the previous run directory
        work_dir = args.work_dir
    else:
        # every rank writes under rank 0's timestamp
        stamp = dist.broadcast_object("{0:%Y-%m-%d-%H-%M-%S}".format(
            datetime.datetime.now()))
        work_dir = os.path.join(args.work_dir, stamp + args.comment)
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    # rank 0 owns train.log, metrics.jsonl, the exports and validation; the
    # other ranks log to the console
    log = setup_logger(os.path.join(work_dir, "train.log") if main_rank
                       else None)

    # machine-readable twin of the text log: one JSON line per event
    metrics_path = os.path.join(work_dir, "metrics.jsonl")

    def jlog(**rec):
        if main_rank:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    log.info("torch %s device %s", torch.__version__,
             torch.cuda.get_device_name(device) if on_card else "cpu")
    log.info("config: %s", json.dumps(dataclasses.asdict(cfg), default=str,
                                      indent=1))

    # data ---------------------------------------------------------------
    train_ds, val_ds = build_datasets(args, cfg, list_folder)
    if args.samples_per_device is None:
        # pin the recipe's global batch over the data ranks
        cfg, warn = resolve_samples_per_device(cfg, dist.n_data)
        if warn:
            log.warning("%s", warn)
    batch_size = cfg.samples_per_device
    fsdp = args.fsdp and dist.n_data > 1
    log.info("rank %d of %d (%s%s); data rank %d of %d, model rank %d of "
             "%d; batch %d a data rank, global batch %d", dist.rank,
             dist.world, device, ", fsdp" if fsdp else "",
             dist.data_rank, dist.n_data, dist.model_rank, dist.n_model,
             batch_size, batch_size * dist.n_data)
    if args.fsdp and not fsdp:
        log.warning("--fsdp: one data rank, nothing to shard")

    # model/state --------------------------------------------------------
    trainer = Trainer(cfg, device=device, dist=dist)
    state = trainer.init_state()
    resumed = args.resume and ckpt.latest_step(ckpt_dir) is not None
    if args.pretrained and not resumed:
        # the backbone's own depth: blocks past it in the file are ignored
        enc = load_deit_checkpoint(args.pretrained,
                                   len(state.model.branch1.encoder.blocks))
        install_pretrained_encoder(state.model, enc)
        log.info("loaded pretrained encoder from %s", args.pretrained)
    # rank 0's weights on every rank; each its share under
    # --model-parallel; with --fsdp, sharded over the data ranks
    state = shard_state(state, dist, fsdp=fsdp)
    if resumed:
        state = ckpt.restore_state(ckpt_dir, state)
        log.info("resumed from step %d", state.step)
        if main_rank and os.path.exists(metrics_path):
            # drop records beyond the restored step: the resumed run
            # re-executes those steps and would otherwise append a second,
            # conflicting line for the same step
            kept = [r for r in read_metrics(metrics_path)
                    if r.get("step", 0) <= state.step]
            with open(metrics_path, "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in kept)

    # The loader is built AFTER the restore, so a resumed run fast-forwards
    # the deterministic index stream to the restored step: batch k is a pure
    # function of (seed, k).  Data rank r loads positions [r B, (r + 1) B) of
    # every global batch; the ranks of a model group load the same.
    loader = PrefetchLoader(train_ds, batch_size, seed=cfg.seed,
                            num_workers=args.num_workers,
                            shard=dist.data_rank, num_shards=dist.n_data,
                            start_step=state.step)
    budget = cfg.par.class_budget
    feeder = DeviceFeeder(
        loader, device, keys=("image", "cls_label", "img_box"),
        # read from the batch's HOST copy, so no step waits for it
        host_fn=lambda b: {"fits_budget": cam_ops.fits_class_budget(
            torch.as_tensor(b["cls_label"]), budget)})
    validator = None
    if main_rank:
        # a sharded model's forward is a collective: rank 0 validates a
        # plain copy that takes the gathered weights
        eval_model = (DualStudent(cfg.model).to(device)
                      if fsdp or dist.n_model > 1 else trainer.model)
        validator = Validator(cfg, eval_model,
                              transfer_dtype=args.val_transfer_dtype)
    meter = AverageMeter()
    t0 = datetime.datetime.now()
    step_t0 = time.perf_counter()
    waited = 0          # feeder waits already reported at a log boundary

    # Preemption safety: trap SIGTERM and SIGINT into a flag the loop checks
    # every iteration: checkpoint, then exit cleanly.  With the order-exact
    # --resume a preempted run loses at most one step of work.  Under a
    # process group the ranks agree on the flag at log boundaries only,
    # where they already wait for each other, so that they all stop at the
    # same step; such a run loses at most a log window.
    preempted = {"sig": None}

    def _on_term(signum, frame):
        preempted["sig"] = signum

    previous = {s: signal.signal(s, _on_term)
                for s in (signal.SIGTERM, signal.SIGINT)}
    profiler = None
    first_step = step = state.step  # host-side count: no device scalar is read
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        for batch, dev_batch in feeder:
            if step >= cfg.max_iters:
                break
            agree = not dist.active or step % cfg.log_iters == 0
            sig = dist.max_(preempted["sig"] or 0) if agree else 0
            if sig:
                log.info("signal %s: checkpointing at step %d and exiting "
                         "(resume with --resume)", sig, step)
                ckpt.save_state(ckpt_dir, state)
                jlog(event="preempted", step=step, signal=sig)
                return 0
            if args.profile_iters and step == args.profile_iters[0]:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if on_card:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            log_now = (step + 1) % cfg.log_iters == 0
            eval_now = (step + 1) % cfg.eval_iters == 0
            guarded = args.sync_debug and on_card and not (log_now or eval_now)
            if guarded:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, metrics = trainer.train_step(state, dev_batch, step=step)
                meter.add(metrics)  # device scalars; read at the log boundary
            finally:
                if guarded:
                    torch.cuda.set_sync_debug_mode("default")
            if profiler is not None and step == args.profile_iters[1]:
                profiler.stop()
                os.makedirs(os.path.join(work_dir, "profile"), exist_ok=True)
                profiler.export_chrome_trace(os.path.join(
                    work_dir, "profile", f"trace-rank{dist.rank}.json"
                    if dist.active else "trace.json"))
                profiler = None
                log.info("profiler trace written to %s/profile", work_dir)

            if log_now:
                delta, eta = cal_eta(t0, step + 1 - first_step,
                                     cfg.max_iters - first_step)
                lr = float(current_lr(cfg.optim, step, cfg.max_iters))
                # waits for the window's steps; summed over the ranks
                window = reduce_window(meter, dist, METRIC_KEYS)
                losses = {k: window[k] for k in METRIC_KEYS[:5]}
                dt = (time.perf_counter() - step_t0) / cfg.log_iters
                step_t0 = time.perf_counter()
                waits = feeder.wait_seconds[waited:]
                waited += len(waits)
                wait_ms = 1e3 * sum(waits) / max(1, len(waits))
                log.info(
                    "Iter: %d; Elapsed: %s; ETA: %s; LR: %.3e; phase: %s; "
                    "%.3f s/it (feeder wait %.1f ms); cls: %.4f | ptc: %.4f "
                    "| seg: %.4f | sim: %.4f | reg: %.4f",
                    step + 1, delta, eta, lr, phase_of(cfg, step), dt, wait_ms,
                    losses["cls_loss"], losses["ptc_loss"], losses["seg_loss"],
                    losses["sim_loss"], losses["reg_loss"])
                jlog(event="train", step=step + 1, lr=lr,
                     phase=phase_of(cfg, step), s_per_iter=round(dt, 4),
                     feeder_wait_ms=round(wait_ms, 3),
                     loss=round(window["loss"], 6),
                     cls_f1=round(window["cls_score"], 4),
                     **{k: round(v, 6) for k, v in losses.items()})

            if eval_now:
                t_ck = time.perf_counter()
                path = ckpt.save_state(ckpt_dir, state)   # every rank
                ckpt_s = time.perf_counter() - t_ck
                weights = ckpt.full_model_state(state.model)
                if main_rank:
                    ckpt.export_weights(os.path.join(ckpt_dir, "weights.npz"),
                                        weights)
                    export_s = time.perf_counter() - t_ck - ckpt_s
                    log.info("validating at iter %d ...", step + 1)
                    t_val = time.perf_counter()
                    model = validator.model
                    if model is not state.model:
                        model.load_state_dict(weights)
                    was_training = model.training
                    model.eval()
                    res = validator.run(val_ds, log=log, progress_every=200)
                    model.train(was_training)
                    val_s = time.perf_counter() - t_val
                    log.info("val cls F1: %.4f / %.4f",
                             res["cls_f1_1"], res["cls_f1_2"])
                    log.info("\n%s", res["table"])
                    jlog(event="val", step=step + 1,
                         cls_f1_1=round(res["cls_f1_1"], 4),
                         cls_f1_2=round(res["cls_f1_2"], 4),
                         **{f"{k}_miou": round(res[f"{k}_miou"], 4)
                            for k in ("cam_1", "cam_2", "cam_aux_1",
                                      "cam_aux_2", "seg_1", "seg_2")},
                         val_s=round(val_s, 3), ckpt_s=round(ckpt_s, 3),
                         ckpt_mb=round(os.path.getsize(path) / 1e6, 1),
                         export_s=round(export_s, 3))
                del weights
                dist.barrier()   # the other ranks wait for the validation
                step_t0 = time.perf_counter()  # validation is not step time

            step += 1
        stats = feeder.stats(skip=min(2, max(0, step - first_step - 1)))
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if on_card else None)
        if dist.active and peak is not None:
            log.info("rank %d peak memory %.3f GiB", dist.rank, peak)
        jlog(event="done", step=step, feeder_wait_ms=stats["wait_ms"],
             h2d_copy_ms=stats["copy_ms"],
             h2d_ready_share=stats["ready_share"], peak_gib=peak)
        log.info("done.")
        return 0
    finally:
        feeder.stop()  # also stops the underlying PrefetchLoader
        if profiler is not None:
            profiler.stop()
        for s, handler in previous.items():
            signal.signal(s, handler)
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)


if __name__ == "__main__":
    sys.exit(main())
