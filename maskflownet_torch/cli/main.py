"""Training/validation/prediction CLI of the port: the counterpart of
``maskflownet_tpu/cli/main.py``, run as ``python -m
maskflownet_torch.cli.main``.

CLI surface of the reference (``main.py:28-57``; README usage ``python
main.py MaskFlownet_S.yaml [--dataset_cfg chairs.yaml] [-c CKPT]
[--clear_steps] [--debug|--valid|--predict] [--resize H,W]``), with the JAX
CLI's flags, defaults and log lines, and these differences:

* ``--device`` (default ``cuda``) in place of ``--platform``: the trainer,
  the device cache and the prefetcher all take it, and without a card
  only ``--device cpu`` runs;
* one process a card: ``MFN_COORDINATOR`` (``host:port``),
  ``MFN_NUM_PROCESSES`` and ``MFN_PROCESS_ID`` start N processes as the
  JAX CLI's do, joined by ``torch.distributed`` (NCCL on cards, gloo on
  the CPU; ``MFN_DIST_BACKEND`` names another, as two processes on one
  card need gloo). ``--batch`` is the global batch: each process loads and
  steps on 1/N of it, and the gradients are averaged over the processes
  (the JAX CLI's processes load ``batch`` each). The run id's device tag
  is N. Every process validates; only process 0 writes the log, the
  checkpoints, the profile and what ``--valid``/``--predict`` write;
* ``--profile START,STOP`` records a ``torch.profiler`` trace into
  ``<root>/profile``;
* ``--aug_sampler`` and ``--aug_label_dtype`` in place of the JAX
  package's ``MFN_AUG_SAMPLER`` and ``MFN_AUG_LABEL_DTYPE``: ``twopass``
  samples the device augmentation as the JAX package does on the TPU
  (``augment/geometry.py``), so it needs ``--aug device``;
* every thread ``main`` starts (the loader's producers and mixer, the
  cache's refresh thread or the prefetcher's worker, the checkpoint
  removal thread) has ended when it returns.

Flow: parse args -> load network+dataset YAML -> resolve run-id/checkpoint
(regex registry, reference ``path.py``) -> build Trainer -> load datasets
into RAM per the dataset config (``main.py:192-365``) -> threaded loader ->
device cache or prefetcher -> train loop with piecewise LR, periodic
validation, checkpoint rotation of 3 (``main.py:513-556``), until the
schedule ends. The metrics are read back from the device only on the
steps that log them.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import threading
from queue import Queue
from timeit import default_timer

import numpy as np

from maskflownet_torch import get_device
from maskflownet_torch.config import load_config, presets
from maskflownet_torch.data import (Dataset, DeviceBatchCache, TrainLoader,
                                    chairs, hd1k, kitti, sintel, things3d,
                                    with_mask)
from maskflownet_torch.models import ModelConfig
from maskflownet_torch.parallel import (DevicePrefetcher, batch_sharding,
                                        initialize_distributed, make_mesh,
                                        shutdown_distributed)
from maskflownet_torch.training import (DictMovingAverage, FileLog, NullLog,
                                        MovingAverage, TrainSettings, Trainer,
                                        find_checkpoints, find_log,
                                        generate_run_id, lr_at_step, read_log,
                                        sync_metrics)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", type=str, nargs="?", default=None)
    p.add_argument("--dataset_cfg", type=str, default="chairs.yaml")
    p.add_argument("-b", "--batch", type=int, default=None,
                   help="global batch size (default: dataset preset)")
    p.add_argument("-s", "--shard", type=int, default=1,
                   help="load 1/shard of things3d")
    p.add_argument("-c", "--checkpoint", type=str, default=None,
                   help="checkpoint (run prefix[:steps]) to resume from")
    p.add_argument("--clear_steps", action="store_true")
    p.add_argument("-n", "--network", type=str, default="MaskFlownet")
    p.add_argument("--debug", action="store_true",
                   help="load only 32 samples per dataset (smoke test)")
    p.add_argument("--valid", action="store_true")
    p.add_argument("--predict", action="store_true")
    p.add_argument("--resize", type=str, default="")
    p.add_argument("--root", type=str, default=".",
                   help="experiment root (logs/ weights/ flows/)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--profile", type=str, default="",
                   help="record a torch.profiler trace over steps START,STOP "
                        "into <root>/profile (e.g. --profile 100,110)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain PyTorch versions of the kernels and must be "
                        "asked for)")
    p.add_argument("--device_cache", type=int, default=0,
                   help="keep N batches resident in device memory with "
                        "background refresh (bounded data echoing). 0 = "
                        "classic double-buffered prefetch")
    p.add_argument("--aug", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="where geometric augmentation runs: 'host' (numpy, "
                        "on the prefetch thread; color aug stays on device) "
                        "or 'device' (inside the train step). 'auto' picks "
                        "device when --device_cache is active (so echoed "
                        "batches get a fresh crop/affine draw every step) "
                        "and host otherwise")
    p.add_argument("--aug_sampler", type=str, default="affine",
                   choices=["affine", "twopass"],
                   help="the device geometric augmentation's sampler: "
                        "'affine' (bilinear) or 'twopass' (the JAX "
                        "package's TPU sampler: its augmented batches)")
    p.add_argument("--aug_label_dtype", type=str, default="float16",
                   choices=["float16", "float32"],
                   help="the dtype twopass samples the labels in")
    args = p.parse_args(argv)
    if args.aug == "auto":
        args.aug = "device" if args.device_cache else "host"
    return args


def build_settings(args, config, dataset_cfg):
    dataset = dataset_cfg.dataset.value
    orig_shape = dataset_cfg.orig_shape.get(list(presets.ORIG_SHAPE[dataset]))
    target_shape = dataset_cfg.target_shape.get(
        [s + (64 - s) % 64 for s in orig_shape])
    model_name = getattr(config.network, "class").get("MaskFlownet")
    model_cfg = ModelConfig(
        flow_multiplier=config.network.flow_multiplier.get(1.0),
        deform_bias=config.network.deform_bias.get(True),
        upfeat_ch=tuple(config.network.upfeat_ch.get([16, 16, 16, 16])))
    mw = config.network.mw.get([0.005, 0.01, 0.02, 0.08, 0.32])
    if len(mw) != 5:
        mw = [0.005, 0.01, 0.02, 0.08, 0.32]
    geo = presets.geometry_aug_config(dataset, target_shape, orig_shape)
    aug = getattr(args, "aug", "host")
    sampler = getattr(args, "aug_sampler", "affine")
    if sampler == "twopass" and aug == "host":
        raise ValueError("--aug_sampler twopass samples inside the train "
                         "step: it needs --aug device (or --device_cache)")
    return TrainSettings(
        model=model_name,
        model_cfg=model_cfg,
        q=config.optimizer.q.get(None),
        loss_weights=tuple(mw),
        fix_head=(model_name == "MaskFlownet"),
        compute_dtype=args.compute_dtype,
        target_shape=tuple(target_shape),
        orig_shape=tuple(orig_shape),
        geo=None if aug == "host" else geo,
        color=presets.color_aug_config(dataset),
        aug_sampler=sampler,
        aug_label_dtype=getattr(args, "aug_label_dtype", "float16"),
    ), geo


def _sintel_columns(entries):
    """(img1s, img2s, flows, masks) of Sintel training entries."""
    return [[sintel.load(p) for p in col] for col in zip(*entries)]


def load_training_data(args, dataset_cfg, batch_size):
    """Dataset branches of the reference training script
    (``main.py:192-365``).
    Returns (training_datasets, validation_datasets, orig_shape)."""
    name = dataset_cfg.dataset.value
    samples = 32 if args.debug else -1
    validation = {}

    if name == "chairs":
        orig_shape = presets.ORIG_SHAPE["chairs"]
        train_set, val_set = chairs.read_trainval()
        tr = chairs.load_set(train_set, samples=samples)
        train = [Dataset(tr)] * batch_size
        va = chairs.load_set(val_set, samples=samples)
        validation["chairs"] = (va[0], va[1], va[2], None)
        sd = sintel.list_data()
        divs = ("training",) if args.network != "MaskFlownet" else ("training2",)
        for div in divs:
            for k, ds in sd[div].items():
                ds = ds[:samples] if samples != -1 else ds
                if not ds:
                    continue
                validation["sintel." + k] = tuple(_sintel_columns(ds))

    elif name == "things3d":
        orig_shape = presets.ORIG_SHAPE["things3d"]
        sub_type = dataset_cfg.sub_type.get("clean")
        listing = things3d.list_data(sub_type=sub_type)
        sl = slice(None, samples if samples != -1 else None, args.shard)
        # lazy: the Dataset holds paths, and the loader's threads decode
        # them on demand through the bounded LRU of things3d.load (the
        # reference decodes the whole shard into RAM up front,
        # main.py:280-296)
        train = [Dataset((listing["image_0"][sl], listing["image_1"][sl],
                          listing["flow"][sl]), load=things3d.load)] \
            * batch_size
        _, val_set = chairs.read_trainval()
        va = chairs.load_set(val_set, samples=samples)
        validation["chairs"] = (va[0], va[1], va[2], None)

    elif name == "sintel":
        orig_shape = (436, 1024)
        num_kitti = dataset_cfg.kitti.get(0)
        num_hd1k = dataset_cfg.hd1k.get(0)
        subsets = ("training" if dataset_cfg.train_all.get(False)
                   else "training1", "training2")
        sd = sintel.list_data()
        cols = [[], [], [], []]
        for k, ds in sd[subsets[0]].items():
            ds = ds[:samples] if samples != -1 else ds
            for col, acc in zip(zip(*ds), cols):
                acc.extend(sintel.load(p) for p in col)
        train = [Dataset(tuple(cols))] * (batch_size - num_kitti - num_hd1k)
        resize = (1024, dataset_cfg.resize_shape.get(436))
        if num_kitti > 0:
            d = kitti.read_dataset(resize=resize,
                                   samples=None if samples == -1 else samples,
                                   editions="2015")
            train += [Dataset((d["image_0"], d["image_1"], d["flow"],
                               d["occ"]))] * num_kitti
        if num_hd1k > 0:
            d = hd1k.read_dataset(resize=resize, samples=samples)
            train += [Dataset((d["image_0"], d["image_1"], d["flow"],
                               d["occ"]))] * num_hd1k
        for k, ds in sd[subsets[1]].items():
            ds = ds[:samples] if samples != -1 else ds
            if not ds:
                continue
            validation["sintel." + k] = tuple(_sintel_columns(ds))

    elif name == "kitti":
        orig_shape = tuple(dataset_cfg.orig_shape.get([370, 1224]))
        resize = (orig_shape[1], orig_shape[0])
        parts = "mixed" if dataset_cfg.train_all.get(False) else "train"
        d = kitti.read_dataset(editions="mixed", parts=parts,
                               samples=None if samples == -1 else samples,
                               resize=resize)
        train = [Dataset((d["image_0"], d["image_1"], d["flow"],
                          d["occ"]))] * batch_size
        for ed in ("2012", "2015"):
            dv = kitti.read_dataset(editions=ed, parts="valid",
                                    samples=None if samples == -1 else samples,
                                    resize=resize)
            validation["kitti." + ed[-2:]] = (dv["image_0"], dv["image_1"],
                                              dv["flow"], dv["occ"])
    else:
        raise NotImplementedError(name)

    return train, validation, tuple(dataset_cfg.orig_shape.get(list(orig_shape)))


def run_validation(trainer, validation, batch_size, resize):
    out = {}
    for vname, (i1, i2, fl, mk) in validation.items():
        if vname.startswith("kitti"):
            # one inference sweep yields both metrics (the reference ran
            # the dataset twice, pipeline.py:176-184)
            epe, fl_all = trainer.validate(
                i1, i2, fl, mk, batch_size=batch_size, resize=resize,
                return_type="both")
            out[vname] = epe
            out[vname + ":kitti"] = fl_all
        else:
            out[vname] = trainer.validate(i1, i2, fl, mk,
                                          batch_size=batch_size,
                                          resize=resize, return_type="epe")
    return out


# (arg, default) pairs eligible for restore-from-log on resume; the first
# three define the model/data and conflict-abort when training.
_RESTORABLE_ARGS = (("config", None), ("dataset_cfg", "chairs.yaml"),
                    ("network", "MaskFlownet"), ("batch", None),
                    ("aug", "host"), ("compute_dtype", "bfloat16"),
                    ("aug_sampler", "affine"), ("aug_label_dtype", "float16"))


def _restore_args_from_log(args, log_file: str, strict: bool = True) -> None:
    """Recover experiment args recorded in the resumed run's log (the CLI
    logs ``k=v!r`` pairs at start). Reference parity: ``main.py:104-109``."""
    _, exp_info = read_log(log_file)
    if not exp_info:
        return
    old = exp_info[-1]
    conflicts = []
    for key, default in _RESTORABLE_ARGS:
        if key not in old:
            continue
        try:
            logged = ast.literal_eval(old[key])
        except (ValueError, SyntaxError):
            continue
        current = getattr(args, key)
        if current == logged:
            continue
        if current == default:
            print(f"Restored {key}={logged!r} from {log_file}")
            setattr(args, key, logged)
        elif key in ("config", "dataset_cfg", "network"):
            conflicts.append(f"{key}: log has {logged!r}, CLI has {current!r}")
    if conflicts and strict:
        raise SystemExit(
            "Resume args conflict with the original run (pass --clear_steps "
            "to start a new run from this checkpoint):\n  "
            + "\n  ".join(conflicts))


def _host_geometry_transform(geo_cfg, rank: int):
    """The ``--aug host`` transform of a loader batch: the numpy geometric
    augmentation of every sample from one RandomState (process ``rank``'s
    own), target-shape uint8 images, f16 flow and uint8 mask out."""
    from maskflownet_torch.augment.host_geometry import batch_host_geometry
    aug_rng = np.random.RandomState(1000 + rank)

    def transform(batch):
        img1, img2, flow, mask = with_mask(batch)
        mask = None if mask.shape[1] == 1 else \
            mask.astype(np.float32) / 255.0
        i1, i2, fl, mk = batch_host_geometry(
            aug_rng, img1.astype(np.float32), img2.astype(np.float32),
            flow.astype(np.float32), mask, geo_cfg)
        return (np.clip(i1 + 0.5, 0, 255).astype(np.uint8),
                np.clip(i2 + 0.5, 0, 255).astype(np.uint8),
                fl.astype(np.float16),
                np.clip(mk * 255 + 0.5, 0, 255).astype(np.uint8))

    return transform


def _validate_all(trainer, root, run_id, batch_size, infer_resize) -> None:
    """``--valid``: Sintel's training2 and training, KITTI 2012 and 2015."""
    log = FileLog(os.path.join(root, "logs", "val", f"{run_id}.val.log"),
                  screen=True)
    try:
        sd = sintel.list_data()
        for div in ("training2", "training"):
            for k, ds in sd[div].items():
                img1, img2, flow, mask = _sintel_columns(ds)
                epe = trainer.validate(img1, img2, flow, mask,
                                       batch_size=batch_size,
                                       resize=infer_resize)
                log.log(f"steps={trainer.steps}, sintel.{div}.{k}:epe={epe}")
        for ed in ("2012", "2015"):
            d = kitti.read_dataset(editions=ed, parts="mixed",
                                   resize=(1224, 370))
            args4 = (d["image_0"], d["image_1"], d["flow"], d["occ"])
            epe, fl = trainer.validate(*args4, batch_size=batch_size,
                                       resize=infer_resize,
                                       return_type="both")
            log.log(f"steps={trainer.steps}, kitti.{ed}:epe={epe}")
            log.log(f"steps={trainer.steps}, kitti.{ed}:kitti={fl}")
    finally:
        log.close()


class _Profile:
    """``--profile START,STOP``: a ``torch.profiler`` trace of the steps
    START..STOP, written as a Chrome trace into ``<root>/profile``."""

    def __init__(self, spec: str, root: str, run_id: str, device, log):
        self.range = tuple(int(s) for s in spec.split(",")) if spec else None
        self.dir = os.path.join(root, "profile")
        self.run_id, self.device, self.log = run_id, device, log
        self.prof = None

    def before_step(self, step: int) -> None:
        if self.range and step == self.range[0]:
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU] + (
                [tp.ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [])
            try:
                self.prof = tp.profile(activities=acts)
                self.prof.start()
            except Exception as e:  # the machine may not allow tracing
                self.log.log(f"profiler unavailable: {e}")
                self.range = self.prof = None

    def after_step(self, step: int, metrics) -> None:
        if self.range and self.prof is not None and step == self.range[1]:
            sync_metrics(metrics)
            self.prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(
                self.dir, f"{self.run_id}_{self.range[0]}-{step}.json"))
            self.log.log(f"profiler trace written to {self.dir}")
            self.range = self.prof = None


def main(argv=None):
    args = parse_args(argv)
    device = get_device(args.device)
    processes = int(os.environ.get("MFN_NUM_PROCESSES", "1"))
    initialize_distributed(os.environ.get("MFN_COORDINATOR"), processes,
                           int(os.environ.get("MFN_PROCESS_ID", "0")),
                           backend=os.environ.get("MFN_DIST_BACKEND"),
                           device=device)
    try:
        return _main(args, make_mesh(device))
    finally:
        if processes > 1:
            shutdown_distributed()


def _main(args, mesh):
    device, rank = mesh.device, mesh.rank

    root = args.root
    for d in ("logs", os.path.join("logs", "val"), os.path.join("logs", "debug"),
              "weights", "flows"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    # checkpoint resolution (reference main.py:79-116)
    steps = 0
    checkpoint = None
    if args.checkpoint is not None:
        prefix, _, want = args.checkpoint.partition(":")
        log_file, run_id = find_log(root, prefix)
        cks = find_checkpoints(root, run_id)
        if want:
            match = [c for c in cks if c[1] == int(want)]
            if not match:
                raise SystemExit(f"steps {want} not found in {cks}")
            checkpoint, steps = match[0]
        else:
            checkpoint, steps = cks[-1]
        if args.clear_steps:
            steps = 0
        else:
            # restore experiment args from the old run's log (reference
            # main.py:104-109 + path.py:33-53): args the user left at their
            # defaults are adopted from the log; an explicit conflict on a
            # model/data-defining arg aborts instead of silently diverging.
            _restore_args_from_log(args, log_file,
                                   strict=not (args.valid or args.predict))
    if args.checkpoint is None or args.clear_steps:
        _, run_id = generate_run_id(str(mesh.world))

    config = load_config(args.config)
    dataset_cfg = load_config(args.dataset_cfg)
    validation_steps = dataset_cfg.validation_steps.get(2500)
    checkpoint_steps = dataset_cfg.checkpoint_steps.get(5000)

    dataset_name = dataset_cfg.dataset.value
    batch_size = args.batch or presets.BATCH_SIZE[dataset_name]
    if batch_size % mesh.world:
        raise SystemExit(
            f"global batch {batch_size} must be divisible by the process "
            f"count {mesh.world} (cf. reference main.py:371)")
    settings, geo_cfg = build_settings(args, config, dataset_cfg)
    trainer = Trainer(settings, mesh=mesh)

    if checkpoint is not None:
        print(f"Load checkpoint {checkpoint}")
        network_class = getattr(config.network, "class").get("MaskFlownet")
        if (network_class == "MaskFlownet" and args.clear_steps
                and dataset_name == "chairs"):
            trainer.load_head(checkpoint)
        else:
            trainer.load(checkpoint, load_states=not (
                args.valid or args.predict or args.clear_steps))
        trainer.steps = steps

    infer_resize = tuple(int(s) for s in args.resize.split(",")) if args.resize else None

    if (args.predict or args.valid) and rank:
        return 0                  # process 0 writes the files and the log
    if args.predict:
        from maskflownet_torch.tools import submission
        ck_name = os.path.basename(checkpoint).replace(".npz", "")
        submission.predict_all(trainer, os.path.join(root, "flows", ck_name),
                               batch_size=batch_size, resize=infer_resize)
        return 0

    if args.valid:
        _validate_all(trainer, root, run_id, batch_size, infer_resize)
        return 0

    # ---- training ----
    t0 = default_timer()
    train_datasets, validation, orig_shape = load_training_data(
        args, dataset_cfg, batch_size)
    print(f"Loaded data in {default_timer() - t0:.1f}s")

    # this process's slots of the global batch, and its shard of every
    # dataset's epochs
    local = batch_sharding(mesh, batch_size)
    loader = TrainLoader(train_datasets[local], local.stop - local.start,
                         settings.orig_shape, seed=rank, shard_index=rank,
                         num_shards=mesh.world)
    # with --aug host the numpy geometric augmentation runs on the
    # prefetch thread and ships target-shape uint8 crops
    transform = (_host_geometry_transform(geo_cfg, rank)
                 if settings.geo is None else with_mask)
    try:
        if args.device_cache:
            prefetch = DeviceBatchCache(loader.get, device=device,
                                        slots=args.device_cache,
                                        transform=transform)
        else:
            prefetch = DevicePrefetcher(loader.get, device=device, depth=2,
                                        transform=transform)
    except BaseException:
        loader.stop()
        raise

    log = NullLog() if rank else FileLog(os.path.join(
        root, "logs", "debug" if args.debug else "", f"{run_id}.log"))
    log.log(f"start={trainer.steps}, train={sum(len(d) for d in train_datasets)}, "
            f"batch={batch_size}, devices={mesh.world}")
    log.log(", ".join(f"{k}={v!r}" for k, v in vars(args).items()))

    lr_schedule = dataset_cfg.optimizer.learning_rate.get(None) \
        or config.optimizer.learning_rate.value
    train_avg = DictMovingAverage()
    loading_time = MovingAverage()
    total_time = MovingAverage()
    checkpoints: list[str] = []
    remove_queue: Queue = Queue(maxsize=50)

    def remove_files():
        while (f := remove_queue.get()) is not None:
            try:
                os.remove(f)
            except OSError as e:
                log.log(f"Remove failed: {e}")

    remover = threading.Thread(target=remove_files, daemon=True)
    remover.start()
    profile = _Profile(args.profile if rank == 0 else "", root, run_id,
                       device, log)

    def _train_loop():
        t1 = None
        while True:
            profile.before_step(trainer.steps + 1)
            lr = lr_at_step(lr_schedule, trainer.steps + 1)
            if lr is None:
                log.log(f"schedule exhausted at step {trainer.steps}")
                return 0
            t0 = default_timer()
            if t1:
                total_time.update(t0 - t1)
            t1 = t0
            batch = prefetch.get()
            loading_time.update(default_timer() - t0)
            metrics = trainer.train_batch_device(batch, lr=lr)
            steps = trainer.steps
            profile.after_step(steps, metrics)
            if rank == 0 and (steps <= 20 or steps % 50 == 0):
                train_avg.update(sync_metrics(metrics))
                log.log("steps={}{}, loading_time={:.3f}, total_time={:.3f}".format(
                    steps, "".join(f", {k}={v}" for k, v in
                                   train_avg.average.items()),
                    loading_time.average, total_time.average))
            if steps % validation_steps == 0 or steps <= 1:
                if validation:
                    val = run_validation(trainer, validation, batch_size,
                                         infer_resize)
                    log.log("steps={}{}".format(
                        steps, "".join(f", {k}={v}" for k, v in val.items())))
                if steps % checkpoint_steps == 0 and rank == 0:
                    prefix = os.path.join(root, "weights", f"{run_id}_{steps}")
                    trainer.save(prefix)
                    checkpoints.append(prefix)
                    while len(checkpoints) > 3:
                        old = checkpoints.pop(0)
                        remove_queue.put(old + ".npz")

    try:
        return _train_loop()
    finally:
        # the consumers first: a refresh or prefetch thread may be waiting
        # on the loader
        prefetch.stop()
        loader.stop()
        remove_queue.put(None)
        remover.join()
        log.close()


if __name__ == "__main__":
    sys.exit(main())
