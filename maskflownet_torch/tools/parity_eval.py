"""One-command evaluation against the published table: the port of
``maskflownet_tpu/tools/parity_eval.py``.

Given dataset roots (``MFN_SINTEL_ROOT``/``MFN_KITTI_ROOT`` or flags) and a
checkpoint -- a published MXNet ``.params`` file or a v1 ``.npz`` -- this
runs the reference's evaluation protocol (its ``main.py --valid`` branch)
and prints the table of the reference's ``weights/README.md`` with a
pass/fail verdict at a relative bound (default 2%):

    python -m maskflownet_torch.tools.parity_eval \\
        dbbSep30-1206_1000000.params --expect dbbSep30 [--device cpu]

Rows whose dataset is absent are reported SKIPPED instead of failing, so
the harness runs on a partial mount. The exit status is 0 when every
computed row with a reference passes, 1 when one fails and 2 when nothing
could be computed.

Protocol:
- Sintel *val* = the ``training2`` split at the native 436x1024, padded to
  multiples of 64 for inference (``resize=None``); Sintel *train+val* =
  the whole ``training`` enumeration (only ``abbSep15`` publishes it).
- KITTI 2012/2015 = ``parts='mixed'`` read-resized to 1224x370, EPE and
  Fl-all from one inference sweep (``Trainer.validate(return_type=
  'both')``).
- ``.params`` checkpoints go through ``tools.import_mxnet`` with its
  strict shape validation; ``--input_channel_order bgr`` adapts
  checkpoints trained on BGR frames (see that module's docstring).
- One device: the card (``--device``, default ``cuda``) or the CPU.
"""

from __future__ import annotations

import json
import os

# the reference's weights/README.md, transcribed in BASELINE.md; metric ->
# published value
EXPECTED = {
    "abbSep15": {
        "network": "MaskFlownet_S",
        "sintel.trainval.clean": 2.33, "sintel.trainval.final": 3.72,
        "sintel.val.clean": 2.93, "sintel.val.final": 5.35,
        "kitti.2012.epe": 4.69, "kitti.2012.fl": 0.20,
        "kitti.2015.epe": 11.88, "kitti.2015.fl": 0.29,
    },
    "dbbSep30": {
        "network": "MaskFlownet_S",
        "sintel.val.clean": 2.70, "sintel.val.final": 4.07,
        "kitti.2012.epe": 3.25, "kitti.2012.fl": 0.11,
        "kitti.2015.epe": 9.14, "kitti.2015.fl": 0.18,
    },
    "5adNov03": {
        "network": "MaskFlownet",
        "sintel.val.clean": 2.52, "sintel.val.final": 3.83,
        "kitti.2012.epe": 2.85, "kitti.2012.fl": 0.10,
        "kitti.2015.epe": 8.15, "kitti.2015.fl": 0.17,
    },
}


def load_trainer(checkpoint: str, network: str, compute_dtype: str = "float32",
                 input_channel_order: str = "rgb", device: str = "cuda"):
    """An evaluation ``Trainer`` on ``device`` holding the checkpoint's
    parameters."""
    from maskflownet_torch.training import Trainer, TrainSettings

    settings = TrainSettings(model=network, compute_dtype=compute_dtype,
                             target_shape=(64, 64), orig_shape=(64, 64),
                             geo=None, color=None)
    if checkpoint.endswith(".params"):
        from maskflownet_torch.tools.import_mxnet import import_checkpoint
        params = import_checkpoint(checkpoint, network,
                                   input_channel_order=input_channel_order)
        return Trainer(settings, device=device, params=params)
    trainer = Trainer(settings, device=device)
    trainer.load(checkpoint, load_states=False)
    return trainer


def eval_sintel(trainer, division: str, batch_size: int, samples=None,
                root=None, split_file=None) -> dict[str, float]:
    """division: 'training2' (val) or 'training' (train+val). Returns
    {'clean': epe, 'final': epe}."""
    from maskflownet_torch.data import sintel

    listed = sintel.list_data(root=root, split_file=split_file)[division]
    out = {}
    for subset in ("clean", "final"):
        entries = listed[subset][:samples] if samples else listed[subset]
        if not entries:
            raise FileNotFoundError(f"no sintel {division}/{subset} pairs")
        img1, img2, flow, mask = [[sintel.load(p) for p in col]
                                  for col in zip(*entries)]
        out[subset] = trainer.validate(img1, img2, flow, mask,
                                       batch_size=batch_size,
                                       return_type="epe")
    return out


def eval_kitti(trainer, edition: str, batch_size: int, samples=None,
               root=None, resize=(1224, 370)) -> tuple[float, float]:
    """(epe, fl_all) over parts='mixed' read-resized to ``resize`` (width,
    height; the protocol's 1224x370 unless a test shrinks it), one
    inference sweep."""
    from maskflownet_torch.data import kitti

    path = kitti.default_paths(root) if root else None
    d = kitti.read_dataset(path=path, editions=edition, parts="mixed",
                           resize=resize, samples=samples)
    if not d["image_0"]:
        raise FileNotFoundError(f"no kitti {edition} pairs")
    return trainer.validate(d["image_0"], d["image_1"], d["flow"], d["occ"],
                            batch_size=batch_size, return_type="both")


def run(checkpoint: str, expect: str | None = None, network: str | None = None,
        batch_size: int = 4, bound: float = 0.02, samples: int | None = None,
        compute_dtype: str = "float32", input_channel_order: str = "rgb",
        sintel_root=None, sintel_split=None, kitti_root=None,
        kitti_resize=(1224, 370),
        rows: tuple[str, ...] = ("sintel.trainval", "sintel.val",
                                 "kitti.2012", "kitti.2015"),
        device: str = "cuda") -> dict:
    """Evaluate and compare. Returns the summary (also printed)."""
    ref = EXPECTED.get(expect, {}) if expect else {}
    if network is None:
        network = ref.get("network")
    if network is None:
        for name, row in EXPECTED.items():
            if name in os.path.basename(checkpoint):
                network, ref, expect = row["network"], row, name
                break
    if network is None:
        network = "MaskFlownet_S"
    if ref:
        # only the rows the expectation publishes
        rows = tuple(r for r in rows if any(k.startswith(r) for k in ref))

    trainer = load_trainer(checkpoint, network, compute_dtype,
                           input_channel_order, device)
    results: dict[str, float] = {}
    skipped: dict[str, str] = {}
    for row in rows:
        try:
            if row in ("sintel.val", "sintel.trainval"):
                division = "training2" if row == "sintel.val" else "training"
                got = eval_sintel(trainer, division, batch_size, samples,
                                  sintel_root, sintel_split)
                results.update({f"{row}.{k}": v for k, v in got.items()})
            else:                                   # kitti.<edition>
                epe, fl = eval_kitti(trainer, row.split(".")[1], batch_size,
                                     samples, kitti_root, resize=kitti_resize)
                results[f"{row}.epe"] = epe
                results[f"{row}.fl"] = fl
        except (FileNotFoundError, NotADirectoryError, OSError) as e:
            skipped[row] = str(e)

    verdicts = {}
    for key, got in results.items():
        if key in ref:
            want = ref[key]
            ok = abs(got - want) <= bound * want
            verdicts[key] = {"got": got, "ref": want, "pass": bool(ok)}

    hdr = f"{'metric':<24}{'got':>10}{'ref':>10}  verdict"
    print(hdr + "\n" + "-" * len(hdr))
    for key in sorted(results):
        v = verdicts.get(key)
        if v:
            mark = "PASS" if v["pass"] else "FAIL"
            print(f"{key:<24}{v['got']:>10.4f}{v['ref']:>10.4f}  {mark}"
                  f" (bound {bound:.0%})")
        else:
            print(f"{key:<24}{results[key]:>10.4f}{'-':>10}  (no reference)")
    for row, why in skipped.items():
        print(f"{row:<24}{'-':>10}{'-':>10}  SKIPPED: data not mounted "
              f"({why.splitlines()[0][:60]})")

    n_fail = sum(not v["pass"] for v in verdicts.values())
    summary = {
        "checkpoint": checkpoint, "network": network, "expect": expect,
        "bound": bound, "results": results,
        "verdicts": verdicts, "skipped": sorted(skipped),
        "n_fail": n_fail,
        "status": ("fail" if n_fail else
                   "pass" if verdicts else
                   "computed" if results else "no-data"),
    }
    print(json.dumps(summary))
    return summary


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint",
                   help="MXNet .params or v1 .npz checkpoint")
    p.add_argument("--expect", choices=sorted(EXPECTED) + ["none"],
                   default=None,
                   help="published row to compare against (auto-detected "
                        "from the checkpoint filename when possible; 'none' "
                        "evaluates without comparing)")
    p.add_argument("--network", default=None,
                   choices=["MaskFlownet_S", "MaskFlownet"])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--bound", type=float, default=0.02,
                   help="relative pass bound vs the reference value")
    p.add_argument("--samples", type=int, default=None,
                   help="cap pairs per row (smoke runs)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--input_channel_order", default="rgb",
                   choices=["rgb", "bgr"])
    p.add_argument("--sintel_root", default=None)
    p.add_argument("--sintel_split", default=None)
    p.add_argument("--kitti_root", default=None)
    p.add_argument("--rows", default=None,
                   help="comma list from: sintel.trainval,sintel.val,"
                        "kitti.2012,kitti.2015")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path and must be asked for)")
    args = p.parse_args(argv)

    kw = {}
    if args.rows:
        kw["rows"] = tuple(args.rows.split(","))
    summary = run(args.checkpoint,
                  expect=None if args.expect == "none" else args.expect,
                  network=args.network, batch_size=args.batch,
                  bound=args.bound, samples=args.samples,
                  compute_dtype=args.compute_dtype,
                  input_channel_order=args.input_channel_order,
                  sintel_root=args.sintel_root, sintel_split=args.sintel_split,
                  kitti_root=args.kitti_root, device=args.device, **kw)
    if summary["status"] == "fail":
        return 1
    if summary["status"] == "no-data":
        print("parity_eval: no dataset could be read -- mount the data or "
              "set MFN_SINTEL_ROOT / MFN_KITTI_ROOT")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
