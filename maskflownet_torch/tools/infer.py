"""Standalone inference tool: the port of ``maskflownet_tpu/tools/infer.py``
(reference ``predict_new_data.py``). Flow for an image pair, a directory
of frames or a video, with the colour-wheel visualisation.

Usage:
  python -m maskflownet_torch.tools.infer CONFIG -c CHECKPOINT.npz \\
      [-i img1 img2] [--frames dir] [--video in.mp4 out.mp4] \\
      [--batch N] [-o out_dir] [--resize H,W] [--device cuda|cpu]

``CHECKPOINT.npz`` is a v1 checkpoint of either package (a training run's,
or ``tools.import_mxnet``'s from a published ``.params`` file). The model
runs in bf16 on the card (``--device``, default ``cuda``; ``--device cpu``
runs the plain PyTorch path).

* ``-i``: ``flow.flo`` (u, v), ``flow.png`` (the colour wheel) and
  ``warped.png`` (image 2 warped by the flow) in the output directory;
* ``--frames``: ``<frame>_flow.png`` for each consecutive pair of the
  directory's frames (in name order), ``--batch`` pairs at a time;
* ``--video``: a flow-visualisation video at the source's fps
  (``predict_new_data.py:100-162``). Video IO needs OpenCV (``cv2``),
  imported only here; without it ``--video`` raises ``ImportError`` and
  ``--frames`` is the route without dependencies.

PNGs are written by ``data.codecs.png8_save`` and read by
``data.codecs.image_load`` (no image library needed).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_trainer(config_name: str, checkpoint: str,
                 compute_dtype: str = "bfloat16", device: str = "cuda"):
    """A ``Trainer`` with the network config's model and the checkpoint's
    parameters (no optimizer state), built as the training CLI builds it."""
    from maskflownet_torch.cli.main import build_settings, parse_args
    from maskflownet_torch.config import load_config
    from maskflownet_torch.training import Trainer

    args = parse_args([config_name])
    args.compute_dtype = compute_dtype
    config = load_config(config_name)
    dataset_cfg = load_config("sintel.yaml")
    settings, _ = build_settings(args, config, dataset_cfg)
    trainer = Trainer(settings, device=device)
    trainer.load(checkpoint, load_states=False)
    return trainer


def predict_image_pair_flow(trainer, img1: np.ndarray, img2: np.ndarray,
                            resize=None):
    """img1/img2: (H, W, 3) uint8 RGB -> (flow (dy, dx), occ, warped)."""
    gen = trainer.predict([img1], [img2], batch_size=1, resize=resize)
    return next(gen)


def predict_frame_sequence(trainer, frames: list[np.ndarray], resize=None,
                           batch_size: int = 4):
    """Consecutive-frame flow for a frame list (``predict_new_data.py:
    100-122``)."""
    return [flow for flow, _, _ in trainer.predict(
        frames[:-1], frames[1:], batch_size=batch_size, resize=resize)]


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "--video needs OpenCV (cv2), which is not installed here; "
            "--frames DIR takes a directory of frames without it") from e
    return cv2


def read_video(path: str) -> tuple[list[np.ndarray], float]:
    """Decode a video into RGB uint8 frames and its fps (OpenCV,
    ``predict_new_data.py:101-116``)."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    while True:
        has, frame = cap.read()
        if not has:
            break
        frames.append(frame[..., ::-1].copy())  # BGR -> RGB
    cap.release()
    if len(frames) < 2:
        raise ValueError(f"{path}: need >=2 frames, got {len(frames)}")
    return frames, fps


def write_video(path: str, frames_rgb: list[np.ndarray], fps: float) -> None:
    """Encode RGB uint8 frames (``predict_new_data.py:94-97, 160``)."""
    cv2 = _cv2()
    h, w = frames_rgb[0].shape[:2]
    fourcc = cv2.VideoWriter_fourcc(
        *("mp4v" if path.lower().endswith(".mp4") else "MJPG"))
    out = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not out.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    for fr in frames_rgb:
        out.write(np.ascontiguousarray(fr[..., ::-1]))  # RGB -> BGR
    out.release()


def predict_video_flow(trainer, video_in: str, video_out: str, resize=None,
                       batch_size: int = 4) -> int:
    """Video -> flow-visualisation video; returns the number of flow
    frames."""
    from maskflownet_torch.tools.flow_vis import flow_to_color

    frames, fps = read_video(video_in)
    flows = predict_frame_sequence(trainer, frames, resize=resize,
                                   batch_size=batch_size)
    write_video(video_out, [flow_to_color(f) for f in flows], fps)
    return len(flows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", type=str)
    p.add_argument("-c", "--checkpoint", type=str, required=True)
    p.add_argument("-i", "--images", type=str, nargs=2, default=None)
    p.add_argument("--frames", type=str, default=None,
                   help="directory of ordered frames")
    p.add_argument("--video", type=str, nargs=2, default=None,
                   metavar=("IN", "OUT"),
                   help="video in -> flow-visualization video out")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("-o", "--output", type=str, default="./flow_out")
    p.add_argument("--resize", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path and must be asked for)")
    args = p.parse_args(argv)
    if not (args.images or args.frames or args.video):
        p.error("need -i, --frames or --video")
    if not (args.images or args.frames):
        _cv2()                  # --video: before the model is built

    from maskflownet_torch.data import codecs
    from maskflownet_torch.tools.flow_vis import flow_to_color

    resize = tuple(int(s) for s in args.resize.split(",")) if args.resize \
        else None
    trainer = load_trainer(args.config, args.checkpoint, device=args.device)
    os.makedirs(args.output, exist_ok=True)

    if args.images:
        img1 = codecs.image_load(args.images[0])
        img2 = codecs.image_load(args.images[1])
        flow, occ, warped = predict_image_pair_flow(trainer, img1, img2,
                                                    resize)
        codecs.flo_save(flow[..., ::-1], os.path.join(args.output,
                                                      "flow.flo"))
        codecs.png8_save(flow_to_color(flow),
                         os.path.join(args.output, "flow.png"))
        codecs.png8_save((np.clip(warped, 0, 1) * 255).astype(np.uint8),
                         os.path.join(args.output, "warped.png"))
        print(f"wrote flow.flo / flow.png / warped.png to {args.output}")
    elif args.frames:
        names = sorted(os.listdir(args.frames))
        frames = [codecs.image_load(os.path.join(args.frames, n))
                  for n in names]
        flows = predict_frame_sequence(trainer, frames, resize,
                                       batch_size=args.batch)
        for name, flow in zip(names, flows):
            codecs.png8_save(flow_to_color(flow), os.path.join(
                args.output, os.path.splitext(name)[0] + "_flow.png"))
        print(f"wrote {len(flows)} flow visualizations to {args.output}")
    else:
        n = predict_video_flow(trainer, args.video[0], args.video[1],
                               resize=resize, batch_size=args.batch)
        print(f"wrote {n} flow frames to {args.video[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
