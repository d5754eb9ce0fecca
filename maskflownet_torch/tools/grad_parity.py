"""How far one f32 train step's gradients on the card lie from the CPU's,
and why.

    python -m maskflownet_torch.tools.grad_parity [--model MaskFlownet]
        [--deform kernel|warpconv] [--seeds 4] [--runs 3] [--out PATH]

For each seed: seeded weights (``init_params(seed)``) and a synthetic
64x128 pair, the size of chip_smoke's card-vs-CPU steps (image 2 is
image 1 moved by (3, -2) pixels, label that flow); the frozen-head step
(``fix_head``) for the cascade, the plain step for MaskFlownet_S. The step's loss and gradients are taken once on the
CPU, then ``--runs`` times on the card in each of three modes: PyTorch's
defaults, ``cudnn.deterministic``, and ``use_deterministic_algorithms``
(cuDNN, cuBLAS and PyTorch's own kernels, such as the interpolation's
backward, without atomics where they have a deterministic form; TF32 off
throughout). Each card run is compared with

* the CPU step: the loss's relative difference and the worst parameter's
  ``|dgrad| / |grad|``, by name, with that parameter's ``|grad|``;
* the CPU step replayed with the card's branches: every value at which
  the step picks a branch -- a deformable conv's sample coordinate (its
  floor), a LeakyReLU's input, a cost volume's output (the side of its
  fused LeakyReLU) -- takes the card's value where the two devices fall
  on different sides (a coordinate takes it always), the gradient through
  it unchanged;
* the card's first run in the same mode (is the card repeatable?).

It also counts the branches that differ between card and CPU, and the
smallest distance of a CPU coordinate to an integer. A branch is a kink:
a value within rounding of it lands on either side on the two devices,
and the gradient behind it jumps by the whole difference of the two
slopes (1 against 0.1 for a LeakyReLU; the floor-based flow gradient
changes cell at an integer); the replay takes that out and leaves the
summation order. Prints a line per run and writes every reading as JSON
to ``--out`` (default ``build/grad_parity.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
from pathlib import Path
from unittest import mock

import torch

import maskflownet_torch.ops.correlation as corr_module
import maskflownet_torch.ops.deform as deform_module
from maskflownet_torch import nn as tnn
from maskflownet_torch.models import ModelConfig, init_params
from maskflownet_torch.training import TrainSettings, Trainer


HW = (64, 128)


def shifted_batch(seed: int, hw, shift=(3, -2)):
    """One smooth random image pair in [0, 255], image 2 image 1 moved by
    the integer flow ``shift`` = (dy, dx); the label is that flow."""
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    m = 8
    coarse = torch.rand((1, 3, (h + 2 * m) // 8, (w + 2 * m) // 8),
                        generator=gen)
    big = 255 * torch.nn.functional.interpolate(
        coarse, size=(h + 2 * m, w + 2 * m), mode="bilinear",
        align_corners=False)
    img1 = big[:, :, m:m + h, m:m + w].contiguous()
    img2 = big[:, :, m - shift[0]:m - shift[0] + h,
               m - shift[1]:m - shift[1] + w].contiguous()
    flow = torch.tensor(shift, dtype=torch.float32)[None, :, None, None]
    return img1, img2, flow.expand(1, 2, h, w).contiguous()


def branches(device_type: str, replay):
    """Patches that record, in call order, every value at which the step
    picks a branch -- each deformable conv's sample coordinates (their
    floor), each LeakyReLU's input and each cost volume's output (its
    fused LeakyReLU's side) -- as CPU tensors into the returned dict; with
    ``replay`` (such a dict from another run, or some of its keys), each
    value whose branch differs takes the replayed value instead (the
    coordinates take it everywhere), the gradient through it unchanged.
    Returns the dict and the patches to enter."""
    seen = {"coords": [], "leaky": [], "corr": []}
    replay = replay or {}
    it = {k: iter(v) for k, v in replay.items()}

    def pick(key, x, side):
        """x, or where its side differs from the replayed one's, that."""
        seen_x = x
        if key in replay:
            r = next(it[key]).to(x.device)
            x = x + (torch.where(side(r) != side(x), r, x) - x).detach()
        seen[key].append(seen_x.detach().cpu())
        return x

    real_grid = deform_module.base_grid

    def grid(flow, offset=0.0):
        sy, sx = real_grid(flow, offset)
        if "coords" in replay:
            ry, rx = (t.to(sy.device) for t in next(it["coords"]))
            sy = sy + (ry - sy).detach()
            sx = sx + (rx - sx).detach()
        seen["coords"].append((sy.detach().cpu(), sx.detach().cpu()))
        return sy, sx

    real_leaky = tnn.leaky_relu

    def leaky(x, slope=0.1):
        return real_leaky(pick("leaky", x, lambda t: t > 0), slope)

    name = "corr_fwd" if device_type == "cuda" else "correlation_plain"
    real_corr = getattr(corr_module, name)

    def corr(*args):
        return pick("corr", real_corr(*args), lambda t: t >= 0)

    # the kernel's wrapper counts its launches under its module name: the
    # spy's while it stands there
    corr.launches = getattr(real_corr, "launches", 0)
    patches = (mock.patch.object(deform_module, "base_grid", grid),
               mock.patch.object(tnn, "leaky_relu", leaky),
               mock.patch.object(corr_module, name, corr))
    return seen, patches


def step(trainer, batch, replay=None, draws=None):
    """(loss, {name: grad on the CPU}, the branch values of
    :func:`branches`) of one step (no update; a frozen parameter has no
    gradient), replaying ``replay``'s branches if given; ``draws`` as
    ``Trainer.loss`` takes them."""
    seen, patches = branches(batch[0].device.type, replay)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        loss, _ = trainer.loss(*batch, draws=draws)
        loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in trainer.params.items()
             if p.grad is not None}
    trainer.opt.zero_grad(set_to_none=True)
    return loss.item(), grads, seen


def worst(got, want):
    """The worst parameter's ``|dgrad| / |grad|``, its name and its
    ``|grad|``."""
    return max((((got[k] - want[k]).norm() / want[k].norm()).item(), k,
                want[k].norm().item())
               for k in want if want[k].norm() > 0)


MODES = ("default", "cudnn.deterministic", "deterministic algorithms")


def set_mode(mode: str) -> None:
    torch.backends.cudnn.deterministic = mode != "default"
    torch.use_deterministic_algorithms(mode == "deterministic algorithms",
                                       warn_only=True)


def flips(card, cpu):
    """How many branches differ between two steps' branch values: floors of
    the coordinates, sides of the LeakyReLUs and of the cost volumes'."""
    return {
        "floor": sum(int((torch.floor(a) != torch.floor(b)).sum())
                     for pa, pb in zip(card["coords"], cpu["coords"])
                     for a, b in zip(pa, pb)),
        "leaky": sum(int(((a > 0) != (b > 0)).sum())
                     for a, b in zip(card["leaky"], cpu["leaky"])),
        "corr": sum(int(((a >= 0) != (b >= 0)).sum())
                    for a, b in zip(card["corr"], cpu["corr"]))}


def nearest_integer(coords) -> float:
    return min(float((c - torch.round(c)).abs().min())
               for pair in coords for c in pair)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="MaskFlownet",
                    choices=("MaskFlownet_S", "MaskFlownet"))
    ap.add_argument("--deform", default="kernel",
                    choices=("kernel", "warpconv"))
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="build/grad_parity.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_parity: needs a CUDA card")
    # cuBLAS is deterministic under use_deterministic_algorithms only with
    # a fixed workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    settings = TrainSettings(model=args.model,
                             fix_head=args.model == "MaskFlownet",
                             compute_dtype="float32",
                             model_cfg=ModelConfig(deform=args.deform))
    rows = []
    for seed in range(args.seeds):
        params = init_params(seed, model=args.model)
        batch = shifted_batch(seed, HW)
        cpu_trainer = Trainer(settings, device="cpu", params=params)
        cpu_loss, cpu_grads, cpu_seen = step(cpu_trainer, batch)
        card_trainer = Trainer(settings, device="cuda", params=params)
        cuda_batch = [t.cuda() for t in batch]
        for mode in MODES:
            set_mode(mode)
            first = None
            for run in range(args.runs):
                loss, grads, seen = step(card_trainer, cuda_batch)
                r_loss, r_grads, _ = step(cpu_trainer, batch, seen)
                err, name, norm = worst(grads, cpu_grads)
                r_err, r_name, _ = worst(grads, r_grads)
                first = first or grads
                self_err, self_name, _ = worst(grads, first)
                row = dict(seed=seed, mode=mode, run=run,
                           loss_rel=abs(loss - cpu_loss) / abs(cpu_loss),
                           worst=err, worst_param=name,
                           worst_param_grad_norm=norm,
                           replay_worst=r_err, replay_worst_param=r_name,
                           replay_loss_rel=abs(loss - r_loss) / abs(r_loss),
                           vs_first_run=self_err,
                           vs_first_run_param=self_name,
                           flips=flips(seen, cpu_seen),
                           nearest_integer=nearest_integer(
                               cpu_seen["coords"]))
                rows.append(row)
                print(json.dumps(row), flush=True)
        del cpu_trainer, card_trainer
    set_mode("default")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, model=args.model,
                                   deform=args.deform, hw=list(HW),
                                   rows=rows), indent=1))
    flipped = [r for r in rows if any(r["flips"].values())]
    for mode in MODES:
        mine = [r for r in rows if r["mode"] == mode]
        print(f"grad_parity {args.model} deform={args.deform} {HW}, "
              f"{mode}: {len(mine)} card runs, worst |dgrad|/|grad| vs CPU "
              f"{max(r['worst'] for r in mine):.3e}, vs the CPU replaying "
              f"the card's branches "
              f"{max(r['replay_worst'] for r in mine):.3e}; "
              f"{sum(1 for r in mine if r in flipped)} runs with a flipped "
              f"branch; "
              f"worst vs the card's first run "
              f"{max(r['vs_first_run'] for r in mine):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
