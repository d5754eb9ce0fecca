"""Spatial (H-axis) sharding of the port on the CPU: gloo ranks spawned
once for the module, a world of 2 (the (1, 2) mesh) and one of 4 (the
(2, 2) mesh) at once, against the port's unsharded forward, which
``tests/test_torch_model.py`` and ``tests/test_torch_cascade.py`` hold
against the JAX package's. No JAX model is built or compiled.

* The row exchange (``parallel/spatial.py::RowShard``) against slices of
  the whole tensor, bitwise: halos with zero rows past the image's
  edges, with its edge rows (``clamp``), reaching past the next rank
  (a 5-row halo of 2-row shards over 4 ranks), the whole-height gather;
  and its gradient against the gradient of the same slices.
* The MaskFlownet_S forward on meshes (1, 2) and (2, 2) and the cascade's
  on (1, 2), 256x128, batch 2, f32: the full-resolution flow and the
  occlusion mask (the cascade: its visual) within 1e-4 px (1e-5 of the
  mask) plus 1e-5 relative of the unsharded forward's -- f32 sums taken
  in other orders (the halo tiles, the all-reduced mean colour).
* Gradients through the sharded S forward on (1, 2): a squared error
  against a random target, each rank's part of it backpropagated through
  the exchanges, the parameters' gradients summed over the ranks, each
  within 1e-5 of the unsharded gradient's norm. In f64: in f32 a value
  within rounding of a kink (a LeakyReLU's 0, a sample coordinate's
  integer) falls on different sides in the two forwards and moves a
  gradient by up to ~2e-3 of its norm (at this size on the CPU), which says
  nothing of the exchanges; the flow stays f32 inside the model
  (``.float()``), hence not 1e-12.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from maskflownet_torch import nn
from maskflownet_torch.inference import centralize
from maskflownet_torch.models import ModelConfig, build_model, init_params
from maskflownet_torch.ops.resample import upsample
from maskflownet_torch.parallel import (initialize_distributed,
                                        make_spatial_forward,
                                        make_spatial_mesh,
                                        shutdown_distributed)
from maskflownet_torch.parallel.spatial import RowShard, SpatialMesh

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
B, H, W = 2, 256, 128
CFG = ModelConfig()
FLOW_ATOL, OCC_ATOL, RTOL, GRAD_RTOL = 1e-4, 1e-5, 1e-5, 1e-5
TIMEOUT_S = 120
# the exchange cases: (top, bottom, clamp)
HALOS = [(1, 1, False), (0, 1, True), (2, 0, False), (5, 5, False),
         (3, 4, True)]


def images(seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(B, 3, H, W).astype(np.float32))
            for _ in range(2)]


def target(seed=1):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(B, 2, H, W).astype(np.float32))


def f64_params():
    return {k: v.double().requires_grad_()
            for k, v in init_params(0, CFG).items()}


def unsharded(model, params, im1, im2, dtype=torch.float32):
    """The port's forward as ``make_spatial_forward`` computes it, whole:
    the flow and the first visual at full resolution."""
    a, b = centralize(im1, im2)
    preds, occs, _ = build_model(model)(nn.apply_ctx(params, dtype), a, b,
                                        CFG)
    return upsample(preds[-1], 4), upsample(occs[0].float(), 4)


def flow_loss(flow, tgt, count):
    return ((flow - tgt) ** 2).sum() / count


def ramp(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


def padded(full, top, bottom, clamp):
    """``full`` (N,C,H,W) with ``top``/``bottom`` rows of zeros, or of its
    edge rows."""
    if clamp:
        return torch.cat([full[:, :, :1].expand(-1, -1, top, -1), full,
                          full[:, :, -1:].expand(-1, -1, bottom, -1)], 2)
    return torch.nn.functional.pad(full, (0, 0, top, bottom))


def check_exchange(shard: RowShard):
    """Each halo case and the gather on 2-row shards, forward and gradient,
    against slices of the whole tensor: a list of failures."""
    bad = []
    h, size, r = 2, shard.size, shard.index
    full = ramp((2, 3, size * h, 5), 0)
    mine = full[:, :, r * h:(r + 1) * h].clone().requires_grad_()
    for k, (top, bottom, clamp) in enumerate(HALOS):
        out = shard.halo(mine, top, bottom, clamp=clamp)
        want = padded(full, top, bottom, clamp)[:, :, r * h:r * h + h + top
                                                + bottom]
        if not torch.equal(out, want):
            bad.append(f"halo {top, bottom, clamp}")
        # d/dx of sum_j <halo_j, w_j>: every rank's weights, placed
        full_x = full.clone().requires_grad_()
        whole = padded(full_x, top, bottom, clamp)
        total = 0
        for j in range(size):
            wj = ramp(want.shape, 100 * k + j)
            total = total + (whole[:, :, j * h:j * h + h + top + bottom]
                             * wj).sum()
        total.backward()
        (g,) = torch.autograd.grad((out * ramp(want.shape, 100 * k + r))
                                   .sum(), mine)
        if not torch.allclose(g, full_x.grad[:, :, r * h:(r + 1) * h],
                              rtol=1e-6, atol=1e-6):
            bad.append(f"halo gradient {top, bottom, clamp}")
    if not torch.equal(shard.gather(mine), full):
        bad.append("gather")
    return bad


def _spatial_rank(rank: int, world: int, port: int, out: str) -> None:
    """One gloo rank of a world of 2 ((1, 2): the exchange, the S and
    cascade forwards, the S gradient) or of 4 ((2, 2): the exchange over
    4 ranks, the S forward). Writes rank<r>.json and rank<r>.pt."""
    torch.set_num_threads(1 if world > 2 else 2)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    got, tensors = {}, {}
    try:
        got["exchange"] = check_exchange(
            RowShard(rank, world, dist.group.WORLD))
        n_data = world // 2
        mesh = make_spatial_mesh(n_data, 2, "cpu")
        got["mesh"] = [mesh.data.rank, mesh.data.world, mesh.rows.index,
                       mesh.rows.size]
        d, s = mesh.data.rank, mesh.rows.index
        bl, hl = B // n_data, H // 2
        rows = (slice(d * bl, (d + 1) * bl), slice(None),
                slice(s * hl, (s + 1) * hl))
        im1, im2 = (x[rows].contiguous() for x in images())
        models = ["MaskFlownet_S"] + (["MaskFlownet"] if world == 2 else [])
        for model in models:
            fwd = make_spatial_forward(build_model(model), CFG, mesh,
                                       torch.float32)
            with torch.no_grad():
                tensors[model] = fwd(init_params(0, CFG, model), im1, im2)
        if world == 2:
            params = f64_params()
            fwd = make_spatial_forward(build_model("MaskFlownet_S"), CFG,
                                       mesh, torch.float64)
            flow, _ = fwd(params, im1.double(), im2.double())
            flow_loss(flow, target()[rows].double(),
                      B * 2 * H * W).backward()
            grads = {k: p.grad for k, p in params.items()}
            for g in grads.values():
                dist.all_reduce(g)          # the ranks' parts of the sum
            tensors["grads"] = grads
        torch.save(tensors, os.path.join(out, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fp:
            json.dump(got, fp)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, out: str):
    port = free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_spatial as t; "
            "t._spatial_rank({{}}, {}, {}, {!r})").format(TESTS, ROOT, world,
                                                         port, out)
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
    return [subprocess.Popen([sys.executable, "-c", code.format(r)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def collect(procs, out):
    readings = []
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        assert p.returncode == 0, text[-3000:]
        with open(os.path.join(out, f"rank{r}.json")) as fp:
            got = json.load(fp)
        readings.append((got, torch.load(os.path.join(out, f"rank{r}.pt"))))
    return readings


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: each rank's (readings, tensors)}, and the unsharded
    references computed while the ranks run."""
    outs = {w: str(tmp_path_factory.mktemp(f"spatial{w}")) for w in (2, 4)}
    procs = {w: spawn(w, outs[w]) for w in outs}
    im1, im2 = images()
    ref = {}
    with torch.no_grad():
        for model in ("MaskFlownet_S", "MaskFlownet"):
            ref[model] = unsharded(model, init_params(0, CFG, model), im1,
                                   im2)
    params = f64_params()
    flow, _ = unsharded("MaskFlownet_S", params, im1.double(), im2.double(),
                        torch.float64)
    flow_loss(flow, target().double(), B * 2 * H * W).backward()
    ref["grads"] = {k: p.grad for k, p in params.items()}
    return {w: collect(procs[w], outs[w]) for w in outs}, ref


@pytest.mark.parametrize("world", [2, 4])
def test_row_exchange_against_slices(worlds, world):
    for got, _ in worlds[0][world]:
        assert got["exchange"] == []


def _check_forward(readings, want, n_data):
    for rank, (got, tensors) in enumerate(readings):
        d, s = divmod(rank, 2)
        assert got["mesh"] == [d, n_data, s, 2]
        bl, hl = B // n_data, H // 2
        rows = (slice(d * bl, (d + 1) * bl), slice(None),
                slice(s * hl, (s + 1) * hl))
        flow, occ = tensors
        assert flow.shape == (bl, 2, hl, W) and occ.shape == (bl, 1, hl, W)
        np.testing.assert_allclose(flow.numpy(), want[0][rows].numpy(),
                                   rtol=RTOL, atol=FLOW_ATOL)
        np.testing.assert_allclose(occ.numpy(), want[1][rows].numpy(),
                                   rtol=RTOL, atol=OCC_ATOL)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_sharded_s_forward_matches_unsharded(worlds, mesh_shape):
    readings, ref = worlds
    world = mesh_shape[0] * mesh_shape[1]
    _check_forward([(g, t["MaskFlownet_S"]) for g, t in readings[world]],
                   ref["MaskFlownet_S"], mesh_shape[0])


def test_sharded_cascade_forward_matches_unsharded(worlds):
    readings, ref = worlds
    _check_forward([(g, t["MaskFlownet"]) for g, t in readings[2]],
                   ref["MaskFlownet"], 1)


def test_gradients_through_the_sharded_s_forward(worlds):
    readings, ref = worlds
    want = ref["grads"]
    for _, tensors in readings[2]:
        got = tensors["grads"]
        assert got.keys() == want.keys()
        worst = max(((got[k] - want[k]).norm() / want[k].norm()).item()
                    for k in want if want[k].norm() > 0)
        assert worst <= GRAD_RTOL


def test_the_mesh_refuses_what_it_cannot_split():
    mesh = make_spatial_mesh(1, 1, "cpu")
    assert isinstance(mesh, SpatialMesh) and mesh.rows.size == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_spatial_mesh(1, 2, "cpu")
    fwd = make_spatial_forward(build_model("MaskFlownet_S"), CFG, mesh,
                               torch.float32)
    im = torch.zeros((1, 3, 96, 64))
    with pytest.raises(ValueError, match="divisible by 64"):
        fwd(init_params(0, CFG), im, im)
