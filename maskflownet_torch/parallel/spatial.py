"""Spatial (H-axis) sharding for very large frames: the port of
``maskflownet_tpu/parallel/spatial.py``.

A 2-D (data, spatial) mesh of processes shards the batch over ``data``
and the image rows over ``spatial``: each rank of a spatial group holds
rows ``[r * h, (r + 1) * h)`` of every tensor of the forward, at every
pyramid level. The JAX package leaves the halo exchanges to XLA's SPMD
partitioner; here they are explicit. ``models/maskflownet.py`` runs
unchanged with a :class:`RowShard` in its ``nn.Ctx`` (``ctx.rows``), and
each op that reads across rows takes its row-sharded form from it:

* a conv (``nn.conv2d``; 3x3, stride 1 or 2, dilation up to 16) reads a
  halo of ``padding`` rows above and the rest of its reach below, and
  runs unpadded in H on the extended tile;
* a transposed conv (``nn.conv_transpose2d``) reads one row each side and
  pads its output back to the local rows;
* a cost volume (``correlation``, md 4 and 2) runs the unchanged kernel on
  f1 zero-padded by md rows and f2 extended by an md-row halo (which at
  the coarsest levels reaches past the neighbour), then drops the padding
  rows;
* ``upsample`` reads one row below, the image's last row repeated past the
  bottom as the unsharded op does;
* ``backwarp`` and the deformable conv read anywhere: the source is
  gathered whole. The deformable conv takes its ``warpconv`` form here
  whatever ``ModelConfig.deform`` says (the same function): the 3x3 conv
  on the one-pixel-extended grid with a 2-row halo, that grid gathered,
  then the bilinear sample of the local rows. The CUDA deform kernels tie
  the sample coordinates to the height of their input, so they cannot take
  a gathered source with the local rows of the flow;
* ``centralize``'s mean is over the whole frame: the sums are
  all-reduced.

Every exchange is one all-reduce of a zeroed buffer holding the rows the
ranks ask for, each owner writing its rows in (:class:`_RowExchange`): the
simplest exact form, and one that NCCL and gloo (on CUDA tensors too)
both offer. It is an autograd function whose backward all-reduces the
cotangents of those rows back to their owners, so gradients flow through
the sharded forward. All ranks of a spatial group run the same ops in the
same order, forward and backward.

H must be divisible by 64 times the spatial size, so that every level
splits evenly.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from maskflownet_torch import get_device, nn
from maskflownet_torch.ops.correlation import correlation as _correlation
from maskflownet_torch.ops.resample import upsample as _upsample
from maskflownet_torch.ops.warp import backwarp_coords, base_grid
from maskflownet_torch.parallel.mesh import Mesh

# every level of the pyramid splits evenly when the local rows are a
# multiple of this
ROW_MULTIPLE = 64


def _plan(wants):
    """The buffer of an exchange: {range: row offset} of every distinct
    wanted range, and its total rows."""
    offsets, total = {}, 0
    for rng in sorted({r for ranges in wants for r in ranges}):
        offsets[rng] = total
        total += rng[1] - rng[0]
    return offsets, total


def _spans(offsets, own, height, clamp):
    """(buffer rows, own rows) pairs of the rows this rank writes: the
    overlap of each wanted range with ``own``, and with ``clamp`` the
    rows past the image's edges, which repeat its first or last row."""
    lo, hi = own
    for (a, b), off in offsets.items():
        s, e = max(a, lo), min(b, hi)
        if s < e:
            yield (off + s - a, off + e - a), (s, e)
        if clamp and hi == height and b > height:
            s = max(a, height)
            yield (off + s - a, off + b - a), (height - 1, height)
        if clamp and lo == 0 and a < 0:
            e = min(b, 0)
            yield (off, off + e - a), (0, 1)


class _RowExchange(torch.autograd.Function):
    """Global rows ``[lo, hi)`` of a row-sharded tensor, for every range
    in ``wants[index]``; zeros outside the image, or with ``clamp`` its
    edge rows. ``x`` holds global rows ``[start, start + x.shape[2])`` and
    this rank contributes rows ``own`` of them; ``wants`` lists every
    rank's ranges (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, shard, start, own, wants, height, clamp):
        offsets, total = _plan(wants)
        n, c, _, w = x.shape
        buf = x.new_zeros((n, c, total, w))
        for (b0, b1), (s, e) in _spans(offsets, own, height, clamp):
            buf[:, :, b0:b1] = x[:, :, s - start:e - start]
        shard.all_reduce(buf)
        ctx.shard, ctx.start, ctx.own, ctx.wants = shard, start, own, wants
        ctx.height, ctx.clamp, ctx.shape = height, clamp, x.shape
        return tuple(buf[:, :, offsets[r]:offsets[r] + r[1] - r[0]].clone()
                     for r in wants[shard.index])

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        offsets, total = _plan(ctx.wants)
        n, c, _, w = ctx.shape
        buf = grads[0].new_zeros((n, c, total, w))
        for r, g in zip(ctx.wants[ctx.shard.index], grads):
            buf[:, :, offsets[r]:offsets[r] + r[1] - r[0]] += g
        ctx.shard.all_reduce(buf)
        gx = buf.new_zeros(ctx.shape)
        for (b0, b1), (s, e) in _spans(offsets, ctx.own, ctx.height,
                                       ctx.clamp):
            part = buf[:, :, b0:b1]
            if e - s != b1 - b0:            # rows past an edge: its row
                part = part.sum(2, keepdim=True)
            gx[:, :, s - ctx.start:e - ctx.start] += part
        return gx, None, None, None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over a spatial group; its gradient is the sum of
    the cotangents."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        y = x.clone()
        shard.all_reduce(y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.clone()
        ctx.shard.all_reduce(g)
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """Rank ``index`` of the ``size`` ranks of a spatial ``group`` (None
    at size 1), and the row-sharded form of every op of the models that
    reads across rows. A tensor's local rows are ``[index * h, (index + 1)
    * h)`` of ``size * h``."""

    index: int
    size: int
    group: object | None

    def all_reduce(self, t: torch.Tensor) -> None:
        if self.size > 1:
            dist.all_reduce(t, group=self.group)

    def _exchange(self, x, wants, clamp=False):
        """:class:`_RowExchange` of a tensor of this rank's rows."""
        h = x.shape[2]
        lo = self.index * h
        return _RowExchange.apply(x, self, lo, (lo, lo + h), wants,
                                  self.size * h, clamp)

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             clamp: bool = False) -> torch.Tensor:
        """x's local rows with ``top`` rows above and ``bottom`` below
        (zeros outside the image, or its edge rows with ``clamp``)."""
        h = x.shape[2]
        wants = tuple(tuple(r for r, k in (((j * h - top, j * h), top),
                                           (((j + 1) * h,
                                             (j + 1) * h + bottom), bottom))
                            if k)
                      for j in range(self.size))
        if not wants[0]:
            return x
        pieces = list(self._exchange(x, wants, clamp=clamp))
        parts = ([pieces.pop(0)] if top else []) + [x] + pieces
        return torch.cat(parts, 2)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole height of a row-sharded tensor, on every rank."""
        if self.size == 1:
            return x
        rows = self.size * x.shape[2]
        return self._exchange(x, (((0, rows),),) * self.size)[0]

    # ------------------------------------------------------------------
    # the ops
    # ------------------------------------------------------------------

    def conv2d(self, x, w, b, stride: int = 1, padding: int = 0,
               dilation: int = 1):
        reach = dilation * (w.shape[2] - 1)
        tile = self.halo(x, padding, reach - padding - stride + 1)
        return F.conv2d(tile, w, b, stride=stride, padding=(0, padding),
                        dilation=dilation)

    def conv_transpose2d(self, x, w, b, stride: int, padding: int):
        k = w.shape[2]
        top = -(-(k - 1 - padding) // stride)
        bottom = (padding + stride - 1) // stride
        y = F.conv_transpose2d(self.halo(x, top, bottom), w, b,
                               stride=stride,
                               padding=(stride * top + padding, padding))
        return y[:, :, :stride * x.shape[2]]

    def correlation(self, f1, f2, md: int, leaky: float | None = None):
        h = f1.shape[2]
        out = _correlation(F.pad(f1, (0, 0, md, md)), self.halo(f2, md, md),
                           md, leaky=leaky)
        return out[:, :, md:md + h]

    def upsample(self, x, factor: int):
        if factor == 1:
            return x
        h = x.shape[2]
        return _upsample(self.halo(x, 0, 1, clamp=True),
                         factor)[:, :, :factor * h]

    def backwarp(self, img, flow):
        sy, sx = base_grid(flow)
        return backwarp_coords(self.gather(img),
                               sy + self.index * flow.shape[2], sx)

    def deform(self, x, flow, weight, bias):
        """The flow-guided deformable 3x3 conv in its ``warpconv`` form
        (``ops/deform.py``): the conv on the one-pixel-extended grid,
        gathered, sampled at ``p + 1 + flow``."""
        h = x.shape[2]
        rows, r0 = self.size * h, self.index * h
        conv = F.conv2d(F.pad(self.halo(x, 2, 2), (2, 2, 0, 0)),
                        weight.to(x.dtype))
        # the extended grid's rows [r0 - 1, r0 + h + 1); this rank owns its
        # own rows, the first rank row -1 and the last row ``rows``
        own = (r0 - (self.index == 0), r0 + h + (self.index == self.size - 1))
        full = (conv if self.size == 1 else _RowExchange.apply(
            conv, self, r0 - 1, own, (((-1, rows + 1),),) * self.size,
            rows, False)[0])
        sy, sx = base_grid(flow, offset=1.0)
        out = backwarp_coords(full, sy + r0, sx)
        return out if bias is None else out + bias.to(x.dtype)[:, None, None]

    def centralize(self, img1, img2):
        """``inference.centralize`` over the whole frame: the pair's mean
        colour, its sums all-reduced over the group."""
        both = torch.cat([img1, img2], 2).float()
        total = both.sum(dim=(2, 3), keepdim=True)
        if self.size > 1:
            total = _AllReduceSum.apply(total, self)
        count = both.shape[2] * both.shape[3] * self.size
        mean = (total / count).to(img1.dtype)
        return img1 - mean, img2 - mean


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A process's place in the (data, spatial) mesh: its data-parallel
    :class:`Mesh` (the ranks that hold the same rows of other samples) and
    its :class:`RowShard` (the ranks that hold other rows of the same
    samples)."""

    data: Mesh
    rows: RowShard


def make_spatial_mesh(n_data: int, n_spatial: int,
                      device: str | torch.device = "cuda") -> SpatialMesh:
    """The (data, spatial) mesh of ``n_data * n_spatial`` processes: rank
    ``d * n_spatial + s`` holds batch shard ``d`` and row shard ``s``.
    Every process calls it (the groups are made collectively); without a
    process group the mesh must be (1, 1). On cards a process drives
    ``cuda:<rank % cards>``."""
    dev = get_device(device)
    if not dist.is_initialized():
        if n_data * n_spatial != 1:
            raise ValueError(f"a ({n_data}, {n_spatial}) mesh needs "
                             f"{n_data * n_spatial} processes; no process "
                             "group was started")
        return SpatialMesh(Mesh(0, 1, dev, None), RowShard(0, 1, None))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_spatial:
        raise ValueError(f"a ({n_data}, {n_spatial}) mesh needs "
                         f"{n_data * n_spatial} processes, not {world}")
    d, s = divmod(rank, n_spatial)
    data_group = spatial_group = None
    for i in range(n_data):             # every rank makes every group
        g = dist.new_group([i * n_spatial + j for j in range(n_spatial)])
        if i == d:
            spatial_group = g
    for j in range(n_spatial):
        g = dist.new_group([i * n_spatial + j for i in range(n_data)])
        if j == s:
            data_group = g
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return SpatialMesh(Mesh(d, n_data, dev, data_group),
                       RowShard(s, n_spatial, spatial_group))


def make_spatial_forward(model_fn, model_cfg, mesh: SpatialMesh,
                         compute_dtype: torch.dtype = torch.bfloat16):
    """The row-sharded forward ``fwd(params, im1, im2) -> (flow, occ)``:
    ``im1``/``im2`` are this rank's rows of its samples, (B, 3, H / S, W)
    in [0, 1] on its device (S the spatial size, H divisible by 64 * S);
    ``flow`` (B, 2, H / S, W) and ``occ`` (B, 1, H / S, W) are the same
    rows of the full-resolution flow (dy, dx) and of the occlusion mask
    (the cascade's visual: flow2's channel 0), f32. ``model_fn`` is a
    forward of ``models/maskflownet.py`` (``build_model(name)``)."""
    rows = mesh.rows

    def fwd(params, im1, im2):
        if im1.shape[2] % ROW_MULTIPLE:
            raise ValueError(
                f"{im1.shape[2]} local rows: H must be divisible by "
                f"{ROW_MULTIPLE} x {rows.size} spatial ranks")
        im1, im2 = rows.centralize(im1, im2)
        ctx = nn.Ctx(mode="apply", params=params, dtype=compute_dtype,
                     rows=rows)
        preds, occs, _ = model_fn(ctx, im1, im2, model_cfg)
        flow = rows.upsample(preds[-1], 4)
        occ = rows.upsample(occs[0].float(), 4) if occs else flow[:, :1]
        return flow, occ

    return fwd
