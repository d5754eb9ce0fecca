"""The train/eval engine of the port: ``TrainSettings`` and ``Trainer``, the
counterpart of ``maskflownet_tpu/training/engine.py:43-58, 104-208,
259-320, 327-408``. ``Trainer.train_batch_device`` takes the batches of
the input path (``data/loader.py``, ``data/device_cache.py``,
``parallel/mesh.py``): NHWC uint8 images and f16 flow, already on the
device.

One step of ``Trainer.train_batch``, in the order of the JAX step
(``engine.py:115-134``): images / 255 in f32; with ``geo``, the geometric
augmentation in f32 from the geometry config's ``orig_shape`` sources to
its ``target_shape`` crops (images returned in the compute dtype, labels
in f32), otherwise a cast to the compute dtype; the mask (/ 255)
broadcast to the labels' resolution; with ``color``, the colour
augmentation in the compute dtype; ``centralize``; the forward of
``settings.model`` (MaskFlownet_S or the MaskFlownet cascade), the mean
multiscale EPE and the ``epe`` metric of the 4x upsampled finest flow,
backward (the cost volume's gradient runs the hand-written kernels on the
card, and so does the deformable conv's: ``model_cfg.deform``'s
``"auto"`` takes its kernels there), then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected as
``optax.scale_by_adam``) applied as ``-lr * update`` with the lr given per
call. The parameters are held in f32 (the master weights) and cast to the
compute dtype inside the forward, so their gradients come back in f32.

With ``fix_head`` the parameters under ``MaskFlownet_S/`` (the cascade's
head) are frozen as the JAX step freezes them (``engine.py:147-153``):
their gradients are zero, and Adam still steps them, so its count
advances with every parameter's and the head's moments stay zero. The
forward reads the head's parameters detached, so the backward computes
no gradient for them, and the step hands Adam zeros in their place.

The augmentations draw from one ``torch.Generator`` that the ``Trainer``
owns on its device, seeded from ``seed``: geometry first, then colour,
without waiting for the device.

With a ``mesh`` (``parallel/mesh.py``) of several processes the step is
data-parallel, as the JAX step over its ``('data',)`` mesh
(``engine.py:79-86, 156-170``): each rank steps on its slice of the global
batch, and draws the augmentation for the whole global batch from the
generator (the same seed on every rank) and keeps its slice, so that N
ranks of B/N samples get the draws of one process of B, as the JAX step
draws once for the global batch. After the backward the gradients and the
two metrics are averaged over the ranks in one all-reduce, so the metrics
are the global batch's; the parameters are broadcast from rank 0 at
construction and after every load, and Adam keeps them identical.
Evaluation runs on each rank alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from maskflownet_torch import get_device, interop, nn
from maskflownet_torch.augment import (ColorAugConfig, GeometryAugConfig,
                                       color_augmentation, draw_color,
                                       draw_geometry, geometry_augmentation)
from maskflownet_torch.inference import Predictor, centralize
from maskflownet_torch.losses import (epe_loss_with_mask, kitti_outlier_rate,
                                      multiscale_epe)
from maskflownet_torch.models.maskflownet import (HEAD_SCOPE, ModelConfig,
                                                  build_model, init_params,
                                                  param_shapes)
from maskflownet_torch.ops.resample import upsample
from maskflownet_torch.parallel.mesh import (Mesh, all_reduce_mean,
                                             batch_sharding,
                                             replicated_sharding)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The JAX package's ``TrainSettings``, field for field, and two more:
    ``aug_sampler`` (``"affine"`` or ``"twopass"``) and
    ``aug_label_dtype`` (``"float16"`` or ``"float32"``, for
    ``"twopass"``), which ``geometry_augmentation`` takes as ``sampler``
    and ``label_dtype``: the explicit counterparts of ``MFN_AUG_SAMPLER``
    and ``MFN_AUG_LABEL_DTYPE`` (the JAX package's off-TPU default is the
    gather path, ``"affine"`` here)."""

    model: str = "MaskFlownet_S"
    model_cfg: ModelConfig = ModelConfig()
    q: float | None = None                   # robust-loss exponent
    loss_weights: tuple = (0.005, 0.01, 0.02, 0.08, 0.32)
    loss_match: str = "upsampling"
    fix_head: bool = False                   # freeze the MaskFlownet_S head
    compute_dtype: str = "bfloat16"          # forward compute precision
    target_shape: tuple[int, int] = (320, 448)
    orig_shape: tuple[int, int] = (384, 512)
    geo: GeometryAugConfig | None = None     # geometric augmentation
    color: ColorAugConfig | None = None      # colour augmentation
    adam_eps: float = 1e-8
    aug_sampler: str = "affine"              # geometry's sampler
    aug_label_dtype: str = "float16"         # twopass's label dtype

    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


def nchw_batch(batch):
    """A batch of the input path -- NHWC tensors (img1, img2, flow[, mask])
    as ``TrainLoader``, ``DeviceBatchCache`` and ``DevicePrefetcher`` lay
    them out -- as contiguous NCHW tensors on the same device, in the same
    dtypes. Contiguous once here: ``.float()`` on a permuted view would
    keep the NHWC strides, which the sampler kernel refuses and cuDNN
    carries into its outputs."""
    return tuple(t.permute(0, 3, 1, 2).contiguous() for t in batch)


def sync_metrics(metrics: dict) -> dict[str, float]:
    """Wait for a step's metrics (0-d device tensors) and return them as
    floats: the JAX package's ``sync_metrics``, the training loop's only
    read-back of the device."""
    return {k: float(v) for k, v in metrics.items()}


def _to_device(draws, dev):
    return None if draws is None else {
        k: None if v is None else v.to(dev) for k, v in draws.items()}


class Trainer:
    """Owns the parameters (f32, on ``device``), Adam's state and the
    step; evaluates through :class:`maskflownet_torch.inference.Predictor`.

    ``params``: port parameters (OIHW), e.g. from
    ``interop.params_from_jax``; without them the weights are drawn from
    ``seed`` by ``models.init_params``. ``mesh``: the data-parallel group
    of this process (``parallel.make_mesh``); the trainer runs on its
    device, which ``device``, if given, must name."""

    def __init__(self, settings: TrainSettings = TrainSettings(),
                 device: str | torch.device | None = None, seed: int = 0,
                 params: dict[str, torch.Tensor] | None = None,
                 mesh: Mesh | None = None):
        self.settings = settings
        self.model_fn = build_model(settings.model)
        self.mesh = mesh
        if mesh is None:
            self.device = get_device("cuda" if device is None else device)
        else:
            self.device = mesh.device
            if device is not None and get_device(device).type != \
                    mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
        self.shapes = param_shapes(settings.model_cfg, settings.model)
        if params is None:
            params = init_params(seed, settings.model_cfg, settings.model)
        missing = sorted(set(self.shapes) - set(params))
        unknown = sorted(set(params) - set(self.shapes))
        if missing or unknown:
            raise ValueError(f"params do not match {settings.model}: missing "
                             f"{missing[:5]}, unknown {unknown[:5]}")
        self.params = {k: params[k].detach().to(self.device, torch.float32)
                       .clone().requires_grad_() for k in sorted(params)}
        #: the frozen parameters: the cascade's head under ``fix_head``
        self.frozen = frozenset(k for k in self.params if settings.fix_head
                                and k.startswith(HEAD_SCOPE + "/"))
        self.opt = torch.optim.Adam(list(self.params.values()), lr=1e-4,
                                    betas=(0.9, 0.999), eps=settings.adam_eps)
        self.steps = 0
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._replicate()

    @property
    def world(self) -> int:
        """The number of data-parallel processes (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.world

    def _replicate(self) -> None:
        """Rank 0's parameters on every rank (nothing without a group)."""
        if self.mesh is not None:
            replicated_sharding(self.mesh, self.params.values())

    def _local_draws(self, draws):
        """This rank's slice of a global batch's draws (every draw but the
        0-d ones is per sample, batch first)."""
        if self.world == 1:
            return draws
        return tuple(None if d is None else {
            k: v if v is None or v.dim() == 0
            else v[batch_sharding(self.mesh, v.shape[0])]
            for k, v in d.items()} for d in draws)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def draw(self, b: int, hw: tuple[int, int]):
        """One step's augmentation draws for a batch of ``b`` at ``hw``
        from the trainer's generator: ``(geometry draws, colour draws)``,
        None where that augmentation is off."""
        s = self.settings
        geo = (None if s.geo is None else
               draw_geometry(self.gen, b, s.geo, self.device))
        color_hw = hw if s.geo is None else tuple(s.geo.target_shape)
        color = (None if s.color is None else
                 draw_color(self.gen, b, color_hw, s.dtype(), s.color,
                            self.device))
        return geo, color

    def prepare(self, img1, img2, flow, mask=None, draws=None):
        """The step's input chain: ``(img1, img2, flow, mask)`` as the model
        and the loss take them -- the centralised images in the compute
        dtype, flow (B,2,H,W) and mask (B,1,H,W) in f32, at the geometry
        config's ``target_shape`` when ``geo`` is set.

        img1/img2: (B,3,H,W) in [0, 255]; flow: (B,2,H,W) (dy, dx) pixels;
        mask: None, (B,H,W) or (B,1,h,w) broadcastable to (B,1,H,W), in
        [0, 255]. Tensors or arrays. ``draws``: the result of
        :meth:`draw`, moved to this device; without it the step draws its
        own. The draws are the global batch's: with a mesh of N processes
        the batch is this rank's B of the global N * B, and the rank takes
        its slice of the draws."""
        s = self.settings
        dev, dtype = self.device, s.dtype()
        # contiguous NCHW (a permuted view's strides would reach the
        # kernels, which take contiguous tensors only)
        img1 = torch.as_tensor(img1, device=dev).contiguous().float().div(
            255.0)
        img2 = torch.as_tensor(img2, device=dev).contiguous().float().div(
            255.0)
        flow = torch.as_tensor(flow, device=dev).contiguous().float()
        b, _, h, w = flow.shape
        if mask is None:
            mask = torch.ones((b, 1, 1, 1), device=dev)
        else:
            mask = torch.as_tensor(mask, device=dev).float() / 255.0
            if mask.dim() == 3:
                mask = mask[:, None]
        if draws is None:
            draws = self.draw(b * self.world, (h, w))
        geo_draws, color_draws = (_to_device(d, dev)
                                  for d in self._local_draws(draws))
        if s.geo is not None:
            img1, img2, flow, mask = geometry_augmentation(
                img1, img2, flow, mask, geo_draws, s.geo, image_dtype=dtype,
                sampler=s.aug_sampler,
                label_dtype=getattr(torch, s.aug_label_dtype, None))
        else:
            img1, img2 = img1.to(dtype), img2.to(dtype)
        mask = mask.expand(b, 1, *flow.shape[2:])
        if s.color is not None:
            img1, img2 = color_augmentation(img1, img2, color_draws, s.color)
        img1, img2 = centralize(img1, img2)
        return img1, img2, flow, mask

    def loss(self, img1, img2, flow, mask=None, draws=None):
        """The step's loss and metric, before backward: ``(loss, epe)``,
        0-d f32 tensors, ``loss`` attached to the parameters. Arguments as
        :meth:`prepare`; the model's H and W are multiples of 64."""
        s = self.settings
        img1, img2, flow, mask = self.prepare(img1, img2, flow, mask, draws)
        params = {k: v.detach() if k in self.frozen else v
                  for k, v in self.params.items()}
        preds, _, _ = self.model_fn(nn.apply_ctx(params, s.dtype()), img1,
                                    img2, s.model_cfg)
        loss = multiscale_epe(flow, mask, preds, weights=s.loss_weights,
                              match=s.loss_match, q=s.q).mean()
        with torch.no_grad():
            epe = epe_loss_with_mask(upsample(preds[-1], 4), flow,
                                     mask).mean()
        return loss, epe

    def apply_gradients(self, lr: float) -> None:
        """One Adam step with the gradients held in ``.grad`` (zeros for
        the frozen parameters), then clear them."""
        for k in self.frozen:
            self.params[k].grad = torch.zeros_like(self.params[k])
        for group in self.opt.param_groups:
            group["lr"] = float(lr)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def train_batch(self, img1, img2, flow, mask=None, lr: float = 1e-4,
                    sync: bool = False, draws=None):
        """One optimisation step (arguments as :meth:`prepare`). Returns
        ``{"loss", "epe"}``, the values before the update: 0-d tensors on
        the device that do not wait for it, or floats with ``sync=True``."""
        loss, epe = self.loss(img1, img2, flow, mask, draws)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None and self.mesh.group is not None:
            loss, epe = self.reduce_gradients(loss, epe)
        self.apply_gradients(lr)
        self.steps += 1
        metrics = {"loss": loss, "epe": epe}
        return sync_metrics(metrics) if sync else metrics

    def reduce_gradients(self, loss, epe):
        """Average the trainable parameters' gradients (zeros where the
        backward left none) and the metrics over the mesh, in one
        all-reduce queued on the current stream. Returns the global
        ``(loss, epe)``."""
        grads = []
        for k, p in self.params.items():
            if k in self.frozen:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        metrics = torch.stack([loss, epe]).float()
        all_reduce_mean(self.mesh, grads + [metrics])
        return metrics[0], metrics[1]

    def train_batch_device(self, batch, lr: float = 1e-4):
        """One step on a device-resident batch laid out as ``TrainLoader``,
        ``DeviceBatchCache`` and ``DevicePrefetcher`` produce it: img1, img2
        (B,H,W,3) uint8; flow (B,H,W,2) f16 (dy, dx) pixels; mask (B,1,1,1)
        or (B,H,W,1) uint8, optional. Made contiguous NCHW on the device
        (:func:`nchw_batch`), then the chain of :meth:`train_batch`, which
        draws the augmentation afresh from the trainer's generator at
        every call (so every echo of a cached batch gets new geometry and
        colour). Returns ``{"loss", "epe"}`` as 0-d tensors that do not
        wait for the device."""
        return self.train_batch(*nchw_batch(batch), lr=lr)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def predictor(self) -> Predictor:
        """A :class:`Predictor` on the trainer's current parameters, compute
        dtype, ``model_cfg`` and model."""
        s = self.settings
        return Predictor({k: v.detach() for k, v in self.params.items()},
                         device=self.device, dtype=s.dtype(),
                         cfg=s.model_cfg, model=s.model)

    def do_batch(self, img1, img2, resize=None):
        """:meth:`Predictor.do_batch` with the current parameters: NCHW
        images in [0, 1] in; flow (dy, dx), occlusion and warped image 2,
        tensors on the device, out."""
        return self.predictor().do_batch(img1, img2, resize=resize)

    def predict(self, img1s, img2s, batch_size: int = 4, resize=None):
        """:meth:`Predictor.predict` with the current parameters: per frame
        (flow (H,W,2) (dy, dx), occ, warped) numpy arrays for lists of
        (H,W,3) uint8 RGB images."""
        return self.predictor().predict(img1s, img2s, batch_size, resize)

    def validate(self, img1s, img2s, flows, masks=None, batch_size: int = 4,
                 resize=None, return_type: str = "epe"):
        """Dataset mean EPE (``"epe"``), KITTI Fl-all (``"kitti"``) or both
        from one sweep (``"both"``), as the JAX ``Trainer.validate``. Lists
        of HWC numpy arrays: uint8 images, (H,W,2) (dy, dx) flows, masks in
        [0, 255]. A short last batch is padded and the padding not
        counted."""
        if return_type not in ("epe", "kitti", "both"):
            raise ValueError(f"return_type {return_type!r}: expected 'epe', "
                             "'kitti' or 'both'")
        n = len(img1s)
        if masks is None:
            masks = [np.full(img1s[i].shape[:2] + (1,), 255, np.uint8)
                     for i in range(n)]
        predictor = self.predictor()
        per_sample: dict[str, list] = {"epe": [], "kitti": []}
        wanted = ("epe", "kitti") if return_type == "both" else (return_type,)
        for j in range(0, n, batch_size):
            i1 = np.stack(img1s[j:j + batch_size]).astype(np.float32) / 255.0
            i2 = np.stack(img2s[j:j + batch_size]).astype(np.float32) / 255.0
            fl = np.stack(flows[j:j + batch_size]).astype(np.float32)
            mk = np.stack(masks[j:j + batch_size]).astype(np.float32) / 255.0
            if mk.ndim == 3:
                mk = mk[..., None]
            pad = batch_size - i1.shape[0]
            if pad:
                i1, i2, fl, mk = [np.concatenate(
                    [x, np.repeat(x[-1:], pad, 0)]) for x in (i1, i2, fl, mk)]
            flow, _, _ = predictor.do_batch(i1.transpose(0, 3, 1, 2),
                                            i2.transpose(0, 3, 1, 2),
                                            resize=resize)
            fl_t, mk_t = (torch.from_numpy(x.transpose(0, 3, 1, 2)).to(
                self.device) for x in (fl, mk))
            for kind in wanted:
                metric = (epe_loss_with_mask if kind == "epe"
                          else kitti_outlier_rate)
                e = metric(flow, fl_t, mk_t).cpu().numpy()
                per_sample[kind].extend(e[:batch_size - pad])
        means = {k: float(np.mean(v)) for k, v in per_sample.items() if v}
        if return_type == "both":
            return means["epe"], means["kitti"]
        return means[return_type]

    # ------------------------------------------------------------------
    # checkpoints: the v1 .npz schema, shared with the JAX package
    # ------------------------------------------------------------------

    def state_dict(self) -> dict[str, np.ndarray]:
        """``p:``/``mu:``/``nu:`` (HWIO), ``step``, ``count``, ``schema``."""
        mu, nu, count = {}, {}, 0
        for k, p in self.params.items():
            st = self.opt.state.get(p)
            if not st:
                mu[k] = nu[k] = torch.zeros_like(p)
                continue
            mu[k], nu[k] = st["exp_avg"], st["exp_avg_sq"]
            count = int(st["step"])
        return interop.npz_entries(self.params, mu, nu, count, self.steps)

    def save(self, prefix: str) -> None:
        np.savez(prefix + ".npz", **self.state_dict())

    def load(self, path: str, load_states: bool = True) -> None:
        """Load a v1 checkpoint written by either package. Missing,
        unknown and mis-shaped entries raise. With ``load_states`` and
        moments in the file, Adam's moments and its per-parameter step
        come from ``mu:``/``nu:``/``count``, and the schedule's step from
        ``step``; the two counts stay separate."""
        ck = interop.read_npz(path, self.shapes)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(ck["params"][k])
        self._replicate()
        if load_states and ck["mu"] is not None:
            if ck["count"] is None or ck["step"] is None:
                raise ValueError(f"checkpoint has moments but no "
                                 f"count/step: {path}")
            for k, p in self.params.items():
                self.opt.state[p] = {
                    "step": torch.tensor(float(ck["count"])),
                    "exp_avg": ck["mu"][k].to(self.device),
                    "exp_avg_sq": ck["nu"][k].to(self.device)}
            self.steps = ck["step"]

    def load_head(self, path: str) -> None:
        """Load a standalone MaskFlownet_S checkpoint (its ``p:`` entries)
        into the cascade's head, as the JAX ``load_head``
        (``engine.py:393-408``): an entry the head does not have, a head
        parameter the file does not cover, and a mis-shaped entry raise."""
        with np.load(path) as z:
            flat = {f"{HEAD_SCOPE}/{k[2:]}": z[k] for k in z.files
                    if k.startswith("p:")}
        unknown = sorted(set(flat) - set(self.params))
        if unknown:
            raise ValueError(f"head params not in model: {unknown[:5]}")
        missing = sorted(k for k in self.params
                         if k.startswith(HEAD_SCOPE + "/") and k not in flat)
        if missing:
            raise ValueError(f"checkpoint does not cover the head: missing "
                             f"{missing[:5]}")
        head = interop.params_from_jax(flat)
        for k, v in head.items():
            if tuple(v.shape) != tuple(self.shapes[k]):
                raise ValueError(f"head param {k!r} shape {tuple(v.shape)} "
                                 f"(OIHW) != model shape {self.shapes[k]}")
        with torch.no_grad():
            for k, v in head.items():
                self.params[k].copy_(v)
        self._replicate()
