"""The JAX package's TPU alternates, in PyTorch, as references held equal to the port's defaults.

Three alternates of the JAX package: the space-to-depth ("packed") decoder
tail (``unet_embroidery_seg_tpu/ops/packed_tail.py``), the ResNet stem's
``packed`` and ``im2col`` lowerings (``models/blocks.py:StemConv7x7``) and
the flat-arena Adam (``ops/flat_adam.py:FlatAdam``). Measured on an H100
(``chip_smoke.py`` phase 18) none is faster than the port's default on
the train step (the packed tail 7-10x the unpacked stage, ``im2col``
2.6-4.4x the direct stem, ``packed`` 1.16x in f32; FlatAdam's step time
within the host's spread of the foreach Adam's), so the port keeps one
path each and these live here, beside the tests that hold them to JAX
and to the default (``tests/test_torch_packed_tail.py``,
``tests/test_torch_stem.py``, ``tests/test_torch_flat_adam.py``). They
import neither ``jax`` nor the JAX package, so ``chip_smoke.py`` runs them
on the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.graph import increment_version

from unet_embroidery_seg_torch.models import blocks
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.ops.resize import _interp_matrix

# --- the packed decoder tail ---------------------------------------------------------------------
#
# unet_resnet50's final stage (``up_conv``: a 2x upsample, two 3x3 convs at
# C = 64, the 1x1 class head, at 2H x 2W) kept at H x W with the 2x2
# sub-pixel phases packed into channels, in (p, q, c) order: packed channel
# (p * 2 + q) * C + c holds pixel (2i + p, 2j + q, c). Tensors are NCHW; the
# packed ones come out in ``channels_last`` memory, so their NHWC view is
# the JAX arrays' layout. Stock PyTorch ops (cuDNN's convs on the card), as
# JAX computes them with XLA's convs and einsums, outside any Pallas kernel.


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW (a ``channels_last`` view, no copy)."""
    return y.permute(0, 3, 1, 2)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, 2H, 2W] -> [B, 4C, H, W] with (p, q, c) channel order."""
    b, c, h2, w2 = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h2 // 2, 2, w2 // 2, 2, c)
    return _nchw(y.permute(0, 1, 3, 2, 4, 5).reshape(b, h2 // 2, w2 // 2, 4 * c))


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """[B, 4C, H, W] -> [B, C, 2H, 2W], the inverse of ``space_to_depth2``."""
    b, c4, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h, w, 2, 2, c4 // 4)
    return _nchw(y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c4 // 4))


def space_to_depth2_labels(y: torch.Tensor) -> torch.Tensor:
    """[B, 2H, 2W] labels -> [B, 4, H, W], phase p * 2 + q on dim 1 (JAX: the last dim)."""
    return space_to_depth2(y[:, None])


@lru_cache(maxsize=None)
def _phase_matrix(n: int, align_corners: bool, device: torch.device) -> torch.Tensor:
    """[i, p, I]: output 2i + p of a 2x resize of ``n`` samples from input I (cached per device,
    so a call after the first copies nothing from the host)."""
    return torch.tensor(_interp_matrix(n, 2 * n, align_corners).reshape(n, 2, n), device=device)


def packed_upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """2x bilinear upsample of [B, C, H, W], emitted packed as [B, 4C, H, W].

    The two interpolation-matrix contractions of ``ops/resize.upsample2x_plain``
    with the output rows 2i + p and columns 2j + q landing in phase channels;
    float32 maths, autocast off, the result in ``x``'s type.
    """
    b, c, h, w = x.shape
    hm, wm = (_phase_matrix(n, align_corners, x.device) for n in (h, w))
    with torch.autocast(x.device.type, enabled=False):
        t = torch.einsum("bIJc,jqJ->bIjqc", x.permute(0, 2, 3, 1).float(), wm)
        u = torch.einsum("ipI,bIjqc->bijpqc", hm, t)
    return _nchw(u.reshape(b, h, w, 4 * c).to(x.dtype))


def _phase_kernel(w: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[O, C, 3, 3] conv weight -> the (p, q)-phase packed weight [O, 4C, 2, 2].

    A stride-1 3x3 conv at 2H x 2W: out[2i + p, 2j + q] = sum over di, dj
    in [-1, 1] of w[:, :, di + 1, dj + 1] . in[2i + p + di, 2j + q + dj].
    Input row 2i + p + di is packed row i + r, phase a; with taps kr in
    {0, 1} and H pads (1 - p, p), r = kr - (1 - p), so di = 2 kr + p + a - 2,
    a tap only where di is in [-1, 1] and a structural zero elsewhere
    (columns alike with ks, q, b). On the weight padded by one zero each
    side, the tap is index 2 kr + p + a: a 4-wide window from p, read as
    (kr, a), and from q as (ks, b); input channels in (a, b, c) order.
    """
    o, c = w.shape[:2]
    k = F.pad(w, (1, 1, 1, 1))[:, :, p:p + 4, q:q + 4].reshape(o, c, 2, 2, 2, 2)
    return k.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 2, 2)


def packed_conv3x3(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """A stride-1 SAME 3x3 conv at 2H x 2W on the packed [B, 4C, H, W] layout.

    Four 2x2 convs (one per output phase (p, q), H and W pads (1 - p, p) and
    (1 - q, q) as an explicit ``F.pad``), equal to the conv at the unpacked
    resolution with the same [O, C, 3, 3] weight; 16/9 of its products.
    """
    outs = [F.conv2d(F.pad(u, (1 - q, q, 1 - p, p)), _phase_kernel(w, p, q)).permute(0, 2, 3, 1)
            for p in (0, 1) for q in (0, 1)]
    y = torch.stack(outs, dim=3)  # [B, H, W, 4, O]
    if b is not None:
        y = y + b.to(y.dtype)
    return _nchw(y.flatten(3))


def packed_conv1x1(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """A 1x1 conv on the packed layout, a per-phase channel product (phases do not mix).

    ``w`` is the unpacked [O, C, 1, 1] (or [O, C]) weight.
    """
    w = w.reshape(w.shape[0], w.shape[1])
    bsz, c4, h, wd = u.shape
    y = torch.einsum("bhwpc,oc->bhwpo", u.permute(0, 2, 3, 1).reshape(bsz, h, wd, 4, c4 // 4),
                     w.to(u.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return _nchw(y.flatten(3))


# --- the ResNet stem's lowerings -----------------------------------------------------------------

STEM_MODES = ("direct", "packed", "im2col")


class StemConv7x7(blocks.Conv2d):
    """The ResNet stem's 7x7 stride-2 pad-3 bias-free conv, in one of three lowerings.

    Every mode computes the same conv from the one ``[features, 3, 7, 7]``
    weight, and gradients reach it through each rearrangement:

    - ``direct``: the port's stem (``blocks.Conv2d``);
    - ``packed``: a 2x2 space-to-depth of the input, then a 4x4 stride-1
      conv over 4 x 3 channels with pads (2, 1) on H and W, its weight the
      zero-padded rearrangement of the 7x7 one (tap a = 2 q + dy - 1);
    - ``im2col``: the 49 strided slices of the padded input side by side,
      then one GEMM with K = 147 (f32 accumulation).

    An odd H or W takes the direct conv, as in JAX. Over the space axis
    each mode takes the direct conv's band and gives its rows: ``im2col``
    the same halo (3 rows above, 2 below), ``packed`` one more above (4, a
    zero tap), so that the halo'd band starts on an even row of the image
    and packs as the whole image does.
    """

    def __init__(self, features: int, mode: str = "packed", in_channels: int = 3):
        if mode not in STEM_MODES:
            raise ValueError(f"stem mode {mode!r}: expected one of {STEM_MODES}")
        super().__init__(in_channels, features, 7, stride=2, padding=3, bias=False)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if self.mode == "direct" or h % 2 or w % 2:
            return super().forward(x)
        if self.mode == "im2col":
            return self._im2col(x)
        return self._packed(x)

    def _im2col(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = (F.pad(x, (3, 3, 3, 3)) if self.space is None
             else F.pad(self.space.exchange(x, 3, 2, zero_edges=True), (3, 3)))
        xp = x.permute(0, 2, 3, 1)
        cols = torch.cat([xp[:, ky:ky + h:2, kx:kx + w:2] for ky in range(7) for kx in range(7)],
                         dim=-1)  # [N, H/2, W/2, 49 C], K in (ky, kx, c) order
        wmat = self.weight.permute(0, 2, 3, 1).reshape(self.out_channels, -1)
        return torch.matmul(cols, wmat.t()).permute(0, 3, 1, 2)

    def _packed(self, x: torch.Tensor) -> torch.Tensor:
        f, c = self.weight.shape[:2]
        wp = F.pad(self.weight, (1, 0, 1, 0)).reshape(f, c, 4, 2, 4, 2)  # (q, dy, r, dx)
        wp = wp.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)
        if self.space is None:
            return F.conv2d(F.pad(space_to_depth2(x), (2, 1, 2, 1)), wp)
        x = self.space.exchange(x, 4, 2, zero_edges=True)
        return F.conv2d(F.pad(space_to_depth2(x), (2, 1)), wp)


def set_stem_mode(backbone: nn.Module, mode: str) -> nn.Module:
    """Give a ``ResNet50Backbone`` (or a model's ``.resnet``) the stem in ``mode``, keeping its
    ``conv1.weight`` parameter itself: the state dict's keys, shapes and values are unchanged."""
    stem = StemConv7x7(backbone.conv1.out_channels, mode=mode)
    stem.weight = backbone.conv1.weight
    stem.space = backbone.conv1.space
    backbone.conv1 = stem
    return backbone


# --- the flat-arena Adam -------------------------------------------------------------------------


def _bump(params: list[torch.Tensor]) -> None:
    try:
        increment_version(params)
    except TypeError:  # older torch: one tensor per call
        for p in params:
            increment_version(p)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``t.numel()`` consecutive slots of storage, in some order."""
    expected = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if stride != expected:
            return False
        expected *= size
    return True


class FlatAdam(torch.optim.Optimizer):
    """Adam over one float32 arena per state (``master`` = the parameters, ``mu``, ``nu``).

    One parameter group; every parameter float32, dense, on one device. An
    update is a handful of arena-wide ops however many tensors the model has
    (unet_resnet50: 181). Semantics are JAX's ``TreeAdam`` and the port's
    foreach Adam: coupled L2 weight decay added to the gradient before the
    moments, bias correction from step 1, the learning rate of the one
    group set per epoch by ``schedules.set_learning_rate``.

    Layout. The float32 parameters are the masters, so the ``master`` arena
    is the parameters themselves: each parameter's data is a view of it
    (``as_strided`` with its own strides, so ``channels_last`` weights stay
    so), and so is its gradient, of a ``grad`` arena (autograd accumulates
    into a gradient that is already there, in place). The traps:

    - a view made with ``p.data = view`` keeps the parameter's own version
      counter, so an update of the arena does not bump it; the conv
      kernel's packed-weight cache keys on it (``ops/conv3x3.py``), so each
      step bumps every parameter's version explicitly;
    - anything that rebinds a parameter (``model.to``, ``p.data = ...``)
      breaks the aliasing: each step and ``zero_grad`` check every
      parameter's data pointer and re-bind (values and moments kept) when
      one moved; in-place writes (``load_state_dict``, DDP's broadcast)
      write the arena;
    - ``zero_grad`` zeroes the grad arena and binds the views (it never sets
      a gradient to None); a gradient found unbound at a step is copied in;
    - checkpoints: ``engine/checkpoint.py`` copies a view of a larger
      storage before it saves it, and ``state_dict`` saves ``mu`` and ``nu``
      once each, so the files are the foreach optimizer's size.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("FlatAdam takes one parameter group")
        self.count = 0
        self._layout: list[tuple[int, torch.Size, tuple[int, ...]]] = []
        self.mu = self.nu = None
        self._bind()

    @property
    def _params(self) -> list[torch.Tensor]:
        return self.param_groups[0]["params"]

    def _views(self, arena: torch.Tensor, layout=None) -> list[torch.Tensor]:
        return [torch.as_strided(arena, shape, stride, offset)
                for offset, shape, stride in (layout or self._layout)]

    def _bind(self) -> None:
        """Make every parameter's data and gradient views of the arenas, keeping the values,
        the gradients and the moments."""
        params = self._params
        device = params[0].device
        for p in params:
            if p.dtype != torch.float32 or p.device != device or not _dense(p):
                raise ValueError("FlatAdam: every parameter float32, dense, on one device")
        layout, offset = [], 0
        for p in params:
            layout.append((offset, p.shape, p.stride()))
            offset += p.numel()
        master = torch.empty(offset, dtype=torch.float32, device=device)
        grad = torch.zeros(offset, dtype=torch.float32, device=device)
        moments = []
        for old in (self.mu, self.nu):
            new = torch.zeros(offset, dtype=torch.float32, device=device)
            if old is not None:
                torch._foreach_copy_(self._views(new, layout), self._views(old.to(device)))
            moments.append(new)
        with torch.no_grad():
            for p, view, gview in zip(params, self._views(master, layout),
                                      self._views(grad, layout)):
                view.copy_(p)
                if p.grad is not None:
                    gview.copy_(p.grad)
                p.data = view
                p.grad = gview
        self.master, self.grad, (self.mu, self.nu) = master, grad, moments
        self._layout = layout
        self._ptrs = [p.data_ptr() for p in params]
        self._grads = self._views(grad)

    def _check_bound(self) -> None:
        if any(p.data_ptr() != ptr for p, ptr in zip(self._params, self._ptrs)):
            self._bind()

    @torch.no_grad()
    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the grad arena and bind each gradient to its view (never None: see the class)."""
        self._check_bound()
        self.grad.zero_()
        for p, g in zip(self._params, self._grads):
            if p.grad is not g:
                p.grad = g

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._check_bound()
        params = self._params
        unbound = [(p.grad, g) for p, g in zip(params, self._grads) if p.grad is not g]
        for got, g in unbound:  # a gradient that autograd or a wrapper put elsewhere
            g.copy_(got) if got is not None else g.zero_()
        group = self.param_groups[0]
        lr, (b1, b2), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
        self.count += 1
        g = self.grad if not wd else torch.add(self.grad, self.master, alpha=wd)
        self.mu.lerp_(g, 1 - b1)
        self.nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        bias_correction1 = 1 - b1 ** float(self.count)
        bias_correction2 = 1 - b2 ** float(self.count)
        denom = self.nu.sqrt().div_(bias_correction2 ** 0.5).add_(eps)
        self.master.addcdiv_(self.mu, denom, value=-(lr / bias_correction1))
        _bump(params)
        return loss

    def state_dict(self) -> dict:
        group = {k: v for k, v in self.param_groups[0].items() if k != "params"}
        group["params"] = list(range(len(self._params)))
        return {"state": {"count": self.count, "mu": self.mu, "nu": self.nu,
                          "layout": [[list(shape), list(stride)]
                                     for _, shape, stride in self._layout]},
                "param_groups": [group]}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        self._check_bound()
        state = state_dict["state"]
        mine = [[list(shape), list(stride)] for _, shape, stride in self._layout]
        if state["layout"] != mine:
            raise ValueError("FlatAdam state of other parameters (shapes or strides differ)")
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])
        self.count = int(state["count"])
        saved = state_dict["param_groups"][0]
        self.param_groups[0].update({k: v for k, v in saved.items() if k != "params"})


# The JAX package's ``make_train_optimizer(variant=)`` values. ``tree`` is the
# port's optimizer; JAX's ``optax`` chain (coupled L2, ``scale_by_adam``,
# ``scale(-lr)``) is the same update to f32 rounding, so it maps there too.
VARIANTS = ("tree", "flat", "optax")


def make_optimizer(variant: str, params: Iterable[torch.nn.Parameter], learning_rate: float,
                   momentum: float = 0.9, weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """The optimizer JAX's ``variant`` names: ``FlatAdam`` for ``flat``, else the port's."""
    if variant not in VARIANTS:
        raise ValueError(f"optimizer variant {variant!r}: expected one of {VARIANTS}")
    if variant == "flat":
        return FlatAdam(params, lr=learning_rate, betas=(momentum, 0.999), eps=1e-8,
                        weight_decay=weight_decay)
    return schedules.make_train_optimizer(params, learning_rate, momentum, weight_decay)
