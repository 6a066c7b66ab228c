"""Square SAME 3x3 conv: the CUDA kernel, its plain versions, its wrappers.

Replaces ``docs/negative-results/pallas_conv.py:conv3x3_same`` (the Pallas
TPU kernel) at every square (C_in = C_out) 3x3 conv of the ported models,
which the JAX package computes with a flax ``nn.Conv``
(``models/blocks.py:conv3x3``). Two forms:

- ``conv3x3_bias_relu``: relu(conv + bias), the kernel's epilogue doing
  both. The six square decoder convs of unet_resnet50,
  ``up_concat{4,3,2,1}.conv2`` and ``up_conv.1`` / ``up_conv.3``, add a bias
  and apply ReLU right after the conv.
- ``conv3x3_same``: the bias-free conv alone, the Pallas kernel's own
  function (its epilogue off). The ``conv2`` of every ``DoubleConv`` of
  unet_plain and attention_unet (nine per model, C = 64 to 1024), which BN
  and ReLU follow as stock ops.

- Kernel: ``csrc/conv3x3_same.cu``. 408 GFLOP per forward at 480^2, batch 8,
  bf16; its bound on the H100 is ~420 us, set by operations at C >= 128 and
  by bytes and operations alike at C = 64. ``conv3x3_path`` names the path
  a call takes:

  - bf16 with C % 16 == 0 (every bf16 site): an implicit GEMM on the tensor
    cores (TMA halo ring, ``wgmma``): ``c64_persistent`` for C <= 64, a
    kernel of its own with the operands swapped (the weights as A, 256
    pixels of the halo stage at each tap's shift as B, both read from shared
    memory by descriptor; ``c64_schedule``), ``wgmma`` above;
  - f32 with C % 4 == 0 (every f32 site; TMA needs 16-byte strides, 4 f32):
    the same kernel on the TF32 tensor cores with each operand split into
    two tf32 parts (``tf32_split``) and three products summed in f32, which
    keeps f32 accuracy (about 2^-21 of each product): ``tf32x3_c64`` for
    C <= 64 (two pipelines per CTA, each streaming its own weights),
    ``tf32x3`` above; the two read the same packing and give the same bits;
  - everything else on the CUDA cores (``fma``).
- dgrad: the same kernel, as the Pallas kernel's docstring has it: dx is
  the same conv of the output's gradient with the weights flipped in space
  and transposed in channels, the epilogue's bias and ReLU off
  (``conv3x3_dgrad``). It reads the weights the forward packed
  (``pack_conv3x3_grad``), flipped and transposed inside the kernel (bf16
  and ``fma``); the ``tf32x3`` packing holds dgrad's planes beside the
  forward's, written in the same launch. wgrad is cuDNN's
  (``torch.nn.grad.conv2d_weight``): the Pallas kernel never computed it,
  the JAX package left it to XLA.
- Plain versions: ``conv3x3_bias_relu_plain``, ``conv3x3_same_plain`` and
  ``conv3x3_dgrad_plain``, nine shifted-slice products accumulated in
  float32 (autocast off), the arithmetic of the Pallas kernel's per-row
  im2col GEMMs.
- Operators (``ops/library.py``): ``unet_seg::conv3x3_bias_relu(x, weight,
  bias, cache, pad_top, pad_bottom, packed)``, ``unet_seg::conv3x3_same(x,
  weight, cache, pad_top, pad_bottom, packed)`` and
  ``unet_seg::conv3x3_dgrad(g, weight, packed, pad_top, pad_bottom)``
  (``*_op``): on a CUDA tensor the kernel, on a CPU tensor the plain
  version (which reads ``weight``), and a fake implementation for tracing.
  ``cache`` and ``packed`` are the autograd Function's choice, made from
  grad mode outside the operator: grad off, ``cache`` and no ``packed``;
  grad on, the Function's ``pack_conv3x3_grad`` packing, which the forward
  reads and the backward hands to dgrad.
- Wrappers: ``conv3x3_bias_relu`` and ``conv3x3_same``, each a
  ``torch.autograd.Function`` over its operator whose backward runs
  ``conv3x3_dgrad``, and ``conv3x3_dgrad``. A CPU tensor takes the plain
  versions; a CUDA tensor launches the kernel or raises on what the kernel
  does not take. ``conv3x3_bias_relu.launches``, ``conv3x3_same.launches``
  and ``conv3x3_dgrad.launches`` count kernel launches and nothing else
  (not calls traced with fake tensors).

Halo-padded mode (the mesh's ``space`` axis, ``parallel/halo.py``): every
form takes ``pad=(pad_top, pad_bottom)``, the zero rows above and below x
in H, 0 to 2 each; the default (1, 1) is SAME, the call of one whole image,
bit for bit as before. The output has ``h + pad_top + pad_bottom - 2``
rows, output row y reading input rows ``y - pad_top .. y - pad_top + 2``. A
band with its neighbours' rows exchanged runs with 0 inside the image and 1
at its global edge. Its backward runs dgrad with ``(2 - pad_top, 2 -
pad_bottom)``, whose output carries the halo rows' gradients (the
exchange's backward returns them), and wgrad (cuDNN's) on the input with
its global-edge zero rows written out, H padding 0. The wrappers'
``.halo_launches`` count the launches with pads other than (1, 1) (they
are counted in ``.launches`` too).

Weights are OIHW (``nn.Conv2d``'s layout). ``pack_conv3x3_weight`` puts them
in the kernel's layout. With grad mode off (predict, eval) the wrappers pack
a weight once per parameter version and keep the packed copy, and the
float32 bias where there is one, until the parameter is updated in place,
given a new storage, or freed (``_packed_params``, which also states what
the cache cannot see). With grad on (training) every forward packs anew
(``pack_conv3x3_grad``) and saves the packing for its backward: nothing is
cached across calls, and nothing is packed in the backward, so a captured
CUDA graph of a train step repacks what the weights hold at each replay. A
bf16 call reads its weights and its bias rounded to bf16, as the JAX
package's AMP computes with bf16 copies of every parameter
(``TreeAdam.cast_params``); the kernel adds the bias in f32.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet_embroidery_seg_torch.ops import _build
from unet_embroidery_seg_torch.ops.library import as_kernel_layout, empty_kernel_output

__all__ = ["TF32X3_PATHS", "conv3x3_bias_relu", "conv3x3_bias_relu_plain", "conv3x3_dgrad",
           "conv3x3_dgrad_plain", "conv3x3_path", "conv3x3_same", "conv3x3_same_plain",
           "pack_conv3x3_grad", "pack_conv3x3_weight", "pick_tile", "pick_tile_c64",
           "c64_schedule", "streamed_schedule", "tf32_split"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_PACK_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p]
# A launch's mode (``csrc/conv3x3_same.cu``'s MODE_*): the bare conv,
# relu(conv + bias), or dgrad reading the forward's packing flipped and
# transposed in the kernel (bf16 tensor-core and ``fma`` paths).
MODE_CONV, MODE_BIAS_RELU, MODE_DGRAD = 0, 1, 2
SAME = (1, 1)
# Input channels per halo stage of a tensor-core path: 128 bytes of the type.
CHUNK = {torch.bfloat16: 64, torch.float32: 32}
# The f32 tensor-core paths (3xTF32): C <= 64, and above. Both read the
# ``tf32x3`` packing.
TF32X3_PATHS = ("tf32x3_c64", "tf32x3")
# C entry point of each tensor-core path.
_TC_SYMBOLS = {"c64_persistent": "conv3x3_wgmma_launch", "wgmma": "conv3x3_wgmma_launch",
               "tf32x3_c64": "conv3x3_tf32x3_launch", "tf32x3": "conv3x3_tf32x3_launch"}


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  pad: tuple[int, int] = SAME) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be NCHW, got shape {tuple(x.shape)}")
    if not all(0 <= p <= 2 for p in pad) or out_rows(x.shape[2], pad) < 1:
        raise ValueError(f"conv3x3: pads {tuple(pad)} (0 to 2 each) leave no output row "
                         f"of {x.shape[2]}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, c, 3, 3):
        raise ValueError(f"conv3x3: needs a ({c}, {c}, 3, 3) weight for {c} channels, "
                         f"got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"conv3x3: needs a ({c},) bias for {c} channels, got {tuple(bias.shape)}")


def out_rows(h: int, pad: tuple[int, int]) -> int:
    """Output rows of a call on ``h`` input rows with H pads ``pad``."""
    return h + pad[0] + pad[1] - 2


def dgrad_pad(pad: tuple[int, int]) -> tuple[int, int]:
    """dgrad's pads for a forward with ``pad``: its output has the forward's input rows."""
    return 2 - pad[0], 2 - pad[1]


# ``csrc/conv3x3_same.cu``'s tensor-core tiles: pixels per tile, the most
# rows a halo stage holds, the tile widths ``pick_tile`` tries. The bf16
# streamed layout (``wgmma``): output channels per tile, CTAs per cluster
# (which share each weight stage, TMA multicast), bytes of a weight stage
# (one tap of one 64-channel chunk for the tile's output channels).
TILE_M, HALO_ROWS, TILE_WIDTHS = 128, 192, (8, 16, 30)
STREAMED_BN, STREAMED_CLUSTER = 128, 2
STREAMED_STAGE_BYTES = STREAMED_BN * 64 * 2


def pick_tile(h: int, w: int) -> tuple[int, int]:
    """The kernel's (TH, TW) for an ``h`` x ``w`` output (``csrc/conv3x3_same.cu:pick_tile``).

    TH = 128 // TW rows of TW pixels, the fewest M rows over the map, ties
    to the smaller halo box.
    """
    best = None
    for tw in TILE_WIDTHS:
        th = TILE_M // tw
        halo = (th + 2) * (tw + 2)
        if halo > HALO_ROWS:
            continue
        key = (-(-h // th) * -(-w // tw) * TILE_M, halo)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return best[1]


def streamed_schedule(n: int, h: int, w: int, c: int, pad: tuple[int, int] = SAME) -> dict:
    """The work of one ``wgmma`` launch on ``h`` input rows, as the kernel's launch lays it out.

    Pixel tiles (``pick_tile``) run x fastest, then y, then image; an item
    is ``cluster`` neighbouring pixel tiles of one 128-channel tile, the
    channel tile fastest, and the cluster's CTA of rank r computes the r-th
    (a tail short of a tile computes the last tile again and stores
    nothing). Each CTA loads 1/``cluster`` of every weight stage and
    receives the rest from the others, so the weights read from L2 are
    ``l2_weight_bytes`` = items x 9 taps x chunks x a stage.
    """
    th, tw = pick_tile(out_rows(h, pad), w)
    tiles_x, tiles_y = -(-w // tw), -(-out_rows(h, pad) // th)
    pix_tiles, co_tiles = n * tiles_y * tiles_x, -(-c // STREAMED_BN)
    chunks = -(-c // CHUNK[torch.bfloat16])
    items = -(-pix_tiles // STREAMED_CLUSTER) * co_tiles
    return {"tile": (th, tw), "tiles": (tiles_y, tiles_x), "pix_tiles": pix_tiles,
            "co_tiles": co_tiles, "chunks": chunks, "cluster": STREAMED_CLUSTER, "items": items,
            "l2_weight_bytes": items * 9 * chunks * STREAMED_STAGE_BYTES}


# The bf16 C <= 64 kernel (``c64_persistent``, ``conv3x3_c64_kernel``): pixels
# per tile (the wgmma N), the tile shapes (TW, TH) its launch picks from, halo
# stages (shared by its two consumer warpgroups), rows of a stage.
C64_N, C64_TILES, C64_STAGES, C64_HALO_ROWS = 256, ((30, 8), (40, 6), (14, 16)), 3, 352


def pick_tile_c64(h: int, w: int) -> tuple[int, int]:
    """The C <= 64 kernel's (TH, TW) for an ``h`` x ``w`` output (``pick_tile_c64`` in the .cu).

    The ``C64_TILES`` shape with the fewest tiles, ties to the first: every
    tile is one full N of 256 pixels, TH rows at the halo's pitch TW + 2.
    """
    best = None
    for tw, th in C64_TILES:
        tiles = -(-w // tw) * -(-h // th)
        if best is None or tiles < best[0]:
            best = (tiles, (th, tw))
    return best[1]


def c64_schedule(n: int, h: int, w: int, pad: tuple[int, int] = SAME, sms: int = 132) -> dict:
    """The work of one ``c64_persistent`` launch on ``h`` input rows, as the kernel lays it out.

    Pixel tiles (``pick_tile_c64``) run x fastest, then y, then image. CTA b
    of ``grid`` (at most ``sms``, at least two items each) takes items b, b +
    grid, ...: its k-th goes to consumer warpgroup k % 2 and halo stage k % 3.
    A tile is N = 256 pixels at the halo's pitch TW + 2 (``halo_pitch``): the
    2 columns past TW of each row, and the pixels past TH rows, are computed
    and dropped (``dropped_share`` of the MMA columns).
    """
    oh = out_rows(h, pad)
    th, tw = pick_tile_c64(oh, w)
    tiles_x, tiles_y = -(-w // tw), -(-oh // th)
    items = n * tiles_x * tiles_y
    grid = min(-(-items // 2), sms)
    return {"tile": (th, tw), "halo_pitch": tw + 2, "tiles": (tiles_y, tiles_x), "items": items,
            "grid": grid, "items_per_cta": -(-items // grid),
            "dropped_share": 1 - th * tw / C64_N}


def conv3x3_path(c: int, dtype: torch.dtype) -> str:
    """The kernel path a CUDA call with ``c`` channels of ``dtype`` takes.

    bf16 with C % 16 == 0: ``c64_persistent`` (C <= 64) or ``wgmma``; f32
    with C % 4 == 0 (TMA's 16-byte strides): ``tf32x3_c64`` (C <= 64) or
    ``tf32x3``; the rest ``fma``.
    """
    if dtype == torch.bfloat16 and c % 16 == 0:
        return "c64_persistent" if c <= 64 else "wgmma"
    if dtype == torch.float32 and c % 4 == 0:
        return "tf32x3_c64" if c <= 64 else "tf32x3"
    return "fma"


def _tc_layout(c: int, dtype: torch.dtype) -> tuple[int, int]:
    """(input-channel chunks, padded output channels) of a tensor-core layout.

    Tiles of 64 output channels for C <= 64, 128 above, in both types.
    """
    bn = 64 if c <= 64 else 128
    return -(-c // CHUNK[dtype]), -(-c // bn) * bn


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away, as ``cvt.rna``.

    On the bits: add half of the dropped 13 bits' range, then clear them;
    the carry rounds the magnitude up, whatever the sign.
    """
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) tf32 parts of an f32 tensor: big = rna(t), small = rna(t - big).

    ``big + small`` is within 2^-22 of ``t`` relatively (t - big is exact in
    f32, and rounding it keeps 11 of its bits), the split the ``tf32x3``
    kernel makes of its inputs in registers and of the weights here.
    """
    big = _round_tf32(t)
    return big, _round_tf32(t - big)


def pack_conv3x3_weight(weight: torch.Tensor, dtype: torch.dtype,
                        path: str | None = None) -> torch.Tensor:
    """An OIHW (C, C, 3, 3) weight in the layout ``path`` reads, in ``dtype``.

    ``path`` defaults to ``conv3x3_path``'s choice for C and ``dtype``; the
    only other one that takes a call is ``fma``.

    - ``c64_persistent`` / ``wgmma``: [tap = ky*3 + kx][input-channel chunk of
      64][co_pad][64], zero where C_in or C_out is padded (co_pad is C rounded
      up to the kernel's 64 or 128 output channels per tile).
    - ``tf32x3`` and ``tf32x3_c64``: [plane][tap][input-channel chunk of
      32][co_pad][32], plane 0 ``w_big`` and plane 1 ``w_small`` of
      ``tf32_split``.
    - ``fma``: [ky][kx][co][ci].
    """
    c = weight.shape[0]
    w = weight.detach().to(dtype).permute(2, 3, 0, 1)  # [ky][kx][co][ci]
    path = path or conv3x3_path(c, dtype)
    if path not in ("fma", conv3x3_path(c, dtype)):
        raise ValueError(f"pack_conv3x3_weight: path {path} does not take {c} channels of {dtype}")
    if path == "fma":
        return w.contiguous()
    chunks, co_pad = _tc_layout(c, dtype)
    chunk = CHUNK[dtype]
    w = F.pad(w, (0, chunks * chunk - c, 0, co_pad - c))  # [ky][kx][co_pad][chunks*chunk]
    w = w.reshape(9, co_pad, chunks, chunk).permute(0, 2, 1, 3)
    if path in TF32X3_PATHS:
        return torch.stack(tf32_split(w))
    return w.contiguous()


def _grad_pack_shape(c: int, dtype: torch.dtype) -> tuple[int, ...]:
    """The shape ``pack_conv3x3_grad`` gives for C channels of ``dtype``."""
    path = conv3x3_path(c, dtype)
    if path == "fma":
        return (3, 3, c, c)
    chunks, co_pad = _tc_layout(c, dtype)
    tile = (9, chunks, co_pad, CHUNK[dtype])
    return (2, 2, *tile) if path in TF32X3_PATHS else tile


def pack_conv3x3_grad(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The packing a forward with grad on makes, reads, and saves for dgrad.

    bf16 tensor-core paths and ``fma``: ``pack_conv3x3_weight``'s layout,
    which dgrad's kernel reads flipped in space and transposed in channels.
    ``tf32x3`` (wgmma takes no transposed tf32 B): [layout][plane][tap]
    [chunk of 32][co_pad][32], layout 0 the forward's planes and layout 1
    dgrad's, ``pack_conv3x3_weight`` of the weight and of ``_dgrad_weight``
    of it, bit for bit. On the card one kernel launch writes both
    (``conv3x3_pack_tf32x3``, counted by ``pack_conv3x3_grad.launches``); on
    the CPU the plain version stacks the two packings.
    """
    c = weight.shape[0]
    if tuple(weight.shape) != (c, c, 3, 3):
        raise ValueError(f"conv3x3: needs a ({c}, {c}, 3, 3) weight, got {tuple(weight.shape)}")
    if conv3x3_path(c, dtype) not in TF32X3_PATHS:
        return pack_conv3x3_weight(weight, dtype)
    if weight.device.type != "cuda":
        return torch.stack([pack_conv3x3_weight(weight, dtype),
                            pack_conv3x3_weight(_dgrad_weight(weight), dtype)])
    w = weight.detach().float()
    out = torch.empty(_grad_pack_shape(c, dtype), dtype=torch.float32, device=w.device)
    chunks, co_pad = out.shape[3], out.shape[4]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    fn = _build.load("conv3x3_same", "conv3x3_pack_tf32x3_launch", _PACK_ARGTYPES)
    with torch.cuda.device(w.device):
        code = fn(w.data_ptr(), out.data_ptr(), c, chunks, co_pad, *w.stride(), stream)
    _build.check(code, "pack_conv3x3_grad")
    pack_conv3x3_grad.launches += 1
    return out


pack_conv3x3_grad.launches = 0


def _check_grad_pack(packed: torch.Tensor | None, c: int, dtype: torch.dtype, what: str) -> None:
    """Raises unless ``packed`` is ``pack_conv3x3_grad``'s packing for C channels of ``dtype``.

    None (a forward operator given no packing) passes.
    """
    if packed is None:
        return
    shape = _grad_pack_shape(c, dtype)
    if (tuple(packed.shape) != shape or packed.dtype != dtype or not packed.is_contiguous()):
        raise ValueError(f"{what}: needs pack_conv3x3_grad's packing {shape} of {dtype}, got "
                         f"{tuple(packed.shape)} of {packed.dtype}")


# (id weight, id bias or None, dtype) -> ((ptr, version) of the weight and
# the bias, packed weight, f32 bias or None). An entry goes when its weight
# or bias is freed (``weakref.finalize``), so a later tensor with a reused
# id never sees it, and it serves only at the pointers and versions it was
# made at: an in-place update (``_version``) or a new storage (``p.data =
# t``) repacks. ``conv3x3_same`` keeps weight-only entries (no bias).
_packed: dict[tuple, tuple] = {}


def _version(t: torch.Tensor) -> int | None:
    return None if t.is_inference() else t._version  # inference tensors keep no counter


def _pack(weight: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype):
    """The packed weight and the bias as f32 holding ``dtype``'s values (None without one)."""
    b = None if bias is None else bias.detach().to(dtype).float().contiguous()
    return pack_conv3x3_weight(weight, dtype), b


def _packed_params(weight: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype):
    """The packed weight and f32 bias (None without one), cached only while grad mode is off.

    With grad on (training) the weights change every step, so each call
    packs. Grad off (``no_grad``, ``inference_mode``: predict, eval) caches
    one packing per parameter version. An update made through ``p.data``
    (``p.data.mul_(...)``) bypasses the version counter, as it bypasses
    autograd, and is not seen there: update parameters in place under
    ``torch.no_grad()`` instead, or assign a new tensor.
    """
    tensors = (weight,) if bias is None else (weight, bias)
    versions = [_version(t) for t in tensors]
    if torch.is_grad_enabled() or None in versions:
        return _pack(weight, bias, dtype)
    key = (id(weight), None if bias is None else id(bias), dtype)
    state = tuple((t.data_ptr(), v) for t, v in zip(tensors, versions))
    hit = _packed.get(key)
    if hit is not None and hit[0] == state:
        return hit[1], hit[2]
    if hit is None:
        for t in tensors:
            weakref.finalize(t, _packed.pop, key, None)
    packed, b = _pack(weight, bias, dtype)
    _packed[key] = (state, packed, b)
    return packed, b


def _conv3x3_f32(x: torch.Tensor, weight: torch.Tensor,
                 pad: tuple[int, int] = SAME) -> torch.Tensor:
    """3x3 conv (H pads ``pad``, W SAME) as nine shifted-slice products, in f32.

    Weights rounded to ``x.dtype``; autocast is off inside: under it the
    products would run in bf16.
    """
    n, c, _, w = x.shape
    h = out_rows(x.shape[2], pad)
    with torch.autocast(x.device.type, enabled=False):
        xp = F.pad(x.float(), (1, 1, pad[0], pad[1]))
        wf = weight.to(x.dtype).float()
        acc = torch.zeros((n, c, h, w), dtype=torch.float32, device=x.device)
        for ky in range(3):
            for kx in range(3):
                acc += torch.einsum(
                    "nihw,oi->nohw", xp[:, :, ky : ky + h, kx : kx + w], wf[:, :, ky, kx]
                )
    return acc


def conv3x3_bias_relu_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pad: tuple[int, int] = SAME
) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) + bias) as nine shifted-slice products.

    The weights and the bias are rounded to ``x.dtype`` (as the kernel reads
    them), then everything is accumulated in float32 and the result cast to
    ``x.dtype``. ``pad``: the H pads, as the kernel's.
    """
    _check_shapes(x, weight, bias, pad)
    y = torch.relu(_conv3x3_f32(x, weight, pad) + bias.to(x.dtype).float()[None, :, None, None])
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def conv3x3_same_plain(x: torch.Tensor, weight: torch.Tensor,
                       pad: tuple[int, int] = SAME) -> torch.Tensor:
    """conv3x3_same(x, weight), no bias, as nine shifted-slice products.

    The Pallas kernel's own function. The weights are rounded to ``x.dtype``
    (as the kernel reads them), everything is accumulated in float32 and the
    result cast to ``x.dtype``, in ``channels_last`` memory. ``pad``: the H
    pads, as the kernel's.
    """
    _check_shapes(x, weight, None, pad)
    return _conv3x3_f32(x, weight, pad).to(x.dtype).contiguous(memory_format=torch.channels_last)


def _dgrad_weight(weight: torch.Tensor) -> torch.Tensor:
    """W flipped in space and transposed in channels: dgrad's conv weight."""
    return weight.detach().flip(2, 3).transpose(0, 1)


def conv3x3_dgrad_plain(g: torch.Tensor, weight: torch.Tensor,
                        pad: tuple[int, int] = SAME) -> torch.Tensor:
    """dx of conv3x3_same(x, weight) from the output's gradient ``g``, as nine products.

    The same conv of ``g`` with the weights flipped in space and transposed
    in channels, rounded to ``g.dtype``, accumulated in float32, cast to
    ``g.dtype`` (the kernel's arithmetic). ``pad`` is dgrad's own H pads
    (``dgrad_pad`` of the forward's).
    """
    _check_shapes(g, weight, None, pad)
    dx = _conv3x3_f32(g, _dgrad_weight(weight), pad)
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def _launch(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor | None,
            what: str, path: str | None = None, pad: tuple[int, int] = SAME,
            dgrad: bool = False) -> torch.Tensor:
    """The kernel on ``x`` with packed weights; bias and ReLU fused when ``bias`` is given.

    ``path`` (``conv3x3_path``'s choice by default) must be the one the
    weights were packed for; ``fma`` takes any call. ``pad``: the H pads.
    ``dgrad``: ``x`` is an output's gradient and ``packed`` the forward's
    packing, which the kernel reads flipped and transposed (MODE_DGRAD; the
    bf16 tensor-core paths and ``fma``, no bias).
    """
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: needs float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: the CUDA kernel needs channels_last memory")
    if packed.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"{what}: x, weight and bias must be on one device")
    n, c, h, w = x.shape
    path = path or conv3x3_path(c, x.dtype)
    if path != "fma" and path != conv3x3_path(c, x.dtype):
        raise ValueError(f"{what}: path {path} does not take {c} channels of {x.dtype}")
    if path != "fma" and x.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: the tensor-core paths need a 16-byte aligned input (TMA)")
    if dgrad and (path in TF32X3_PATHS or bias is not None):
        raise ValueError(f"{what}: MODE_DGRAD takes no bias and no tf32x3 call")
    out = empty_kernel_output((n, c, out_rows(h, pad), w), x)
    if out.numel() == 0:
        return out
    b = 0 if bias is None else bias.data_ptr()
    mode = MODE_DGRAD if dgrad else MODE_CONV if bias is None else MODE_BIAS_RELU
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if path == "fma":
            fn = _build.load("conv3x3_same", "conv3x3_fma_launch", _FMA_ARGTYPES)
            code = fn(x.data_ptr(), packed.data_ptr(), b, out.data_ptr(), n, h, w, c,
                      _DTYPE_CODES[x.dtype], mode, pad[0], pad[1], stream)
        else:
            fn = _build.load("conv3x3_same", _TC_SYMBOLS[path], _TC_ARGTYPES)
            code = fn(x.data_ptr(), packed.data_ptr(), b, out.data_ptr(), n, h, w, c, mode,
                      pad[0], pad[1], stream)
    _build.check(code, what)
    return out


def _count(wrapper, pad: tuple[int, int]) -> None:
    wrapper.launches += 1
    if tuple(pad) != SAME:
        wrapper.halo_launches += 1


def _forward_weights(weight: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype,
                     cache: bool, packed: torch.Tensor | None, what: str):
    """The forward's packed weights (``tf32x3`` grad packing: its layout 0) and f32 bias.

    ``packed`` (grad on): the autograd Function's ``pack_conv3x3_grad``;
    without it ``cache`` takes the per-version cache (grad off), else the
    call packs anew.
    """
    if packed is None:
        return _packed_params(weight, bias, dtype) if cache else _pack(weight, bias, dtype)
    _check_grad_pack(packed, weight.shape[0], dtype, what)
    b = None if bias is None else bias.detach().to(dtype).float().contiguous()
    return (packed[0] if packed.dim() == 6 else packed), b


def _conv3x3_bias_relu_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            cache: bool, pad_top: int = 1, pad_bottom: int = 1,
                            packed: torch.Tensor | None = None) -> torch.Tensor:
    """``unet_seg::conv3x3_bias_relu`` on a CUDA tensor: the kernel with bias and ReLU fused.

    ``packed``: the Function's ``pack_conv3x3_grad`` packing (grad on);
    without it, ``cache`` takes the packed weights from the per-version
    cache (grad mode off), else the call packs them anew. ``pad_top``,
    ``pad_bottom``: the H pads.
    """
    pad = (pad_top, pad_bottom)
    _check_shapes(x, weight, bias, pad)
    wpk, b = _forward_weights(weight, bias, x.dtype, cache, packed, "conv3x3")
    out = _launch(x, wpk, b, "conv3x3", pad=pad)
    _count(conv3x3_bias_relu, pad)
    return out


conv3x3_bias_relu_op = torch.library.custom_op(
    "unet_seg::conv3x3_bias_relu", _conv3x3_bias_relu_cuda, mutates_args=(),
    device_types="cuda")


@conv3x3_bias_relu_op.register_kernel("cpu")
def _(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, cache: bool,
      pad_top: int = 1, pad_bottom: int = 1, packed: torch.Tensor | None = None) -> torch.Tensor:
    _check_grad_pack(packed, x.shape[1], x.dtype, "conv3x3")
    return as_kernel_layout(conv3x3_bias_relu_plain(x, weight, bias, (pad_top, pad_bottom)))


@conv3x3_bias_relu_op.register_fake
def _(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, cache: bool,
      pad_top: int = 1, pad_bottom: int = 1, packed: torch.Tensor | None = None) -> torch.Tensor:
    pad = (pad_top, pad_bottom)
    _check_shapes(x, weight, bias, pad)
    _check_grad_pack(packed, x.shape[1], x.dtype, "conv3x3")
    n, c, h, w = x.shape
    return empty_kernel_output((n, c, out_rows(h, pad), w), x)


def _conv3x3_dgrad_cuda(g: torch.Tensor, weight: torch.Tensor, packed: torch.Tensor,
                        pad_top: int = 1, pad_bottom: int = 1) -> torch.Tensor:
    """``unet_seg::conv3x3_dgrad`` on a CUDA tensor: the kernel on the forward's packing.

    bf16 and ``fma``: the kernel reads ``packed`` flipped in space and
    transposed in channels (MODE_DGRAD); ``tf32x3``: the bare conv on the
    packing's dgrad planes (layout 1). Nothing is packed here.
    """
    pad = (pad_top, pad_bottom)
    _check_shapes(g, weight, None, pad)
    _check_grad_pack(packed, g.shape[1], g.dtype, "conv3x3_dgrad")
    if packed.dim() == 6:  # tf32x3
        dx = _launch(g, packed[1], None, "conv3x3_dgrad", pad=pad)
    else:
        dx = _launch(g, packed, None, "conv3x3_dgrad", pad=pad, dgrad=True)
    _count(conv3x3_dgrad, pad)
    return dx


conv3x3_dgrad_op = torch.library.custom_op(
    "unet_seg::conv3x3_dgrad", _conv3x3_dgrad_cuda, mutates_args=(), device_types="cuda")


@conv3x3_dgrad_op.register_kernel("cpu")
def _(g: torch.Tensor, weight: torch.Tensor, packed: torch.Tensor, pad_top: int = 1,
      pad_bottom: int = 1) -> torch.Tensor:
    _check_grad_pack(packed, g.shape[1], g.dtype, "conv3x3_dgrad")  # the plain version reads weight
    return as_kernel_layout(conv3x3_dgrad_plain(g, weight, (pad_top, pad_bottom)))


@conv3x3_dgrad_op.register_fake
def _(g: torch.Tensor, weight: torch.Tensor, packed: torch.Tensor, pad_top: int = 1,
      pad_bottom: int = 1) -> torch.Tensor:
    pad = (pad_top, pad_bottom)
    _check_shapes(g, weight, None, pad)
    _check_grad_pack(packed, g.shape[1], g.dtype, "conv3x3_dgrad")
    n, c, h, w = g.shape
    return empty_kernel_output((n, c, out_rows(h, pad), w), g)


def conv3x3_dgrad(g: torch.Tensor, weight: torch.Tensor, pad: tuple[int, int] = SAME,
                  packed: torch.Tensor | None = None) -> torch.Tensor:
    """dx of conv3x3_same(x, weight) from the output's gradient ``g`` (NCHW).

    A CPU tensor takes ``conv3x3_dgrad_plain``; a CUDA tensor (channels_last)
    runs the conv kernel on ``g`` with the weights flipped and transposed
    and its epilogue's bias and ReLU off, reading ``packed``, the forward's
    ``pack_conv3x3_grad(weight, g.dtype)`` (the Functions' backward hands
    over the one their forward made; a call with none packs it here).
    ``pad`` is dgrad's own H pads (``dgrad_pad`` of the forward's).
    """
    if packed is None:
        packed = pack_conv3x3_grad(weight, g.dtype)
    return conv3x3_dgrad_op(g, weight, packed, *pad)


conv3x3_dgrad.launches = 0
conv3x3_dgrad.halo_launches = 0


def _wgrad(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
           pad: tuple[int, int]) -> torch.Tensor:
    """dW of the conv with H pads ``pad`` (cuDNN's wgrad on the card), in the weight's dtype.

    SAME is cuDNN's padding 1; other pads write their zero rows out and pad
    H by 0, so the input rows the forward read are the rows wgrad reads.
    """
    if tuple(pad) == SAME:
        return torch.nn.grad.conv2d_weight(x, weight.shape, g, padding=1).to(weight.dtype)
    xp = F.pad(x, (0, 0, pad[0], pad[1])) if pad[0] or pad[1] else x
    return torch.nn.grad.conv2d_weight(xp, weight.shape, g, padding=(0, 1)).to(weight.dtype)


class _Conv3x3BiasRelu(torch.autograd.Function):
    """relu(conv(x, W) + b) with the kernels forward and (dgrad) backward.

    With grad on the forward packs W once (``pack_conv3x3_grad``), reads the
    packing and saves it. Backward of the fused op: g_pre = g * (y > 0)
    with y the saved output; dx = dgrad(g_pre) through the conv kernel on
    the saved packing; db = sum of g_pre; dW by
    ``torch.nn.grad.conv2d_weight`` (cuDNN on the card), as the JAX package
    left wgrad to XLA. dW and db come back in the parameters' dtype.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, cache: bool, pad: tuple[int, int]):
        packed = None if cache else pack_conv3x3_grad(weight, x.dtype)
        y = conv3x3_bias_relu_op(x, weight, bias, cache, *pad, packed=packed)
        if not cache:  # grad mode on: a backward may follow
            ctx.save_for_backward(x, weight, y, packed)
            ctx.bias_dtype, ctx.pad = bias.dtype, pad
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, y, packed = ctx.saved_tensors
        g_pre = torch.empty_like(y, memory_format=torch.channels_last)
        torch.ops.aten.threshold_backward.grad_input(g, y, 0, grad_input=g_pre)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dgrad_op(g_pre, weight, packed, *dgrad_pad(ctx.pad)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _wgrad(x, weight, g_pre.to(x.dtype), ctx.pad)
        if ctx.needs_input_grad[2]:
            db = g_pre.sum(dim=(0, 2, 3), dtype=torch.float32).to(ctx.bias_dtype)
        return dx, dw, db, None, None


def conv3x3_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      pad: tuple[int, int] = SAME) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) + bias) for an NCHW tensor (channels_last on the card).

    Differentiable in x, weight and bias. With grad mode off the packed
    weights come from the per-version cache; with it on (training) every
    call packs what the weight holds now, and its backward's dgrad reads
    that packing. ``pad``: the H pads (SAME: 1, 1).
    """
    return _Conv3x3BiasRelu.apply(x, weight, bias, not torch.is_grad_enabled(), tuple(pad))


conv3x3_bias_relu.launches = 0
conv3x3_bias_relu.halo_launches = 0


def _conv3x3_same_cuda(x: torch.Tensor, weight: torch.Tensor, cache: bool, pad_top: int = 1,
                       pad_bottom: int = 1, packed: torch.Tensor | None = None) -> torch.Tensor:
    """``unet_seg::conv3x3_same`` on a CUDA tensor: the kernel, epilogue off.

    ``cache`` and ``packed`` as ``_conv3x3_bias_relu_cuda``'s; ``pad_top``,
    ``pad_bottom``: the H pads.
    """
    pad = (pad_top, pad_bottom)
    _check_shapes(x, weight, None, pad)
    wpk, _ = _forward_weights(weight, None, x.dtype, cache, packed, "conv3x3_same")
    out = _launch(x, wpk, None, "conv3x3_same", pad=pad)
    _count(conv3x3_same, pad)
    return out


conv3x3_same_op = torch.library.custom_op(
    "unet_seg::conv3x3_same", _conv3x3_same_cuda, mutates_args=(), device_types="cuda")


@conv3x3_same_op.register_kernel("cpu")
def _(x: torch.Tensor, weight: torch.Tensor, cache: bool, pad_top: int = 1,
      pad_bottom: int = 1, packed: torch.Tensor | None = None) -> torch.Tensor:
    _check_grad_pack(packed, x.shape[1], x.dtype, "conv3x3_same")
    return as_kernel_layout(conv3x3_same_plain(x, weight, (pad_top, pad_bottom)))


@conv3x3_same_op.register_fake
def _(x: torch.Tensor, weight: torch.Tensor, cache: bool, pad_top: int = 1,
      pad_bottom: int = 1, packed: torch.Tensor | None = None) -> torch.Tensor:
    pad = (pad_top, pad_bottom)
    _check_shapes(x, weight, None, pad)
    _check_grad_pack(packed, x.shape[1], x.dtype, "conv3x3_same")
    n, c, h, w = x.shape
    return empty_kernel_output((n, c, out_rows(h, pad), w), x)


class _Conv3x3Same(torch.autograd.Function):
    """conv(x, W), no bias, with the kernel forward (epilogue off) and dgrad backward.

    With grad on the forward packs W once (``pack_conv3x3_grad``), reads the
    packing and saves it. Backward: dx = dgrad(g) through the conv kernel on
    the saved packing; dW by ``torch.nn.grad.conv2d_weight`` (cuDNN on the
    card), as the JAX package left wgrad to XLA. There is no ReLU mask: BN
    and ReLU follow as stock ops. On the card ``g`` (BN's input gradient) is
    made ``channels_last`` if it is not, which the kernel reads.
    """

    @staticmethod
    def forward(ctx, x, weight, cache: bool, pad: tuple[int, int]):
        packed = None if cache else pack_conv3x3_grad(weight, x.dtype)
        y = conv3x3_same_op(x, weight, cache, *pad, packed=packed)
        if not cache:  # grad mode on: a backward may follow
            ctx.save_for_backward(x, weight, packed)
            ctx.pad = pad
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, packed = ctx.saved_tensors
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dgrad_op(g, weight, packed, *dgrad_pad(ctx.pad))
        if ctx.needs_input_grad[1]:
            dw = _wgrad(x, weight, g, ctx.pad)
        return dx, dw, None, None


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor,
                 pad: tuple[int, int] = SAME) -> torch.Tensor:
    """conv3x3_same(x, weight), no bias, for an NCHW tensor (channels_last on the card).

    Differentiable in x and weight. With grad mode off the packed weights
    come from the per-version cache; with it on (training) every call packs
    what the weight holds now, and its backward's dgrad reads that packing.
    ``pad``: the H pads (SAME: 1, 1).
    """
    return _Conv3x3Same.apply(x, weight, not torch.is_grad_enabled(), tuple(pad))


conv3x3_same.launches = 0
conv3x3_same.halo_launches = 0
