"""bf16 (AMP) parameter rounding: the port against the JAX package on the CPU.

Under AMP the JAX package computes with bf16 copies of every parameter
(``ops/flat_adam.py:TreeAdam.cast_params``). The port keeps float32
parameters under ``torch.autocast`` and reads each one as its bf16 value:
autocast casts the stock convs' weights and biases, the conv3x3 wrappers
round their weights and bias, ``BatchNorm`` and the diff head round theirs.
These tests hold each of those roundings, pin the one place the port keeps
float32 on purpose (the upsample's interpolation weights), and hold each
ported family's bf16 forward to JAX's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.engine.steps import make_predict_fn as jax_make_predict_fn
from unet_embroidery_seg_tpu.models import SUPPORTED_MODELS as JAX_MODELS
from unet_embroidery_seg_tpu.models import blocks as jax_blocks
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.models import init_model
from unet_embroidery_seg_tpu.ops import resize as jax_resize
from unet_embroidery_seg_tpu.ops.flat_adam import TreeAdam
from unet_embroidery_seg_torch.engine.steps import make_predict_fn
from unet_embroidery_seg_torch.models import build_model
from unet_embroidery_seg_torch.models.blocks import BatchNorm, ClassHead
from unet_embroidery_seg_torch.models.unet_attention import AttentionUNet
from unet_embroidery_seg_torch.models.unet_dualdense import DualDenseUNet
from unet_embroidery_seg_torch.models.unet_plain import UNetPlain
from unet_embroidery_seg_torch.ops import conv3x3 as conv3x3_mod
from unet_embroidery_seg_torch.ops.resize import _interp_matrix, upsample2x_plain
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

BF16 = torch.bfloat16
PORT_CLASSES = {"unet_plain": UNetPlain, "attention_unet": AttentionUNet,
                "dualdense_unet": DualDenseUNet}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


# --- the diff head -------------------------------------------------------------------


def test_diff_head_equals_jax_bf16_diff_head_bit_for_bit():
    c = 64
    rng = np.random.RandomState(0)
    kernel = (0.02 * rng.randn(1, 1, c, 2)).astype(np.float32)  # the reference init's scale
    bias = (0.02 * rng.randn(2)).astype(np.float32)
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    head = jax_blocks.ClassHead(num_classes=2, diff=True, dtype=jnp.bfloat16)
    params = TreeAdam(1e-4).cast_params({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)})
    want = np.asarray(head.apply({"params": params}, xb).astype(jnp.float32))

    port = ClassHead(c, 2, diff=True)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel[0, 0].T.copy())[:, :, None, None])
        port.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == BF16 and got.shape == (2, 5, 7)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # The repair matters at this seed: subtracting the f32 masters and then
    # rounding (the port before) gives other bf16 weights than JAX's.
    w = port.weight[:, :, 0, 0].detach()
    assert not torch.equal((w[1] - w[0]).to(BF16), w.to(BF16)[1] - w.to(BF16)[0])


def test_diff_head_in_f32_is_the_f32_difference():
    port = ClassHead(8, 2, diff=True)
    torch.nn.init.normal_(port.weight, 0.0, 0.5, generator=torch.Generator().manual_seed(1))
    torch.nn.init.normal_(port.bias, 0.0, 0.5, generator=torch.Generator().manual_seed(2))
    x = torch.randn(1, 8, 3, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = port(x)
        w = port.weight[:, :, 0, 0]
        want = torch.einsum("nchw,c->nhw", x, w[1] - w[0]) + (port.bias[1] - port.bias[0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- BatchNorm -------------------------------------------------------------------------


def _seeded_bn(c: int, seed: int) -> BatchNorm:
    bn = BatchNorm(c)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.3 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return bn


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_under_autocast_uses_bf16_valued_affine_parameters(train):
    c = 16
    bn = _seeded_bn(c, seed=4).train(train)
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    x = torch.randn(2, c, 5, 6, generator=torch.Generator().manual_seed(5)).to(BF16)
    with torch.autocast("cpu", dtype=BF16):
        got = bn(x)
    want = F.batch_norm(x, stats[0].clone(), stats[1].clone(), _bf16_values(bn.weight.detach()),
                        _bf16_values(bn.bias.detach()), train, 0.1, 1e-5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # f32 affine parameters would give another result at these values.
    f32 = F.batch_norm(x, stats[0].clone(), stats[1].clone(), bn.weight.detach(),
                       bn.bias.detach(), train, 0.1, 1e-5)
    assert not torch.equal(got, f32)
    if train:  # the statistics stay f32, the running variance flax's biased one
        assert bn.running_var.dtype == torch.float32
        n = x.numel() // c
        var = x.float().var(dim=(0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_var, 0.9 * stats[1] + 0.1 * var, rtol=1e-5, atol=1e-6)
        assert n > 1


def test_batchnorm_gradient_reaches_the_f32_parameters_through_the_rounding():
    c = 8
    bn = _seeded_bn(c, seed=6).train()
    x = torch.randn(2, c, 4, 5, generator=torch.Generator().manual_seed(7)).to(BF16)
    g = torch.randn(2, c, 4, 5, generator=torch.Generator().manual_seed(8)).to(BF16)
    with torch.autocast("cpu", dtype=BF16):
        y = bn(x)
    dw, db = torch.autograd.grad(y, (bn.weight, bn.bias), g)
    assert dw.dtype == db.dtype == torch.float32
    # Straight through the round trip: the gradient of the f32-valued normalisation.
    xhat = (x.float() - x.float().mean(dim=(0, 2, 3), keepdim=True)) * torch.rsqrt(
        x.float().var(dim=(0, 2, 3), unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(db, g.float().sum(dim=(0, 2, 3)), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(dw, (g.float() * xhat).sum(dim=(0, 2, 3)), rtol=2e-2, atol=2e-2)


def test_batchnorm_in_f32_keeps_its_f32_parameters():
    bn = _seeded_bn(8, seed=9).eval()
    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(10))
    want = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight.detach(), bn.bias.detach(),
                        False, 0.1, 1e-5)
    with torch.no_grad():
        torch.testing.assert_close(bn(x), want, rtol=0, atol=0)


# --- the fused conv's bias ---------------------------------------------------------------


def test_fused_conv_bf16_plain_version_and_packing_use_the_bf16_valued_bias():
    c = 16
    g = torch.Generator().manual_seed(11)
    x = torch.randn(1, c, 6, 7, generator=g).to(BF16)
    weight = torch.randn(c, c, 3, 3, generator=g) / (3 * c ** 0.5)
    bias = 0.3 * torch.randn(c, generator=g)
    got = conv3x3_mod.conv3x3_bias_relu_plain(x, weight, bias)
    torch.testing.assert_close(got, conv3x3_mod.conv3x3_bias_relu_plain(x, weight, _bf16_values(bias)),
                               rtol=0, atol=0)
    f32 = torch.relu(conv3x3_mod._conv3x3_f32(x, weight) + bias[None, :, None, None]).to(BF16)
    assert not torch.equal(got, f32.contiguous(memory_format=torch.channels_last))
    # What the kernel reads: an f32 bias holding the bf16 values; f32 calls keep it.
    _, b = conv3x3_mod._pack(weight, bias, BF16)
    assert b.dtype == torch.float32 and torch.equal(b, _bf16_values(bias))
    _, b32 = conv3x3_mod._pack(weight, bias, torch.float32)
    assert torch.equal(b32, bias)


def test_plain_conv_and_upsample_compute_in_f32_under_autocast():
    # Under CPU autocast an einsum would run in bf16: the plain versions turn it off.
    g = torch.Generator().manual_seed(12)
    x = torch.randn(1, 8, 5, 6, generator=g).to(BF16)
    weight = torch.randn(8, 8, 3, 3, generator=g)
    with torch.autocast("cpu", dtype=BF16):
        conv = conv3x3_mod.conv3x3_same_plain(x, weight)
        up = upsample2x_plain(x, True)
    torch.testing.assert_close(conv, conv3x3_mod.conv3x3_same_plain(x, weight), rtol=0, atol=0)
    torch.testing.assert_close(up, upsample2x_plain(x, True), rtol=0, atol=0)


# --- the interpolation weights: pinned, not repaired ---------------------------------------

# unet_resnet50's five upsample input sizes (align_corners=True) at 480^2,
# and the families' four (align_corners=False) with the odd sizes of 44^2.
RESNET_UPSAMPLE_SIZES = [15, 30, 60, 120, 240]
FAMILY_UPSAMPLE_SIZES = [2, 5, 11, 22, 30, 60, 120, 240]


@pytest.mark.parametrize("align_corners,sizes", [(True, RESNET_UPSAMPLE_SIZES),
                                                 (False, FAMILY_UPSAMPLE_SIZES)])
def test_interpolation_weights_in_bf16(align_corners, sizes):
    # JAX's bf16 upsample casts these matrices to bf16; the port keeps f32.
    # align_corners=False: 0, 0.25, 0.75, 1 only, exact in bf16, so nothing
    # differs. align_corners=True: k (H - 1) / (2H - 1) rounds.
    for h in sizes:
        m = torch.from_numpy(_interp_matrix(h, 2 * h, align_corners).copy())
        exact = torch.equal(_bf16_values(m), m)
        assert exact is (not align_corners), h
        if not align_corners:
            assert set(m.unique().tolist()) <= {0.0, 0.25, 0.75, 1.0}


def _upsample_f32(x: torch.Tensor, align_corners: bool, bf16_weights: bool) -> torch.Tensor:
    """The port's upsample arithmetic (f32 maths, one rounding), weights optionally bf16."""
    h, w = x.shape[-2:]
    mh = torch.from_numpy(_interp_matrix(h, 2 * h, align_corners).copy())
    mw = torch.from_numpy(_interp_matrix(w, 2 * w, align_corners).copy())
    if bf16_weights:
        mh, mw = _bf16_values(mh), _bf16_values(mw)
    y = torch.einsum("oh,nchw->ncow", mh, x.float())
    return torch.einsum("pw,ncow->ncop", mw, y).to(x.dtype)


def _ulp_at_scale(t: torch.Tensor) -> float:
    """One bf16 ulp at the binade of the largest |value| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(t.float().abs().max().item())) - 7)


@pytest.mark.parametrize("align_corners,sizes", [(True, RESNET_UPSAMPLE_SIZES),
                                                 (False, FAMILY_UPSAMPLE_SIZES)])
def test_bf16_interpolation_weights_move_the_output_by_at_most_one_ulp(align_corners, sizes):
    # What this departure alone does: the same f32 maths and one rounding to
    # bf16, with the f32 weights (the port) and with JAX's bf16 weights. Each
    # output is a convex combination of <= 4 inputs, so rounding the weights
    # (2^-9 each) moves it by about 2^-8 of the largest input: at most one
    # bf16 ulp at the largest output's binade, beyond the output's own
    # rounding. align_corners=False: the weights are exact, nothing moves.
    for h in sizes:
        x = torch.from_numpy(np.random.RandomState(h).randn(1, 8, h, h).astype(np.float32)).to(BF16)
        port = _upsample_f32(x, align_corners, bf16_weights=False)
        torch.testing.assert_close(port, upsample2x_plain(x, align_corners), rtol=0, atol=0)
        moved = (port.float() - _upsample_f32(x, align_corners, True).float()).abs().max().item()
        if align_corners:
            assert 0 < moved <= _ulp_at_scale(port), h
        else:
            assert moved == 0, h


@pytest.mark.parametrize("align_corners,sizes", [(True, RESNET_UPSAMPLE_SIZES),
                                                 (False, FAMILY_UPSAMPLE_SIZES)])
def test_bf16_upsample_against_jax_is_within_two_ulps(align_corners, sizes):
    # Against JAX's bf16 upsample itself, two more roundings add to the
    # weights': XLA rounds the joint einsum's intermediate (one axis done)
    # to bf16, then its result. Measured: at most 0.0082 of the largest
    # output (h = 120, align_corners=True), 0.0054 with exact weights; held
    # to two bf16 ulps at the largest output's binade (>= 2^-7 of it).
    for h in sizes:
        x = np.random.RandomState(h).randn(1, h, h, 8).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(jax_resize.upsample2x(xb, align_corners=align_corners).astype(jnp.float32))
        xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16).permute(0, 3, 1, 2)
        got = upsample2x_plain(xt, align_corners)
        diff = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want).max()
        assert diff <= 2 * _ulp_at_scale(got), h


# --- each ported family's bf16 forward against JAX's ------------------------------------

FAMILY_SIZES = {"unet_resnet50": 64, "unet_plain": 44, "attention_unet": 44, "dualdense_unet": 44,
                "multitask_unet": 64}
NARROW = {"unet_plain": {"base_channels": 8}, "attention_unet": {"base_channels": 8},
          "dualdense_unet": {"base_channels": 8, "growth_rate": 8}}
# |port - JAX| as a share of the largest JAX logit, measured at this seed
# (largest / median): unet_resnet50 0.0170 / 0.0027, unet_plain 0.0093 /
# 0.0015, attention_unet 0.0107 / 0.0011, dualdense_unet 0.0124 / 0.0010,
# multitask_unet seg 0.0093 / 0.0018 and its six class logits 0.0071 / 0.0043;
# before the three repairs the medians were 0.0031, 0.0020, 0.0015, 0.0015.
# That is bf16's own noise: the port's f32 forward lies 0.0066-0.0223 (largest)
# from JAX's bf16 one. Held to about twice the measured values (the median of
# six class logits has less room: it is nearly their largest).
BF16_TOL_MAX, BF16_TOL_MEDIAN = 0.03, 0.005


def _seeded_variables(template: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, tuple(np.shape(leaf))
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def _family_models(name: str):
    size = FAMILY_SIZES[name]
    if name in ("unet_resnet50", "multitask_unet"):
        jmodel = jax_build_model(name, num_classes=2, dtype=jnp.bfloat16)
        template = jax.tree.map(np.asarray, init_model(jmodel, jax.random.PRNGKey(0), (64, 64)))
        port = build_model(name, 2, device="cpu")
    else:
        jmodel = JAX_MODELS[name](num_classes=2, dtype=jnp.bfloat16, **NARROW[name])
        template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, size, size, 3)), train=False))
        port = PORT_CLASSES[name](num_classes=2, **NARROW[name])
        port = port.to(memory_format=torch.channels_last)
    variables = _seeded_variables(dict(template), seed=0)
    port.load_state_dict(state_dict_from_jax(name, variables), strict=True)
    return jmodel, variables, port.eval(), size


@pytest.mark.parametrize("name", list(FAMILY_SIZES))
def test_bf16_eval_forward_matches_jax_bf16(name):
    jmodel, variables, port, size = _family_models(name)
    x = np.random.RandomState(1).rand(2, size, size, 3).astype(np.float32)
    # JAX's AMP forward: bf16 compute with TreeAdam's bf16 parameter copies
    # (the batch statistics stay f32, as cast_params leaves them).
    cast = {**variables, "params": TreeAdam(1e-4).cast_params(variables["params"])}
    want = jax_make_predict_fn(jmodel)(cast, jnp.asarray(x))
    got = make_predict_fn(port, amp=True)(x)
    if name == "multitask_unet":  # (seg (N, H, W, 1), cls (N, 3)): each held alike
        shapes = [(2, size, size, 1), (2, 3)]
    else:
        want, got, shapes = (want,), (got,), [(2, size, size, 2)]
    for w, g, shape in zip(want, got, shapes):
        w, g = np.asarray(w.astype(jnp.float32)), g.numpy()
        assert g.shape == w.shape == shape
        scale = np.abs(w).max()
        assert 0.1 < scale < 1e3
        # What remains after the repairs is where each side rounds: summation
        # order in bf16-input convs (both accumulate in f32, round to bf16 at
        # other points), XLA's bf16 intermediate in the joint upsample einsum,
        # and the interpolation weights (pinned above). See BF16_TOL_MAX.
        diff = np.abs(g - w)
        assert diff.max() <= BF16_TOL_MAX * scale, (shape, diff.max() / scale)
        assert np.median(diff) <= BF16_TOL_MEDIAN * scale, (shape, np.median(diff) / scale)


# --- float32 precision, stated and set by the CLIs -------------------------------------


def test_clis_set_pytorch_default_float32_precision(monkeypatch):
    import inspect

    from unet_embroidery_seg_torch import predict, train, val
    from unet_embroidery_seg_torch.utils import device, timing

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    device.set_float32_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False  # matmuls: full f32
    assert torch.backends.cudnn.allow_tf32 is True  # cuDNN's convs: TF32 (PyTorch's default)
    for entry in (train.train, val.val, predict.predict):
        assert "set_float32_precision()" in inspect.getsource(entry), entry.__name__
    # The profile scripts count the f32 conv kernel in its own group, not cuDNN's.
    name = "void (anonymous namespace)::tc::conv3x3_wgmma_kernel<float, 128, false, false>(...)"
    assert timing._group_of(name).startswith("port conv3x3 f32")
    assert timing._group_of(name.replace("<float", "<__nv_bfloat16")) == "port conv3x3 (forward and dgrad)"
