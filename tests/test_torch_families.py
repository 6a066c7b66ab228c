"""unet_plain, attention_unet and dualdense_unet: the port against the JAX package on the CPU.

The JAX models are built directly at narrow widths (``base_channels`` 8,
``growth_rate`` 8); numpy draws their weights from a seed (He-scaled
kernels, non-trivial BN statistics) so the logits are O(1), and the same
numbers reach the port through ``state_dict_from_jax`` with ``strict=True``.
44^2 maps to 22, 11, 5 and 2, so every decoder stage meets a skip of
another size: unet_plain center-pads, the other two resize. Also here: the
bias-free conv3x3 and the two resize ops the families add, values and
gradients against JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.engine.steps import make_predict_fn as jax_make_predict_fn
from unet_embroidery_seg_tpu.models.unet_attention import AttentionUNet as JaxAttentionUNet
from unet_embroidery_seg_tpu.models.unet_dualdense import DualDenseUNet as JaxDualDenseUNet
from unet_embroidery_seg_tpu.models.unet_plain import UNetPlain as JaxUNetPlain
from unet_embroidery_seg_tpu.ops import resize as jax_resize
from unet_embroidery_seg_tpu.utils import torch_interop
from unet_embroidery_seg_torch.engine.steps import make_predict_fn
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.models.blocks import init_weights
from unet_embroidery_seg_torch.models.unet_attention import AttentionUNet
from unet_embroidery_seg_torch.models.unet_dualdense import DualDenseUNet
from unet_embroidery_seg_torch.models.unet_plain import UNetPlain
from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain
from unet_embroidery_seg_torch.ops.resize import center_pad_to, resize_bilinear
from unet_embroidery_seg_torch.ops.upsample import upsample2x
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE = 44  # 44 -> 22 -> 11 -> 5 -> 2: odd maps, every skip of another size
FAMILIES = {
    "unet_plain": (JaxUNetPlain, UNetPlain, {"base_channels": 8}),
    "attention_unet": (JaxAttentionUNet, AttentionUNet, {"base_channels": 8}),
    "dualdense_unet": (JaxDualDenseUNet, DualDenseUNet, {"base_channels": 8, "growth_rate": 8}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after.

    The suite runs its files in parallel workers, and torch's default (a
    thread per core in every worker) oversubscribes the cores: its spinning
    threads then slow every worker's torch work many times over.
    """
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(jmodel, seed: int) -> dict:
    """The JAX model's variables with numpy-drawn values (shapes from ``eval_shape``)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(key, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, tuple(leaf.shape)
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def port_model(name: str, variables: dict, diff_head: bool = False):
    _, cls, kwargs = FAMILIES[name]
    model = init_weights(cls(num_classes=2, diff_head=diff_head, **kwargs),
                         torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    model.load_state_dict(state_dict_from_jax(name, variables), strict=True)
    return model


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name = request.param
    jcls, _, kwargs = FAMILIES[name]
    jmodel = jcls(num_classes=2, **kwargs)
    variables = seeded_variables(jmodel, seed=0)
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    return {"name": name, "jmodel": jmodel, "variables": variables, "x": x,
            "port": port_model(name, variables),
            "jax_logits": np.asarray(jax_make_predict_fn(jmodel)(variables, jnp.asarray(x)))}


def test_eval_forward_matches_jax_f32(family):
    got = make_predict_fn(family["port"], amp=False)(family["x"]).numpy()
    want = family["jax_logits"]
    assert got.shape == want.shape == (2, SIZE, SIZE, 2)
    assert 0.1 < np.abs(want).max() < 1e3  # the seeded weights keep logits O(1)
    # f32 both sides (JAX matmul precision "highest"); ~25 layers summed in
    # another order by XLA and oneDNN: 1e-4 of the logit scale.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_state_dict_from_jax_equals_torch_interop_export(family):
    ours = state_dict_from_jax(family["name"], family["variables"])
    theirs = torch_interop.export_state_dict(family["name"], family["variables"])
    assert set(ours) == set(theirs) == set(family["port"].state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


SQUARE_CONVS = {"unet_plain": 9, "attention_unet": 9, "dualdense_unet": 0}


def test_forward_runs_each_kernel_site_through_its_wrapper(family, monkeypatch):
    seen = {"up": [], "conv": []}

    def spy_up(x, align_corners):
        seen["up"].append((tuple(x.shape), align_corners))
        return upsample2x(x, align_corners)

    def spy_conv(x, w):
        seen["conv"].append(tuple(x.shape))
        return conv3x3_same(x, w)

    monkeypatch.setattr(blocks, "upsample2x", spy_up)
    monkeypatch.setattr(blocks, "conv3x3_same", spy_conv)
    make_predict_fn(family["port"], amp=False)(family["x"])
    c = 8
    assert seen["up"] == [((2, 16 * c, 2, 2), False), ((2, 8 * c, 5, 5), False),
                          ((2, 4 * c, 11, 11), False), ((2, 2 * c, 22, 22), False)]
    if SQUARE_CONVS[family["name"]]:
        # inc, down1..4, up1..4: C x C at each level's width and size
        assert seen["conv"] == [
            (2, c, 44, 44), (2, 2 * c, 22, 22), (2, 4 * c, 11, 11), (2, 8 * c, 5, 5),
            (2, 16 * c, 2, 2), (2, 8 * c, 5, 5), (2, 4 * c, 11, 11), (2, 2 * c, 22, 22),
            (2, c, 44, 44)]
    else:
        assert seen["conv"] == []


@pytest.mark.parametrize("name", list(FAMILIES))
def test_full_width_model_matches_the_jax_parameter_tree(name):
    # The factory's full-width model (base 64, growth 32) has exactly the
    # JAX model's leaves under the reference keys, shape for shape.
    jcls = FAMILIES[name][0]
    shapes = jax.eval_shape(lambda: jcls(num_classes=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = state_dict_from_jax(name, jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                                  dict(shapes)))
    got = build_model(name, 2, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_build_model_is_seeded_and_initialises_every_conv(name):
    a = build_model(name, 2, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model(name, 2, device="cpu", generator=torch.Generator().manual_seed(5))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    for n, p in a.named_parameters():
        assert torch.isfinite(p).all(), n
        if p.dim() == 4:  # reference 'normal' init, the bias-free square convs included
            assert abs(p.std().item() - 0.02) < 0.01, n
    assert next(a.parameters()).dtype == torch.float32


@pytest.mark.parametrize("name", list(FAMILIES))
def test_decoder_width_is_a_unet_resnet50_option(name):
    with pytest.raises(ValueError, match="decoder_width"):
        build_model(name, 2, decoder_width=1.5, device="cpu")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_diff_head_is_the_two_class_difference(name):
    variables = seeded_variables(FAMILIES[name][0](num_classes=2, **FAMILIES[name][2]), 3)
    diff, plain = port_model(name, variables, diff_head=True), port_model(name, variables)
    x = torch.from_numpy(np.random.RandomState(4).rand(2, SIZE, SIZE, 3).astype(np.float32))
    with torch.inference_mode():
        got, two = diff.eval()(x.permute(0, 3, 1, 2)), plain.eval()(x.permute(0, 3, 1, 2))
    assert got.shape == (2, SIZE, SIZE)
    torch.testing.assert_close(got, two[:, 1] - two[:, 0], rtol=0, atol=1e-5)


# --- the bias-free conv3x3 and the resize ops ---------------------------------------


def _jax_conv(x_nhwc, w_hwio):
    return jax.lax.conv_general_dilated(
        x_nhwc, w_hwio, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("shape", [(2, 9, 11, 8), (1, 16, 16, 5), (1, 1, 3, 4)])
def test_conv3x3_same_plain_matches_lax_conv_and_its_grad(shape):
    n, h, w, c = shape
    rng = np.random.RandomState(h * w + c)
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    want = np.asarray(_jax_conv(jnp.asarray(x), jnp.asarray(w_hwio)))
    dx_want, dw_want = jax.grad(lambda a, b: jnp.sum(_jax_conv(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w_hwio))
    for fn in (conv3x3_same_plain, conv3x3_same):  # the plain version's autograd; the Function's
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).requires_grad_()
        y = fn(xt, wt)
        assert y.is_contiguous(memory_format=torch.channels_last)
        dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g).permute(0, 3, 1, 2))
        # f32 both sides; fan-in 9*C <= 72 terms of O(1) products: < 1e-5.
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(dx_want),
                                   rtol=0, atol=1e-5)
        # dW sums over every pixel: 1e-5 of its scale.
        dw_ref = np.asarray(dw_want).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=0, atol=1e-5 * np.abs(dw_ref).max())


def test_conv3x3_same_wrapper_takes_plain_version_on_cpu():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 4, 6, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 4, 3, 3).astype(np.float32))
    before = conv3x3_same.launches
    out = conv3x3_same(x, w)
    assert conv3x3_same.launches == before
    torch.testing.assert_close(out, conv3x3_same_plain(x, w), rtol=0, atol=0)


@pytest.mark.parametrize("hw,target", [((4, 4), (5, 5)), ((2, 6), (5, 6)), ((10, 10), (11, 13)),
                                       ((3, 3), (3, 3))])
def test_center_pad_to_matches_jax_with_gradient(hw, target):
    rng = np.random.RandomState(sum(hw + target))
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_resize.center_pad_to(jnp.asarray(x), target))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = center_pad_to(xt, target)
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(), want)
    g = rng.randn(*want.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).permute(0, 3, 1, 2))
    dx_want = jax.grad(lambda a: jnp.sum(jax_resize.center_pad_to(a, target) * g))(
        jnp.asarray(x))
    np.testing.assert_array_equal(dx.permute(0, 2, 3, 1).numpy(), np.asarray(dx_want))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("hw,target", [((2, 2), (5, 5)), ((5, 5), (11, 11)), ((11, 7), (22, 7)),
                                       ((4, 6), (3, 9))])
def test_resize_bilinear_matches_jax_with_gradient(hw, target, align_corners):
    rng = np.random.RandomState(sum(hw + target))
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), target, align_corners))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = resize_bilinear(xt, target, align_corners)
    assert y.shape == (2, 3, *target) and y.is_contiguous(memory_format=torch.channels_last)
    # f32 both sides (HIGHEST in JAX), <= 2-term lerps per axis.
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)
    g = rng.randn(*want.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).permute(0, 3, 1, 2))
    dx_want = jax.grad(lambda a: jnp.sum(jax_resize.resize_bilinear(a, target, align_corners) * g))(
        jnp.asarray(x))
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(dx_want),
                               rtol=0, atol=1e-5)
