"""The port's unet_resnet50 predict path against the JAX package, in float32 on the CPU.

One module-scoped JAX init serves every test here. Its weights are then
redrawn by numpy from a seed (He-scaled kernels, non-trivial BN statistics)
so the logits are O(1) and the comparison means something; the same numpy
weights go to both sides through the port's ``state_dict_from_jax`` with
``strict=True``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.data.augment import letterbox as jax_letterbox
from unet_embroidery_seg_tpu.engine.steps import make_predict_fn as jax_make_predict_fn
from unet_embroidery_seg_tpu.models import blocks as jax_blocks
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.models import init_model
from unet_embroidery_seg_tpu.utils import torch_interop
from unet_embroidery_seg_torch import predict as port_predict
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch.data.augment import letterbox
from unet_embroidery_seg_torch.engine import checkpoint
from unet_embroidery_seg_torch.engine.steps import make_predict_fn
from unet_embroidery_seg_torch.models import SUPPORTED_MODELS, build_model
from unet_embroidery_seg_torch.models.blocks import ClassHead
from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
from unet_embroidery_seg_torch.ops.upsample import upsample2x
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE = 96  # 96 -> 48 -> 24 -> 24 -> 12 -> 6 -> 3: odd maps at the bottom, like 480 -> 15


def _seeded(variables: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def ref():
    jmodel = jax_build_model("unet_resnet50", num_classes=2)
    template = jax.tree.map(np.asarray, init_model(jmodel, jax.random.PRNGKey(0), (64, 64)))
    variables = _seeded(template, seed=0)
    port = build_model("unet_resnet50", 2, device="cpu")
    port.load_state_dict(state_dict_from_jax("unet_resnet50", variables), strict=True)
    rng = np.random.RandomState(1)
    x = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    jax_predict = jax_make_predict_fn(jmodel)
    return {
        "variables": variables,
        "port": port,
        "x": x,
        "jax_predict": jax_predict,
        "jax_logits": np.asarray(jax_predict(variables, jnp.asarray(x))),
    }


def _assert_close_to_scale(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_eval_forward_matches_jax_f32(ref):
    got = make_predict_fn(ref["port"], amp=False)(ref["x"]).numpy()
    want = ref["jax_logits"]
    assert got.shape == want.shape == (2, SIZE, SIZE, 2)
    assert 0.1 < np.abs(want).max() < 1e3  # the seeded weights keep logits O(1)
    # f32 both sides (JAX matmul precision "highest"); ~70 layers of convs
    # summed in another order by XLA and oneDNN: 1e-4 of the logit scale.
    _assert_close_to_scale(got, want, 1e-4)


def test_forward_runs_each_kernel_site_through_its_wrapper(ref, monkeypatch):
    seen = {"up": [], "conv": []}
    import unet_embroidery_seg_torch.models.blocks as blocks

    def spy_up(x, align_corners):
        seen["up"].append((tuple(x.shape), align_corners))
        return upsample2x(x, align_corners)

    def spy_conv(x, w, b):
        seen["conv"].append(tuple(x.shape))
        return conv3x3_bias_relu(x, w, b)

    monkeypatch.setattr(blocks, "upsample2x", spy_up)
    monkeypatch.setattr(blocks, "conv3x3_bias_relu", spy_conv)
    make_predict_fn(ref["port"], amp=False)(ref["x"])
    s = SIZE
    assert seen["up"] == [
        ((2, 2048, 3, 3), True), ((2, 512, 6, 6), True), ((2, 256, 12, 12), True),
        ((2, 128, 24, 24), True), ((2, 64, s // 2, s // 2), True),
    ]
    assert seen["conv"] == [
        (2, 512, 6, 6), (2, 256, 12, 12), (2, 128, 24, 24), (2, 64, 48, 48),
        (2, 64, s, s), (2, 64, s, s),
    ]


def test_backbone_shape_chain_has_odd_maps(ref):
    x = torch.from_numpy(ref["x"]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = ref["port"].resnet(x)
    assert [tuple(f.shape[1:]) for f in feats] == [
        (64, 48, 48), (256, 24, 24), (512, 12, 12), (1024, 6, 6), (2048, 3, 3),
    ]


def test_state_dict_from_jax_equals_torch_interop_export(ref):
    ours = state_dict_from_jax("unet_resnet50", ref["variables"])
    theirs = torch_interop.export_state_dict("unet_resnet50", ref["variables"])
    assert set(ours) == set(theirs)
    assert set(ours) == set(ref["port"].state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert "up_conv.1.weight" in ours and "resnet.layer1.0.downsample.0.weight" in ours


def test_pth_roundtrip_gives_same_output(ref, tmp_path):
    path = str(tmp_path / "best.pth")
    checkpoint.save_weights(path, ref["port"])
    fresh = build_model("unet_resnet50", 2, device="cpu",
                        generator=torch.Generator().manual_seed(123))
    checkpoint.load_weights(path, fresh)
    a = make_predict_fn(ref["port"], amp=False)(ref["x"])
    b = make_predict_fn(fresh, amp=False)(ref["x"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _synthetic_canvases(tmp_path, n=2):
    rng = np.random.RandomState(2)
    paths, canvases = [], []
    for i, (w, h) in enumerate([(70, 50), (40, 88)][:n]):
        img = Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
        path = tmp_path / f"s{i}.png"
        img.save(path)
        paths.append(path)
        mask = Image.new("L", img.size, 0)
        ours, _ = letterbox(img, mask, (SIZE, SIZE))
        theirs, _ = jax_letterbox(img, mask, (SIZE, SIZE))
        np.testing.assert_array_equal(np.array(ours), np.array(theirs))
        canvases.append(np.array(ours, np.float32) / 255.0)
    return paths, np.stack(canvases)


def test_predict_softmax_matches_jax(ref, tmp_path):
    _, xs = _synthetic_canvases(tmp_path)
    got = port_predict.predict_probs(make_predict_fn(ref["port"], amp=False), xs)
    want = np.asarray(jax.nn.softmax(ref["jax_predict"](ref["variables"], jnp.asarray(xs)), -1))
    assert got.shape == (2, SIZE, SIZE, 2)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)
    # Probabilities in [0, 1]; f32 logits agree to 1e-4 of their scale above.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_predict_cli_writes_one_mask_per_input(ref, tmp_path, monkeypatch):
    paths, _ = _synthetic_canvases(tmp_path)
    weights = tmp_path / "w.pth"
    checkpoint.save_weights(str(weights), ref["port"])
    monkeypatch.chdir(tmp_path)
    args = port_predict.parse_args([
        "--data_path", str(tmp_path), "--weights", str(weights),
        "--input-size", str(SIZE), "--no-amp", "--batch", "2", "--device", "cpu",
    ])
    out = port_predict.predict(args)
    assert os.path.relpath(out, tmp_path) == os.path.join("run", "predict", "exp")
    masks = sorted(f for f in os.listdir(out) if f.endswith("_mask.png"))
    assert masks == [p.stem + "_mask.png" for p in paths]
    for p in paths:
        assert Image.open(os.path.join(out, p.stem + "_mask.png")).size == Image.open(p).size


@pytest.mark.parametrize("diff", [False, True])
def test_class_head_matches_jax(diff):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    kernel = rng.randn(1, 1, 6, 2).astype(np.float32)
    bias = rng.randn(2).astype(np.float32)
    want = np.asarray(jax_blocks.ClassHead(2, diff=diff).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jnp.asarray(x)
    ))
    head = ClassHead(6, 2, diff=diff)
    head.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.numpy() if diff else got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # f32, 6-term sums


def test_init_is_the_reference_normal_scheme_and_seeded():
    a = build_model("unet_resnet50", 2, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model("unet_resnet50", 2, device="cpu", generator=torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    w = sa["up_concat4.conv1.weight"]
    assert abs(w.mean().item()) < 1e-3 and abs(w.std().item() - 0.02) < 1e-3
    assert abs(sa["resnet.layer4.2.bn3.weight"].mean().item() - 1.0) < 5e-3
    assert torch.count_nonzero(sa["up_conv.3.bias"]) == 0
    assert next(a.parameters()).dtype == torch.float32


@pytest.mark.parametrize("name", [m for m in SUPPORTED_MODELS if m == "multitask_unet"])
def test_unported_families_raise_naming_the_roadmap(name):
    # multitask_unet, the last family, is ported: it builds, and takes the
    # space axis; what the CLI refuses is an input whose bands would not
    # split evenly (its ResNet-50 encoder: a multiple of 32 x --mesh-space).
    model = build_model(name, 2, device="cpu")
    assert {k.split(".")[0] for k in model.state_dict()} >= {"encoder", "cls_head", "seg_head"}
    args = port_train.parse_args(["--task", "multitask", "--model", name, "--device", "cpu",
                                  "--profile", "--mesh-space", "2", "--input-size", "96"])
    with pytest.raises(ValueError, match="multiple of 32 x --mesh-space 2 = 64"):
        port_train.train(args)
