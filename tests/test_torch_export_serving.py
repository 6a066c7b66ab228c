"""The port's ``torch.export`` serving artifact, on the CPU: round trip, and parity with JAX's.

The CLI writes artifacts and a manifest whose ``--check`` holds the loaded
artifact to the direct forward, as ``tests/test_export_serving.py`` holds
JAX's StableHLO artifact. Then the same variables go through JAX's exporter
(``scripts/export_serving.py:export_one``) and the port's, and both
artifacts get the same numpy input.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax import export as jexport

from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.models import init_model
from unet_embroidery_seg_tpu.models.unet_plain import UNetPlain as JaxUNetPlain
from unet_embroidery_seg_torch import export_serving
from unet_embroidery_seg_torch.engine import checkpoint
from unet_embroidery_seg_torch.engine.steps import make_predict_fn
from unet_embroidery_seg_torch.models import build_model
from unet_embroidery_seg_torch.models.unet_plain import UNetPlain
from unet_embroidery_seg_torch.predict import predict_probs
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import export_serving as jax_export_serving  # noqa: E402  (JAX's exporter, scripts/)

SIZE = 32


def _input(seed: int, batch: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).rand(batch, SIZE, SIZE, 3).astype(np.float32)


def _seeded(variables: dict, seed: int) -> dict:
    """The tree redrawn by numpy: He-scaled kernels, non-trivial BN statistics (O(1) logits)."""
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


def _port_model(name: str, seed: int = 0) -> torch.nn.Module:
    return build_model(name, 2, generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture
def workdir(tmp_path):
    """A temporary directory, emptied at teardown: full-width weights and artifacts are ~0.1 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_export_roundtrip_cli(workdir):
    tmp_path = workdir
    weights = str(tmp_path / "w.pth")
    checkpoint.save_weights(weights, _port_model("unet_plain"))
    out = str(tmp_path / "serving")
    res = subprocess.run(
        [sys.executable, "-m", "unet_embroidery_seg_torch.export_serving",
         "--weights", weights, "--model", "unet_plain", "--num-classes", "1",
         "--input-size", str(SIZE), "--batches", "1", "--platforms", "cpu",
         "--no-amp", "--out", out, "--check"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert manifest["torch_version"] == torch.__version__ and manifest["platforms"] == ["cpu"]
    art = manifest["artifacts"]["1"]["cpu"]
    assert art["file"] == f"unet_plain_{SIZE}_b1_cpu.pt2"
    assert art["check_max_abs_diff"] < 1e-5  # f32 export, tiny tolerance

    # The consumer side: torch and the port's operators, through load_artifact.
    module = export_serving.load_artifact(os.path.join(out, art["file"]))
    with torch.no_grad():
        probs = module(torch.from_numpy(_input(1))).numpy()
    assert probs.shape == (1, SIZE, SIZE, 2)
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, atol=1e-5)


def _models(name: str):
    """(JAX model, port model): unet_plain at the family tests' width 8, unet_resnet50 full."""
    if name == "unet_plain":
        return JaxUNetPlain(num_classes=2, base_channels=8), UNetPlain(2, 8)
    return jax_build_model(name, num_classes=2), build_model(name, 2, device="cpu")


@pytest.mark.parametrize("name", ["unet_plain", "unet_resnet50"])
def test_artifact_matches_the_jax_artifact(name):
    # init_model's tree (seeded key; its shapes, as running the init op by
    # op takes ~20 s here), every leaf drawn by numpy: at the reference init
    # every probability is within 4e-4 of 0.5, where 1e-5 says little.
    jmodel, port = _models(name)
    variables = _seeded(jax.eval_shape(lambda: init_model(jmodel, jax.random.PRNGKey(3),
                                                          (SIZE, SIZE))), seed=0)
    jax_data = jax_export_serving.export_one(jax_export_serving.build_predict(jmodel), variables,
                                             batch=1, size=SIZE, platforms=["cpu"], bake=True)
    x = _input(2)
    want = np.asarray(jexport.deserialize(jax_data).call(x))

    port.to(memory_format=torch.channels_last).load_state_dict(
        state_dict_from_jax(name, variables), strict=True)
    data = export_serving.export_one(export_serving.build_predict(port, amp=False), 1, SIZE)
    with torch.no_grad():
        got = export_serving.load_artifact(data)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, SIZE, SIZE, 2)
    assert np.ptp(want) > 0.1  # the redrawn weights move the probabilities off 0.5
    # f32 both sides (JAX matmul precision "highest"); the convs sum in
    # another order in XLA and oneDNN, and softmax damps logit differences.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_unbaked_export_takes_the_state_dict():
    """--no-bake-weights artifacts take (state_dict, x) at call time, and equal the baked one."""
    model = _port_model("unet_plain", seed=4)
    predict = export_serving.build_predict(model, amp=False)
    baked = export_serving.export_one(predict, 2, SIZE, bake=True)
    unbaked = export_serving.export_one(predict, 2, SIZE, bake=False)
    assert len(unbaked) < len(baked)  # the weights stay out
    x = torch.from_numpy(_input(3, batch=2))
    with torch.no_grad():
        got = export_serving.load_artifact(unbaked)(model.state_dict(), x)
        want = export_serving.load_artifact(baked)(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # the same ops on the same inputs


def test_bf16_artifact_equals_eager_predict():
    model = _port_model("unet_plain", seed=5)
    data = export_serving.export_one(export_serving.build_predict(model, amp=True), 2, SIZE)
    x = _input(4, batch=2)
    with torch.no_grad():
        got = export_serving.load_artifact(data)(torch.from_numpy(x)).numpy()
    want = predict_probs(make_predict_fn(model, amp=True), x)
    # The artifact runs the eager ops under the same bf16 autocast: equal.
    np.testing.assert_array_equal(got, want)
    # Without the metadata asserts export puts before each autocast cast:
    # each would be one more host dispatch per call.
    module = export_serving.load_artifact(data)
    assert not [n for gm in module.modules() if isinstance(gm, torch.fx.GraphModule)
                for n in gm.graph.nodes
                if n.target is torch.ops.aten._assert_tensor_metadata.default]


def test_multitask_unet_is_refused():
    with pytest.raises(ValueError, match="two heads"):
        export_serving.build_predict(_port_model("multitask_unet"), amp=True)
