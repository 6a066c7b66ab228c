"""The accuracy study's data (``scripts/torch_parity_study.py``): one set of samples, three trees.

The study writes 64 / 16 / 16 ``SyntheticSource`` samples (seed 0) as a
parquet tree where ``datasets`` is installed and as a VOC tree of PNGs
elsewhere. Both, read as the train CLI reads them (``open_source``), must
decode to the same images and masks, and to those of the JAX package's
``scripts/export_parity_dataset.py`` tree read through the JAX package's
``HFParquetSource``: the data the published bands were measured on. Then
the study itself at a tiny regime on the CPU: the JSON entry, the resume,
the refusal of another regime's file and of a directory that is not a tree.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from unet_embroidery_seg_torch.data.sources import HFParquetSource, VOCSource, open_source
from unet_embroidery_seg_tpu.data.sources import HFParquetSource as JaxHFParquetSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


study = _load_script("torch_parity_study")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def delete_tmp_path(request):
    """Delete the test's ``tmp_path`` when it ends, pass or fail (it holds checkpoints)."""
    yield
    if "tmp_path" in request.fixturenames:
        shutil.rmtree(request.node.funcargs["tmp_path"], ignore_errors=True)


def _decoded(source) -> list[tuple[np.ndarray, np.ndarray]]:
    return [(np.asarray(source[i]["image"]), np.asarray(source[i]["mask"]))
            for i in range(len(source))]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity_trees")
    out = {}
    for fmt in ("voc", "parquet"):
        assert study.ensure_tree(root / fmt, fmt) == fmt
        out[fmt] = root / fmt
    export = _load_script("export_parity_dataset")
    export.export(export.parse_args(["--out", str(root / "jax")]))
    out["jax"] = root / "jax"
    out["cache"] = root / "cache"
    yield out
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("split", list(study.SPLITS))
def test_voc_and_parquet_trees_decode_to_the_jax_export(trees, split):
    cache = str(trees["cache"])
    voc = open_source(str(trees["voc"]), study.CONFIG, split, cache)
    parquet = open_source(str(trees["parquet"]), study.CONFIG, split, cache)
    jax_tree = JaxHFParquetSource(str(trees["jax"]), study.CONFIG, split, cache)
    assert isinstance(voc, VOCSource) and isinstance(parquet, HFParquetSource)
    want = _decoded(jax_tree)
    assert len(want) == study.SPLITS[split]
    for got in (_decoded(voc), _decoded(parquet)):
        assert len(got) == len(want)
        for (img, mask), (want_img, want_mask) in zip(got, want):
            assert img.dtype == np.uint8 and img.shape == want_img.shape
            np.testing.assert_array_equal(img, want_img)
            np.testing.assert_array_equal(mask, want_mask)


def test_a_directory_without_the_tree_is_refused(tmp_path):
    (tmp_path / "other.txt").write_text("not a tree")
    with pytest.raises(RuntimeError, match="no whole tree"):
        study.ensure_tree(tmp_path)


def test_welch_interval_matches_the_textbook_case():
    # two samples of 8, equal spread: df = 14, t(0.975, 14) = 2.1448
    ci = study.welch_ci(0.31, 0.04, 8, 0.30, 0.04, 8)
    assert ci["df"] == pytest.approx(14.0)
    assert ci["hi"] - ci["diff"] == pytest.approx(2.1448 * 0.02, rel=1e-4)
    assert ci["covers_zero"]


def test_paired_interval_matches_scipy_paired_t():
    from scipy import stats

    a, b = [0.31, 0.28, 0.35, 0.22, 0.30], [0.27, 0.29, 0.30, 0.20, 0.26]
    ci = study.paired_ci(a, b)
    want = stats.ttest_rel(a, b).confidence_interval(0.95)
    assert (ci["lo"], ci["hi"]) == pytest.approx((want.low, want.high), rel=1e-9)
    assert ci["n"] == 5 and ci["diff"] == pytest.approx(0.028)


def test_jax_unpaired_band_is_recorded_beside_the_verdict_not_in_it():
    # a bf16 resnet arm at 0.2566: out of ref's band by more than its std, inside
    # the JAX package's unpaired band (PARITY.md:61)
    runs = [0.2166, 0.2966, 0.2366, 0.2766]
    entry = {"by_seed": {str(i): {"IoU": x} for i, x in enumerate(runs)}}
    out = study.summarize("resnet_lovasz/bf16", entry)
    assert set(out["held_against"]) == {"ref", "jax_bf16"}
    assert not out["held_against"]["ref"]["within_one_std"] and out["pass"] is False
    assert out["jax_unpaired"]["mean"] == 0.2666 and out["jax_unpaired"]["within_one_std"]
    assert study.summarize("resnet_lovasz/f32_tf32", entry)["jax_unpaired"]["mean"] == 0.265


def test_default_arms_are_the_four_held_to_the_bands():
    assert study.parse_args([]).arms == ["resnet_lovasz/bf16", "resnet_lovasz/f32_tf32",
                                         "resnet_lovasz/f32_no_tf32", "plain_bce/bf16"]
    assert set(study.ARMS) - set(study.DEFAULT_ARMS) == {
        "resnet_lovasz/bf16_host_input", "resnet_lovasz/bf16_torch_conv_bias"}


def test_study_on_the_cpu_writes_resumes_and_refuses_another_regime(trees, tmp_path, capsys):
    out = tmp_path / "parity.json"
    argv = ["--arms", "plain_bce/bf16", "--seeds", "0", "1", "--epochs", "1",
            "--input-size", "32", "--data", str(trees["voc"]), "--out", str(out),
            "--workdir", str(tmp_path / "runs"), "--device", "cpu"]
    results = study.main(argv)
    arm = results["arms"]["plain_bce/bf16"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert arm["seeds"] == [0, 1] and arm["IoU"]["n"] == 2
    for seed in ("0", "1"):
        run = arm["by_seed"][seed]
        assert math.isfinite(run["IoU"]) and run["amp"] is True and run["seconds"] > 0
    assert set(arm["held_against"]) == {"ref", "jax_bf16"}
    assert arm["jax_unpaired"]["mean"] == 0.3741
    assert isinstance(arm["pass"], bool)
    assert results["data"]["format"] == "voc" and results["regime"]["epochs"] == 1
    capsys.readouterr()
    study.main(argv)  # every seed is in the file: nothing runs again
    assert capsys.readouterr().out.count("[skip]") == 2
    with pytest.raises(SystemExit, match="another regime"):
        study.main(argv[:-2] + ["--epochs", "2", "--device", "cpu"])


def test_tf32_off_arm_replaces_the_cli_precision_for_the_fit_only():
    from unet_embroidery_seg_torch import train as train_cli

    cli = train_cli.set_float32_precision
    with study.cudnn_tf32(False):
        assert train_cli.set_float32_precision is not cli
        train_cli.set_float32_precision()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert train_cli.set_float32_precision is cli
    assert torch.backends.cudnn.allow_tf32 is True  # the CLI's setting again
    with study.cudnn_tf32(True):
        assert train_cli.set_float32_precision is cli


def test_torch_conv_bias_arm_changes_only_the_conv_biases(tmp_path):
    from unet_embroidery_seg_torch.models import build_model

    path = study.torch_conv_bias_init("unet_resnet50", 3, tmp_path / "init.pth")
    got = torch.load(path, weights_only=True)
    want = build_model("unet_resnet50", 2, diff_head=True,
                       generator=torch.Generator().manual_seed(3), device="cpu").state_dict()
    changed = [k for k, v in want.items() if not torch.equal(v, got[k])]
    assert changed and all(k.endswith(".bias") and want[k].abs().max() == 0 for k in changed)
    for k in changed:
        fan_in = want[k[: -len("bias")] + "weight"][0].numel()
        assert 0 < got[k].abs().max() <= fan_in ** -0.5
