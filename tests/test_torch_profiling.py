"""The port's profiling helpers and the train CLI's ``--profile``, on the CPU."""

import glob
import json
import os
import shutil

import pytest

from unet_embroidery_seg_tpu.utils import profiling as jax_profiling
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch.utils import profiling


def test_device_memory_stats_is_empty_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == ""
    assert profiling.device_memory_stats() == ""  # no card here


@pytest.mark.parametrize("warmup,ticks", [(1, [8, 8, 8, 4]), (2, [8, 8]), (0, [2, 2, 2]),
                                          (3, [8])])
def test_step_timer_counts_as_jax(warmup, ticks):
    port, ref = profiling.StepTimer(warmup), jax_profiling.StepTimer(warmup)
    for n in ticks:
        port.tick(n)
        ref.tick(n)
    assert (port._seen, port._images, port._t0 is None) == (ref._seen, ref._images, ref._t0 is None)
    assert (port.steps_per_sec > 0) == (ref.steps_per_sec > 0)
    assert (port.images_per_sec > 0) == (ref.images_per_sec > 0)


def test_trace_context_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)):
        torch.ones(3).add_(1)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert any(e.get("name") == "aten::add_" for e in json.load(open(path))["traceEvents"])


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """An empty working directory for the CLI's run/, emptied at teardown (full-size weights)."""
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# unet_resnet50 at 64^2, 4 train batches of 2: the host path traces steps 1
# and 2 (--profile-steps 2), the resident path chunk 1 (--scan-chunk 2).
CLI_ARGS = ["--data-path", "synthetic:8", "--input-size", "64", "--batch-size", "2",
            "--epochs", "1", "--max-train-batches", "4", "--max-val-batches", "1",
            "--max-test-batches", "1", "--device", "cpu", "--no-amp", "--ckpt-every", "0",
            "--no-export-vis", "--profile", "--profile-steps", "2", "--scan-chunk", "2"]
# The kernels' operators per unet_resnet50 train step (forward and backward).
PER_STEP = {"unet_seg::upsample2x": 5, "unet_seg::upsample2x_backward": 5,
            "unet_seg::conv3x3_bias_relu": 6, "unet_seg::conv3x3_dgrad": 6}


@pytest.mark.parametrize("path", ["--no-device-augment", "--device-augment"])
def test_train_cli_profile_traces_the_window(workdir, path, capsys):
    exp = port_train.train(port_train.parse_args(CLI_ARGS + [path]))
    (trace,) = glob.glob(os.path.join(exp, "trace", "*.pt.trace.json"))
    events = json.load(open(trace))["traceEvents"]
    counts = {name: sum(e.get("name") == name for e in events) for name in PER_STEP}
    assert counts == {name: 2 * n for name, n in PER_STEP.items()}  # the window's 2 steps
    out = capsys.readouterr().out
    assert "[profile] trace written to" in out
    assert "HBM:" not in out  # the CPU has no card memory line
