"""``chip_smoke.py`` phase 12a on the CPU: its records do not depend on how often it times.

12a records each side's output and gradients after one forward + backward,
then times more calls of the same closure, and autograd adds each of their
backward passes into the same ``x.grad``. Here a stub timer calls the two
sides different numbers of times, at a small shape, over a 1-rank gloo
group: every relative error must stay within ``TOL_SYNC_BN``.
"""

import sys
from pathlib import Path

import pytest
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SHAPE = (2, 8, 6, 6)


@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _stub_timer(cudnn_calls: int, sync_calls: int):
    """A timer that calls cuDNN's side ``cudnn_calls`` times and the sync side ``sync_calls``."""
    timed = []

    def timer(fn):
        n = sync_calls if len(timed) % 2 else cudnn_calls  # 12a times cuDNN's side first
        timed.append(n)
        for _ in range(n):
            fn()
        return 0.0

    return timer


@pytest.mark.parametrize("cudnn_calls,sync_calls", [(1, 5), (5, 1)])
def test_sync_bn_check_record_is_independent_of_the_timer(group, cudnn_calls, sync_calls):
    result = chip_smoke.sync_bn_check(group, device="cpu", shape=SHAPE,
                                      timer=_stub_timer(cudnn_calls, sync_calls))
    for label in ("f32", "bf16"):
        assert result[label]["calls"] == {"cudnn": 1 + cudnn_calls, "sync": 1 + sync_calls}
        for key, err in result[label]["rel_err"].items():
            tol = chip_smoke.TOL_SYNC_BN[label if key in ("y", "dx", "dw", "db") else "f32"]
            assert err <= tol, (label, key, err)
    lo, hi = result["f32"]["dx_ratio_range"]
    assert abs(lo - 1.0) <= 1e-3 and abs(hi - 1.0) <= 1e-3

