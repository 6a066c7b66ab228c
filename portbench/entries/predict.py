"""Entry ``predict``: batch prediction through ``predict.predict_probs``, one client, closed loop.

Set-up builds the program's model (two-class head) from the benchmark's
seeded weights, BN's running statistics calibrated on a seeded batch
(``gen.calibrated``), and its inference function (``engine/steps.make_predict_fn``),
and makes a pool of seeded batches of letterboxed canvases as host NHWC
float32 arrays, as the predict CLI's letterbox gives them. The window
calls ``predict_probs(predict_fn, batch)`` on the pool's batches in turn,
each call after the last one's probabilities are on the host, until
``--seconds`` have passed. A seeded sample of the calls keeps its
probabilities, and the last call's too, for the comparison after the
window. With ``--trace 1`` a bounded stretch of calls after the window
runs under the profiler.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import gen
from portbench.check import predict_gaps
from portbench.reference import models as ref_models


class Session:
    STRETCH = "predict_call"  # the span of one traced unit of work
    FAULTS = ("half_batch", "altered_answer")

    def __init__(self, run):
        from unet_embroidery_seg_torch import predict as port_predict
        from unet_embroidery_seg_torch.engine import steps
        from unet_embroidery_seg_torch.models import build_model
        from unet_embroidery_seg_torch.utils.device import set_float32_precision

        set_float32_precision()
        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        self.size, self.batch = cell["size"], cell["batch"]
        self.predict_probs = port_predict.predict_probs
        self.spec = gen.init_spec(_meta_reference(cfg))
        model = build_model(cfg["model"], cfg["num_classes"], device=dev)
        model.load_state_dict(self._weights())
        if dev.type == "cuda":  # the calibration's forward is the benchmark's, not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        fn = steps.make_predict_fn(model, amp=cell["dtype"] == "bf16")
        if run.fault == "half_batch":
            whole = fn
            fn = lambda x: whole(x[: len(x) // 2])  # noqa: E731
        elif run.fault == "altered_answer":
            whole = fn

            def fn(x):  # the first image's two classes swapped
                logits = whole(x)
                return torch.cat([logits[:1].flip(-1), logits[1:]])
        self.model, self.fn = model, fn
        self.dispatch_s, self.timing = [], False
        self.pool = [gen.predict_batch(run.seed, b, self.batch, self.size, dev).cpu().numpy()
                     for b in range(cell["pool"])]
        for _ in range(2):  # warm-up: the one shape this cell uses
            self.predict_probs(self._predict_fn, self.pool[0])
        self.kept: list[tuple[int, np.ndarray]] = []
        self.calls = 0

    def _weights(self) -> dict[str, torch.Tensor]:
        """The seeded weights with BN's running statistics calibrated (``gen.calibrated``)."""
        run, dev = self.run, self.run.device
        ref = _meta_reference(run.config).to_empty(device=dev)
        out = gen.calibrated(ref, gen.weights(self.spec, run.seed, dev), run.seed, self.size, dev)
        del ref
        return out

    def _predict_fn(self, images):
        t = time.perf_counter()
        with self.run.tracer.span("predict_fn"):
            out = self.fn(images)
        if self.timing:
            self.dispatch_s.append(time.perf_counter() - t)
        return out

    def _call(self) -> tuple[float, np.ndarray, int]:
        b = self.calls % len(self.pool)
        self.calls += 1
        t = time.perf_counter()
        probs = self.predict_probs(self._predict_fn, self.pool[b])
        return time.perf_counter() - t, probs, b

    def window(self) -> dict:
        run = self.run
        keep = np.random.default_rng((run.seed, gen.SAMPLE))
        want = (self.batch, self.size, self.size, run.config["num_classes"])
        latencies, images, failed, last = [], 0, 0, None
        self.dispatch_s.clear()
        self.timing = True
        t0 = time.perf_counter()
        run.mark_first_step()
        while True:
            dt, probs, b = self._call()
            latencies.append(dt)
            images += len(probs)
            failed += probs.shape != want
            if keep.random() < run.cell["check_share"]:
                self.kept.append((b, probs))
                last = None
            else:
                last = (b, probs)
            if time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
        self.timing = False
        if last is not None:
            self.kept.append(last)
        p95 = float(np.percentile(np.asarray(latencies) * 1e3, 95, method="linear"))
        stats = {"img_per_s": images / elapsed, "window_s": elapsed, "calls": len(latencies),
                 "dispatch_s": list(self.dispatch_s), "checked_calls": len(self.kept)}
        if run.trace:
            stats.update(self._traced())
        return {"metrics": {"predict_img_per_s": images / elapsed, "predict_p95_ms": p95},
                "attempted": len(latencies), "failed": int(failed), "stats": stats}

    def _traced(self) -> dict:
        run = self.run
        run.tracer.start()
        for _ in range(run.cell["profile_calls"]):
            with run.tracer.span("predict_call"):
                self._call()
        run.tracer.stop()
        return {"profiled_calls": run.cell["profile_calls"]}

    def free(self) -> None:
        self.model = self.fn = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- what decides ``correct`` -----------------------------------------------------------
    def program_readings(self) -> list[tuple[int, np.ndarray]]:
        return self.kept

    def reference(self, precision: str) -> dict[int, np.ndarray]:
        """The reference's probabilities of each pool batch the sample holds, from the seed."""
        run, cfg, dev = self.run, self.run.config, self.run.device
        model = _meta_reference(cfg).to_empty(device=dev)
        model.load_state_dict(self._weights())
        model = ref_models.set_precision(model, precision).eval()
        out = {}
        with torch.no_grad():
            for b in sorted({b for b, _ in self.kept}):
                x = gen.predict_batch(run.seed, b, self.batch, self.size, dev)
                with ref_models.Precision(precision, dev):
                    logits = model(x.permute(0, 3, 1, 2))
                out[b] = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1).cpu().numpy()
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def as_program(self, ref: dict[int, np.ndarray]) -> list[tuple[int, np.ndarray]]:
        """The reference's probabilities in the program's place (the control)."""
        return [(b, ref[b]) for b, _ in self.kept]

    def gaps(self, got, want) -> dict:
        return predict_gaps(got, want)


def _meta_reference(cfg: dict) -> torch.nn.Module:
    with torch.device("meta"):
        return ref_models.build(cfg, diff=False)
