"""Entry ``train_chunk``: resident training through the train CLI's chunked loop.

Set-up builds the program's model from the benchmark's seeded weights,
its Adam and its binary train step (``engine/steps.make_binary_train_step``),
uploads the seeded split as ``engine/resident.ResidentData`` and wraps the
step in ``engine/resident.make_train_chunk_fn`` (gather, on-card
augmentation, step), as ``python -m unet_embroidery_seg_torch.train`` does
on the card. The epoch plans are the benchmark's (``gen.plan``), uploaded
at each epoch's start. Chunk k of an epoch runs steps [kK, (k+1)K) and
its losses are read once, as the CLI reads them.

The first chunk is the warm-up and the comparison's run at once: the step
wrapper keeps Adam's first moment after step 1 (the first gradient as Adam
took it) and the parameters' change after step 3 (``Readings``), through the same chunk call and feed the window
uses. The window then runs chunks on from there, across epochs, until
``--seconds`` have passed, and ends in a synchronise. With ``--trace 1`` a
bounded stretch of chunks after the window runs under the profiler, each
chunk and each step call inside a span of its own.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import gen
from portbench.check import train_gaps
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train

COMPARED_STEPS = 3
ADAM_BETA1 = 0.9


class Session:
    STRETCH = "chunk"  # the span of one traced unit of work
    FAULTS = ("unchanged_state", "half_batch")

    def __init__(self, run):
        from unet_embroidery_seg_torch.engine import resident, steps
        from unet_embroidery_seg_torch.models import build_model
        from unet_embroidery_seg_torch.ops import schedules
        from unet_embroidery_seg_torch.utils.device import set_float32_precision

        set_float32_precision()
        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        self.size, self.batch, self.k = cell["size"], cell["batch"], cell["chunk"]
        self.n = cell["split"]
        images, masks, wh = gen.split(run.seed, self.n, self.size, dev)
        self.pos_weight = None
        if cfg["loss"] == "bce":
            rows = torch.as_tensor(gen.pos_weight_rows(self.n), device=dev)
            self.pos_weight = gen.pos_weight(masks[rows])
        self.data = resident.ResidentData(images, masks, wh, None, self.n)

        self.spec = gen.init_spec(_meta_reference(cfg))
        weights = gen.weights(self.spec, run.seed, dev)
        model = build_model(cfg["model"], cfg["num_classes"], diff_head=True, device=dev)
        model.load_state_dict(weights)
        opt = schedules.make_train_optimizer(model.parameters(), cell["lr"],
                                             weight_decay=cell["weight_decay"])
        step = steps.make_binary_train_step(model, opt, cfg["loss"], self.pos_weight,
                                            amp=cell["dtype"] == "bf16")
        if run.fault == "unchanged_state":
            opt.step = lambda *a, **k: None
        elif run.fault == "half_batch":
            whole, h = step, self.batch // 2
            step = lambda images, pngs, sm: whole(images[:h], pngs[:h], sm[:h])  # noqa: E731
        self.model, self.opt, self.step = model, opt, step
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.before = [weights[n] for n in self.names]
        self.calls, self.dispatch_s, self.timing = 0, [], False
        self.readings = {}
        self.chunk_fn = resident.make_train_chunk_fn(
            self._step, (self.size, self.size), True, cfg["num_classes"],
            augment=cell["augment"], seed=run.seed)
        self.epoch, self.c0, self.plan = 0, 0, None

        steps_done, losses = self._chunk()  # warm-up, and the compared steps
        if steps_done < COMPARED_STEPS:
            raise ValueError(f"a chunk of {steps_done} steps: {COMPARED_STEPS} are compared")
        self.readings["losses"] = losses[:COMPARED_STEPS].tolist()
        self.before = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- the program's step, as the chunk calls it ------------------------------------------
    def _step(self, images, pngs, sample_mask):
        t = time.perf_counter()
        with self.run.tracer.span("train_step"):
            loss = self.step(images, pngs, sample_mask)
        if self.timing:
            self.dispatch_s.append(time.perf_counter() - t)
        self.calls += 1
        if self.calls == 1:
            states = [self.opt.state.get(p, {}).get("exp_avg") for p in self.params]
            # to the host at once (set-up only), so that the card's peak does not hold them
            self.readings["grad_vectors"] = [
                torch.zeros_like(p).cpu() if s is None else (s / (1 - ADAM_BETA1)).cpu()
                for s, p in zip(states, self.params)]
        elif self.calls == COMPARED_STEPS:
            with torch.no_grad():
                self.readings["change_vectors"] = [
                    d.cpu() for d in torch._foreach_sub(self.params, self.before)]
        return loss

    def _chunk(self) -> tuple[int, torch.Tensor]:
        """Run the next chunk of the plan; (its steps, its losses read to the host)."""
        dev = self.run.device
        if self.c0 == 0:
            idx, mask = gen.plan(self.n, self.batch, self.epoch, self.run.seed)
            self.plan = (torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev), mask)
        idx_t, mask_t, mask = self.plan
        c0, c1 = self.c0, min(self.c0 + self.k, len(mask))
        out = self.chunk_fn(self.data, idx_t[c0:c1], mask_t[c0:c1], self.epoch, range(c0, c1))
        losses = out.cpu()  # the chunk's one read, as the train CLI reads it
        self.images_done = float(mask[c0:c1].sum())
        self.c0 = c1 if c1 < len(mask) else 0
        self.epoch += self.c0 == 0
        return c1 - c0, losses

    # -- the measured window ------------------------------------------------------------------
    def window(self) -> dict:
        run = self.run
        steps = images = failed = 0
        self.dispatch_s.clear()
        self.timing = True
        t0 = time.perf_counter()
        run.mark_first_step()
        while True:
            n, losses = self._chunk()
            steps += n
            images += self.images_done
            failed += int((~torch.isfinite(losses)).sum())
            if time.perf_counter() - t0 >= run.seconds:
                break
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        elapsed = time.perf_counter() - t0
        self.timing = False
        stats = {"img_per_s": images / elapsed, "window_s": elapsed, "steps": steps,
                 "dispatch_s": list(self.dispatch_s)}
        if run.trace:
            stats.update(self._traced())
        return {"metrics": {"train_img_per_s": images / elapsed}, "attempted": steps,
                "failed": failed, "stats": stats}

    def _traced(self) -> dict:
        """A bounded stretch of whole chunks under the profiler, after the window."""
        run = self.run
        chunks = max(1, math.ceil(run.cell["profile_steps"] / self.k))
        steps = 0
        run.tracer.start()
        for _ in range(chunks):
            with run.tracer.span("chunk"):
                n, _ = self._chunk()
            steps += n
        run.tracer.stop()
        return {"profiled_steps": steps}

    def free(self) -> None:
        self.model = self.opt = self.step = self.chunk_fn = self.data = self.plan = None
        self.params = []
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- what decides ``correct`` -----------------------------------------------------------
    def program_readings(self) -> ref_train.Readings:
        r = self.readings
        grads = dict(zip(self.names, r["grad_vectors"]))
        change = dict(zip(self.names, r["change_vectors"]))
        return ref_train.Readings(
            [float(v) for v in r["losses"]],
            {k: float(v.norm()) for k, v in grads.items()},
            {k: float(v.norm()) for k, v in change.items()},
            grad_vectors=grads, change_vectors=change)

    def reference(self, precision: str) -> ref_train.Readings:
        """The reference's readings of the compared steps, from the seed alone."""
        run, cell, cfg, dev = self.run, self.run.cell, self.run.config, self.run.device
        model = _meta_reference(cfg).to_empty(device=dev)
        model.load_state_dict(gen.weights(self.spec, run.seed, dev))
        model = ref_models.set_precision(model, precision)
        pos_weight = None
        if cfg["loss"] == "bce":
            rows = gen.pos_weight_rows(self.n)
            pos_weight = gen.pos_weight(gen.split_rows(run.seed, rows, self.size, dev)[1])
        idx, mask = gen.plan(self.n, self.batch, 0, run.seed)
        if not np.all(mask[:COMPARED_STEPS]):
            raise ValueError("the compared steps hold padded rows")
        batches = [ref_train.batch(run.seed, 0, k,
                                   gen.split_rows(run.seed, idx[k], self.size, dev),
                                   (self.size, self.size), cell["augment"])
                   for k in range(COMPARED_STEPS)]
        out = ref_train.run_steps(model, batches, cfg["loss"], pos_weight, cell["lr"],
                                  cell["weight_decay"], precision)
        del model, batches
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def as_program(self, ref: ref_train.Readings) -> ref_train.Readings:
        """The reference's readings in the program's place (the control)."""
        return ref

    def gaps(self, got: ref_train.Readings, want: ref_train.Readings) -> dict:
        return train_gaps(got, want, head=f"{self.run.config['head']}.weight")


def _meta_reference(cfg: dict) -> torch.nn.Module:
    with torch.device("meta"):
        return ref_models.build(cfg, diff=True)
