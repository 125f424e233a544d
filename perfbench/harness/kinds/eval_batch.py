"""Evaluating a checkpoint: the window runs the port's eval forward on a
batch, ``eval.postprocess.decode_and_nms`` and the copy of the
detections to the host, as ``tools/test.evaluate`` does a batch.

A sample of the window's batches, drawn from the seed over all of them,
is kept as the program returned it; after the window the reference
decodes the same clouds and each sampled batch is compared."""
from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

from perfbench.harness import weights
from perfbench.harness.cell import Cell, Phases, check_port_config
from perfbench.harness.kinds.detections import (
    decoded_numbers,
    merge,
    reference_decode,
    scene_rows,
)
from perfbench.harness.kinds.semi_train import precision
from perfbench.harness.scenes import add_height, make_rooms


class Kind:
    unit = "batch"
    spans = None  # set by the harness for a traced run's span part
    e2e = "eval_scenes_per_s"

    def __init__(self, cell: Cell):
        self.cell = cell
        self.b = cell.traffic["batch"]
        self.kept: list = []     # (batch index, host detections)
        self.seen = 0
        self.failed = 0
        self.rng = random.Random(f"{cell.seed}/sample")

    def _clouds(self) -> list:
        t, gen = self.cell.traffic, self.cell.gen("scenes")
        return [add_height(make_rooms(gen, self.b, t["points"],
                                      tuple(t["objects"]))[0])
                for _ in range(t["batches"])]

    def setup(self) -> None:
        from nesie_tpu_torch.config import (
            InferenceConfig,
            get_config,
        )
        from nesie_tpu_torch.eval.postprocess import decode_and_nms
        from nesie_tpu_torch.train.runner import build_model

        ph = self.phases = Phases()
        c = self.cell
        name = c.cfg["port_configs"]["test"]
        pcfg = get_config(name)
        check_port_config(c.cfg, name, dict(
            model=pcfg.model, test=InferenceConfig.from_experiment(pcfg)))
        model = build_model(pcfg)
        ph.mark("imports and model")
        self.spec = weights.spec(model.state_dict())
        model.load_state_dict(weights.make_weights(self.spec, c.gen("weights")))
        self.model = model.to(c.device).eval()
        self.decode = decode_and_nms
        ph.mark("weights")
        self.clouds = self._clouds()
        self.sync()
        ph.mark("clouds")
        self.i = 0
        self._batch(0)  # warm-up: the one shape the window uses
        ph.mark("warm-up batch")
        self.i, self.seen, self.kept, self.failed = 0, 0, [], 0

    def _batch(self, j: int) -> dict:
        test = self.cell.cfg["test"]
        pts = self.clouds[j]
        with torch.inference_mode():
            out = self.model(pts, test["sample_mod"])
            with (self.spans.span("decode_nms") if self.spans
                  else contextlib.nullcontext()):
                dec = self.decode(out, pts, nms_thr=test["nms_thr"],
                                  score_thr=test["score_thr"],
                                  use_iou_for_nms=test["use_iou_for_nms"])
                return {k: v.cpu().numpy() for k, v in dec.items()}

    def run_unit(self) -> None:
        j = self.i % len(self.clouds)
        host = self._batch(j)
        self.i += 1
        self.seen += 1
        if not all(v.dtype == bool or np.isfinite(v).all()
                   for v in host.values()):
            self.failed += 1
        # a sample of ``checked`` batches over the whole window (reservoir)
        k = self.cell.traffic["checked"]
        if len(self.kept) < k:
            self.kept.append((j, host))
        else:
            r = self.rng.randrange(self.seen)
            if r < k:
                self.kept[r] = (j, host)

    def sync(self) -> None:
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def window_metrics(self, units: int, wall_s: float) -> dict:
        return {self.e2e: units * self.b / wall_s}

    def outcome(self) -> tuple[int, int]:
        return self.seen, self.failed

    def notes(self) -> list[str]:
        sel = [int(h["selected"].sum()) for _, h in self.kept]
        return [self.phases.line(), f"sampled batches {[j for j, _ in self.kept]}, detections "
                f"kept in each: {sel}"]

    def free(self) -> None:
        del self.model
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, fault: str | None = None,
                  device=None) -> list:
        """The reference's decode of the sampled batches (``tf32``: the
        control's precision; ``device``: the cell's by default)."""
        from perfbench.reference import build

        c = self.cell
        dev = c.device if device is None else torch.device(device)
        with precision(tf32):
            net = build.model(c.cfg)
            net.load_state_dict(weights.make_weights(self.spec,
                                                     c.gen("weights")))
            net = net.to(dev).eval()
            out = []
            for j, _ in self.kept:
                ref = reference_decode(net, self.clouds[j].to(dev),
                                       c.cfg["test"])
                out.append([scene_rows(ref, i) for i in range(self.b)])
        return out

    def numbers(self, ref: list) -> dict:
        prog = []
        for _, host in self.kept:
            prog.append([dict(bbox=host["bbox"][i], obj=host["obj_scores"][i],
                              sem=host["sem_scores"][i],
                              selected=host["selected"][i])
                         for i in range(host["bbox"].shape[0])])
        return self.numbers_from(prog, ref)

    def numbers_from(self, prog: list, ref: list) -> dict:
        """``prog``: per sampled batch, per scene dict(bbox, obj, sem,
        selected) (the program's, or the reference's form of a control)."""
        tol = self.cell.limits["decision_tol"]
        worst = dict(score_gap=0.0, box_gap=0.0, keep_flips=0)
        for p, r in zip(prog, ref):
            got = decoded_numbers(p, r, self.cell.cfg["test"], tol)
            worst = merge(worst, got)
        if len(prog) != len(ref) or not prog:
            worst = {k: float("inf") for k in worst}
        return worst
