"""Serving single clouds: one client in a closed loop with no think time
calls the port's ``apis.Detector`` (``init_detector`` of the configuration's
test config, with the seed's weights loaded), each request a numpy cloud
that the Detector samples, runs through the eval forward, decode + NMS
and the per-class expansion, and returns as numpy arrays.

Each request is timed from the call to the return of its result; a
sample of the window's requests, drawn from the seed over all of them,
is kept as returned and compared after the window with the reference's
run of the same cloud through the same steps."""
from __future__ import annotations

import math
import random
import time

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
from perfbench.harness.scenes import make_rooms


class Kind:
    unit = "request"
    spans = None
    e2e = "request_p95_ms"

    def __init__(self, cell: Cell):
        self.cell = cell
        self.latencies: list = []
        self.kept: list = []
        self.seen = 0
        self.failed = 0
        self.rng = random.Random(f"{cell.seed}/sample")

    def setup(self) -> None:
        from nesie_tpu_torch.apis import init_detector
        from nesie_tpu_torch.config import (
            InferenceConfig,
            get_config,
        )

        ph = self.phases = Phases()
        c, t = self.cell, self.cell.traffic
        name = c.cfg["port_configs"]["test"]
        pcfg = get_config(name)
        check_port_config(c.cfg, name, dict(
            model=pcfg.model, test=InferenceConfig.from_experiment(pcfg)))
        self.det = init_detector(name, device=c.device)
        self.spec = weights.spec(self.det.model.state_dict())
        ph.mark("imports and detector")
        self.det.model.load_state_dict(
            weights.make_weights(self.spec, c.gen("weights")))
        ph.mark("weights")
        gen = c.gen("scenes")
        pts = make_rooms(gen, t["clouds"], t["cloud_points"],
                         tuple(t["objects"]))[0]
        self.clouds = list(pts.cpu().numpy())
        ph.mark("clouds")
        self.det(self.clouds[0])  # warm-up: the one shape a request has
        ph.mark("warm-up request")
        self.i = 0

    def run_unit(self) -> None:
        j = self.i % len(self.clouds)
        t0 = time.perf_counter()
        ans = self.det(self.clouds[j])
        self.latencies.append((time.perf_counter() - t0) * 1e3)
        self.i += 1
        self.seen += 1
        if not all(np.isfinite(v).all() for v in ans.values()):
            self.failed += 1
        k = self.cell.traffic["checked"]
        if len(self.kept) < k:
            self.kept.append((j, ans))
        else:
            r = self.rng.randrange(self.seen)
            if r < k:
                self.kept[r] = (j, ans)

    def sync(self) -> None:
        pass  # every request returns host arrays

    def window_metrics(self, units: int, wall_s: float) -> dict:
        return {self.e2e: float(np.percentile(self.latencies, 95))}

    def outcome(self) -> tuple[int, int]:
        return self.seen, self.failed

    def notes(self) -> list[str]:
        lat = np.asarray(self.latencies)
        return [self.phases.line(), f"{len(lat)} requests: latency median "
                f"{np.median(lat):.4f} ms, p95 {np.percentile(lat, 95):.4f}"
                f", max {lat.max():.4f}; detections returned by the sampled "
                f"requests: {[len(a['scores_3d']) for _, a in self.kept]}"]

    def free(self) -> None:
        del self.det
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, fault: str | None = None,
                  device=None) -> list:
        """The reference's decode of the sampled requests' clouds
        (``tf32``: the control's precision; ``device``: the cell's by
        default)."""
        from perfbench.reference import build
        from perfbench.reference.data import io

        c, test = self.cell, self.cell.cfg["test"]
        dev = c.device if device is None else torch.device(device)
        with precision(tf32):
            net = build.model(c.cfg)
            net.load_state_dict(weights.make_weights(self.spec,
                                                     c.gen("weights")))
            net = net.to(dev).eval()
            out = []
            for j, _ in self.kept:
                pts = io.add_height(np.asarray(self.clouds[j],
                                               np.float32)[:, :3])
                pts = io.sample_points(pts, test["num_points"],
                                       np.random.default_rng(test["seed"]))
                pts = torch.from_numpy(np.ascontiguousarray(pts[None])).to(
                    dev)
                out.append(scene_rows(reference_decode(net, pts, test), 0))
        return out

    def numbers(self, ref: list) -> dict:
        return self.numbers_from([ans for _, ans in self.kept], ref)

    def numbers_from(self, answers: list, ref: list) -> dict:
        """``answers``: per sampled request the returned dict, or a
        reference decode (a control), expanded per class here."""
        from perfbench.reference.eval.postprocess import expand_per_class

        tol = self.cell.limits["decision_tol"]
        test = self.cell.cfg["test"]
        worst = dict(score_gap=0.0, box_gap=0.0, keep_flips=0)
        if len(ref) != len(answers) or not ref:
            return {k: math.inf for k in worst}
        for ans, r in zip(answers, ref):
            if "boxes_3d" not in ans:
                boxes, scores, labels = expand_per_class(dict(
                    bbox=ans["bbox"], obj_scores=ans["obj"],
                    sem_scores=ans["sem"], selected=ans["selected"]))
                ans = dict(boxes_3d=boxes, scores_3d=scores,
                           labels_3d=labels)
            got = answer_numbers(ans, r, test, tol)
            worst = merge(worst, got)
        return worst


def answer_numbers(ans: dict, r: dict, test: dict, tol: float) -> dict:
    """A returned answer (boxes_3d (S*C, 7), scores_3d, labels_3d: the
    kept proposals expanded per class) against the reference's decode of
    the same cloud: each returned box is matched to the reference's
    nearest proposal, and the comparison is ``decoded_numbers``' on the
    proposals the answer kept, with a wrongly labelled row counted as a
    flip."""
    inf = dict(score_gap=math.inf, box_gap=math.inf, keep_flips=math.inf)
    c = r["sem"].shape[-1]
    boxes = np.asarray(ans["boxes_3d"], np.float64)
    scores = np.asarray(ans["scores_3d"], np.float64)
    labels = np.asarray(ans["labels_3d"])
    if len(boxes) % c or len(scores) != len(boxes) or \
            len(labels) != len(boxes):
        return inf
    s = len(boxes) // c
    first = boxes[:s]
    if s and not np.isfinite(first).all():
        return inf
    idx = (np.abs(first[:, None, :] - r["bbox"][None].astype(np.float64))
           .max(-1).argmin(-1) if s else np.zeros(0, int))
    selected = np.zeros(len(r["obj"]), bool)
    selected[idx] = True
    want_labels = np.repeat(np.arange(c), s)
    wrong = int((labels != want_labels).sum()) + (s - len(set(idx.tolist())))
    box_gap = float(np.abs(boxes - np.tile(r["bbox"][idx], (c, 1))).max()) \
        if s else 0.0
    want = (r["obj"][idx][None, :] * r["sem"][idx].T).reshape(-1)
    score_gap = float(np.abs(scores - want).max()) if s else 0.0
    prog = dict(bbox=r["bbox"], obj=r["obj"], sem=r["sem"],
                selected=selected)
    got = decoded_numbers([prog], [r], test, tol)
    return dict(got, score_gap=score_gap, box_gap=box_gap,
                keep_flips=got["keep_flips"] + wrong)
