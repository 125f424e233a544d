"""One cell: its configuration, traffic mix and limits, found by name
under ``perfbench/``, with the generators drawn from ``--seed``."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(spec: dict, workload: str) -> tuple[dict, dict]:
    """The workload entry and its configuration entry."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return cell, cfg


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict       # perfbench/configs/<config>.json
    traffic: dict   # perfbench/traffic/<traffic>.json
    limits: dict    # perfbench/limits/<workload>.json
    seed: int
    device: torch.device

    @staticmethod
    def load(workload: str, seed: int, device, root: Path = ROOT) -> "Cell":
        entry, conf = find(load_spec(root), workload)
        bench = root / "perfbench"
        return Cell(
            name=workload,
            cfg=json.loads((root / conf["file"]).read_text()),
            traffic=json.loads(
                (bench / "traffic" / f"{entry['traffic']}.json").read_text()),
            limits=json.loads(
                (bench / "limits" / f"{workload}.json").read_text()),
            seed=seed, device=torch.device(device))

    def gen(self, purpose: str) -> torch.Generator:
        """A generator on the cell's device for one purpose (weights,
        scenes, the window's draws), seeded from ``--seed`` and the
        purpose."""
        h = hashlib.sha256(f"{self.seed}/{purpose}".encode()).digest()
        return torch.Generator(self.device).manual_seed(
            int.from_bytes(h[:8], "little") >> 1)


def check_port_config(cfg: dict, port_cfg, sections) -> None:
    """Raise if the port's named configuration departs from the benchmark
    configuration file in any of ``sections`` (file key -> the port's
    dataclass or dict of that section)."""
    bad = []
    for key, got in sections.items():
        if dataclasses.is_dataclass(got):
            got = dataclasses.asdict(got)
        want = cfg[key]
        for k, v in want.items():
            g = got.get(k, "<missing>")
            if _norm(g) != _norm(v):
                bad.append(f"{key}.{k}: port {g!r}, configuration {v!r}")
    if bad:
        raise SystemExit(f"the port's {port_cfg} departs from the benchmark "
                         "configuration: " + "; ".join(bad))


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, float):
        return round(v, 9)
    return v


class Phases:
    """Host seconds of set-up's phases, for a line before the result."""

    def __init__(self):
        self.t = time.perf_counter()
        self.rows: list = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.rows.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return "set-up phases (s): " + ", ".join(
            f"{n} {s:.3f}" for n, s in self.rows)
