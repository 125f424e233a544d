"""Cells of the benchmark cut to a size the CPU tests can hold: the
same files, with the model narrowed (the port's named configurations
narrowed alike by ``narrow_port``) and the traffic shrunk."""
from __future__ import annotations

import copy
import json

import pytest
import torch

from perfbench.harness.cell import BENCH, ROOT, Cell

MODEL = dict(num_proposal=16, reg_max=8, num_points=[64, 32, 16, 16],
             num_samples=[8, 8, 4, 4],
             sa_channels=[[16, 16, 32], [32, 32, 32], [32, 32, 32],
                          [32, 32, 32]],
             fp_channels=[[32, 32], [32, 32]])
TRAFFIC = dict(semi_train=dict(labeled=2, unlabeled=2, points=512, max_gt=8,
                               gt_boxes=4, batches=4, checked_steps=3),
               eval_batch=dict(batch=2, points=512, batches=2, checked=2),
               serve_closed=dict(cloud_points=700, clouds=3, checked=2))
TEST_POINTS = 512


def overrides(model: dict) -> list[str]:
    def fmt(v):
        return repr(tuple(tuple(x) if isinstance(x, list) else x for x in v)
                    if isinstance(v, list) else v)
    return [f"model.{k}={fmt(v)}" for k, v in model.items()] + \
        [f"data.num_points={TEST_POINTS}"]


def narrow_port(patch=setattr) -> None:
    """Make ``get_config`` of the port, where the harness and ``apis``
    look it up, return its named configurations with ``overrides(MODEL)``
    applied. ``patch``: ``setattr``, or pytest's ``monkeypatch.setattr``
    to undo it after a test."""
    import nesie_tpu_torch.apis as apis
    import nesie_tpu_torch.config as config

    get = getattr(config.get_config, "__wrapped__", config.get_config)

    def narrowed(name):
        return config.apply_overrides(get(name), overrides(MODEL))
    narrowed.__wrapped__ = get
    for mod in (config, apis):
        patch(mod, "get_config", narrowed)


@pytest.fixture
def narrow(monkeypatch):
    """The port's named configurations narrowed as the tiny cells are,
    for one test (import it into a test module to use it)."""
    narrow_port(monkeypatch.setattr)


def tiny_cell(workload: str, seed: int = 7, device="cpu") -> Cell:
    """A cell of ``BENCHMARK.json`` cut to the tests' size (with
    ``narrow_port`` in effect)."""
    return tiny(Cell.load(workload, seed, device, ROOT))


def cell_of(config: str, traffic: str, seed: int = 7, device="cpu") -> Cell:
    """A cell of a configuration and a traffic mix by their file names,
    whether or not ``BENCHMARK.json`` pairs them (no limits)."""
    def read(kind, name):
        return json.loads((BENCH / kind / f"{name}.json").read_text())
    return Cell(name=f"{config}.{traffic}", cfg=read("configs", config),
                traffic=read("traffic", traffic), limits={}, seed=seed,
                device=torch.device(device))


def tiny(cell: Cell) -> Cell:
    """``cell`` cut to the tests' size (``MODEL``, ``TRAFFIC``)."""
    cfg = copy.deepcopy(cell.cfg)
    cfg["model"].update(MODEL)
    cfg["test"]["num_points"] = TEST_POINTS
    cell.cfg = cfg
    cell.traffic = dict(cell.traffic, **TRAFFIC[cell.traffic["kind"]])
    return cell
