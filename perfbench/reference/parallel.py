"""The one-process forms of the port's collectives and row layouts, for
the benchmark's reference: every sum, gather and draw is the local one."""
from __future__ import annotations

import torch

RowLayout = None  # no layout in one process


def active() -> bool:
    return False


def global_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_sum_(tensors) -> None:
    return None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    return x


def reduce_metrics(metrics: dict) -> dict:
    return metrics


def part_rows(*parts: int):
    return None


def draw_rows(layout, draw_fn, shape) -> torch.Tensor:
    return draw_fn(shape)


def global_rows(layout, x: torch.Tensor) -> torch.Tensor:
    return x
