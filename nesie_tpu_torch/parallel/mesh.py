"""Data parallelism: one process a card under ``torchrun``. Counterpart of
``nesie_tpu/parallel/mesh.py``.

The JAX package's mesh is single-program: BN statistics, loss normalisers
and gradients are taken over the global batch, so a mesh of any size
computes what one device computes on the whole batch. The port keeps that
invariant across processes with explicit collectives:

* train-mode BN sums (Σx, Σx², n) over every rank (``nn.layers.BatchNorm``,
  through ``global_sum``, whose backward sums the incoming gradient too);
* every loss normaliser divides by a sum over every rank
  (``train.targets``, ``train.sup_loss``; the SAQE angle label's largest
  box weight by a max), so the ranks' local losses add up to the global
  loss;
* ``train.state.apply_gradients`` sums the gradients over the ranks before
  the clip, so the clip, AdamW and the EMA teacher run identically on
  every rank;
* the step's draws (jitter noise, ``random``'s seed indices) are made for
  the global batch from the generator every rank seeds alike, and each
  rank keeps its rows (``RowLayout.draw``); the semi step gathers the
  unlabeled rows' ``(scan_idx, hist)`` and the teacher's classes where a
  global index reads them.

**Row layout.** A batch is one or more parts: the semi step's labeled and
unlabeled scenes, or the one part of a supervised or eval batch. Rank r
holds rows [r·b_p, (r+1)·b_p) of each part p, the parts in order, so the
ranks' rows of a part, concatenated in rank order, are that part of the
global batch. This differs on purpose from the JAX package's multi-process
layout (``process_local_rows`` over the whole [labeled; unlabeled] batch),
under which a rank could hold only labeled rows: the semi step slices its
batch at ``n_labeled``, so every rank needs rows of both parts.

**Backend.** NCCL when each rank has a card of its own; gloo when ranks
share a card (NCCL refuses two ranks on one GPU) or run on the CPU. Gloo
sums and gathers CUDA tensors through the host.

Without a launched process group (no ``torchrun`` environment) the world
is one process and nothing here communicates: every call path is the
one-process one, bit for bit.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

log = logging.getLogger("nesie_tpu_torch")

TIMEOUT_S = 120  # a rank that waits longer in a collective fails


@dataclass(frozen=True)
class Mesh:
    """The launched world as this process sees it."""
    size: int              # ranks
    rank: int
    device: torch.device   # this rank's device
    backend: str | None    # "nccl", "gloo", or None without a group


def active() -> bool:
    """Whether a process group is launched (collectives communicate)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def _launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def make_mesh(num_devices: int | None = None, device="cuda") -> Mesh:
    """The data-parallel world from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``): sets this rank's card and starts the process group
    once a process, every collective timing out after ``TIMEOUT_S`` (a
    later call returns the same world). Without that environment, a world
    of one with no group. Raises ``ValueError`` when ``num_devices`` is
    given and is not the world size."""
    device = torch.device(device)
    if not _launched():
        check_num_devices(num_devices, 1)
        return Mesh(1, 0, device, None)
    size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    check_num_devices(num_devices, size)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        backend = "nccl" if cards >= local_world else "gloo"
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    if not active():
        dist.init_process_group(backend, timeout=timedelta(seconds=TIMEOUT_S))
        log.info("process group: rank %d of %d, backend %s, device %s",
                 dist.get_rank(), size, backend, device)
        if device.type == "cuda":
            _build_kernels_once(local_rank)
    return Mesh(size, dist.get_rank(), device, dist.get_backend())


def check_num_devices(num_devices: int | None,
                      size: int | None = None) -> None:
    """Raise ``ValueError`` unless ``num_devices`` is None or the world
    size (default: the launched one)."""
    size = world_size() if size is None else size
    if num_devices is not None and num_devices != size:
        raise ValueError(
            f"num_devices={num_devices}, but {size} process(es) run: launch "
            f"one process a device with torchrun --nproc_per_node "
            f"{num_devices} (or leave num_devices unset)")


def _build_kernels_once(local_rank: int) -> None:
    """The program's kernel library is built by local rank 0 while the
    others wait, so that one ``nvcc`` runs a host."""
    from nesie_tpu_torch.ops import _build

    if local_rank == 0:
        _build.build()
    dist.barrier()


def shutdown() -> None:
    """End the process group, if one was launched."""
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


# ------------------------------------------------------------ collectives
class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradients, since
    every rank's loss depends on every rank's summand."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (``x`` itself without a
    group)."""
    return _GlobalSum.apply(x) if active() else x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, no gradient (``x`` itself without a group)."""
    if not active():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the ranks, no gradient."""
    if not active():
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


@torch.no_grad()
def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the ranks in place, one collective a dtype."""
    if not active():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated on the leading axis
    in rank order (``x`` itself without a group)."""
    if not active():
        return x
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return torch.cat(out)


def reduce_metrics(metrics: dict) -> dict:
    """A step's 0-dim metrics summed over the ranks in one collective, each
    back in its dtype: the global loss terms and counts once the
    normalisers are global."""
    if not active() or not metrics:
        return metrics
    vals = torch.stack([v.detach().to(torch.float64)
                        for v in metrics.values()])
    dist.all_reduce(vals)
    return {k: s.to(v.dtype) for (k, v), s in zip(metrics.items(), vals)}


@torch.no_grad()
def replicate(*modules: torch.nn.Module) -> None:
    """Every module's parameters and buffers take rank 0's values (after
    init and after a restore)."""
    if not active():
        return
    for m in modules:
        for t in [*m.parameters(), *m.buffers()]:
            dist.broadcast(t.data, src=0)


# ------------------------------------------------------------ row layout
@dataclass(frozen=True)
class RowLayout:
    """This rank's rows of a global batch made of parts: ``parts`` are the
    per-rank row counts of each part (see the module docstring)."""
    parts: tuple
    size: int
    rank: int

    @property
    def rows(self) -> int:
        """Rows a rank holds."""
        return sum(self.parts)

    @property
    def global_rows(self) -> int:
        return self.rows * self.size

    def index(self, r: int | None = None) -> torch.Tensor:
        """Global row indices of rank ``r``'s rows (default this rank's),
        in its local order."""
        r = self.rank if r is None else r
        out, offset = [], 0
        for p in self.parts:
            out.append(torch.arange(offset + r * p, offset + (r + 1) * p))
            offset += p * self.size
        return torch.cat(out)

    def draw(self, draw_fn, shape) -> torch.Tensor:
        """``draw_fn(global shape)`` for the global batch, this rank's rows:
        every rank draws the same from a generator seeded alike."""
        if shape[0] != self.rows:
            raise ValueError(f"a draw of {shape[0]} rows under a layout of "
                             f"{self.rows} rows a rank")
        full = draw_fn((self.global_rows, *shape[1:]))
        return full[self.index().to(full.device)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` in the global batch's order."""
        got = all_gather_rows(x)
        order = torch.cat([self.index(r) for r in range(self.size)])
        out = torch.empty_like(got)
        out[order.to(got.device)] = got
        return out


def part_rows(*parts: int) -> RowLayout | None:
    """The layout of a batch whose parts hold ``parts`` rows a rank, or
    None without a group (draws and gathers are then the local ones)."""
    if not active():
        return None
    return RowLayout(tuple(parts), world_size(), rank())


def process_local_rows(global_rows: int) -> tuple[int, int]:
    """[lo, hi) of a one-part global batch that this rank holds."""
    size = world_size()
    if global_rows % size:
        raise ValueError(f"global batch {global_rows} not divisible by "
                         f"{size} ranks")
    per = global_rows // size
    return rank() * per, (rank() + 1) * per


def draw_rows(layout: RowLayout | None, draw_fn, shape) -> torch.Tensor:
    """``draw_fn(shape)``, or with a layout the global draw's rows of this
    rank."""
    return draw_fn(shape) if layout is None else layout.draw(draw_fn, shape)


def global_rows(layout: RowLayout | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` of the global batch (``x`` itself without a layout)."""
    return x if layout is None else layout.gather(x)


def shard_host_batch(batch: dict, device, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of a numpy host batch (its arrays, ``aug*`` dicts and
    scene-id lists), on ``device`` as ``data.dataset.batch_to_device``
    moves them."""
    from nesie_tpu_torch.data.dataset import batch_to_device

    def rows(v):
        if isinstance(v, dict):
            return {f: a[lo:hi] for f, a in v.items()}
        return v[lo:hi]

    return batch_to_device({k: rows(v) for k, v in batch.items()}, device)
