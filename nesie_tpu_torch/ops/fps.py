"""Furthest point sampling: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``nesie_tpu/ops/pallas_fps.py``, whose two Pallas kernels
(the batched ``_fps_batched_kernel`` and the single-row ``_fps_kernel``)
both have ``csrc/fps_onchip.cu`` as their CUDA kernel: each row held on
chip on one CTA or across a thread-block cluster, with the exchange of a
step's candidates chosen by its plan. ``fps_ref`` is its plain version.
``ops.pointops.furthest_point_sample`` picks between the plain version
and ``fps_onchip``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def fps_ref(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain D-FPS: (B, N, 3) float32 -> (B, M) int32.

    Start at index 0 with every distance at 1e10; each step takes
    ``min(dist, (dx*dx + dy*dy) + dz*dz)`` and the first index of the
    maximum (``torch.argmax`` returns the first maximal index).
    """
    return fps_steps(xyz, num_samples,
                     lambda dist: dist.argmax(dim=1, keepdim=True))


def fps_steps(xyz: torch.Tensor, num_samples: int, select) -> torch.Tensor:
    """``fps_ref``'s loop with the next index found by ``select``: the
    (B, N) distances -> (B, 1) int64 indices."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, num_samples), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.int64, device=xyz.device)
    for i in range(1, num_samples):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        last = select(dist)
        out[:, i] = last[:, 0].to(torch.int32)
    return out


def _check_samples(N: int, num_samples: int) -> None:
    if not 1 <= num_samples <= N:
        raise ValueError(f"num_samples={num_samples} must be in [1, N={N}]")


# the exchanges of csrc/fps_onchip.cu, by their number in its C interface
EXCHANGES = ("auto", "local", "barrier", "mailbox", "mailbox_cta")
# the most rows a batch of the single-row kernel's regime has (requests,
# training steps); such a batch counts its launches as fps_onchip_small
FPS_SMALL_MAX_ROWS = 16
# steps the instrumented kernel stamps, and its stamps a step
TIMED_STEPS, STAMPS = 512, 6


def fps_launch_name(batch: int) -> str:
    """The launch count a batch of ``batch`` rows adds to in
    ``_build.KERNELS``: ``fps_onchip_small`` up to 16 rows (the TPU's
    single-row kernel's regime), else ``fps_onchip`` (the batched one)."""
    return "fps_onchip_small" if batch <= FPS_SMALL_MAX_ROWS else "fps_onchip"


def _exchange_id(exchange: str) -> int:
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange {exchange!r} is not one of {EXCHANGES}")
    return EXCHANGES.index(exchange)


def fps_onchip_plan(batch: int, n: int, cluster_size: int = 0,
                    threads: int = 0, exchange: str = "auto",
                    timed: bool = False) -> dict:
    """The launch plan ``fps_onchip_cuda`` takes for (batch, n): cluster
    size, threads per CTA, points per thread held in registers (0: the
    streaming kernel, coordinates read from L2), dynamic shared memory
    bytes, whether the streaming kernel needs a (B, N) scratch, how many
    clusters (CTAs for the local exchange) are resident at once, and the
    exchange. ``cluster_size`` (1 to 16), ``threads`` (a cap) and
    ``exchange`` ask for a plan; 0 and "auto" let the plan choose.
    ``timed``: the instrumented kernel's plan. Raises where no plan
    fits."""
    plan = (ctypes.c_int * 7)()
    err = _build.library().nesie_fps_onchip_plan(
        batch, n, cluster_size, threads, _exchange_id(exchange), int(timed),
        ctypes.addressof(plan))
    if err != 0:
        raise RuntimeError(f"fps_onchip: no launch plan for B={batch}, N={n}, "
                           f"cluster_size={cluster_size}, threads={threads}, "
                           f"exchange={exchange} (cudaError {err})")
    return dict(cluster=plan[0], threads=plan[1], points_per_thread=plan[2],
                smem_bytes=plan[3], scratch=bool(plan[4]),
                resident_clusters=plan[5], exchange=EXCHANGES[plan[6]])


def fps_onchip_cuda(xyz: torch.Tensor, num_samples: int,
                    cluster_size: int = 0, threads: int = 0,
                    exchange: str = "auto") -> torch.Tensor:
    """Launch ``csrc/fps_onchip.cu``: each row held on chip on one CTA or
    across a thread-block cluster. ``cluster_size``, ``threads`` and
    ``exchange`` ask for a plan (see ``fps_onchip_plan``); 0 and "auto"
    let the plan choose."""
    _build.check_cuda_input("xyz", xyz)
    B, N, _ = xyz.shape
    _check_samples(N, num_samples)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    plan = fps_onchip_plan(B, N, cluster_size, threads, exchange)
    scratch = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
               if plan["scratch"] else None)
    _build.launch(fps_launch_name(B), "nesie_fps_onchip", xyz.data_ptr(), B,
                  N, num_samples, cluster_size, threads,
                  _exchange_id(exchange),
                  None if scratch is None else scratch.data_ptr(),
                  out.data_ptr(), device=xyz.device)
    return out


def fps_onchip_timed(xyz: torch.Tensor, num_samples: int,
                     cluster_size: int = 0, threads: int = 0,
                     exchange: str = "auto"):
    """Launch the instrumented instantiation of ``csrc/fps_onchip.cu``
    (registers layout only). Returns the indices and a (TIMED_STEPS,
    STAMPS) int64 tensor of thread 0 of row 0's first CTA: clock64() at
    the step's start, after the point loop, the warp reduction, the push,
    the barrier or wait, and the cross-CTA reduction (-1 where a step or
    a phase did not run)."""
    _build.check_cuda_input("xyz", xyz)
    B, N, _ = xyz.shape
    _check_samples(N, num_samples)
    fps_onchip_plan(B, N, cluster_size, threads, exchange, timed=True)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    stamps = torch.full((TIMED_STEPS, STAMPS), -1, dtype=torch.int64,
                        device=xyz.device)
    _build.launch("fps_onchip_timed", "nesie_fps_onchip_timed",
                  xyz.data_ptr(), B, N, num_samples, cluster_size, threads,
                  _exchange_id(exchange), stamps.data_ptr(), out.data_ptr(),
                  device=xyz.device)
    return out, stamps
