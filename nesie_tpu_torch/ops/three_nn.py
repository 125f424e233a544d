"""Three nearest neighbours: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``nesie_tpu/ops/pallas_three_nn.py``. The kernel is
``csrc/three_nn.cu``; it returns indices only, and
``ops.pointops.three_nn`` recomputes the distances from them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_CHUNK_ELEMENTS = 1 << 24


def three_nn_ref(query: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Plain three-NN indices: (B, M, 3), (B, N, 3) -> (B, M, 3) int32.

    Exact ``(a-b)^2`` distances, three argmin passes (``torch.argmin``
    returns the first minimal index), so ties go to the lower index.
    """
    query = query.float()
    source = source.float()
    B, N, _ = source.shape
    M = query.shape[1]
    chunk = max(1, min(M, _CHUNK_ELEMENTS // max(1, B * N)))
    sx, sy, sz = (t[:, None, :] for t in source.unbind(-1))
    out = []
    for q in query.split(chunk, dim=1):
        dx = q[..., 0:1] - sx
        dy = q[..., 1:2] - sy
        dz = q[..., 2:3] - sz
        d2 = dx * dx + dy * dy + dz * dz  # (B, chunk, N)
        picks = []
        for _ in range(3):
            i = d2.argmin(dim=-1, keepdim=True)
            picks.append(i)
            d2 = d2.scatter(-1, i, float("inf"))
        out.append(torch.cat(picks, dim=-1).to(torch.int32))
    return torch.cat(out, dim=1)


def three_nn_plan(batch: int, m: int, queries_per_thread: int = 0) -> dict:
    """The launch plan ``three_nn_cuda`` takes for (batch, m) queries:
    queries a thread (1, 2 or 4; 0 lets the plan choose) and threads a
    block. Raises on a request the kernel does not take."""
    plan = (ctypes.c_int * 2)()
    err = _build.library().nesie_three_nn_plan(
        batch, m, queries_per_thread, ctypes.addressof(plan))
    if err != 0:
        raise RuntimeError(f"three_nn: no launch plan for B={batch}, M={m}, "
                           f"queries_per_thread={queries_per_thread} "
                           f"(cudaError {err})")
    return dict(queries_per_thread=plan[0], threads=plan[1])


def three_nn_cuda(query: torch.Tensor, source: torch.Tensor,
                  queries_per_thread: int = 0) -> torch.Tensor:
    """Launch ``csrc/three_nn.cu``: a block serves threads x Q queries of
    one row over the row staged in shared memory. ``queries_per_thread``
    asks for Q (see ``three_nn_plan``); 0 lets the plan choose."""
    _build.check_cuda_input("query", query)
    _build.check_cuda_input("source", source)
    B, M, _ = query.shape
    N = source.shape[1]
    if source.shape[0] != B or source.device != query.device:
        raise ValueError("query and source must share batch size and device")
    if N < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got {N}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid height 65535")
    idx = torch.empty((B, M, 3), dtype=torch.int32, device=query.device)
    if B * M == 0:
        return idx
    _build.launch("three_nn", "nesie_three_nn", query.data_ptr(),
                  source.data_ptr(), B, M, N, queries_per_thread,
                  idx.data_ptr(), device=query.device)
    return idx
