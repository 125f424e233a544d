"""The FPS lab's step variants: the wrapper of ``csrc/fps_variants.cu``
and the variants' plain PyTorch versions.

Counterpart of the TPU FPS lab: the step bodies of ``tools/fps_lab.py``
(``LAB_VARIANTS``) and ``tools/fps_experiments.py``
(``EXPERIMENT_VARIANTS``). Each variant computes exactly ``fps_ref``'s
D-FPS; they differ in how a step selects the next index and fetches its
coordinates (the head note of ``csrc/fps_variants.cu`` says how):

* select ``max_then_min`` (S2): the max value, then the lowest index
  holding it; ``refetch`` (S3): an argmax, its value read back by index,
  then the lowest index holding it; ``bitcast`` (S4): the max of the
  float32 bits as int32, then the lowest index holding those bits;
* fetch ``aos3`` (F1) reads the (B, N, 3) input; ``merged4`` (F2) a
  (B, N, 4) padded copy, one float4 a point; ``soa`` (F3) a (B, 3, N)
  copy.

Nothing on the eval or training path calls this module: their FPS is
``ops.pointops.furthest_point_sample``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .fps import _check_samples, fps_steps


class Variant(NamedTuple):
    select: str   # "max_then_min", "refetch" or "bitcast"
    fetch: str    # "aos3", "merged4" or "soa"
    rows: int     # rows a block carries
    unroll: int   # unroll factor of the step loop
    replaces: str  # the TPU step body, file:line (tie rule's line after)


LAB_VARIANTS = {
    "v2_merged": Variant("max_then_min", "merged4", 1, 1,
                         "tools/fps_lab.py:45"),
    "v3_blocked": Variant("max_then_min", "soa", 1, 1,
                          "tools/fps_lab.py:112"),
    "v4_blocked2": Variant("refetch", "soa", 1, 1, "tools/fps_lab.py:150"),
}
EXPERIMENT_VARIANTS = {
    "v1": Variant("max_then_min", "aos3", 1, 1,
                  "tools/fps_experiments.py:86,57"),
    "v2": Variant("bitcast", "aos3", 1, 1, "tools/fps_experiments.py:86,67"),
    "v3": Variant("bitcast", "aos3", 2, 1, "tools/fps_experiments.py:106,67"),
    "v4": Variant("bitcast", "merged4", 1, 1,
                  "tools/fps_experiments.py:134,67"),
    "v5": Variant("bitcast", "merged4", 1, 4,
                  "tools/fps_experiments.py:134,67"),
}
# the order is the kernel's variant id (the switch in csrc/fps_variants.cu)
VARIANTS = {**LAB_VARIANTS, **EXPERIMENT_VARIANTS}
_IDS = {name: i for i, name in enumerate(VARIANTS)}
_LAUNCHES = dict.fromkeys(VARIANTS, 0)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict:
    """Launches of each variant; their sum is ``_build``'s
    ``fps_variant`` count."""
    return dict(_LAUNCHES)


def merged4(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N, 4), the fourth coordinate 0: one 16-byte load a
    point."""
    return F.pad(xyz, (0, 1)).contiguous()


def soa(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, 3, N)."""
    return xyz.transpose(1, 2).contiguous()


_LAYOUTS = {"aos3": None, "merged4": merged4, "soa": soa}


def fps_variant_cuda(xyz: torch.Tensor, num_samples: int,
                     name: str) -> torch.Tensor:
    """Launch variant ``name`` of ``csrc/fps_variants.cu``: (B, N, 3)
    float32 on the card -> (B, M) int32. Makes the variant's layout copy
    first (F2, F3)."""
    variant = VARIANTS[name]
    _build.check_cuda_input("xyz", xyz)
    B, N, _ = xyz.shape
    _check_samples(N, num_samples)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    layout = _LAYOUTS[variant.fetch]
    aux = layout(xyz) if layout else xyz
    dist = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    _build.launch("fps_variant", "nesie_fps_variant", _IDS[name],
                  xyz.data_ptr(), aux.data_ptr(), B, N, num_samples,
                  dist.data_ptr(), out.data_ptr(), device=xyz.device)
    _LAUNCHES[name] += 1
    return out


def _first_of(equal: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, 1) the lowest index that is True."""
    n = equal.shape[1]
    iota = torch.arange(n, device=equal.device)
    return torch.where(equal, iota, n).amin(dim=1, keepdim=True)


def _max_then_min(dist):
    return _first_of(dist == dist.amax(dim=1, keepdim=True))


def _refetch(dist):
    return _first_of(dist == dist.gather(1, dist.argmax(dim=1, keepdim=True)))


def _bitcast(dist):
    bits = dist.view(torch.int32)
    return _first_of(bits == bits.amax(dim=1, keepdim=True))


_SELECTS = {"max_then_min": _max_then_min, "refetch": _refetch,
            "bitcast": _bitcast}


def fps_variant_ref(xyz: torch.Tensor, num_samples: int,
                    name: str) -> torch.Tensor:
    """Plain version of variant ``name``: ``fps_ref``'s loop with the
    variant's select rule. The fetch form and the rows a block carries
    change no value, so they are not mirrored."""
    return fps_steps(xyz, num_samples, _SELECTS[VARIANTS[name].select])
