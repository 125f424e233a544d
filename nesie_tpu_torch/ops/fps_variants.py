"""The FPS lab's step variants: the wrapper of ``csrc/fps_variants.cu``
and the variants' plain PyTorch versions.

Counterpart of the TPU FPS lab: the step bodies of ``tools/fps_lab.py``
(``LAB_VARIANTS``) and ``tools/fps_experiments.py``
(``EXPERIMENT_VARIANTS``). Each variant computes exactly ``fps_ref``'s
D-FPS on the shipped FPS's on-chip frame (``csrc/fps_onchip.cu``: a row on
one CTA or across a cluster, distances in registers, coordinates in
shared memory) and differs from the shipped step by one idea (the head
note of ``csrc/fps_variants.cu`` says how):

* select ``max_then_min`` (S2): the max value, then the lowest index
  holding it, two exchanges a step; ``refetch`` (S3): any index of the
  max, its value read back by index from the distances (kept in shared
  memory), then the lowest index holding it; ``bitcast`` (S4): the
  shipped step, one exchange of (value bits, index);
* fetch ``merged`` (F2): the winner's coordinates ride in the candidate;
  ``aos3`` (F1): one load of the winner from the (B, N, 3) input;
  ``blocked`` (F3): one read of the winner from its owner's shared
  memory (DSMEM across a cluster);
* rows 2 (``v3``): two rows on one CTA or cluster share each exchange;
  unroll 4 (``v5``): the step loop unrolled.

A launch takes the plan of the shipped FPS for the same shape
(``fps_variant_plan``). The kernels live in the lab's own library
(``_build.LIBRARIES["fps_lab"]``), built the first time a variant is
launched. Nothing on the eval or training path calls this module: their
FPS is ``ops.pointops.furthest_point_sample``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nesie_tpu_torch import utils

from . import _build
from .fps import _check_samples, _exchange_id, fps_onchip_plan, fps_steps


class Variant(NamedTuple):
    select: str   # "max_then_min", "refetch" or "bitcast"
    fetch: str    # "aos3", "merged" or "blocked"
    rows: int     # rows a CTA or cluster carries
    unroll: int   # unroll factor of the step loop
    replaces: str  # the TPU step body, file:line (tie rule's line after)


LAB_VARIANTS = {
    "v2_merged": Variant("max_then_min", "merged", 1, 1,
                         "tools/fps_lab.py:45"),
    "v3_blocked": Variant("max_then_min", "blocked", 1, 1,
                          "tools/fps_lab.py:112"),
    "v4_blocked2": Variant("refetch", "blocked", 1, 1, "tools/fps_lab.py:150"),
}
EXPERIMENT_VARIANTS = {
    "v1": Variant("max_then_min", "aos3", 1, 1,
                  "tools/fps_experiments.py:86,57"),
    "v2": Variant("bitcast", "aos3", 1, 1, "tools/fps_experiments.py:86,67"),
    "v3": Variant("bitcast", "aos3", 2, 1, "tools/fps_experiments.py:106,67"),
    "v4": Variant("bitcast", "merged", 1, 1,
                  "tools/fps_experiments.py:134,67"),
    "v5": Variant("bitcast", "merged", 1, 4,
                  "tools/fps_experiments.py:134,67"),
}
# the order is the kernel's variant id (the switch in csrc/fps_variants.cu)
VARIANTS = {**LAB_VARIANTS, **EXPERIMENT_VARIANTS}
_IDS = {name: i for i, name in enumerate(VARIANTS)}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nesie_fps_variant": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                                     _P]}
_lib = None  # the lab's library, once loaded


def library():
    """The lab's kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = _build.load("fps_lab", _SIGNATURES)
    return _lib


def reset_launch_counts() -> None:
    utils.reset_counts("fps_variant.")


def launch_counts() -> dict:
    """Launches of each variant (counts ``fps_variant.<name>``); their sum
    is ``_build``'s ``fps_variant`` count."""
    done = utils.counts("fps_variant.")
    return {name: done.get(f"fps_variant.{name}", 0) for name in VARIANTS}


def fps_variant_plan(name: str, batch: int, n: int) -> dict:
    """The plan a launch of variant ``name`` takes for (batch, n):
    ``fps_onchip_plan(batch, n)`` itself, the shipped FPS's plan, for a
    one-row variant. ``v3`` carries two rows on a CTA or cluster, so it
    takes the plan of ``ceil(batch / 2)`` rows of ``2 n`` points (the cost
    model with the points an SM holds counted for both rows): its cluster,
    threads and exchange, and half its points a thread, up to a multiple
    of 4, for each row. Needs the card; raises where no plan fits."""
    if VARIANTS[name].rows == 1:
        return fps_onchip_plan(batch, n)
    pair = fps_onchip_plan(-(-batch // 2), 2 * n)
    return dict(cluster=pair["cluster"], threads=pair["threads"],
                points_per_thread=-(-pair["points_per_thread"] // 8) * 4,
                resident_clusters=pair["resident_clusters"],
                exchange=pair["exchange"], rows=2)


def plan_tag(plan: dict) -> str:
    """A plan as a label: C=cluster, T=threads, P=points a thread (of each
    row for two rows), the exchange."""
    rows = " x2 rows" if plan.get("rows", 1) == 2 else ""
    return (f"C={plan['cluster']} T={plan['threads']} "
            f"P={plan['points_per_thread']} {plan['exchange']}{rows}")


def fps_variant_cuda(xyz: torch.Tensor, num_samples: int,
                     name: str) -> torch.Tensor:
    """Launch variant ``name`` of ``csrc/fps_variants.cu``: (B, N, 3)
    float32 on the card -> (B, M) int32, with ``fps_variant_plan``'s plan.
    A plan the kernel was not instantiated for raises."""
    _build.check_cuda_input("xyz", xyz)
    B, N, _ = xyz.shape
    _check_samples(N, num_samples)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    plan = fps_variant_plan(name, B, N)
    _build.launch("fps_variant", "nesie_fps_variant", _IDS[name],
                  xyz.data_ptr(), B, N, num_samples, plan["cluster"],
                  plan["threads"], plan["points_per_thread"],
                  _exchange_id(plan["exchange"]), out.data_ptr(),
                  device=xyz.device, lib=library())
    utils.count(f"fps_variant.{name}")
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
    variant's select rule. The fetch, the rows a CTA carries and the
    unroll change no value, so they are not mirrored."""
    return fps_steps(xyz, num_samples, _SELECTS[VARIANTS[name].select])
