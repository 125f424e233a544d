"""CUDA graphs of a forward, split at its FPS launches.

``FpsSplitGraph.capture(fn)`` records the device work of ``fn()`` as a
chain of CUDA graphs in one memory pool, cut at each call of
``ops.pointops.furthest_point_sample`` on a CUDA tensor: that call ends
the graph being captured, runs FPS eagerly (``pointops.onchip_fps``, its
span and its launch through ``pointops.fps_onchip_cuda``), and opens the
next graph, which reads the FPS result where that call left it.
``replay()`` runs the chain again: a graph, FPS copied into that same
tensor, the next graph, and so on. So each FPS stays a launch of its own,
with its span and its launch count at every replay, and each graph adds
the launch counts (``launch.<kernel>``) made while it was captured.

Capture runs on a side stream with the spans suspended, so that no span's
CUDA event enters a graph. Each graph is replayed as soon as it is
captured: the FPS after it samples real coordinates, and ``capture``
returns ``fn()``'s real output, in tensors that every replay rewrites.
Capture leaves the launch counts as it found them. The graphs read the
tensors that ``fn`` read, in place: its inputs, which the caller refills
before a replay, and a module's parameters and buffers
(``load_state_dict`` copies into them). A capture that fails is closed,
and its error raised.
"""
from __future__ import annotations

import torch

from nesie_tpu_torch import utils
from nesie_tpu_torch.ops import _build, pointops


class FpsSplitGraph:
    """One forward's chain of CUDA graphs and eager FPS calls on
    ``device``. Chains that share ``pool`` (another chain's ``pool``) must
    be replayed in the order they were captured."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.pool = pool
        self.steps: list = []  # (graph, its launch counts) or (xyz, m, out)
        self._graph = None
        self._counted = None

    def capture(self, fn):
        """Capture ``fn()`` (its work on this card's current stream) and
        return its output."""
        with torch.cuda.device(self.device), utils.spans_suspended():
            before = _build.launch_counts()
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            pointops._CAPTURE = self
            try:
                with torch.cuda.stream(side):
                    try:
                        self._begin()
                        out = fn()
                        self._end()
                    except BaseException:
                        self._abort()
                        raise
            finally:
                pointops._CAPTURE = None
                main.wait_stream(side)
                for name, n in _build.launch_counts().items():
                    if n != before[name]:
                        utils.count(f"launch.{name}", before[name] - n)
        return out

    def fps(self, xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
        """``furthest_point_sample``'s CUDA path while this chain captures:
        end the graph, sample eagerly, open the next graph."""
        self._end()
        out = pointops.onchip_fps(xyz, num_samples)
        self.steps.append((xyz, num_samples, out))
        self._begin()
        return out

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            for step in self.steps:
                if isinstance(step[0], torch.cuda.CUDAGraph):
                    step[0].replay()
                    for name, n in step[1]:
                        utils.count(name, n)
                else:
                    xyz, num_samples, out = step
                    out.copy_(pointops.onchip_fps(xyz, num_samples))

    def _begin(self) -> None:
        self._counted = _build.launch_counts()
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool)

    def _end(self) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        graph.replay()
        made = [(f"launch.{k}", n - self._counted[k])
                for k, n in _build.launch_counts().items()
                if n != self._counted[k]]
        self.steps.append((graph, made))

    def _abort(self) -> None:
        graph, self._graph = self._graph, None
        self.steps.clear()
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # an invalidated capture ends all the same
