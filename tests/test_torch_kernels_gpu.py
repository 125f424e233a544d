"""The port's CUDA kernels against their plain PyTorch versions.

The tests marked ``gpu`` build the kernels with nvcc and run them on the
card; elsewhere they skip. The rest check, on any machine, that a kernel
wrapper refuses what the kernel does not take instead of falling back.
This file imports no jax, so the card's machine can run it:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``.
"""
import numpy as np
import pytest
import torch

from nesie_tpu_torch.ops import _build
from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
from nesie_tpu_torch.ops.fps import fps_cuda, fps_ref
from nesie_tpu_torch.ops.three_nn import three_nn_cuda, three_nn_ref

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _uniform(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.uniform(size=shape) * scale).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", [(2, 1000, 128), (3, 4097, 500), (1, 64, 64)])
def test_fps_kernel_matches_plain(cuda, b, n, m):
    xyz = _uniform((b, n, 3), seed=n).to(cuda)
    before = _build.launch_counts()["fps"]
    got = fps_cuda(xyz, m)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fps"] == before + 1
    assert torch.equal(got, fps_ref(xyz, m))


@pytest.mark.gpu
def test_fps_kernel_lattice_ties(cuda):
    g = torch.arange(8.0)
    xyz = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
    xyz = xyz.reshape(1, -1, 3).contiguous().to(cuda)
    assert torch.equal(fps_cuda(xyz, 200), fps_ref(xyz, 200))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "dup_centers", "no_neighbour",
                                  "min_radius"])
def test_ball_query_kernel_matches_plain(cuda, case):
    xyz = _uniform((2, 3001, 3), seed=1).to(cuda)
    radius, k, min_r = 0.2, 16, 0.0
    centers = _uniform((2, 301, 3), seed=2).to(cuda)
    if case == "dup_centers":
        centers = xyz[:, :301].contiguous()
    elif case == "no_neighbour":
        centers = centers + 5.0
    elif case == "min_radius":
        min_r = 0.1
    got = ball_query_cuda(xyz, centers, radius, k, min_r)
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_ref(xyz, centers, radius, k, min_r))
    if case == "no_neighbour":
        assert (got == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "duplicate_sources"])
def test_three_nn_kernel_matches_plain(cuda, case):
    q = _uniform((2, 777, 3), seed=3).to(cuda)
    s = _uniform((2, 2050, 3), seed=4).to(cuda)  # two smem tiles and a bit
    if case == "duplicate_sources":
        s[:, 1025:] = s[:, :1025]
        q[:, :100] = s[:, :100]
    got = three_nn_cuda(q, s)
    torch.cuda.synchronize()
    assert torch.equal(got, three_nn_ref(q, s))


@pytest.mark.parametrize("kernel", ["fps", "ball_query", "three_nn"])
def test_wrappers_refuse_cpu_tensors(kernel):
    """A kernel wrapper never runs the plain version in its place."""
    x = _uniform((1, 64, 3), seed=5)
    call = {
        "fps": lambda: fps_cuda(x, 8),
        "ball_query": lambda: ball_query_cuda(x, x, 0.2, 4),
        "three_nn": lambda: three_nn_cuda(x, x),
    }[kernel]
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.gpu
def test_wrappers_refuse_bad_layouts(cuda):
    x = _uniform((1, 64, 3), seed=6).to(cuda)
    with pytest.raises(TypeError):
        fps_cuda(x.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ball_query_cuda(_uniform((1, 128, 3), seed=7).to(cuda)[:, ::2], x,
                        0.2, 4)
    with pytest.raises(ValueError):
        three_nn_cuda(x[..., :2].contiguous(), x)
