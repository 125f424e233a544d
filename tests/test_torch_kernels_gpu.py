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

from nesie_tpu_torch.core.boxes import box_corners, corners_minmax
from nesie_tpu_torch.ops import _build
from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
from nesie_tpu_torch.ops.fps import (
    fps_onchip_cuda,
    fps_onchip_plan,
    fps_ref,
)
from nesie_tpu_torch.ops import fps_variants
from nesie_tpu_torch.ops.fps_variants import (
    VARIANTS,
    fps_variant_cuda,
    fps_variant_plan,
)
from nesie_tpu_torch.ops.three_nn import three_nn_cuda, three_nn_ref
from nesie_tpu_torch.ops.decode_nms import (
    MAX_BOXES,
    box_minmax,
    keep_mask_cuda,
    keep_mask_ref,
)

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
def test_fps_dispatch_by_batch(cuda):
    from nesie_tpu_torch.ops import furthest_point_sample

    xyz = _uniform((17, 3000, 3), seed=12).to(cuda)
    counts = _build.launch_counts()
    furthest_point_sample(xyz[:16], 64)
    furthest_point_sample(xyz, 64)
    after = _build.launch_counts()
    assert after["fps_onchip_small"] == counts["fps_onchip_small"] + 1
    assert after["fps_onchip"] == counts["fps_onchip"] + 1


def _onchip_cases():
    """(B, N, M, cluster): the eval forward's SA1 and a ragged B > 16 row
    under the plan's own choice, then every cluster size at a ragged N
    (5003: a multiple of no cluster size, of no thread count and of 4)."""
    return ([(32, 40000, 2048, 0), (17, 40001, 2048, 0)]
            + [(17, 5003, 700, c) for c in range(1, 9)])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,cluster", _onchip_cases())
def test_fps_onchip_kernel_matches_plain(cuda, b, n, m, cluster):
    xyz = _uniform((b, n, 3), seed=n + b).to(cuda)  # one oracle per shape
    plan = fps_onchip_plan(b, n, cluster)
    if cluster:
        assert plan["cluster"] == cluster
    assert plan["points_per_thread"] > 0  # these rows fit on chip
    before = _build.launch_counts()["fps_onchip"]
    got = fps_onchip_cuda(xyz, m, cluster_size=cluster)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fps_onchip"] == before + 1
    assert torch.equal(got, _fps_oracle(xyz, m))


@pytest.mark.gpu
@pytest.mark.parametrize("threads", [128, 256, 1024])
def test_fps_onchip_thread_counts(cuda, threads):
    """Fewer threads hold more points each in registers."""
    xyz = _uniform((17, 12000, 3), seed=threads).to(cuda)
    plan = fps_onchip_plan(17, 12000, 2, threads)
    assert 0 < plan["threads"] <= threads and plan["points_per_thread"] > 0
    got = fps_onchip_cuda(xyz, 300, cluster_size=2, threads=threads)
    assert torch.equal(got, fps_ref(xyz, 300))


@pytest.mark.gpu
@pytest.mark.parametrize("n,cluster,scratch", [(120000, 4, False),
                                               (2000000, 1, True)])
def test_fps_onchip_streaming_rows(cuda, n, cluster, scratch):
    """Slices past the register layout read their coordinates from L2,
    with their distances in shared memory or, past that, in scratch."""
    xyz = _uniform((17, n, 3), seed=13).to(cuda)
    plan = fps_onchip_plan(17, n, cluster)
    assert plan["points_per_thread"] == 0 and plan["scratch"] == scratch
    got = fps_onchip_cuda(xyz, 40, cluster_size=cluster)
    assert torch.equal(got, fps_ref(xyz, 40))


@pytest.mark.gpu
@pytest.mark.parametrize("b,cluster", [(17, 0), (32, 0), (17, 3), (32, 8)])
def test_fps_onchip_lattice_ties(cuda, b, cluster):
    g = torch.arange(20.0)
    xyz = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
    xyz = xyz.reshape(1, -1, 3).expand(b, -1, -1).contiguous().to(cuda)
    got = fps_onchip_cuda(xyz, 500, cluster_size=cluster)
    want = fps_ref(xyz[:1], 500).expand(b, -1)
    assert torch.equal(got, want)
    assert torch.equal(got, fps_ref(xyz, 500))


# every exchange a variant's plan takes: one CTA at 1000 and 1024 points
# (and the lattice's 512), a cluster of 2 at 4099 (v3: of 3), the
# clusters of 8 and 32 x 40000 (mailbox; v3 mailbox_cta), an odd B at a
# cluster shape (mailbox_cta, v3's last cluster one row)
_VARIANT_SHAPES = [(1, 1000, 1), (3, 1000, 1000), (7, 4099, 256),
                   (8, 40000, 2048), (1, 1024, 1024), (32, 40000, 2048),
                   (7, 40000, 512)]
_WANT = {}


def _fps_oracle(xyz, m, cloud="uniform"):
    key = (tuple(xyz.shape), m, cloud)
    if key not in _WANT:  # one fps_ref per shape for all eight variants
        _WANT[key] = fps_ref(xyz, m)
    return _WANT[key]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", _VARIANT_SHAPES)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_fps_variant_kernel_matches_plain(cuda, name, b, n, m):
    """M = N at (3, 1000); odd B at 1, 3 and 7 leaves v3's last block one
    row; N = 4099 is a multiple of no block size."""
    xyz = _uniform((b, n, 3), seed=n + b).to(cuda)
    before = _build.launch_counts()["fps_variant"]
    before_v = fps_variants.launch_counts()[name]
    got = fps_variant_cuda(xyz, m, name)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fps_variant"] == before + 1
    assert fps_variants.launch_counts()[name] == before_v + 1
    assert torch.equal(got, _fps_oracle(xyz, m))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VARIANTS))
def test_fps_variant_kernel_lattice_ties(cuda, name):
    g = torch.arange(8.0)
    xyz = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
    xyz = xyz.reshape(1, -1, 3).contiguous().to(cuda)
    assert torch.equal(fps_variant_cuda(xyz, 200, name), fps_ref(xyz, 200))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VARIANTS))
def test_fps_variant_kernel_ties_across_a_cluster(cuda, name):
    """40 distinct points tiled to 8 x 40000: after 40 steps every distance
    is 0, a tie that spans every CTA of the row's cluster."""
    base = np.random.default_rng(1).uniform(size=(8, 40, 3))
    xyz = torch.from_numpy(np.ascontiguousarray(
        np.tile(base, (1, 1000, 1)), dtype=np.float32)).to(cuda)
    assert fps_variant_plan(name, 8, 40000)["cluster"] > 1
    assert torch.equal(fps_variant_cuda(xyz, 2048, name),
                       _fps_oracle(xyz, 2048, "tied"))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(3, 600), (1, 512), (7, 4099),
                                 (8, 40000), (32, 40000), (7, 40000)])
def test_fps_variant_plan_is_the_shipped_plan(cuda, b, n):
    """Every one-row variant takes fps_onchip_plan's plan; v3 the plan of
    ceil(B / 2) rows of 2N points with half its points a thread."""
    for name in VARIANTS:
        if name != "v3":
            assert fps_variant_plan(name, b, n) == fps_onchip_plan(b, n)
    pair = fps_onchip_plan(-(-b // 2), 2 * n)
    plan = fps_variant_plan("v3", b, n)
    assert (plan["cluster"], plan["threads"], plan["exchange"]) == (
        pair["cluster"], pair["threads"], pair["exchange"])
    assert plan["points_per_thread"] == -(-pair["points_per_thread"] // 8) * 4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v2_merged", "v3", "v4"])
def test_fps_variant_plan_outside_the_instantiated_set_raises(
        cuda, monkeypatch, name):
    """No fallback: a plan the kernel was not built for, or one that does
    not hold the row, fails the launch and counts nothing."""
    xyz = _uniform((2, 1000, 3), seed=9).to(cuda)
    plan = fps_variant_plan(name, 2, 1000)
    before = _build.launch_counts()["fps_variant"]
    for bad in (dict(plan, points_per_thread=12),  # no such instantiation
                dict(plan, exchange="barrier"),
                dict(plan, threads=32),  # 32 x 8 points < 1000
                dict(plan, cluster=2)):  # the local exchange is one CTA's
        monkeypatch.setattr(fps_variants, "fps_variant_plan",
                            lambda *args, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            fps_variant_cuda(xyz, 64, name)
    assert _build.launch_counts()["fps_variant"] == before


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


# centers per query: 2 x 300 take the warp-per-center kernel, 2 x 4500
# the shared-memory tile kernel (the switch is at 64 centers an SM)
_BQ_CENTERS = {"warp": 300, "tile": 4500}


def _bq_case(case, m, dev):
    """(xyz, centers, radius, K, min_radius) of one ball-query edge case
    with m centers a row."""
    xyz = _uniform((2, 2500, 3), seed=21)
    centers = _uniform((2, m, 3), seed=22)
    on_points = torch.arange(m) % 2500  # centers on source points
    radius, k, min_r = 0.15, 32, 0.0
    if case == "ragged_tiles":  # N past a multiple of the 1024-point tile,
        xyz = _uniform((2, 3077, 3), seed=23)  # M of no CTA size
        centers = _uniform((2, m + 33, 3), seed=24)
    elif case == "few_hits":  # fewer hits than K almost everywhere
        radius, k = 0.05, 64
    elif case == "duplicate_sources":  # d2 == 0 hits, in index order
        xyz[:, 1200:2400] = xyz[:, :1200]
        centers = xyz[:, on_points]
        radius = 0.02
    elif case == "min_radius":
        radius, min_r = 0.3, 0.2
    elif case == "zero_radius":  # only d2 <= 0 qualifies
        centers = xyz[:, (on_points + 100) % 2500]
        radius = 0.0
    elif case == "no_neighbour":
        centers = centers + 5.0
    elif case == "saturated":  # every center full after a few points
        radius, k = 2.0, 16
    return (xyz.to(dev), centers.contiguous().to(dev), radius, k, min_r)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["tile", "warp"])
@pytest.mark.parametrize("case", ["ragged_tiles", "few_hits",
                                  "duplicate_sources", "min_radius",
                                  "zero_radius", "no_neighbour", "saturated"])
def test_ball_query_kernel_edge_cases(cuda, case, path):
    xyz, centers, radius, k, min_r = _bq_case(case, _BQ_CENTERS[path], cuda)
    before = _build.launch_counts()["ball_query"]
    got = ball_query_cuda(xyz, centers, radius, k, min_r)
    torch.cuda.synchronize()
    assert _build.launch_counts()["ball_query"] == before + 1
    assert torch.equal(got, ball_query_ref(xyz, centers, radius, k, min_r))
    if case == "no_neighbour":
        assert (got == 0).all()


@pytest.mark.gpu
def test_ball_query_kernel_sa1_shape(cuda):
    """SA1 at B=2: 40000 points -> 2048 centers, r 0.2, K 64. 4096
    centers take the warp-per-center path; chip_smoke.py holds the tile
    path to the plain version at SA1 for B=32 and 12."""
    xyz = _uniform((2, 40000, 3), seed=25, scale=4.0).to(cuda)
    centers = xyz[:, fps_onchip_cuda(xyz, 2048)[0].long()].contiguous()
    got = ball_query_cuda(xyz, centers, 0.2, 64)
    assert torch.equal(got, ball_query_ref(xyz, centers, 0.2, 64))


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


def _three_nn_case(case):
    """(query, source) of one three-NN edge case."""
    q, s = _uniform((2, 777, 3), seed=50), _uniform((2, 1021, 3), seed=51)
    if case == "long_row":  # past the resident row: three tiles
        s = _uniform((2, 5003, 3), seed=52)
    elif case == "duplicate_sources":  # equal distances: lower index first
        s[:, 500:1000] = s[:, :500]
        q[:, :300] = s[:, 600:900]
    elif case == "equidistant":  # integer lattice, queries at cell centres
        g = torch.arange(10.0)
        s = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
        s = s.reshape(1, -1, 3).expand(2, -1, -1).contiguous()
        q = torch.floor(q * 9.0) + 0.5
    elif case == "one_query":
        q = q[:, :1].contiguous()
    return q, s


@pytest.mark.gpu
@pytest.mark.parametrize("qpt", [1, 2, 4])
@pytest.mark.parametrize("case", ["ragged_row", "long_row",
                                  "duplicate_sources", "equidistant",
                                  "one_query"])
def test_three_nn_queries_per_thread(cuda, case, qpt):
    """Q = 1, 2, 4 queries a thread; N = 1021 (no multiple of 4: NaN
    padding), 5003 (tiles past the resident row), duplicate and
    equidistant sources (ties to the lower index), M = 1."""
    from nesie_tpu_torch.ops.three_nn import three_nn_plan

    q, s = (t.to(cuda) for t in _three_nn_case(case))
    assert three_nn_plan(2, q.shape[1], qpt)["queries_per_thread"] == qpt
    before = _build.launch_counts()["three_nn"]
    got = three_nn_cuda(q, s, qpt)
    torch.cuda.synchronize()
    assert _build.launch_counts()["three_nn"] == before + 1
    assert torch.equal(got, three_nn_ref(q, s))


@pytest.mark.gpu
def test_three_nn_plan(cuda):
    """The side grid takes 4 queries a thread, a request's FP queries 1;
    a request the kernel does not take raises."""
    from nesie_tpu_torch.ops.three_nn import three_nn_plan

    assert three_nn_plan(32, 24576)["queries_per_thread"] == 4
    assert three_nn_plan(1, 1024)["queries_per_thread"] == 1
    with pytest.raises(RuntimeError, match="no launch plan"):
        three_nn_plan(1, 1024, 3)


@pytest.mark.parametrize("kernel", ["fps_onchip", "fps_onchip_timed",
                                    "ball_query", "three_nn",
                                    "fps_variant"])
def test_wrappers_refuse_cpu_tensors(kernel):
    """A kernel wrapper never runs the plain version in its place."""
    from nesie_tpu_torch.ops.fps import fps_onchip_timed

    x = _uniform((1, 64, 3), seed=5)
    call = {
        "fps_onchip": lambda: fps_onchip_cuda(x, 8),
        "fps_onchip_timed": lambda: fps_onchip_timed(x, 8),
        "ball_query": lambda: ball_query_cuda(x, x, 0.2, 4),
        "three_nn": lambda: three_nn_cuda(x, x),
        "fps_variant": lambda: fps_variant_cuda(x, 8, "v1"),
    }[kernel]
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize(
    "edited", sorted(p.name for p in _build._CSRC.iterdir()))
def test_an_edit_rebuilds_only_the_libraries_it_reaches(
        tmp_path, monkeypatch, edited):
    """Each library is named by its own sources, the headers and the
    flags: an edit to a source moves its library's path alone (the
    program's stays where it was when the lab's fps_variants.cu
    changes), an edit to a header moves both."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build._CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {lib: _build.library_path(lib) for lib in _build.LIBRARIES}
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    for lib, sources in _build.LIBRARIES.items():
        moved = edited in sources or edited.endswith(".cuh")
        assert (_build.library_path(lib) != before[lib]) == moved, lib


def test_each_source_is_in_one_library(monkeypatch):
    """Every csrc/*.cu is built into exactly one library; the program's
    is the five kernels its paths launch. Calls on CPU tensors, the
    lab's included, build neither library."""
    from nesie_tpu_torch.ops import pointops

    cu = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    owned = [s for srcs in _build.LIBRARIES.values() for s in srcs]
    assert sorted(owned) == cu
    assert set(_build.LIBRARIES["kernels"]) == {
        "fps_onchip.cu", "ball_query.cu", "three_nn.cu", "decode_nms.cu",
        "sa_mlp.cu"}
    assert _build.LIBRARIES["fps_lab"] == ("fps_variants.cu",)
    built = []
    monkeypatch.setattr(_build, "build", lambda *a, **k: built.append((a, k)))
    x = _uniform((2, 64, 3), seed=8)
    idx = pointops.furthest_point_sample(x, 16)
    pointops.ball_query(x, pointops.gather_points(x, idx), 0.3, 4)
    pointops.three_nn(x[:, :8].contiguous(), x)
    for name in VARIANTS:
        assert torch.equal(fps_variants.fps_variant_ref(x, 16, name), idx)
    with pytest.raises(ValueError, match="CUDA"):
        fps_variant_cuda(x, 16, "v1")
    assert built == []
    assert _build._lib is None and fps_variants._lib is None


@pytest.mark.gpu
def test_wrappers_refuse_bad_layouts(cuda):
    x = _uniform((1, 64, 3), seed=6).to(cuda)
    with pytest.raises(TypeError):
        fps_onchip_cuda(x.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ball_query_cuda(_uniform((1, 128, 3), seed=7).to(cuda)[:, ::2], x,
                        0.2, 4)
    with pytest.raises(ValueError):
        three_nn_cuda(x[..., :2].contiguous(), x)


@pytest.mark.gpu
def test_fps_onchip_plan_raises_without_a_plan(cuda):
    """A cluster size the kernel does not take, the local exchange across
    a cluster, or a row the mailbox cannot hold on chip raises; nothing
    falls back."""
    with pytest.raises(RuntimeError, match="no launch plan"):
        fps_onchip_plan(32, 40000, 17)
    with pytest.raises(RuntimeError, match="no launch plan"):
        fps_onchip_plan(2, 40000, 2, 0, "local")
    with pytest.raises(RuntimeError, match="no launch plan"):
        fps_onchip_plan(32, 40000, 0, 0, "local")  # one CTA cannot hold it
    with pytest.raises(RuntimeError, match="no launch plan"):
        fps_onchip_plan(1, 2000000, 16, 0, "mailbox")
    with pytest.raises(ValueError, match="exchange"):
        fps_onchip_plan(1, 4000, 0, 0, "ring")
    with pytest.raises(RuntimeError, match="no launch plan"):
        fps_onchip_cuda(_uniform((17, 64, 3), seed=8).to(cuda), 8,
                        cluster_size=17)


@pytest.mark.gpu
@pytest.mark.parametrize("exchange", ["mailbox", "mailbox_cta"])
@pytest.mark.parametrize("cluster", list(range(1, 17)))
def test_fps_mailbox_cluster_sizes(cuda, cluster, exchange):
    """Every cluster size at a ragged N (5003: a multiple of no cluster
    size, of no thread count and of 4; at 16 the last slices are short)."""
    xyz = _uniform((3, 5003, 3), seed=30).to(cuda)
    plan = fps_onchip_plan(3, 5003, cluster, 0, exchange)
    assert plan["cluster"] == cluster and plan["exchange"] == exchange
    before = _build.launch_counts()["fps_onchip_small"]
    got = fps_onchip_cuda(xyz, 700, cluster, 0, exchange)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fps_onchip_small"] == before + 1
    assert torch.equal(got, _fps_oracle(xyz, 700))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,exchanges", [
    (1, 40000, 2048, ("mailbox", "mailbox_cta")),   # a Detector request
    (12, 40000, 2048, ("mailbox", "mailbox_cta")),  # semi-step SA1
    (12, 1024, 256, ("local",)),  # vote-mode aggregation: one CTA a row
    (2, 200000, 2048, ("mailbox", "mailbox_cta")),  # 200000-point rows
])
def test_fps_small_batches_match_plain(cuda, b, n, m, exchanges):
    """The plan's own choice at the B <= 16 shapes of the paths: rows on
    chip (the 200000-point rows at C=16), the exchange a mailbox, or one
    CTA for a short row."""
    xyz = _uniform((b, n, 3), seed=n + b, scale=5.0).to(cuda)
    plan = fps_onchip_plan(b, n)
    assert plan["exchange"] in exchanges and plan["points_per_thread"] > 0
    if exchanges == ("local",):
        assert plan["cluster"] == 1
    got = fps_onchip_cuda(xyz, m)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_ref(xyz, m))


@pytest.mark.gpu
@pytest.mark.parametrize("b,cluster,exchange", [
    (1, 0, "auto"), (12, 0, "auto"), (16, 0, "auto"), (12, 16, "mailbox"),
    (16, 3, "mailbox_cta"), (1, 1, "local")])
def test_fps_small_batches_lattice_ties(cuda, b, cluster, exchange):
    g = torch.arange(20.0)
    xyz = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
    xyz = xyz.reshape(1, -1, 3).expand(b, -1, -1).contiguous().to(cuda)
    got = fps_onchip_cuda(xyz, 500, cluster, 0, exchange)
    assert torch.equal(got, _fps_oracle(xyz[:1], 500).expand(b, -1))


@pytest.mark.gpu
def test_fps_exchanges_agree_at_b32(cuda):
    """The barrier and both mailbox exchanges give the same indices at the
    eval forward's 32 x 40000 -> 2048 (and fps_ref's)."""
    xyz = _uniform((32, 40000, 3), seed=40032).to(cuda)
    got = {x: fps_onchip_cuda(xyz, 2048, 7, 0, x)
           for x in ("barrier", "mailbox", "mailbox_cta")}
    assert torch.equal(got["barrier"], got["mailbox"])
    assert torch.equal(got["barrier"], got["mailbox_cta"])
    assert torch.equal(got["barrier"], _fps_oracle(xyz, 2048))


@pytest.mark.gpu
def test_fps_onchip_timed_matches_plain(cuda):
    """The instrumented kernel gives the same indices and stamps every
    phase of its first steps in order."""
    from nesie_tpu_torch.ops.fps import TIMED_STEPS, fps_onchip_timed

    xyz = _uniform((2, 40000, 3), seed=41).to(cuda)
    for exchange in ("barrier", "mailbox", "mailbox_cta"):
        got, stamps = fps_onchip_timed(xyz, 600, 8, 0, exchange)
        assert torch.equal(got, _fps_oracle(xyz, 600))
        s = stamps[:599].cpu()
        assert (s >= 0).all() and (s[:, 1:] >= s[:, :-1]).all()
        assert (stamps[599:TIMED_STEPS] == -1).all()


def test_fps_exchange_names():
    """An exchange is named; an unknown name raises before any build."""
    from nesie_tpu_torch.ops.fps import EXCHANGES, _exchange_id

    assert [_exchange_id(x) for x in EXCHANGES] == list(range(5))
    with pytest.raises(ValueError, match="exchange"):
        _exchange_id("ring")


def test_fps_step_split_phases():
    """The step split's medians: each phase from its stamps, the step
    from one start to the next, a phase a step did not stamp left out."""
    from nesie_tpu_torch.tools.fps_step_split import SKIP, split

    steps = SKIP + 5
    base = torch.arange(steps, dtype=torch.int64)[:, None] * 100
    stamps = base + torch.tensor([0, 10, 30, 35, 80, 90])
    got = split(stamps, steps)
    assert got == dict(point_loop=10.0, warp_reduce=20.0, push=5.0,
                       barrier_or_wait=45.0, cross_reduce=10.0, step=100.0)
    stamps[:, 3:5] = -1  # one warp: no push, no wait
    got = split(stamps, steps)
    assert got["push"] is None and got["barrier_or_wait"] is None
    assert got["point_loop"] == 10.0


@pytest.mark.gpu
@pytest.mark.parametrize("b", [32, 12])
@pytest.mark.parametrize("n,m", [(1024, 256), (2048, 1024), (1024, 512),
                                 (512, 256)])
def test_fps_option_shapes(cuda, b, n, m):
    """The real seed FPS's and SA2-SA4's shapes (``seed_fps_prefix_opt``
    and ``fps_prefix_opt`` off), at the eval batch and the semi step's."""
    xyz = _uniform((b, n, 3), seed=n + m, scale=4.0).to(cuda)
    assert torch.equal(fps_onchip_cuda(xyz, m), fps_ref(xyz, m))


@pytest.mark.gpu
def test_ball_query_spec_shape(cuda):
    """``sample_mod="spec"``'s aggregation: 32 x 1024 votes over the 1024
    seeds, r=0.3, K=16."""
    seeds = _uniform((32, 1024, 3), seed=11, scale=3.0).to(cuda)
    votes = (seeds + 0.05 * torch.randn(
        seeds.shape, generator=torch.Generator(cuda).manual_seed(1),
        device=cuda)).contiguous()
    assert torch.equal(ball_query_cuda(seeds, votes, 0.3, 16),
                       ball_query_ref(seeds, votes, 0.3, 16))


@pytest.mark.gpu
def test_launch_lands_on_the_tensors_card(cuda):
    """FPS, the ball query and three-NN on tensors of a card other than the
    current one (a data-parallel rank's situation) run on that card: the
    launch makes the tensors' card current for the call and takes its
    stream. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    other = torch.device("cuda", 1)
    xyz = _uniform((2, 3000, 3), seed=21, scale=2.0)
    query = _uniform((2, 700, 3), seed=22, scale=2.0)
    before = _build.launch_counts()
    idx = fps_onchip_cuda(xyz.to(other), 256)
    nbrs = ball_query_cuda(xyz.to(other), query.to(other), 0.3, 16)
    nn3 = three_nn_cuda(query.to(other), xyz.to(other))
    torch.cuda.synchronize(other)
    assert torch.cuda.current_device() == 0
    assert idx.device == nbrs.device == nn3.device == other
    assert torch.equal(idx.cpu(), fps_ref(xyz, 256))
    assert torch.equal(nbrs.cpu(), ball_query_ref(xyz, query, 0.3, 16))
    assert torch.equal(nn3.cpu(), three_nn_ref(query, xyz))
    after = _build.launch_counts()
    assert after["ball_query"] == before["ball_query"] + 1
    assert after["three_nn"] == before["three_nn"] + 1


def _blocks(b, n, seed):
    """``b`` segmentation blocks of ``n`` points: 1.5 m x 1.5 m, 3 m
    high."""
    return _uniform((b, n, 3), seed) * torch.tensor([1.5, 1.5, 3.0])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", [(16, 8192, 1024), (24, 8192, 1024),
                                   (8, 1024, 256)])
def test_fps_onchip_point_tail_shapes(cuda, b, n, m):
    """The segmentor's SA1 in training (16 blocks) and in slide_inference
    (24), and the VoteHead's seed / vote FPS (8 x 1024 seeds -> 256)."""
    xyz = _blocks(b, n, seed=60 + b).to(cuda)
    fps_onchip_plan(b, n)  # a plan exists
    got = fps_onchip_cuda(xyz, m)
    assert torch.equal(got, fps_ref(xyz, m))


@pytest.mark.gpu
def test_ball_query_segmentor_sa1_shape(cuda):
    """The segmentor's SA1: 1024 centres over 8192 points, r 0.1, K 32,
    B=16."""
    xyz = _blocks(16, 8192, seed=70).to(cuda)
    centers = torch.stack([x[fps_onchip_cuda(x[None], 1024)[0].long()]
                           for x in xyz]).contiguous()
    got = ball_query_cuda(xyz, centers, 0.1, 32)
    assert torch.equal(got, ball_query_ref(xyz, centers, 0.1, 32))


@pytest.mark.gpu
def test_three_nn_segmentor_final_fp_shape(cuda):
    """The segmentor's last FP: 8192 queries over 1024 sources, B=16."""
    q = _blocks(16, 8192, seed=71).to(cuda)
    s = q[:, :1024].contiguous()
    assert torch.equal(three_nn_cuda(q, s), three_nn_ref(q, s))


@pytest.mark.gpu
def test_points_sampler_and_knn_on_card(cuda):
    """``points_sampler``'s D-FPS on the card (K2, then K1 past 16 rows)
    equals ``fps_ref``; its F-FPS and ``FS`` modes and ``knn`` (plain
    PyTorch on both devices) equal the CPU: indices identical (the
    distances are summed channel by channel, one rounding per op on
    both devices)."""
    from nesie_tpu_torch.ops import pointops

    for b in (4, 17):
        xyz = _uniform((b, 4096, 3), seed=80 + b).to(cuda)
        got = pointops.points_sampler(xyz, None, 512, "D-FPS")
        assert torch.equal(got, fps_ref(xyz, 512))
    xyz = _uniform((4, 4096, 3), seed=90)
    feats = _uniform((4, 4096, 1), seed=91)
    for mode in ("F-FPS", "FS"):
        got = pointops.points_sampler(xyz.to(cuda), feats.to(cuda), 256, mode)
        assert torch.equal(got.cpu(), pointops.points_sampler(xyz, feats, 256,
                                                              mode))
    q = _uniform((4, 512, 3), seed=92)
    got = pointops.knn(16, xyz.to(cuda), q.to(cuda))
    assert torch.equal(got.cpu(), pointops.knn(16, xyz, q))


@pytest.mark.gpu
def test_voxel_stack_on_card(cuda):
    """The voxel stack is plain PyTorch on both devices and launches none
    of the port's kernels: ``voxelize`` identical to the CPU; a
    ``SparseBasicBlock`` (train mode) forward and backward with the same
    output sites, features within 1e-5 and weight gradients within 1e-4
    of their largest magnitude; ``roiaware_pool3d`` max identical and avg
    within 1e-5, their feature gradients within 1e-5, on the points
    farther than 1e-4 m from every voxel face of their rois
    (``chip_smoke.roi_off_faces``)."""
    import chip_smoke
    from nesie_tpu_torch.nn.sparse_block import SparseBasicBlock
    from nesie_tpu_torch.ops import roiaware_pool3d
    from nesie_tpu_torch.ops.spconv import SparseTensor
    from nesie_tpu_torch.ops.voxel import voxelize

    _build.reset_launch_counts()
    pts = _uniform((20000, 4), seed=100, scale=10.0)
    pts[:, 2] *= 0.2
    args = ((0.1, 0.1, 0.2), (0, 0, 0, 10, 10, 2), 5, 4000)
    want = voxelize(pts, *args)
    got = voxelize(pts.to(cuda), *args)
    for field in want._fields:
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field))

    torch.manual_seed(0)
    block = SparseBasicBlock(4, 16).train()
    block_gpu = SparseBasicBlock(4, 16).train().to(cuda)
    block_gpu.load_state_dict(block.state_dict())
    feats = want.voxels.sum(1) / want.num_points.clamp(min=1)[:, None]
    outs = []
    for dev, mod in ((torch.device("cpu"), block), (cuda, block_gpu)):
        x = SparseTensor(feats.to(dev), want.coords.to(dev),
                         want.valid.to(dev), (10, 100, 100))
        out = mod(x)
        (out.features ** 2).sum().backward()
        outs.append((out, {n: p.grad.cpu() for n, p in mod.named_parameters()}))
    (cpu_out, cpu_grad), (gpu_out, gpu_grad) = outs
    assert torch.equal(gpu_out.valid.cpu(), cpu_out.valid)
    assert torch.allclose(gpu_out.features.detach().cpu(),
                          cpu_out.features.detach(), atol=1e-5, rtol=0)
    for name, g in cpu_grad.items():
        assert torch.allclose(gpu_grad[name], g, rtol=0,
                              atol=1e-4 * float(g.abs().max())), name

    rng = np.random.default_rng(101)
    rois = torch.from_numpy(np.concatenate([
        rng.uniform(2, 8, (16, 2)), rng.uniform(0, 0.3, (16, 1)),
        rng.uniform(1, 3, (16, 3)), rng.uniform(-3, 3, (16, 1))],
        1).astype(np.float32))
    ok = chip_smoke.roi_off_faces(rois.numpy(), pts[:, :3].numpy(),
                                  (6, 6, 6), 1e-4)
    xyz = pts[torch.from_numpy(ok), :3].contiguous()
    f = _uniform((len(xyz), 8), seed=102)
    for mode in ("max", "avg"):
        res = []
        for dev in (torch.device("cpu"), cuda):
            fd = f.to(dev).detach().requires_grad_()
            pooled = roiaware_pool3d(rois.to(dev), xyz.to(dev), fd,
                                     (6, 6, 6), 32, mode)
            (pooled ** 2).sum().backward()
            res.append((pooled.detach().cpu(), fd.grad.cpu()))
        (p_cpu, g_cpu), (p_gpu, g_gpu) = res
        if mode == "max":
            assert torch.equal(p_gpu, p_cpu)
        assert torch.allclose(p_gpu, p_cpu, atol=1e-5, rtol=0)
        assert torch.allclose(g_gpu, g_cpu, atol=1e-5, rtol=0)
    torch.cuda.synchronize()
    assert not any(_build.launch_counts().values())


@pytest.mark.gpu
def test_mono3d_and_overfit_decode_on_card(cuda):
    """``flip_mono3d_outputs`` + ``merge_aug_mono3d_outputs`` identical on
    the card and the CPU; a tiny ``overfit_check`` run (20 steps) on the
    card, its head outputs decoded again on the CPU: keep lists and boxes
    identical, scores within 1e-6 (``chip_smoke.OVERFIT_SCORE_TOL``)."""
    from nesie_tpu_torch.eval import decode_and_nms
    from nesie_tpu_torch.nn.detector import init_weights_flax_
    from nesie_tpu_torch.nn.mono3d import (
        flip_mono3d_outputs,
        merge_aug_mono3d_outputs,
    )
    from nesie_tpu_torch.tools import overfit_check
    from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
    from nesie_tpu_torch.train.step import make_supervised_train_step

    gen = torch.Generator().manual_seed(0)
    views = [([torch.randn(2, 10, 24, 40, generator=gen)],
              [torch.rand(2, 9, 24, 40, generator=gen)],
              [torch.randn(2, 2, 24, 40, generator=gen)],
              [torch.randn(2, 1, 24, 40, generator=gen)]) for _ in range(2)]

    def tta(vs):
        cls, reg, extra = flip_mono3d_outputs(vs[1][0], vs[1][1],
                                              list(vs[1][2:]), pred_velo=True)
        return merge_aug_mono3d_outputs([vs[0], (cls, reg, *extra)])

    want = tta(views)
    got = tta([tuple([m.to(cuda) for m in g] for g in v) for v in views])
    for g, w in zip(got, want):
        assert torch.equal(g[0].cpu(), w[0])

    model = overfit_check.build_model(tiny=True)
    init_weights_flax_(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, make_lr_schedule(4e-3, 20), device=cuda)
    ds = overfit_check.make_dataset(4, 0)
    rng = np.random.default_rng(0)
    gen = torch.Generator(cuda).manual_seed(0)
    overfit_check.train_steps(state, make_supervised_train_step(), ds, rng,
                              20, 4, overfit_check.TINY_POINTS, cuda, gen)
    ev = overfit_check.evaluate_scenes(state, ds, rng, 4,
                                       overfit_check.TINY_POINTS, cuda, gen)
    assert ev["kept"] > 0
    for b in ev["batches"]:
        cpu = decode_and_nms({k: torch.from_numpy(v)
                              for k, v in b["raw"].items()},
                             torch.from_numpy(b["points"]))
        for k in ("selected", "bbox"):
            assert np.array_equal(cpu[k].numpy(), b["decoded"][k]), k
        for k in ("obj_scores", "sem_scores"):
            assert np.abs(cpu[k].numpy() - b["decoded"][k]).max() <= 1e-6, k


# ---- the eval decode's keep mask (csrc/decode_nms.cu) -------------------


def _decode_case(b, n, p, seed):
    """Clouds of n points x 4 channels in a 6 x 6 x 3 m room, p boxes a
    scene around points of the cloud (some empty, many overlapping), scores
    on a grid of 1/64 (many ties, some 0 and -0) and 4 classes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(b, n, 4)) * np.array([6.0, 6.0, 3.0, 1.0])
    around = pts[np.arange(b)[:, None], rng.integers(0, n, size=(b, p)), :3]
    bbox = np.concatenate([
        around + rng.normal(scale=0.3, size=(b, p, 3)),
        0.1 + 1.5 * rng.uniform(size=(b, p, 3)),
        rng.uniform(-np.pi, np.pi, size=(b, p, 1))], -1)
    obj = np.round(rng.uniform(size=(b, p)) * 64) / 64
    obj[rng.uniform(size=(b, p)) < 0.05] = -0.0
    t = [torch.from_numpy(x.astype(np.float32)) for x in (pts, bbox, obj)]
    return (*t, torch.from_numpy(rng.integers(0, 4, size=(b, p))))


def _crafted_case():
    """Three scenes of 10 boxes, with the keep mask they must give at
    score_thr -1 (selected = kept) and nms_thr 0.25, and the counts of
    the boxes that sit at the non-empty threshold."""
    g0, g1, g2 = (0.0, 0.0, 0.0), (10.0, 0.0, 0.0), (20.0, 0.0, 0.0)
    unit = (2.0, 2.0, 2.0)
    boxes = [  # centre, size, yaw, class, score
        (g0, unit, 0.0, 0, 0.9),     # 0 kept: 6 points
        (g1, unit, 0.0, 0, 0.95),    # 1 empty (exactly 5 points)
        (g0, unit, 0.0, 1, 0.8),     # 2 suppressed by 9 (class 1)
        (g0, unit, 0.0, 0, 0.9),     # 3 ties 0's score: later index, out
        ((10.0, 0.0, 0.25), unit, 0.0, 0, 0.5),  # 4 kept: 1 is empty
        (g2, unit, 0.0, 2, -0.0),    # 5 kept: -0 and +0 tie, index order
        (g2, unit, 0.0, 2, 0.0),     # 6 out
        ((50.0, 50.0, 50.0), unit, 0.0, 0, 0.99),  # 7 empty
        (g0, unit, np.pi / 4, 0, 0.7),  # 8 suppressed by 0 (IoU 0.5)
        (g0, unit, 0.0, 1, 0.85),    # 9 kept: overlaps 0, other class
    ]
    faces = [(1, 0, 0), (0, -1, 0),  # on box 0's xy faces: outside
             (0, 0, 1), (0, 0, -1),  # on its z faces: inside
             (0.5, 0.5, 0.5), (-0.5, 0.2, 0.9), (0.99, 0.99, -0.99),
             (0.1, 0.1, 0.1)]
    five = [(10, 0, 0), (10.5, 0, 0), (9.5, 0, 0), (10, 0.5, 0), (10, 0, 0.5),
            (10, 0, 1.2)]  # the last one in box 4 only
    six = [(20, 0, 0), (20.5, 0, 0), (19.5, 0, 0), (20, 0.5, 0), (20, 0, 0.5),
           (20, 0, -0.5)]
    far = [(100.0, 100.0, 100.0)]
    clouds = [faces + five + six + far * 4, far * 24,
              faces + far * 16]
    pts = np.array([[(*q, 0.0) for q in c] for c in clouds], np.float64)
    bbox = np.array([(*c, *s, y) for c, s, y, _, _ in boxes])
    same = np.array([(*g0, *unit, 0.0)] * len(boxes))
    bbox = np.stack([bbox, bbox, same])
    cls = np.array([[k for *_, k, _ in boxes], [k for *_, k, _ in boxes],
                    [0] * len(boxes)])
    obj = np.array([[s for *_, s in boxes]] * 2 + [[0.5] * len(boxes)])
    keep = np.zeros((3, len(boxes)), bool)
    keep[0, [0, 4, 5, 9]] = True
    keep[2, 0] = True
    t = [torch.from_numpy(x.astype(np.float32)) for x in (pts, bbox, obj)]
    counts = {(0, 0): 6, (0, 1): 5, (0, 4): 6, (0, 5): 6, (2, 0): 6}
    return (*t, torch.from_numpy(cls)), torch.from_numpy(keep), counts


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
def test_decode_nms_crafted_cases(request, device):
    """Equal scores keep index order (-0 and +0 too), points on the xy
    faces are outside and on the z faces inside, 5 points is empty and 6
    is not, an empty box suppresses nothing, a scene with no non-empty box
    keeps nothing, and boxes of other classes do not suppress each other:
    the plain version on the CPU, and the kernel and the plain version on
    the card."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    inputs, keep, counts = _crafted_case()
    inputs = [t.to(device) for t in inputs]
    runs = [keep_mask_ref(*inputs, 0.25, -1.0)]
    if device == "cuda":
        runs.append(keep_mask_cuda(*inputs, 0.25, -1.0))
    for selected, got in runs:
        assert torch.equal(selected.cpu(), keep)
        for (b, k), n in counts.items():
            assert int(got[b, k]) == n, (b, k)
    if device == "cuda":
        assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,p", [(1, 40000, 256), (3, 4097, 256),
                                   (32, 40000, 256), (2, 1000, 1024)])
def test_decode_nms_kernel_matches_plain(cuda, b, n, p):
    """The keep mask and the point counts of the kernel are the plain
    version's on the card, one launch of each of the two kernels a call;
    the batched minmax is the per-scene one bit for bit."""
    pts, bbox, obj, cls = (t.to(cuda) for t in _decode_case(b, n, p, n + p))
    for thr in (0.25, 0.05):
        before = _build.launch_counts()["decode_nms"]
        got, got_counts = keep_mask_cuda(pts, bbox, obj, cls, thr, 0.05)
        torch.cuda.synchronize()
        assert _build.launch_counts()["decode_nms"] == before + 2
        want, want_counts = keep_mask_ref(pts, bbox, obj, cls, thr, 0.05)
        assert torch.equal(got_counts, want_counts)
        assert torch.equal(got, want)
        assert 0 < int(want.sum()) < b * p
    mm = box_minmax(bbox)
    for i in range(b):
        assert torch.equal(mm[i], corners_minmax(box_corners(bbox[i])))


@pytest.mark.gpu
def test_decode_and_nms_makes_no_host_sync(cuda):
    """A B=32 decode of head outputs on the card runs the kernels (two
    launches) and never makes the host wait for the card."""
    from nesie_tpu_torch.eval.postprocess import decode_and_nms

    pts, bbox, _, _ = _decode_case(32, 40000, 256, 9)
    g = torch.Generator().manual_seed(9)
    out = {"bbox_preds": bbox, "obj_scores": torch.randn(32, 256, 2,
                                                         generator=g),
           "sem_scores": torch.randn(32, 256, 18, generator=g),
           "iou_scores": torch.rand(32, 256, 18, generator=g)}
    out = {k: v.to(cuda) for k, v in out.items()}
    pts = pts.to(cuda)
    decode_and_nms(out, pts)
    torch.cuda.synchronize()
    before = _build.launch_counts()["decode_nms"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = decode_and_nms(out, pts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.launch_counts()["decode_nms"] == before + 2
    cpu = decode_and_nms({k: v.cpu() for k, v in out.items()}, pts.cpu())
    assert torch.equal(got["bbox"].cpu(), cpu["bbox"])
    assert int(got["selected"].sum()) > 0


def test_decode_nms_wrapper_refuses_what_it_does_not_take():
    """CPU tensors, other dtypes, non-contiguous inputs and more than
    MAX_BOXES proposals a scene raise; nothing falls back."""
    pts, bbox, obj, cls = _decode_case(2, 300, 16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        keep_mask_cuda(pts, bbox, obj, cls, 0.25, 0.05)
    with pytest.raises(TypeError, match="float32"):
        keep_mask_cuda(pts.double(), bbox, obj, cls, 0.25, 0.05)
    with pytest.raises(TypeError, match="int64"):
        keep_mask_cuda(pts, bbox, obj, cls.int(), 0.25, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        keep_mask_cuda(pts, bbox.transpose(0, 1).contiguous().transpose(0, 1),
                       obj, cls, 0.25, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        keep_mask_cuda(pts[:, ::2], bbox, obj, cls, 0.25, 0.05)
    many = _decode_case(1, 300, MAX_BOXES + 1, 4)
    with pytest.raises(ValueError, match="at most"):
        keep_mask_cuda(*many, 0.25, 0.05)
    with pytest.raises(ValueError, match="shape"):
        keep_mask_cuda(pts[..., :2].contiguous(), bbox, obj, cls, 0.25, 0.05)


def test_decode_and_nms_on_cpu_takes_the_plain_version():
    """CPU tensors decode through the plain per-scene loop: no launch
    counted, no library built, the plain version's keep mask."""
    from nesie_tpu_torch.eval.postprocess import decode_and_nms

    pts, bbox, _, _ = _decode_case(3, 2000, 64, 5)
    g = torch.Generator().manual_seed(5)
    out = {"bbox_preds": bbox,
           "obj_scores": torch.randn(3, 64, 2, generator=g),
           "sem_scores": torch.randn(3, 64, 4, generator=g),
           "iou_scores": torch.rand(3, 64, 4, generator=g)}
    _build.reset_launch_counts()
    got = decode_and_nms(out, pts)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    assert _build._lib is None and fps_variants._lib is None
    want, _ = keep_mask_ref(pts, bbox, got["obj_scores"],
                            got["sem_scores"].argmax(-1), 0.25, 0.05)
    assert torch.equal(got["selected"], want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("shape", [(7,), (64, 7), (3, 256, 7)])
def test_box_minmax_is_box_corners_minmax(shape):
    """The minmax the kernel takes is ``corners_minmax(box_corners())``
    bit for bit."""
    g = torch.Generator().manual_seed(len(shape))
    bbox = torch.cat([torch.randn(*shape[:-1], 3, generator=g) * 3,
                      torch.rand(*shape[:-1], 3, generator=g) * 2,
                      torch.rand(*shape[:-1], 1, generator=g) * 7 - 3.5], -1)
    assert torch.equal(box_minmax(bbox), corners_minmax(box_corners(bbox)))


# ---- the eval set abstraction's gather, MLP and pool (csrc/sa_mlp.cu) ----

# (N, M, K, C, widths, radius) of the five PointSAModule calls of an eval
# forward; the Nesie and SAQE configurations share them
SA_CALLS = {
    "sa1": (40000, 2048, 64, 1, (64, 64, 128), 0.2),
    "sa2": (2048, 1024, 32, 128, (128, 128, 256), 0.4),
    "sa3": (1024, 512, 16, 256, (128, 128, 256), 0.8),
    "sa4": (512, 256, 16, 256, (128, 128, 256), 1.2),
    "agg": (1024, 256, 16, 256, (128, 128, 128), 0.3),
}
# float32 sums of up to 259 products in another order, through three
# layers, at the output's scale: ~100 ulp
SA_RTOL = 1e-5


def _sa_case(call, b, dev, seed=0):
    """A call's inputs on ``dev``: points spread over a room (many balls
    hold fewer than K, so the ball query fills duplicates), SA1's single
    feature channel as a strided view of (B, N, 4) points, an MLP with
    lecun-normal weights and BN statistics away from 0 and 1, in eval.
    Returns (xyz, new_xyz, features, idx, radius, mlp)."""
    from nesie_tpu_torch.nn.detector import init_weights_flax_, randomize_bn_
    from nesie_tpu_torch.nn.layers import PointMLP

    n, m, k, c, widths, radius = SA_CALLS[call]
    rng = np.random.default_rng(seed)
    room = np.array([7.0, 6.0, 3.0], np.float32)
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32) * room
    if c == 1:
        pts = np.concatenate([xyz, xyz[..., 2:]], -1)
        pts = torch.from_numpy(pts).to(dev)
        xyz_t, feats = pts[..., :3], pts[..., 3:]
    else:
        xyz_t = torch.from_numpy(xyz).to(dev)
        feats = torch.from_numpy(
            rng.standard_normal((b, n, c)).astype(np.float32)).to(dev)
    new_xyz = xyz_t[:, :m].contiguous()
    idx = ball_query_cuda(xyz_t.contiguous(), new_xyz, radius, k)
    mlp = PointMLP(c + 3, widths)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        init_weights_flax_(mlp, g)
        randomize_bn_(mlp, g)
    return xyz_t, new_xyz, feats, idx, radius, mlp.to(dev).eval()


def _sa_check(xyz, new_xyz, feats, idx, radius, mlp, normalize=True):
    from nesie_tpu_torch.ops.sa_mlp import mlp_layers, sa_mlp_cuda, sa_mlp_ref

    with torch.inference_mode():
        before = _build.launch_counts()["sa_mlp"]
        got = sa_mlp_cuda(xyz, new_xyz, feats, idx, radius, mlp_layers(mlp),
                          normalize)
        torch.cuda.synchronize()
        assert _build.launch_counts()["sa_mlp"] == before + 1
        want = sa_mlp_ref(xyz, new_xyz, feats, idx, radius, mlp,
                          normalize_xyz=normalize)
    assert got.shape == want.shape and torch.isfinite(want).all()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= SA_RTOL * scale
    return got, want


def _sa_cases():
    return ([(call, b) for call in SA_CALLS for b in (1, 2)]
            + [("sa1", 32)])


@pytest.mark.gpu
@pytest.mark.parametrize("call,b", _sa_cases())
def test_sa_mlp_kernel_matches_plain(cuda, call, b):
    """Each eval call shape at B=1 and 2 (the small grids take the 64- and
    32-row tiles) and SA1 at B=32, with duplicate-filled neighbourhoods
    and BN statistics away from 0 and 1."""
    case = _sa_case(call, b, cuda, seed=b)
    # some centres hold fewer than K points: their slots repeat
    assert (case[3][..., -1] == case[3][..., 0]).any()
    got, want = _sa_check(*case)
    # the kernel rounds as PyTorch's ops do, cuBLAS's sums aside
    assert (got == want).float().mean() > 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["strided_c128", "c64", "no_features",
                                  "unnormalized"])
def test_sa_mlp_kernel_other_forms(cuda, form):
    """The instantiations the eval calls leave out: 128-wide feature rows
    that are not 16-byte aligned (4-byte copies), 64 hidden channels over
    64 features (the segmentor's SA2), no features (the relative xyz
    alone), and offsets not divided by the radius."""
    from nesie_tpu_torch.nn.detector import init_weights_flax_, randomize_bn_
    from nesie_tpu_torch.nn.layers import PointMLP

    xyz, new_xyz, feats, idx, radius, mlp = _sa_case("sa3", 2, cuda, seed=9)
    normalize = form != "unnormalized"
    if form in ("strided_c128", "c64", "no_features"):
        c, widths = {"strided_c128": (128, (128, 128, 256)),
                     "c64": (64, (64, 64, 128)),
                     "no_features": (0, (64, 64, 128))}[form]
        g = torch.Generator().manual_seed(3)
        big = torch.randn(*feats.shape[:2], c + 1, generator=g).to(cuda)
        feats = big[..., 1:] if c else None
        mlp = PointMLP(c + 3, widths)
        with torch.no_grad():
            init_weights_flax_(mlp, g)
            randomize_bn_(mlp, g)
        mlp = mlp.to(cuda).eval()
    _sa_check(xyz, new_xyz, feats, idx, radius, mlp, normalize)


def _room_points(b, seed, dev):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(size=(b, 40000, 3)).astype(np.float32)
    xyz *= np.array([7.0, 6.0, 3.0], np.float32)
    pts = np.concatenate([xyz, xyz[..., 2:]], -1)
    return torch.from_numpy(pts).to(dev)


def _flagship(dev):
    from nesie_tpu_torch.nn.detector import (
        VoteNetNesie,
        init_weights_flax_,
        randomize_bn_,
    )

    model = VoteNetNesie()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        init_weights_flax_(model, g)
        randomize_bn_(model, g)
    return model.to(dev)


@pytest.mark.gpu
def test_sa_module_takes_the_kernel_in_eval_only(cuda):
    """An eval forward under inference_mode launches the kernel for its
    five SA calls and counts no unfused call; the teacher (train-mode BN
    under frozen_bn_stats, no grad) and an eval forward with grad launch
    none, each call counting its reason. The kernel's forward equals the
    torch path's within float32 reordering."""
    from nesie_tpu_torch import utils
    from nesie_tpu_torch.nn.layers import frozen_bn_stats

    model = _flagship(cuda).eval()
    pts = _room_points(2, 5, cuda)

    def run(grad=False, train=False):
        _build.reset_launch_counts()
        utils.reset_counts("sa.unfused.")
        model.train(train)
        ctx = torch.enable_grad() if grad else torch.inference_mode()
        with ctx, frozen_bn_stats(model):
            out = model(pts, "seed")
        return (_build.launch_counts()["sa_mlp"],
                utils.counts("sa.unfused."), out)

    launched, unfused, fused = run()
    assert launched == 5 and unfused == {}
    assert run(train=True)[:2] == (0, {"sa.unfused.train_mode": 5})
    launched, unfused, plain = run(grad=True)
    assert (launched, unfused) == (0, {"sa.unfused.grad": 5})
    for key in ("obj_scores", "sem_scores", "bbox_preds"):
        want = plain[key].detach()
        scale = max(1.0, float(want.abs().max()))
        assert float((fused[key] - want).abs().max()) <= 1e-4 * scale, key


@pytest.mark.gpu
def test_sa_mlp_in_a_replayed_graph(cuda):
    """A ``graphs.FpsSplitGraph`` capture of the B=1 eval forward takes
    the kernel (launches and all) and a replay on new points gives the
    eager forward's result bit for bit."""
    from nesie_tpu_torch.graphs import FpsSplitGraph

    model = _flagship(cuda).eval()
    pts = _room_points(1, 6, cuda)
    with torch.inference_mode():
        model(pts, "seed")  # eager first, as the Detector runs
        graph = FpsSplitGraph(cuda)
        out = graph.capture(lambda: model(pts, "seed")["obj_scores"])
        pts.copy_(_room_points(1, 7, cuda))
        _build.reset_launch_counts()
        graph.replay()
        replayed = _build.launch_counts()
        got = out.clone()
        _build.reset_launch_counts()
        want = model(pts, "seed")["obj_scores"]
        assert _build.launch_counts() == replayed
    assert replayed["sa_mlp"] == 5
    assert torch.equal(got, want)


def test_sa_mlp_wrapper_refuses_cpu_tensors_and_shapes():
    """The wrapper launches or raises: CPU tensors and widths or K the
    kernel does not take raise; ``kernel_shape_ok`` names the latter."""
    from nesie_tpu_torch.ops.sa_mlp import kernel_shape_ok, sa_mlp_cuda

    xyz = _uniform((1, 64, 3), seed=5)
    idx = torch.zeros((1, 8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sa_mlp_cuda(xyz, xyz[:, :8].contiguous(), None, idx, 0.2, [], True)
    assert kernel_shape_ok((64, 64, 128), 64)
    assert kernel_shape_ok((128, 128, 256), 16)
    assert kernel_shape_ok((128, 128, 128), 8)
    for widths, k in (((32, 32, 64), 32), ((128, 64, 128), 16),
                      ((128, 128, 64), 16), ((128, 128, 256), 12),
                      ((128, 128, 256), 4), ((64, 128), 16),
                      ((256, 256, 512), 32)):
        assert not kernel_shape_ok(widths, k), (widths, k)


def _old_sa_forward(mod, xyz, features):
    """PointSAModule's forward as it was before the kernel: ball query,
    gather, concatenate, the MLP, the max (or mean) over K."""
    from nesie_tpu_torch.nn.pointnet2 import sample_centers
    from nesie_tpu_torch.ops import ball_query, group_points

    new_xyz, indices = sample_centers(xyz, mod.num_point, None, None,
                                      mod.input_fps_ordered)
    idx = ball_query(xyz, new_xyz, mod.radius, mod.num_sample)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if mod.normalize_xyz:
        grouped_xyz = grouped_xyz / mod.radius
    grouped = grouped_xyz
    if features is not None:
        grouped = group_points(features, idx)
        if mod.use_xyz:
            grouped = torch.cat([grouped_xyz, grouped], dim=-1)
    h = mod.mlps[0](grouped)
    return new_xyz, h.amax(dim=2) if mod.pool == "max" else h.mean(dim=2)


@pytest.mark.parametrize("c,normalize,pool,train", [
    (1, True, "max", False), (5, False, "max", False), (0, True, "avg", False),
    (4, True, "max", True)])
def test_sa_module_plain_path_is_the_old_path(c, normalize, pool, train):
    """On the CPU the module runs the plain version, which is the old
    forward bit for bit, and counts neither a launch nor an unfused call
    (only CUDA calls count their reason)."""
    from nesie_tpu_torch import utils
    from nesie_tpu_torch.nn.detector import init_weights_flax_, randomize_bn_
    from nesie_tpu_torch.nn.pointnet2 import PointSAModule

    g = torch.Generator().manual_seed(c)
    pts = torch.rand(2, 300, 3 + max(c, 1), generator=g) * 2
    xyz, feats = pts[..., :3], (pts[..., 3:3 + c] if c else None)
    mod = PointSAModule(32, 0.4, 8, c, (16, 16, 24), normalize_xyz=normalize,
                        pool=pool)
    with torch.no_grad():
        init_weights_flax_(mod, g)
        randomize_bn_(mod, g)
    mod.train(train)
    _build.reset_launch_counts()
    before = utils.counts("sa.unfused.")
    with torch.no_grad():
        want = _old_sa_forward(mod, xyz, feats)
        got = mod(xyz, feats)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.launch_counts()["sa_mlp"] == 0
    assert utils.counts("sa.unfused.") == before


def test_sa_module_unfused_reasons():
    """``unfused_reason`` as the module sees it, in the order train mode,
    grad, dtype, shape; None where the kernel takes the call."""
    from nesie_tpu_torch.nn.pointnet2 import PointSAModule

    xyz, feats = torch.zeros(1, 8, 3), torch.zeros(1, 8, 128)
    mod = PointSAModule(4, 0.4, 16, 128, (128, 128, 256))
    with torch.no_grad():
        assert mod.unfused_reason(xyz, feats) == "train_mode"
        mod.eval()
        assert mod.unfused_reason(xyz, feats) is None
        mod.mlps[0].layer1.bn.train()
        assert mod.unfused_reason(xyz, feats) == "train_mode"
        mod.eval()
        assert mod.unfused_reason(xyz, feats.double()) == "dtype"
        assert PointSAModule(4, 0.4, 16, 128, (128, 128, 256),
                             dtype=torch.bfloat16).eval().unfused_reason(
            xyz, feats) == "dtype"
        assert PointSAModule(4, 0.4, 16, 128, (128, 128, 256)).double(
        ).eval().unfused_reason(xyz, feats) == "dtype"
        for kw in (dict(pool="avg"), dict(use_xyz=False),
                   dict(num_sample=12), dict(mlp_channels=(64, 64, 64))):
            args = dict(num_point=4, radius=0.4, num_sample=16,
                        in_channels=128, mlp_channels=(128, 128, 256))
            other = PointSAModule(**{**args, **kw}).eval()
            assert other.unfused_reason(xyz, feats) == "shape", kw
    assert mod.unfused_reason(xyz, feats) == "grad"
