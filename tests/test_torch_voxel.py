"""The voxel stack of the port held to the JAX package on the same
numpy-seeded inputs (CPU): ``ops.voxel``, ``ops.spconv``,
``nn.sparse_block`` (with ``convert.module_state_dict_from_flax``) and
``ops.roiaware_pool``. The inputs are built the way
``tests/test_parity_ops.py`` builds them, that file's own cases among
them, at small sizes: clouds of 2000-5000 points, a (16, 16, 16) sparse
grid with V = 256 and C = 8, 8 rois with ``out_size`` 4.

Tolerances:
* integer outputs (coords, counts, ``valid``, output sites): identical;
* float32 forwards: 1e-5 absolute. ``voxelize``'s voxels and the pooled
  maxima are copies of inputs, so they are identical too;
* gradients of the sparse convolutions, the sparse block and
  ``roiaware_pool3d``: 1e-10 absolute in float64, against ``jax.grad``
  under ``jax.enable_x64``.

The smoke's ``[voxel]`` phase holds the card to the CPU at the full
shapes (``chip_smoke.VOXEL_TOL``): integer outputs identical, float
outputs within 1e-5 of the CPU's largest magnitude (at least 1) for
forwards and 1e-4 for gradients, which sum over up to 40000 rows.

The traps of the port each have a test of their own: ``jnp.unique``'s
static size with more distinct sites than capacity
(``test_static_unique_truncates_to_the_smallest_sites``), ``voxelize``'s
overflow row (``test_voxelize_overflow_row_never_leaks``), BN statistics
over the padding rows (``test_sparse_bn_counts_padding_rows``), and
``segment_max``'s gradient on tied maxima
(``test_roiaware_max_gradient_splits_ties``).

``roiaware_pool3d`` rotates the points into each roi's frame with
``cos``/``sin``, which may differ by an ulp between XLA and torch; a
point within 1e-4 m of a face of a roi's voxel grid could then change
voxel. ``chip_smoke.roi_off_faces`` drops such points before the
comparison (the smoke's ``[voxel]`` phase does the same on the card): 1 to
5 of the 3000 points of each input here, and the tests assert that it
drops at most 2%.

The port's linear voxel ids are int64 (int32 in the JAX package); the
largest grid here has 16^3 sites, far below 2^31, so both agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import nesie_tpu.ops.roiaware_pool as jroi
import nesie_tpu.ops.spconv as jsp
import nesie_tpu.ops.voxel as jvox
import nesie_tpu_torch.ops.roiaware_pool as troi
import nesie_tpu_torch.ops.spconv as tsp
import nesie_tpu_torch.ops.voxel as tvox
from nesie_tpu.nn.sparse_block import SparseBasicBlock as JBlock
from nesie_tpu.nn.sparse_block import SparseConv3d as JSparseConv3d
from nesie_tpu.nn.sparse_block import SubMConv3d as JSubMConv3d
from nesie_tpu_torch.convert import module_state_dict_from_flax
from nesie_tpu_torch.nn.sparse_block import SparseBasicBlock, SparseConv3d, SubMConv3d
from nesie_tpu_torch.ops import roiaware_pool3d

torch.set_num_threads(1)
F32 = dict(atol=1e-5, rtol=0)
F64 = dict(atol=1e-10, rtol=0)
GRID = (16, 16, 16)
V, C = 256, 8
FACE_MARGIN = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ voxelize
def _cloud(seed, n, lo=-0.2, hi=1.2, c=4):
    return np.random.default_rng(seed).uniform(lo, hi, (n, c)).astype(np.float32)


PARITY_PTS = np.array([[0.05, 0.05, 0.05, 1.0], [0.06, 0.06, 0.06, 2.0],
                       [0.95, 0.95, 0.95, 3.0], [9.0, 9.0, 9.0, 4.0]],
                      np.float32)

VOX_CASES = {
    # (points, voxel_size, range, max_points, max_voxels)
    "parity_basic": (PARITY_PTS, (0.1,) * 3, (0, 0, 0, 1, 1, 1), 2, 4),
    "parity_cap": (np.zeros((10, 3), np.float32) + 0.05, (0.1,) * 3,
                   (0, 0, 0, 1, 1, 1), 3, 4),
    "no_cap": (_cloud(0, 3000), (0.1,) * 3, (0, 0, 0, 1, 1, 1), 35, 5000),
    "both_caps": (_cloud(1, 5000), (0.1,) * 3, (0, 0, 0, 1, 1, 1), 3, 64),
    "point_cap": (_cloud(2, 4000, 0, 1), (0.25, 0.25, 0.5), (0, 0, 0, 1, 1, 1),
                  5, 1000),
    "kitti_like": (_cloud(3, 2000, -5, 5), (0.4, 0.4, 0.8),
                   (-4.0, -4.0, -3.0, 4.0, 4.0, 1.0), 5, 400),
}


def _voxelize_both(case):
    pts, vs, rng_, mp, mv = VOX_CASES[case]
    return (jvox.voxelize(jnp.asarray(pts), vs, rng_, mp, mv),
            tvox.voxelize(_t(pts), vs, rng_, mp, mv))


@pytest.mark.parametrize("case", list(VOX_CASES))
def test_voxelize_matches_jax(case):
    want, got = _voxelize_both(case)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.coords.dtype == torch.int32
    assert got.num_points.dtype == torch.int32


def test_voxelize_overflow_row_never_leaks():
    """Both caps bind: the points past ``max_points`` and the voxels past
    ``max_voxels`` go to the overflow row, which is sliced off. Every row
    holds exactly the first points of its own voxel, in point order, and
    zeros after them."""
    pts, vs, rng_, mp, mv = VOX_CASES["both_caps"]
    got = tvox.voxelize(_t(pts), vs, rng_, mp, mv)
    assert got.voxels.shape == (mv, mp, pts.shape[1])
    grid = np.floor(pts[:, :3] / np.float32(0.1)).astype(np.int64)
    ok = np.all((grid >= 0) & (grid < 10), 1)
    occupied = len(np.unique(grid[ok], axis=0))
    assert occupied > mv and int(got.num_voxels) == mv
    voxels, coords = got.voxels.numpy(), got.coords.numpy()
    counts = got.num_points.numpy()
    assert counts.max() == mp and (counts > 0).all()
    rejected = 0
    for v in range(mv):
        mine = np.flatnonzero(ok & np.all(grid[:, ::-1] == coords[v], 1))
        rejected += len(mine) - counts[v]
        np.testing.assert_array_equal(voxels[v, :counts[v]],
                                      pts[mine[:counts[v]]])
        assert not voxels[v, counts[v]:].any()
    assert rejected > 0
    # the row past the last voxel kept nothing the overflow row took in
    want = jvox.voxelize(jnp.asarray(pts), vs, rng_, mp, mv)
    np.testing.assert_array_equal(voxels[-1], np.asarray(want.voxels)[-1])


@pytest.mark.parametrize("mode", ["mean", "max"])
@pytest.mark.parametrize("case", ["parity", "seeded"])
def test_dynamic_scatter_matches_jax(mode, case):
    if case == "parity":
        pts = np.array([[1.0, 2.0], [3.0, 4.0], [10.0, 10.0]], np.float32)
        ids, n_seg = np.array([0, 0, 2]), 3
    else:
        rng = np.random.default_rng(4)
        pts = rng.normal(size=(3000, 5)).astype(np.float32)
        n_seg = 400  # some segments empty, some ids out of range
        ids = rng.integers(-3, n_seg + 50, 3000)
    want = np.asarray(jvox.dynamic_scatter(jnp.asarray(pts), jnp.asarray(ids),
                                           n_seg, mode))
    got = tvox.dynamic_scatter(_t(pts), _t(ids), n_seg, mode).numpy()
    assert got.shape == want.shape
    if mode == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


# --------------------------------------------------------------- spconv
def _sparse_from_dense(dense, cap=32):
    """tests/test_parity_ops.py's helper: dense (D, H, W, C) -> the arrays
    of a SparseTensor of its nonzero sites, capacity ``cap``."""
    mask = np.abs(dense).sum(-1) > 0
    zz, yy, xx = np.nonzero(mask)
    feats = np.zeros((cap, dense.shape[-1]), dense.dtype)
    coords = np.zeros((cap, 3), np.int32)
    valid = np.zeros(cap, bool)
    n = len(zz)
    feats[:n] = dense[zz, yy, xx]
    coords[:n] = np.stack([zz, yy, xx], 1)
    valid[:n] = True
    return feats, coords, valid, dense.shape[:3]


def _seeded_sparse(seed, n_active=180, c=C, dtype=np.float32):
    """V = 256 slots on the (16, 16, 16) grid, ``n_active`` distinct sites
    in shuffled slots; padding rows keep nonzero features and coords."""
    rng = np.random.default_rng(seed)
    lin = rng.choice(np.prod(GRID), n_active, replace=False)
    coords = rng.integers(0, 16, (V, 3)).astype(np.int32)
    coords[:n_active] = np.stack([lin // 256, (lin // 16) % 16, lin % 16], 1)
    valid = np.arange(V) < n_active
    perm = rng.permutation(V)
    feats = rng.normal(size=(V, c)).astype(dtype)
    return feats, coords[perm], valid[perm], GRID


def _parity_sparse(name):
    rng = np.random.default_rng(0)
    if name == "parity_random":
        dense = np.zeros((5, 5, 5, 2), np.float32)
        for _ in range(6):
            dense[tuple(rng.integers(0, 5, 3))] = rng.normal(size=2)
    elif name == "parity_downsample":
        dense = np.zeros((4, 4, 4, 2), np.float32)
        dense[0, 0, 0], dense[1, 1, 1], dense[3, 3, 3] = [1, 2], [3, 4], [5, 6]
    else:  # a 6^3 grid with 7 sites, as the inverse-conv test builds it
        dense = np.zeros((6, 6, 6, 2), np.float32)
        for _ in range(7):
            dense[tuple(rng.integers(0, 6, 3))] = rng.normal(size=2)
    return _sparse_from_dense(dense)


def _inputs(name, dtype=np.float32):
    if name.startswith("parity"):
        f, c, v, g = _parity_sparse(name)
        return f.astype(dtype), c, v, g
    return _seeded_sparse(int(name[-1]), dtype=dtype)


def _both(arrays):
    f, c, v, g = arrays
    return (jsp.SparseTensor(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v),
                             tuple(g)),
            tsp.SparseTensor(_t(f), _t(c), _t(v), tuple(g)))


def _weights(seed, c_in, c_out, dtype=np.float32, k=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k**3, c_in, c_out)) * 0.3).astype(dtype)


def _run(op, m, x, w, b):
    """One sparse op of module ``m`` (``jsp`` or ``tsp``) on ``x`` with
    square weights ``w`` (k^3, C, C) and bias ``b``."""
    if op == "subm":
        return m.submanifold_conv3d(x, w, b)
    if op == "subm_k1":
        return m.submanifold_conv3d(x, w[13:14], b, kernel_size=1)
    if op == "conv":
        return m.sparse_conv3d(x, w, b)
    if op == "conv_cap20":
        return m.sparse_conv3d(x, w, b, max_out_voxels=20)
    if op == "conv_s3":
        return m.sparse_conv3d(x, w, b, stride=3)
    if op == "inverse":
        return m.sparse_inverse_conv3d(m.sparse_conv3d(x, w, None), w, x, b)
    if op == "transpose":
        return m.sparse_conv_transpose3d(x, w, b, max_out_voxels=2048)
    if op == "transpose_cap":
        return m.sparse_conv_transpose3d(x, w, b)
    if op == "maxpool":
        return m.sparse_maxpool3d(x)
    assert op == "maxpool_cap10"
    return m.sparse_maxpool3d(x, max_out_voxels=10)


SP_OPS = ["subm", "subm_k1", "conv", "conv_cap20", "conv_s3", "inverse",
          "transpose", "transpose_cap", "maxpool", "maxpool_cap10"]
SP_INPUTS = ["parity_random", "parity_downsample", "parity_inverse",
             "seeded0", "seeded1"]


def _assert_sparse_equal(got, want, tol):
    assert got.grid_shape == tuple(want.grid_shape)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.features.shape == want.features.shape
    np.testing.assert_allclose(got.features.detach().numpy(),
                               np.asarray(want.features), **tol)


@pytest.mark.parametrize("inputs", SP_INPUTS)
@pytest.mark.parametrize("op", SP_OPS)
def test_spconv_forward_matches_jax(op, inputs):
    arrays = _inputs(inputs)
    c_in = arrays[0].shape[1]
    w = _weights(1, c_in, c_in)  # square, so the inverse conv reuses it
    b = np.random.default_rng(2).normal(size=c_in).astype(np.float32)
    xj, xt = _both(arrays)
    want = _run(op, jsp, xj, jnp.asarray(w), jnp.asarray(b))
    got = _run(op, tsp, xt, _t(w), _t(b))
    _assert_sparse_equal(got, want, F32)


@pytest.mark.parametrize("op", ["subm", "conv_cap20", "inverse",
                                "transpose_cap", "maxpool", "maxpool_cap10"])
def test_spconv_gradients_match_jax(op):
    f, c, v, g = _seeded_sparse(3, dtype=np.float64)
    if op.startswith("maxpool"):
        f[::7] = f[1::7][: len(f[::7])]  # equal rows, some in one cell
    w = _weights(4, C, C, np.float64)
    b = np.random.default_rng(5).normal(size=C)

    with jax.enable_x64(True):
        def loss_j(f_, w_, b_):
            x = jsp.SparseTensor(f_, jnp.asarray(c), jnp.asarray(v), g)
            return jnp.sum(_run(op, jsp, x, w_, b_).features ** 2)

        want = jax.grad(loss_j, argnums=(0, 1, 2))(
            jnp.asarray(f), jnp.asarray(w), jnp.asarray(b))
        want = [np.asarray(a) for a in want]
    ft, wt, bt = (_t(a).requires_grad_() for a in (f, w, b))
    x = tsp.SparseTensor(ft, _t(c), _t(v), g)
    (_run(op, tsp, x, wt, bt).features ** 2).sum().backward()
    for name, got, w_ in zip(("features", "weights", "bias"),
                             (ft.grad, wt.grad, bt.grad), want):
        got = np.zeros_like(w_) if got is None else got.numpy()
        np.testing.assert_allclose(got, w_, err_msg=name, **F64)


@pytest.mark.parametrize("op", ["conv", "transpose", "maxpool"])
def test_static_unique_truncates_to_the_smallest_sites(op):
    """More distinct output sites than capacity: the port keeps the
    smallest linear ids in increasing order, as ``jnp.unique(size=,
    fill_value=)`` does; with room to spare, the rest is padding at the
    grid's size."""
    arrays = _seeded_sparse(6)
    xj, xt = _both(arrays)
    w = _weights(7, C, 4)
    run = {
        "conv": lambda m, x, cap: m.sparse_conv3d(x, w_of(m), None,
                                                  max_out_voxels=cap),
        "transpose": lambda m, x, cap: m.sparse_conv_transpose3d(
            x, w_of(m), None, max_out_voxels=cap),
        "maxpool": lambda m, x, cap: m.sparse_maxpool3d(
            x, max_out_voxels=cap),
    }[op]

    def w_of(m):
        return jnp.asarray(w) if m is jsp else _t(w)

    full = run(tsp, xt, 8192)
    n_sites = int(full.valid.sum())
    for cap in (n_sites // 3, n_sites - 1, n_sites, n_sites + 5):
        got, want = run(tsp, xt, cap), run(jsp, xj, cap)
        _assert_sparse_equal(got, want, F32)
        grid = got.grid_shape
        lin = tsp._linear(got.coords, grid)
        k = min(cap, n_sites)
        np.testing.assert_array_equal(lin[:k].numpy(),
                                      tsp._linear(full.coords, grid)[:k].numpy())
        assert (lin[k:] == np.prod(grid)).all()
        assert bool((lin[1:k] > lin[:k - 1]).all())
    assert n_sites // 3 < n_sites


def test_kernel_offset_order_is_ij():
    offs = tsp._kernel_offsets(3).numpy()
    np.testing.assert_array_equal(offs, np.asarray(jsp._kernel_offsets(3)))
    assert offs[1].tolist() == [-1, -1, 0] and offs[3].tolist() == [-1, 0, -1]


# ------------------------------------------------------------ the block
def _flax_vars(module, x, dtype, seed=0):
    """flax variables, batch stats moved off their init, in ``dtype``
    (initialised in float32, so float64 copies are exact)."""
    var = module.init(jax.random.PRNGKey(seed), x, False) if isinstance(
        module, JBlock) else module.init(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed + 10)

    def move(a):
        return a + rng.uniform(0.1, 0.5, np.shape(a)).astype(np.float32)

    var = dict(var)
    if "batch_stats" in var:
        var["batch_stats"] = jax.tree.map(move, var["batch_stats"])
    if "bias" in var.get("params", {}):
        var["params"] = dict(var["params"], bias=move(var["params"]["bias"]))
    return jax.tree.map(lambda a: np.asarray(a, np.float32).astype(dtype), var)


def _port_block(var, c_in, c_out, dtype):
    block = SparseBasicBlock(c_in, c_out).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    sd = module_state_dict_from_flax(var["params"], var["batch_stats"])
    block.load_state_dict(
        {k: v.to(block.conv1.weight.dtype) if v.is_floating_point() else v
         for k, v in sd.items()}, strict=True)
    return block


@pytest.mark.parametrize("c_out", [C, 12])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("inputs", ["parity_block", "seeded8"])
def test_sparse_basic_block_matches_jax(inputs, train, c_out):
    """Forward (float32, 1e-5) and, in train mode, the running statistics
    of both BNs; ``down`` exists iff the widths differ."""
    if inputs == "parity_block":  # test_parity_ops.test_sparse_basic_block
        rng = np.random.default_rng(0)
        dense = np.zeros((4, 4, 4, C), np.float32)
        dense[0, 0, 0] = rng.normal(size=C)
        dense[2, 1, 3] = rng.normal(size=C)
        arrays = _sparse_from_dense(dense)
    else:
        arrays = _seeded_sparse(8)
    xj, xt = _both(arrays)
    jblock = JBlock(channels=c_out)
    var = _flax_vars(jblock, xj, np.float32)
    block = _port_block(var, C, c_out, np.float32)
    assert (block.down is None) == (c_out == C)
    block.train(train)
    if train:
        want, upd = jblock.apply(var, xj, True, mutable=["batch_stats"])
    else:
        want = jblock.apply(var, xj, False)
    got = block(xt)
    _assert_sparse_equal(got, want, F32)
    assert not got.features[~xt.valid].any()
    if train:
        for i in (1, 2):
            bn = getattr(block, f"bn{i}")
            stats = upd["batch_stats"][f"bn{i}"]["BatchNorm_0"]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(stats["mean"]), **F32)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(stats["var"]), **F32)


@pytest.mark.parametrize("train", [False, True])
def test_sparse_basic_block_gradients_match_jax(train):
    arrays = _seeded_sparse(9, dtype=np.float64)
    f, c, v, g = arrays
    jblock = JBlock(channels=12)
    with jax.enable_x64(True):
        xj = jsp.SparseTensor(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v),
                              g)
        var = _flax_vars(jblock, xj, np.float64)

        def loss_j(params, f_):
            x = xj._replace(features=f_)
            out = jblock.apply(dict(var, params=params), x, train,
                               mutable=["batch_stats"])[0]
            return jnp.sum(out.features ** 2)

        gp, gf = jax.grad(loss_j, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, var["params"]), jnp.asarray(f))
    block = _port_block(var, C, 12, np.float64)
    block.train(train)
    ft = _t(f).requires_grad_()
    (block(tsp.SparseTensor(ft, _t(c), _t(v), g)).features ** 2).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gf), **F64)
    # the gradient tree by the port's names, in float64 (the conversion
    # itself stores float32)
    want = {"down.weight": np.asarray(gp["down"]["kernel"]).T}
    for i in (1, 2):
        bn = gp[f"bn{i}"]["BatchNorm_0"]
        want.update({f"conv{i}.weight": gp[f"conv{i}"]["kernel"],
                     f"bn{i}.weight": bn["scale"], f"bn{i}.bias": bn["bias"]})
    assert want.keys() == dict(block.named_parameters()).keys()
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   err_msg=name, **F64)


def test_sparse_bn_counts_padding_rows():
    """flax's BatchNorm in ``_SparseBN`` takes its statistics over all V
    rows, the zero padding rows included; statistics over the valid rows
    alone would differ. The port's running mean equals JAX's, not the
    masked mean."""
    arrays = _seeded_sparse(11, n_active=40)
    xj, xt = _both(arrays)
    jblock = JBlock(channels=C)
    var = _flax_vars(jblock, xj, np.float32)
    block = _port_block(var, C, C, np.float32).train()
    _, upd = jblock.apply(var, xj, True, mutable=["batch_stats"])
    conv1 = block.conv1(xt).features.detach()
    before = block.bn1.running_mean.clone()
    block(xt)
    all_rows = 0.9 * before + 0.1 * conv1.mean(0)
    valid_rows = 0.9 * before + 0.1 * conv1[xt.valid].mean(0)
    want = np.asarray(upd["batch_stats"]["bn1"]["BatchNorm_0"]["mean"])
    np.testing.assert_allclose(block.bn1.running_mean.numpy(), want, **F32)
    np.testing.assert_allclose(all_rows.numpy(), want, **F32)
    assert np.abs(valid_rows.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("kind", ["subm", "subm_bias", "conv", "conv_bias"])
def test_sparse_conv_modules_convert_and_match(kind):
    arrays = _seeded_sparse(12)
    xj, xt = _both(arrays)
    bias = kind.endswith("bias")
    if kind.startswith("subm"):
        jmod, tmod = JSubMConv3d(6, use_bias=bias), SubMConv3d(C, 6,
                                                               use_bias=bias)
    else:
        jmod = JSparseConv3d(6, stride=2, use_bias=bias)
        tmod = SparseConv3d(C, 6, stride=2, use_bias=bias)
    var = _flax_vars(jmod, xj, np.float32)
    tmod.load_state_dict(module_state_dict_from_flax(var["params"]),
                         strict=True)
    assert tmod.weight.shape == (27, C, 6)
    _assert_sparse_equal(tmod(xt), jmod.apply(var, xj), F32)


# ------------------------------------------------------- roiaware pool
def _roi_inputs(seed, n_rois=8, n_pts=3000, c=6, dtype=np.float32):
    """Rois and points as tests/test_parity_ops.py draws them, denser."""
    rng = np.random.default_rng(seed)
    rois = np.stack([
        rng.uniform(-1, 1, n_rois), rng.uniform(-1, 1, n_rois),
        rng.uniform(-0.5, 0.5, n_rois), rng.uniform(0.5, 1.5, n_rois),
        rng.uniform(0.5, 1.5, n_rois), rng.uniform(0.5, 1.5, n_rois),
        rng.uniform(-np.pi, np.pi, n_rois)], axis=1).astype(dtype)
    pts = rng.uniform(-1.5, 1.5, (n_pts, 3)).astype(dtype)
    feats = rng.normal(size=(n_pts, c)).astype(dtype)
    return rois, pts, feats


def _pool_inputs(seed, dtype, out_size=(4, 4, 4), ties=False):
    rois, pts, feats = _roi_inputs(seed, dtype=dtype)
    if ties:
        feats[1::2] = feats[::2]
        feats = np.round(feats, 1).astype(dtype)
    ok = chip_smoke.roi_off_faces(rois, pts, out_size, FACE_MARGIN)
    assert ok.mean() > 0.98, ok.mean()  # drops at most 2% of the points
    return rois, pts[ok], feats[ok]


@pytest.mark.parametrize("out_size,max_pts", [((4, 4, 4), 8), ((4, 4, 4), 128),
                                              ((3, 5, 2), 4), (4, 16)])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(mode, out_size, max_pts):
    size = (out_size,) * 3 if isinstance(out_size, int) else out_size
    rois, pts, feats = _pool_inputs(0, np.float32, size)
    want = np.asarray(jroi.roiaware_pool3d(rois, pts, feats, out_size,
                                           max_pts, mode))
    got = roiaware_pool3d(_t(rois), _t(pts), _t(feats), out_size, max_pts,
                          mode).numpy()
    assert got.shape == want.shape == (8, *size, feats.shape[1])
    if mode == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


def test_roiaware_voxel_ids_and_ranks_match_jax():
    rois, pts, _ = _pool_inputs(1, np.float32)
    want = np.asarray(jroi._voxel_ids(jnp.asarray(rois), jnp.asarray(pts),
                                      (4, 4, 4)))
    got = troi._voxel_ids(_t(rois), _t(pts), (4, 4, 4))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        troi._rank_in_voxel(got).numpy(),
        np.asarray(jax.vmap(jroi._rank_in_voxel)(jnp.asarray(want))))


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_roiaware_pool3d_gradients_match_jax(mode):
    rois, pts, feats = _pool_inputs(2, np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda f: jnp.sum(jroi.roiaware_pool3d(
            jnp.asarray(rois), jnp.asarray(pts), f, (4, 4, 4), 8, mode) ** 2))(
                jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (roiaware_pool3d(_t(rois), _t(pts), f, (4, 4, 4), 8, mode) ** 2).sum(
    ).backward()
    np.testing.assert_allclose(f.grad.numpy(), want, **F64)


def test_roiaware_max_gradient_splits_ties():
    """Duplicated feature values tie for a voxel's maximum:
    ``jax.ops.segment_max`` shares the gradient equally among the tied
    points, and so does the port."""
    rois, pts, feats = _pool_inputs(3, np.float64, ties=True)
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda f: jnp.sum(jroi.roiaware_pool3d(
            jnp.asarray(rois), jnp.asarray(pts), f, (4, 4, 4), 128, "max")))(
                jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    roiaware_pool3d(_t(rois), _t(pts), f, (4, 4, 4), 128, "max").sum(
    ).backward()
    got = f.grad.numpy()
    np.testing.assert_allclose(got, want, **F64)
    shares = np.unique(np.round(got[(got > 0) & (got < 1)], 6))
    assert 0.5 in shares  # a maximum tied between two points
