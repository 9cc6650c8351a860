"""The port's kernel layer (repro_torch.kernels) against the JAX package.

On the CPU the port's ops run their plain PyTorch versions (the kernels
need a card); the reference side runs the Pallas kernels in interpret mode
(``backend="pallas"`` off-TPU). Inputs are made with numpy from a seed.
Tolerances: distances rtol = atol = 1e-5 (both fp32, different summation
orders); masks exact except pairs whose float64 distance lies within
1e-5·max(1, δ) of δ; cells and bits exact on the same mapped coordinates.
The CUDA kernels themselves are held against the plain versions on a card
by ``chip_smoke.py`` (phase 3 and at the main path's shapes).
"""
import numpy as np
import pytest
import torch

from repro.core import partition as ref_partition
from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops, ref

METRICS = ("l1", "l2", "linf", "cosine", "dot")
SHAPES = ((37, 50, 20), (96, 160, 40), (1, 7, 3))


def _data(a, b, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(a, m)).astype(np.float32)
    y = rng.normal(size=(b, m)).astype(np.float32)
    return x, y


def _d64(x, y, metric):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if metric == "l1":
        return np.abs(x[:, None] - y[None]).sum(-1)
    if metric == "linf":
        return np.abs(x[:, None] - y[None]).max(-1)
    if metric == "l2":
        return np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))
    if metric == "cosine":
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        yn = y / np.maximum(np.linalg.norm(y, axis=1, keepdims=True), 1e-12)
        return 1.0 - xn @ yn.T
    return x @ y.T


def _assert_mask(got, want, d64, delta):
    band = np.abs(d64 - delta) <= 1e-5 * max(1.0, abs(delta))
    assert not ((got != want) & ~band).any()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pairdist_matches_pallas(metric, shape):
    x, y = _data(*shape, seed=sum(shape))
    want = np.asarray(ref_ops.pairdist(x, y, metric, backend="pallas"))
    got = ops.pairdist(torch.as_tensor(x), torch.as_tensor(y), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_pairdist_mask_matches_pallas(metric, shape):
    x, y = _data(*shape, seed=7 + sum(shape))
    d64 = _d64(x, y, metric)
    delta = float(np.median(d64))
    want = np.asarray(ref_ops.pairdist_mask(x, y, delta, metric, backend="pallas"))
    got = ops.pairdist_mask(torch.as_tensor(x), torch.as_tensor(y), delta, metric).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    _assert_mask(got, want, d64, delta)


@pytest.mark.parametrize("metric", ("l1", "l2", "linf"))
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_pairdist_mask_filtered_matches_pallas(metric, shape):
    x, y = _data(*shape, seed=11 + sum(shape))
    anchors = y[:5]
    px = _d64(x, anchors, metric).astype(np.float32)
    py = _d64(y, anchors, metric).astype(np.float32)
    d64 = _d64(x, y, metric)
    delta = float(np.quantile(d64, 0.2))
    db = ref.prune_delta(delta, metric, float(max(np.abs(x).max(), np.abs(y).max())), shape[2])
    want = np.asarray(
        ref_ops.pairdist_mask_filtered(x, y, px, py, delta, metric, delta_bound=db, backend="pallas")
    )
    got = ops.pairdist_mask_filtered(
        *(torch.as_tensor(v) for v in (x, y, px, py)), delta, metric, delta_bound=db
    ).numpy()
    _assert_mask(got, want, d64, delta)
    # Identical to the unfiltered mask: the bound never prunes a hit.
    plain = ops.pairdist_mask(torch.as_tensor(x), torch.as_tensor(y), delta, metric).numpy()
    np.testing.assert_array_equal(got, plain)


def _plan(xm_np, p, delta=0.3, seed=0):
    return ref_partition.build_partition(xm_np, p, delta, strategy="iterative", seed=seed)


def _boxes(plan):
    return [np.array(b) for b in (plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi)]


@pytest.mark.parametrize("p", (5, 32, 70))
def test_assign_membership_exact_on_same_coords(p):
    rng = np.random.default_rng(p)
    xm = rng.normal(size=(150, 6)).astype(np.float32)
    boxes = _boxes(_plan(xm[::3], p))
    want_c, want_b = ref_ops.assign_membership(xm, *boxes, backend="pallas")
    got_c, got_b = ops.assign_membership(torch.as_tensor(xm), *(torch.as_tensor(b) for b in boxes))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_b.numpy().view(np.uint32), np.asarray(want_b))
    if p > 32:  # the top bit of a word is in play
        assert (np.asarray(want_b) >= 1 << 31).any()
    member = ops.unpack_membership(got_b, p).numpy()
    np.testing.assert_array_equal(member, np.asarray(ref_ops.unpack_membership(want_b, p)))


@pytest.mark.parametrize("metric", METRICS)
def test_map_assign_matches_pallas(metric):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(130, 24)).astype(np.float32)
    # Anchors off the data: an l2 self-distance is all cancellation.
    anchors = rng.normal(size=(6, 24)).astype(np.float32)
    xm0 = _d64(x, anchors, metric).astype(np.float32)
    boxes = _boxes(_plan(xm0[::2], 40, delta=0.05))
    want_xm, want_c, want_b = (
        np.asarray(v) for v in ref_ops.map_assign(x, anchors, *boxes, metric, backend="pallas")
    )
    got_xm, got_c, got_b = (
        v.numpy() for v in ops.map_assign(
            torch.as_tensor(x), torch.as_tensor(anchors), *(torch.as_tensor(b) for b in boxes),
            metric,
        )
    )
    np.testing.assert_allclose(got_xm, want_xm, rtol=1e-5, atol=1e-5)
    near = np.zeros(len(x), bool)
    for edge in boxes:
        near |= (np.abs(want_xm[:, None, :] - edge[None]) <= 1e-5).any(-1).any(-1)
    np.testing.assert_array_equal(got_c[~near], want_c[~near])
    np.testing.assert_array_equal(got_b.view(np.uint32)[~near], want_b[~near])


@pytest.mark.parametrize("metric", ("l1", "l2"))
def test_plain_map_assign_matches_reference_oracle(metric):
    from repro.kernels import ref as jref

    rng = np.random.default_rng(8)
    x = rng.normal(size=(90, 12)).astype(np.float32)
    anchors = rng.normal(size=(5, 12)).astype(np.float32)
    boxes = _boxes(_plan(_d64(x, anchors, metric).astype(np.float32)[::3], 36, delta=0.1))
    want = [np.asarray(v) for v in jref.map_assign(x, anchors, *boxes, metric)]
    got = [v.numpy() for v in ref.map_assign(
        torch.as_tensor(x), torch.as_tensor(anchors), *(torch.as_tensor(b) for b in boxes), metric
    )]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    cells, bits = ref.assign_membership(torch.as_tensor(want[0]), *(torch.as_tensor(b) for b in boxes))
    np.testing.assert_array_equal(cells.numpy(), want[1])
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want[2])


@pytest.mark.parametrize("want", ("cells", "member"))
def test_map_assign_want_zero_fills(want):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    boxes = _boxes(_plan(_d64(x, x[:4], "l1").astype(np.float32), 9))
    _, c, b = ops.map_assign(
        torch.as_tensor(x), torch.as_tensor(x[:4]), *(torch.as_tensor(v) for v in boxes),
        "l1", want=want,
    )
    _, rc, rb = ref_ops.map_assign(x, x[:4], *boxes, "l1", backend="pallas", want=want)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(rb))
    assert not (c.numpy().any() if want == "member" else b.numpy().any())


def _open_boxes(xm, p, seed, delta=0.05):
    """p kernel boxes over mapped coordinates ``xm`` (n, n_dims): each box
    bounds 3 random dimensions by quantile intervals and leaves the rest
    open (±1e30), so every dimension block matters and rows fall in a few
    boxes each; the whole boxes are the kernel boxes grown by δ."""
    rng = np.random.default_rng(seed)
    n_dims = xm.shape[1]
    lo = np.full((p, n_dims), -1e30, np.float32)
    hi = np.full((p, n_dims), 1e30, np.float32)
    for i in range(p):
        dims = rng.choice(n_dims, 3, replace=False)
        q = np.sort(rng.uniform(0.0, 1.0, 2))
        lo[i, dims] = np.quantile(xm[:, dims], 0.5 * q[0], axis=0)
        hi[i, dims] = np.quantile(xm[:, dims], 0.5 + 0.5 * q[1], axis=0)
    return [lo, hi, lo - delta, hi + delta]


@pytest.mark.parametrize("n_dims", (72, 130))
@pytest.mark.parametrize("p", (33, 100))
def test_map_assign_many_dims_and_partitions_matches_pallas(n_dims, p):
    """Shapes past 64 mapped dims and 32 partitions (several dim and word
    blocks in the kernel's plan): the port's map_assign and
    assign_membership (their plain versions here) against the JAX
    package's Pallas kernel in interpret mode, every ``want``; coordinates
    within rtol = atol = 1e-5, cells and bits exact off box edges, and
    exact on the same coordinates."""
    rng = np.random.default_rng(n_dims + p)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    anchors = rng.normal(size=(n_dims, 16)).astype(np.float32)
    boxes = _open_boxes(_d64(x, anchors, "l1").astype(np.float32), p, seed=p)
    tb = [torch.as_tensor(b) for b in boxes]
    for want in ops.WANTS:
        want_xm, want_c, want_b = (
            np.asarray(v) for v in ref_ops.map_assign(x, anchors, *boxes, "l1", backend="pallas", want=want)
        )
        got_xm, got_c, got_b = (
            v.numpy() for v in ops.map_assign(torch.as_tensor(x), torch.as_tensor(anchors), *tb, "l1", want=want)
        )
        assert got_xm.shape == (50, n_dims) and got_b.shape == (50, -(-p // 32))
        np.testing.assert_allclose(got_xm, want_xm, rtol=1e-5, atol=1e-5)
        near = np.zeros(len(x), bool)
        for edge in boxes:
            near |= (np.abs(want_xm[:, None, :] - edge[None]) <= 1e-5).any(-1).any(-1)
        np.testing.assert_array_equal(got_c[~near], want_c[~near])
        np.testing.assert_array_equal(got_b.view(np.uint32)[~near], want_b[~near])
        rc, rb = ref_ops.assign_membership(want_xm, *boxes, backend="pallas", want=want)
        gc, gb = ops.assign_membership(torch.as_tensor(want_xm), *tb, want=want)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(gb.numpy().view(np.uint32), np.asarray(rb))
        if want == "both":  # the boxes select rows: cells past 0 and set bits
            assert (want_c > 0).any() and want_b.any()


def test_pack_unpack_roundtrip_bit31():
    rng = np.random.default_rng(0)
    member = torch.as_tensor(rng.random((20, 70)) < 0.5)
    member[:, 31] = True
    bits = ref.pack_membership(member)
    assert bits.dtype == torch.int32 and (bits[:, 0] < 0).all()
    assert torch.equal(ref.unpack_membership(bits, 70), member)


def test_prune_delta_matches_reference():
    from repro.kernels import ref as jref

    for metric in ("l1", "l2", "linf", "cosine", "angular"):
        for args in ((0.5, 0.0, 0), (3.0, 40.0, 128), (1e-3, 1e3, 8)):
            d, xa, m = args
            assert ref.prune_delta(d, metric, xa, m) == jref.prune_delta(d, metric, xa, m)


def test_backend_dispatch_rules():
    x = torch.zeros((3, 4))
    assert ops.resolve_backend("auto", "l2", x) == "torch"
    assert ops.resolve_backend("auto", "angular", x) == "torch"
    assert ops.resolve_backend("torch", "l1", x) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.resolve_backend("cuda", "l1", x)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ops.resolve_backend("cuda", "angular", x)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("pallas", "l1", x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.pairdist(x, x, "l1", backend="cuda")
    with pytest.raises(ValueError, match="unsound"):
        ops.pairdist_mask_filtered(x, x, x, x, 1.0, "cosine")


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import mapassign, pairdist

    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pairdist.pairdist_cuda(x, x, "l1")
    with pytest.raises(ValueError, match="CUDA"):
        pairdist.pairdist_filtered_cuda(x, x, x, x, "l1", 1.0, 1.0)
    box = torch.zeros((32, 8))
    with pytest.raises(ValueError, match="CUDA"):
        mapassign.map_assign_cuda(x, None, box, box, box, box, None, 8, True, True)


# --- host-side launch choices of the verify-tile wrappers (no card needed)


@pytest.mark.parametrize(
    "a, b, n_sm, tile",
    [
        (1024, 4096, 132, 128),  # the engine's tile: 8 x 32 = 256 CTAs of 128 x 128
        (256, 4096, 132, 64),  # a query batch: 2 x 32 = 64 large CTAs, so 4 x 64 small ones
        (1024, 2176, 132, 128),  # 8 x 17 = 136 >= 132
        (1024, 2048, 132, 64),  # 8 x 16 = 128 < 132
        (1, 1, 132, 64),  # nothing fills the card: the small tile
        (129, 129, 4, 128),  # 2 x 2 = 4 CTAs on a 4-SM card
        (128, 128, 4, 64),
    ],
)
def test_choose_tile_by_grid(a, b, n_sm, tile):
    from repro_torch.kernels import pairdist

    assert pairdist.choose_tile(a, b, n_sm) == tile


def test_launch_plan_checks_tile_and_grid_rows():
    from repro_torch.kernels import pairdist

    x = torch.zeros((2, 4))
    assert pairdist.launch_plan("t", x, 1024, 4096, tile=64) == 64
    rows = pairdist.MAX_GRID_Y * 64
    assert pairdist.launch_plan("t", x, rows, 8, tile=64) == 64
    with pytest.raises(ValueError, match="x rows per launch"):
        pairdist.launch_plan("t", x, rows + 1, 8, tile=64)
    assert pairdist.launch_plan("t", x, rows + 1, 8, tile=128) == 128
    with pytest.raises(ValueError, match="tile must be one of"):
        pairdist.launch_plan("t", x, 8, 8, tile=32)


def _at_float_offset(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` copied one float into a buffer: contiguous, 4-byte aligned
    but not 16-byte aligned."""
    buf = torch.zeros(rows.numel() + 1)
    buf[1:] = rows.flatten()
    return buf[1:].view(rows.shape)


@pytest.mark.parametrize("m", (33, 100, 128))
def test_stage_flags_from_width_and_alignment(m):
    from repro_torch.kernels import pairdist

    base = torch.zeros((11, m))
    assert base.data_ptr() % 16 == 0
    vec = pairdist.VEC_ROWS if m % 4 == 0 else 0
    assert pairdist.stage_flags(base, base) == vec
    # One row in: the base moves by 4 m bytes, aligned again when m % 4 == 0.
    assert pairdist.stage_flags(base[1:], base[3:]) == vec
    # One float in: 4-byte copies whatever the width.
    assert pairdist.stage_flags(_at_float_offset(base[:5]), base) == 0
    assert pairdist.stage_flags(base, _at_float_offset(base[:5])) == 0


@pytest.mark.parametrize("bp", (1, 3, 8, 16, 17))
def test_stage_flags_for_pivot_coordinates(bp):
    from repro_torch.kernels import pairdist

    x = torch.zeros((9, 128))
    p = torch.zeros((9, bp))
    pivots = pairdist.VEC_PIVOTS if bp % 4 == 0 else 0
    assert pairdist.stage_flags(x, x, p, p) == pairdist.VEC_ROWS | pivots
    assert pairdist.stage_flags(x, x, p[1:], p[2:]) == pairdist.VEC_ROWS | pivots
    assert pairdist.stage_flags(x, x, _at_float_offset(p), p) == pairdist.VEC_ROWS


# --- host-side launch plans of the map-assign and histogram wrappers


@pytest.mark.parametrize("metric_mode", (True, False), ids=("metric", "assign-only"))
@pytest.mark.parametrize("n", (1, 256, 4096, 50_000, 1_000_000))
def test_map_assign_launch_plan_fits_and_covers(n, metric_mode):
    from repro_torch.kernels import mapassign

    n_sm = 132
    for nap in (8, 16, 64, 72, 136, 256, 1024):
        for pp, p in ((32, 1), (32, 16), (32, 32), (128, 100), (1024, 1000), (4096, 4096)):
            for smem_max in (mapassign.SMEM_OPTIN, 64 * 1024):
                plan = mapassign.launch_plan(n, nap, pp, p, metric_mode, n_sm, smem_max=smem_max)
                key = (n, nap, pp, p, metric_mode, smem_max, plan)
                # Fits the card's (or the given) shared memory.
                assert plan.smem == mapassign.smem_bytes(
                    plan.rows, plan.db, plan.pw, metric_mode, plan.stream), key
                assert plan.smem <= smem_max, key
                # Every row: tiles of `rows` rows, the last one ragged: one
                # CTA each, or the persistent kernel's CTAs walking them.
                rows = mapassign.ROWS if metric_mode else mapassign.ASSIGN_ROWS
                tiles = -(-n // plan.rows)
                assert plan.rows in rows and (tiles - 1) * plan.rows < n <= tiles * plan.rows, key
                if plan.stream:
                    assert not metric_mode and plan.rows >= mapassign.THREADS, key
                    assert plan.db >= nap and plan.pw == pp // 32, key  # one block: edges staged once
                    per_sm = min(mapassign.STREAM_CTAS, mapassign.SMEM_PER_SM // (plan.smem + 1024))
                    assert per_sm >= 1 and 1 <= plan.grid <= min(tiles, per_sm * n_sm), key
                    rounds = -(-tiles // plan.grid)
                    assert rounds == -(-tiles // (per_sm * n_sm)), key  # no more rounds than a full grid
                else:
                    assert plan.grid == tiles, key
                if n >= rows[-1] * n_sm and smem_max == mapassign.SMEM_OPTIN and not plan.stream:
                    assert plan.grid >= n_sm, key  # the grid fills the card
                # Every dimension: blocks of db (a multiple of 8) dims over nap.
                assert plan.db % 8 == 0 and plan.db >= 8, key
                if metric_mode:
                    assert plan.a in mapassign.ANCHORS
                    assert plan.db == (mapassign.THREADS // plan.rows) * plan.a, key
                    assert plan.db >= nap or plan.a == mapassign.ANCHORS[-1] or smem_max < mapassign.SMEM_OPTIN, key
                else:
                    assert plan.a == 1 and plan.db <= min(nap, mapassign.SWEEP_DIMS), key
                # Every cell: word blocks of pw words over pp / 32 words.
                words = pp // 32
                assert 1 <= plan.pw <= words and -(-words // plan.pw) * plan.pw >= words, key


def test_map_assign_launch_plan_main_path_and_query_batches():
    from repro_torch.kernels import mapassign

    # The join's two launches over 1M rows: 256-row CTAs, 8 anchors a thread.
    assert mapassign.launch_plan(1_000_000, 8, 32, 16, True, 132) == mapassign.MapPlan(
        rows=256, a=8, db=8, pw=1, grid=3907, smem=83_232)
    # The assign-only launch: the persistent kernel, 1,954 tiles of 512 rows
    # in 5 rounds over 391 CTAs (3 per SM fit 132 SMs).
    assert mapassign.launch_plan(1_000_000, 8, 32, 16, False, 132) == mapassign.MapPlan(
        rows=512, a=1, db=8, pw=1, grid=391, smem=36_864, stream=True)
    # Query batches: 32-row CTAs, a thread per (row, anchor).
    for n, grid in ((256, 8), (4096, 128)):
        plan = mapassign.launch_plan(n, 8, 32, 16, True, 132)
        assert (plan.rows, plan.a, plan.db, plan.grid) == (32, 1, 8, grid)
    with pytest.raises(ValueError, match="bad padded shape"):
        mapassign.launch_plan(10, 12, 32, 16, True, 132)
    with pytest.raises(ValueError, match="bad padded shape"):
        mapassign.launch_plan(10, 8, 48, 16, True, 132)
    with pytest.raises(ValueError, match="bad padded shape"):  # a word of padding only
        mapassign.launch_plan(10, 8, 64, 16, True, 132)


@pytest.mark.parametrize("t", (1, 8, 16, 17, 383, 384, 1024, 5000, 20_000, 1_000_000))
def test_histogram_launch_plan_fits_and_covers(t):
    from repro_torch.kernels import histogram

    n_sm = 132
    for n in (1, 77, 4099, 1_000_000):
        for m in (1, 5, 33, 128, 130, 1000):
            plan = histogram.launch_plan(n, m, t, n_sm)
            key = (n, m, t, plan)
            assert plan.smem == histogram.smem_bytes(t, plan.qb, plan.mode, plan.tmax, plan.copies), key
            assert plan.smem <= histogram.SMEM_OPTIN, key
            # Every dimension: grid_x blocks of qb quads (4 dims each).
            assert plan.qb in (1, 2, 4, 8, 16, 32) and plan.grid_x == -(-m // (4 * plan.qb)), key
            # Every row: strided ranges, at least one, within the grid's limit.
            assert 1 <= plan.grid_y <= histogram.MAX_GRID_Y, key
            assert plan.grid_y <= max(1, -(-n // (histogram.THREADS // plan.qb))), key
            # Every cell: registers for t <= 16, shared histograms of t cells
            # per dim in each copy, or global atomics (no limit).
            if t <= 16:
                assert plan.mode == histogram.REGISTERS and t <= plan.tmax in histogram.REG_CELLS, key
            elif plan.mode == histogram.SHARED:
                assert 1 <= plan.copies <= histogram.WARPS and plan.smem >= 4 * plan.copies * 4 * plan.qb * t, key
            else:
                assert plan.mode == histogram.GLOBAL and plan.smem == 0, key
                assert 4 * 4 * (t | 1) > histogram.SMEM_OPTIN, key  # not even one quad fits
    # The stats stage's shape: registers, 32 quads, 8 CTAs per SM.
    assert histogram.launch_plan(1_000_000, 128, 8, n_sm) == histogram.HistPlan(
        mode=histogram.REGISTERS, tmax=8, qb=32, copies=1, grid_x=1, grid_y=1056, smem=32_768)


@pytest.mark.parametrize("metric", ("l1", "l2", "linf", "cosine"))
def test_pairdist_count_matches_reference(metric):
    """Per-row fan-out: the port's ``ops.pairdist_count`` (plain on the
    CPU) and ``ref.pairdist_count`` against the reference's ops (Pallas in
    interpret mode) and ref; exact except rows with a pair in the δ band."""
    from repro.kernels import ref as jref

    x, y = _data(37, 50, 20, seed=11)
    delta = float(np.quantile(_d64(x, y, metric), 0.2))
    got = ops.pairdist_count(torch.as_tensor(x), torch.as_tensor(y), delta, metric)
    plain = ref.pairdist_count(torch.as_tensor(x), torch.as_tensor(y), delta, metric)
    want = np.asarray(ref_ops.pairdist_count(x, y, delta, metric, backend="pallas"))
    assert got.dtype == plain.dtype == torch.int32 and got.shape == (37,)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jref.pairdist_count(x, y, delta, metric)))
    band = (np.abs(_d64(x, y, metric) - delta) <= 1e-5 * max(1.0, abs(delta))).sum(1)
    assert (np.abs(got.numpy() - want) <= band).all() and got.sum() > 0
