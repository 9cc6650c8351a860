"""The port's index stays exact when mapped coordinates round differently.

Lemma 4 holds for exact coordinates; a row's mapped coordinate is a sum
rounded in fp32, and the card's kernel sums in another order than the
plain path. On integer rows under l1 many pairs sit at exactly δ with the
triangle inequality tight along an anchor (every same-side pair of a
1-feature set), so a δ-neighbour of a row on its cell's box face lies a
few ulps past a box expanded by exactly δ. Every routing and membership
test of the index (a query batch, ``self_pairs``, an insert's ΔR×R_old and
ΔR×ΔR, ``DistIndex`` on a gloo world of 1) must stay exact with every
mapped coordinate nudged by up to 4 ulps: pairs equal brute force.
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import index, mapping, spjoin
from repro_torch.kernels import ops as kops

DELTA = 4.0
N_OLD = 400
SEEDS = range(4)
CASES = ("query_batch", "self_pairs", "insert_cross", "insert_self", "dist_index")


def _nudge(x: torch.Tensor, gen: torch.Generator, most: int = 4) -> torch.Tensor:
    """``x`` moved by a random whole number of ulps in [-most, most] per
    element: what a different fp32 summation order does to a distance."""
    steps = torch.randint(-most, most + 1, x.shape, generator=gen)
    up, down = torch.full_like(x, float("inf")), torch.full_like(x, float("-inf"))
    for _ in range(most):
        x = torch.where(steps > 0, torch.nextafter(x, up), torch.where(steps < 0, torch.nextafter(x, down), x))
        steps = steps - steps.sign()
    return x


@pytest.fixture
def nudged(monkeypatch):
    """Every mapped coordinate the index computes, nudged."""
    gen = torch.Generator().manual_seed(0)
    real_map_assign, real_call = kops.map_assign, mapping.SpaceMap.__call__

    def map_assign(*args, **kwargs):
        xm, cells, bits = real_map_assign(*args, **kwargs)
        return _nudge(xm, gen), cells, bits

    def space_map(self, v):
        return _nudge(real_call(self, v), gen)

    monkeypatch.setattr(kops, "map_assign", map_assign)
    monkeypatch.setattr(mapping.SpaceMap, "__call__", space_map)


@pytest.fixture
def world1(tmp_path):
    """An in-process gloo world of one rank, destroyed after the test."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        yield None
    finally:
        dist.destroy_process_group()


def _rows():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 120, size=(600, 1)).astype(np.float32),
            rng.integers(0, 120, size=(150, 1)).astype(np.float32))


def _pairs(case: str, x: np.ndarray, q: np.ndarray, cfg: spjoin.JoinConfig):
    """The case's pairs from the index, and brute force's."""
    if case == "query_batch":
        idx = index.build_index(x, cfg, device="cpu")
        return idx.query_batch(q), index.brute_force_query(x, q, DELTA, "l1", device="cpu")
    if case == "dist_index":
        idx = index.build_index(x, cfg, device="cpu").to_distributed()
        return idx.query_batch(q), index.brute_force_query(x, q, DELTA, "l1", device="cpu")
    if case == "self_pairs":
        idx = index.build_index(x, cfg, device="cpu")
        return idx.self_pairs(), spjoin.brute_force_pairs(x, DELTA, "l1", device="cpu")
    idx = index.build_index(x[:N_OLD], cfg, device="cpu")
    got, _ = idx.insert_batch(x[N_OLD:])
    truth = spjoin.brute_force_pairs(x, DELTA, "l1", device="cpu")
    truth = truth[truth[:, 1] >= N_OLD]
    cross = case == "insert_cross"
    keep = lambda p: p[(p[:, 0] < N_OLD) == cross]  # noqa: E731
    return keep(got), keep(truth)


@pytest.mark.parametrize("fused", (True, False), ids=("fused", "plain"))
@pytest.mark.parametrize("case", CASES)
def test_index_exact_when_mapped_coordinates_round_differently(
    nudged, tmp_path, case, fused, request
):
    if case == "dist_index":
        request.getfixturevalue("world1")
    x, q = _rows()
    for seed in SEEDS:
        cfg = spjoin.JoinConfig(delta=DELTA, metric="l1", k=64, p=8, n_dims=1,
                                map_fused=fused, seed=seed)
        got, truth = _pairs(case, x, q, cfg)
        assert len(truth) > 0
        assert got.tobytes() == truth.tobytes(), (seed, len(got), len(truth))
