"""Quickstart on the GPU: metric similarity self-join with the PyTorch/CUDA
port of SP-Join, checked against brute force.

    PYTHONPATH=src python examples/quickstart_torch.py            # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import spjoin
from repro_torch.data import synthetic


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args()

    # 1. Some clustered vector data (3k objects, 16 dims).
    data = synthetic.mixture(n=3000, m=16, n_clusters=8, spread=6.0, seed=0)

    # 2. Configure the join: L2 distance, threshold delta, generative sampling
    #    (Alg. 3/4) + learning-based partitioning (Alg. 6) — the paper's best arm.
    cfg = spjoin.JoinConfig(
        delta=3.0, metric="l2",
        sampler="generative", partitioner="learning",
        k=512,        # pivots (cf. sampling.required_sample_size for the bound)
        p=16,         # partitions / reducers
        n_dims=8,     # target-space dimensionality
    )

    # 3. Join (on the card unless --device cpu: the map-assign and filtered
    #    pairdist CUDA kernels run the map and verify phases).
    result = spjoin.join(data, cfg, device=args.device)
    print(f"device:         {args.device}")
    print(f"objects:        {len(data)}")
    print(f"similar pairs:  {result.n_pairs}")
    print(f"verifications:  {result.n_verifications} "
          f"({result.n_verifications / (len(data)**2):.1%} of brute force)")
    print(f"node confidences: {result.node_confidences.round(3)}")
    print(f"phase times: sample {result.sample_time_s:.2f}s | "
          f"map {result.map_time_s:.2f}s | verify {result.verify_time_s:.2f}s")

    # 4. Exactness against brute force (small data only!).
    truth = spjoin.brute_force_pairs(data, cfg.delta, cfg.metric, device=args.device)
    assert np.array_equal(result.pairs, truth), "join must be exact"
    print("exactness check vs brute force: OK")


if __name__ == "__main__":
    main()
