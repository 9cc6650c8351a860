"""Deterministic, shardable, resumable data: the LM token pipeline and the
row stream of the incremental join layer.

The port of ``repro.data.pipeline`` (numpy, as in the reference; the port
imports nothing of the JAX package). The design rule: a batch is a PURE
FUNCTION of (seed, step), a row of (seed, index) — no iterator state — so
the same seed gives the same arrays in both packages, a restart at step s
reproduces the batches an uninterrupted run saw (a checkpoint stores only
s), and any host can recompute any shard of any step. ``host_batch``
returns one host's slice, ``global_batch`` the whole batch, and
``device_batch`` the batch sharded over a device mesh: each rank builds
its own rows (no collective) as DTensors of the global batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import synthetic
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seed: int = 0
    seq_len: int = 1024
    global_batch: int = 8


class TokenPipeline:
    """Synthetic LM token stream (swap ``example`` for a real tokenized
    store — the addressing contract is the whole interface)."""

    def __init__(self, cfg: ArchConfig, pcfg: PipelineConfig):
        self.cfg = cfg
        self.pcfg = pcfg

    def example(self, index: int) -> np.ndarray:
        return synthetic.token_example(
            self.pcfg.seed, index, self.pcfg.seq_len + 1, self.cfg.vocab
        )

    def global_batch(self, step: int) -> dict:
        """Step ``step``'s batch as numpy: int32 ``tokens`` and ``labels``
        (B, seq_len); vlm: fp32 ``patches`` (B, n_patches, frontend_dim)
        prepended and their label positions -1; audio: fp32 ``frames``
        (B, seq_len, frontend_dim) and per-frame labels."""
        B = self.pcfg.global_batch
        start = step * B
        toks = np.stack([self.example(start + i) for i in range(B)])
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.family == "vlm":
            # patch stand-ins ride along; label positions for patches masked
            n_p = self.cfg.n_patches
            rngs = np.random.default_rng(np.random.SeedSequence([self.pcfg.seed, step]))
            batch = {
                "patches": rngs.normal(size=(B, n_p, self.cfg.frontend_dim)).astype(np.float32),
                "tokens": batch["tokens"][:, : self.pcfg.seq_len - n_p],
                "labels": np.concatenate(
                    [np.full((B, n_p), -1, np.int32),
                     batch["labels"][:, : self.pcfg.seq_len - n_p]], axis=1),
            }
        if self.cfg.family == "audio":
            rngs = np.random.default_rng(np.random.SeedSequence([self.pcfg.seed, step]))
            batch = {
                "frames": rngs.normal(size=(B, self.pcfg.seq_len, self.cfg.frontend_dim)).astype(np.float32),
                "labels": batch["labels"] % self.cfg.vocab,
            }
        return batch

    def host_batch(self, step: int, host_id: int, n_hosts: int) -> dict:
        g = self.global_batch(step)
        B = self.pcfg.global_batch
        if B % n_hosts:
            raise ValueError(f"global batch {B} does not split over {n_hosts} hosts")
        lo = host_id * (B // n_hosts)
        hi = lo + B // n_hosts
        return {k: v[lo:hi] for k, v in g.items()}

    def device_batch(self, step: int, mesh, batch_axes=("pod", "data")) -> dict:
        """Step ``step``'s global batch as DTensors on ``mesh`` (a
        ``DeviceMesh``), dim 0 sharded over the batch axes the mesh has
        (major to minor) and replicated over the others. Each rank holds
        exactly ``host_batch``'s rows for its index along those axes
        (``.to_local()``), on the mesh's device."""
        import torch
        from torch.distributed.tensor import DTensor

        from repro_torch.models import base

        sizes = base.axis_sizes(mesh)
        axes = tuple(a for a in batch_axes if a in sizes)
        coord = dict(zip(sizes, mesh.get_coordinate()))
        host_id, n_hosts = 0, 1
        for a in axes:
            host_id, n_hosts = host_id * sizes[a] + coord[a], n_hosts * sizes[a]
        spec = ((axes if len(axes) > 1 else axes[0]),) if axes else ()
        placements = base.placements_for(spec, mesh)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        B = self.pcfg.global_batch
        if B % n_hosts:
            raise ValueError(f"global batch {B} does not split over {n_hosts} ranks")
        lo = host_id * (B // n_hosts)
        out = {}
        for k, v in self.global_batch(step).items():
            local = torch.as_tensor(v[lo : lo + B // n_hosts], device=device)
            out[k] = DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(v.shape),
                                        stride=torch.empty(v.shape, device="meta").stride())
        return out


class StreamSource:
    """Deterministic row stream feeding ``spjoin.join_incremental`` /
    ``MetricIndex.insert_batch``.

    Row ``i`` is ``np.random.SeedSequence([seed, i])``'s draw, so the
    GLOBAL row sequence is independent of how it is chopped into insertion
    batches — what makes "the same pairs under ANY batch split" a
    well-posed claim. ``dist``: "normal" | "uniform" | "clustered" (rows
    around ``n_clusters`` fixed centers, a function of the seed alone).
    """

    def __init__(
        self,
        n_features: int,
        seed: int = 0,
        dist: str = "normal",
        n_clusters: int = 4,
        scale: float = 1.0,
    ):
        if dist not in ("normal", "uniform", "clustered"):
            raise ValueError(f"unknown stream dist {dist!r}")
        self.n_features = n_features
        self.seed = seed
        self.dist = dist
        self.scale = scale
        # Cluster centers use the reserved row index 2**62.
        if dist == "clustered":
            rng = np.random.default_rng(np.random.SeedSequence([seed, 2**62]))
            self.centers = rng.normal(size=(n_clusters, n_features)).astype(
                np.float32
            ) * np.float32(3.0 * scale)
        else:
            self.centers = None

    def row(self, i: int) -> np.ndarray:
        """Row ``i`` of the global stream — pure in (seed, i)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(i)]))
        if self.dist == "uniform":
            x = rng.uniform(-1.0, 1.0, size=self.n_features) * self.scale
        elif self.dist == "clustered":
            c = self.centers[int(rng.integers(self.centers.shape[0]))]
            x = c + rng.normal(size=self.n_features) * (0.3 * self.scale)
        else:
            x = rng.normal(size=self.n_features) * self.scale
        return x.astype(np.float32)

    def prefix(self, n: int) -> np.ndarray:
        """The first ``n`` rows as one (n, m) array."""
        return self.batch(0, n)

    def batch(self, start: int, size: int) -> np.ndarray:
        """Rows [start, start + size) — one insertion batch."""
        if size == 0:
            return np.zeros((0, self.n_features), np.float32)
        return np.stack([self.row(i) for i in range(start, start + size)])
