"""Fixture: each collective at its blessed site (closures count as their
factory)."""
import torch
import torch.distributed as dist


def _all_gather(t, group, stage: str):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def _make_exchange(group, M: int, spd: int, stage: str):
    def exchange(buf):
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=group)
        return out

    return exchange
