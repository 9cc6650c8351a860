"""Fixture: collectives outside their blessed sites."""
import torch
import torch.distributed as dist


def _all_gather(t, group, stage: str):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def sum_counts(t, group):
    dist.all_reduce(t, group=group)  # expect: collective-site
    dist.broadcast(t, src=0, group=group)  # expect: collective-site
    torch.distributed.all_to_all_single(t, t, group=group)  # expect: collective-site
    return t
