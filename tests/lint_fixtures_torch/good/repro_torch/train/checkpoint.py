"""Fixture: a justified waiver that suppresses a violation."""
import torch.distributed as dist


def save(group):
    # spjoin-lint-torch: allow[collective-site] -- a fence once per checkpoint, outside any step
    dist.barrier(group=group)
