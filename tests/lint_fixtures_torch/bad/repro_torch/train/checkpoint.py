"""Fixture: waivers that break the hygiene rules."""
import torch.distributed as dist


def save(group):
    # expect-next: waiver-hygiene
    dist.barrier(group=group)  # spjoin-lint-torch: allow[collective-site] -- short


def load():
    # expect-next: waiver-hygiene
    x = 1  # spjoin-lint-torch: allow[host-sync] -- nothing on this line reads the device
    # expect-next: waiver-hygiene
    y = 2  # spjoin-lint-torch: allow[no-such-rule] -- a rule name the checker does not know
    return x + y
