"""Fixture: host-sync constructs inside a step scope (moe_block) and in a
function it calls."""
import numpy as np
import torch

Tensor = torch.Tensor


def _positive(x: Tensor) -> Tensor:
    return x[x > 0]  # expect: host-sync


def moe_block(params: dict, x: Tensor, cfg, group_size: int = 2048):
    n = x.sum().item()  # expect: host-sync
    top = x.amax(-1).tolist()  # expect: host-sync
    host = x.cpu()  # expect: host-sync
    arr = x.detach().numpy()  # expect: host-sync
    torch.cuda.synchronize()  # expect: host-sync
    idx = torch.nonzero(x > 0)  # expect: host-sync
    k = int(x.max())  # expect: host-sync
    if x.sum() > 0:  # expect: host-sync
        x = x * 2
    ids = torch.as_tensor(np.arange(4), device=x.device)  # expect: host-sync
    return _positive(x), (n, top, host, arr, idx, k, ids)
