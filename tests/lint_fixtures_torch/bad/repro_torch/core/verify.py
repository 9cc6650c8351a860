"""Fixture: stream scopes off their budgets. verify_cell_lists has one
sync site more than its budget of 7; _flush_window_batch one fewer than
its budget of 4 (the ratchet asks for the budget to come down)."""
import numpy as np
import torch

Tensor = torch.Tensor


def verify_cell_lists(data: Tensor, v_lists, w_lists, delta: float):  # expect: host-sync
    out = []
    for v_idx, w_idx in zip(v_lists, w_lists):
        v_pos = torch.as_tensor(np.asarray(v_idx), device=data.device)
        w_pos = torch.as_tensor(np.asarray(w_idx), device=data.device)
        for t in range(4):
            rows = data.index_select(0, v_pos)
            cand = rows.abs().amax(-1) <= delta
            n = int(cand.sum())
            counts = rows.sum(0).tolist()
            vi = torch.nonzero(cand)
            keep = rows[:, 0] > 0
            out.append(rows[keep])
            out.append(w_pos[keep])
            out.append(rows.max().item())
            out.append((n, counts, vi))
    return out


def _flush_window_batch(pending, delta: float):  # expect: host-sync
    hits = []
    for tiles in pending:
        x = torch.stack(tiles)
        close = x <= delta
        hits.append(torch.nonzero(close))
        hits.append(x[close])
        hits.append(int(x.sum()))
    return hits
