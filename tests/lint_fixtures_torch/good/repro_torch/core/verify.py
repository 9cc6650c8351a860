"""Fixture: verify_cell_lists at exactly its budget of 7 sync sites; the
reads outside the loops are not counted."""
import numpy as np
import torch

Tensor = torch.Tensor


def verify_cell_lists(data: Tensor, v_lists, w_lists, delta: float):
    band = float(data.abs().max())
    out = []
    for v_idx, w_idx in zip(v_lists, w_lists):
        v_idx = np.asarray(v_idx, np.int64)
        n_v = int(v_idx.size)
        v_pos = torch.as_tensor(v_idx, device=data.device)
        w_pos = torch.as_tensor(np.asarray(w_idx), device=data.device)
        for t in range(0, n_v, 4):
            rows = data.index_select(0, v_pos)
            cand = rows.abs().amax(-1) <= delta
            n = int(cand.sum())
            counts = rows.sum(0).tolist()
            vi = torch.nonzero(cand)
            keep = rows[:, 0] > 0
            out.append(rows[keep])
            out.append(w_pos[keep])
            out.append((n, counts, vi, int(vi.numel())))
    return out, band
