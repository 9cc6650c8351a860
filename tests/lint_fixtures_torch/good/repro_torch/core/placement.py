"""Fixture: a host numpy planner keeps float64 (not a step scope)."""
import numpy as np


def plan_loads(loads) -> np.ndarray:
    return np.asarray(loads, dtype=np.float64) / 2.0
