"""Step functions, the optimizer and checkpoints (the port of ``repro.train``)."""
from repro_torch.train import train_step  # noqa: F401
