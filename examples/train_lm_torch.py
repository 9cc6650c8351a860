"""Train a reduced-config LM end-to-end with the port's launcher —
checkpointing, deterministic data, resumable. Any of the 10 architectures
via --arch; on the card unless --device cpu.

    PYTHONPATH=src python examples/train_lm_torch.py --arch xlstm-1.3b
    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen1.5-0.5b --device cpu

(Equivalent to: python -m repro_torch.launch.train --arch <a> --reduced
--steps 60 --ckpt-dir runs/example_ckpt_torch --ckpt-every 30 --log-every
10; any of the launcher's arguments given here replaces its default.)
"""
import sys

from repro_torch.launch import train

DEFAULTS = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "60",
            "--ckpt-dir", "runs/example_ckpt_torch", "--ckpt-every", "30", "--log-every", "10"]

if __name__ == "__main__":
    train.train(train.parse_args(DEFAULTS + sys.argv[1:]))
