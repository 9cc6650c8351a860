"""Batched LM serving on the GPU with the PyTorch port: prefill by decode,
then greedy decode against the bf16 KV cache.

    PYTHONPATH=src python examples/serve_lm_torch.py                    # on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch granite-34b --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-2.7b --device cpu

Every decoder of the zoo serves: the dense, vlm, moe (deepseek-moe-16b,
llama4-scout-17b-a16e), hybrid (zamba2-2.7b) and ssm (xlstm-1.3b) families.

(Equivalent to: python -m repro_torch.launch.serve --arch <a> --reduced ...)
"""
import sys

sys.argv = [sys.argv[0]] + (sys.argv[1:] or ["--arch", "qwen1.5-0.5b"]) + [
    "--reduced", "--batch", "4", "--prompt-len", "16", "--gen", "24",
]
if "--arch" not in sys.argv:
    sys.argv += ["--arch", "qwen1.5-0.5b"]
from repro_torch.launch.serve import main

main()
