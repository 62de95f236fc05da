"""Serve a small LM with batched requests through the engine (counterpart
of the JAX package's ``examples/serve_batched.py``; the paper's
latency-measurement methodology: consecutive step-to-step intervals).

Four requests of 12 tokens, 24 new tokens each, through the serving CLI at
the config's ``SMOKE`` size: qwen3-0.6b by default, or any transformer
config with ``--arch`` (the MoE family's ``qwen2-moe-a2.7b`` among them)::

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch qwen2-moe-a2.7b --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    return serve_main(["--arch", args.arch, "--smoke", "--requests", "4",
                       "--prompt-len", "12", "--max-new", "24",
                       "--device", args.device])


if __name__ == "__main__":
    main()
