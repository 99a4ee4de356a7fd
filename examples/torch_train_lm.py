"""End-to-end LM training on the port (twin of examples/train_lm.py).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

Trains the reduced qwen2-0.5b config for a few hundred steps on the
synthetic Zipf corpus with ``repro_torch.launch.train``: checkpoints every
100 steps, resume with ``--resume`` — the same launcher ``chip_smoke.py``
drives at full width on the card.  It runs on ``cuda`` unless
``--device cpu`` asks for the CPU.  Checkpoints go to ``--ckpt``, by
default a new temporary directory.
"""
import argparse
import tempfile

from repro_torch.core import fm
from repro_torch.launch import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="torch_train_lm_")
    with fm.conf(device=args.device):
        losses = train.main([
            "--arch", "qwen2-0.5b", "--reduced",
            "--steps", str(args.steps),
            "--batch", "16", "--seq", "256",
            "--ckpt-dir", ckpt, "--ckpt-every", "100",
            "--log-every", "20"] + (["--resume"] if args.resume else []))
    print(f"checkpoints in {ckpt}; loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          if losses else f"nothing to run past step {args.steps} in {ckpt}")


if __name__ == "__main__":
    main()
