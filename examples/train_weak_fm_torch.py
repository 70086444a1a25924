"""Train a zoo architecture (reduced config) with the PyTorch port's
training substrate: the port's twin of ``examples/train_weak_fm.py``, on
the card by default. Pick any of the 10 assigned architectures.

    PYTHONPATH=src python examples/train_weak_fm_torch.py --arch olmo-1b \\
        --steps 200 --batch 8 --seq 64 [--device cpu]
"""
import argparse

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=".cache/example_weak_fm_torch.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    metrics = train(args.arch, smoke=True, steps=args.steps,
                    batch=args.batch, seq=args.seq, lr=1e-3, ckpt=args.ckpt,
                    device=args.device)
    print(f"final metrics: {metrics}")
    assert metrics["loss"] < 4.0, "loss should have dropped well below init"


if __name__ == "__main__":
    main()
