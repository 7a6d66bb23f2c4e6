"""End-to-end LM training on the PyTorch/CUDA port (``train_lm.py``'s
counterpart): a reduced tinyllama-family model on the synthetic pipeline
for a few hundred steps, with checkpoints and a crash-resume
demonstration.  The same driver trains the full configs
(``repro_torch.launch.train``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]  # H100
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

``--steps``, ``--batch`` and ``--seq`` shrink the run; the checkpoints go
to a temporary directory, removed at the end.
"""
import argparse
import shutil
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    common = ["--arch", args.arch, "--reduced", "--batch", str(args.batch),
              "--seq", str(args.seq), "--save-every", "25", "--device",
              args.device]

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        print("=== phase 1: train to half way, checkpointing ===")
        train_mod.main(common + ["--steps", str(args.steps // 2),
                                 "--ckpt-dir", ckpt_dir])
        print("=== phase 2: resume from checkpoint and finish ===")
        out = train_mod.main(common + ["--steps", str(args.steps),
                                       "--ckpt-dir", ckpt_dir, "--resume"])
        assert out["start_step"] == args.steps // 2, out
        assert out["last_loss"] < out["first_loss"], out
        print("loss decreased across the resume boundary ✓")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
