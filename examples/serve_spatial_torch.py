"""End-to-end spatial query service on the PyTorch/CUDA port
(``serve_spatial.py``'s counterpart): build a partitioned R-tree fleet,
serve batches of range queries with straggler re-issue, report
throughput.

    PYTHONPATH=src python examples/serve_spatial_torch.py               # H100
    PYTHONPATH=src python examples/serve_spatial_torch.py --device cpu  # twins

``--n``, ``--partitions``, ``--batches`` and ``--batch-size`` shrink the
run.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = serve.main(["--n", str(args.n), "--partitions",
                      str(args.partitions), "--batches", str(args.batches),
                      "--batch-size", str(args.batch_size),
                      "--selectivity", "0.001", "--device", args.device])
    assert out["qps"] > 0
    return out


if __name__ == "__main__":
    main()
