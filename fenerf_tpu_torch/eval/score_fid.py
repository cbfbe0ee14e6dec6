"""Standalone FID scorer on the port (counterpart of
fenerf_tpu/eval/score_fid.py): the FID between two directories of PNGs
through InceptionV3 (nn/inception.py) on one device. Prints ONE JSON line
{"fid", "images", "score_s", "device"}.

The trainer (apps/train.py) scores in-process on its own device, so this
CLI is for scoring a finished run's `evaluation/` directories.

Usage:
  python -m fenerf_tpu_torch.eval.score_fid --real out/evaluation/real \
      --gen out/evaluation/generated [--weights inception.npz] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--real", required=True)
    p.add_argument("--gen", required=True)
    p.add_argument("--weights", default=None,
                   help="inception .npz (default: $FENERF_INCEPTION_WEIGHTS)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    args = p.parse_args(argv)

    from fenerf_tpu_torch.eval import fid as fidlib

    n = (len(glob.glob(os.path.join(args.real, "*.png")))
         + len(glob.glob(os.path.join(args.gen, "*.png"))))
    t0 = time.perf_counter()
    fid = fidlib.calculate_fid(
        args.real, args.gen,
        feature_fn=fidlib.inception_features(args.weights, args.device),
        batch_size=args.batch)
    out = {"fid": fid, "images": n,
           "score_s": round(time.perf_counter() - t0, 3),
           "device": args.device}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
