"""Quality metrics between two image directories on the port: FID, KID and
IS (counterpart of fenerf_tpu/apps/eval_metrics.py).

Reference: eval_metrics.py (torch-fidelity over a generated directory
against a real one). The metric math is eval/fid.py's and
eval/metrics.py's on the host; the features are InceptionV3's pool3 on
the card (nn/inception.py, weights from $FENERF_INCEPTION_WEIGHTS), or
with --feature_extractor stub the images' pixels at every 8th row and
column (pipeline checks only). As in the JAX package, IS reads the same
features as logits. The PNGs are read by the port's reader.

Usage:
  python -m fenerf_tpu_torch.apps.eval_metrics --real_dir real \
      --gen_dir gen [--metrics fid kid isc] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--real_dir", required=True)
    p.add_argument("--gen_dir", required=True)
    p.add_argument("--metrics", nargs="+", default=["fid", "kid"],
                   choices=["fid", "kid", "isc"])
    p.add_argument("--feature_extractor", default="inception",
                   choices=["inception", "stub"],
                   help="stub = raw downsampled pixels (pipeline checks only)")
    p.add_argument("--kid_subsets", type=int, default=100)
    p.add_argument("--kid_subset_size", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the Inception features (raises if "
                        "CUDA is requested and absent)")
    args = p.parse_args(argv)

    import numpy as np

    from fenerf_tpu_torch.eval import fid as fidlib
    from fenerf_tpu_torch.eval import metrics as M

    t0 = time.perf_counter()
    if args.feature_extractor == "inception":
        feature_fn = fidlib.inception_features(device=args.device)
    else:
        def feature_fn(imgs):
            x = imgs[:, ::8, ::8, :]
            return x.reshape(x.shape[0], -1)

    feats = {}
    for name, d in (("real", args.real_dir), ("gen", args.gen_dir)):
        imgs = fidlib._load_images(d)
        feats[name] = np.concatenate([
            np.asarray(feature_fn(imgs[i:i + 64]))
            for i in range(0, len(imgs), 64)])

    out = {}
    if "fid" in args.metrics:
        out["fid"] = fidlib.fid_from_features(feats["real"], feats["gen"])
    if "kid" in args.metrics:
        mean, std = M.kid(feats["real"], feats["gen"],
                          n_subsets=args.kid_subsets,
                          subset_size=args.kid_subset_size)
        out["kid_mean"], out["kid_std"] = mean, std
    if "isc" in args.metrics:
        mean, std = M.inception_score(feats["gen"])
        out["isc_mean"], out["isc_std"] = mean, std
    print(json.dumps(out))
    print(f"[eval_metrics] {len(feats['real'])} real, {len(feats['gen'])} "
          f"generated images in {time.perf_counter() - t0:.2f} s")
    return out


if __name__ == "__main__":
    main()
