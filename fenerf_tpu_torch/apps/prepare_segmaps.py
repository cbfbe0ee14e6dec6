"""Label face photos with CelebA-style parsing maps on the port
(counterpart of fenerf_tpu/apps/prepare_segmaps.py).

Reference: prepare_segmaps.py — BiSeNet(20) parses FFHQ-style images; the
labels are remapped to the CelebAMask-HQ 19-class scheme and written beside
the images for training, or as inversion targets.

Images (JPEG as PIL decodes them, or PNG) are decoded by the port's codec
(data/native_loader.py::read_image), resized to --size by the PIL-exact
bilinear (utils/image.py::resize), parsed one at a time on the card
(nn/bisenet.py), the argmax taken there; the grey label PNG and, with
--colorize, a palette preview are written per image. --weights is the
reference's segNet-20Class.pth (a torch state_dict), which the repository
does not carry.

Usage:
  python -m fenerf_tpu_torch.apps.prepare_segmaps --images 'photos/*.jpg' \
      --output_dir masks --weights segNet-20Class.pth [--colorize] \
      [--size 512] [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True, help="glob of input images")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--weights", required=True,
                   help="path to segNet-20Class.pth (torch state_dict)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--colorize", action="store_true",
                   help="also write palette-colorized previews")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises if CUDA is requested and "
                        "absent)")
    args = p.parse_args(argv)

    if not os.path.exists(args.weights):
        raise SystemExit(
            f"parsing weights not found at {args.weights}; obtain "
            "segNet-20Class.pth from the FENeRF release (README.md)")

    import numpy as np
    import torch

    from fenerf_tpu_torch.data.native_loader import read_image
    from fenerf_tpu_torch.nn.bisenet import (bisenet_apply, load_bisenet,
                                             remap_labels)
    from fenerf_tpu_torch.utils.image import resize, save_png
    from fenerf_tpu_torch.utils.mask_tools import colorize

    t_all = time.perf_counter()
    dev = torch.device(args.device)
    params = load_bisenet(args.weights, dev)
    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(glob.glob(args.images))
    model_ms = []
    for f in files:
        x = resize(read_image(f, "RGB"), (args.size, args.size),
                   "bilinear")[None].astype(np.float32) / 255.0
        x = (x.transpose(0, 3, 1, 2) - 0.5) / 0.5
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            seg = torch.argmax(bisenet_apply(params, x), dim=1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        model_ms.append((time.perf_counter() - t0) * 1e3)
        s = remap_labels(seg[0].to(torch.uint8).cpu().numpy())
        stem = os.path.splitext(os.path.basename(f))[0]
        save_png(os.path.join(args.output_dir, f"{stem}.png"), s)
        if args.colorize:
            save_png(os.path.join(args.output_dir, f"{stem}_color.png"),
                     colorize(s))
    seconds = time.perf_counter() - t_all
    print(f"parsed {len(files)} images -> {args.output_dir}")
    # per image: the model's ms (synchronized), and the whole run's s
    return {"files": files, "model_ms": model_ms, "seconds": seconds}


if __name__ == "__main__":
    main()
