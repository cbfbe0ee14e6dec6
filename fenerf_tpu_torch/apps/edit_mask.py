"""Headless segmentation-map editor on the port (counterpart of
fenerf_tpu/apps/edit_mask.py): the painter's edits, scripted.

  python -m fenerf_tpu_torch.apps.edit_mask mask.png edited.png \
      --op remove:hat --op switch:left_eye:right_eye \
      --op scale:hair:1.3 --op simplify --colorize

then run apps/invert.py with --seg_path edited.png. Label maps are read
as PIL's convert("L") gives them (data/native_loader.py::read_image) and
written as grey PNGs (utils/image.py::encode_png); host-only, numpy and
scipy.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--op", action="append", default=[],
                   help="remove:CLS[:FILL] | switch:A:B | scale:CLS:FACTOR | "
                        "rect:CLS:x0:y0:x1:y1 | simplify | "
                        "transfer:CLS[,CLS..]:REF.png[:DY:DX] (paste CLS "
                        "regions from another mask, reference tools.py "
                        "switch_semantic :499)")
    p.add_argument("--colorize", action="store_true",
                   help="also write a palette-colorized preview")
    args = p.parse_args(argv)

    import numpy as np

    from fenerf_tpu_torch.data.native_loader import read_image
    from fenerf_tpu_torch.utils import mask_tools as mt
    from fenerf_tpu_torch.utils.image import save_png

    def cls(name: str) -> int:
        return mt.LABELS[name] if not name.isdigit() else int(name)

    def read_labels(path: str) -> np.ndarray:
        return read_image(path, "L")

    mask = read_labels(args.input)
    for op in args.op:
        parts = op.split(":")
        kind = parts[0]
        if kind == "remove":
            fill = cls(parts[2]) if len(parts) > 2 else mt.LABELS["skin"]
            mask = mt.remove_semantic(mask, cls(parts[1]), fill)
        elif kind == "switch":
            mask = mt.switch_semantic(mask, cls(parts[1]), cls(parts[2]))
        elif kind == "scale":
            mask = mt.scale_semantic(mask, cls(parts[1]), float(parts[2]))
        elif kind == "rect":
            region = np.zeros(mask.shape, bool)
            x0, y0, x1, y1 = map(int, parts[2:6])
            region[y0:y1, x0:x1] = True
            mask = mt.add_semantic(mask, cls(parts[1]), region)
        elif kind == "transfer":
            labels = tuple(cls(c) for c in parts[1].split(","))
            dy = int(parts[3]) if len(parts) > 3 else 0
            dx = int(parts[4]) if len(parts) > 4 else 0
            mask = mt.transfer_semantic(mask, read_labels(parts[2]), labels,
                                        (dy, dx))
        elif kind == "simplify":
            mask = mt.simplify_mask(mask)
        else:
            raise SystemExit(f"unknown op {kind!r}")

    save_png(args.output, mask.astype(np.uint8))
    if args.colorize:
        save_png(args.output.rsplit(".", 1)[0] + "_color.png",
                 mt.colorize(mask))
    print(f"wrote {args.output}")
    return mask


if __name__ == "__main__":
    main()
