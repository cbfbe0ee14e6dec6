"""Replay a mask-edit session log into a video on the port (counterpart
of fenerf_tpu/apps/edit_log_video.py).

Reference: Painter/converter_log_to_video.py — replays the PyQt painter's
stroke / rect / fill event log into colorized frames. apps/paint_ui.py
records the session as mask snapshots (one per completed edit, the .npz of
--edit_log); the replay colorizes each snapshot, which reproduces the
visible editing timeline whatever the event model.

Usage:
  python -m fenerf_tpu_torch.apps.edit_log_video --log sess.editlog.npz \
      --out sess.avi [--fps 4] [--hold 6] [--side img.png]

--hold repeats the final frame so that the result lingers; --side
composites an RGB image (e.g. the inversion's last render, resized by the
PIL-exact bilinear) beside each mask frame, as the reference converter's
side-by-side output. The video is utils/video.py's uncompressed AVI (the
JAX package writes mp4 through cv2).
"""
from __future__ import annotations

import argparse

import numpy as np

from fenerf_tpu_torch.utils.image import resize
from fenerf_tpu_torch.utils.mask_tools import colorize
from fenerf_tpu_torch.utils.video import write_avi


def log_to_frames(frames_u8: np.ndarray, side: np.ndarray | None = None,
                  hold: int = 6) -> list[np.ndarray]:
    """(N, H, W) uint8 label maps -> list of (H, W[, +W], 3) uint8
    frames."""
    out = []
    for m in frames_u8:
        f = colorize(m).astype(np.uint8)
        if side is not None:
            s = side
            if s.shape[:2] != f.shape[:2]:
                s = resize(s, (f.shape[1], f.shape[0]), "bilinear")
            f = np.concatenate([f, s], axis=1)
        out.append(f)
    out.extend([out[-1]] * max(hold - 1, 0))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--log", required=True,
                   help=".npz from paint_ui --edit_log")
    p.add_argument("--out", default=None, help="avi path (default <log>.avi)")
    p.add_argument("--fps", type=int, default=4)
    p.add_argument("--hold", type=int, default=6,
                   help="repeat the final frame this many times")
    p.add_argument("--side", default=None,
                   help="optional RGB image composited beside each frame")
    args = p.parse_args(argv)

    with np.load(args.log) as log:
        frames = log["frames"]
    side = None
    if args.side:
        from fenerf_tpu_torch.data.native_loader import read_image

        side = read_image(args.side, "RGB")
    out = args.out or args.log.rsplit(".", 1)[0] + ".avi"
    video = log_to_frames(frames, side, args.hold)
    write_avi(out, video, fps=args.fps)
    print(f"wrote {out} ({len(frames)} edit states)")
    return out, video


if __name__ == "__main__":
    main()
