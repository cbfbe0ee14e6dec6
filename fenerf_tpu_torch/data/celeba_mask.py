"""Image(+mask) datasets and the host input pipeline (port of
fenerf_tpu/data/celeba_mask.py, without PIL).

Reference behaviour (datasets.py):
  * CelebAMaskHQ_wo_background_seg_18 (:465-549): paired jpg/png under
    <root>/celebahq_mask_img, <root>/celebahq_mask_mask; image Resize(320)
    -> CenterCrop(256) -> Resize(img_size) -> [-1, 1]; the mask NEAREST
    through the same geometry; background pixels zeroed when
    background_mask; paired random hflip; the mask as 18 one-hot channels
    in [-1, 1].
  * CelebA (:20-41): jpg glob, the same geometry, hflip.
  * get_dataset_distributed (:96-114): a per-host share of the examples
    and an explicit epoch seed.

Images are decoded by the port's native codec (data/native_loader.py:
baseline JPEG and PNG, equal to PIL's decode) and resized by
utils/image.py's PIL-exact resizes, so the items equal the JAX package's.
`iterate_batches` draws the same permutations and flips from the same
numpy seeds as the JAX loader and builds the batches in a DataLoader's
worker processes, off the process whose host thread drives the step.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Iterator

import numpy as np
from torch.utils.data import DataLoader, Dataset

from fenerf_tpu_torch.data.native_loader import read_image
from fenerf_tpu_torch.utils.image import resize


def _prep(img: np.ndarray, img_size: int, nearest: bool) -> np.ndarray:
    """(H, W[, C]) uint8 -> (img_size, img_size[, C]) uint8: the short side
    scaled to 320 (round(w * scale), as Python rounds), the centre 256
    square, then img_size."""
    method = "nearest" if nearest else "bilinear"
    h, w = img.shape[:2]
    scale = 320 / min(w, h)
    img = resize(img, (round(w * scale), round(h * scale)), method)
    h, w = img.shape[:2]
    left, top = (w - 256) // 2, (h - 256) // 2
    img = img[top:top + 256, left:left + 256]
    return resize(img, (img_size, img_size), method)


def one_hot_labels(mask: np.ndarray, n: int = 18,
                   include_background: bool = False) -> np.ndarray:
    """mask (H, W) int -> (n, H, W) one-hot.

    include_background=False: labels 1..n (background dropped), as
    CelebAMaskHQ_wo_background_seg_18._mask_labels (datasets.py:518-523).
    include_background=True: labels 0..n-1 (background as channel 0), as
    CelebAMaskHQ._mask_labels (datasets.py:165-172, 19 channels).
    """
    out = np.zeros((n,) + mask.shape, dtype=np.float32)
    off = 0 if include_background else 1
    for i in range(n):
        out[i][mask == i + off] = 1.0
    return out


def _to_chw(img: np.ndarray) -> np.ndarray:
    x = np.asarray(img, dtype=np.float32) / 255.0
    return (x.transpose(2, 0, 1) - 0.5) / 0.5


class CelebAMaskDataset:
    """Paired image + 18-channel mask dataset (joint RGB + semantic
    training)."""

    def __init__(self, dataset_path: str, img_size: int,
                 background_mask: bool = True, seg_channels: int = 18,
                 seg_background: bool = False, img_nearest: bool = False,
                 img_glob: str = "celebahq_mask_img/*.jpg",
                 mask_glob: str = "celebahq_mask_mask/*.png"):
        self.images = sorted(glob.glob(os.path.join(dataset_path, img_glob)))
        self.masks = sorted(glob.glob(os.path.join(dataset_path, mask_glob)))
        assert len(self.images) == len(self.masks), (
            f"{len(self.images)} images vs {len(self.masks)} masks")
        assert self.images, f"no data under {dataset_path}"
        self.img_size = img_size
        self.background_mask = background_mask
        self.seg_channels = seg_channels
        self.seg_background = seg_background
        self.img_nearest = img_nearest

    def __len__(self):
        return len(self.images)

    def _finish(self, img_hw3_u8, mask_hw_u8, flip):
        x = _to_chw(img_hw3_u8)
        m = np.asarray(mask_hw_u8)
        if flip:
            x = x[:, :, ::-1].copy()
            m = m[:, ::-1].copy()
        labels = one_hot_labels(m, self.seg_channels,
                                self.seg_background) * 2.0 - 1.0
        return x, labels

    def __getitem__(self, index: int, flip: bool = False):
        img = read_image(self.images[index], "RGB")
        mask = read_image(self.masks[index], "L")
        if self.background_mask:
            # the mask NEAREST-resized to the image, at the image's size
            m = resize(mask, (img.shape[1], img.shape[0]), "nearest")
            img = img.copy()
            img[m == 0] = 0
        img = _prep(img, self.img_size, nearest=self.img_nearest)
        mask = _prep(mask, self.img_size, nearest=True)
        return self._finish(img, mask, flip)


class CelebADataset:
    """RGB-only dataset of the single-latent pi-GAN curriculum
    (datasets.py:20-41)."""

    def __init__(self, dataset_path: str, img_size: int, **_):
        self.images = sorted(glob.glob(dataset_path))
        assert self.images, f"no data under {dataset_path}"
        self.img_size = img_size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int, flip: bool = False):
        x = _to_chw(_prep(read_image(self.images[index], "RGB"),
                          self.img_size, nearest=False))
        if flip:
            x = x[:, :, ::-1].copy()
        return x, np.zeros((0, self.img_size, self.img_size), np.float32)


class SimpleImageDataset:
    """Direct-resize RGB datasets: Cats (hflip) / Carla (no flip)
    (datasets.py:43-80), NEAREST straight to img_size."""

    def __init__(self, dataset_path: str, img_size: int, hflip: bool = True,
                 **_):
        self.images = sorted(glob.glob(dataset_path))
        assert self.images, f"no data under {dataset_path}"
        self.img_size = img_size
        self.hflip = hflip

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int, flip: bool = False):
        img = resize(read_image(self.images[index], "RGB"),
                     (self.img_size, self.img_size), "nearest")
        x = _to_chw(img)
        if flip and self.hflip:
            x = x[:, :, ::-1].copy()
        return x, np.zeros((0, self.img_size, self.img_size), np.float32)


DATASETS = {
    "CelebAMaskHQ_wo_background_seg_18": CelebAMaskDataset,
    # the 19-channel variant KEEPS the background as channel 0 (labels
    # 0..18, datasets.py:141-173) and resizes images NEAREST (:124-128)
    "CelebAMaskHQ": lambda dataset_path, img_size, **kw: CelebAMaskDataset(
        dataset_path, img_size,
        **{**kw, "seg_channels": 19, "seg_background": True,
           "img_nearest": True}),
    # the single-image overfit / debug variant: ONE fixed demo pair
    # (datasets.py:551-634)
    "CelebAMaskHQ_single_image_wo_background_seg_18":
        lambda dataset_path, img_size, **kw: CelebAMaskDataset(
            dataset_path, img_size,
            **{**kw, "img_glob": "demo_mask_img/97.jpg",
               "mask_glob": "demo_mask_mask/97.png"}),
    "CelebA": CelebADataset,
    "Cats": SimpleImageDataset,
    "Carla": lambda dataset_path, img_size, **kw: SimpleImageDataset(
        dataset_path, img_size, hflip=False, **kw),
}


def make_dataset(name: str, dataset_path: str, img_size: int, **kw):
    return DATASETS[name](dataset_path=dataset_path, img_size=img_size, **kw)


class _JaxOrder:
    """The JAX loader's batches, without end, as lists of (index, flip)
    pairs: the permutation of epoch e from RandomState(seed + e), this
    host's share of it, the flips from one RandomState per host drawn per
    epoch; the first `skip` batches dropped unread."""

    def __init__(self, n, batch_size, seed, host_index, n_hosts, skip):
        self.n, self.batch_size, self.seed = n, batch_size, seed
        self.host_index, self.n_hosts, self.skip = host_index, n_hosts, skip

    def __iter__(self):
        bs = self.batch_size
        rng = np.random.RandomState(self.seed + 7919 * self.host_index)
        skipped, epoch = 0, 0
        while True:
            order = np.random.RandomState(self.seed + epoch).permutation(
                self.n)[self.host_index::self.n_hosts]
            flips = rng.rand(len(order)) > 0.5
            for s in range(0, len(order) - bs + 1, bs):
                if skipped < self.skip:
                    skipped += 1
                    continue
                yield [(int(i), bool(f)) for i, f in
                       zip(order[s:s + bs], flips[s:s + bs])]
            epoch += 1


class _Batches(Dataset):
    """A whole batch per index: (images, labels, its host seconds)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, pairs):
        t0 = time.perf_counter()
        items = [self.dataset.__getitem__(i, flip=f) for i, f in pairs]
        return (np.stack([it[0] for it in items]),
                np.stack([it[1] for it in items]),
                time.perf_counter() - t0)


def _as_is(batch):
    return batch


def iterate_batches(
    dataset,
    batch_size: int,
    seed: int = 0,
    host_index: int = 0,
    n_hosts: int = 1,
    skip: int = 0,
    timings: list | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled, host-sharded, flip-augmented batches of (imgs, labels):
    the JAX loader's batches for the same arguments. A DataLoader builds
    each batch in one of up to 8 worker processes (a core left free for
    the process that drives the device; forked from multiprocessing's fork
    server, so a script that iterates must guard its entry with
    `if __name__ == "__main__"`), stopped when the iterator closes. `skip`
    drops the first batches unread (a resumed run); `timings`, when given,
    receives each batch's host time in its worker, in seconds."""
    loader = DataLoader(
        _Batches(dataset),
        sampler=_JaxOrder(len(dataset), batch_size, seed, host_index,
                          n_hosts, skip),
        batch_size=None, collate_fn=_as_is,
        num_workers=max(1, min((os.cpu_count() or 2) - 1, 8)),
        multiprocessing_context="forkserver")
    batches = iter(loader)
    try:
        for imgs, labels, seconds in batches:
            if timings is not None:
                timings.append(seconds)
            yield imgs, labels
    finally:
        del batches   # stops the worker processes
