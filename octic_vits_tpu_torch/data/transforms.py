"""Host-side image transforms, PIL + numpy, NHWC float32 output (the port's
own copy of octic_vits_tpu/data/transforms.py: the same images and seeds give
the same arrays, bit for bit).

Covers the three reference pipelines:
* eval: Resize(size/crop_ratio, bicubic) -> CenterCrop -> normalize
  (reference: deit/datasets.py:113-136)
* DeiT III "3-Augment": RRC + hflip + choice(grayscale/solarize/blur) +
  color jitter (reference: deit/augment.py:90-123)
* DINOv2 multi-crop: 2 global + N local crops with blur/solarize recipe
  (reference: dinov2/data/augmentations.py:19-118)

Plus the equivariance stress transforms (`rotate90`, `hflip`) used by
`--rot-eval` / `--flop-eval` (reference: deit/datasets.py:119-132).

PIL is imported inside the functions that use it, so that importing the
package needs no PIL.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _bicubic():
    from PIL import Image

    return Image.BICUBIC


class PerSampleRng:
    """Wrap a transform `fn(img, rng=...)` with a per-sample derived RNG.

    The RNG is seeded from (seed, epoch, index), so augmentation is a pure
    function of those three: deterministic under any loader-worker
    scheduling and across preemption resumes (reference:
    dinov2/data/loaders.py:166-222 seeds its workers for the same reason).
    """

    wants_index = True  # datasets pass index= when they see this

    def __init__(self, fn, seed: int = 0):
        self.fn = fn
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __call__(self, img, index: int = 0):
        # explicit integer mix (random.Random takes no tuple seeds, and this
        # stays stable across interpreter runs, unlike hash())
        derived = (self.seed * 1_000_003 + self.epoch) * 1_000_003 + index
        return self.fn(img, rng=random.Random(derived))


def to_normalized_array(img) -> np.ndarray:
    """PIL -> float32 normalized [H, W, 3]."""
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def to_uint8_array(img) -> np.ndarray:
    """PIL -> uint8 [H, W, 3]."""
    return np.asarray(img.convert("RGB"), np.uint8)


def resize_center_crop(img, size: int, crop_ratio: float = 0.875):
    resize_to = int(size / crop_ratio)
    w, h = img.size
    if w < h:
        nw, nh = resize_to, int(resize_to * h / w)
    else:
        nw, nh = int(resize_to * w / h), resize_to
    img = img.resize((nw, nh), _bicubic())
    left = (nw - size) // 2
    top = (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def eval_transform(img, size: int = 224, crop_ratio: float = 0.875):
    return to_normalized_array(resize_center_crop(img, size, crop_ratio))


def rrc_box(w: int, h: int, scale: Tuple[float, float], rng: random.Random,
            ratio=(3 / 4, 4 / 3)) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling -> (left, top, cw, ch)."""
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = (math.log(ratio[0]), math.log(ratio[1]))
        r = math.exp(rng.uniform(*log_r))
        cw = int(round(math.sqrt(target * r)))
        ch = int(round(math.sqrt(target / r)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return left, top, cw, ch
    s = min(w, h)
    return (w - s) // 2, (h - s) // 2, s, s


def random_resized_crop(img, size: int, scale: Tuple[float, float], rng: random.Random,
                        ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics, bicubic."""
    w, h = img.size
    left, top, cw, ch = rrc_box(w, h, scale, rng, ratio)
    return img.resize((size, size), _bicubic(), box=(left, top, left + cw, top + ch))


def gaussian_blur(img, rng: random.Random, radius_range=(0.1, 2.0)):
    from PIL import ImageFilter

    return img.filter(ImageFilter.GaussianBlur(rng.uniform(*radius_range)))


def sample_jitter(rng: random.Random, brightness=0.0, contrast=0.0, saturation=0.0,
                  hue=0.0) -> Tuple[List[int], List[float]]:
    """ColorJitter parameter sampling: op codes (0 brightness, 1 contrast,
    2 saturation, 3 hue) in random order + matching factors."""
    ops: List[int] = []
    facs: List[float] = []
    if brightness > 0:
        ops.append(0)
        facs.append(rng.uniform(max(0, 1 - brightness), 1 + brightness))
    if contrast > 0:
        ops.append(1)
        facs.append(rng.uniform(max(0, 1 - contrast), 1 + contrast))
    if saturation > 0:
        ops.append(2)
        facs.append(rng.uniform(max(0, 1 - saturation), 1 + saturation))
    if hue > 0:
        ops.append(3)
        facs.append(rng.uniform(-hue, hue))
    order = list(range(len(ops)))
    rng.shuffle(order)
    return [ops[i] for i in order], [facs[i] for i in order]


def apply_jitter_pil(img, ops: List[int], facs: List[float]):
    from PIL import Image, ImageEnhance

    for op, f in zip(ops, facs):
        if op == 0:
            img = ImageEnhance.Brightness(img).enhance(f)
        elif op == 1:
            img = ImageEnhance.Contrast(img).enhance(f)
        elif op == 2:
            img = ImageEnhance.Color(img).enhance(f)
        else:
            hsv = np.asarray(img.convert("HSV"), np.uint8).copy()
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(f * 255)) % 256
            img = Image.fromarray(hsv, "HSV").convert("RGB")
    return img


def color_jitter(img, rng: random.Random, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
    """torchvision ColorJitter analog (random order of the four ops)."""
    ops, facs = sample_jitter(rng, brightness, contrast, saturation, hue)
    return apply_jitter_pil(img, ops, facs)


def random_erasing(arr: np.ndarray, rng: random.Random, reprob: float = 0.0,
                   mode: str = "pixel", count: int = 1) -> np.ndarray:
    """timm RandomErasing analog, applied after normalization (reference:
    deit/main.py:130-137; the DeiT III recipe sets reprob=0.0). `mode`:
    'pixel' fills with per-pixel standard-normal noise, 'const' with zeros."""
    if reprob <= 0 or rng.random() > reprob:
        return arr
    h, w, c = arr.shape
    out = arr.copy()
    npr = np.random.RandomState(rng.randrange(2 ** 31))
    for _ in range(count):
        for _attempt in range(10):
            area = h * w * rng.uniform(0.02, 1 / 3) / count
            ratio = math.exp(rng.uniform(math.log(0.3), math.log(10 / 3)))
            eh = int(round(math.sqrt(area * ratio)))
            ew = int(round(math.sqrt(area / ratio)))
            if 0 < eh < h and 0 < ew < w:
                top = rng.randint(0, h - eh)
                left = rng.randint(0, w - ew)
                if mode == "pixel":
                    patch = npr.normal(size=(eh, ew, c)).astype(out.dtype)
                else:
                    patch = np.zeros((eh, ew, c), out.dtype)
                out[top:top + eh, left:left + ew] = patch
                break
    return out


def three_augment(img, size: int = 224, rng: Optional[random.Random] = None,
                  color_jitter_strength: float = 0.3, src: bool = False, reprob: float = 0.0,
                  remode: str = "pixel", recount: int = 1) -> np.ndarray:
    """DeiT III 3-Augment (reference: deit/augment.py:90-123)."""
    from PIL import Image, ImageOps

    rng = rng or random
    if src:
        # simple-random-crop variant: resize + pad-reflect random crop
        img = img.resize((size, size), Image.BICUBIC)
    else:
        img = random_resized_crop(img, size, (0.08, 1.0), rng)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    choice = rng.randint(0, 2)
    if choice == 0:
        img = ImageOps.grayscale(img).convert("RGB")
    elif choice == 1:
        img = ImageOps.solarize(img, threshold=128)
    else:
        img = gaussian_blur(img, rng)
    if color_jitter_strength:
        img = color_jitter(img, rng, brightness=color_jitter_strength,
                           contrast=color_jitter_strength, saturation=color_jitter_strength)
    arr = to_normalized_array(img)
    if reprob > 0:
        arr = random_erasing(arr, rng, reprob, remode, recount)
    return arr


class DataAugmentationDINO:
    """DINOv2 multi-crop augmentation
    (reference: dinov2/data/augmentations.py:19-118)."""

    def __init__(self, global_crops_scale=(0.32, 1.0), local_crops_scale=(0.05, 0.32),
                 local_crops_number=8, global_crops_size=224, local_crops_size=96):
        self.global_crops_scale = global_crops_scale
        self.local_crops_scale = local_crops_scale
        self.local_crops_number = local_crops_number
        self.global_crops_size = global_crops_size
        self.local_crops_size = local_crops_size
        # False -> emit uint8 crops (normalize in collate)
        self.normalize = True
        # the numpy + native C++ crop pipeline (resize_crop_u8 +
        # color_jitter_u8 of native/octic_data.cc); falls back to PIL when
        # the native library lacks the kernels
        self.use_native = True

    def _color(self, img, rng):
        from PIL import ImageOps

        if rng.random() < 0.8:
            img = color_jitter(img, rng, 0.4, 0.4, 0.2, 0.1)
        if rng.random() < 0.2:
            img = ImageOps.grayscale(img).convert("RGB")
        return img

    def _geo(self, img, size, scale, rng):
        from PIL import Image

        img = random_resized_crop(img, size, scale, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def _call_native(self, image, rng) -> Optional[Dict]:
        """uint8 + native C++ pipeline: the PIL path's op sequence and
        parameter distributions; resize and jitter run in
        native/octic_data.cc."""
        from PIL import Image, ImageFilter

        from octic_vits_tpu_torch.data import native

        if not native.has_resize():
            return None
        arr = np.asarray(image.convert("RGB"), np.uint8)
        h, w = arr.shape[:2]

        def geo(size, scale):
            left, top, cw, ch = rrc_box(w, h, scale, rng)
            out = native.resize_crop(arr, (top, left, top + ch, left + cw), (size, size))
            if rng.random() < 0.5:
                out = np.ascontiguousarray(out[:, ::-1])
            return out

        def color(c):
            if rng.random() < 0.8:
                ops, facs = sample_jitter(rng, 0.4, 0.4, 0.2, 0.1)
                c = np.ascontiguousarray(c)
                native.color_jitter_inplace(c, ops, facs)
            if rng.random() < 0.2:
                lum = ((299 * c[..., 0].astype(np.uint32)
                        + 587 * c[..., 1].astype(np.uint32)
                        + 114 * c[..., 2].astype(np.uint32)) // 1000).astype(np.uint8)
                c = np.repeat(lum[..., None], 3, axis=-1)
            return c

        def blur(c):
            im = Image.fromarray(c).filter(ImageFilter.GaussianBlur(rng.uniform(0.1, 2.0)))
            return np.asarray(im, np.uint8)

        g1 = color(geo(self.global_crops_size, self.global_crops_scale))
        g1 = blur(g1)
        g2 = color(geo(self.global_crops_size, self.global_crops_scale))
        if rng.random() < 0.1:
            g2 = blur(g2)
        if rng.random() < 0.2:
            g2 = np.where(g2 >= 128, 255 - g2, g2).astype(np.uint8)
        locals_ = []
        for _ in range(self.local_crops_number):
            lc = color(geo(self.local_crops_size, self.local_crops_scale))
            if rng.random() < 0.5:
                lc = blur(lc)
            locals_.append(np.ascontiguousarray(lc))
        out = {"global_crops": [np.ascontiguousarray(g1), np.ascontiguousarray(g2)],
               "local_crops": locals_}
        if self.normalize:
            out = {k: [native.normalize_batch(v[None])[0] for v in vs] for k, vs in out.items()}
        return out

    def __call__(self, image, rng: Optional[random.Random] = None):
        from PIL import ImageOps

        rng = rng or random
        if self.use_native:
            out = self._call_native(image, rng)
            if out is not None:
                return out
        g1 = self._geo(image, self.global_crops_size, self.global_crops_scale, rng)
        g1 = self._color(g1, rng)
        g1 = gaussian_blur(g1, rng)  # p=1.0

        g2 = self._geo(image, self.global_crops_size, self.global_crops_scale, rng)
        g2 = self._color(g2, rng)
        if rng.random() < 0.1:
            g2 = gaussian_blur(g2, rng)
        if rng.random() < 0.2:
            g2 = ImageOps.solarize(g2, threshold=128)

        to_arr = to_normalized_array if self.normalize else to_uint8_array
        locals_ = []
        for _ in range(self.local_crops_number):
            lc = self._geo(image, self.local_crops_size, self.local_crops_scale, rng)
            lc = self._color(lc, rng)
            if rng.random() < 0.5:
                lc = gaussian_blur(lc, rng)
            locals_.append(to_arr(lc))
        return {"global_crops": [to_arr(g1), to_arr(g2)], "local_crops": locals_}


def rotate90(img_arr: np.ndarray, k: int = 1) -> np.ndarray:
    """Equivariance stress eval: rot90 on a normalized HWC array
    (reference: deit/datasets.py:119-126, --rot-eval)."""
    return np.rot90(img_arr, k=k, axes=(0, 1)).copy()


def hflip(img_arr: np.ndarray) -> np.ndarray:
    """--flop-eval (reference: deit/datasets.py:127-132)."""
    return img_arr[:, ::-1].copy()
