"""Host-side augmentations (numpy, cv2): the port's own copy of
otvm_tpu/data/augs.py, which re-implements the reference's imgaug,
albumentations and skimage calls with their parameter ranges
(dataset.py):

  * gamma_contrast          iaa.GammaContrast(TruncatedNormal(1.0, .2, .5, 1.5))
  * additive_gaussian_noise iaa.AdditiveGaussianNoise(scale=(0, .03*255))
  * jpeg_compression        iaa.JpegCompression(compression=(20, 80))
  * motion_blur             A.MotionBlur(blur_limit=(3, 50)), a random-angle
                            line kernel over the t-stacked image
  * match_histograms        skimage.exposure.match_histograms(channel_axis=-1)
  * random_transform        dataset.py:84-191: rotation, shear, zoom, shift
                            and channel shift composed, warped by cv2 in the
                            reference's flipped-matrix convention

Images are float32 in [0, 255], as in the reference's pipeline; every
random draw comes from the np.random.RandomState passed in.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def truncated_normal(rnd: np.random.RandomState, mean, std, lo, hi):
    for _ in range(100):
        v = rnd.normal(mean, std)
        if lo <= v <= hi:
            return v
    return float(np.clip(v, lo, hi))


def gamma_contrast(img: np.ndarray, gamma: float) -> np.ndarray:
    """uint8 semantics: 255 * (I/255)^gamma, rounded."""
    x = np.clip(img, 0, 255).astype(np.uint8)
    table = (255.0 * (np.arange(256) / 255.0) ** gamma).round().astype(np.uint8)
    return table[x].astype(np.float32)


def additive_gaussian_noise(rnd, img: np.ndarray, scale: float) -> np.ndarray:
    noise = rnd.normal(0.0, scale, img.shape).astype(np.float32)
    return np.clip(np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)
                   + noise, 0, 255).round().astype(np.float32)


def jpeg_compression(rnd, img: np.ndarray, compression: int) -> np.ndarray:
    """compression in [0,100] -> cv2 quality = 100 - compression."""
    import cv2

    q = int(100 - compression)
    x = np.clip(img, 0, 255).astype(np.uint8)
    if x.ndim == 2:
        ok, enc = cv2.imencode(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, q])
        return cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    ok, enc = cv2.imencode(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, q])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR).astype(np.float32)


def motion_blur_kernel(rnd, ksize: int) -> np.ndarray:
    """Random-angle line kernel (albumentations MotionBlur style)."""
    import cv2

    k = np.zeros((ksize, ksize), np.float32)
    x1, x2 = rnd.randint(0, ksize), rnd.randint(0, ksize)
    y1, y2 = rnd.randint(0, ksize), rnd.randint(0, ksize)
    cv2.line(k, (x1, y1), (x2, y2), 1.0, thickness=1)
    s = k.sum()
    if s == 0:
        k[ksize // 2, ksize // 2] = 1.0
        s = 1.0
    return k / s


def motion_blur(rnd, img: np.ndarray, blur_limit=(3, 50)) -> np.ndarray:
    """Applied to [H, W, C*t] stacks like the reference (dataset.py:460-495)."""
    import cv2

    ksize = rnd.randint(blur_limit[0], blur_limit[1] + 1)
    if ksize % 2 == 0:
        ksize += 1
    k = motion_blur_kernel(rnd, ksize)
    return cv2.filter2D(img, -1, k)


def match_histograms(src: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching (skimage.exposure semantics) on the
    full stacked array (the reference matches across the whole [t,H,W,3]
    block at once, dataset.py:442-449).

    Values are quantized to uint8 bins first: identical to skimage on uint8
    inputs (the reference pipeline is uint8-scaled), under half a step on
    interpolated floats, and a 256-entry bincount and lookup table in place
    of np.unique over the whole array."""
    out = np.empty_like(src, dtype=np.float32)
    for c in range(src.shape[-1]):
        s = np.clip(src[..., c], 0, 255).astype(np.uint8)
        r = np.clip(ref[..., c], 0, 255).astype(np.uint8).ravel()
        s_cnt = np.bincount(s.ravel(), minlength=256)
        r_cnt = np.bincount(r, minlength=256)
        s_q = np.cumsum(s_cnt).astype(np.float64) / s.size
        r_nz = np.nonzero(r_cnt)[0]
        r_q = np.cumsum(r_cnt).astype(np.float64)[r_nz] / r.size
        lut = np.interp(s_q, r_q, r_nz.astype(np.float64)).astype(np.float32)
        out[..., c] = lut[s]
    return out


def channel_shift(imgs: Sequence[np.ndarray], intensity: float) -> List[np.ndarray]:
    """dataset.py:822-838: shift all channels, clip to the IMAGE's min/max."""
    ys = []
    for x in imgs:
        if x.ndim == 3:
            ys.append(np.clip(x + intensity, x.min(), x.max()))
        else:
            ys.append(x)
    return ys


def random_transform(xs: Sequence[np.ndarray], rnd,
                     rt=0, hs=0, ws=0, sh=0, zm=(1, 1), sc=(1, 1), cs=0.0,
                     hf=False) -> List[np.ndarray]:
    """dataset.py:84-191.  3-D arrays warp bilinear, 2-D warp nearest."""
    import cv2

    h, w = xs[0].shape[0], xs[0].shape[1]
    theta = np.pi / 180 * rnd.uniform(-rt, rt) if rt else 0.0
    tx = rnd.uniform(-hs, hs) * h if hs else 0.0
    ty = rnd.uniform(-ws, ws) * w if ws else 0.0
    shear = np.pi / 180 * rnd.uniform(-sh, sh) if sh else 0.0
    if zm[0] == 1 and zm[1] == 1:
        zx = zy = 1.0
    else:
        zx, zy = rnd.uniform(*zm), rnd.uniform(*zm)
    if not (sc[0] == 1 and sc[1] == 1):
        s = rnd.uniform(*sc)
        zx, zy = zx * s, zy * s

    M = None
    if theta != 0:
        M = np.array([[np.cos(theta), -np.sin(theta), 0],
                      [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
    if tx != 0 or ty != 0:
        shift = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]])
        M = shift if M is None else M @ shift
    if shear != 0:
        if rnd.uniform(0, 1) < 0.5:
            sm = np.array([[1, -np.sin(shear), 0], [0, np.cos(shear), 0], [0, 0, 1]])
        else:
            sm = np.array([[np.cos(shear), 0, 0], [np.sin(shear), 1, 0], [0, 0, 1]])
        M = sm if M is None else M @ sm
    if zx != 1 or zy != 1:
        zmx = np.array([[zx, 0, 0], [0, zy, 0], [0, 0, 1]])
        M = zmx if M is None else M @ zmx

    ys = list(xs)
    if M is not None:
        # offset to center (dataset.py:91-97)
        o_x, o_y = h / 2 + 0.5, w / 2 + 0.5
        off = np.array([[1, 0, o_x], [0, 1, o_y], [0, 0, 1]])
        rst = np.array([[1, 0, -o_x], [0, 1, -o_y], [0, 0, 1]])
        M = off @ M @ rst
        # the reference's cv2 matrix convention (dataset.py:66-81)
        cvM = np.zeros((2, 3), np.float64)
        cvM[:2, :2] = np.flipud(np.fliplr(M[:2, :2]))
        cvM[:2, 2] = np.flip(M[:2, 2], axis=0)
        dsize = (xs[0].shape[1], xs[0].shape[0])
        ys = [cv2.warpAffine(x, cvM, dsize,
                             flags=cv2.INTER_LINEAR if x.ndim == 3 else cv2.INTER_NEAREST)
              for x in xs]

    if cs:
        ys = channel_shift(ys, rnd.uniform(-cs, cs))
    if hf and rnd.uniform(0, 1) < 0.5:
        ys = [x[:, ::-1] for x in ys]
    return ys
