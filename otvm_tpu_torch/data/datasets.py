"""Training datasets on the host (numpy, cv2): DIM (images faking clips,
stages 1-3) and VideoMatting108 (clips, stage 4).  The port's own copy of
otvm_tpu/data/datasets.py, after dataset.py:543-820 (DIM_Train) and
:232-540 (VideoMatting108_Train):

  * the object-centric random crop, with the 0.2 < alpha < 0.8 centre
    retries and the unknown-coverage fallback (dataset.py:318-357, 655-693);
  * VM108's temporal sampling, a random skip <= max_skip a step and a time
    flip (dataset.py:359-400); the trainer sets max_skip each epoch
    (`vm108_max_skip_for_epoch`, train.py:285-289);
  * the aug chain: gamma, histogram matching, flips, t-stacked motion blur,
    gaussian noise, jpeg, random affine (per frame for DIM);
  * the trimap synthesized from the augmented alpha: a random eps snap,
    close first, dilation radius 0-13 (dataset.py:200-229, 536-539), with
    the affine's out-of-bounds pixels as background (make_trimap,
    dataset.py:221-227).

Every random draw comes from the np.random.RandomState a caller passes, in
the JAX package's order, so one seed gives the JAX package's sample.

A sample: {"fg", "bg": [S, H, W, 3] RGB float in [0, 1], "alpha":
[S, H, W, 1], "tri": [S, H, W, 3] one-hot}; the BGR flip and the 1/255 of
the reference's model happen here.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import augs
from .trimap import _dilate


class _FrameCache:
    """Decoded-image RAM cache (path -> uint8 array).

    The reference spreads decoding over 8 DataLoader processes a rank
    (train.py:294-301); here RAM takes its place: with repeats=20 an epoch
    reads every frame ~20 times, and the working set (a few GB as uint8)
    fits.  Thread-safe under the GIL (at worst a frame is decoded twice)."""

    def __init__(self, max_bytes: int = 16 << 30):
        self._store: Dict[str, np.ndarray] = {}
        self._bytes = 0
        self.max_bytes = max_bytes

    def imread(self, path: str, flags) -> np.ndarray:
        import cv2

        hit = self._store.get(path)
        if hit is None:
            hit = cv2.imread(path, flags)
            if self._bytes + hit.nbytes <= self.max_bytes:
                self._store[path] = hit
                self._bytes += hit.nbytes
        return hit


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _object_centric_crop(rnd, frames: np.ndarray, masks: Optional[np.ndarray],
                         size: Tuple[int, int], outer_tries: int, center_tries=1000):
    """frames [T,H,W,C] (or [H,W,C] wrapped), masks [T,H,W] in [0,255]."""
    import cv2

    real = frames[0].shape[:2]
    min_scale = max(size[0] / real[0], size[1] / real[1])
    do_mask = masks is not None
    # at most 3 scales exist, so the retry loop (up to 100 x 1000 tries,
    # dataset.py:318-357) resizes once a scale, not once a try (the same
    # arrays).  Frames stay uint8 until the final [T, size, size] crop is
    # converted to float32: full-size float32 copies cost more than the
    # crop's work.
    rz_cache = {}

    def resized(scale):
        if scale not in rz_cache:
            dsize = (int(real[1] * scale), int(real[0] * scale))
            if dsize == (real[1], real[0]):
                rz_cache[scale] = (np.asarray(frames),
                                   np.asarray(masks) if do_mask else None)
            else:
                f = np.stack([cv2.resize(f, dsize,
                                         interpolation=cv2.INTER_LINEAR)
                              for f in frames])
                m = np.stack([cv2.resize(m, dsize,
                                         interpolation=cv2.INTER_LINEAR)
                              for m in masks]) if do_mask else None
                rz_cache[scale] = (f, m)
        return rz_cache[scale]

    # The reference tests up to outer_tries x 1000 candidate centres one
    # Python iteration at a time (dataset.py:333-354).  The same heuristic,
    # vectorized: all 1000 centres of an outer try are drawn at once and
    # tested for the strict unknown-band condition in one indexing op; the
    # coverage fallback (the last 100 candidates of the last outer try)
    # stays a loop.
    for t in range(outer_tries):
        scale = max(rnd.choice([1.0, 1 / 1.5, 1 / 2.0]), min_scale + 0.01)
        rz_f, rz_m = resized(scale)
        if not do_mask:
            cr_y = rnd.randint(0, rz_f.shape[1] - size[0] + 1)
            cr_x = rnd.randint(0, rz_f.shape[2] - size[1] + 1)
            break
        ys = rnd.randint(0, rz_f.shape[1] - size[0] + 1, center_tries)
        xs = rnd.randint(0, rz_f.shape[2] - size[1] + 1, center_tries)
        last = t == outer_tries - 1
        n_strict = center_tries - 100 if last else center_tries
        cvals = rz_m[0, ys[:n_strict] + size[0] // 2, xs[:n_strict] + size[1] // 2]
        ok = (cvals > 0.2 * 255) & (cvals < 0.8 * 255)
        hit = int(np.argmax(ok)) if ok.any() else -1
        if hit >= 0:
            cr_y, cr_x = int(ys[hit]), int(xs[hit])
            break
        if last:
            np_in1 = ((rz_m[0] > 0.2 * 255) & (rz_m[0] < 0.8 * 255)).sum()
            cr_y, cr_x = int(ys[-1]), int(xs[-1])     # ultimate fallback
            for tt in range(n_strict, center_tries):
                crop = rz_m[0, ys[tt]:ys[tt] + size[0], xs[tt]:xs[tt] + size[1]]
                ur = (crop > 0.2 * 255) & (crop < 0.8 * 255)
                if ur.sum() > 0.5 * np_in1 or ur.mean() > 0.01 / 255.0:
                    cr_y, cr_x = int(ys[tt]), int(xs[tt])
                    break
            break
    f = rz_f[:, cr_y:cr_y + size[0], cr_x:cr_x + size[1]].astype(np.float32)
    m = (rz_m[:, cr_y:cr_y + size[0], cr_x:cr_x + size[1]].astype(np.float32)
         if do_mask else None)
    return f, m


def _aug_chain(rnd, fg, bg, a, size, probs, per_frame_flip=False):
    """Shared gamma/hist/flip/motion/gauss/jpeg chain; all [T,H,W,*] 0..255."""
    S = len(fg)
    if rnd.uniform(0, 1) < probs["gamma"]:
        g = augs.truncated_normal(rnd, 1.0, 0.2, 0.5, 1.5)
        fg = np.stack([augs.gamma_contrast(fg[i], g) for i in range(S)])
    if rnd.uniform(0, 1) < probs["gamma"]:
        g = augs.truncated_normal(rnd, 1.0, 0.2, 0.5, 1.5)
        bg = np.stack([augs.gamma_contrast(bg[i], g) for i in range(S)])
    if rnd.uniform(0, 1) < probs["hist"]:
        ratio = rnd.uniform(0, 0.5)
        if rnd.uniform(0, 1) < 0.05:
            bg = augs.match_histograms(bg, fg) * ratio + bg * (1 - ratio)
        else:
            fg = augs.match_histograms(fg, bg) * ratio + fg * (1 - ratio)
    if rnd.randint(0, 2) == 0:
        fg = fg[:, :, ::-1].copy()
        a = a[:, :, ::-1].copy()
    if rnd.randint(0, 2) == 0:
        bg = bg[:, :, ::-1].copy()
    if per_frame_flip:
        for i in range(S):
            if rnd.uniform(0, 1) < 0.05:
                fg[i] = fg[i, ::-1]
                bg[i] = bg[i, ::-1]
                a[i] = a[i, ::-1]
    # motion blur on t-stacked planes (dataset.py:460-495)
    if rnd.uniform(0, 1) < probs["motion"]:
        def stack_blur(*arrs):
            cat = np.concatenate([x if x.ndim == 4 else x[..., None] for x in arrs],
                                 axis=3)                      # t,h,w,C
            flat = cat.transpose(1, 2, 3, 0).reshape(size[0], size[1], -1)
            blurred = augs.motion_blur(rnd, flat)
            out = blurred.reshape(size[0], size[1], -1, S).transpose(3, 0, 1, 2)
            return np.clip(out, 0, 255)

        if rnd.uniform(0, 1) < 0.5:
            out = stack_blur(fg, bg, a)
            fg, bg, a = out[..., :3], out[..., 3:6], out[..., 6]
        else:
            if rnd.uniform(0, 1) < 0.9:
                out = stack_blur(fg, a)
                fg, a = out[..., :3], out[..., 3]
            if rnd.uniform(0, 1) < 0.3:
                bg = stack_blur(bg)
    if rnd.uniform(0, 1) < probs["gauss"]:
        scale = rnd.uniform(0, 0.03 * 255)
        for i in range(S):
            fg[i] = augs.additive_gaussian_noise(rnd, fg[i], scale)
            bg[i] = augs.additive_gaussian_noise(rnd, bg[i], scale)
    if rnd.uniform(0, 1) < probs["jpeg"]:
        comp = rnd.randint(20, 81)
        for i in range(S):
            fg[i] = augs.jpeg_compression(rnd, fg[i], comp)
            a[i] = augs.jpeg_compression(rnd, a[i], comp)
            bg[i] = augs.jpeg_compression(rnd, bg[i], comp)
    return (np.ascontiguousarray(fg), np.ascontiguousarray(bg),
            np.ascontiguousarray(a))


def _finalize(rnd, fg, bg, a, ignore) -> Dict[str, np.ndarray]:
    """BGR->RGB, /255, trimap synthesis (dataset.py:536-539)."""
    a01 = a / 255.0
    eps = rnd.uniform(0.01, 0.2)
    close_first = rnd.uniform(0, 1) < 0.05
    ig = ignore < 0.5 if ignore is not None else None
    S = len(a01)
    # reference: random.Random.randint is INCLUSIVE -> radius 0..13
    radius = rnd.randint(0, 14)
    close_r = rnd.randint(0, 6) if close_first else 0
    tris, alphas = [], []
    for i in range(S):
        al = a01[i].copy()
        al[al < eps] = 0.0
        al[al > 1 - eps] = 1.0
        igi = ig[i] if ig is not None else None
        tm = ((al > 0) & (al < 1)).astype(np.float32)
        tm_ori = tm
        if close_first:
            inv = 1.0 - tm
            if igi is not None:
                inv[igi] = 0
            inv = _dilate(inv, close_r)
            tm = 1.0 - inv
            if igi is not None:
                tm[igi] = 0
            tm = _dilate(tm, close_r)
        tm = _dilate(tm, radius)
        if close_first:
            tm = np.clip(tm + tm_ori, 0, 1)
        label = np.where(tm > 0.5, 1, 2 * (al > 0.5).astype(np.int64))
        if igi is not None:
            label[igi] = 0
            al[igi] = 0
        tris.append(np.eye(3, dtype=np.float32)[label])
        alphas.append(al)
    return dict(
        fg=np.ascontiguousarray(fg[..., ::-1], np.float32) / 255.0,
        bg=np.ascontiguousarray(bg[..., ::-1], np.float32) / 255.0,
        alpha=np.stack(alphas)[..., None].astype(np.float32),
        tri=np.stack(tris).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# DIM (image dataset faking video, stages 1-3)
# ---------------------------------------------------------------------------

class DIMTrain:
    """dataset.py:543-820.  Layout: <root>/Combined_Dataset/Training_set/...

    Any directory tree with <fg_dir>/fg/*.png + <fg_dir>/alpha/*.png and a
    bg image pool works; see `from_folders` for the generic constructor used
    in tests."""

    def __init__(self, fg_alpha_pairs: Sequence[Tuple[str, str]],
                 bg_paths: Sequence[str], image_shape=(320, 320),
                 sample_length=3,
                 probs=None, cache_frames=True):
        self.pairs = list(fg_alpha_pairs)
        self.bgs = list(bg_paths)
        self.image_shape = tuple(image_shape)
        self.sample_length = sample_length
        self.probs = probs or dict(gamma=0.5, hist=0.5, motion=0.5,
                                   gauss=0.5, jpeg=0.5)
        self._cache = _FrameCache() if cache_frames else None

    @classmethod
    def from_adobe_layout(cls, data_root: str, **kw):
        """Combined_Dataset layout (dataset.py:584-651)."""
        root = os.path.join(data_root, "Combined_Dataset")
        names_txt = os.path.join(root, "Training_set", "training_fg_names.txt")
        dirs = ["Training_set/Adobe-licensed images", "Training_set/Other"]
        pairs = []
        with open(names_txt) as f:
            wanted = [v.strip() for v in f if v.strip()]
        lookup = {}
        for d in sorted(dirs):
            fgd = os.path.join(root, d, "fg")
            if os.path.isdir(fgd):
                for n in sorted(os.listdir(fgd)):
                    lookup.setdefault(n, (os.path.join(root, d, "fg", n),
                                          os.path.join(root, d, "alpha", n)))
        for n in wanted:
            if n in lookup:
                pairs.append(lookup[n])
        bgd = os.path.join(root, "Training_set", "train2014")
        bgs = [os.path.join(bgd, n) for n in sorted(os.listdir(bgd))]
        return cls(pairs, bgs, **kw)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int, rnd: Optional[np.random.RandomState] = None):
        import cv2

        rnd = rnd or np.random.RandomState()
        imread = self._cache.imread if self._cache else cv2.imread
        fgp, ap = self.pairs[idx]
        # uint8 until the crop (see _object_centric_crop)
        fg0 = imread(fgp, cv2.IMREAD_COLOR)
        a0 = imread(ap, cv2.IMREAD_GRAYSCALE)
        bg0 = imread(self.bgs[rnd.randint(0, len(self.bgs))],
                     cv2.IMREAD_COLOR)
        S = self.sample_length
        fgl, bgl, al = [], [], []
        for _ in range(S):
            f, a = _object_centric_crop(rnd, fg0[None], a0[None],
                                        self.image_shape, outer_tries=10)
            b, _ = _object_centric_crop(rnd, bg0[None], None,
                                        self.image_shape, outer_tries=10)
            fgl.append(f[0])
            al.append(a[0])
            bgl.append(b[0])
        fg, bg, a = np.stack(fgl), np.stack(bgl), np.stack(al)
        fg, bg, a = _aug_chain(rnd, fg, bg, a, self.image_shape, self.probs,
                               per_frame_flip=True)
        # per-frame random affine (dataset.py:801-804)
        ignore = np.ones_like(a)
        for i in range(S):
            fg[i], bg[i], a[i], ignore[i] = augs.random_transform(
                [fg[i], bg[i], a[i], ignore[i]], rnd,
                rt=25, sh=15, zm=(0.90, 1.10), sc=(0.9, 1.0), cs=0.07 * 255)
        return _finalize(rnd, fg, bg, a, ignore)


# ---------------------------------------------------------------------------
# VideoMatting108 (stage 4)
# ---------------------------------------------------------------------------

def vm108_max_skip_for_epoch(epoch: int, total_epochs: int = 200) -> int:
    """Curriculum (train.py:285-289): skip grows 5 -> 15 -> 25 at fixed
    fractions of training."""
    if epoch < int(total_epochs * 0.25):
        return 5
    if epoch < int(total_epochs * 0.5):
        return 15
    return 25


class VM108Train:
    """dataset.py:232-540.  Layout: <root>/VideoMatting108/{FG_done,BG_done2,
    frame_corr.json, train_videos.txt}."""

    def __init__(self, data_root: str, image_shape=(320, 320), sample_length=3,
                 max_skip=75, mode="train", probs=None, cache_frames=True):
        import json

        self.root = os.path.join(data_root, "VideoMatting108")
        self.image_shape = tuple(image_shape)
        self.sample_length = sample_length
        self.max_skip = max_skip
        self.probs = probs or dict(gamma=0.3, hist=0.3, motion=0.3,
                                   gauss=0.3, jpeg=0.3)
        self.do_time_flip = 0.5
        self.do_affine = 0.5
        with open(os.path.join(self.root, "frame_corr.json")) as f:
            self.frame_corr = json.load(f)
        with open(os.path.join(self.root, f"{mode}_videos.txt")) as f:
            seqs = [v.strip() for v in f if v.strip()]
        self.FG, self.BG = [], []
        for v in seqs:
            fns = [k for k in sorted(self.frame_corr.keys())
                   if os.path.dirname(k) == v]
            self.FG.append([os.path.join("FG_done", k) for k in fns])
            self.BG.append([os.path.join("BG_done2", self.frame_corr[k]) for k in fns])
        self._cache = _FrameCache() if cache_frames else None

    def __len__(self):
        return len(self.FG)

    def _sample_skips(self, rnd, max_skip):
        skips = [0] + [rnd.randint(0, max_skip + 1) for _ in range(self.sample_length - 1)]
        return [sum(skips[:i + 1]) for i in range(len(skips))]

    def __getitem__(self, idx: int, rnd: Optional[np.random.RandomState] = None):
        import cv2

        rnd = rnd or np.random.RandomState()
        S = self.sample_length
        fg_paths = self.FG[idx]
        bg_paths = self.BG[rnd.randint(0, len(self.BG))]

        for ttr in range(1000):
            cum = self._sample_skips(rnd, 0 if ttr > 600 else self.max_skip)
            if (len(fg_paths) - S - cum[-1] > 1) and (len(bg_paths) - S - cum[-1] > 1):
                break
        else:
            return self.__getitem__(rnd.randint(0, len(self)), rnd)

        if rnd.uniform(0, 1) < self.do_time_flip:
            fg_paths = fg_paths[::-1]
        st = rnd.randint(0, len(fg_paths) - S - cum[-1])
        fg_sel = [fg_paths[st + c] for c in cum]
        if rnd.uniform(0, 1) < self.do_time_flip:
            bg_paths = bg_paths[::-1]
        st_b = rnd.randint(0, len(bg_paths) - S - cum[-1])
        bg_sel = [bg_paths[st_b + c] for c in cum]

        imread = self._cache.imread if self._cache else cv2.imread
        fgs, als, bgs = [], [], []
        for p in fg_sel:
            # uint8 until the crop (see _object_centric_crop)
            raw = imread(os.path.join(self.root, p), cv2.IMREAD_UNCHANGED)
            fgs.append(raw[..., :3])
            als.append(raw[..., 3])
        if int(als[0].sum(dtype=np.int64)) < 1:
            return self.__getitem__(rnd.randint(0, len(self)), rnd)
        for p in bg_sel:
            bp = os.path.join(self.root, p)
            if not os.path.exists(bp):
                bp = os.path.splitext(bp)[0] + ".png"
            bgs.append(imread(bp, cv2.IMREAD_COLOR))

        fg, a = _object_centric_crop(rnd, np.stack(fgs), np.stack(als),
                                     self.image_shape, outer_tries=100)
        bg, _ = _object_centric_crop(rnd, np.stack(bgs), None,
                                     self.image_shape, outer_tries=100)
        fg, bg, a = _aug_chain(rnd, fg, bg, a, self.image_shape, self.probs)
        ignore = np.ones_like(a)
        if rnd.uniform(0, 1) < self.do_affine:
            allf = list(fg) + list(a) + list(ignore) + list(bg)
            out = augs.random_transform(allf, rnd, rt=10, sh=5,
                                        zm=(0.95, 1.05), cs=0.03 * 255)
            fg = np.stack(out[:S])
            a = np.stack(out[S:2 * S])
            ignore = np.stack(out[2 * S:3 * S])
            bg = np.stack(out[3 * S:4 * S])
        return _finalize(rnd, fg, bg, a, ignore)
