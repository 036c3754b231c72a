"""Frame store (port of ``repnerv_tpu/data/frames.py``): the video, its
sampling, and the frame sources.

Each sample is ``(frame / 255, idx / len)``; ``frame_gap`` strides the
sampling.  ``make_frame_store`` puts the video on one of three rungs, each
taken as the video outgrows the last (the reference gets this for free from
a PIL load per item):

1. it fits the device budget: one uint8 tensor on the device, and a step
   gathers its frames there from an index tensor (no pixels cross from the
   host after the first copy);
2. it is over the device budget (or ``cache_device`` is off): a uint8 host
   array, in pinned memory when the device is CUDA, from which batches and
   the streaming epoch's chunks are copied asynchronously;
3. a frame directory whose decoded size is over the host budget: a
   ``DirFrames``, which decodes the frames it is asked for from disk.

The frame sources: a sorted directory of images, the synthetic video, and
the photo and corpus videos (camera pans over matplotlib's bundled sample
rasters), each equal byte for byte to the JAX package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import DataConfig

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _load_frame(path: str) -> np.ndarray:
    """One image as uint8 [H, W, 3]; a portrait frame swaps H and W (an axis
    swap, not a rotation), as the reference's loader does."""
    from PIL import Image  # only the frame-directory sources need PIL

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return arr.transpose(1, 0, 2) if arr.shape[0] > arr.shape[1] else arr


class DirFrames:
    """Lazy frame-directory source: decodes the frames it is asked for and
    never holds the video in host memory (the reference's per-item PIL load,
    for videos larger than memory).

    It has the slice of the ndarray API the pipeline uses: ``shape``,
    ``dtype``, ``nbytes`` (logical: the decoded size), ``len`` and integer /
    array ``__getitem__`` returning uint8 pixels.  It keeps the last frame it
    decoded.
    """

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        first = _load_frame(self.paths[0])
        self._hw3 = first.shape
        self._cache = (0, first)  # one frame (the eval reads its target again)
        self.dtype = np.uint8

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self.paths), *self._hw3)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape))

    def _one(self, i: int) -> np.ndarray:
        i = int(i)
        if self._cache[0] == i:
            return self._cache[1]
        arr = _load_frame(self.paths[i])
        if arr.shape != self._hw3:
            raise ValueError(f"frame {self.paths[i]} shape {arr.shape} != {self._hw3}")
        self._cache = (i, arr)
        return arr

    def __getitem__(self, rows):
        if np.isscalar(rows) or getattr(rows, "ndim", 1) == 0:
            return self._one(rows)
        return np.stack([self._one(i) for i in np.asarray(rows).reshape(-1)])

    def __len__(self) -> int:
        return len(self.paths)


def read_frames(frames, rows, out: np.ndarray) -> None:
    """Write ``frames[r]`` for each of ``rows`` into ``out[j]`` (uint8
    [len(rows), H, W, 3]), from a host array or a ``DirFrames``."""
    for j, r in enumerate(np.asarray(rows).reshape(-1)):
        out[j] = frames[int(r)]


def list_frame_paths(
    main_dir: str, vid_list: Optional[Sequence[int]] = None
) -> Tuple[List[str], np.ndarray]:
    """Sorted frame paths, and t normalized over the FULL directory (the
    reference normalizes before ``vid_list`` subsetting)."""
    names = sorted(f for f in os.listdir(main_dir) if f.lower().endswith(IMG_EXTS))
    if not names:
        raise FileNotFoundError(f"no frame images in {main_dir}")
    n_all = len(names)
    t_all = np.arange(n_all, dtype=np.float64) / n_all
    if vid_list is not None and None not in tuple(vid_list):
        idx = list(vid_list)
        names = [names[i] for i in idx]
        t_all = t_all[idx]
    return [os.path.join(main_dir, f) for f in names], t_all.astype(np.float32)


def load_frame_dir(
    main_dir: str, vid_list: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a sorted frame directory -> (frames [N, H, W, 3] uint8, t [N]);
    portrait frames swap H and W, as the reference does."""
    paths, t_all = list_frame_paths(main_dir, vid_list)
    return np.stack([_load_frame(p) for p in paths]), t_all


def synthetic_video(n_frames: int, h: int, w: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's deterministic synthetic video, byte for byte: a
    translating multi-octave value-noise texture + smooth gradients + a
    moving bright box (natural-image-like statistics keep SSIM losses
    non-degenerate)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=np.float32),
        np.linspace(0, 1, w, dtype=np.float32),
        indexing="ij",
    )

    def octave(cells_y, cells_x, amp):
        g = rng.standard_normal((3, cells_y + 1, cells_x + 1)).astype(np.float32)
        ys = np.linspace(0, cells_y, h, dtype=np.float32)
        xs = np.linspace(0, cells_x, w, dtype=np.float32)
        y0 = np.clip(ys.astype(np.int32), 0, cells_y - 1)
        x0 = np.clip(xs.astype(np.int32), 0, cells_x - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        out = np.empty((h, w, 3), np.float32)
        for c in range(3):
            gc = g[c]
            top = gc[y0][:, x0] * (1 - fx) + gc[y0][:, x0 + 1] * fx
            bot = gc[y0 + 1][:, x0] * (1 - fx) + gc[y0 + 1][:, x0 + 1] * fx
            out[:, :, c] = top * (1 - fy) + bot * fy
        return out * amp

    texture = (
        octave(4, 6, 0.5)
        + octave(12, 20, 0.25)
        + octave(36, 60, 0.12)
        + octave(max(h // 8, 2), max(w // 8, 2), 0.06)
    )
    phases = rng.uniform(0, 2 * np.pi, size=(3,)).astype(np.float32)
    freqs = rng.uniform(1.0, 2.5, size=(3, 2)).astype(np.float32)

    frames = np.empty((n_frames, h, w, 3), dtype=np.uint8)
    for n in range(n_frames):
        t = n / max(n_frames, 1)
        base = np.stack(
            [
                0.3
                * np.sin(
                    2 * np.pi * (freqs[c, 0] * yy + freqs[c, 1] * xx) + phases[c] + 2 * np.pi * t
                )
                for c in range(3)
            ],
            axis=-1,
        )
        sy = int(t * h * 0.5) % h
        sx = int(t * w * 0.25) % w
        tex = np.roll(texture, (sy, sx), axis=(0, 1))
        img = 0.5 + base + tex
        bh, bw = h // 4, w // 4
        y0 = int((h - bh) * t)
        x0 = int((w - bw) * (0.5 + 0.5 * np.sin(2 * np.pi * t)))
        img[y0 : y0 + bh, x0 : x0 + bw] += 0.3
        frames[n] = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    t_all = np.arange(n_frames, dtype=np.float32) / n_frames
    return frames, t_all


Frames = Union[torch.Tensor, np.ndarray, DirFrames]


@dataclass
class FrameStore:
    """The video [N, H, W, 3] uint8 with gap sampling.  ``frames`` is a
    tensor on the device (resident), a host array, or a ``DirFrames``;
    ``gather`` returns its batches on ``device`` (a tensor's own device when
    not given, else the CPU)."""

    frames: Frames
    t: np.ndarray  # [N] normalized indices over the full source sequence
    frame_gap: int = 1
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.device is None:
            self.device = self.frames.device if self.resident else torch.device("cpu")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" != "cuda:0": the epoch functions compare devices to keep their buffers
            self.device = torch.device("cuda", torch.cuda.current_device())

    @property
    def resident(self) -> bool:
        """The video is one tensor on ``device`` (rung 1)."""
        return isinstance(self.frames, torch.Tensor)

    @property
    def num_samples(self) -> int:
        return self.frames.shape[0] // self.frame_gap

    @property
    def hw(self) -> Tuple[int, int]:
        return self.frames.shape[1], self.frames.shape[2]

    def sample_indices(self) -> np.ndarray:
        return np.arange(self.num_samples) * self.frame_gap

    def epoch_batches(
        self, batch_size: int, *, shuffle: bool, seed: int, drop_last: bool
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (frame rows, t) batches in the JAX package's order."""
        idx = self.sample_indices()
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        n = len(idx)
        stop = n - (n % batch_size) if drop_last else n
        for i in range(0, stop, batch_size):
            rows = idx[i : i + batch_size]
            yield rows, self.t[rows]

    def gather(self, rows) -> torch.Tensor:
        """[B, H, W, 3] f32 in [0, 1] on ``device``.  Resident: a gather on
        the device, then /255.  Host or disk: a gather on the host into a
        batch in pinned memory (on a CUDA device), copied with
        ``non_blocking``; ``rows`` then may be a numpy array or a tensor."""
        if self.resident:
            rows = torch.as_tensor(rows, dtype=torch.long, device=self.frames.device)
            return self.frames[rows].float() / 255.0
        rows = np.asarray(rows.cpu() if torch.is_tensor(rows) else rows).reshape(-1)
        host = torch.empty((len(rows), *self.frames.shape[1:]), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        read_frames(self.frames, rows, host.numpy())
        return host.to(self.device, non_blocking=True).float() / 255.0

    def frame(self, i: int) -> np.ndarray:
        """Frame ``i`` as a host uint8 array [H, W, 3]."""
        if self.resident:
            return self.frames[int(i)].cpu().numpy()
        return np.asarray(self.frames[int(i)])


def device_budget_bytes(cfg: DataConfig, device: torch.device) -> int:
    """Pixel budget on the device: ``hbm_budget_mb`` -1 = 40% of a CUDA
    device's memory (no limit on the CPU), 0 = no limit, > 0 = MiB."""
    if cfg.hbm_budget_mb == 0:
        return 1 << 62
    if cfg.hbm_budget_mb > 0:
        return cfg.hbm_budget_mb * (1 << 20)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory * 0.40)
    return 1 << 62


def host_budget_bytes(cfg: DataConfig) -> int:
    """Decoded-size budget of a frame directory in host memory:
    ``host_budget_mb`` 0 = no limit, > 0 = MiB."""
    return cfg.host_budget_mb * (1 << 20) if cfg.host_budget_mb > 0 else 1 << 62


def pinned_copy(frames: np.ndarray) -> np.ndarray:
    """``frames`` copied into page-locked host memory: a view of a pinned
    tensor, which the view keeps alive."""
    host = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
    out = host.numpy()
    out[...] = frames
    return out


def photo_video(
    n_frames: int, h: int, w: int, seed: int = 0, motion: str = "normal"
) -> Tuple[np.ndarray, np.ndarray]:
    """Real-photograph video: smooth camera pan/zoom over a mirror-tiled
    real photo (matplotlib's bundled ``grace_hopper.jpg``, 600x512 RGB).

    The synthetic generator's value-noise statistics are not photographic;
    this video gives genuine photographic high-frequency content
    (skin/fabric/insignia texture, sharp edges) from a raster that ships
    with matplotlib, so nothing is downloaded.  Mirror-tiling keeps every
    pixel at native texture scale; the camera path is smooth (NeRV-friendly
    temporal coherence, like a real pan shot).
    """
    import matplotlib.cbook as cbook
    from PIL import Image

    photo = np.asarray(
        Image.open(cbook.get_sample_data("grace_hopper.jpg", asfileobj=False))
    )
    # seed-keyed content transform so a multi-video suite (suite_main.py,
    # one seed per video) gets distinct content, not just distinct camera
    # paths: rotation / mirror of the source photo before tiling.  seed 0
    # is the identity — single-video `--dataset photo` runs are unchanged.
    if seed % 4:
        photo = np.rot90(photo, k=seed % 4)
    if (seed // 4) % 2:
        photo = photo[:, ::-1]
    canvas = _mirror_tile(photo, h, w)
    return _camera_pan_video(
        canvas, n_frames, h, w, np.random.default_rng(seed), motion=motion
    )


def _mirror_tile(photo: np.ndarray, h: int, w: int, max_zoom: float = 1.25) -> np.ndarray:
    """Mirror-tile a source image until it covers the largest crop window
    (keeps every pixel at native texture scale)."""
    need_h = int(h * max_zoom) + photo.shape[0]
    need_w = int(w * max_zoom) + photo.shape[1]
    row = photo
    while row.shape[1] < need_w:
        row = np.concatenate([row, row[:, ::-1]], axis=1)
    canvas = row
    while canvas.shape[0] < need_h:
        canvas = np.concatenate([canvas, canvas[::-1]], axis=0)
    return canvas


_MOTION_PROFILES = {
    # (pan fraction of frame size, zoom-breath amplitude)
    "normal": (0.08, 0.03),
    "slow": (0.01, 0.004),
    "static": (0.0, 0.0),
}


def _camera_pan_video(
    canvas: np.ndarray,
    n_frames: int,
    h: int,
    w: int,
    rng: np.random.Generator,
    max_zoom: float = 1.25,
    motion: str = "normal",
) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth pan/zoom camera over a canvas -> ([N,h,w,3] uint8, t [N]).

    Camera-realistic amplitudes: ~5 px/frame pan at 132 frames and a +-3%
    zoom breath — adjacent-frame L1 lands near the synthetic video's
    (~7/255), i.e. a normal pan shot, not an adversarial one.  ``motion``
    picks a profile from _MOTION_PROFILES ("slow" ~1/8 amplitudes,
    "static" freezes the camera) — used to separate temporal bandwidth
    from spatial capacity in the text-class floor analysis."""
    from PIL import Image

    pan_frac, zoom_amp = _MOTION_PROFILES[motion]
    ph = rng.uniform(0, 2 * np.pi, size=4)
    ch, cw = canvas.shape[:2]
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    pan_y, pan_x = pan_frac * h, pan_frac * w
    cy0, cx0 = (ch - int(h * max_zoom)) // 2, (cw - int(w * max_zoom)) // 2
    for n in range(n_frames):
        t = n / max(n_frames, 1)
        zoom = 1.12 + zoom_amp * np.sin(2 * np.pi * t + ph[0])
        crop_h, crop_w = int(h * zoom), int(w * zoom)
        y0 = int(cy0 + pan_y * np.sin(2 * np.pi * t + ph[1]))
        x0 = int(cx0 + pan_x * np.sin(2 * np.pi * t + ph[2]))
        y0 = np.clip(y0, 0, ch - crop_h)
        x0 = np.clip(x0, 0, cw - crop_w)
        crop = canvas[y0 : y0 + crop_h, x0 : x0 + crop_w]
        if (crop_h, crop_w) != (h, w):
            crop = np.asarray(
                Image.fromarray(crop).resize((w, h), Image.BILINEAR)
            )
        frames[n] = crop
    t_all = np.arange(n_frames, dtype=np.float32) / n_frames
    return frames, t_all



def _src_photo(variant: int) -> np.ndarray:
    """Real photograph: matplotlib's bundled grace_hopper.jpg (600x512)."""
    import matplotlib.cbook as cbook
    from PIL import Image

    img = np.asarray(
        Image.open(cbook.get_sample_data("grace_hopper.jpg", asfileobj=False))
    )
    if variant % 4:
        img = np.rot90(img, k=variant % 4)
    if (variant // 4) % 2:
        img = img[:, ::-1]
    return img


def _src_mri(variant: int) -> np.ndarray:
    """Real medical imagery: matplotlib's bundled 256x256 uint16 MRI slice
    (s1045.ima.gz), windowed and rendered through the 'bone' colormap at 3x
    scale — smooth anatomy gradients + sharp skull/tissue boundaries."""
    import matplotlib
    import matplotlib.cbook as cbook
    from PIL import Image

    with cbook.get_sample_data("s1045.ima.gz") as f:
        mri = np.frombuffer(f.read(), np.uint16).reshape(256, 256).astype(np.float32)
    # crop to the anatomy's bounding box so mirror tiles are tissue, not the
    # black scanner background (small crops would otherwise land on void)
    ys, xs = np.nonzero(mri > np.percentile(mri, 50))
    mri = mri[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
    lo, hi = np.percentile(mri[mri > 0], [1, 99])
    norm = np.clip((mri - lo) / max(hi - lo, 1.0), 0.0, 1.0)
    # light-table backdrop: the scanner background renders as a dim smooth
    # gradient instead of flat black, so any camera crop has structure
    hh, ww = norm.shape
    gy, gx = np.meshgrid(
        np.linspace(0, 1, hh, dtype=np.float32),
        np.linspace(0, 1, ww, dtype=np.float32),
        indexing="ij",
    )
    backdrop = 0.10 + 0.12 * (0.5 * gy + 0.5 * np.sin(3.1 * gx))
    norm = np.maximum(norm, backdrop.astype(np.float32))
    rgb = (matplotlib.colormaps["bone"](norm)[..., :3] * 255).astype(np.uint8)
    if variant % 4:
        rgb = np.rot90(rgb, k=variant % 4)
    rgb = np.asarray(
        Image.fromarray(rgb).resize((rgb.shape[1] * 3, rgb.shape[0] * 3), Image.BILINEAR)
    )
    return rgb


def _src_terrain(variant: int) -> np.ndarray:
    """Real-world terrain: matplotlib's bundled Jacksboro-fault DEM
    (344x403 elevation raster), hillshaded with a LightSource + terrain
    colormap at 2x scale — natural fractal relief texture."""
    import matplotlib
    import matplotlib.cbook as cbook
    from matplotlib.colors import LightSource
    from PIL import Image

    dem = cbook.get_sample_data("jacksboro_fault_dem.npz")
    elev = np.asarray(dem["elevation"], np.float32)
    azim = 315.0 + 45.0 * (variant % 4)
    ls = LightSource(azdeg=azim, altdeg=45)
    shaded = ls.shade(
        elev, cmap=matplotlib.colormaps["terrain"], blend_mode="overlay",
        vert_exag=2.0,
    )
    rgb = (np.clip(shaded[..., :3], 0, 1) * 255).astype(np.uint8)
    if (variant // 4) % 2:
        rgb = rgb[:, ::-1]
    rgb = np.asarray(
        Image.fromarray(rgb).resize((rgb.shape[1] * 2, rgb.shape[0] * 2), Image.BILINEAR)
    )
    return rgb


def _src_text(variant: int) -> np.ndarray:
    """Rendered text page (light glyphs on dark, colored tokens) — the
    hard-edge/high-frequency content class NeRV-family models struggle with
    most; the camera pan turns it into scrolling text."""
    from PIL import Image, ImageDraw, ImageFont

    rng = np.random.default_rng(1000 + variant)
    W, H = 960, 720
    # subtle paper-like gradient so no region of the page is flat
    gy, gx = np.meshgrid(
        np.linspace(0, 1, H, dtype=np.float32),
        np.linspace(0, 1, W, dtype=np.float32),
        indexing="ij",
    )
    bg = (18 + 14 * gy + 8 * np.sin(4.0 * gx))[..., None] * np.array(
        [1.0, 1.1, 1.35], np.float32
    )
    img = Image.fromarray(np.clip(bg, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.load_default(size=22)
    except TypeError:  # older PIL: fixed-size bitmap font
        font = ImageFont.load_default()
    words = (
        "repnerv tpu pallas mesh pjit scan fuse deploy conv shuffle swish "
        "frame index epoch adam cosine warmup psnr ssim huffman rans bpp "
        "quant prune finetune decode serve bitstream checkpoint orbax jit"
    ).split()
    palette = [(225, 228, 235), (140, 200, 255), (255, 190, 120), (160, 235, 160)]
    y = 6
    while y < H - 26:
        x = 6 + int(rng.integers(10))
        while x < W - 30:  # run glyphs to the edge: mirror-tiling doubles
            wd = words[int(rng.integers(len(words)))]  # any blank margin
            col = palette[int(rng.integers(len(palette)))]
            draw.text((x, y), wd, fill=col, font=font)
            x += 12 * len(wd) + 14
        y += 28
    return np.asarray(img)


CORPUS_CLASSES = ("photo", "mri", "terrain", "text")


def corpus_video(
    n_frames: int, h: int, w: int, seed: int = 0, motion: str = "normal"
) -> Tuple[np.ndarray, np.ndarray]:
    """Diverse-content video corpus: seed k -> content class k % 4
    (photo / MRI / terrain / rendered text), with k // 4 keying the
    within-class variant (rotation, mirror, light azimuth, text layout) and
    the camera path.  All sources are real-world rasters bundled with
    matplotlib or procedural renders, so nothing is downloaded (BENCHMARKS
    "content diversity"): skin/fabric, anatomy gradients, fractal relief,
    hard glyph edges."""
    cls = CORPUS_CLASSES[seed % len(CORPUS_CLASSES)]
    variant = seed // len(CORPUS_CLASSES)
    src = {
        "photo": _src_photo,
        "mri": _src_mri,
        "terrain": _src_terrain,
        "text": _src_text,
    }[cls](variant)
    canvas = _mirror_tile(src, h, w)
    return _camera_pan_video(
        canvas, n_frames, h, w, np.random.default_rng(seed), motion=motion
    )



def make_frame_store(cfg: DataConfig, device, *, split: str = "train") -> FrameStore:
    """A FrameStore from the frame directory ``data_dir/<dataset>``, else the
    synthetic video (``photo`` / ``corpus``: the real-raster videos) when
    ``synthetic_frames > 0``, on the rung of the ladder its size calls for
    (the module docstring)."""
    device = torch.device(device)
    gap = cfg.frame_gap if split == "train" else cfg.test_gap
    path = os.path.join(cfg.data_dir, cfg.dataset.lower())
    if os.path.isdir(path):
        paths, t = list_frame_paths(path, cfg.vid)
        lazy = DirFrames(paths)
        if lazy.nbytes > host_budget_bytes(cfg):
            print(
                f"frame store: {lazy.nbytes / 2**20:.0f} MiB decoded exceeds "
                f"host budget {cfg.host_budget_mb} MiB; decoding lazily from "
                f"disk ({len(paths)} files)"
            )
            return FrameStore(frames=lazy, t=t, frame_gap=gap, device=device)
        frames, t = load_frame_dir(path, cfg.vid)
    elif cfg.synthetic_frames > 0:
        h, w = cfg.synthetic_hw
        if cfg.dataset in ("photo", "corpus"):
            gen = photo_video if cfg.dataset == "photo" else corpus_video
            frames, t = gen(cfg.synthetic_frames, h, w, seed=cfg.content_seed,
                            motion=cfg.content_motion)
        else:
            frames, t = synthetic_video(cfg.synthetic_frames, h, w, seed=cfg.content_seed)
    else:
        raise FileNotFoundError(f"frame dir {path} not found and synthetic_frames == 0")
    if cfg.cache_device:
        budget = device_budget_bytes(cfg, device)
        if frames.nbytes <= budget:
            return FrameStore(frames=torch.from_numpy(frames).to(device), t=t, frame_gap=gap)
        print(
            f"frame store: video is {frames.nbytes / 2**20:.0f} MiB, over "
            f"the HBM pixel budget ({budget / 2**20:.0f} MiB); keeping it "
            "host-resident — fused epochs will stream chunks"
        )
    if device.type == "cuda":
        frames = pinned_copy(frames)  # so that batch and chunk copies are asynchronous
    return FrameStore(frames=frames, t=t, frame_gap=gap, device=device)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC ``F.adaptive_avg_pool2d``: a reshape-mean for integer ratios (the
    multi-scale targets' case), else torch's bins
    [floor(i*h/oh), ceil((i+1)*h/oh))."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))
    ys = [(int(np.floor(i * h / oh)), int(np.ceil((i + 1) * h / oh))) for i in range(oh)]
    xs = [(int(np.floor(j * w / ow)), int(np.ceil((j + 1) * w / ow))) for j in range(ow)]
    rows = [
        torch.stack([x[:, y0:y1, x0:x1, :].mean(dim=(1, 2)) for x0, x1 in xs], dim=1)
        for y0, y1 in ys
    ]
    return torch.stack(rows, dim=1)
