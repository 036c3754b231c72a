"""Frame store: the video as one uint8 tensor resident on the device (port of
the in-core part of ``repnerv_tpu/data/frames.py``).

Each sample is ``(frame / 255, idx / len)``; ``frame_gap`` strides the
sampling.  A step gathers its frames on the device from an index tensor, so
no pixels cross from the host after the first copy.  A video over the
device budget raises: the out-of-core ladder (host streaming, lazy frame
directories) is ROADMAP A7, as are the photo and corpus generators.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DataConfig

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


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
    from PIL import Image  # only this path needs PIL

    paths, t_all = list_frame_paths(main_dir, vid_list)
    frames = []
    for p in paths:
        with Image.open(p) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
        if arr.shape[0] > arr.shape[1]:
            arr = arr.transpose(1, 0, 2)
        frames.append(arr)
    return np.stack(frames), t_all


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


@dataclass
class FrameStore:
    """The video [N, H, W, 3] uint8 on a device, with gap sampling."""

    frames: torch.Tensor  # [N, H, W, 3] uint8
    t: np.ndarray  # [N] normalized indices over the full source sequence
    frame_gap: int = 1

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
        """[B, H, W, 3] f32 in [0, 1]: a device-side gather, then /255."""
        rows = torch.as_tensor(rows, dtype=torch.long, device=self.frames.device)
        return self.frames[rows].float() / 255.0


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


def make_frame_store(cfg: DataConfig, device, *, split: str = "train") -> FrameStore:
    """A FrameStore from ``data_dir/<dataset>`` (decoded in core), else the
    synthetic video when ``synthetic_frames > 0``."""
    device = torch.device(device)
    gap = cfg.frame_gap if split == "train" else cfg.test_gap
    path = os.path.join(cfg.data_dir, cfg.dataset.lower())
    if os.path.isdir(path):
        frames, t = load_frame_dir(path, cfg.vid)
    elif cfg.synthetic_frames > 0:
        if cfg.dataset in ("photo", "corpus"):
            raise NotImplementedError(
                f"--dataset {cfg.dataset}: the photo and corpus generators are not ported "
                "yet (ROADMAP A7)"
            )
        h, w = cfg.synthetic_hw
        frames, t = synthetic_video(cfg.synthetic_frames, h, w, seed=cfg.content_seed)
    else:
        raise FileNotFoundError(f"frame dir {path} not found and synthetic_frames == 0")
    budget = device_budget_bytes(cfg, device)
    if frames.nbytes > budget:
        raise NotImplementedError(
            f"the video is {frames.nbytes / 2**20:.0f} MiB, over the device pixel budget "
            f"({budget / 2**20:.0f} MiB); out-of-core training is not ported yet (ROADMAP A7)"
        )
    return FrameStore(frames=torch.from_numpy(frames).to(device), t=t, frame_gap=gap)


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
