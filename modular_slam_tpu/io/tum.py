"""TUM-format RGB-D dataset reader (host side).

Replaces the reference's RgbdFileProvider
(/root/reference/src/lib/modular_slam/rgbd_file_provider.cpp):

- plain directory mode: `root/rgb/*.png` + `root/depth/*.png`, sorted and
  paired 1:1 (rgbd_file_provider.cpp:17-53) — the bundled sample format;
- TUM sequence mode: `root/rgb.txt` + `root/depth.txt` with timestamped
  file lists, associated by nearest timestamp (readTumRgbdDataset
  :109-134 expects associate.py output; we associate directly);
- depth PNGs are 16-bit, scaled by depth_factor (TUM: 1/5000,
  :136-145); rgb PNGs are 8-bit color.

Decoding prefers the native C++ loader (modular_slam_tpu.io.native) when
built, else OpenCV, else the bundled numpy+zlib decoder (viz/png.py,
8-bit RGB and 16-bit gray: what TUM and eval/make_dataset write).  The
host loader produces numpy arrays; the device transfer + grayscale
conversion happens in `frame_to_device`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from modular_slam_tpu.types import LUMA_WEIGHTS  # noqa: E402
from modular_slam_tpu.config import CameraConfig
from modular_slam_tpu.io.associate import associate
from modular_slam_tpu.viz.png import read_png

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")

try:  # optional native decoder (see native/ + io/native.py)
    from modular_slam_tpu.io.native import decode_png as _native_decode
except Exception:  # pragma: no cover - absent until built
    _native_decode = None

try:
    import cv2 as _cv2
except Exception:  # pragma: no cover
    _cv2 = None


def load_rgb(path: str) -> np.ndarray:
    """Load an 8-bit color image as RGB uint8 [H, W, 3]."""
    if _native_decode is not None:
        img = _native_decode(path)
        if img is not None and img.ndim == 3:
            return img
    if _cv2 is not None:
        bgr = _cv2.imread(path, _cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return bgr[..., ::-1].copy()
    img = read_png(path)
    return img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)


def load_depth_raw(path: str) -> np.ndarray:
    """Load a 16-bit depth image as raw uint16 (no factor applied)."""
    if _native_decode is not None:
        raw = _native_decode(path)
        if raw is not None and raw.ndim == 2:
            return raw.astype(np.uint16)
    if _cv2 is not None:
        raw = _cv2.imread(path, _cv2.IMREAD_ANYDEPTH)
        if raw is None:
            raise FileNotFoundError(path)
        return raw.astype(np.uint16)
    return read_png(path).astype(np.uint16)


def load_depth(path: str, depth_factor: float) -> np.ndarray:
    """Load a 16-bit depth image -> float32 meters (0 = invalid)."""
    if _native_decode is not None:
        raw = _native_decode(path)
        if raw is not None and raw.ndim == 2:
            return raw.astype(np.float32) * depth_factor
    if _cv2 is not None:
        raw = _cv2.imread(path, _cv2.IMREAD_ANYDEPTH)
        if raw is None:
            raise FileNotFoundError(path)
        return raw.astype(np.float32) * depth_factor
    return read_png(path).astype(np.float32) * depth_factor


@dataclass
class FrameRecord:
    timestamp: float
    rgb_path: str
    depth_path: str


class TumRgbdDataset:
    """Lazy host-side RGB-D sequence."""

    def __init__(self, root: str, camera: Optional[CameraConfig] = None,
                 max_difference: float = 0.02):
        self.root = root
        # camera resolution order: explicit arg > intrinsics.txt in the
        # sequence dir (written by eval/make_dataset.py) > the TUM preset
        # the reference hardcodes (rgbd_file_provider.cpp:136-145)
        self.camera = camera or _read_intrinsics(
            os.path.join(root, "intrinsics.txt")) or CameraConfig()
        self.records: List[FrameRecord] = []

        rgb_txt = os.path.join(root, "rgb.txt")
        depth_txt = os.path.join(root, "depth.txt")
        if os.path.exists(rgb_txt) and os.path.exists(depth_txt):
            rgb_list = _read_file_list(rgb_txt, root)
            depth_list = _read_file_list(depth_txt, root)
            pairs = associate(
                [t for t, _ in rgb_list], [t for t, _ in depth_list],
                max_difference=max_difference,
            )
            for i, j in pairs:
                self.records.append(
                    FrameRecord(rgb_list[i][0], rgb_list[i][1], depth_list[j][1])
                )
        else:
            rgb_dir = os.path.join(root, "rgb")
            depth_dir = os.path.join(root, "depth")
            rgbs = _list_images(rgb_dir)
            depths = _list_images(depth_dir)
            if len(rgbs) != len(depths):
                # reference init() rejects count mismatch
                # (rgbd_file_provider.cpp:50-53)
                raise ValueError(
                    f"rgb/depth count mismatch: {len(rgbs)} vs {len(depths)}"
                )
            for k, (r, d) in enumerate(zip(rgbs, depths)):
                self.records.append(FrameRecord(float(k), r, d))

        if not self.records:
            raise ValueError(f"no frames found under {root}")

        # optional ground truth for evaluation
        self.groundtruth: Optional[np.ndarray] = None
        gt_txt = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt_txt):
            self.groundtruth = _read_trajectory_file(gt_txt)

    def __len__(self) -> int:
        return len(self.records)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray, float]:
        rec = self.records[idx]
        rgb = load_rgb(rec.rgb_path)
        depth = load_depth(rec.depth_path, self.camera.depth_factor)
        return rgb, depth, rec.timestamp

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for i in range(len(self)):
            yield self.load(i)

    def timestamps(self) -> np.ndarray:
        return np.array([r.timestamp for r in self.records])

    def prefetch_iter(self, n_threads: int = 4, ring: int = 8):
        """Iterate frames through the native decode-ahead loader
        (native/png_loader.cpp); falls back to synchronous decoding when
        the native library is unavailable."""
        try:
            from modular_slam_tpu.io import native

            if not native.available():
                raise RuntimeError
            pl = native.PrefetchLoader(
                [r.rgb_path for r in self.records],
                [r.depth_path for r in self.records],
                n_threads=n_threads, ring=ring,
            )
        except Exception:
            yield from self
            return
        try:
            for i, rec in enumerate(self.records):
                rgb, dep = pl.get(i)
                depth = dep.astype(np.float32) * self.camera.depth_factor
                yield rgb, depth, rec.timestamp
        finally:
            pl.close()

    _LUMA = np.array(LUMA_WEIGHTS, np.float32)

    def wire_iter(self, n_threads: int = 4, ring: int = 8,
                  native_ok: bool = True):
        """Iterate frames in the minimum-byte WIRE format:
        (gray uint8 [H,W], depth uint16 [H,W] raw, timestamp) — for
        `SlamSystem.process_chunk_wire`.  uint8 luma + raw uint16
        depth is 2.3x smaller than rgb + f32 meters, and 8-bit luma is
        the reference's grayscale semantics (frame.cpp toGrayScale).
        Uses the native decode-ahead loader when available."""
        def conv(rgb: np.ndarray, dep16: np.ndarray):
            gray = np.clip(np.round(
                rgb.astype(np.float32) @ self._LUMA), 0, 255
            ).astype(np.uint8)
            return gray, dep16

        try:
            if not native_ok:
                raise RuntimeError
            from modular_slam_tpu.io import native

            if not native.available():
                raise RuntimeError
            # luma conversion happens IN the decode threads (to_gray) so
            # it overlaps PNG decode instead of costing main-thread time
            pl = native.PrefetchLoader(
                [r.rgb_path for r in self.records],
                [r.depth_path for r in self.records],
                n_threads=n_threads, ring=ring, to_gray=True,
            )
        except Exception:
            for rec in self.records:
                rgb = load_rgb(rec.rgb_path)
                dep16 = load_depth_raw(rec.depth_path)
                g, d = conv(rgb, dep16)
                yield g, d, rec.timestamp
            return
        try:
            for i, rec in enumerate(self.records):
                gray, dep = pl.get(i)
                yield gray, dep.astype(np.uint16), rec.timestamp
        finally:
            pl.close()


def _list_images(d: str) -> List[str]:
    if not os.path.isdir(d):
        raise FileNotFoundError(d)
    out = sorted(
        os.path.join(d, f)
        for f in os.listdir(d)
        if f.lower().endswith(_IMG_EXTS)
    )
    return out


def _read_file_list(path: str, root: str) -> List[Tuple[float, str]]:
    out: List[Tuple[float, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), os.path.join(root, parts[1])))
    return out


def _read_intrinsics(path: str) -> Optional[CameraConfig]:
    """`fx fy cx cy depth_factor width height` on one non-comment line."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            return CameraConfig(
                fx=float(v[0]), fy=float(v[1]), cx=float(v[2]),
                cy=float(v[3]), depth_factor=float(v[4]),
                width=int(v[5]), height=int(v[6]))
    return None


def _read_trajectory_file(path: str) -> np.ndarray:
    """TUM trajectory/groundtruth: rows `t x y z qx qy qz qw` -> [N, 8]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    return np.array(rows, dtype=np.float64)


def frame_to_device(rgb: np.ndarray, depth: np.ndarray, timestamp: float):
    """Host numpy frame -> device RgbdFrame with luma grayscale.

    Grayscale uses the reference's 0.299/0.587/0.114 weights
    (frame.cpp:6-27), computed on device as one fused dot.
    """
    import jax.numpy as jnp
    from modular_slam_tpu.types import RgbdFrame

    rgb_d = jnp.asarray(rgb)
    w = jnp.array(LUMA_WEIGHTS, dtype=jnp.float32)
    gray = jnp.tensordot(rgb_d.astype(jnp.float32), w, axes=([-1], [0]))
    return RgbdFrame(
        rgb=rgb_d,
        gray=gray,
        depth=jnp.asarray(depth, dtype=jnp.float32),
        timestamp=jnp.float32(timestamp),
    )
