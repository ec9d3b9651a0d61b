"""COLMAP sparse-model reader and IDR camera conversion (port of
``vf_nerf_tpu/datasets/helpers/colmap.py``; reference
``datasets/helpers/colmap_2_dtu.py``).

A reader of the documented COLMAP binary and text formats covering what
the converter needs (cameras and image poses), and the conversion:
``world_mat_{i} = K @ [R|t]`` per image, keyed in image-name order, written
as IDR's ``cameras_before_normalization.npz``. Host numpy.

CLI:
    python -m vf_nerf_torch.datasets.helpers.colmap \
        --model_dir sparse/0 --out cameras_before_normalization.npz
"""

from __future__ import annotations

import argparse
import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# Subset of COLMAP camera models: model_id → (name, num_params).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def intrinsic_matrix(self) -> np.ndarray:
        k = np.eye(3, dtype=np.float64)
        if self.model == "SIMPLE_PINHOLE" or "SIMPLE_RADIAL" in self.model \
                or self.model == "FOV":
            f, cx, cy = self.params[0], self.params[1], self.params[2]
            k[0, 0] = k[1, 1] = f
        else:
            fx, fy, cx, cy = self.params[:4]
            k[0, 0], k[1, 1] = fx, fy
        k[0, 2], k[1, 2] = cx, cy
        return k


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray   # [w, x, y, z]
    tvec: np.ndarray
    camera_id: int
    name: str

    def world_to_cam(self) -> np.ndarray:
        """(3, 4) [R|t] world→camera."""
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]])
        return np.concatenate([rot, self.tvec[:, None]], axis=1)


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height,
                                           params)
    return cameras


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            camera_id = _read(f, "<i")[0]
            name_chars = []
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_chars.append(c)
            name = b"".join(name_chars).decode("utf-8")
            (n_pts,) = _read(f, "<Q")
            f.seek(n_pts * 24, os.SEEK_CUR)  # skip 2 doubles + 1 int64 each
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name)
    return images


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            cameras[cam_id] = ColmapCamera(
                cam_id, model, int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cameras


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    # Two lines per image: metadata + 2D points (skipped).
    for meta in lines[::2]:
        parts = meta.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return images


def read_model(model_dir: str
               ) -> Tuple[Dict[int, ColmapCamera], Dict[int, ColmapImage]]:
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        return (read_cameras_binary(os.path.join(model_dir, "cameras.bin")),
                read_images_binary(os.path.join(model_dir, "images.bin")))
    return (read_cameras_text(os.path.join(model_dir, "cameras.txt")),
            read_images_text(os.path.join(model_dir, "images.txt")))


def colmap_to_idr_cameras(model_dir: str, out_path: str) -> Dict[str, np.ndarray]:
    """Write IDR-format ``world_mat_{i} = K @ [R|t]`` (4×4, last row
    [0,0,0,1]) keyed by image-name sort order (the reference converter's
    output contract, ``colmap_2_dtu.py:450-471``)."""
    cameras, images = read_model(model_dir)
    ordered = sorted(images.values(), key=lambda im: im.name)
    payload: Dict[str, np.ndarray] = {}
    for i, image in enumerate(ordered):
        k = cameras[image.camera_id].intrinsic_matrix()
        world_mat = np.eye(4)
        world_mat[:3] = k @ image.world_to_cam()
        payload[f"world_mat_{i}"] = world_mat
    np.savez(out_path, **payload)
    return payload


def main() -> None:
    parser = argparse.ArgumentParser(
        description="COLMAP sparse model → IDR cameras npz")
    parser.add_argument("--model_dir", required=True,
                        help="COLMAP sparse model dir (bin or txt)")
    parser.add_argument("--out", default="cameras_before_normalization.npz")
    args = parser.parse_args()
    payload = colmap_to_idr_cameras(args.model_dir, args.out)
    print(f"wrote {len(payload)} cameras to {args.out}")


if __name__ == "__main__":
    main()
