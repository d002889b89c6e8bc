"""Caption fine-tuning datasets: a directory of images, and a CSV of crops.

The counterpart of the JAX package's `labeling/caption_datasets.py` (ref:
experimenting_env/captioner/captioning_datasets/base_dataset.py,
detection_dataset.py). Images are `.npz` (key `arr_0`) or `.npy` arrays,
or `.png` / `.jpg` files read with PIL, which is imported only for those.
Batches are uint8 crop stacks and token arrays, ready for
`train/captioner_train.train_step`.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path, allow_pickle=True)["arr_0"]
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"reading {path} needs PIL (Pillow), which is not installed; "
            f"store the images as .npz or .npy arrays") from exc
    return np.asarray(Image.open(path).convert("RGB"))


class CaptioningBaseDataset:
    """Directory of images with captions from a sidecar (`captions.csv`
    with columns image,caption, or `captions.json` mapping file name to
    caption) or per-image `.txt` files; images without a caption are
    skipped."""

    def __init__(self, images_dir: str,
                 captions_file: Optional[str] = None):
        self.images_dir = images_dir
        self.items: List[Tuple[str, str]] = []
        caps: Dict[str, str] = {}
        captions_file = captions_file or next(
            (os.path.join(images_dir, n) for n in ("captions.csv",
                                                   "captions.json")
             if os.path.exists(os.path.join(images_dir, n))), None)
        if captions_file and captions_file.endswith(".csv"):
            with open(captions_file) as fh:
                for row in csv.DictReader(fh):
                    caps[row["image"]] = row["caption"]
        elif captions_file and captions_file.endswith(".json"):
            with open(captions_file) as fh:
                caps = json.load(fh)
        for name in sorted(os.listdir(images_dir)):
            if not name.lower().endswith((".png", ".jpg", ".jpeg", ".npz",
                                          ".npy")):
                continue
            path = os.path.join(images_dir, name)
            cap = caps.get(name)
            if cap is None:
                txt = os.path.splitext(path)[0] + ".txt"
                if os.path.exists(txt):
                    with open(txt) as fh:
                        cap = fh.read().strip()
            if cap:
                self.items.append((path, cap))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, str]:
        path, cap = self.items[i]
        return _load_image(path), cap


class DetectionCropDataset:
    """CSV of crops: columns image,x1,y1,x2,y2,caption[,object_id]. Each
    box is expanded by 0.2 of its size on each side and resized to
    `crop_size` (the captioner's input), on `device`."""

    def __init__(self, csv_path: str, crop_size: int = 224,
                 images_root: Optional[str] = None, device="cpu"):
        self.rows: List[Dict] = []
        self.crop_size = crop_size
        self.device = torch.device(device)
        root = images_root or os.path.dirname(os.path.abspath(csv_path))
        with open(csv_path) as fh:
            for row in csv.DictReader(fh):
                path = row["image"]
                if not os.path.isabs(path):
                    path = os.path.join(root, path)
                self.rows.append({
                    "image": path,
                    "box": [float(row["x1"]), float(row["y1"]),
                            float(row["x2"]), float(row["y2"])],
                    "caption": row["caption"],
                    "object_id": int(row.get("object_id", -1) or -1),
                })

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, str, int]:
        from ..ops.detections import expand_boxes
        from ..ops.image import crop_and_resize

        r = self.rows[i]
        img = _load_image(r["image"])
        h, w = img.shape[:2]
        box = expand_boxes(torch.tensor([r["box"]], dtype=torch.float32,
                                        device=self.device), 0.2, h, w)
        crop = crop_and_resize(torch.as_tensor(img, device=self.device)
                               .float(), box, self.crop_size)[0]
        return (np.clip(crop.cpu().numpy(), 0, 255).astype(np.uint8),
                r["caption"], r["object_id"])

    def batches(self, tokenizer, context_length: int, batch_size: int,
                shuffle: bool = True, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Whole batches (the tail dropped), in an order drawn from a numpy
        generator seeded with `seed` when `shuffle`."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            crops, caps, ids = zip(*[self[j] for j in order[i:i + batch_size]])
            yield {
                "image": np.stack(crops),
                "tokens": tokenizer.encode_batch(list(caps), context_length),
                "object_ids": np.asarray(ids, np.int32),
                "valid": np.ones(batch_size, bool),
            }
