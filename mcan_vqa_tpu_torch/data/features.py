"""Region features: padding, the BUTD npz files and the packed cache (the
port's copy of mcan_vqa_tpu/data/features.py).

The reference reads one ``.npz`` per image (core/data/load_data.py:99-150).
``PackedFeatureCache`` packs a split's files once into one flat fp16
memmap with an index, so a lookup is two memmap slices: no file open, no
zlib, no transpose. The JAX package's native C++ batcher over the cache is
not ported; batches are assembled in numpy.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def pad_img_feat(img_feat: np.ndarray, pad_size: int) -> np.ndarray:
    """Truncate to, or zero-pad rows up to, ``pad_size`` (reference
    core/data/data_utils.py:119-130). Pad rows stay all zero: the model
    recovers the pad mask from them."""
    if img_feat.shape[0] > pad_size:
        img_feat = img_feat[:pad_size]
    out = np.zeros((pad_size,) + img_feat.shape[1:], dtype=img_feat.dtype)
    out[: img_feat.shape[0]] = img_feat
    return out


def iid_from_path(path: str) -> str:
    """The COCO image id of a BUTD feature file name
    (COCO_val2014_000000000042.jpg.npz -> "42"; reference
    core/data/data_utils.py:20-27)."""
    return str(int(path.split("/")[-1].split("_")[-1].split(".")[0]))


def glob_feature_paths(feat_dir: str) -> Dict[str, str]:
    """{image_id: npz path} of one split's directory."""
    return {iid_from_path(p): p
            for p in glob.glob(os.path.join(feat_dir, "*.npz"))}


def load_npz_feature(path: str) -> np.ndarray:
    """One BUTD npz -> features [n_regions, 2048] (stored transposed as
    "x" [2048, n]; reference core/data/load_data.py:116-117)."""
    with np.load(path) as z:
        return z["x"].transpose(1, 0)


class PackedFeatureCache:
    """A split's region features in one flat fp16 memmap. Under
    ``cache_dir``:

      features.bin   float16 [total_rows, feat_dim]
      index.json     {"index": {image_id: [row_start, n_rows]}, feat_dim,
                     total_rows}
      bbox.bin       float32 [total_rows, 4], where the npz files had boxes
    """

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        with open(os.path.join(cache_dir, "index.json")) as f:
            meta = json.load(f)
        self.feat_dim: int = meta["feat_dim"]
        self.index: Dict[str, Tuple[int, int]] = {
            k: tuple(v) for k, v in meta["index"].items()}
        self._mm = np.memmap(os.path.join(cache_dir, "features.bin"),
                             dtype=np.float16, mode="r",
                             shape=(meta["total_rows"], self.feat_dim))
        bbox_path = os.path.join(cache_dir, "bbox.bin")
        self._bbox = None
        if os.path.exists(bbox_path):
            self._bbox = np.memmap(bbox_path, dtype=np.float32, mode="r",
                                   shape=(meta["total_rows"], 4))

    def __contains__(self, iid: str) -> bool:
        return iid in self.index

    def get(self, iid: str) -> np.ndarray:
        start, n = self.index[iid]
        return np.asarray(self._mm[start: start + n])

    def get_padded(self, iid: str, pad_size: int,
                   dtype=np.float32) -> np.ndarray:
        start, n = self.index[iid]
        n = min(n, pad_size)
        out = np.zeros((pad_size, self.feat_dim), dtype=dtype)
        out[:n] = self._mm[start: start + n]
        return out

    def get_bboxes(self, iid: str, pad_size: Optional[int] = None):
        """The regions' boxes [n, 4] (padded to ``pad_size`` rows), or None
        where the cache was packed without them."""
        if self._bbox is None:
            return None
        start, n = self.index[iid]
        boxes = np.asarray(self._bbox[start: start + n])
        if pad_size is not None:
            boxes = pad_img_feat(boxes[:pad_size], pad_size)
        return boxes

    @staticmethod
    def build(npz_dir_or_paths, cache_dir: str, feat_dim: int = 2048,
              log_every: int = 5000) -> "PackedFeatureCache":
        """Pack npz files (a directory or a list of paths) into
        ``cache_dir``. A bbox.bin of an earlier build there is removed
        first and written again only if these files carry boxes; two files
        of one image id are refused."""
        if isinstance(npz_dir_or_paths, str):
            paths = sorted(glob.glob(os.path.join(npz_dir_or_paths,
                                                  "*.npz")))
        else:
            paths = list(npz_dir_or_paths)
        os.makedirs(cache_dir, exist_ok=True)
        bbox_path = os.path.join(cache_dir, "bbox.bin")
        if os.path.exists(bbox_path):
            os.remove(bbox_path)

        index: Dict[str, List[int]] = {}
        total = 0
        for p in paths:
            with np.load(p) as z:
                n = z["x"].shape[1]
            iid = iid_from_path(p)
            if iid in index:
                raise ValueError(
                    f"duplicate image id {iid!r} in the input set "
                    f"(second occurrence: {p}) -- every npz must map to "
                    f"a unique image id")
            index[iid] = [total, n]
            total += n

        mm = np.memmap(os.path.join(cache_dir, "features.bin"),
                       dtype=np.float16, mode="w+",
                       shape=(max(total, 1), feat_dim))
        bb = None
        for i, p in enumerate(paths):
            start, n = index[iid_from_path(p)]
            with np.load(p) as z:
                mm[start: start + n] = z["x"].transpose(1, 0).astype(
                    np.float16)
                if "bbox" in z.files:
                    if bb is None:     # rows packed before stay zero
                        bb = np.memmap(bbox_path, dtype=np.float32,
                                       mode="w+", shape=(max(total, 1), 4))
                    bb[start: start + n] = z["bbox"][:, :4]
            if log_every and i % log_every == 0:
                print(f"packing features: {i}/{len(paths)}", flush=True)
        mm.flush()
        if bb is not None:
            bb.flush()
        with open(os.path.join(cache_dir, "index.json"), "w") as f:
            json.dump({"feat_dim": feat_dim, "total_rows": max(total, 1),
                       "index": index}, f)
        return PackedFeatureCache(cache_dir)
