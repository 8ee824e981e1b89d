"""Image preprocessing utilities (reference python/paddle/v2/image.py).

The reference uses cv2; here the transforms are pure numpy (HWC uint8 or
float arrays), so the hermetic environment needs no vision dependency.
`load_image` tries PIL then cv2 and raises a pointed error when neither
is available — decoding bytes is the only step that genuinely needs a
codec."""
from __future__ import annotations

import numpy as np

__all__ = [
    "load_image", "load_image_bytes", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def _resize_bilinear(im, h, w):
    """HWC (or HW) bilinear resize, align-corners=False (the cv2 default
    the reference relied on)."""
    im = np.asarray(im)
    src_h, src_w = im.shape[:2]
    if (src_h, src_w) == (h, w):
        return im.copy()
    ys = (np.arange(h) + 0.5) * src_h / h - 0.5
    xs = (np.arange(w) + 0.5) * src_w / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, src_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, src_w - 1)
    y1 = np.clip(y0 + 1, 0, src_h - 1)
    x1 = np.clip(x0 + 1, 0, src_w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if im.ndim == 3:
        fy, fx = fy[..., None], fx[..., None]
    a = im[y0][:, x0].astype(np.float64)
    b = im[y0][:, x1].astype(np.float64)
    c = im[y1][:, x0].astype(np.float64)
    d = im[y1][:, x1].astype(np.float64)
    out = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
           + c * fy * (1 - fx) + d * fy * fx)
    return out.astype(im.dtype) if np.issubdtype(im.dtype, np.integer) \
        else out.astype(im.dtype)


def load_image_bytes(bytes, is_color=True):  # noqa: A002 (reference name)
    """Decode an encoded image buffer. Needs PIL or cv2."""
    import io

    try:
        from PIL import Image

        img = Image.open(io.BytesIO(bytes))
        img = img.convert("RGB" if is_color else "L")
        return np.asarray(img)
    except ImportError:
        pass
    try:
        import cv2

        flag = 1 if is_color else 0
        arr = np.frombuffer(bytes, dtype=np.uint8)
        return cv2.imdecode(arr, flag)
    except ImportError:
        raise ImportError(
            "decoding image bytes needs PIL or cv2; the numpy-only "
            "transforms (resize/crop/flip) work on already-decoded arrays")


def load_image(file, is_color=True):  # noqa: A002
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color=is_color)


def resize_short(im, size):
    """Resize so the SHORT edge becomes `size`, keeping aspect ratio
    (reference image.py:163)."""
    h, w = im.shape[:2]
    if h > w:
        return _resize_bilinear(im, int(round(h * size / w)), size)
    return _resize_bilinear(im, size, int(round(w * size / h)))


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference image.py:189)."""
    return np.asarray(im).transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0, w0 = (h - size) // 2, (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> (random|center) crop (+ random flip when training)
    -> CHW float32 -> optional mean subtraction (reference image.py:291)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color=is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean if mean.ndim != 1 else mean[:, None, None]
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pickle batches of (encoded image, label) pairs out of a tar archive
    (reference image.py:48) — used by the legacy flowers pipeline."""
    import os
    import pickle
    import tarfile

    out_path = f"{data_file}.{dataset_name}.batch"
    meta = {"file_list": [], "num_samples": 0}
    if os.path.isdir(out_path):
        return out_path
    os.makedirs(out_path, exist_ok=True)
    data, labels, nfile = [], [], 0
    with tarfile.open(data_file) as tf:
        for member in tf.getmembers():
            if member.name not in img2label:
                continue
            data.append(tf.extractfile(member).read())
            labels.append(img2label[member.name])
            meta["num_samples"] += 1
            if len(data) == num_per_batch:
                name = os.path.join(out_path, f"batch_{nfile}")
                with open(name, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f,
                                protocol=2)
                meta["file_list"].append(name)
                data, labels, nfile = [], [], nfile + 1
    if data:
        name = os.path.join(out_path, f"batch_{nfile}")
        with open(name, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f, protocol=2)
        meta["file_list"].append(name)
    with open(os.path.join(out_path, "batch_meta"), "wb") as f:
        pickle.dump(meta, f, protocol=2)
    return out_path
