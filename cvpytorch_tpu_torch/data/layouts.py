"""Dataset directories in each format's own layout, written from seeded
numpy and given JPEG files (no download): VOCdevkit, ADE20K / Camvid /
Portrait image-mask folders, VisDrone-DET and -MOT, the WIDER FACE list
and PennFudanPed.  ``tests/test_torch_voc_misc_datasets.py`` holds the
port's datasets to the JAX package's on them and ``chip_smoke.py`` trains
the configs on them.  Each writer returns what a config's ``DATASET``
stage needs (``IMG_DIR``, ``LABELS``, ``INDICES``, ``ANN_FILE``).

Every file is one the real datasets hold: JPEG images are copies of the
given files, PNG images and gray masks come from ``png.write_png``, VOC
and PennFudan masks are palette PNGs (``png.write_palette_png``), VOC's
with 255 borders around each object.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from .image_io import imread
from .png import write_palette_png, write_png


def voc_palette() -> list[int]:
    """VOC's colour map: the bits of the index spread over R, G, B."""
    pal = []
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal += [r, g, b]
    return pal


def smooth_image(rng, h: int, w: int) -> np.ndarray:
    """A (h, w, 3) BGR uint8 image: gradients and noise."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1)
    return ((base + rng.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def _box(rng, h: int, w: int, lo: float = 0.1, hi: float = 0.5) -> tuple[int, int, int, int]:
    """Integer (x0, y0, x1, y1), 0 ≤ x0 < x1 ≤ w, of a box of lo–hi of the image."""
    bw = max(int(rng.uniform(lo, hi) * w), 2)
    bh = max(int(rng.uniform(lo, hi) * h), 2)
    x0 = int(rng.randint(0, w - bw + 1))
    y0 = int(rng.randint(0, h - bh + 1))
    return x0, y0, x0 + bw, y0 + bh


def _copy_jpegs(jpegs, n: int, out_dir: str, names) -> list[tuple[int, int]]:
    """Copies ``jpegs`` (cycled) to ``out_dir/<name>.jpg``; their (h, w)."""
    os.makedirs(out_dir, exist_ok=True)
    shapes = {}
    out = []
    for i in range(n):
        src = jpegs[i % len(jpegs)]
        if src not in shapes:
            shapes[src] = imread(src).shape[:2]
        shutil.copyfile(src, os.path.join(out_dir, f"{names[i]}.jpg"))
        out.append(shapes[src])
    return out


def write_voc(root: str, jpegs, names, n: int, n_train: int, seed: int = 0) -> dict:
    """VOCdevkit/VOC2012 of ``n`` ids: ``JPEGImages/<id>.jpg``,
    ``Annotations/<id>.xml`` (1–4 objects of ``names``, every third image
    also one whose name is in no dictionary; ``difficult`` 1, 0, empty or
    absent), ``SegmentationClass/<id>.png`` palette masks (each object's
    box its class index + 1 with a 3-pixel 255 border), and
    ``ImageSets/Segmentation/{train,val}.txt``.  The first id's image is a
    ``.png``, which only ``VOCDetection`` reads (from the sorted
    ``Annotations``); the split files list the next ``n_train`` ids, then
    the rest.  → {'IMG_DIR', 'train', 'val' (INDICES files)}."""
    rng = np.random.RandomState(seed)
    ids = [f"2008_{i:06d}" for i in range(n)]
    for d in ("JPEGImages", "Annotations", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    img_dir = os.path.join(root, "JPEGImages")
    h, w = 375, 500
    write_png(os.path.join(img_dir, f"{ids[0]}.png"), smooth_image(rng, h, w))
    shapes = [(h, w)] + _copy_jpegs(jpegs, n - 1, img_dir, ids[1:])
    palette = voc_palette()
    for i, (iid, (h, w)) in enumerate(zip(ids, shapes)):
        mask = np.zeros((h, w), np.uint8)
        objs = []
        for k in range(rng.randint(1, 5)):
            c = int(rng.randint(len(names)))
            x0, y0, x1, y1 = _box(rng, h, w)
            mask[max(y0 - 3, 0):y1 + 3, max(x0 - 3, 0):x1 + 3] = 255
            mask[y0:y1, x0:x1] = c + 1
            diff = ("<difficult>1</difficult>", "<difficult>0</difficult>",
                    "<difficult></difficult>", "")[k % 4]
            objs.append((names[c], diff, (x0 + 1, y0 + 1, x1, y1)))
        if i % 3 == 0:
            objs.append(("notaclass", "", _box(rng, h, w)))
        body = "".join(
            f"<object><name> {name} </name><pose>Left</pose>{diff}<bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax>"
            "</bndbox></object>" for name, diff, b in objs)
        with open(os.path.join(root, "Annotations", f"{iid}.xml"), "w") as f:
            f.write(f"<annotation><folder>VOC2012</folder><filename>{iid}.jpg</filename>"
                    f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
                    f"{body}</annotation>")
        write_palette_png(os.path.join(root, "SegmentationClass", f"{iid}.png"), mask, palette)
    out = {"IMG_DIR": root}
    for split, part in (("train", ids[1:1 + n_train]), ("val", ids[1 + n_train:])):
        path = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
        with open(path, "w") as f:
            f.write("".join(f"{i}\n" for i in part))
        out[split] = path
    return out


def write_paired_seg(root: str, n: int, num_classes: int, seed: int = 0,
                     jpegs=None, offset: int = 0, seg_dir: bool = True,
                     size: tuple[int, int] = (48, 64)) -> dict:
    """ADE20K / Portrait (``jpegs`` given: ``images/<sub>/<name>.jpg``) or
    Camvid (``.png`` images of ``size``) folders, with gray masks of class
    ids + ``offset`` (ADE20K's are 1-based, 0 unlabelled) under
    ``annotations/`` mirroring the images' paths, or beside the images
    without ``seg_dir``.  → {'IMG_DIR', 'SEG_DIR' or None}."""
    rng = np.random.RandomState(seed)
    img_root = os.path.join(root, "images")
    ann_root = os.path.join(root, "annotations") if seg_dir else img_root
    for i in range(n):
        sub = f"part{i % 2}"
        os.makedirs(os.path.join(img_root, sub), exist_ok=True)
        os.makedirs(os.path.join(ann_root, sub), exist_ok=True)
        name = f"frame_{i:04d}"
        if jpegs is not None:
            (h, w), = _copy_jpegs([jpegs[i % len(jpegs)]], 1, os.path.join(img_root, sub),
                                  [name])
        else:
            h, w = size
            write_png(os.path.join(img_root, sub, name + ".png"), smooth_image(rng, h, w))
        if jpegs is None and not seg_dir:
            continue  # Camvid without SEG_DIR: the image is its own mask
        mask = rng.randint(0, num_classes, (h, w)) + offset
        if offset:
            mask[:h // 5] = 0  # unlabelled
        write_png(os.path.join(ann_root, sub, name + ".png"), mask.astype(np.uint8))
    return {"IMG_DIR": img_root, "SEG_DIR": ann_root if seg_dir else None}


def write_visdrone(root: str, jpegs, n: int, seed: int = 0) -> str:
    """VisDrone2019-DET: ``images/*.jpg`` and ``annotations/*.txt`` rows
    ``x,y,w,h,score,category,truncation,occlusion`` over categories 0–11
    (0 ignored regions, 11 others), some boxes under 2 pixels, trailing
    commas, a short row; one image without its txt.  → IMG_DIR."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    names = [f"{i:07d}_{seed:05d}_d_{i:07d}" for i in range(n)]
    shapes = _copy_jpegs(jpegs, n, img_dir, names)
    for i, (name, (h, w)) in enumerate(zip(names, shapes)):
        if i == n - 1:
            break  # no annotation file
        rows = []
        for k in range(rng.randint(4, 40)):
            x0, y0, x1, y1 = _box(rng, h, w, 0.01, 0.2)
            bw, bh = x1 - x0, y1 - y0
            if k % 9 == 5:
                bw = 1  # under 2 pixels
            cat = int(rng.randint(0, 12))
            rows.append(f"{x0},{y0},{bw},{bh},{int(cat != 0)},{cat},{rng.randint(2)},"
                        f"{rng.randint(3)}" + ("," if k % 2 else ""))
        rows.append("1,2,3")  # too short: skipped
        with open(os.path.join(ann_dir, name + ".txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return img_dir


def write_visdrone_mot(root: str, jpegs, n_seq: int, n_frames: int, seed: int = 0) -> str:
    """VisDrone2019-MOT: ``sequences/<seq>/<frame>.jpg`` and
    ``annotations/<seq>.txt`` rows ``frame,id,x,y,w,h,score,category,...``.
    → IMG_DIR."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for s in range(n_seq):
        seq = f"uav{s:07d}_{seed:05d}_v"
        shapes = _copy_jpegs(jpegs, n_frames, os.path.join(root, "sequences", seq),
                             [f"{f + 1:07d}" for f in range(n_frames)])
        rows = []
        for f, (h, w) in enumerate(shapes):
            for tid in range(rng.randint(2, 8)):
                x0, y0, x1, y1 = _box(rng, h, w, 0.01, 0.3)
                cat = int(rng.randint(0, 12))
                bw = 1 if tid == 5 else x1 - x0
                rows.append(f"{f + 1},{tid + 1},{x0},{y0},{bw},{y1 - y0},1,{cat},0,0")
        with open(os.path.join(root, "annotations", seq + ".txt"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return root


def write_widerface(root: str, jpegs, n: int, seed: int = 0) -> dict:
    """WIDER FACE: ``images/<event>/<name>.jpg`` and the
    ``wider_face_train_bbx_gt.txt`` list (path, count, ``x y w h blur
    expression illumination invalid occlusion pose`` rows); every fourth
    entry has count 0 and its one row of zeros, some faces are 2 pixels or
    less.  → {'IMG_DIR', 'ANN_FILE'}."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    lines = []
    for i in range(n):
        event = f"{i % 3}--Event"
        name = f"{i % 3}_Event_{i:04d}"
        (h, w), = _copy_jpegs([jpegs[i % len(jpegs)]], 1, os.path.join(img_dir, event), [name])
        lines.append(f"{event}/{name}.jpg")
        k = 0 if i % 4 == 3 else int(rng.randint(1, 6))
        lines.append(str(k))
        for j in range(k):
            x0, y0, x1, y1 = _box(rng, h, w, 0.005, 0.2)
            bw = 2 if j == 1 else x1 - x0
            lines.append(f"{x0} {y0} {bw} {y1 - y0} 0 0 0 0 0 0 ")
        if k == 0:
            lines.append("0 0 0 0 0 0 0 0 0 0 ")
    ann = os.path.join(root, "wider_face_train_bbx_gt.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"IMG_DIR": img_dir, "ANN_FILE": ann}


def write_pennfudan(root: str, n: int, seed: int = 0, palette: bool = True,
                    size: tuple[int, int] = (360, 480)) -> str:
    """PennFudanPed: ``PNGImages/FudanPedNNNNN.png`` RGB images of about
    ``size`` and ``PedMasks/FudanPedNNNNN_mask.png`` instance maps (0
    background, 1..k one pedestrian each, overlapping in paint order), as
    palette PNGs like the dataset's, or gray ones.  → IMG_DIR."""
    rng = np.random.RandomState(seed)
    for d in ("PNGImages", "PedMasks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    colours = [0, 0, 0] + rng.randint(0, 256, 3 * 255).tolist()
    for i in range(n):
        h = size[0] + int(rng.randint(-40, 41))
        w = size[1] + int(rng.randint(-60, 61))
        name = f"FudanPed{i + 1:05d}"
        write_png(os.path.join(root, "PNGImages", name + ".png"), smooth_image(rng, h, w))
        mask = np.zeros((h, w), np.uint8)
        for k in range(1, rng.randint(1, 5) + 1):
            x0, y0, x1, y1 = _box(rng, h, w, 0.1, 0.4)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            cy, cx = (y0 + y1 - 1) / 2, (x0 + x1 - 1) / 2
            inside = ((yy - cy) / max((y1 - y0) / 2, 1)) ** 2 + \
                ((xx - cx) / max((x1 - x0) / 2, 1)) ** 2 <= 1
            mask[y0:y1, x0:x1][inside] = k
        path = os.path.join(root, "PedMasks", name + "_mask.png")
        if palette:
            write_palette_png(path, mask, colours)
        else:
            write_png(path, mask)
    return root
