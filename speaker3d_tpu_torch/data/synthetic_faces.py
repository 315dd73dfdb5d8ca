"""Rendered synthetic face frames for training and testing the face
detector (``models/face_detector.py``) without an image corpus.

The counterpart of ``speaker3d_tpu/data/synthetic_faces.py``, copied as it
is: a "face" is an ellipse head with darker eye and mouth blobs and radial
shading; distractor shapes (bright rectangles, plain ellipses) teach the
detector what not to fire on. Host numpy, drawing from the caller's
``np.random.Generator``: the same seed renders frames byte-equal to the JAX
package's. Each ellipse's per-pixel arithmetic runs on its bounding box
(plus a margin) instead of the whole frame, which gives the same pixels
~5x faster at 288 x 384. ``cli/train_face_detector.py`` trains on
``render_frame``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _box_grid(frame_shape, x, y, w, h):
    """(rows, cols, ys, xs) of the frame's part that can hold an ellipse
    inscribed in the box (x, y, w, h), with a 2-pixel margin: ys, xs are
    the np.mgrid of those pixels' coordinates."""
    H, W = frame_shape
    y0, y1 = max(int(np.floor(y)) - 2, 0), min(int(np.ceil(y + h)) + 3, H)
    x0, x1 = max(int(np.floor(x)) - 2, 0), min(int(np.ceil(x + w)) + 3, W)
    rows, cols = slice(y0, max(y1, y0)), slice(x0, max(x1, x0))
    ys, xs = np.mgrid[rows, cols]
    return rows, cols, ys, xs


def render_face(frame: np.ndarray, x: int, y: int, w: int, h: int,
                brightness: float = 200.0):
    """Draw one face into `frame` (grayscale uint8-ish float array)."""
    # every pixel the head, eyes and mouth cover lies in the face's box: the
    # JAX package's per-pixel arithmetic, on the box instead of the frame
    rows, cols, ys, xs = _box_grid(frame.shape, x, y, w, h)
    view = frame[rows, cols]
    cx, cy = x + w / 2.0, y + h / 2.0
    # head: filled ellipse with radial shading
    d = ((xs - cx) / (w / 2.0)) ** 2 + ((ys - cy) / (h / 2.0)) ** 2
    head = d <= 1.0
    view[head] = brightness * (1.0 - 0.3 * d[head])
    # eyes: two dark ellipses
    for ex in (cx - 0.25 * w, cx + 0.25 * w):
        ey = cy - 0.15 * h
        de = (((xs - ex) / (0.10 * w)) ** 2
              + ((ys - ey) / (0.08 * h)) ** 2)
        view[de <= 1.0] = 0.25 * brightness
    # mouth: dark horizontal bar
    dm = (((xs - cx) / (0.28 * w)) ** 2
          + ((ys - (cy + 0.3 * h)) / (0.07 * h)) ** 2)
    view[dm <= 1.0] = 0.3 * brightness


def render_frame(rng: np.random.Generator, height: int = 144,
                 width: int = 192, max_faces: int = 2,
                 distractors: int = 2
                 ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """-> (grayscale uint8 frame [H, W], [(x, y, w, h)] face boxes)."""
    frame = rng.uniform(20, 60) + 10.0 * rng.standard_normal((height, width))
    # distractor shapes: bright rectangles / plain ellipses (no features)
    for _ in range(int(rng.integers(0, distractors + 1))):
        w = int(rng.integers(12, 40))
        h = int(rng.integers(12, 40))
        x = int(rng.integers(0, width - w))
        y = int(rng.integers(0, height - h))
        if rng.random() < 0.5:
            frame[y:y + h, x:x + w] = rng.uniform(120, 230)
        else:
            rows, cols, ys, xs = _box_grid(frame.shape, x, y, w, h)
            d = (((xs - (x + w / 2)) / (w / 2)) ** 2
                 + ((ys - (y + h / 2)) / (h / 2)) ** 2)
            frame[rows, cols][d <= 1.0] = rng.uniform(120, 230)

    boxes = []
    n_faces = int(rng.integers(1, max_faces + 1))
    for _ in range(n_faces):
        for _attempt in range(20):
            w = int(rng.integers(24, 56))
            h = int(w * rng.uniform(1.1, 1.4))
            if h >= height - 2:
                continue
            x = int(rng.integers(0, width - w))
            y = int(rng.integers(0, height - h))
            if all(abs((x + w / 2) - (bx + bw / 2)) > (w + bw) / 2
                   or abs((y + h / 2) - (by + bh / 2)) > (h + bh) / 2
                   for bx, by, bw, bh in boxes):
                render_face(frame, x, y, w, h,
                            brightness=rng.uniform(160, 230))
                boxes.append((x, y, w, h))
                break
    return np.clip(frame, 0, 255).astype(np.uint8), boxes


def render_moving_face_video(rng: np.random.Generator, n_frames: int,
                             height: int = 144, width: int = 192,
                             n_faces: int = 2):
    """Frames with faces moving on linear paths -> (frames, boxes_per_frame).
    The 'rendered moving faces' fixture for tracking tests."""
    faces = []
    for _ in range(n_faces):
        w = int(rng.integers(28, 44))
        h = int(w * 1.25)
        x = rng.uniform(0, width - w - 1)
        y = rng.uniform(0, height - h - 1)
        vx = rng.uniform(-2.5, 2.5)
        vy = rng.uniform(-1.5, 1.5)
        faces.append([x, y, w, h, vx, vy])
    frames, boxes_seq = [], []
    for _ in range(n_frames):
        frame = 40.0 + 8.0 * rng.standard_normal((height, width))
        boxes = []
        for f in faces:
            x, y, w, h, vx, vy = f
            render_face(frame, int(x), int(y), w, h, brightness=200.0)
            boxes.append((int(x), int(y), w, h))
            f[0] = x + vx
            f[1] = y + vy
            if not 0 <= f[0] <= width - w - 1:
                f[4] = -vx
                f[0] = x
            if not 0 <= f[1] <= height - h - 1:
                f[5] = -vy
                f[1] = y
        frames.append(np.clip(frame, 0, 255).astype(np.uint8))
        boxes_seq.append(boxes)
    return frames, boxes_seq
