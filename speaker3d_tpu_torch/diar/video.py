"""Audio-visual diarization: the vision chain on the host, TalkNet's
active-speech scores on the card.

The counterpart of ``speaker3d_tpu/diar/video.py``: detect and track faces
(``build_face_tracks``: greedy IoU tracking, 112x112 bilinear crops, the
quality filter), score active speech per track (``score_tracks_asd``: 4
MFCC frames per crop, each window anchored at its crop's own time), embed
each track's active crops (``embed_tracks``), and flatten the tracks per
frame for ``diar/cluster.py::JointClustering``
(``tracks_to_vision_inputs``). The models come in as callables:

  face_detector(frame_gray [H, W])      -> list of (x, y, w, h)
  face_embedder(face_crops [N, h, w])   -> [N, D] embeddings
  asd_scorer(audio_mfcc, face_crops)    -> per-frame speech scores

``make_talknet_asd_scorer`` is the TalkNet scorer on ``device``. Everything
else here is host numpy, copied from the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def resize_bilinear(patch: np.ndarray, size: int) -> np.ndarray:
    """Vectorised numpy bilinear resize to [size, size], cv2's pixel-centre
    alignment without cv2 (used even where cv2 exists)."""
    h, w = patch.shape[:2]
    if h == 0 or w == 0:
        return np.zeros((size, size), patch.dtype)
    # cv2's pixel-center alignment: sample at (i + 0.5) * scale - 0.5
    fy = np.clip((np.arange(size) + 0.5) * (h / size) - 0.5, 0, h - 1)
    fx = np.clip((np.arange(size) + 0.5) * (w / size) - 0.5, 0, w - 1)
    y0 = np.floor(fy).astype(int)
    x0 = np.floor(fx).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None]
    wx = (fx - x0)[None, :]
    p = patch.astype(np.float32)
    top = p[y0][:, x0] * (1 - wx) + p[y0][:, x1] * wx
    bot = p[y1][:, x0] * (1 - wx) + p[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def crop_sharpness(crops: np.ndarray) -> float:
    """Mean variance-of-Laplacian over a track's crops, the face-quality
    score: blurred or featureless crops (occlusions, motion blur,
    mis-tracks) score low."""
    p = crops.astype(np.float32)
    lap = (p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2]
           + p[:, 1:-1, 2:] - 4.0 * p[:, 1:-1, 1:-1])
    return float(np.mean(np.var(lap.reshape(lap.shape[0], -1), axis=1)))


@dataclasses.dataclass
class FaceTrack:
    """A contiguous single-face track."""

    start_time: float
    frame_times: List[float]
    crops: np.ndarray          # [T, H, W] grayscale face crops
    asd_scores: Optional[np.ndarray] = None
    embedding: Optional[np.ndarray] = None

    @property
    def end_time(self):
        return self.frame_times[-1] if self.frame_times else self.start_time


def build_face_tracks(frames: Sequence[np.ndarray], frame_times: Sequence[float],
                      face_detector: Callable, iou_threshold: float = 0.5,
                      crop_size: int = 112,
                      min_quality: float = 0.0) -> List[FaceTrack]:
    """Greedy IoU tracking of detections across frames. A track lives on
    through up to 10 frames without a match; tracks of fewer than 3 frames
    are dropped, and with ``min_quality`` > 0 those whose mean crop
    sharpness (``crop_sharpness``) falls below it."""

    def iou(a, b):
        ax, ay, aw, ah = a
        bx, by, bw, bh = b
        x1, y1 = max(ax, bx), max(ay, by)
        x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
        inter = max(0, x2 - x1) * max(0, y2 - y1)
        union = aw * ah + bw * bh - inter
        return inter / union if union > 0 else 0.0

    def crop(frame, box):
        x, y, w, h = [int(v) for v in box]
        h_img, w_img = frame.shape[:2]
        x, y = max(0, x), max(0, y)
        patch = frame[y:min(y + h, h_img), x:min(x + w, w_img)]
        if patch.size == 0:
            patch = np.zeros((crop_size, crop_size), frame.dtype)
        return resize_bilinear(patch, crop_size)

    active: List[dict] = []
    done: List[FaceTrack] = []
    for frame, t in zip(frames, frame_times):
        dets = list(face_detector(frame))
        matched = set()
        for tr in active:
            best, best_iou = None, iou_threshold
            for di, d in enumerate(dets):
                if di in matched:
                    continue
                v = iou(tr["box"], d)
                if v >= best_iou:
                    best, best_iou = di, v
            if best is not None:
                matched.add(best)
                tr["box"] = dets[best]
                tr["times"].append(t)
                tr["crops"].append(crop(frame, dets[best]))
                tr["miss"] = 0
            else:
                tr["miss"] += 1
        still = []
        for tr in active:
            if tr["miss"] > 10:
                done.append(FaceTrack(tr["times"][0], tr["times"],
                                      np.stack(tr["crops"])))
            else:
                still.append(tr)
        active = still
        for di, d in enumerate(dets):
            if di not in matched:
                active.append({"box": d, "times": [t],
                               "crops": [crop(frame, d)], "miss": 0})
    for tr in active:
        done.append(FaceTrack(tr["times"][0], tr["times"],
                              np.stack(tr["crops"])))
    done = [t for t in done if len(t.frame_times) >= 3]
    if min_quality > 0.0:
        done = [t for t in done if crop_sharpness(t.crops) >= min_quality]
    return done


def score_tracks_asd(tracks: List[FaceTrack], audio_mfcc: np.ndarray,
                     asd_scorer: Callable, fps: float = 25.0,
                     mfcc_hop_s: float = 0.01) -> None:
    """Attach per-frame active-speech scores to each track.

    The audio slice is taken by TRUE track time (the reference's
    ``t0*4`` indexing assumes 25 fps / 10 ms hop); scorers consume exactly
    4 MFCC frames per visual frame (the TalkNet contract). Each crop's
    4-frame window is anchored at that crop's OWN frame time — tracks may
    contain detection gaps (build_face_tracks keeps a track alive across
    up to 10 missed frames without appending crops), so an evenly spaced
    4:1 grid over the span would misalign audio after any gap.
    """
    for tr in tracks:
        n = len(tr.frame_times)
        span_s = (tr.frame_times[-1] - tr.start_time) + 1.0 / fps
        start = int(round(tr.start_time / mfcc_hop_s))
        dur = max(4, int(round(span_s / mfcc_hop_s)))
        a = audio_mfcc[start:start + dur]
        if a.shape[0] < dur:
            a = np.pad(a, ((0, dur - a.shape[0]), (0, 0)))
        rel = (np.asarray(tr.frame_times) - tr.start_time) / mfcc_hop_s
        base = np.clip(np.round(rel).astype(int), 0, dur - 4)
        idx = (base[:, None] + np.arange(4)[None, :]).reshape(-1)
        tr.asd_scores = np.asarray(asd_scorer(a[idx], tr.crops))


def embed_tracks(tracks: List[FaceTrack], face_embedder: Callable,
                 active_threshold: float = 0.0) -> None:
    for tr in tracks:
        if tr.asd_scores is not None:
            keep = tr.asd_scores > active_threshold
            crops = tr.crops[keep] if keep.any() else tr.crops
        else:
            crops = tr.crops
        embs = np.asarray(face_embedder(crops))
        tr.embedding = embs.mean(axis=0)


def tracks_to_vision_inputs(tracks: List[FaceTrack]):
    """-> (visionX [N, D], visionT [N]) flattened per-frame for
    JointClustering (frames of a track share its embedding)."""
    visionX, visionT = [], []
    for ti, tr in enumerate(tracks):
        for t in tr.frame_times:
            visionX.append(tr.embedding)
            visionT.append(t)
    order = np.argsort(visionT)
    return (np.stack(visionX)[order] if visionX else np.zeros((0, 1)),
            list(np.asarray(visionT)[order]))


def make_talknet_asd_scorer(state_dict, device=DEFAULT_DEVICE, model=None):
    """The TalkNet scorer on ``device``: ``scorer(audio_mfcc [4T, 13],
    face_crops [T, H, W]) -> softmax(scores_av)[:, 1]`` as numpy, one track
    at batch 1, in fp32 with TF32 off. ``state_dict``: a TalkNetModel
    state_dict (None keeps ``model``'s weights)."""
    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.models.talknet import TalkNetModel

    dev = resolve_device(device)
    model = model or TalkNetModel()
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.to(dev).eval()

    def scorer(audio_mfcc, face_crops):
        audio = torch.as_tensor(np.asarray(audio_mfcc, np.float32), device=dev)
        faces = torch.as_tensor(np.asarray(face_crops, np.float32), device=dev)
        with torch.inference_mode(), matmul_precision("float32", dev):
            av, _, _ = model(audio[None], faces[None])
            return torch.softmax(av, dim=-1)[0, :, 1].cpu().numpy()

    return scorer
