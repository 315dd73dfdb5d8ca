"""Overlap-aware diarization post-processing (host numpy, float64).

The counterpart of ``speaker3d_tpu/diar/overlap.py``, copied as it is: a
sliding-window segmentation model gives per-chunk frame-level speaker
activations; the per-frame speaker COUNT gates how many clusters may be
active; per-chunk Hungarian alignment maps segmentation channels to global
clusters; frames where clustering found speech but the gated activations
are empty fall back to the cluster assignment.

The segmentation model is pluggable (``diar/dnn_seg.py::DnnSegmenter``):
anything returning ``SlidingSegmentation`` works.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np


@dataclasses.dataclass
class SlidingSegmentation:
    """Chunked frame-level speaker activations.

    data: [num_chunks, frames_per_chunk, num_classes] binary/probability.
    chunk_starts: [num_chunks] start time (s) of each chunk.
    frame_step: seconds per frame.
    frame_duration: seconds covered by one frame window.
    """

    data: np.ndarray
    chunk_starts: np.ndarray
    frame_step: float
    frame_duration: float = 0.0

    @property
    def num_chunks(self):
        return self.data.shape[0]


@dataclasses.dataclass
class FrameCount:
    """Aggregated per-frame speaker count over the whole file.
    (reference: `count` with SlidingWindowFeature semantics)"""

    data: np.ndarray          # [num_frames] int
    frame_step: float
    frame_duration: float = 0.0

    def closest_frame(self, t: float) -> int:
        return int(np.rint((t - 0.5 * self.frame_duration) / self.frame_step))

    def middle(self, i: int) -> float:
        # 0.5*(start+end), NOT start + 0.5*duration: mirrors pyannote
        # Segment.middle's float rounding exactly (the two differ in the
        # last ulp and the reference's merged vad_time inherits the value)
        s = i * self.frame_step
        return 0.5 * (s + (s + self.frame_duration))

    def __len__(self):
        return len(self.data)


def aggregate_count(seg: SlidingSegmentation, num_frames: int,
                    threshold: float = 0.5) -> FrameCount:
    """Per-frame speaker count: mean over overlapping chunk activations,
    rounded (reference: binarize + Inference.aggregate + np.rint)."""
    total = np.zeros(num_frames)
    weight = np.zeros(num_frames)
    binary = (seg.data > threshold).astype(np.float64)
    fpc = seg.data.shape[1]
    for c in range(seg.num_chunks):
        start = int(np.rint(seg.chunk_starts[c] / seg.frame_step))
        end = min(start + fpc, num_frames)
        if start >= num_frames:
            continue
        n = end - start
        total[start:end] += binary[c, :n].sum(axis=-1)
        weight[start:end] += 1.0
    counts = np.rint(total / np.maximum(weight, 1.0)).astype(np.uint8)
    return FrameCount(counts, seg.frame_step, seg.frame_duration)


def get_valid_field(count: FrameCount) -> List[List[float]]:
    """Intervals where the segmentation count is nonzero.
    (reference: bin/infer_diarization.py:761-773)"""
    valid = []
    start = None
    for i in range(len(count)):
        c = count.data[i]
        if c == 0 or i == len(count) - 1:
            if start is not None:
                valid.append([start, count.middle(i)])
                start = None
        else:
            if start is None:
                start = count.middle(i)
    return valid


def run_segmentation(segmentation_model: Callable, wav: np.ndarray,
                     sample_rate: int, threshold: float = 0.5) -> tuple:
    """Run a pluggable segmentation model -> (SlidingSegmentation, FrameCount).

    ``threshold`` binarizes per-speaker activations before the speaker
    count is aggregated (the reference hardcodes pyannote's 0.5; an
    in-repo segmenter's operating point is tunable — raising it trades
    overlap recall for count false alarms)."""
    seg: SlidingSegmentation = segmentation_model(wav, sample_rate)
    duration = len(wav) / sample_rate
    num_frames = int(np.ceil(duration / seg.frame_step))
    return seg, aggregate_count(seg, num_frames, threshold=threshold)


def post_process(output_field_labels: Sequence[Sequence],
                 speaker_num: int, seg: SlidingSegmentation,
                 count: FrameCount, threshold: float = 0.5):
    """Refine cluster segments with overlap-aware activations.
    (reference: bin/infer_diarization.py:651-702; ``threshold`` binarizes
    the segmenter activations, same knob as run_segmentation)"""
    from scipy.optimize import linear_sum_assignment

    num_frames = len(count)
    cluster_frames = np.zeros((num_frames, speaker_num))
    half = 0.5 * count.frame_duration
    for st, ed, cid in output_field_labels:
        a = max(count.closest_frame(st + half), 0)
        b = max(count.closest_frame(ed + half), 0)
        cluster_frames[a:b, int(cid)] = 1.0

    activations = np.zeros((num_frames, speaker_num))
    num_chunks, fpc, num_classes = seg.data.shape
    binary_seg = (seg.data > threshold).astype(np.float64)
    for c in range(num_chunks):
        start_frame = max(count.closest_frame(seg.chunk_starts[c] + half), 0)
        end_frame = min(start_frame + fpc, num_frames)
        n = end_frame - start_frame
        if n <= 0:
            continue
        data = binary_seg[c, :n]
        chunk_cluster = cluster_frames[start_frame:end_frame]
        cost = []
        for j in range(num_classes):
            if data[:, j].sum() > 0:
                cost.append([(data[:, j].astype(int) & d.astype(int)).sum()
                             for d in chunk_cluster.T])
            else:
                cost.append([-1] * speaker_num)
        cost = np.array(cost)
        rows, cols = linear_sum_assignment(-cost)
        aligned = np.zeros((n, speaker_num))
        for r, cc in zip(rows, cols):
            if cost[r, cc] > 0:
                aligned[:, cc] = np.maximum(data[:, r], aligned[:, cc])
        activations[start_frame:end_frame] += aligned

    sorted_speakers = np.argsort(-activations, axis=-1)
    binary = np.zeros_like(activations)
    for t in range(num_frames):
        for i in range(min(speaker_num, int(count.data[t]))):
            s = sorted_speakers[t, i]
            if activations[t, s] > 0:
                binary[t, s] = 1.0

    supplement = (binary.sum(-1) == 0) & (cluster_frames.sum(-1) != 0)
    binary[supplement] = cluster_frames[supplement]
    timestamps = [count.middle(i) for i in range(num_frames)]
    return binary, timestamps


def binary_to_segs(binary: np.ndarray, timestamps: Sequence[float],
                   threshold: float = 0.5) -> List[List]:
    """Frame-wise binary activations -> [start, end, spk] segments.
    (reference: bin/infer_diarization.py:704-725)"""
    out = []
    for k, k_scores in enumerate(binary.T):
        start = timestamps[0]
        is_active = k_scores[0] > threshold
        t = start
        for t, y in zip(timestamps[1:], k_scores[1:]):
            if is_active:
                if y < threshold:
                    out.append([round(start, 3), round(t, 3), k])
                    start = t
                    is_active = False
            else:
                if y > threshold:
                    start = t
                    is_active = True
        if is_active:
            out.append([round(start, 3), round(t, 3), k])
    return sorted(out, key=lambda x: x[0])
