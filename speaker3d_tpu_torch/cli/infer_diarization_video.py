"""Audio-visual diarization CLI on a CUDA card (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/infer_diarization_video.py``, with
the same flags plus ``--device``: read the video's frames (sampled at
``--fps``) and its 16 kHz audio, track faces, score active speech per track
(ASD), embed each track's active crops, run the audio diarization
pipeline, then reconcile the audio clusters with the face tracks
(``diar/cluster.py::JointClustering``) and write RTTM.

The vision models are the user's to give:
  --face_detector_exp_dir  a trained detector (cli/train_face_detector.py)
  --yunet_onnx             cv2.FaceDetectorYN model file for detection
  --face_boxes_json        precomputed boxes per source frame index
                           {frame_idx: [[x, y, w, h], ...]}
  --face_embed_onnx        cv2.dnn face-recognition model (112x112 input)
  --asd_exp_dir            a TalkNet experiment (the JAX ASD trainer's
                           ``asd_state`` layout), run on ``--device``
Detection needs one of the first three. Without the last two, faces are
embedded as normalised 24x24 pixels and ASD is an audio-energy heuristic.
The audio comes from ``--wav``, else ffmpeg extracts it.

Usage:
  python -m speaker3d_tpu_torch.cli.infer_diarization_video --video v.mp4 \
      --out_dir out/ (--face_detector_exp_dir D | --face_boxes_json B |
      --yunet_onnx Y) [--wav v.wav] [--asd_exp_dir A] [--device cuda]

``main`` parses the flags, reads the audio and the frames (``read_frames``,
cv2), and hands both to ``diarize_video``, which does the rest: a caller
can feed it any stream of (source index, time, grey frame) without cv2.
cv2 is imported only in ``read_frames`` and the two ONNX builders.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

FS = 16000


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Audio-visual speaker diarization")
    p.add_argument("--video", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--wav", default=None,
                   help="16 kHz audio for the video (else ffmpeg extracts it)")
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common")
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--exp_dir", default=None)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--yunet_onnx", default=None)
    p.add_argument("--face_boxes_json", default=None)
    p.add_argument("--face_detector_exp_dir", default=None,
                   help="a trained detector (cli/train_face_detector.py)")
    p.add_argument("--face_threshold", type=float, default=0.35)
    p.add_argument("--face_min_quality", type=float, default=0.0,
                   help="drop tracks whose mean crop sharpness "
                        "(variance-of-Laplacian) is below this")
    p.add_argument("--face_embed_onnx", default=None)
    p.add_argument("--asd_exp_dir", default=None)
    p.add_argument("--speaker_num", type=int, default=None)
    p.add_argument("--vad_threshold", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device of the audio embeddings, the face "
                        "detector and TalkNet; 'cpu' must be asked for")
    return p.parse_args(argv)


def extract_audio(video: str, fs: int = FS) -> str:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found: pass --wav with the video's 16 kHz audio")
    out = tempfile.NamedTemporaryFile(suffix=".wav", delete=False).name
    subprocess.run(["ffmpeg", "-y", "-i", video, "-ac", "1", "-ar", str(fs),
                    "-loglevel", "error", out], check=True)
    return out


def read_frames(video: str, fps: float):
    """Stream (source_frame_idx, time_s, grey frame) sampled at ~fps: a
    generator, so only tracked face crops persist, never all frames."""
    import cv2

    cap = cv2.VideoCapture(video)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 cannot open {video}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    step = max(1, int(round(src_fps / fps)))
    idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % step == 0:
                yield idx, idx / src_fps, cv2.cvtColor(frame,
                                                       cv2.COLOR_BGR2GRAY)
            idx += 1
    finally:
        cap.release()


def build_face_detector(args, src_idx_iter=None, device="cuda"):
    """``src_idx_iter`` yields the SOURCE frame index of each sampled frame
    (in lockstep with the tracking loop), so a ``--face_boxes_json`` table
    keyed by source index stays right when frames are decimated."""
    if args.face_boxes_json:
        with open(args.face_boxes_json) as f:
            table = {int(k): v for k, v in json.load(f).items()}

        def detector(frame):
            idx = next(src_idx_iter)
            return [tuple(b) for b in table.get(idx, [])]

        return detector
    if args.yunet_onnx:
        import cv2

        det = cv2.FaceDetectorYN_create(args.yunet_onnx, "", (320, 320))

        def detector(frame):
            h, w = frame.shape[:2]
            det.setInputSize((w, h))
            _, faces = det.detect(cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR))
            if faces is None:
                return []
            return [tuple(f[:4]) for f in faces]

        return detector
    if args.face_detector_exp_dir:
        from speaker3d_tpu_torch.models.face_detector import load_face_detector_exp

        return load_face_detector_exp(args.face_detector_exp_dir,
                                      threshold=args.face_threshold,
                                      device=device)
    raise RuntimeError("no face detector: pass --face_detector_exp_dir "
                       "(train one with cli/train_face_detector.py), "
                       "--yunet_onnx, or --face_boxes_json")


def pixel_embedder(crops):
    """Normalised 24x24 downsampled pixels: separates visually distinct
    faces; a recognition model (``--face_embed_onnx``) does better."""
    n = crops.shape[0]
    ys = np.linspace(0, crops.shape[1] - 1, 24).astype(int)
    xs = np.linspace(0, crops.shape[2] - 1, 24).astype(int)
    flat = crops[:, ys][:, :, xs].reshape(n, -1).astype(np.float32)
    flat -= flat.mean(axis=1, keepdims=True)
    return flat / np.maximum(np.linalg.norm(flat, axis=1, keepdims=True),
                             1e-6)


def build_face_embedder(args):
    if args.face_embed_onnx:
        import cv2

        net = cv2.dnn.readNetFromONNX(args.face_embed_onnx)

        def embedder(crops):
            out = []
            for c in crops:
                blob = cv2.dnn.blobFromImage(
                    cv2.cvtColor(c.astype(np.uint8), cv2.COLOR_GRAY2BGR),
                    1.0 / 127.5, (112, 112), (127.5, 127.5, 127.5))
                net.setInput(blob)
                out.append(net.forward().reshape(-1))
            return np.stack(out)

        return embedder
    return pixel_embedder


def energy_scorer(audio_mfcc, face_crops):
    """Active when the synchronised audio has energy (the ASD stand-in
    without a TalkNet experiment: every visible face in a single-face scene
    gets speech credit; JointClustering's overlap voting still works)."""
    n = face_crops.shape[0]
    scores = np.zeros(n, np.float32)
    if audio_mfcc.size:
        e = np.square(audio_mfcc).mean(axis=-1)
        e = e.reshape(n, -1).mean(axis=1) if e.size >= n else np.resize(e, n)
        thr = np.percentile(e, 20)
        scores = (e > thr).astype(np.float32)
    return scores


def build_asd_scorer(args, device="cuda"):
    if args.asd_exp_dir:
        from speaker3d_tpu_torch.diar.video import make_talknet_asd_scorer
        from speaker3d_tpu_torch.models.talknet import load_talknet_exp

        return make_talknet_asd_scorer(None, device=device,
                                       model=load_talknet_exp(args.asd_exp_dir))
    return energy_scorer


def diarize_video(args, stream, wav_1d, device):
    """Everything after the reading: ``stream`` yields (source index, time
    in s, grey frame [H, W]) in order; ``wav_1d`` is the 16 kHz audio.
    Writes ``<out_dir>/<video basename>.rttm``, prints the closing line and
    returns ``{'fields', 'tracks', 'boxes' (the detections per sampled
    frame), 'stage_s' (wall seconds per stage), 'rttm'}``."""
    from speaker3d_tpu_torch.cli.extract import load_model
    from speaker3d_tpu_torch.diar.cluster import CommonClustering, JointClustering
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline, compressed_seg
    from speaker3d_tpu_torch.diar.video import (
        build_face_tracks, embed_tracks, score_tracks_asd,
        tracks_to_vision_inputs)
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.ops.mfcc import mfcc

    stage_s = dict.fromkeys(("frames", "detection", "tracking", "mfcc", "asd",
                             "face_embed", "audio", "joint"), 0.0)

    def timed_stream():
        it = iter(stream)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                stage_s["frames"] += time.perf_counter() - t
            yield item

    # the vision chain, streamed: the tee'd iterators advance in lockstep
    # (frame and time pulled by the tracking zip, the source index by the
    # detector), so memory stays bounded by the live face crops
    frames_in = timed_stream()
    if args.face_boxes_json:
        s_frames, s_times, s_idx = itertools.tee(frames_in, 3)
        src_idx_iter = (i for i, _, _ in s_idx)
    else:  # a lagging tee branch would buffer every frame
        s_frames, s_times = itertools.tee(frames_in, 2)
        src_idx_iter = None
    frames = (g for _, _, g in s_frames)
    frame_times_it = (t for _, t, _ in s_times)
    spacing = {"first": None, "second": None}

    def times_with_spacing():
        for t in frame_times_it:
            if spacing["first"] is None:
                spacing["first"] = t
            elif spacing["second"] is None:
                spacing["second"] = t
            yield t

    detect = build_face_detector(args, src_idx_iter=src_idx_iter,
                                 device=device)
    boxes = []

    def detector(frame):
        t = time.perf_counter()
        found = detect(frame)
        stage_s["detection"] += time.perf_counter() - t
        boxes.append(list(found))
        return found

    t0 = time.perf_counter()
    tracks = build_face_tracks(frames, times_with_spacing(), detector,
                               min_quality=args.face_min_quality)
    stage_s["tracking"] = (time.perf_counter() - t0 - stage_s["frames"]
                           - stage_s["detection"])
    frame_spacing = ((spacing["second"] - spacing["first"])
                     if spacing["second"] is not None else 1.0 / args.fps)
    actual_fps = 1.0 / max(frame_spacing, 1e-6)
    if tracks:
        t0 = time.perf_counter()
        audio_mfcc = mfcc(wav_1d, FS)
        stage_s["mfcc"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        score_tracks_asd(tracks, audio_mfcc, build_asd_scorer(args, device),
                         fps=actual_fps)
        stage_s["asd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        embed_tracks(tracks, build_face_embedder(args))
        stage_s["face_embed"] = time.perf_counter() - t0

    # the audio chain
    t0 = time.perf_counter()
    model = load_model(args.exp_dir, args.model_id, args.local_model_dir)
    embed_fn = build_embedding_fn(model, device=device, precision="high")
    pipe = DiarizationPipeline(embed_fn, vad_threshold=args.vad_threshold,
                               batch_size=args.batch_size,
                               speaker_num=args.speaker_num, device=device)
    fields = pipe(wav_1d)
    stage_s["audio"] = time.perf_counter() - t0

    base = os.path.splitext(os.path.basename(args.video))[0]
    if tracks and fields:
        t0 = time.perf_counter()
        visionX, visionT = tracks_to_vision_inputs(tracks)
        joint = JointClustering(
            CommonClustering("AHC", mer_cos=0.3, fix_cos_thr=0.3,
                             device=device),
            CommonClustering("AHC", mer_cos=0.3, fix_cos_thr=0.3,
                             device=device))
        # JointClustering chains vision frames 0.04 s x face_det_stride
        # apart: the stride comes from the MEASURED sampled-frame spacing
        # (the requested --fps is only approximate after integer
        # decimation), so consecutive frames always chain
        conf = types.SimpleNamespace(face_det_stride=frame_spacing / 0.04)
        labels = joint(pipe.last_embeddings, visionX,
                       [list(c) for c in pipe.last_chunks], visionT,
                       conf=conf)
        fields = compressed_seg(
            [[c[0], c[1], int(lab)] for c, lab in zip(pipe.last_chunks,
                                                     labels)])
        stage_s["joint"] = time.perf_counter() - t0

    out_rttm = os.path.join(args.out_dir, base + ".rttm")
    pipe.save_diar_output(out_rttm, wav_id=base, output_field_labels=fields)
    n_spk = len({f[2] for f in fields})
    print(f"{base}: {len(fields)} segments, {n_spk} speakers, "
          f"{len(tracks)} face tracks -> {out_rttm}", flush=True)
    return {"fields": fields, "tracks": tracks, "boxes": boxes,
            "stage_s": stage_s, "rttm": out_rttm}


def main(argv=None):
    from speaker3d_tpu_torch.device import resolve_device
    from speaker3d_tpu_torch.utils.fileio import load_audio

    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    tmp_wav = None
    if not args.wav:
        tmp_wav = extract_audio(args.video, FS)
    try:
        wav_1d = np.asarray(load_audio(args.wav or tmp_wav, obj_fs=FS))[0]
    finally:
        if tmp_wav:
            os.unlink(tmp_wav)
    diarize_video(args, read_frames(args.video, args.fps), wav_1d, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
