"""Batch diarization over speech-estimate wavs (VAD + embedding + clustering).

The counterpart of the repo root's ``run_diarization_speech_estimate.py``
over this package's diarization CLI (``cli/infer_diarization.py``), with its
flags, messages and return codes, plus ``--device``: every file of
``--src_dir`` matching ``--pattern`` (default ``*_speech_estimate.wav``;
a pattern with no glob character falls back to every file of a common
audio extension) is diarized WITHOUT overlap detection in one CLI call,
writing JSON and the diagnostic sidecars (.meta.json, .pairs.json, ...)
into ``--out_dir`` (default: the sibling ``<src_basename>_3dspeaker_
diarization``). The VAD post-processing, clustering and chunking knobs are
forwarded to the CLI when given. A missing source directory or no match:
an ``[ERROR]`` line and return code 1.

Usage:
  python -m speaker3d_tpu_torch.cli.run_diarization_speech_estimate \
      --src_dir d/ [--pattern '*_speech_estimate.wav'] [--out_dir out/]
      [--speaker_num N] [--no_chunk_after_vad] [--vad_threshold F]
      [--vad_min_speech_ms F] [--vad_max_silence_ms F]
      [--vad_energy_threshold F] [--vad_boundary_expansion_ms F]
      [--cluster_mer_cos F] [--cluster_fix_cos_thr F]
      [--cluster_min_cluster_size N] [--chunk_dur F] [--chunk_step F]
      [--batch_size N] [--nprocs N] [--device cuda]
"""

import argparse
import glob
import os
import sys

from speaker3d_tpu_torch.device import DEFAULT_DEVICE

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".m4a", ".ogg")


def find_audio_files(src_dir, pattern):
    if "*" in pattern or "?" in pattern:
        return sorted(glob.glob(os.path.join(src_dir, pattern)))
    files = []
    for ext in AUDIO_EXTENSIONS:
        files += glob.glob(os.path.join(src_dir, f"*{ext}"))
        files += glob.glob(os.path.join(src_dir, f"*{ext.upper()}"))
    return sorted(files)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Diarize *_speech_estimate.wav files "
                    "(VAD + embedding + clustering, no overlap detection)")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--pattern", default="*_speech_estimate.wav")
    p.add_argument("--speaker_num", type=int, default=None)
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common")
    p.add_argument("--exp_dir", default=None)
    p.add_argument("--no_chunk_after_vad", action="store_true")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the diarization CLI; 'cpu' must be "
                        "asked for")
    # knobs forwarded verbatim to the diarization CLI; None = pipeline default
    forwarded = [
        ("--vad_threshold", float), ("--vad_min_speech_ms", float),
        ("--vad_max_silence_ms", float), ("--vad_energy_threshold", float),
        ("--vad_boundary_expansion_ms", float), ("--cluster_mer_cos", float),
        ("--cluster_fix_cos_thr", float), ("--cluster_min_cluster_size", int),
        ("--chunk_dur", float), ("--chunk_step", float), ("--batch_size", int),
        ("--nprocs", int),
    ]
    for flag, typ in forwarded:
        p.add_argument(flag, type=typ, default=None)
    args = p.parse_args(argv)

    src_dir = os.path.abspath(args.src_dir)
    if not os.path.isdir(src_dir):
        print(f"[ERROR] Source directory does not exist: {src_dir}")
        return 1
    wavs = find_audio_files(src_dir, args.pattern)
    if not wavs:
        print(f"[ERROR] No audio files found in {src_dir} "
              f"matching pattern {args.pattern}")
        return 1
    if args.out_dir is None:
        out_dir = os.path.join(os.path.dirname(src_dir),
                               os.path.basename(src_dir)
                               + "_3dspeaker_diarization")
    else:
        out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    print(f"[INFO] Found {len(wavs)} audio files")
    print(f"[INFO] Output directory: {out_dir}")

    from speaker3d_tpu_torch.cli.infer_diarization import main as diar_main

    diar_argv = (["--wav"] + wavs
                 + ["--out_dir", out_dir, "--out_type", "json", "--sidecar",
                    "--device", args.device])
    if args.speaker_num is not None:
        diar_argv += ["--speaker_num", str(args.speaker_num)]
    if args.no_chunk_after_vad:
        diar_argv += ["--no_chunk_after_vad"]
    if args.exp_dir:
        diar_argv += ["--exp_dir", args.exp_dir]
    else:
        diar_argv += ["--model_id", args.model_id]
    for flag, _ in forwarded:
        val = getattr(args, flag.lstrip("-"))
        if val is not None:
            diar_argv += [flag, str(val)]
    diar_main(diar_argv)
    print(f"[INFO] Diarization completed; results in {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
