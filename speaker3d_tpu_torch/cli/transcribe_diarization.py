"""Speaker-attributed transcripts from diarization RTTMs and ASR words.

The counterpart of ``speaker3d_tpu/cli/transcribe_diarization.py``, with its
flags, messages and output plus ``--device``: per recording, read the RTTM
and the ASR result, attribute each word to a speaker
(``diar/transcribe.py``) and write ``<spk>: [st ed] text`` lines to
``<out_dir>/<rec_id>.txt``. The ASR result comes from ``--asr_dir`` (one
``<rec_id>.json`` per recording from any engine:
``{"text", "raw_text", "timestamp"}``) or from the package's CTC model
(``--asr_exp_dir``, a ``cli/train_asr_ctc.py`` experiment of either
package, decoding ``--wav_dir/<rec_id>.wav`` on the card).

``--device`` is resolved as in every entry point of the package (CUDA
unless ``cpu`` is asked for, raising without a card), also with
``--asr_dir``, where the attribution runs on the host.

Usage:
  python -m speaker3d_tpu_torch.cli.transcribe_diarization \
      --rttm_dir exp/rttm (--asr_dir exp/asr_json | --asr_exp_dir exp/asr_ctc \
      --wav_dir wavs) --out_dir exp/transcripts [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.parallel.mesh import init_multihost, process_shard


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Speaker-attributed transcripts")
    p.add_argument("--rttm_dir", required=True)
    p.add_argument("--asr_dir", default=None,
                   help="<rec_id>.json ASR results (text/raw_text/timestamp) "
                        "from any external engine")
    p.add_argument("--asr_exp_dir", default=None,
                   help="CTC ASR experiment (cli/train_asr_ctc.py): "
                        "transcribe --wav_dir recordings natively instead "
                        "of reading --asr_dir JSONs")
    p.add_argument("--wav_dir", default=None,
                   help="<rec_id>.wav recordings (required with "
                        "--asr_exp_dir)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--merge_gap_s", type=float, default=2.0)
    p.add_argument("--timestamps", choices=["auto", "ms", "s"],
                   default="auto",
                   help="unit of ASR word timestamps: 'ms' (the Paraformer "
                        "convention), 's', or 'auto' (detect from "
                        "magnitude). The native --asr_exp_dir engine always "
                        "emits seconds")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the ASR model; 'cpu' must be "
                        "asked for")
    args = p.parse_args(argv)
    if bool(args.asr_dir) == bool(args.asr_exp_dir):
        p.error("exactly one of --asr_dir / --asr_exp_dir is required")
    if args.asr_exp_dir and not args.wav_dir:
        p.error("--asr_exp_dir requires --wav_dir")
    return args


def load_rttm_fields(path):
    """An RTTM's SPEAKER lines -> [[st, ed, spk], ...]."""
    fields = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 8 and parts[0] == "SPEAKER":
                st = float(parts[3])
                fields.append([st, st + float(parts[4]), parts[7]])
    return fields


def main(argv=None):
    from speaker3d_tpu_torch.diar.transcribe import attribute_transcript

    args = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    transcriber = None
    if args.asr_exp_dir:
        from speaker3d_tpu_torch.asr.ctc import CTCTranscriber

        transcriber = CTCTranscriber(args.asr_exp_dir, device=device)
    rec_ids = sorted(os.path.splitext(p)[0]
                     for p in os.listdir(args.rttm_dir) if p.endswith(".rttm"))
    for rec_id in process_shard(rec_ids):
        if transcriber is not None:
            from speaker3d_tpu_torch.utils.fileio import load_audio

            wav_path = os.path.join(args.wav_dir, rec_id + ".wav")
            if not os.path.isfile(wav_path):
                print(f"[WARNING] no wav for {rec_id}, skipped")
                continue
            wav = load_audio(wav_path, obj_fs=16000)[0]
            asr = transcriber.transcribe(wav)
        else:
            asr_path = os.path.join(args.asr_dir, rec_id + ".json")
            if not os.path.isfile(asr_path):
                print(f"[WARNING] no ASR json for {rec_id}, skipped")
                continue
            with open(asr_path) as f:
                asr = json.load(f)
        fields = load_rttm_fields(os.path.join(args.rttm_dir,
                                               rec_id + ".rttm"))
        ts_ms = {"auto": None, "ms": True, "s": False}[args.timestamps]
        if transcriber is not None:
            ts_ms = False  # the CTC engine emits seconds
        utts = attribute_transcript(asr, fields, args.merge_gap_s,
                                    timestamps_ms=ts_ms)
        out = os.path.join(args.out_dir, rec_id + ".txt")
        with open(out, "w") as f:
            for text, (st, ed), spk in utts:
                f.write(f"{spk}: [{st:.3f} {ed:.3f}] {text}\n")
        print(f"{rec_id}: {len(utts)} attributed utterances -> {out}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
