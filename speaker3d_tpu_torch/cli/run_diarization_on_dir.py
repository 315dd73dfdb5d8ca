"""Pattern-matched batch diarization with an aggregated summary.

The counterpart of the repo root's ``run_diarization_on_dir.py`` over this
package's diarization CLI (``cli/infer_diarization.py``), with its flags,
messages and return codes, plus ``--device``: every file of ``--src_dir``
matching ``--pattern`` is diarized in one CLI call (JSON plus the
diagnostic sidecars into ``--out_dir``, by default ``<src_dir>/diarization``;
flags the driver does not know pass on to the CLI), then the summary JSON
``{file: {num_speakers, segments}}`` is written to ``--summary_out``, with
the speakers of each file renumbered from 0 under
``--per_sentence_reindex``. No match: a message and return code 1.

Usage:
  python -m speaker3d_tpu_torch.cli.run_diarization_on_dir --src_dir d/ \\
      --pattern '*.wav' --out_dir out/ --summary_out summary.json \\
      [--device cuda] [diarization knobs...]
"""

import argparse
import glob
import json
import os
import sys

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src_dir", required=True)
    p.add_argument("--pattern", default="*speech_estimate.wav")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--summary_out", default=None)
    p.add_argument("--speaker_num", type=int, default=None)
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common")
    p.add_argument("--exp_dir", default=None)
    p.add_argument("--per_sentence_reindex", action="store_true")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the diarization CLI; 'cpu' must be "
                        "asked for")
    args, extra = p.parse_known_args(argv)

    wavs = sorted(glob.glob(os.path.join(args.src_dir, args.pattern)))
    if not wavs:
        print(f"no files matching {args.pattern} under {args.src_dir}")
        return 1
    out_dir = args.out_dir or os.path.join(args.src_dir, "diarization")
    os.makedirs(out_dir, exist_ok=True)

    from speaker3d_tpu_torch.cli.infer_diarization import main as diar_main

    diar_argv = (["--wav"] + wavs
                 + ["--out_dir", out_dir, "--out_type", "json", "--sidecar",
                    "--device", args.device] + extra)
    if args.speaker_num is not None:
        diar_argv += ["--speaker_num", str(args.speaker_num)]
    if args.exp_dir:
        diar_argv += ["--exp_dir", args.exp_dir]
    else:
        diar_argv += ["--model_id", args.model_id]
    diar_main(diar_argv)

    summary = {}
    for wav in wavs:
        base = os.path.splitext(os.path.basename(wav))[0]
        jpath = os.path.join(out_dir, f"{base}.json")
        if not os.path.isfile(jpath):
            continue
        with open(jpath) as f:
            segs = json.load(f)
        spks = sorted({v["speaker"] for v in segs.values()})
        remap = ({s: i for i, s in enumerate(spks)}
                 if args.per_sentence_reindex else None)
        summary[base] = {
            "num_speakers": len(spks),
            "segments": [
                {"start": v["start"], "stop": v["stop"],
                 "speaker": remap[v["speaker"]] if remap else v["speaker"]}
                for v in segs.values()],
        }
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"summary for {len(summary)} files -> {args.summary_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
