"""Batch diarization driver over a directory (no overlap detection).

The counterpart of the repo root's ``run_diarization_simple.py`` over this
package's diarization CLI (``cli/infer_diarization.py``), with its flags,
plus ``--device``: the directory goes to the CLI as ``--wav``, which
diarizes every audio file in it (VAD, embeddings, AHC) and writes each
file's RTTM or JSON and the diagnostic sidecars into ``--out_dir``. Flags
it does not know pass on to the CLI.

Usage:
  python -m speaker3d_tpu_torch.cli.run_diarization_simple --src_dir wavs/ \\
      --out_dir out/ [--speaker_num N] [--out_type rttm|json] [--model_id ID]
      [--device cuda]
"""

import argparse
import sys

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--speaker_num", type=int, default=None)
    p.add_argument("--out_type", choices=["rttm", "json"], default="json")
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common")
    p.add_argument("--exp_dir", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the diarization CLI; 'cpu' must be "
                        "asked for")
    args, extra = p.parse_known_args(argv)

    from speaker3d_tpu_torch.cli.infer_diarization import main as diar_main

    diar_argv = ["--wav", args.src_dir, "--out_dir", args.out_dir,
                 "--out_type", args.out_type, "--sidecar",
                 "--device", args.device] + extra
    if args.speaker_num is not None:
        diar_argv += ["--speaker_num", str(args.speaker_num)]
    if args.exp_dir:
        diar_argv += ["--exp_dir", args.exp_dir]
    else:
        diar_argv += ["--model_id", args.model_id]
    diar_main(diar_argv)


if __name__ == "__main__":
    sys.exit(main())
