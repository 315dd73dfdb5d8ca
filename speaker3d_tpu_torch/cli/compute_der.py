"""DER scoring CLI.

The counterpart of ``speaker3d_tpu/cli/compute_der.py`` (reference:
egs/3dspeaker/speaker-diarization/local/compute_der.py wrapping NIST
md-eval.pl), with the same flags and output text plus ``--device``: compare
hypothesis RTTMs against reference RTTMs with a +/- collar (default 0.25 s)
and an optional ignore-overlap mode; print per-file and overall
MISS/FA/SER/DER percentages (``diar/der.py``, host arithmetic).

``--device`` is resolved as in every entry point of the package (CUDA
unless ``cpu`` is asked for, raising without a card), so one command line
serves the whole diarization workflow; the scoring itself runs on the host.

Usage:
  python -m speaker3d_tpu_torch.cli.compute_der --ref ref.rttm --hyp hyp.rttm \
      [--collar 0.25] [--ignore_overlap] [--device cuda]
"""

from __future__ import annotations

import argparse

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.diar.der import compute_der, compute_der_for_files, load_rttm


def main(argv=None):
    p = argparse.ArgumentParser(description="Compute diarization error rate")
    p.add_argument("--ref", required=True, help="reference RTTM file")
    p.add_argument("--hyp", required=True, help="hypothesis RTTM file")
    p.add_argument("--collar", type=float, default=0.25)
    p.add_argument("--ignore_overlap", action="store_true")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="the package's device; 'cpu' must be asked for")
    args = p.parse_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    resolve_device(args.device)

    ref = load_rttm(args.ref)
    hyp = load_rttm(args.hyp)

    for fid in sorted(ref):
        r = compute_der(ref[fid], hyp.get(fid, []), args.collar,
                        args.ignore_overlap)
        print(f"{fid}: {r}")
    total = compute_der_for_files(ref, hyp, args.collar, args.ignore_overlap)
    print(f"OVERALL: {total}")
    print(f"DER = {100 * total.der:.2f}%")
    return total


if __name__ == "__main__":
    main()
