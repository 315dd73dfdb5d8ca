"""SSL (SDPN, RDINO) single/pair speaker-verification inference CLI.

The counterpart of ``speaker3d_tpu/cli/infer_sv_ssl.py`` (reference:
speakerlab/bin/infer_sv_ssl.py), with its flags plus ``--device``: the SSL
experiment's teacher backbone embeds each wav at batch 1 through the linear
mel spectrogram (``cli/extract_ssl.py::load_teacher_embedder``); with
``--save_dir`` each embedding is saved as ``<wav basename>.npy``; for a pair
the cosine is printed as ``[INFO] cosine similarity: x.xxxxx``. The default
``--variant`` is ``sdpn`` here (``rdino`` in ``extract_ssl``), as in the
JAX CLIs.

Usage:
  python -m speaker3d_tpu_torch.cli.infer_sv_ssl --exp_dir exp/sdpn \
      --wavs a.wav b.wav [--variant sdpn] [--save_dir embs] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract_ssl import load_teacher_embedder
    from speaker3d_tpu_torch.utils.fileio import load_audio

    p = argparse.ArgumentParser()
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--wavs", nargs="+", required=True)
    p.add_argument("--variant", choices=["rdino", "sdpn"], default="sdpn")
    p.add_argument("--save_dir", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device; 'cpu' must be asked for")
    args = p.parse_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group

    embed = load_teacher_embedder(args.exp_dir, args.variant, args.device)
    embs = []
    for wav_path in args.wavs:
        emb = embed(load_audio(wav_path, obj_fs=16000)[0])
        embs.append(emb)
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(wav_path))[0]
            np.save(os.path.join(args.save_dir, f"{base}.npy"), emb)

    if len(embs) == 2:
        a, b = embs
        score = float(np.dot(a, b)
                      / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        print(f"[INFO] cosine similarity: {score:.5f}")


if __name__ == "__main__":
    main()
