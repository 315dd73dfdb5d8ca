"""End-to-end diarization CLI on a CUDA card (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/infer_diarization.py``, with the
same flags plus ``--device``. Per file: run the diarization pipeline, write
RTTM or JSON, and with ``--sidecar`` the .meta.json RTF, .vad_info.json,
.pairs.json and .vad_masked.wav diagnostics. Files are sharded across
processes rank::world.

Usage:
  python -m speaker3d_tpu_torch.cli.infer_diarization --wav a.wav [b.wav ...] \
      --out_dir out/ [--model_id iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common]
      [--speaker_num N] [--out_type rttm|json] [--sidecar] [--device cuda]
      [--cluster_type AHC|spectral|umap_hdbscan] [--cluster_backend device]

Clustering: AHC (default), spectral (the upstream recipe's; float64 on the
host, or its affinity, Laplacian and eigenpairs on ``--device`` with
``--cluster_backend device``; ``--cluster_pval``, ``--cluster_seed``) or
UMAP+HDBSCAN (the UMAP layout on ``--device``). ``--exp_dir`` (a trained
experiment of either trainer) replaces ``--model_id``.

The DNN front end, each model an experiment of either package's trainer
(``cli/train_vad.py``, ``cli/train_segmentation.py``), on ``--device``:
``--vad_exp_dir`` replaces the energy VAD with a trained DFSMN VAD, and
``--include_overlap --segmentation_exp_dir EXP`` adds overlap-aware
post-processing driven by a trained FSMN segmenter.
"""

from __future__ import annotations

import argparse
import glob
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Speaker diarization (PyTorch)")
    p.add_argument("--wav", nargs="+", required=True,
                   help="wav files / dirs / list files (.list)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common")
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--device", default="cuda",
                   help="torch device for the embeddings and the device "
                        "clustering paths; 'cpu' must be asked for")
    p.add_argument("--exp_dir", default=None,
                   help="a trained experiment instead of --model_id")
    p.add_argument("--out_type", choices=["rttm", "json"], default="rttm")
    p.add_argument("--speaker_num", type=int, default=None)
    p.add_argument("--vad_threshold", type=float, default=0.5)
    p.add_argument("--vad_exp_dir", default=None,
                   help="a trained DFSMN VAD experiment (cli/train_vad.py) "
                        "instead of the energy VAD")
    p.add_argument("--vad_min_speech_ms", type=float, default=200.0,
                   help="drop speech segments shorter than this")
    p.add_argument("--vad_max_silence_ms", type=float, default=300.0,
                   help="fill silence gaps up to this long")
    p.add_argument("--vad_energy_threshold", type=float, default=0.05,
                   help="energy floor for boundary refinement")
    p.add_argument("--vad_boundary_expansion_ms", type=float, default=10.0,
                   help="re-expansion margin after energy contraction")
    p.add_argument("--vad_boundary_energy_percentile", type=float,
                   default=10.0,
                   help="dynamic-threshold percentile for boundary "
                        "refinement")
    p.add_argument("--include_overlap", action="store_true",
                   help="overlap-aware post-processing by a trained FSMN "
                        "segmenter (--segmentation_exp_dir)")
    p.add_argument("--segmentation_threshold", type=float, default=0.5,
                   help="binarization threshold of the segmenter's "
                        "per-speaker activations")
    p.add_argument("--segmentation_exp_dir", default=None,
                   help="cli/train_segmentation.py experiment (required "
                        "with --include_overlap)")
    p.add_argument("--cluster_type", default="AHC",
                   choices=["AHC", "spectral", "umap_hdbscan"],
                   help="clustering: AHC, spectral (the upstream recipe's) "
                        "or umap_hdbscan; inputs of fewer than 40 chunks go "
                        "to AHC whatever the type")
    p.add_argument("--cluster_backend", default="auto",
                   choices=["auto", "numpy", "device", "nnchain",
                            "nnchain_device"],
                   help="AHC numerics: 'auto' = exact scipy to 4096 chunks, "
                        "then the NN-chain linkage, on the card when "
                        "--device is CUDA; 'device' computes only the "
                        "affinity on the card. The device NN-chain runs in "
                        "float32, so near-tie merge order can drift from "
                        "scipy's float64 linkage; force 'numpy' for exact "
                        "reference parity. Spectral: 'device' runs the "
                        "affinity, Laplacian and eigenpairs on --device in "
                        "float32, every other value the float64 host path")
    p.add_argument("--cluster_seed", type=int, default=None,
                   help="k-means seed of the spectral path (default: numpy's "
                        "global RNG, as the reference)")
    p.add_argument("--cluster_mer_cos", type=float, default=0.3)
    p.add_argument("--cluster_fix_cos_thr", type=float, default=0.3)
    p.add_argument("--cluster_min_cluster_size", type=int, default=0)
    p.add_argument("--cluster_min_cluster_ratio", type=float, default=None,
                   help="relative minor-cluster threshold: effective size = "
                        "max(min_cluster_size, ceil(ratio*num_chunks))")
    p.add_argument("--cluster_pval", type=float, default=0.012,
                   help="spectral p-pruning value")
    p.add_argument("--chunk_dur", type=float, default=1.5)
    p.add_argument("--chunk_step", type=float, default=0.75)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--no_chunk_after_vad", action="store_true")
    p.add_argument("--nprocs", type=int, default=1,
                   help="local process fan-out: files are round-robin "
                        "sharded rank::nprocs across spawned subprocesses")
    p.add_argument("--sidecar", action="store_true",
                   help="write .meta.json/.vad_info.json/.pairs.json/"
                        ".vad_masked.wav diagnostics")
    return p.parse_args(argv)


def collect_wavs(specs):
    wavs = []
    for spec in specs:
        if os.path.isdir(spec):
            wavs += sorted(glob.glob(os.path.join(spec, "*.wav")))
        elif spec.endswith(".list") or spec.endswith(".txt"):
            with open(spec) as f:
                wavs += [line.strip() for line in f if line.strip()]
        else:
            wavs.append(spec)
    return wavs


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract import load_model
    from speaker3d_tpu_torch.device import resolve_device
    from speaker3d_tpu_torch.diar.cluster import CommonClustering
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.parallel.mesh import init_multihost, process_shard
    from speaker3d_tpu_torch.utils.fanout import maybe_fanout
    from speaker3d_tpu_torch.utils.fileio import write_wav

    args = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    if args.include_overlap and not args.segmentation_exp_dir:
        raise SystemExit("--include_overlap requires --segmentation_exp_dir "
                         "(train one with cli/train_segmentation.py)")
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    if maybe_fanout("speaker3d_tpu_torch.cli.infer_diarization", argv,
                    args.nprocs):
        return

    vad = None
    if args.vad_exp_dir:
        from speaker3d_tpu_torch.diar.dnn_vad import load_vad_exp

        vad = load_vad_exp(args.vad_exp_dir, threshold=args.vad_threshold,
                           device=device)
    segmentation = None
    if args.include_overlap:
        from speaker3d_tpu_torch.diar.dnn_seg import load_segmentation_exp

        segmentation = load_segmentation_exp(args.segmentation_exp_dir,
                                             device=device)
    model = load_model(args.exp_dir, args.model_id, args.local_model_dir)
    embed_fn = build_embedding_fn(model, device=device, precision="high")
    cluster = None
    if args.cluster_type != "AHC" or args.cluster_backend != "auto":
        kw = {}
        if args.cluster_type == "spectral":
            kw = dict(pval=args.cluster_pval, max_num_spks=15,
                      oracle_num=args.speaker_num,
                      random_state=args.cluster_seed,
                      backend=("device" if args.cluster_backend == "device"
                               else "numpy"))
        elif args.cluster_type == "AHC":
            kw = dict(fix_cos_thr=args.cluster_fix_cos_thr,
                      backend=args.cluster_backend)
        # AHC keeps the pipeline's min_cluster_size (the backend flag changes
        # numerics only); spectral and UMAP+HDBSCAN keep the recipe's 4
        # when it is unset
        min_csize = (args.cluster_min_cluster_size
                     if args.cluster_type == "AHC"
                     else args.cluster_min_cluster_size or 4)
        cluster = CommonClustering(
            args.cluster_type, mer_cos=args.cluster_mer_cos,
            min_cluster_size=min_csize,
            min_cluster_ratio=args.cluster_min_cluster_ratio, device=device,
            **kw)
    pipe = DiarizationPipeline(
        embed_fn,
        vad=vad,
        cluster=cluster,
        vad_threshold=args.vad_threshold,
        vad_min_speech_ms=args.vad_min_speech_ms,
        vad_max_silence_ms=args.vad_max_silence_ms,
        vad_energy_threshold=args.vad_energy_threshold,
        vad_boundary_expansion_ms=args.vad_boundary_expansion_ms,
        vad_boundary_energy_percentile=args.vad_boundary_energy_percentile,
        segmentation_model=segmentation,
        segmentation_threshold=args.segmentation_threshold,
        cluster_mer_cos=args.cluster_mer_cos,
        cluster_fix_cos_thr=args.cluster_fix_cos_thr,
        cluster_min_cluster_size=args.cluster_min_cluster_size,
        cluster_min_cluster_ratio=args.cluster_min_cluster_ratio,
        chunk_dur=args.chunk_dur,
        chunk_step=args.chunk_step,
        batch_size=args.batch_size,
        no_chunk_after_vad=args.no_chunk_after_vad,
        speaker_num=args.speaker_num,
        device=device,
    )

    for wav_path in process_shard(collect_wavs(args.wav)):
        base = os.path.splitext(os.path.basename(wav_path))[0]
        fields = pipe(wav_path, speaker_num=args.speaker_num)
        out_file = os.path.join(args.out_dir, f"{base}.{args.out_type}")
        pipe.save_diar_output(out_file, wav_id=base)
        print(f"{base}: {len(fields)} segments, "
              f"{len({f[2] for f in fields})} speakers -> {out_file}")
        if args.sidecar:
            # the pipeline's own waveform object: the identity-keyed upload
            # is reused for the .pairs.json re-embedding
            wav_1d = pipe.last_wav_1d
            pipe.save_vad_info(os.path.join(args.out_dir,
                                            f"{base}.vad_info.json"))
            # pairs BEFORE meta: meta carries the pairwise min/mean stats
            pipe.save_pairs(os.path.join(args.out_dir, f"{base}.pairs.json"),
                            wav_1d=wav_1d)
            pipe.save_meta(os.path.join(args.out_dir, f"{base}.meta.json"),
                           wav_1d.shape[-1] / 16000.0, wav_path=wav_path)
            if pipe.last_vad_masked_audio is not None:
                write_wav(os.path.join(args.out_dir, f"{base}.vad_masked.wav"),
                          pipe.last_vad_masked_audio, 16000)
            try:
                pipe.save_vad_plot(os.path.join(args.out_dir, f"{base}.vad.png"),
                                   wav_1d=wav_1d)
            except Exception as e:  # plotting is best-effort (fork behavior)
                print(f"[WARNING] vad plot failed: {e}")


if __name__ == "__main__":
    main()
