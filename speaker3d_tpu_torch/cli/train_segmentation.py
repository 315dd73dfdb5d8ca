"""FSMN segmentation (overlap) trainer CLI on one CUDA card (or the CPU
when asked).

The counterpart of ``speaker3d_tpu/cli/train_segmentation.py``, with the
loop, logs, checkpoints and deliberate differences of ``cli/train_vad.py``
(the JAX trainer's checkpoint layout, which both packages'
``load_segmentation_exp`` and trainers read; initial weights from a torch
generator seeded by ``--seed``; one card).

Usage:
  python -m speaker3d_tpu_torch.cli.train_segmentation \
      --config configs/fsmn_seg.yaml [--device cuda] [--any_yaml_key=value ...]

Config keys: exp_dir, speech (CSV with ID,wav,spk or wav.scp + utt2spk),
noise (optional scp), window_dur, max_speakers, batch_size, num_epoch, the
LR schedule, model.args (``FSMNSegmenter``). Diarize with the experiment
through ``python -m speaker3d_tpu_torch.cli.infer_diarization
--include_overlap --segmentation_exp_dir <exp_dir>``.
"""

from __future__ import annotations

from speaker3d_tpu_torch.cli.train_vad import setup, train_fsmn


def main(argv=None):
    from speaker3d_tpu_torch.data.dataset_seg import SyntheticSegmentationDataset
    from speaker3d_tpu_torch.models.segmentation import FSMNSegmenter
    from speaker3d_tpu_torch.train.seg_train import make_seg_train_step

    args, device, config = setup(
        argv, "Train the FSMN overlap segmentation model")
    max_speakers = config.get("max_speakers", 3)
    dataset = SyntheticSegmentationDataset(
        speech=config["speech"],
        noise=config.get("noise"),
        utt2spk=config.get("utt2spk"),
        sample_rate=config.get("sample_rate", 16000),
        window_dur=config.get("window_dur", 5.0),
        max_speakers=max_speakers,
        events_per_speaker=config.get("events_per_speaker", 2),
        min_event_dur=config.get("min_event_dur", 0.4),
        snr_range=tuple(config.get("snr_range", (0.0, 20.0))),
        seed=args.seed,
        size=config.get("dataset_size"),
    )
    margs = dict(config.get("model", {}).get("args", {}))
    margs.setdefault("max_speakers", max_speakers)
    train_fsmn(args, device, config, dataset, FSMNSegmenter(**margs),
               make_seg_train_step, default_batch=32)


if __name__ == "__main__":
    main()
