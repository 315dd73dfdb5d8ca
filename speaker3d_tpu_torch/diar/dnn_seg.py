"""DNN segmentation for overlap-aware diarization: a trained FSMNSegmenter
-> ``SlidingSegmentation``.

The counterpart of ``speaker3d_tpu/diar/dnn_seg.py``. ``DnnSegmenter``
plugs into ``DiarizationPipeline`` as its ``segmentation_model`` ((wav[n],
fs) -> SlidingSegmentation), which ``diar/overlap.py`` consumes: per-frame
speaker counts gate the cluster activations, and Hungarian alignment maps
window-local channels to global clusters.

The file is covered by windows of ``window_dur`` every ``step_dur`` (the
step snapped to the 160-sample fbank hop, so that chunk starts land on the
aggregation frame grid; the last window zero-padded). Windows are gathered
on the device from one upload of the waveform and run, in batches, through
the Kaldi fbank (the fbank kernel on a card) with no mean-norm, matching
training, and the model in fp32 (TF32 off).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.diar.dnn_vad import FsmnFrontEnd, load_fsmn_exp
from speaker3d_tpu_torch.diar.overlap import SlidingSegmentation
from speaker3d_tpu_torch.models.segmentation import FSMNSegmenter


class DnnSegmenter(FsmnFrontEnd):
    """Callable sliding-window segmentation with the pipeline interface."""

    def __init__(self, model: FSMNSegmenter, sample_rate: int = 16000,
                 window_dur: float = 5.0, step_dur: float = 0.5,
                 batch_size: int = 8, device=DEFAULT_DEVICE):
        super().__init__(model, sample_rate, batch_size, device)
        self.frame_step = self.frame_shift / sample_rate
        self.frame_duration = self.frame_length / sample_rate
        self.win_samples = int(window_dur * sample_rate)
        self.step_samples = max(
            int(round(step_dur * sample_rate / self.frame_shift))
            * self.frame_shift, self.frame_shift)
        self.frames_per_win = 1 + (self.win_samples
                                   - self.frame_length) // self.frame_shift
        self.num_classes = model.max_speakers

    def __call__(self, wav_1d, sample_rate: Optional[int] = None
                 ) -> SlidingSegmentation:
        if sample_rate is not None and sample_rate != self.fs:
            raise ValueError(f"expected {self.fs} Hz audio, got {sample_rate}")
        x = np.clip(np.asarray(wav_1d, np.float32).reshape(-1), -1.0, 1.0)
        n = x.shape[0]
        # windows covering [0, n): one every step, the last zero-padded
        n_win = max(1, 1 + -(-max(n - self.win_samples, 0)
                             // self.step_samples))
        starts = np.arange(n_win, dtype=np.int64) * self.step_samples
        probs = self.probs(x, starts, self.win_samples)
        return SlidingSegmentation(data=probs,
                                   chunk_starts=starts / self.fs,
                                   frame_step=self.frame_step,
                                   frame_duration=self.frame_duration)


def load_segmentation_exp(exp_dir: str, sample_rate: int = 16000,
                          device=DEFAULT_DEVICE,
                          **seg_kwargs) -> DnnSegmenter:
    """A DnnSegmenter on ``device`` from a segmentation experiment
    directory; the window is the config's ``window_dur``."""
    dev = resolve_device(device)
    config, model = load_fsmn_exp(exp_dir, FSMNSegmenter,
                                  config_keys=("max_speakers",))
    seg_kwargs.setdefault("window_dur", config.get("window_dur", 5.0))
    return DnnSegmenter(model, sample_rate=sample_rate, device=dev,
                        **seg_kwargs)
