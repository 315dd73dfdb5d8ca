"""End-to-end speaker diarization pipeline.

The counterpart of ``speaker3d_tpu/diar/pipeline.py``: VAD -> post-processing
-> energy boundary refinement -> sliding 1.5 s / 0.75 s chunks per speech
interval -> batched embedding extraction on the device -> AHC clustering
(mer_cos .3 / fix_cos_thr .3) -> compressed segment list -> RTTM/JSON plus
diagnostic sidecars (.meta.json RTF, .pairs.json cosines, .vad_info.json).
With a ``segmentation_model`` (``diar/dnn_seg.py``), the intervals where
it counts a speaker join the VAD's, and the clusters' segments are refined
by its per-frame speaker counts (``diar/overlap.py``), so two speakers may
overlap.

Device notes:
- Each file's waveform is uploaded once (int16 when every sample is exactly
  k/32768, else float32). Chunks are cut and circle-padded on the device by
  one index gather and fed straight into the embed call, so the host ships
  the audio once plus two int32 vectors per batch.
- Every batch is padded to ``batch_size`` rows, and every chunk of a call
  is circle-padded to the pad length of the JAX pipeline: chunk_dur, or the
  longest chunk rounded up to a multiple of chunk_dur. The JAX pipeline
  also pads the resident waveform to a power-of-two count of slabs; the
  gather reads only ``[start, start + len)``, so that padding changes no
  result and is left out.
- Embeddings stay on the device until the last batch is issued and come back
  in one copy.
"""

from __future__ import annotations

import json
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.diar import overlap
from speaker3d_tpu_torch.diar import vad as vad_mod
from speaker3d_tpu_torch.diar.cluster import CommonClustering, cosine_affinity
from speaker3d_tpu_torch.utils.fileio import load_audio
from speaker3d_tpu_torch.utils.wire import wire_quantize


def circle_pad(x: np.ndarray, target_len: int) -> np.ndarray:
    """Tile-pad a waveform to target length; longer inputs are truncated."""
    n = x.shape[0]
    if n >= target_len:
        return x[:target_len]
    reps = -(-target_len // n)
    return np.tile(x, reps)[:target_len]


def gather_chunks(wav: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                  chunk_len: int) -> torch.Tensor:
    """Cut and circle-pad chunks from a device-resident waveform.

    wav [n] int16|float32, starts/lens [B] int -> [B, chunk_len] float32 with
    row i = wav[starts[i] + (t mod lens[i])]; rows with lens == 0 (empty
    chunks and batch padding) are zero."""
    if wav.numel() == 0:
        return torch.zeros((starts.shape[0], chunk_len), dtype=torch.float32,
                           device=wav.device)
    t = torch.arange(chunk_len, device=wav.device)
    idx = starts[:, None] + t[None, :] % lens.clamp(min=1)[:, None]
    chunks = wav[idx]
    if chunks.dtype == torch.int16:
        # k/32768 is an exact power-of-two scale: bitwise equal to the host
        # int16 -> float32 conversion
        chunks = chunks.to(torch.float32) * (1.0 / 32768)
    else:
        chunks = chunks.to(torch.float32)
    return torch.where(lens[:, None] == 0, torch.zeros((), device=wav.device),
                       chunks)


def compressed_seg(seg_list):
    """Merge adjacent same-speaker chunks; split overlaps at the midpoint."""
    new_list: List[list] = []
    for i, (st, ed, cid) in enumerate(seg_list):
        if i == 0:
            new_list.append([st, ed, cid])
        elif cid == new_list[-1][2]:
            if st > new_list[-1][1]:
                new_list.append([st, ed, cid])
            else:
                new_list[-1][1] = ed
        else:
            if st < new_list[-1][1]:
                p = (new_list[-1][1] + st) / 2
                new_list[-1][1] = p
                st = p
            new_list.append([st, ed, cid])
    return new_list


def sliding_chunks(st: float, ed: float, dur: float, step: float):
    """Sliding windows over [st, ed]; short leftovers keep their true end."""
    chunks = []
    if ed - st <= 0:
        return chunks
    sub_st = st
    made = False
    while sub_st + dur < ed + step:
        chunks.append([sub_st, min(sub_st + dur, ed)])
        sub_st += step
        made = True
    if not made:
        chunks.append([st, ed])
    return chunks


class DiarizationPipeline:
    """Python API mirroring the reference Diarization3Dspeaker class.

    ``embed_fn``: maps a float32 waveform batch [B, L] on ``device`` to
    embeddings [B, D] (see ``eval.embedding.build_embedding_fn``).
    ``device``: where the waveform, the chunk gather and the embeddings live
    (default CUDA; ``"cpu"`` must be asked for)."""

    def __init__(self,
                 embed_fn: Callable,
                 sample_rate: int = 16000,
                 vad: Optional[Callable] = None,
                 cluster: Optional[Callable] = None,
                 speaker_num: Optional[int] = None,
                 no_chunk_after_vad: bool = False,
                 vad_threshold: float = 0.5,
                 vad_min_speech_ms: float = 200.0,
                 vad_max_silence_ms: float = 300.0,
                 vad_energy_threshold: float = 0.05,
                 vad_boundary_expansion_ms: float = 10.0,
                 vad_boundary_energy_percentile: float = 10.0,
                 cluster_mer_cos: float = 0.3,
                 cluster_fix_cos_thr: float = 0.3,
                 cluster_min_cluster_size: int = 0,
                 cluster_min_cluster_ratio: Optional[float] = None,
                 chunk_dur: float = 1.5,
                 chunk_step: float = 0.75,
                 batch_size: int = 64,
                 segmentation_model: Optional[Callable] = None,
                 segmentation_threshold: float = 0.5,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.embed_fn = embed_fn
        self.fs = sample_rate
        self.vad_model = vad or vad_mod.try_ten_vad(
            sample_rate, threshold=vad_threshold) or vad_mod.EnergyVAD(
                sample_rate, threshold=vad_threshold)
        self.cluster = cluster if cluster is not None else CommonClustering(
            "AHC", mer_cos=cluster_mer_cos, fix_cos_thr=cluster_fix_cos_thr,
            min_cluster_size=cluster_min_cluster_size,
            min_cluster_ratio=cluster_min_cluster_ratio, device=self.device)
        self.speaker_num = speaker_num
        self.no_chunk_after_vad = no_chunk_after_vad
        self.chunk_dur = chunk_dur
        self.chunk_step = chunk_step
        self.batch_size = batch_size
        self.segmentation_model = segmentation_model
        self.segmentation_threshold = segmentation_threshold

        # TenVad/EnergyVAD emit 16 ms-hop flags; a DnnVAD advertises its
        # 10 ms fbank hop as `.frame_ms`
        self.vad_frame_size_ms = float(getattr(self.vad_model, "frame_ms", 16.0))
        self.vad_min_speech_ms = vad_min_speech_ms
        self.vad_max_silence_ms = vad_max_silence_ms
        self.vad_energy_threshold = vad_energy_threshold
        self.vad_boundary_expansion_ms = vad_boundary_expansion_ms
        self.vad_boundary_energy_percentile = vad_boundary_energy_percentile

        # diagnostic state from the last call (fork sidecar surface)
        self.output_field_labels = None
        self.last_vad_time = None
        self.last_vad_time_raw = None
        self.last_vad_time_processed = None
        self.last_vad_refined_mask = None
        self._masked_audio_parts = None
        self._masked_audio_cache = None
        self.last_chunks = None
        self.last_wav_1d = None
        self.last_embeddings = None
        self.last_elapsed = None
        self.last_pairwise_stats = None
        # wire of the last upload: {'dtype', 'bytes'}
        self.last_wire = None
        self._resident = None  # (wav_1d, device tensor) of the last upload
        self.last_pad_len = None  # L of the last do_emb_extraction call
        # wall-clock per stage of the last call: upload, vad, vad_post,
        # [segmentation,] embed, cluster[, overlap_post]
        self.last_stage_times = {}

    @property
    def last_vad_masked_audio(self):
        """[1, n] waveform with non-speech zeroed (the .vad_masked.wav
        sidecar), computed lazily on first access."""
        if self._masked_audio_cache is None and self._masked_audio_parts:
            wav_1d, refined_mask = self._masked_audio_parts
            self._masked_audio_cache = (wav_1d * refined_mask)[None]
        return self._masked_audio_cache

    # ---- stages ------------------------------------------------------------

    def do_vad(self, wav_1d):
        return self.vad_model(wav_1d)

    def postprocess_vad(self, flags, wav_1d):
        hop = int(self.vad_frame_size_ms * self.fs / 1000)
        processed = vad_mod.post_process_speech_flags(
            flags, self.vad_frame_size_ms, self.vad_min_speech_ms,
            self.vad_max_silence_ms)
        processed_mask = vad_mod.flags_to_mask(processed, len(wav_1d), hop)
        refined_mask = vad_mod.refine_vad_boundaries_with_energy(
            wav_1d, processed_mask, self.fs, self.vad_energy_threshold,
            self.vad_boundary_energy_percentile, self.vad_boundary_expansion_ms)
        vad_time = vad_mod.mask_to_intervals(refined_mask, self.fs)
        return processed_mask, refined_mask, vad_time

    def resident_wav(self, wav_1d) -> torch.Tensor:
        """The waveform on the device, uploaded once per wav object: int16
        when every sample is exactly k/32768, else float32."""
        if self._resident is not None and self._resident[0] is wav_1d:
            return self._resident[1]
        w16 = wire_quantize(np.asarray(wav_1d))
        host = w16 if w16 is not None else np.ascontiguousarray(
            wav_1d, dtype=np.float32)
        self.last_wire = {"dtype": str(host.dtype), "bytes": host.nbytes}
        dev = torch.from_numpy(host).to(self.device)
        self._resident = (wav_1d, dev)
        return dev

    def do_emb_extraction(self, chunks: Sequence[Sequence[float]], wav_1d):
        """Embed chunks gathered on the device from the resident waveform.

        Every chunk is circle-padded to L, as in the JAX pipeline:
        ``L0 = int(chunk_dur * fs)``, and L = L0 when no chunk is longer, else
        the longest chunk rounded up to a multiple of L0. So one sliding
        window that ``int(t * fs)`` rounds to L0 + 1 samples pads every chunk
        of the call to 2 * L0, and whole segments (.pairs.json) are padded to
        a multiple of chunk_dur. ``last_pad_len`` keeps the call's L."""
        L0 = int(self.chunk_dur * self.fs)
        bounds = [(int(st * self.fs), int(ed * self.fs)) for st, ed in chunks]
        max_len = max((ed - st for st, ed in bounds), default=L0)
        L = L0 if max_len <= L0 else -(-max_len // L0) * L0
        self.last_pad_len = L
        wav = self.resident_wav(wav_1d)
        bs = self.batch_size
        n = len(bounds)
        n_pad = -(-n // bs) * bs
        starts = np.zeros(n_pad, np.int64)
        lens = np.zeros(n_pad, np.int64)
        starts[:n] = [st for st, _ in bounds]
        lens[:n] = [ed - st for st, ed in bounds]
        starts = torch.from_numpy(starts).to(self.device)
        lens = torch.from_numpy(lens).to(self.device)
        outs = []
        for s in range(0, n_pad, bs):
            batch = gather_chunks(wav, starts[s:s + bs], lens[s:s + bs], L)
            outs.append(torch.as_tensor(self.embed_fn(batch)))
        return torch.cat(outs)[:n].cpu().numpy()

    def do_clustering(self, chunks, embeddings, speaker_num=None):
        labels = self.cluster(
            embeddings,
            speaker_num=speaker_num if speaker_num is not None else self.speaker_num)
        speaker_num = int(labels.max()) + 1
        fields = [[c[0], c[1], int(l)] for c, l in zip(chunks, labels)]
        return speaker_num, compressed_seg(fields)

    # ---- entry -------------------------------------------------------------

    def __call__(self, wav, wav_fs=None, speaker_num=None):
        t0 = time.time()
        stages = self.last_stage_times = {}
        wav_data = load_audio(wav, wav_fs, self.fs)
        wav_1d = np.asarray(wav_data)[0]
        # the exact audio this call processed: sidecar writers reuse THIS
        # object, so the identity-keyed upload is reused too
        self.last_wav_1d = wav_1d

        t = time.time()
        self.resident_wav(wav_1d)
        stages["upload"] = time.time() - t

        t = time.time()
        flags, wav_for_vad = self.do_vad(wav_1d)
        stages["vad"] = time.time() - t

        t = time.time()
        processed_mask, refined_mask, vad_time = self.postprocess_vad(
            flags, wav_for_vad)
        hop = int(self.vad_frame_size_ms * self.fs / 1000)
        self.last_vad_time_raw = vad_mod.flags_to_intervals(
            flags, len(wav_for_vad), hop, self.fs)
        self.last_vad_time_processed = vad_mod.mask_to_intervals(
            processed_mask, self.fs)
        self.last_vad_refined_mask = refined_mask
        stages["vad_post"] = time.time() - t

        if self.segmentation_model is not None:
            t = time.time()
            segmentations, count = overlap.run_segmentation(
                self.segmentation_model, wav_1d, self.fs,
                threshold=self.segmentation_threshold)
            vad_time = vad_mod.merge_vad(vad_time,
                                         overlap.get_valid_field(count))
            stages["segmentation"] = time.time() - t

        if self.no_chunk_after_vad:
            chunks = [[st, ed] for st, ed in vad_time]
        else:
            chunks = [c for st, ed in vad_time
                      for c in sliding_chunks(st, ed, self.chunk_dur,
                                              self.chunk_step)]
        self.last_vad_time = vad_time
        self._masked_audio_parts = (wav_1d, refined_mask)
        self._masked_audio_cache = None
        self.last_chunks = chunks

        if len(chunks) == 0:
            self.output_field_labels = []
            self.last_embeddings = np.zeros((0, 1), np.float32)
            self.last_elapsed = time.time() - t0
            return []

        t = time.time()
        embeddings = self.do_emb_extraction(chunks, wav_1d)
        self.last_embeddings = embeddings
        stages["embed"] = time.time() - t

        t = time.time()
        spk_num, fields = self.do_clustering(chunks, embeddings, speaker_num)
        stages["cluster"] = time.time() - t

        if self.segmentation_model is not None:
            t = time.time()
            binary, timestamps = overlap.post_process(
                fields, spk_num, segmentations, count,
                threshold=self.segmentation_threshold)
            fields = overlap.binary_to_segs(binary, timestamps)
            stages["overlap_post"] = time.time() - t

        self.output_field_labels = fields
        self.last_elapsed = time.time() - t0
        return fields

    # ---- outputs -----------------------------------------------------------

    def save_diar_output(self, out_file, wav_id=None, output_field_labels=None):
        # `is None`, not falsy: an explicitly passed EMPTY result list must
        # write an empty file, not fall back to the previous file's segments
        fields = (output_field_labels if output_field_labels is not None
                  else self.output_field_labels)
        if fields is None:
            raise ValueError("No results can be saved.")
        wav_id = wav_id or "default"
        if str(out_file).endswith("rttm"):
            with open(out_file, "w") as f:
                for st, ed, cid in fields:
                    f.write(f"SPEAKER {wav_id} 0 {st:.3f} {ed - st:.3f} "
                            f"<NA> <NA> {int(cid):d} <NA> <NA>\n")
        elif str(out_file).endswith("json"):
            out = {}
            for st, ed, cid in fields:
                segid = f"{wav_id}_{round(st, 3)}_{round(ed, 3)}"
                out[segid] = {"start": st, "stop": ed, "speaker": int(cid)}
            with open(out_file, "w") as f:
                json.dump(out, f, indent=2)
        else:
            raise ValueError("Supported output formats: RTTM and JSON.")

    def save_meta(self, out_file, wav_duration_s: float, wav_path=None):
        """RTF sidecar with the reference's key names; the pairwise stats
        are filled when save_pairs ran for this file."""
        elapsed = self.last_elapsed or 0.0
        stats = self.last_pairwise_stats or {}
        meta = {
            "wav_path": wav_path,
            "duration_sec": wav_duration_s,
            "processing_time_sec": elapsed,
            "rtf": elapsed / wav_duration_s if wav_duration_s > 0 else None,
            "pairwise_min_cosine": stats.get("min"),
            "pairwise_mean_cosine": stats.get("mean"),
        }
        with open(out_file, "w") as f:
            json.dump(meta, f, indent=2)

    def save_pairs(self, out_file, wav_1d=None):
        """Pairwise cosines between the final diarized segments, re-embedded
        from ``wav_1d``; without audio, between the chunk embeddings."""
        self.last_pairwise_stats = None
        segs = self.output_field_labels or []
        if wav_1d is not None and len(segs) >= 2:
            seg_times = [[float(s[0]), float(s[1])] for s in segs]
            embs = self.do_emb_extraction(seg_times, wav_1d)
            z = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-12)
            aff = z @ z.T
            iu = np.triu_indices(aff.shape[0], k=1)
            vals = aff[iu]
            if vals.size:
                self.last_pairwise_stats = {"min": float(vals.min()),
                                            "mean": float(vals.mean())}
            pairs = [{
                "i": int(i), "j": int(j),
                "seg_i": {"start": float(segs[i][0]),
                          "stop": float(segs[i][1]),
                          "speaker": int(segs[i][2])},
                "seg_j": {"start": float(segs[j][0]),
                          "stop": float(segs[j][1]),
                          "speaker": int(segs[j][2])},
                "cosine": float(aff[i, j]),
            } for i, j in zip(*iu)]
            data = {"pairs": pairs}
        elif self.last_embeddings is None or len(self.last_embeddings) == 0:
            data = {"pairs": []}
        else:
            aff = cosine_affinity(self.last_embeddings)
            n = aff.shape[0]
            data = {"pairs": [{
                "i": i, "j": j,
                "chunk_i": self.last_chunks[i],
                "chunk_j": self.last_chunks[j],
                "cosine": float(aff[i, j]),
            } for i in range(n) for j in range(i + 1, n)]}
        with open(out_file, "w") as f:
            json.dump(data, f, indent=2)

    def save_vad_plot(self, out_file, wav_1d=None, sample_rate=None):
        """3-panel VAD figure: waveform with raw / processed / refined
        interval overlays (needs matplotlib)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        wav = (np.asarray(wav_1d) if wav_1d is not None
               else (self.last_vad_masked_audio[0]
                     if self.last_vad_masked_audio is not None else None))
        if wav is None:
            raise ValueError("no waveform available for plotting")
        if sample_rate is None:
            sample_rate = self.fs  # time axis must match the VAD overlays
        t = np.arange(len(wav)) / sample_rate
        panels = [("raw VAD", self.last_vad_time_raw),
                  ("post-processed", self.last_vad_time_processed),
                  ("refined", self.last_vad_time)]
        fig, axes = plt.subplots(3, 1, figsize=(14, 7), sharex=True)
        for ax, (title, intervals) in zip(axes, panels):
            ax.plot(t, wav, linewidth=0.3, color="#444")
            for st, ed in (intervals or []):
                ax.axvspan(st, ed, color="tab:green", alpha=0.3)
            ax.set_title(title, fontsize=9)
            ax.set_ylabel("amp")
        axes[-1].set_xlabel("time [s]")
        fig.tight_layout()
        fig.savefig(out_file, dpi=100)
        plt.close(fig)

    def save_vad_info(self, out_file):
        data = {
            "raw": self.last_vad_time_raw,
            "processed": self.last_vad_time_processed,
            "refined": self.last_vad_time,
        }
        with open(out_file, "w") as f:
            json.dump(data, f, indent=2)
