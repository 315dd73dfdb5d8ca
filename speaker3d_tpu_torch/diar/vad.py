"""Voice activity detection: pluggable frame-level VAD + the fork's exact
post-processing chain.

The port's own copy of ``speaker3d_tpu/diar/vad.py`` (pure numpy, host
side); the tests hold the two equal.

Behavioral contract (reference: speakerlab/bin/infer_diarization.py):
  - frame flags at a 16 ms hop (TenVadWrapper, :120-166). TenVad itself is a
    closed native dependency; we control only its contract, so the default
    in-repo VAD is an adaptive energy VAD with the same interface, and any
    callable `wav[n] -> (flags, wav)` plugs in.
  - post-processing (:347-384): moving-average smoothing (win 3, >0.5),
    fill silence gaps <= 300 ms, drop speech < 200 ms.
  - energy boundary refinement (:386-457): 20 ms/10 ms frame energy with
    overlap-max accumulation, percentile-10 dynamic threshold (floored),
    forward/backward contraction within a 100 ms lookahead, then bounded
    re-expansion (the reference re-expands the tail fully to the original
    segment end — reproduced exactly).
"""

from __future__ import annotations

import numpy as np


class EnergyVAD:
    """Adaptive frame-energy VAD with the TenVad wrapper's interface.

    Decision per 16 ms frame: speech iff the frame RMS energy exceeds
    max(abs_floor, noise_percentile * snr_factor). The adaptive term tracks
    the recording's noise floor via a low percentile of frame energies.
    """

    def __init__(self, sample_rate: int = 16000, frame_ms: float = 16.0,
                 threshold: float = 0.5, abs_floor: float = 1e-4,
                 noise_percentile: float = 10.0, snr_factor: float = 4.0):
        self.sample_rate = sample_rate
        self.frame_ms = frame_ms  # pipeline reads this to scale intervals
        self.hop_size = int(frame_ms * sample_rate / 1000)
        self.threshold = threshold
        self.abs_floor = abs_floor
        self.noise_percentile = noise_percentile
        self.snr_factor = snr_factor

    def __call__(self, wav_1d):
        x = np.asarray(wav_1d, dtype=np.float32).reshape(-1)
        if x.size == 0:
            return [], x
        x = np.clip(x, -1.0, 1.0)
        n_frames = len(x) // self.hop_size
        if n_frames == 0:
            return [0] * 0, x
        frames = x[: n_frames * self.hop_size].reshape(n_frames, self.hop_size)
        energy = np.sqrt(np.mean(np.square(frames), axis=1) + 1e-12)
        noise = np.percentile(energy, self.noise_percentile)
        # Cap at half the loud-frame level so recordings with no silence
        # (noise floor == speech level) still classify as speech; the
        # absolute floor keeps all-silence recordings silent.
        thr = max(self.abs_floor,
                  min(noise * self.snr_factor,
                      0.5 * np.percentile(energy, 95)))
        flags = (energy > thr).astype(int).tolist()
        return flags, x


def try_ten_vad(sample_rate=16000, frame_ms=16.0, threshold=0.5):
    """Use the external ten_vad native lib if present; else None.
    (reference: bin/infer_diarization.py:126-166)"""
    try:
        from ten_vad import TenVad  # type: ignore
    except ImportError:
        return None

    hop = int(frame_ms * sample_rate / 1000)
    engine = TenVad(hop, threshold)

    def vad(wav_1d):
        x = np.clip(np.asarray(wav_1d, dtype=np.float32).reshape(-1), -1, 1)
        x16 = (x * 32767).astype(np.int16)
        flags = []
        for i in range(len(x16) // hop):
            _, f = engine.process(x16[i * hop:(i + 1) * hop])
            flags.append(int(f))
        return flags, x

    return vad


def _runs(x):
    """Run-length encode a 0/1 array -> (starts, lengths, values)."""
    change = np.flatnonzero(x[1:] != x[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(x)]))
    return starts, ends - starts, x[starts]


def _repeat_blocks(values, width: int):
    """``np.repeat(values, width)`` via a broadcast fill.

    This numpy build's np.repeat is a scalar loop (measured 5.8 s for 86M
    output samples on the 90-min bench, like its cumsum/diff); a broadcast
    assignment into a reshaped output runs at memcpy speed."""
    values = np.asarray(values, dtype=np.float32)
    out = np.empty(values.shape[0] * width, np.float32)
    out.reshape(-1, width)[:] = values[:, None]
    return out


def _edges01(mask):
    """(starts, ends) of the 1-runs of a 0/1 array, diff-free.

    Equivalent to np.where(np.diff(np.concatenate(([0], mask, [0]))) > 0)
    etc. — np.diff here is a scalar loop (measured 12 s on 86M samples)."""
    m = np.asarray(mask) > 0
    if m.shape[0] == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    rise = np.flatnonzero(m[1:] & ~m[:-1]) + 1
    fall = np.flatnonzero(~m[1:] & m[:-1]) + 1
    if m[0]:
        rise = np.concatenate(([0], rise))
    if m[-1]:
        fall = np.concatenate((fall, [m.shape[0]]))
    return rise, fall


def post_process_speech_flags(flags, frame_ms: float = 16.0,
                              min_speech_ms: float = 200.0,
                              max_silence_ms: float = 300.0):
    """Smooth + fill short gaps + drop short speech.

    Vectorized run-length implementation of the reference's sequential scans
    (reference: bin/infer_diarization.py:347-384). Semantics preserved
    exactly: a gap/segment is only rewritten when a frame of the *other*
    class follows it, so trailing runs are never modified, while leading
    runs are.
    """
    flags = np.asarray(flags, dtype=np.float32)
    if flags.size == 0:
        return flags
    win = 3
    pad = np.pad(flags, (win // 2, win // 2), mode="edge")
    smooth = (np.convolve(pad, np.ones(win) / win, mode="valid") > 0.5).astype(
        np.float32)

    min_speech = max(1, int(min_speech_ms / frame_ms))
    max_silence = max(1, int(max_silence_ms / frame_ms))

    res = smooth.copy()
    # fill silence gaps <= max_silence that are followed by speech
    starts, lengths, values = _runs(res)
    for k in np.flatnonzero((values == 0) & (lengths <= max_silence)):
        if k < len(values) - 1:  # a speech frame follows
            res[starts[k]:starts[k] + lengths[k]] = 1
    # drop speech runs < min_speech that are followed by silence
    starts, lengths, values = _runs(res)
    for k in np.flatnonzero((values == 1) & (lengths < min_speech)):
        if k < len(values) - 1:
            res[starts[k]:starts[k] + lengths[k]] = 0
    return res


def flags_to_mask(flags, num_samples: int, hop_size: int):
    """Frame flags -> per-sample {0,1} mask."""
    mask = np.zeros(num_samples, dtype=np.float32)
    rep = _repeat_blocks(flags, hop_size)
    k = min(rep.shape[0], num_samples)
    mask[:k] = rep[:k]
    return mask


def frame_energy_envelope(audio, sample_rate: int):
    """Overlap-max 20 ms / 10 ms frame energy per sample.

    (reference: bin/infer_diarization.py:391-401) The reference writes each
    frame's running max over its whole window, each frame overwriting the
    previous frame's overlap, so with window >= hop the final value at sample
    j is cummax(frame_energy)[last frame covering j] — computed here in
    closed vectorized form (the sequential loop was the diarization host-side
    bottleneck on hour-scale files).
    """
    window = int(0.02 * sample_rate)
    hop = int(0.01 * sample_rate)
    n = len(audio)
    n_frames = (n - window) // hop + 1
    env = np.zeros(n, dtype=np.float32)
    if n_frames <= 0:
        return env
    # Per-frame mean energy. Every frame is full-width: n_frames was chosen
    # so starts[-1] + window <= n. A strided window view + row sums stays
    # vectorized (np.cumsum is a scalar loop in this numpy build and costs
    # seconds per 10 min of audio).
    sq = np.square(np.asarray(audio, dtype=np.float32))
    frames = np.lib.stride_tricks.sliding_window_view(sq, window)[::hop]
    en = frames.sum(axis=1, dtype=np.float64) / window
    starts = np.arange(n_frames) * hop
    ends = starts + window
    if window >= hop:
        # env is piecewise-constant per hop block: block i (< n_frames) holds
        # cummax(en)[i]; samples in [n_frames*hop, ends[-1]) hold the global
        # max; samples past the last frame's end stay 0.
        m = np.maximum.accumulate(en).astype(np.float32)
        head = _repeat_blocks(m, hop)
        k = min(head.shape[0], n)
        env[:k] = head[:k]
        env[k:int(ends[-1])] = m[-1]
    else:  # disjoint frames (never the 20/10 ms case): direct writes
        for i in range(n_frames):
            env[starts[i]:ends[i]] = en[i]
    return env


def _sorted_env_percentile(env, s, e, ends_last, p):
    """``np.percentile(env[s:e], p)`` in O(1).

    Valid only for envelopes from `frame_energy_envelope` with
    window >= hop: there env is NON-DECREASING on [0, ends_last) (it
    repeats cummax'd frame energies) and zero after, so the sorted
    segment is [zeros...] + env[s:min(e, ends_last)] and the two order
    statistics the linear method interpolates are direct lookups. The
    interpolation replicates numpy's _lerp exactly (both t<0.5 and
    t>=0.5 branches) so results are bitwise np.percentile's — the
    per-segment percentile was the diarization host chain's top cost
    (3.3 s of a 5.1 s 90-min pass, tools/profile_vad.py)."""
    if not 0.0 <= p <= 100.0:  # np.percentile's validation, kept loud
        raise ValueError("Percentiles must be in the range [0, 100]")
    n = e - s
    body_end = min(e, ends_last)
    z = e - body_end if body_end > s else n  # zeros sort first

    # replicate np.percentile's dtype path exactly: for float input the
    # quantile, virtual index, and gamma are all computed in the ARRAY's
    # dtype (numpy: q = true_divide(q, a.dtype.type(100)); linear's
    # get_virtual_index = (n-1)*q; _get_gamma casts to virtual's dtype),
    # and _lerp runs in that dtype with a branch at gamma >= 0.5
    ft = env.dtype.type if env.dtype.kind == "f" else np.float64
    virtual = ft(n - 1) * np.true_divide(p, ft(100))
    i0 = int(np.floor(virtual))
    t = virtual - ft(i0)

    def val(i):
        if i < z:
            return ft(0)
        return env[s + (i - z)]

    a = val(i0)
    b = val(min(i0 + 1, n - 1))
    diff = b - a
    if t >= 0.5:
        return b - diff * (ft(1) - t)
    return a + diff * t


def refine_vad_boundaries_with_energy(audio, vad_mask, sample_rate: int,
                                      energy_threshold: float = 0.05,
                                      energy_percentile: float = 10.0,
                                      boundary_expansion_ms: float = 10.0):
    """Contract segment boundaries past low-energy samples, then re-expand
    within the original segment. (reference: bin/infer_diarization.py:386-457)"""
    refined = vad_mask.copy()
    hop = int(0.01 * sample_rate)
    env = frame_energy_envelope(audio, sample_rate)
    if not env.any():
        return refined

    starts, ends = _edges01(vad_mask)
    if len(starts) == 0:
        return refined

    # fast-percentile precondition (the 20 ms / 10 ms case): env is
    # cummax-monotone up to the last frame's end, zero after
    window = int(0.02 * sample_rate)
    n_frames = (len(audio) - window) // hop + 1
    ends_last = (n_frames - 1) * hop + window if (
        n_frames > 0 and window >= hop) else None

    lookahead = 10 * hop
    expand = int(boundary_expansion_ms * sample_rate / 1000.0)

    for start, end in zip(starts, ends):
        seg = env[start:end]
        if seg.size == 0:
            continue
        if ends_last is not None:
            pct = _sorted_env_percentile(env, start, end, ends_last,
                                         energy_percentile)
        else:
            pct = np.percentile(seg, energy_percentile)
        thr = max(pct, energy_threshold)

        new_start = start
        head = env[start:min(end, start + lookahead)]
        low = np.flatnonzero(head < thr)
        if low.size:
            new_start = start + int(low[0])
            refined[start:new_start] = 0

        new_end = end
        tail_lo = max(new_start, end - lookahead)
        tail = env[tail_lo + 1:end][::-1]  # indices end-1 .. tail_lo+1
        low = np.flatnonzero(tail < thr)
        if low.size:
            i = end - 1 - int(low[0])
            refined[i:end] = 0
            new_end = i + 1

        if expand > 0:
            refined[max(start, new_start - expand):new_start] = 1
            # the reference re-fills the tail up to the original end
            refined[new_end:end] = 1
    return refined.astype(np.float32)


def mask_to_intervals(mask, sample_rate: int):
    """Per-sample mask -> [[start_sec, end_sec], ...].
    (reference: bin/infer_diarization.py:459-482)"""
    if len(mask) == 0:
        return []
    starts, ends = _edges01(mask)
    return [[float(s) / sample_rate, float(e) / sample_rate]
            for s, e in zip(starts, ends) if e > s]


def flags_to_intervals(flags, num_samples: int, hop_size: int, sample_rate: int):
    """Raw frame flags -> intervals. (reference: bin/infer_diarization.py:484-509)"""
    intervals = []
    flags = list(flags)
    i, N = 0, len(flags)
    while i < N:
        if flags[i]:
            j = i + 1
            while j < N and flags[j]:
                j += 1
            st = i * hop_size / sample_rate
            ed = min(j * hop_size, num_samples) / sample_rate
            if ed > st:
                intervals.append([st, ed])
            i = j
        else:
            i += 1
    return intervals


def merge_vad(vad1, vad2):
    """Union of two interval lists. (reference: utils/utils.py:129-138)"""
    intervals = [list(iv) for iv in list(vad1) + list(vad2)]
    intervals.sort(key=lambda x: x[0])
    merged = []
    for iv in intervals:
        if not merged or merged[-1][1] < iv[0]:
            merged.append(iv)
        else:
            merged[-1][1] = max(merged[-1][1], iv[1])
    return merged
