"""``speaker3d_tpu_torch/diar/overlap.py`` against the JAX package's copy on
the CPU: every function bit-equal on seeded random segmentations, over a
hypothesis sweep of chunk counts, frame steps and thresholds."""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.diar import overlap as jov
from speaker3d_tpu_torch.diar import overlap as tov
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000


def _segmentation(mod, rng, n_chunks, fpc, n_cls, frame_step, step_frames):
    data = rng.random((n_chunks, fpc, n_cls)).astype(np.float32)
    starts = np.arange(n_chunks) * step_frames * frame_step
    return mod.SlidingSegmentation(data=data, chunk_starts=starts,
                                   frame_step=frame_step,
                                   frame_duration=0.025)


def _fields(rng, duration, n_spk, n_seg):
    cuts = np.sort(rng.uniform(0, duration, 2 * n_seg)).reshape(-1, 2)
    return [[float(a), float(b), int(rng.integers(n_spk))] for a, b in cuts]


def _same(a, b):
    """Equal structure, types and values (floats bit-equal)."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


@settings(max_examples=40, deadline=None)
@given(n_chunks=st.integers(1, 12), fpc=st.integers(5, 60),
       n_cls=st.integers(1, 3), frame_step=st.sampled_from([0.01, 0.016,
                                                              0.0169]),
       step_frames=st.integers(1, 30), threshold=st.floats(0.05, 0.95),
       n_spk=st.integers(1, 4), seed=st.integers(0, 2**31 - 1))
def test_overlap_functions_bit_equal(n_chunks, fpc, n_cls, frame_step,
                                     step_frames, threshold, n_spk, seed):
    segs = {mod: _segmentation(mod, np.random.default_rng(seed), n_chunks,
                               fpc, n_cls, frame_step, step_frames)
            for mod in (jov, tov)}
    jseg, tseg = segs[jov], segs[tov]
    assert jseg.num_chunks == tseg.num_chunks == n_chunks
    num_frames = int(step_frames * (n_chunks - 1) + fpc
                     + np.random.default_rng(seed).integers(-4, 5))
    num_frames = max(num_frames, 1)
    jc = jov.aggregate_count(jseg, num_frames, threshold)
    tc = tov.aggregate_count(tseg, num_frames, threshold)
    _same(tc.data, jc.data)
    assert (tc.frame_step, tc.frame_duration, len(tc)) == (
        jc.frame_step, jc.frame_duration, len(jc))
    for t in (0.0, 0.013, frame_step * 7.5, 1.234):
        assert tc.closest_frame(t) == jc.closest_frame(t)
    for i in (0, 1, num_frames - 1):
        assert tc.middle(i) == jc.middle(i)
    _same(tov.get_valid_field(tc), jov.get_valid_field(jc))

    duration = num_frames * frame_step
    fields = _fields(np.random.default_rng(seed + 1), duration, n_spk,
                     int(np.random.default_rng(seed).integers(1, 8)))
    spk_num = max(f[2] for f in fields) + 1
    jb, jt = jov.post_process(fields, spk_num, jseg, jc, threshold)
    tb, tt = tov.post_process(fields, spk_num, tseg, tc, threshold)
    _same(tb, jb)
    _same(tt, jt)
    _same(tov.binary_to_segs(tb, tt), jov.binary_to_segs(jb, jt))
    for thr in (0.5, threshold):
        _same(tov.binary_to_segs(tb, tt, thr), jov.binary_to_segs(jb, jt, thr))


@settings(max_examples=15, deadline=None)
@given(seconds=st.floats(0.3, 9.0), threshold=st.floats(0.1, 0.9),
       seed=st.integers(0, 2**31 - 1))
def test_run_segmentation_bit_equal(seconds, threshold, seed):
    """run_segmentation with a stand-in model: windows of 2 s every 0.5 s
    of seeded activations, as ``DnnSegmenter`` lays them out."""
    wav = np.zeros(int(seconds * FS), np.float32)

    def model_for(mod):
        def model(x, fs):
            n_win = max(1, 1 + -(-max(len(x) - 2 * fs, 0) // (fs // 2)))
            rng = np.random.default_rng(seed)
            return mod.SlidingSegmentation(
                data=rng.random((n_win, 198, 3)).astype(np.float32),
                chunk_starts=np.arange(n_win) * 0.5, frame_step=0.01,
                frame_duration=0.025)
        return model

    js, jc = jov.run_segmentation(model_for(jov), wav, FS, threshold)
    ts, tc = tov.run_segmentation(model_for(tov), wav, FS, threshold)
    _same(ts.data, js.data)
    _same(tc.data, jc.data)
    assert len(tc) == len(jc) == int(np.ceil(len(wav) / FS / 0.01))
