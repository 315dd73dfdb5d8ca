"""The port's audio-visual host code (``speaker3d_tpu_torch/diar/video.py``,
``diar/cluster.py::JointClustering``) against the JAX package's on the
CPU: the bilinear resize and the sharpness score bit-equal; face tracking
on rendered moving faces (with missed detections, a face leaving for more
than 10 frames, a short track and the quality filter) giving the same
tracks, times and crops; the ASD audio slices each scorer receives, the
track embeddings and the per-frame vision inputs equal; JointClustering's
labels equal on a seeded hypothesis sweep (injected audio and vision
labels, several strides) and with each package's AHC."""

import types

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.cli import infer_diarization_video as jcli
from speaker3d_tpu.data.synthetic_faces import render_moving_face_video
from speaker3d_tpu.diar import cluster as jcluster
from speaker3d_tpu.diar import video as jvideo
from speaker3d_tpu_torch.cli import infer_diarization_video as tcli
from speaker3d_tpu_torch.diar import cluster as tcluster
from speaker3d_tpu_torch.diar import video as tvideo
from speaker3d_tpu_torch.ops.mfcc import mfcc
from tests.torch_threads import cap_torch_threads  # noqa: F401


def test_resize_and_sharpness_bit_equal():
    rng = np.random.default_rng(0)
    for shape, size in (((37, 53), 24), ((112, 112), 112), ((5, 90), 112),
                        ((0, 4), 8)):
        patch = rng.uniform(0, 255, shape).astype(np.float32)
        got, want = tvideo.resize_bilinear(patch, size), \
            jvideo.resize_bilinear(patch, size)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    crops = rng.uniform(0, 255, (6, 32, 32)).astype(np.float32)
    assert tvideo.crop_sharpness(crops) == jvideo.crop_sharpness(crops)


def _scene(seed=5, n_frames=60):
    """Rendered moving faces; the detector sees the true boxes but misses
    face 0 at frames 10-12 (the track lives on) and 20-34 (it ends), drops
    face 1 at random and adds a 2-frame blip."""
    frames, boxes = render_moving_face_video(np.random.default_rng(seed),
                                             n_frames=n_frames, n_faces=2)
    rng = np.random.default_rng(seed + 1)
    dets = []
    for i, bl in enumerate(boxes):
        d = []
        if not (10 <= i <= 12 or 20 <= i <= 34):
            d.append(bl[0])
        if rng.random() > 0.1:
            d.append(bl[1])
        if i in (40, 41):
            d.append((5, 5, 20, 24))
        dets.append(d)
    times = [0.04 * i + 0.3 for i in range(n_frames)]
    return frames, times, dets


def _tracks(video_mod, min_quality):
    frames, times, dets = _scene()
    it = iter(dets)
    return video_mod.build_face_tracks(frames, times, lambda f: next(it),
                                       min_quality=min_quality)


def _assert_same_tracks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.start_time == w.start_time and g.frame_times == w.frame_times
        assert g.crops.dtype == w.crops.dtype
        assert g.crops.tobytes() == w.crops.tobytes()


def test_tracking_asd_and_embeddings_equal():
    for min_quality in (0.0, 50.0):
        _assert_same_tracks(_tracks(tvideo, min_quality),
                            _tracks(jvideo, min_quality))
    got, want = _tracks(tvideo, 0.0), _tracks(jvideo, 0.0)
    assert len(got) >= 3  # face 0 twice, face 1; the blip is dropped
    wav = np.random.default_rng(2).standard_normal(16000 * 3).astype(
        np.float32)
    feats = mfcc(wav, 16000)
    seen = {"t": [], "j": []}

    def scorer(key):
        def score(audio, crops):
            assert audio.shape == (4 * len(crops), 13)
            seen[key].append(audio.copy())
            return (audio.reshape(len(crops), -1).mean(axis=1)
                    > 0).astype(np.float32)
        return score

    for fps in (25.0, 12.5):
        tvideo.score_tracks_asd(got, feats, scorer("t"), fps=fps)
        jvideo.score_tracks_asd(want, feats, scorer("j"), fps=fps)
        for g, w in zip(got, want):
            assert g.asd_scores.tobytes() == w.asd_scores.tobytes()
    assert all(a.tobytes() == b.tobytes() for a, b in zip(seen["t"],
                                                           seen["j"]))
    args = types.SimpleNamespace(face_embed_onnx=None)
    tvideo.embed_tracks(got, tcli.build_face_embedder(args))
    jvideo.embed_tracks(want, jcli.build_face_embedder(args))
    for g, w in zip(got, want):
        assert g.embedding.tobytes() == w.embedding.tobytes()
    (tx, tt), (jx, jt) = (tvideo.tracks_to_vision_inputs(got),
                          jvideo.tracks_to_vision_inputs(want))
    assert tx.tobytes() == jx.tobytes() and tt == jt
    assert tvideo.tracks_to_vision_inputs([])[0].shape == (0, 1)


def _energy_inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((40, 13)), np.zeros((10, 112, 112))


def test_energy_scorer_equal():
    args = types.SimpleNamespace(asd_exp_dir=None)
    for seed in range(3):
        audio, crops = _energy_inputs(seed)
        got = tcli.build_asd_scorer(args, "cpu")(audio, crops)
        want = jcli.build_asd_scorer(args, None, 16000)(audio, crops)
        assert got.tobytes() == want.tobytes()


def _joint_case(seed, n_chunks, n_vspk, stride):
    rng = np.random.default_rng(seed)
    d = 12
    centers = rng.standard_normal((4, d))
    alab = rng.integers(0, 3, n_chunks)
    audioX = centers[alab] + 0.3 * rng.standard_normal((n_chunks, d))
    starts = np.cumsum(rng.uniform(0.3, 1.0, n_chunks))
    audioT = [[float(s), float(s + 1.5)] for s in starts]
    visionT, vlab = [], []
    t = float(rng.uniform(0, 2))
    end = starts[-1] + 1.5
    while t < end:
        spk = int(rng.integers(0, n_vspk))
        for _ in range(int(rng.integers(5, 60))):
            visionT.append(round(t, 4))
            vlab.append(spk)
            t += 0.04 * stride * (1 if rng.random() > 0.05 else 3)
        t += float(rng.uniform(0, 1.5))
    vcent = rng.standard_normal((n_vspk, 8))
    visionX = vcent[vlab] + 0.05 * rng.standard_normal((len(vlab), 8))
    conf = types.SimpleNamespace(face_det_stride=stride)
    return (audioX, visionX, audioT, visionT, conf, alab.copy(),
            np.asarray(vlab))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**16), n_chunks=st.integers(2, 60),
       n_vspk=st.integers(1, 4), stride=st.sampled_from([1, 2, 2.5]))
def test_joint_clustering_labels_equal(seed, n_chunks, n_vspk, stride):
    audioX, visionX, audioT, visionT, conf, alab, vlab = _joint_case(
        seed, n_chunks, n_vspk, stride)
    got = tcluster.JointClustering(lambda X: alab.copy(),
                                   lambda X: vlab.copy())(
        audioX, visionX, audioT, visionT, conf)
    want = jcluster.JointClustering(lambda X: alab.copy(),
                                    lambda X: vlab.copy())(
        audioX, visionX, audioT, visionT, conf)
    np.testing.assert_array_equal(got, want)


def test_joint_clustering_with_each_packages_ahc():
    for seed in range(4):
        audioX, visionX, audioT, visionT, conf, _, _ = _joint_case(
            seed, 50, 3, 1)
        kw = dict(mer_cos=0.3, fix_cos_thr=0.3)
        got = tcluster.JointClustering(
            tcluster.CommonClustering("AHC", device="cpu", **kw),
            tcluster.CommonClustering("AHC", device="cpu", **kw))(
            audioX, visionX, audioT, visionT, conf)
        want = jcluster.JointClustering(
            jcluster.CommonClustering("AHC", **kw),
            jcluster.CommonClustering("AHC", **kw))(
            audioX, visionX, audioT, visionT, conf)
        np.testing.assert_array_equal(got, want)
