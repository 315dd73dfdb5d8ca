"""The port's video diarization CLI (``speaker3d_tpu_torch/cli/
infer_diarization_video.py --device cpu``) against the JAX CLI on
``tests/test_video_cli.py``'s MJPG video (two speakers, each face visible
during its own turns, the tiny x-vector experiment trained by the JAX
trainer), writing identical RTTM bytes and the same closing line with:
the ``--face_boxes_json`` table and the energy ASD scorer at the video's
10 fps and decimated to ``--fps 5``; a face detector trained once by the
port's trainer on the video's own annotated frames (its JSONL ``data``
branch) and read by both CLIs; and a seeded JAX TalkNet ``asd_state``
experiment. Both CLIs refuse a run without a detector with the same
error."""

import json
import os

import jax
import numpy as np
import pytest
import yaml

from tests.test_video_cli import video_setup  # noqa: F401  (the fixture)
from tests.torch_threads import cap_torch_threads  # noqa: F401
from speaker3d_tpu.cli import infer_diarization_video as jcli
from speaker3d_tpu_torch.cli import infer_diarization_video as tcli


@pytest.fixture(scope="module")
def detector_exp(video_setup, tmp_path_factory):  # noqa: F811
    """A detector trained by the port's CLI on a JSONL of the video's own
    frames and boxes (every other frame)."""
    cv2 = pytest.importorskip("cv2")
    from speaker3d_tpu_torch.cli.train_face_detector import main as train

    _, _, vid_path, boxes_path, _ = video_setup
    root = str(tmp_path_factory.mktemp("video_det"))
    with open(boxes_path) as f:
        boxes = {int(k): v for k, v in json.load(f).items()}
    cap = cv2.VideoCapture(vid_path)
    rows, idx = [], 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % 2 == 0:
            path = os.path.join(root, f"f{idx}.png")
            cv2.imwrite(path, cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
            rows.append({"image": path, "boxes": boxes[idx]})
        idx += 1
    cap.release()
    data = os.path.join(root, "faces.jsonl")
    with open(data, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    cfg = {"exp_dir": os.path.join(root, "exp"), "data": data,
           "height": 120, "width": 160, "batch_size": 8,
           "step_per_epoch": 10, "num_epoch": 40, "max_lr": 5e-3,
           "warmup_epoch": 1, "model": {"args": {"channels": 8}}}
    path = os.path.join(root, "det.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    train(["--config", path, "--device", "cpu"])
    return cfg["exp_dir"]


@pytest.fixture(scope="module")
def asd_exp(tmp_path_factory):
    """A seeded JAX TalkNet saved as the JAX ASD trainer's ``asd_state``,
    BatchNorm statistics drawn near 0."""
    from speaker3d_tpu.models.talknet import TalkNetModel
    from speaker3d_tpu.utils.checkpoint import Checkpointer

    root = str(tmp_path_factory.mktemp("asd"))
    init = jax.tree_util.tree_map(np.asarray, jax.jit(TalkNetModel().init)(
        jax.random.PRNGKey(7), np.zeros((1, 8, 13), np.float32),
        np.zeros((1, 2, 112, 112), np.float32)))
    rng = np.random.default_rng(8)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else (
            (0.1 * rng.standard_normal(v.shape)) if k == "mean"
            else rng.random(v.shape) + 0.5).astype(np.float32)
            for k, v in tree.items()}

    Checkpointer(os.path.join(root, "models")).save_checkpoint(1, {
        "asd_state": {"params": init["params"],
                      "batch_stats": draw(init["batch_stats"]),
                      "step": np.asarray(0, np.int32)}})
    return root


def _both(video_setup, tmp_path, extra):  # noqa: F811
    _, wav_path, vid_path, _, exp_dir = video_setup
    outs = {}
    for name, main, dev in (("jax", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        out_dir = str(tmp_path / name)
        assert main(["--video", vid_path, "--wav", wav_path, "--out_dir",
                     out_dir, "--exp_dir", exp_dir] + extra + dev) == 0
        with open(os.path.join(out_dir, "conv.rttm"), "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    lines = outs["port"].decode().splitlines()
    assert lines
    return lines


def _closing_lines(capsys):
    """The two CLIs' closing lines, without their output paths."""
    return [ln.split(" -> ")[0] for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("conv: ")]


def _speakers(lines):
    return {ln.split()[7] for ln in lines}


@pytest.mark.parametrize("fps", ["10", "5"])
def test_boxes_with_the_energy_scorer(video_setup, tmp_path, capsys,  # noqa: F811
                                      fps):
    boxes_path = video_setup[3]
    lines = _both(video_setup, tmp_path,
                  ["--face_boxes_json", boxes_path, "--fps", fps])
    assert len(_speakers(lines)) == 2, lines
    printed = _closing_lines(capsys)
    assert len(printed) == 2 and printed[0] == printed[1]
    assert "face tracks" in printed[0]


def test_trained_detector_read_by_both(video_setup, detector_exp,  # noqa: F811
                                       tmp_path, capsys):
    lines = _both(video_setup, tmp_path,
                  ["--face_detector_exp_dir", detector_exp, "--fps", "10"])
    printed = _closing_lines(capsys)
    assert len(printed) == 2 and printed[0] == printed[1]
    # the detector finds the faces: tracks reach the joint clustering
    assert " 0 face tracks" not in printed[0], printed
    assert len(_speakers(lines)) == 2, lines


def test_talknet_asd_experiment(video_setup, asd_exp, tmp_path):  # noqa: F811
    boxes_path = video_setup[3]
    lines = _both(video_setup, tmp_path,
                  ["--face_boxes_json", boxes_path, "--fps", "5",
                   "--asd_exp_dir", asd_exp])
    assert len(_speakers(lines)) == 2, lines


def test_no_detector_is_refused_alike(video_setup, tmp_path):  # noqa: F811
    _, wav_path, vid_path, _, exp_dir = video_setup
    argv = ["--video", vid_path, "--wav", wav_path, "--out_dir",
            str(tmp_path), "--exp_dir", exp_dir]
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(RuntimeError, match="no face detector: pass "
                           "--face_detector_exp_dir"):
            main(argv + extra)
