"""The port's multi-crop SSL datasets and loader (data/dataset_ssl.py)
against the JAX package's: with Python's ``random`` and ``np.random``
seeded alike, ``RDINODataset`` (augmented globals and locals) and
``SDPNDataset`` (clean globals, augmented locals) give byte-equal items,
and ``SSLBatchLoader`` at one worker gives byte-equal batches in the same
order and layout, over seeded speech, noise files laid out as MUSAN's
(``.../<noise|speech|music>/<a>/<b>/<file>``, the category the fourth
path component from the end) and a seeded RIR bank.
"""

import random

import numpy as np
import pytest

from speaker3d_tpu.data import dataset_ssl as jds
from speaker3d_tpu_torch.data import dataset_ssl as pds
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000
MAX_FRAMES = 50       # 0.5 s globals, 0.25 s locals


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl_data")
    rng = np.random.default_rng(50)
    scp = root / "train.scp"
    with open(scp, "w") as f:
        for i in range(6):
            n = int(FS * rng.uniform(0.6, 1.5))
            path = root / f"u{i}.wav"
            write_wav(str(path), (0.2 * rng.standard_normal(n)).astype(
                np.float32), FS)
            f.write(f"u{i} {path}\n")
    noise = root / "noise.scp"
    with open(noise, "w") as f:
        for j, cat in enumerate(["noise", "speech", "music", "noise"]):
            folder = root / "musan" / cat / "a" / "b"
            folder.mkdir(parents=True, exist_ok=True)
            path = folder / f"n{j}.wav"
            n = int(FS * rng.uniform(0.2, 1.0))
            write_wav(str(path), (0.1 * rng.standard_normal(n)).astype(
                np.float32), FS)
            f.write(f"n{j} {path}\n")
    rir = root / "rir.npy"
    np.save(rir, (rng.standard_normal((4, 320)) * np.exp(
        -np.arange(320) / 40.0)).astype(np.float32))
    return {"data": str(scp), "noise": str(noise), "rir_bank": str(rir)}


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def test_noise_categories_come_from_the_path(corpus):
    ds = pds.RDINODataset(corpus["data"], noise=corpus["noise"],
                          rir_bank=corpus["rir_bank"], max_frames=MAX_FRAMES)
    assert sorted(ds.noise) == ["music", "noise", "speech"]
    assert len(ds.noise["noise"]) == 2


@pytest.mark.parametrize("name,glb", [("RDINODataset", 2),
                                      ("SDPNDataset", 1)])
def test_items_are_byte_equal(corpus, name, glb):
    kw = dict(noise=corpus["noise"], rir_bank=corpus["rir_bank"],
              max_frames=MAX_FRAMES, glb_num=glb, local_num=4)
    want_ds = getattr(jds, name)(corpus["data"], **kw)
    got_ds = getattr(pds, name)(corpus["data"], **kw)
    for seed in (0, 1, 2):
        _seed(seed)
        want = [want_ds[i] for i in range(len(want_ds))]
        _seed(seed)
        got = [got_ds[i] for i in range(len(got_ds))]
        for w, g in zip(want, got):
            assert sorted(g) == sorted(w) == ["global_wavs", "local_wavs"]
            for key in w:
                assert g[key].dtype == w[key].dtype == np.float32
                assert g[key].shape == w[key].shape
                assert g[key].tobytes() == w[key].tobytes(), (seed, key)
        assert want[0]["global_wavs"].shape == (glb, MAX_FRAMES * 160)
        assert want[0]["local_wavs"].shape == (4, MAX_FRAMES * 80)


def test_loader_batches_are_byte_equal_at_one_worker(corpus):
    kw = dict(noise=corpus["noise"], rir_bank=corpus["rir_bank"],
              max_frames=MAX_FRAMES)
    loaders = [mod.SSLBatchLoader(mod.RDINODataset(corpus["data"], **kw),
                                  batch_size=2, num_workers=1, seed=9)
               for mod in (jds, pds)]
    assert len(loaders[0]) == len(loaders[1]) == 3
    for epoch in (0, 1):
        runs = []
        for loader in loaders:
            loader.set_epoch(epoch)
            _seed(100 + epoch)
            runs.append(list(loader))
        want, got = runs
        assert len(got) == len(want) == 3
        for w, g in zip(want, got):
            assert g["global_wavs"].shape == (2, 2, MAX_FRAMES * 160)
            assert g["local_wavs"].shape == (2, 4, MAX_FRAMES * 80)
            for key in w:
                assert g[key].tobytes() == w[key].tobytes()


def test_loader_raises_the_datasets_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"unreadable item {i}")

    with pytest.raises(OSError, match="unreadable"):
        list(pds.SSLBatchLoader(Broken(), batch_size=2, num_workers=1))
