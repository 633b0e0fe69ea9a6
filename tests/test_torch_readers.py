"""The PyTorch port's dataset readers vs the JAX package's, on the CPU.

Fixtures are written with the JAX package's TFRecord encoders, PIL JPEGs
and a small OpenCV AVI, from seeded numpy: a GQN ``mazes`` set (84x84
JPEG frames, resized to the model's frame), a BAIR ``softmotion30_44k``
set (raw 64x64x3 frames), KTH class folders of AVIs, Penn Action folders
of JPEGs and a flat-float ``animation`` set.  Each loader of the port
(``GqnReader`` with its shuffle, interleave and threaded decode,
``robot_push_samples``, ``kth_samples``, ``penn_samples``,
``flat_feature_samples``) yields the JAX loader's first samples to the
bit at the same seed, and ``make_dataset`` JAX's first batches and test
batch (tolerance 0).  The TFRecord loaders run under both IO backends.
Shapes are tiny; no JAX function is compiled.
"""

import itertools
import os
from io import BytesIO

import numpy as np
import pytest

from kccotgan_tpu.config import ModelConfig, TrainConfig
from kccotgan_tpu.data import bair as jax_bair
from kccotgan_tpu.data import datasets as jax_datasets
from kccotgan_tpu.data import generic as jax_generic
from kccotgan_tpu.data import gqn as jax_gqn
from kccotgan_tpu.data import kth as jax_kth
from kccotgan_tpu.data import penn as jax_penn
from kccotgan_tpu.data.tfrecord import encode_example, encode_sequence_example, write_tfrecord
from kccotgan_tpu_torch.data import bair, datasets, generic, gqn, io, kth, native_io, penn
from tests._torch_port import port_cfg

T, HW = 4, 16


@pytest.fixture(params=["python", "native"])
def backend(request, monkeypatch):
    """The port's IO backend for the test (JAX's reader is its own); the
    native one skips where no C++ compiler is on PATH."""
    if request.param == "python":
        monkeypatch.setenv("KCCOT_FORCE_PY_IO", "1")
    else:
        if not native_io.available():
            pytest.skip("no C++ compiler on PATH")
        monkeypatch.delenv("KCCOT_FORCE_PY_IO", raising=False)
    assert io.backend() == request.param
    return request.param


def assert_same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def first(it, n):
    return list(itertools.islice(it, n))


def jpeg(frame):
    from PIL import Image

    buf = BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def write_mazes(root, n_files=3, per_file=5, frames=6, seed=0):
    """GQN mazes train shards ``0001-of-1080.tfrecord`` ... of 84x84 JPEG
    frames, and the ``np_mazes_test.npy`` batch with an alpha channel."""
    rng = np.random.default_rng(seed)
    info = jax_gqn.GQN_DATASETS["mazes"]
    for path in jax_gqn.gqn_record_files(info, "train", str(root))[:n_files]:
        recs = [
            encode_example({
                "frames": [jpeg(rng.integers(0, 256, (84, 84, 3), dtype=np.uint8)) for _ in range(frames)],
                "cameras": rng.normal(size=5 * frames).astype(np.float32).tolist(),
            })
            for _ in range(per_file)
        ]
        write_tfrecord(path, recs)
    np.save(root / "mazes" / "np_mazes_test.npy", rng.uniform(size=(3, HW, 6, HW, 4)).astype(np.float32))


def write_bair(root, n_train=5, n_test=3, seed=0):
    """BAIR ``softmotion30_44k/{train,test}/`` shards of SequenceExamples,
    30 raw 64x64x3 frames each; one record without its frames, skipped."""
    rng = np.random.default_rng(seed)
    base = root / "softmotion30_44k"

    def video():
        frames = rng.integers(0, 256, (30, 64, 64, 3), dtype=np.uint8)
        return encode_sequence_example({f"{i}/image_aux1/encoded": [frames[i].tobytes()] for i in range(30)})

    recs = [video() for _ in range(n_train)]
    write_tfrecord(str(base / "train" / "shard_b.tfrecord"), recs[2:])
    write_tfrecord(str(base / "train" / "shard_a.tfrecord"), recs[:2] + [encode_sequence_example({"x": [1]})])
    write_tfrecord(str(base / "test" / "shard_0.tfrecord"), [video() for _ in range(n_test)])
    return base


def write_kth(root, seed=0):
    """Two KTH class folders (a fast class and a slow one) of 24x24 AVIs."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    for cls, n_frames in (("walking", 20), ("boxing", 24)):
        d = root / cls
        d.mkdir(parents=True)
        for v in range(2):
            path = d / f"person0{v}_{cls}_d1.avi"
            w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (24, 24))
            if not w.isOpened():
                pytest.skip("cv2 VideoWriter lacks codec support in this image")
            for _ in range(n_frames):
                w.write(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8))
            w.release()


def write_penn(root, seed=0):
    """Penn Action folders of numbered JPEGs: one long enough for stride 2,
    one short (every frame); frames larger and smaller than the crop."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for name, n, (h, w) in (("0001", 2 * T + 3, (HW + 4, HW + 6)), ("0002", T + 1, (HW - 2, HW + 2))):
        d = root / name
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{i:06d}.jpg")


def write_animation(root, n_files=2, per_file=3, seed=0):
    """Flat-float ``animation`` shards: ``x`` of H*W*T*C floats, plus one
    record of the wrong size, skipped."""
    rng = np.random.default_rng(seed)
    for f in range(n_files):
        recs = [encode_example({"x": rng.uniform(size=HW * HW * T * 3).astype(np.float32).tolist()})
                for _ in range(per_file)]
        write_tfrecord(str(root / f"part{f}.tfrecord"), recs + [encode_example({"x": [0.5, 0.25]})])


@pytest.mark.parametrize("decode_workers,cycle,block", [(0, 2, 3), (2, 4, 16)])
def test_gqn_reader_equal_jax(tmp_path, backend, decode_workers, cycle, block):
    pytest.importorskip("PIL")
    write_mazes(tmp_path)
    kw = dict(custom_frame_size=HW, seed=3, cycle_length=cycle, block_length=block, shuffle_buffer=4,
              decode_workers=decode_workers)
    got = gqn.GqnReader("mazes", T, str(tmp_path), **kw)
    want = jax_gqn.GqnReader("mazes", T, str(tmp_path), **kw)
    assert got.files() == want.files()
    samples = first(got.samples(), 20)
    assert samples[0].shape == (HW, T, HW, 3)
    assert_same(samples, first(want.samples(), 20))


def test_gqn_reader_full_size_and_registry(tmp_path):
    """No resize at the dataset's own frame size; the registry, the file
    names and the refusals are JAX's."""
    pytest.importorskip("PIL")
    write_mazes(tmp_path, n_files=1, per_file=2)
    assert gqn.GQN_DATASETS == {k: gqn.GqnDatasetInfo(**vars(v)) for k, v in jax_gqn.GQN_DATASETS.items()}
    info = gqn.GQN_DATASETS["rooms_ring_camera"]
    assert gqn.gqn_record_files(info, "test", "/r") == jax_gqn.gqn_record_files(
        jax_gqn.GQN_DATASETS["rooms_ring_camera"], "test", "/r")
    kw = dict(seed=1, shuffle_files=False, decode_workers=0)
    got = first(gqn.GqnReader("mazes", T, str(tmp_path), **kw).samples(), 3)
    assert got[0].shape == (84, T, 84, 3)
    assert_same(got, first(jax_gqn.GqnReader("mazes", T, str(tmp_path), **kw).samples(), 3))
    assert gqn.GqnReader("mazes", T, str(tmp_path)).decode_workers == jax_gqn.GqnReader(
        "mazes", T, str(tmp_path)).decode_workers
    with pytest.raises(ValueError, match="unknown GQN dataset"):
        gqn.GqnReader("nope", T, str(tmp_path))
    with pytest.raises(ValueError, match="exceeds"):
        gqn.GqnReader("jaco", 12, str(tmp_path))


@pytest.mark.parametrize("train", [True, False])
def test_robot_push_samples_equal_jax(tmp_path, backend, train):
    base = write_bair(tmp_path)
    got = list(bair.robot_push_samples(str(base), 15, train=train))
    assert len(got) == (5 if train else 3) and got[0].shape == (64, 15, 64, 3)
    assert_same(got, jax_bair.robot_push_samples(str(base), 15, train=train))


def test_flat_feature_samples_equal_jax(tmp_path, backend):
    write_animation(tmp_path)
    pattern = str(tmp_path / "*.tfrecord")
    got = first(generic.flat_feature_samples(pattern, HW, HW, T, 3, seed=2), 14)  # past two passes
    assert got[0].shape == (HW, T, HW, 3)
    assert_same(got, first(jax_generic.flat_feature_samples(pattern, HW, HW, T, 3, seed=2), 14))


def test_kth_samples_equal_jax(tmp_path):
    write_kth(tmp_path)
    got = list(kth.kth_samples(str(tmp_path), 5, HW, HW, T, seed=1))
    assert got[0].shape == (HW, T, HW, 3)
    assert_same(got, jax_kth.kth_samples(str(tmp_path), 5, HW, HW, T, seed=1))


@pytest.mark.parametrize("crop", [True, False])
def test_penn_samples_equal_jax(tmp_path, crop):
    pytest.importorskip("PIL")
    write_penn(tmp_path)
    got = list(penn.penn_samples(str(tmp_path), 5, HW, HW, T, crop=crop, seed=4))
    want = list(jax_penn.penn_samples(str(tmp_path), 5, HW, HW, T, crop=crop, seed=4))
    if crop:
        assert got[0].shape == (HW, T, HW, 3)
        assert_same(got, want)
    else:  # frames of two sizes: each sample alone
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert_same([g], [w])


def tiny_cfg(dname, data_path, **kw):
    return TrainConfig(
        dname=dname, data_path=str(data_path), batch_size=2, total_time_steps=T, int_time_steps=2,
        n_epochs=2, seed=5, model=ModelConfig(x_height=HW, x_width=HW, n_channels=3), **kw,
    )


def assert_make_dataset_equal(cfg, n_batches=None):
    got_it, got_test = datasets.make_dataset(port_cfg(cfg))
    want_it, want_test = jax_datasets.make_dataset(cfg)
    if want_test is None:
        assert got_test is None
    else:
        assert_same([got_test], [want_test])
    if n_batches is not None:
        got_it, want_it = first(got_it, n_batches), first(want_it, n_batches)
    assert_same(got_it, want_it)
    return got_test


def test_make_dataset_mazes_equal_jax(tmp_path):
    pytest.importorskip("PIL")
    write_mazes(tmp_path)
    test = assert_make_dataset_equal(tiny_cfg("mazes", tmp_path), n_batches=3)
    assert test.shape == (2, HW, T, HW, 3)  # the alpha channel dropped


@pytest.mark.parametrize("with_test", [True, False])
def test_make_dataset_robot_push_equal_jax(tmp_path, backend, with_test):
    base = write_bair(tmp_path)
    if not with_test:
        os.remove(base / "test" / "shard_0.tfrecord")
    test = assert_make_dataset_equal(tiny_cfg("robot_push", tmp_path))
    assert (test is not None) == with_test


@pytest.mark.parametrize("with_test", [True, False])
def test_make_dataset_kth_equal_jax(tmp_path, with_test):
    write_kth(tmp_path / "kth")
    if with_test:
        write_kth(tmp_path / "kth_test", seed=1)
    test = assert_make_dataset_equal(tiny_cfg("kth", tmp_path))
    assert (test is not None) == with_test


@pytest.mark.parametrize("split", ["test_dir", "train_fallback", "short_test_dir"])
def test_make_dataset_penn_action_equal_jax(tmp_path, split, caplog):
    """A held-out ``penn_frames_test/``, the in-distribution fallback on
    the train folder, and a test split too short for a batch (None, with
    ``_collect_batch``'s warning)."""
    pytest.importorskip("PIL")
    write_penn(tmp_path / "penn_frames")
    if split == "test_dir":
        write_penn(tmp_path / "penn_frames_test", seed=1)
    if split == "short_test_dir":
        (tmp_path / "penn_frames_test" / "0001").mkdir(parents=True)
    with caplog.at_level("WARNING"):
        test = assert_make_dataset_equal(tiny_cfg("penn_action", tmp_path))
    assert (test is None) == (split == "short_test_dir")
    if split == "short_test_dir":
        warned = [r for r in caplog.records if "yielded only 0 of the 2 samples" in r.getMessage()]
        assert {r.name for r in warned} == {"kccotgan_tpu.data.datasets", "kccotgan_tpu_torch.data.datasets"}


@pytest.mark.parametrize("dname", ["animation", "ucf"])
def test_make_dataset_flat_feature_equal_jax(tmp_path, backend, dname):
    write_animation(tmp_path / dname)
    assert_make_dataset_equal(tiny_cfg(dname, tmp_path), n_batches=3)
