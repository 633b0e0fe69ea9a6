"""The PyTorch port's data layer vs the JAX package's, on the CPU.

The port keeps its own numpy copies of the fixtures, the MMNIST loader
and the iterator combinators (the JAX package's ``data`` imports JAX);
these tests hold them equal to the JAX package's to the bit, item by
item and in order, for the same seeds, and ``make_dataset`` to JAX's
batches and test batch for the same configuration.  No JAX function is
compiled.
"""

import numpy as np
import pytest

from kccotgan_tpu.config import ModelConfig, TrainConfig
from kccotgan_tpu.data import datasets as jax_datasets
from kccotgan_tpu.data import mmnist as jax_mmnist
from kccotgan_tpu.data import pipeline as jax_pipeline
from kccotgan_tpu.data import synthetic as jax_synthetic
from kccotgan_tpu_torch.data import datasets, mmnist, pipeline, synthetic
from tests._torch_port import port_cfg


def assert_same_items(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("args", [
    dict(num_videos=3, time_steps=5, height=16, width=16, seed=0),
    dict(num_videos=2, time_steps=4, height=20, width=24, channels=3, seed=7),
    dict(num_videos=2, time_steps=30, height=24, width=24, num_blobs=3, blob_radius=4, seed=11),
])
def test_bouncing_blobs_equal_jax(args):
    got, want = synthetic.bouncing_blobs(**args), jax_synthetic.bouncing_blobs(**args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mmap", [True, False])
def test_mmnist_fixture_and_loader_equal_jax(tmp_path, mmap):
    ours, theirs = str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")
    synthetic.write_mmnist_fixture(ours, num_videos=3, time_steps=6, seed=2)
    jax_synthetic.write_mmnist_fixture(theirs, num_videos=3, time_steps=6, seed=2)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got = mmnist.load_mmnist(ours, 5, mmap=mmap)
    assert got.shape == (3, 64, 5, 64, 1)
    np.testing.assert_array_equal(got, jax_mmnist.load_mmnist(theirs, 5, mmap=mmap))
    assert mmnist.mmnist_paths("/data") == jax_mmnist.mmnist_paths("/data")


@pytest.mark.parametrize("batch_size,shuffle", [(2, True), (3, False)])
def test_array_dataset_equal_jax(batch_size, shuffle):
    data = np.random.default_rng(0).uniform(size=(7, 2, 3, 2, 1)).astype(np.float32)
    got = pipeline.ArrayDataset(data, batch_size, seed=4)
    want = jax_pipeline.ArrayDataset(data, batch_size, seed=4)
    assert len(got) == len(want)
    assert_same_items(got.repeat(3, shuffle=shuffle), want.repeat(3, shuffle=shuffle))


@pytest.mark.parametrize("shuffle,seed", [(True, 5), (False, None)])
def test_generator_dataset_equal_jax(shuffle, seed):
    def samples():
        return (np.full((2, 2), i, np.float64) for i in range(23))

    got = pipeline.GeneratorDataset(samples, 4, shuffle_buffer=6, seed=seed)
    want = jax_pipeline.GeneratorDataset(samples, 4, shuffle_buffer=6, seed=seed)
    assert_same_items(got.repeat(2, shuffle=shuffle), want.repeat(2, shuffle=shuffle))


@pytest.mark.parametrize("buffer_size", [1, 8, 100])
def test_shuffle_stream_equal_jax(buffer_size):
    got = list(pipeline.shuffle_stream(range(50), buffer_size, seed=3))
    assert got == list(jax_pipeline.shuffle_stream(range(50), buffer_size, seed=3))
    assert sorted(got) == list(range(50))


def test_interleave_equal_jax():
    def inner(i):
        return range(10 * i, 10 * i + 2 + i)

    got = list(pipeline.interleave(range(5), inner, cycle_length=3, block_length=2))
    assert got == list(jax_pipeline.interleave(range(5), inner, cycle_length=3, block_length=2))


@pytest.mark.parametrize("workers", [0, 3])
def test_parallel_map_equal_jax(workers):
    got = list(pipeline.parallel_map(lambda x: x * x, range(20), workers=workers, prefetch=4))
    assert got == list(jax_pipeline.parallel_map(lambda x: x * x, range(20), workers=workers, prefetch=4))


def tiny_cfg(**kw):
    return TrainConfig(
        batch_size=2, total_time_steps=4, int_time_steps=2, n_epochs=2, seed=5,
        model=ModelConfig(x_height=16, x_width=16), **kw,
    )


def test_make_dataset_synthetic_equal_jax():
    cfg = tiny_cfg(dname="synthetic")
    got_it, got_test = datasets.make_dataset(port_cfg(cfg))
    want_it, want_test = jax_datasets.make_dataset(cfg)
    np.testing.assert_array_equal(got_test, want_test)
    assert_same_items(got_it, want_it)


@pytest.mark.parametrize("with_test", [True, False])
def test_make_dataset_mmnist_equal_jax(tmp_path, with_test):
    train_path, test_path = mmnist.mmnist_paths(str(tmp_path))
    (tmp_path / "mmnist").mkdir()
    synthetic.write_mmnist_fixture(train_path, num_videos=5, time_steps=6, seed=0)
    if with_test:
        synthetic.write_mmnist_fixture(test_path, num_videos=3, time_steps=6, seed=1)
    cfg = tiny_cfg(dname="mmnist", data_path=str(tmp_path))
    got_it, got_test = datasets.make_dataset(port_cfg(cfg))
    want_it, want_test = jax_datasets.make_dataset(cfg)
    if with_test:
        assert got_test.shape == (2, 64, 4, 64, 1)
        np.testing.assert_array_equal(got_test, want_test)
    else:
        assert got_test is None and want_test is None
    assert_same_items(got_it, want_it)


@pytest.mark.parametrize("dname", ["mazes", "robot_push", "kth", "penn_action", "ucf"])
def test_make_dataset_names_what_is_not_ported(dname):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        datasets.make_dataset(port_cfg(tiny_cfg(dname=dname)))


def test_cpu_prefetch_yields_float32_tensors():
    batches = [np.ones((2, 3), np.float64), np.zeros((1, 3), np.float32)]
    got = list(pipeline.device_prefetch(iter(batches), device="cpu"))
    assert [tuple(t.shape) for t in got] == [(2, 3), (1, 3)]
    assert all(str(t.dtype) == "torch.float32" and t.device.type == "cpu" for t in got)
