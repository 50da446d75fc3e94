"""Parity of the port's data substrate (``repro_torch.data``) with the JAX
package's, on the CPU.

``digits.py`` is a copy of the reference module, so every function is held
to exact equality: ``make_dataset`` (procedural and from
``REPRO_MNIST_PATH``), the Fig. 8 ``corrupt`` suite in all five kinds and
the image transforms behind it.  ``pipeline.digit_batches``,
``host_shard`` and ``prefetch``, and the train-time ``_augment`` of
``core.train_snn``, are exactly equal too.
"""

import itertools
from pathlib import Path

import numpy as np
import pytest

from repro.core import train_snn as jtrain
from repro.data import digits as jdig
from repro.data import pipeline as jpipe
from repro_torch.core import train_snn as ttrain
from repro_torch.data import digits as tdig
from repro_torch.data import pipeline as tpipe

ROOT = Path(__file__).resolve().parents[1]


def _same_ds(a, b):
    for f in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.n_train == b.n_train


def test_digits_module_is_a_copy_of_the_reference():
    src = ROOT / "src"
    assert (src / "repro_torch/data/digits.py").read_bytes() == \
        (src / "repro/data/digits.py").read_bytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_make_dataset_matches_jax(seed, monkeypatch):
    monkeypatch.delenv("REPRO_MNIST_PATH", raising=False)
    ds = tdig.make_dataset(n_train=30, n_test=12, seed=seed)
    _same_ds(ds, jdig.make_dataset(n_train=30, n_test=12, seed=seed))
    assert ds.x_train.shape == (30, 784) and ds.y_test.shape == (12,)
    assert 0.0 <= ds.x_train.min() and ds.x_train.max() <= 1.0


def test_make_dataset_reads_repro_mnist_path(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.integers(0, 256, (7, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 7).astype(np.uint8),
             x_test=rng.integers(0, 256, (3, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 3).astype(np.uint8))
    monkeypatch.setenv("REPRO_MNIST_PATH", str(path))
    ds = tdig.make_dataset()
    _same_ds(ds, jdig.make_dataset())
    assert ds.x_train.shape == (7, 784) and ds.y_train.dtype == np.int32


@pytest.mark.parametrize("kind", ["clean", "rotation", "shift", "noise",
                                  "occlusion"])
@pytest.mark.parametrize("seed", [0, 5])
def test_corrupt_matches_jax(kind, seed):
    x = np.random.default_rng(seed).random((6, 784)).astype(np.float32)
    got, want = tdig.corrupt(x, kind, seed), jdig.corrupt(x, kind, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tdig.corrupt(x, "blur")


@pytest.mark.parametrize("fn,kw", [
    ("rotate_images", {"degrees": -30.0}), ("shift_images", {"frac": 0.5}),
    ("shift_images", {"frac": 1.0}), ("noise_images", {"sigma": 0.1,
                                                       "seed": 2}),
    ("occlude_images", {"size": 4, "seed": 9})])
def test_image_transforms_match_jax(fn, kw):
    x = np.random.default_rng(7).random((4, 784)).astype(np.float32)
    np.testing.assert_array_equal(getattr(tdig, fn)(x, **kw),
                                  getattr(jdig, fn)(x, **kw))


@pytest.mark.parametrize("batch,epochs", [(8, 2), (7, None), (50, 1)])
def test_digit_batches_match_jax(batch, epochs):
    rng = np.random.default_rng(batch)
    x = rng.random((50, 784)).astype(np.float32)
    y = rng.integers(0, 10, 50).astype(np.int32)
    take = 20 if epochs is None else None
    got = list(itertools.islice(tpipe.digit_batches(x, y, batch, seed=4,
                                                    epochs=epochs), take))
    want = list(itertools.islice(jpipe.digit_batches(x, y, batch, seed=4,
                                                     epochs=epochs), take))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["pixels"], w["pixels"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
def test_host_shard_matches_jax(num_hosts):
    a = np.arange(48).reshape(8, 6)
    for h in range(num_hosts):
        np.testing.assert_array_equal(tpipe.host_shard(a, h, num_hosts),
                                      jpipe.host_shard(a, h, num_hosts))
    with pytest.raises(ValueError):
        tpipe.host_shard(a, 0, 3)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_matches_jax(depth):
    items = [{"i": i, "x": np.full(3, i)} for i in range(9)]
    got = list(tpipe.prefetch(iter(items), depth))
    want = list(jpipe.prefetch(iter(items), depth))
    assert [g["i"] for g in got] == [w["i"] for w in want] == list(range(9))
    assert list(tpipe.prefetch(iter([]), depth)) == []


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_augment_matches_jax(seed):
    x = np.random.default_rng(seed).random((64, 784)).astype(np.float32)
    got = ttrain._augment(x, np.random.default_rng(seed + 1))
    want = jtrain._augment(x, np.random.default_rng(seed + 1))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
