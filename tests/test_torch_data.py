"""Port parity: config (field names, defaults, overrides), synthetic data,
the split, the loader's order and padding, and the mask store, against the
JAX package. All exact."""

import dataclasses

import numpy as np
import pytest

from weaklysuperviseddl_tpu import config as jcfg
from weaklysuperviseddl_tpu.cli import _apply_overrides as jax_overrides
from weaklysuperviseddl_tpu.data.dataset import download_data as jax_download
from weaklysuperviseddl_tpu.data.dataset import load_split_data as jax_split
from weaklysuperviseddl_tpu.data.loader import batches as jax_batches
from weaklysuperviseddl_tpu.data.loader import stack_dataset as jax_stack
from weaklysuperviseddl_tpu.data.synthetic import synthetic_pet_arrays as jax_synthetic
from weaklysuperviseddl_tpu_torch import config as tcfg
from weaklysuperviseddl_tpu_torch.data.dataset import download_data, load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import batches, stack_dataset
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays

CONFIG_CLASSES = ["DataConfig", "ClassifierConfig", "CamConfig", "MaskConfig", "SegConfig",
                  "RefineConfig", "AlternatingConfig", "MeshConfig", "ExperimentConfig"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_equal(name):
    """Same field names, in the same order, with the same defaults."""
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())


def test_smoke_config_and_overrides_equal():
    assert dataclasses.asdict(tcfg.smoke_config()) == dataclasses.asdict(jcfg.smoke_config())
    overrides = {"data.image_size": "96", "seg.epochs": "3", "alternating.refine.num_steps": "7",
                 "alternating.refine.use_pallas": "false", "mask.store_dir": "/x",
                 "classifier.lr": "0.5"}
    got = tcfg.apply_overrides(tcfg.ExperimentConfig(), overrides)
    want = jax_overrides(jcfg.ExperimentConfig(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.alternating.refine.num_steps == 7 and got.alternating.refine.use_pallas is False


@pytest.mark.parametrize("n,size,classes,seed", [(5, 32, 37, 0), (3, 48, 5, 10_000)])
def test_synthetic_arrays_byte_identical(n, size, classes, seed):
    for got, want in zip(synthetic_pet_arrays(n, size, classes, seed),
                         jax_synthetic(n, size, classes, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_split_batches_and_stack_equal():
    kw = dict(train_ratio=0.8, seed=3, synthetic_size=11, image_size=32, num_classes=37)
    (tr, va), (jtr, jva) = load_split_data(None, **kw), jax_split(None, **kw)
    for got, want in ((tr, jtr), (va, jva)):
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(np.stack(got.images), np.stack(want.images))
    for kwargs in (dict(batch_size=4, shuffle=True, seed=3, pad_to_full=True),
                   dict(batch_size=3), dict(batch_size=4, shuffle=True, seed=1)):
        got, want = list(batches(tr, **kwargs)), list(jax_batches(jtr, **kwargs))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.num_valid == w.num_valid
            for field in ("image", "label", "trimap"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    test = download_data(None, split="test", synthetic_size=16, image_size=32)
    jtest = jax_download(None, split="test", synthetic_size=16, image_size=32)
    for got, want in zip(stack_dataset(test), jax_stack(jtest)):
        np.testing.assert_array_equal(got, want)


def test_mask_store_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    store = MaskStore(directory=str(tmp_path))
    masks = rng.integers(0, 2, (3, 8, 9)).astype(np.uint8)
    images = rng.integers(0, 256, (3, 8, 9, 3)).astype(np.uint8)
    for i in (2, 0, 1):
        store.put(f"{i:05d}", images[i], masks[i])
    store.update_mask("00001", 1 - masks[1])
    loaded = MaskStore.load(str(tmp_path))
    got_images, got_masks, keys = loaded.as_arrays()
    assert keys == ["00000", "00001", "00002"] == store.keys()
    want_masks = masks.copy()
    want_masks[1] = 1 - masks[1]
    np.testing.assert_array_equal(got_masks, want_masks)
    np.testing.assert_array_equal(got_images, images)
    mem_images, mem_masks, _ = store.as_arrays()
    np.testing.assert_array_equal(mem_masks, want_masks)
    np.testing.assert_array_equal(mem_images, images)
