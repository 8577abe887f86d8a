"""The rest of the pseudo-mask stage against the JAX package: the host-spilling
CAM extraction (``extract_cams(spill_to_host=True)``) and the streaming mask
derivation, the native asynchronous PNG store and its ``flush`` barrier,
``prefetch`` and ``download_data(limit=)``."""

import os
import re
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_classifier import jax_classifier_numpy, port_classifier
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu import native as jax_native
from weaklysuperviseddl_tpu.data.dataset import download_data as jax_download
from weaklysuperviseddl_tpu.data.loader import batches as jax_batches
from weaklysuperviseddl_tpu.data.loader import prefetch as jax_prefetch
from weaklysuperviseddl_tpu.masks.pseudo import extract_cams as jax_extract_cams
from weaklysuperviseddl_tpu.masks.pseudo import masks_from_cams as jax_masks_from_cams
from weaklysuperviseddl_tpu_torch import native
from weaklysuperviseddl_tpu_torch.data import mask_store
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.data.loader import batches, prefetch
from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
from weaklysuperviseddl_tpu_torch.masks.pseudo import extract_cams, masks_from_cams

pytestmark = pytest.mark.usefixtures("single_torch_thread")

SIZE = 64
CRF = dict(gauss_sxy=1.0, gauss_compat=2.0, bilat_sxy=50.0, bilat_srgb=5.0, bilat_compat=10.0,
           n_iters=5, bilat_backend="lattice")


@pytest.fixture(scope="module")
def classifiers():
    model, variables = jax_classifier_numpy()
    return model, variables, port_classifier(variables)


@pytest.fixture(scope="module")
def extracted(classifiers):
    """9 synthetic pets at 64² in batches of 4 (3 batches, the last padded):
    the port's resident and spilled (windows of 2 batches) extractions."""
    _, _, port = classifiers
    ds = download_data(None, synthetic_size=9, image_size=SIZE)
    kw = dict(image_size=SIZE, max_images=None)
    resident = extract_cams(batches(ds, 4, pad_to_full=True), port, **kw)
    spilled = extract_cams(batches(ds, 4, pad_to_full=True), port, spill_to_host=True,
                           batches_per_dispatch=2, **kw)
    return resident, spilled


def test_spilled_cams_are_bit_equal_to_resident(extracted):
    resident, spilled = extracted
    assert resident.on_device and not spilled.on_device
    assert isinstance(spilled.cams, np.ndarray) and spilled.device == torch.device("cpu")
    assert len(spilled) == len(resident) == 9
    np.testing.assert_array_equal(spilled.cams, resident.cams.numpy())
    np.testing.assert_array_equal(spilled.store_images, resident.store_images.numpy())
    np.testing.assert_array_equal(spilled.images_raw, resident.images_raw.numpy())
    assert spilled.resident_bytes() == 0
    assert resident.resident_bytes() == 9 * (SIZE * SIZE * 3 + SIZE * SIZE * 4 + SIZE * SIZE * 3)


@pytest.mark.parametrize("use_crf", [False, True])
def test_spilled_masks_are_bit_equal_to_resident(extracted, use_crf):
    """Without and with the CRF (the lattice, which needs the raw images
    streamed too), in the default order and in a shuffled, capped one."""
    resident, spilled = extracted
    order = np.random.default_rng(1).permutation(9)
    for kw in (dict(), dict(order=order, max_images=7)):
        want = masks_from_cams(resident, use_crf=use_crf, crf_kwargs=CRF, **kw).as_arrays()
        got = masks_from_cams(spilled, use_crf=use_crf, crf_kwargs=CRF, **kw).as_arrays()
        assert got[2] == want[2] and len(got[2]) == kw.get("max_images", 9)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert 0.02 < got[1].mean() < 0.98


def test_spill_path_agrees_with_jax(classifiers, extracted):
    """JAX's own spill path (windows of 2 batches) on the same weights: CAMs
    within LayerCAM's parity tolerance (test_torch_cam.py), masks >= 0.99
    equal, store images within one grey level."""
    model, variables, _ = classifiers
    _, spilled = extracted
    jds = jax_download(None, synthetic_size=9, image_size=SIZE)
    want = jax_extract_cams(jax_batches(jds, 4, pad_to_full=True), model, variables,
                            image_size=SIZE, max_images=None, spill_to_host=True,
                            batches_per_dispatch=2)
    assert not want.on_device and want.resident_bytes() == 0
    np.testing.assert_allclose(spilled.cams, want.cams, atol=2e-3)
    assert np.abs(spilled.store_images.astype(int) - want.store_images.astype(int)).max() <= 1
    w_masks = jax_masks_from_cams(want).as_arrays()[1]
    g_masks = masks_from_cams(spilled).as_arrays()[1]
    assert (g_masks == w_masks).mean() >= 0.99


def test_masks_from_cams_flushes_its_store(extracted, tmp_path, monkeypatch):
    """The stage's durability barrier: the store is flushed once before
    masks_from_cams returns, and every PNG is then whole on disk."""
    resident, _ = extracted
    calls = []
    flush = MaskStore.flush
    monkeypatch.setattr(MaskStore, "flush", lambda self: (calls.append(self), flush(self)))
    store = masks_from_cams(resident, store_dir=str(tmp_path))
    assert store.writer == "native" and calls == [store]
    images, masks, keys = store.as_arrays()
    for i, key in enumerate(keys):
        on_disk = np.asarray(Image.open(tmp_path / "pseudo_masks" / f"{key}.png"))
        np.testing.assert_array_equal(on_disk, masks[i] * 255)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "images" / f"{key}.png")),
                                      images[i])
    loaded = MaskStore.load(str(tmp_path))
    np.testing.assert_array_equal(loaded.as_arrays()[1], masks)


def _png_cases():
    rng = np.random.default_rng(0)
    return {"mask": (rng.uniform(size=(64, 64)) > 0.5).astype(np.uint8) * 255,
            "rgb": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
            "gray_1": rng.integers(0, 256, (13, 7, 1), dtype=np.uint8)}


def test_native_png_bytes_equal_jax(tmp_path):
    """The port's writer, synchronous and queued, writes the JAX package's
    native writer's bytes, which PIL decodes to the same pixels."""
    for name, arr in _png_cases().items():
        want, sync, queued = (str(tmp_path / f"{name}_{w}.png") for w in ("jax", "sync", "async"))
        jax_native.png_write(want, arr)
        native.png_write(sync, arr)
        native.png_write_async(queued, arr)
        native.io_flush()
        want_bytes = open(want, "rb").read()
        assert open(sync, "rb").read() == want_bytes
        assert open(queued, "rb").read() == want_bytes
        np.testing.assert_array_equal(np.asarray(Image.open(sync)), arr.reshape(arr.shape[:2])
                                      if arr.ndim == 3 and arr.shape[2] == 1 else arr)
    with pytest.raises(ValueError, match="expected"):
        native.png_write(sync, np.zeros((4, 4, 2), np.uint8))


def test_flush_raises_naming_the_path_it_could_not_write(tmp_path):
    store = MaskStore(str(tmp_path))
    store.put("00000", np.zeros((8, 8, 3), np.uint8), np.eye(8, dtype=np.uint8))
    store.flush()
    shutil.rmtree(store.mask_dir)
    store.put("00001", None, np.eye(8, dtype=np.uint8))
    with pytest.raises(OSError, match=re.escape(os.path.join(store.mask_dir, "00001.png"))):
        store.flush()
    store.flush()  # the failure was reported once; nothing is queued now
    assert native.io_flush_report() == (0, [])


def test_store_falls_back_to_pil_visibly(tmp_path, monkeypatch):
    """Where the writer cannot be built the store writes with PIL and says
    so; the files read back the same."""
    def no_compiler():
        raise RuntimeError("g++ failed on wsdl_io.cpp")

    monkeypatch.setattr(native, "load", no_compiler)
    store = MaskStore(str(tmp_path))
    assert store.writer == "pil" and mask_store.native_error() == "g++ failed on wsdl_io.cpp"
    mask = np.eye(8, dtype=np.uint8)
    store.put("00000", np.full((8, 8, 3), 9, np.uint8), mask)
    store.flush()
    got_image, got_mask = MaskStore.load(str(tmp_path)).get("00000")
    np.testing.assert_array_equal(got_mask, mask)
    assert (got_image == 9).all()
    assert MaskStore(None).writer is None


# JAX's producer thread dies of the exception, which pytest reports
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefetch_keeps_order_and_reraises():
    """Order is kept with a slow consumer and a queue of 1; an exception in
    the iterator reaches the consumer after the items before it, where JAX's
    prefetch ends the stream silently."""
    got = []
    for item in prefetch(iter(range(20)), size=1):
        got.append(item)
        time.sleep(0.001)
    assert got == list(range(20))

    def failing():
        yield from range(3)
        raise KeyError("decode failed")

    seen = []
    with pytest.raises(KeyError, match="decode failed"):
        for item in prefetch(failing()):
            seen.append(item)
    assert seen == [0, 1, 2]
    assert list(jax_prefetch(failing())) == [0, 1, 2]  # JAX: no exception
    early = prefetch(iter(range(1000)), size=2)
    assert next(early) == 0
    early.close()  # stops the producer thread


@pytest.fixture
def pet_root(tmp_path):
    """A Pet-layout directory: 3 ragged JPEGs with PNG trimaps, a list file
    with a comment line."""
    root = tmp_path / "pet"
    (root / "images").mkdir(parents=True)
    (root / "annotations" / "trimaps").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = ["# Image CLASS-ID SPECIES BREED ID"]
    for i, (name, cls) in enumerate([("Abyssinian_1", 1), ("beagle_7", 2), ("beagle_9", 2)]):
        h, w = 40 + 7 * i, 50 + 3 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            root / "images" / f"{name}.jpg")
        Image.fromarray(rng.integers(1, 4, (h, w)).astype(np.uint8)).save(
            root / "annotations" / "trimaps" / f"{name}.png")
        lines.append(f"{name} {cls} 1 1")
    (root / "annotations" / "trainval.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("limit", [None, 2, 10])
def test_download_data_limit_matches_jax(pet_root, limit):
    got = download_data(pet_root, limit=limit)
    want = jax_download(pet_root, limit=limit)
    assert len(got) == len(want) == (3 if limit is None else min(limit, 3))
    np.testing.assert_array_equal(got.labels, want.labels)
    for a, b in zip(got.images + got.trimaps, want.images + want.trimaps):
        np.testing.assert_array_equal(a, b)
    syn = download_data(None, synthetic_size=8, image_size=32, limit=limit)
    jsyn = jax_download(None, synthetic_size=8, image_size=32, limit=limit)
    assert len(syn) == len(jsyn) == (8 if limit is None else min(limit, 8))
    np.testing.assert_array_equal(np.stack(syn.images), np.stack(jsyn.images))
    np.testing.assert_array_equal(syn.labels, jsyn.labels)
    assert jnp.asarray(syn.labels).shape == (len(syn),)
