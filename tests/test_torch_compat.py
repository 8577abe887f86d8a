"""Port parity for the reference-named surface (``weaklysuperviseddl_tpu_torch/
compat/``): every entry point against the JAX package's ``compat`` on the
same numpy inputs from a seed, at smoke width (ResNet-18, width 0.25, 32-64²)
with JAX's weights bridged into the port (``models/jax_import.py``). CAMs
within 2e-3, losses within 1e-5, masks equal or, where the CAMs or the
refinement decide near a threshold, > 0.99 of the pixels; the window losses
within 1e-6. Training is compared with dropout the identity on both sides
(JAX's random bits cannot be reproduced) from one initial tree.

Also: the adapters' layout heuristics at their edge shapes, the PNG
directory contract of ``generate_pseudo_masks``, ``device=None`` raising
without a card, and the import boundary (no module of the surface imports
JAX or the JAX package)."""

import ast
import dataclasses
import functools
import os
import pathlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from test_torch_classifier import jax_classifier_numpy
from test_torch_models import jax_deeplab_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_segmentation import _NoDropout

import weaklysuperviseddl_tpu.compat as jax_compat_pkg
import weaklysuperviseddl_tpu.train.alternating as jax_alternating
import weaklysuperviseddl_tpu.train.segmentation as jax_segmentation
from weaklysuperviseddl_tpu.compat import AlternatingDirectionBoundaryLoss as JBL
from weaklysuperviseddl_tpu.compat import AlternatingDirectionCutLoss as JCL
from weaklysuperviseddl_tpu.compat import Abalations as JAbl
from weaklysuperviseddl_tpu.compat import ExtraUtilities as JExtra
from weaklysuperviseddl_tpu.compat import LayerCAM as JLayerCAM
from weaklysuperviseddl_tpu.compat import Lovasz_Softmax_Loss as JL
from weaklysuperviseddl_tpu.compat import PsuedoMasks as JPsuedo
from weaklysuperviseddl_tpu.compat import RunInference as JRun
from weaklysuperviseddl_tpu.compat import SegmentationDataset as JDataset
from weaklysuperviseddl_tpu.compat import SegmentationModel as JSeg
from weaklysuperviseddl_tpu.compat import SupervisedModel as JSup
from weaklysuperviseddl_tpu.compat import Visualisation as JVis
from weaklysuperviseddl_tpu.compat import _adapt as jadapt
from weaklysuperviseddl_tpu.compat.ClassificationModel import FrozenResNetCAM as JaxFrozen
from weaklysuperviseddl_tpu.compat.ClassificationModel import (
    evaluate_classification as jax_evaluate_classification,
)
from weaklysuperviseddl_tpu.compat.ClassificationModel import train_fc_only as jax_train_fc_only
from weaklysuperviseddl_tpu.data.dataset import download_data as jax_download
from weaklysuperviseddl_tpu.data.loader import batches as jax_batches
from weaklysuperviseddl_tpu.models.classifier import CamClassifier as JaxCamClassifier
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import SegTrainState as JaxSegTrainState
import weaklysuperviseddl_tpu_torch.compat as compat_pkg
from weaklysuperviseddl_tpu_torch.compat import AlternatingDirectionBoundaryLoss as BL
from weaklysuperviseddl_tpu_torch.compat import AlternatingDirectionCutLoss as CL
from weaklysuperviseddl_tpu_torch.compat import Abalations as Abl
from weaklysuperviseddl_tpu_torch.compat import ExtraUtilities as Extra
from weaklysuperviseddl_tpu_torch.compat import LayerCAM as PLayerCAM
from weaklysuperviseddl_tpu_torch.compat import Lovasz_Softmax_Loss as L
from weaklysuperviseddl_tpu_torch.compat import PsuedoMasks
from weaklysuperviseddl_tpu_torch.compat import RunInference as Run
from weaklysuperviseddl_tpu_torch.compat import SegmentationDataset as Dataset
from weaklysuperviseddl_tpu_torch.compat import SegmentationModel as Seg
from weaklysuperviseddl_tpu_torch.compat import SupervisedModel as Sup
from weaklysuperviseddl_tpu_torch.compat import Visualisation as Vis
from weaklysuperviseddl_tpu_torch.compat import _adapt
from weaklysuperviseddl_tpu_torch.compat.ClassificationModel import (
    FrozenResNetCAM,
    evaluate_classification,
    train_fc_only,
)
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import Dropout
from weaklysuperviseddl_tpu_torch.models.jax_import import (
    cam_classifier_state_dict_from_jax,
    deeplab_state_dict_from_jax,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")
ROOT = pathlib.Path(__file__).resolve().parent.parent
SEG = dict(backbone_depth=18, width_multiplier=0.25)


def _quiet(*_args, **_kwargs):
    pass


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_frozen():
    """JAX's compat FrozenResNetCAM on ``jax_classifier_numpy``'s weights:
    its own constructor, with the flax ``init`` it calls (at 224², many
    seconds on a CPU) replaced by the cached tree."""
    _, variables = jax_classifier_numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxCamClassifier, "init", lambda self, *a, **k: variables)
        return JaxFrozen(num_classes=37, depth=18, width_multiplier=0.25)


def port_frozen():
    """The port's FrozenResNetCAM on the CPU with the same weights."""
    model = FrozenResNetCAM(num_classes=37, depth=18, width_multiplier=0.25, device="cpu")
    model.load_state_dict(cam_classifier_state_dict_from_jax(jax_classifier_numpy()[1]))
    return model.eval()


@functools.lru_cache(maxsize=None)
def pets(split, n, size=64):
    """(the port's dataset, JAX's) of ``n`` synthetic pets."""
    return (download_data(None, split=split, synthetic_size=n, image_size=size),
            jax_download(None, split=split, synthetic_size=n, image_size=size))


@pytest.fixture(scope="module")
def frozen():
    return jax_frozen(), port_frozen()


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


def _jax_initialize_model(num_classes=2, device=None, backbone_depth=50, width_multiplier=1.0,
                          input_size=256, lr=1e-4, seed=0):
    """JAX's compat initialize_model with ``jax_deeplab_numpy``'s tree (non-
    trivial BatchNorm statistics) in place of flax's jitted init, which
    costs seconds of compiling; the optimizer is create_seg_state's."""
    model, variables = jax_deeplab_numpy(backbone_depth, width_multiplier, seed, input_size)
    tx = apply_if_finite_fast(optax.adam(lr))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxSegTrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             tx.init(params))
    return JSeg.SegModelHandle(model, state, input_size), tx


def _jax_from_tree(mp, record):
    """JAX's compat ``initialize_model`` as ``_jax_initialize_model``, the
    initial weights (as numpy) and the tx recorded."""
    def spy(*args, **kwargs):
        handle, tx = _jax_initialize_model(*args, **kwargs)
        record["variables"] = {"params": _tree_np(handle.state.params),
                               "batch_stats": _tree_np(handle.state.batch_stats)}
        record["tx"] = tx
        return handle, tx

    mp.setattr(JSeg, "initialize_model", spy)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _port_from_tree(mp, record):
    """The port's compat ``initialize_model``, its model loaded with JAX's
    recorded initial weights."""
    original = Seg.initialize_model

    def wrapped(*args, **kwargs):
        handle, opt = original(*args, **kwargs)
        handle.module.load_state_dict(deeplab_state_dict_from_jax(record["variables"]))
        return handle, opt

    mp.setattr(Seg, "initialize_model", wrapped)


# ---- adapters ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 6), (5, 6, 3), (3, 4, 3), (2, 3, 4, 5), (2, 4, 5, 3),
                                   (1, 3, 3, 3), (1, 3, 7, 3)])
def test_to_nhwc_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape)  # float64 → float32
    got, got_b = _adapt.to_nhwc(x)
    want, want_b = jadapt.to_nhwc(x)
    assert got_b == want_b and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(5, 6), (1, 4, 6), (1, 5, 6), (1, 3, 2), (2, 5, 6),
                                   (2, 1, 5, 6)])
def test_to_hw_batch_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape)  # int64 → int32
    got, got_b = _adapt.to_hw_batch(x)
    want, want_b = jadapt.to_hw_batch(x)
    assert got_b == want_b and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(1, 8, 16, 16), (1, 9, 16, 16), (2, 16, 16, 8),
                                   (2, 16, 16), (8, 12, 9), (2, 8, 8, 8)])
def test_prediction_map_layout_matches_jax(shape):
    """8 channels and fewer, before a trailing dimension above 8, are NCHW."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got, got_b = CL.to_nhwc_any_channels(x)
    want, want_b = JCL.to_nhwc_any_channels(x)
    assert got_b == want_b
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- ClassificationModel and LayerCAM ---------------------------------------

def test_frozen_resnet_call_and_state_dict_match_jax(frozen, tmp_path):
    """(logits, [f2, f3, f4]) for an NCHW batch and a CHW image, NCHW out;
    the port reads JAX's torch-style state dict and the reference's stem
    keys, and JAX reads the port's."""
    jmodel, model = frozen
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    for inp in (x, x[1]):
        want_logits, want_feats = jmodel(inp)
        with torch.no_grad():
            logits, feats = model(inp)
        np.testing.assert_allclose(_np(logits), np.asarray(want_logits), rtol=1e-3, atol=2e-3)
        assert len(feats) == 3
        for got, want in zip(feats, want_feats):
            np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(want),
                                       rtol=1e-3, atol=2e-3)
    jsd = jmodel.state_dict()
    reference = {k.replace("conv1.", "layer0.0.", 1) if k.startswith("conv1.") else
                 k.replace("bn1.", "layer0.1.", 1) if k.startswith("bn1.") else k: v
                 for k, v in jsd.items()}
    assert any(k.startswith("layer0.0.") for k in reference)
    path = tmp_path / "classifier.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in reference.items()}, path)
    clone = FrozenResNetCAM(num_classes=37, depth=18, width_multiplier=0.25, seed=9,
                            device="cpu")
    clone.load_state_dict(torch.load(path, weights_only=True), strict=False)
    for k, v in model.state_dict().items():
        if k in jsd:
            np.testing.assert_array_equal(_np(clone.state_dict()[k]), np.asarray(jsd[k]), k)
    back = JaxFrozen.__new__(JaxFrozen)
    back.__dict__.update(jmodel.__dict__)
    back.load_state_dict({k: _np(v) for k, v in model.state_dict().items()
                          if not k.endswith("num_batches_tracked")})
    np.testing.assert_array_equal(np.asarray(back(x)[0]), np.asarray(jmodel(x)[0]))
    assert clone.to("cpu") is clone and clone.eval() is clone


def test_fc_training_and_evaluation_match_jax():
    """The (model, dataloader) signature, 2 epochs from one tree: fc within
    1e-5, accuracy and macro-F1 equal."""
    jmodel, model = jax_frozen(), port_frozen()
    ds, jds = pets("trainval", 8)
    jax_train_fc_only(jmodel, lambda: jax_batches(jds, 4, pad_to_full=True), epochs=2,
                      image_size=64)
    out = train_fc_only(model, lambda: batches(ds, 4, pad_to_full=True), device="cpu",
                        epochs=2, image_size=64, log=_quiet)
    assert out is model
    fc = jmodel.variables["params"]["fc"]
    np.testing.assert_allclose(_np(model.fc.weight).T, np.asarray(fc["kernel"]), atol=1e-5)
    np.testing.assert_allclose(_np(model.fc.bias), np.asarray(fc["bias"]), atol=1e-5)
    want = jax_evaluate_classification(jmodel, lambda: jax_batches(jds, 3), image_size=64)
    got = evaluate_classification(model, [b for b in batches(ds, 3)], device="cpu",
                                  image_size=64, log=_quiet)
    assert got == pytest.approx(want, abs=1e-5)


def test_layercam_generator_matches_jax(frozen):
    """generate on a CHW image with a class and on an NHWC batch with the
    argmax class; generate_bg_cam with the first valid class; the evaluation
    on 5 + 1 test pets."""
    jmodel, model = frozen
    jgen = JLayerCAM.LayerCAMGenerator(jmodel, ["layer3", "layer4"], output_size=64)
    gen = PLayerCAM.LayerCAMGenerator(model, ["layer3", "layer4"], output_size=64)
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    batch = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    for args, kw in (((img,), dict(class_idx=np.array([5]), alpha=0.5)), ((batch,), {})):
        want, got = jgen.generate(*args, **kw), gen.generate(*args, **kw)
        assert isinstance(got, torch.Tensor) and got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3)
    for want, got in zip(jgen.generate_bg_cam(img, [7, 2], alpha=2.0),
                         gen.generate_bg_cam(img, [7, 2], alpha=2.0)):
        assert got.shape == (64, 64)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3)
    ds, jds = pets("test", 8)
    want = JLayerCAM.evaluate_layercam_on_test_set(jgen, jax_batches(jds, 4), max_images=5,
                                                   log=_quiet)
    got = PLayerCAM.evaluate_layercam_on_test_set(gen, batches(ds, 4), max_images=5, log=_quiet)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-2)


def test_cam_generator_matches_jax(frozen):
    jmodel, model = frozen
    img = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    want = JCL.CAMGenerator(jmodel).generate_all_cams(img)
    got = CL.CAMGenerator(model).generate_all_cams(img)
    assert got.shape == (37, 4, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3)
    for want, got in zip(JCL.CAMGenerator(jmodel).generate_bg_cam(img, [3, 30], alpha=2.0),
                         CL.CAMGenerator(model).generate_bg_cam(img, [3, 30], alpha=2.0)):
        assert got.shape == (224, 224)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3)


# ---- PsuedoMasks, SegmentationDataset, SegmentationModel --------------------

def test_keep_largest_matches_jax():
    """A {0,255} mask with three blobs and one with none; numpy and torch
    inputs; uint8 numpy out."""
    m = np.zeros((24, 30), np.uint8)
    m[2:6, 2:6] = 255
    m[10:20, 8:25] = 255
    m[21:23, 27:29] = 255
    for mask in (m, np.zeros_like(m), m // 255):
        want = JPsuedo.keep_largest(mask)
        got = PsuedoMasks.keep_largest(torch.from_numpy(mask))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PsuedoMasks.keep_largest(torch.from_numpy(m)),
                                  JPsuedo.keep_largest(m))


@pytest.fixture(scope="module")
def trained(frozen, tmp_path_factory):
    """Both packages' generate_pseudo_masks over 8 train pets (64²) into one
    root, then both train_segmentation_model over the port's directories for
    one epoch at 32², from one initial tree (``_jax_initialize_model``),
    dropout the identity."""
    jmodel, model = frozen
    root = str(tmp_path_factory.mktemp("compat"))
    ds, jds = pets("trainval", 8)
    jgen = JLayerCAM.LayerCAMGenerator(jmodel, ["layer3", "layer4"], output_size=64)
    gen = PLayerCAM.LayerCAMGenerator(model, ["layer3", "layer4"], output_size=64)
    out = {"root": root}
    out["jax_dirs"] = JPsuedo.generate_pseudo_masks(jax_batches(jds, 4, pad_to_full=True), jgen,
                                                    run_id="jax", root=root)
    out["dirs"] = PsuedoMasks.generate_pseudo_masks(batches(ds, 4, pad_to_full=True), gen,
                                                    run_id="port", root=root, log=_quiet)
    record = {}
    kw = dict(run_id="port", lr=1e-4, num_epochs=1, batch_size=4, root=root, seg_size=32,
              log=_quiet, **SEG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        mp.setattr(Dropout, "forward", lambda self, x: x)
        _jax_from_tree(mp, record)
        _port_from_tree(mp, record)
        out["jax"], out["jax_loss"] = JSeg.train_segmentation_model(**kw)
        out["port"], out["port_loss"] = Seg.train_segmentation_model(device="cpu", **kw)
    out["tx"] = record["tx"]
    return out


def test_pseudo_mask_directories_match_jax(trained):
    """The reference's layout: one PNG per image, named by its running id,
    in ``pseudo_masks_{run_id}`` and ``images_{run_id}``; read back, the
    masks equal JAX's, the images within one grey level."""
    (jimg_dir, jmask_dir), (img_dir, mask_dir) = trained["jax_dirs"], trained["dirs"]
    root = trained["root"]
    assert img_dir == os.path.join(root, "images_port")
    assert mask_dir == os.path.join(root, "pseudo_masks_port")
    names = sorted(f"{i}.png" for i in range(8))
    for d in (jimg_dir, jmask_dir, img_dir, mask_dir):
        assert sorted(os.listdir(d)) == names
    assert not os.path.exists(os.path.join(root, "_store_port"))
    images, masks = Seg.read_pseudo_masks(root, "port")
    jimages, jmasks = Seg.read_pseudo_masks(root, "jax")
    np.testing.assert_array_equal(masks, jmasks)
    assert 0.02 < masks.mean() < 0.98  # the masks have structure
    assert np.abs(images.astype(int) - jimages.astype(int)).max() <= 1


class _TwoBlobCams:
    """A CAM generator for ``generate_pseudo_masks`` whose maps hold two
    blobs, a large one placed by the class and a small one (the synthetic
    pets' LayerCAMs are one blob each, where keeping the largest component
    changes nothing)."""

    def __init__(self, as_array):
        self.as_array = as_array

    def generate(self, images, class_idx=None, alpha=1.0):
        size = images.shape[1]
        yy, xx = np.mgrid[0:size, 0:size] / size
        cams = []
        for c in np.asarray(class_idx).reshape(-1):
            big = np.exp(-((yy - 0.3 - 0.01 * (c % 8)) ** 2 + (xx - 0.35) ** 2) / 0.02)
            small = 0.8 * np.exp(-((yy - 0.75) ** 2 + (xx - 0.8) ** 2) / 0.003)
            cams.append(np.maximum(big, small))
        return self.as_array(np.stack(cams).astype(np.float32))


def test_pseudo_masks_keep_largest_matches_jax(tmp_path):
    """Two-blob CAMs over 8 pets, with and without keeping the largest
    component: the PNG masks equal JAX's each way, and keeping the largest
    drops the small blob."""
    ds, jds = pets("trainval", 8)
    root = str(tmp_path)
    got = {}
    for keep in (True, False):
        JPsuedo.generate_pseudo_masks(jax_batches(jds, 4, pad_to_full=True),
                                      _TwoBlobCams(jnp.asarray), keep_largest_masks=keep,
                                      run_id=f"jax{keep}", root=root)
        PsuedoMasks.generate_pseudo_masks(batches(ds, 4, pad_to_full=True),
                                          _TwoBlobCams(torch.from_numpy),
                                          keep_largest_masks=keep, run_id=f"port{keep}",
                                          root=root, log=_quiet)
        _, got[keep] = Seg.read_pseudo_masks(root, f"port{keep}")
        np.testing.assert_array_equal(got[keep], Seg.read_pseudo_masks(root, f"jax{keep}")[1])
    assert got[True].shape == (8, 64, 64)
    core = (slice(None), slice(46, 51), slice(49, 54))  # inside the small blob
    assert got[False][core].all() and not got[True][:, 40:].any()
    np.testing.assert_array_equal(got[True][:, :40], got[False][:, :40])


@pytest.mark.parametrize("transform,return_name", [(True, True), (False, False)])
def test_pseudo_segmentation_dataset_matches_jax(trained, transform, return_name):
    img_dir, mask_dir = trained["dirs"]
    want = JDataset.PseudoSegmentationDataset(img_dir, mask_dir, transform, return_name)
    got = Dataset.PseudoSegmentationDataset(img_dir, mask_dir, transform, return_name)
    assert len(got) == len(want) == 8
    for i in (0, 7):
        w, g = want[i], got[i]
        assert len(g) == len(w) == (3 if return_name else 2)
        for a, b in zip(g, w):
            if isinstance(b, str):
                assert a == b
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_segmentation_training_matches_jax(trained):
    """One epoch (two steps) from one tree: the final loss within 1e-4; the
    handle gives NCHW logits within 2e-3 of JAX's, in eval mode, and leaves
    the model's mode as it was."""
    assert np.isfinite(trained["port_loss"])
    np.testing.assert_allclose(trained["port_loss"], trained["jax_loss"], rtol=1e-4)
    x = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    module = trained["port"].module
    was_training = module.training
    want = trained["jax"](x)["out"]
    got = trained["port"](x)["out"]
    assert got.shape == want.shape == (2, 2, 32, 32)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-3, atol=2e-3)
    assert module.training == was_training


def test_evaluate_model_variants_match_jax(trained):
    """SegmentationModel's (truth trimap == 1) and the CutLoss script's
    (the shifted trimap inverted) over 8 test pets at 64²."""
    ds, jds = pets("test", 8)
    for pkg, jpkg, kw in ((Seg, JSeg, dict(log=_quiet)), (CL, JCL, {})):
        want = jpkg.evaluate_model(trained["jax"], jax_batches(jds, 4), **kw)
        got = pkg.evaluate_model(trained["port"], batches(ds, 4), **kw)
        assert got == pytest.approx(want, abs=2e-3)


def test_infer_and_plot_matches_jax(trained, tmp_path):
    ds, _ = pets("trainval", 8)
    img_path = str(tmp_path / "pet.png")
    Image.fromarray(ds.images[0]).save(img_path)
    want = JCL.infer_and_plot(trained["jax"], img_path, img_path)
    got = CL.infer_and_plot(trained["port"], img_path, img_path,
                            save_path=str(tmp_path / "viz.png"))
    assert got.shape == (256, 256)
    assert (got == np.asarray(want)).mean() > 0.99
    assert (tmp_path / "viz.png").exists()


@pytest.mark.parametrize("mask_scale,lr", [(255, 0.2), (1, 1e-2)])
def test_refine_pseudo_mask_matches_jax(trained, mask_scale, lr):
    """A PNG-style {0,255} mask at lr 0.2 (pixels move) and a {0,1} one at
    the path's lr (none can); masks as float32 [H,W]."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
    mask = (rng.uniform(0, 1, (32, 32)) > 0.5).astype(np.uint8) * mask_scale
    kw = dict(threshold=0.5, lr=lr, num_steps=5)
    want = np.asarray(JCL.refine_pseudo_mask(trained["jax"], img, mask, **kw))
    got = CL.refine_pseudo_mask(trained["port"], img, mask, **kw)
    assert got.dtype == torch.float32 and got.shape == (32, 32)
    assert (_np(got) == want).mean() > 0.99
    moved = (_np(got) != (mask > 0)).mean()
    assert moved > 0.01 if lr > 0.1 else moved == 0.0


def test_cut_train_model_matches_jax(trained, no_dropout):
    """The CutLoss script's train_model on Batch objects (trimap == 1): one
    more epoch of the trained handles, the loss within 5e-4 (three steps
    from one tree: Adam's first steps move the parameters whose gradient is
    float noise by ±lr in either package, ROADMAP queue 3, and the two
    trajectories part by about 1e-4 of the loss a step); another optimizer
    is refused. Runs last: it trains the shared handles."""
    ds, jds = pets("trainval", 8)
    want = JCL.train_model(trained["jax"], trained["tx"], num_epochs=1,
                           train_loader=jax_batches(jds, 4, pad_to_full=True), log=_quiet)
    port = trained["port"]
    with pytest.raises(ValueError, match="optimizer"):
        CL.train_model(port, object(), train_loader=batches(ds, 4))
    got = CL.train_model(port, port.state.optimizer, num_epochs=1,
                         train_loader=batches(ds, 4, pad_to_full=True), log=_quiet)
    np.testing.assert_allclose(got, want, rtol=5e-4)


def test_segmentation_handle_moves_with_its_optimizer():
    handle, opt = Seg.initialize_model(2, device="cpu", input_size=32, **SEG)
    assert opt is handle.state.optimizer and handle.eval() is handle
    assert handle.to("meta") is handle
    assert next(handle.module.parameters()).device.type == "meta"
    assert {t.device.type for t in opt.m + opt.v} == {"meta"}
    assert {t.device.type for t in (opt.count, opt.notfinite_count, opt.total_notfinite)} \
        == {"meta"}


# ---- the window losses, affinities, CRF -------------------------------------

def test_window_loss_classes_and_affinities_match_jax():
    rng = np.random.default_rng(2)
    preds = rng.standard_normal((1, 2, 12, 12)).astype(np.float32)
    img = rng.uniform(0, 1, (1, 3, 12, 12)).astype(np.float32)
    got = CL.LocalNormalizedCutLoss(0.05, 5)(preds, img)
    want = JCL.LocalNormalizedCutLoss(0.05, 5)(preds, img)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    probs = torch.softmax(torch.from_numpy(preds), dim=1).numpy()
    got = BL.ConstrainToBoundaryLossSingle(0.1, 5, 5)(probs[0], img[0])
    want = JBL.ConstrainToBoundaryLossSingle(0.1, 5, 5)(probs[0], img[0])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    got = CL.compute_affinities(img, sigma_color=0.1, sigma_space=5, window_size=5)
    want = JCL.compute_affinities(img, sigma_color=0.1, sigma_space=5, window_size=5)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert g.shape == (1, 1, 12, 12)
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6)


def test_apply_dense_crf_matches_jax():
    """One uint8 image and its CAM at 32² (JAX's exact filter off the TPU
    holds to 64²): uint8 masks, > 0.999 of the pixels equal."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:32, 0:32] / 32
    cam = np.exp(-((yy - 0.5) ** 2 + (xx - 0.4) ** 2) / 0.05).astype(np.float32)
    img = np.clip(np.stack([cam, 1 - cam, cam * 0.5], -1) * 255
                  + rng.normal(0, 20, (32, 32, 3)), 0, 255).astype(np.uint8)
    want = JCL.apply_dense_crf(img, cam)
    got = CL.apply_dense_crf(img, torch.from_numpy(cam))
    assert got.dtype == np.uint8 and got.shape == (32, 32)
    assert (got == want).mean() > 0.999
    assert 0.05 < got.mean() < 0.95


# ---- the boundary-loss script -----------------------------------------------

def test_boundary_script_matches_jax(frozen, tmp_path):
    """run_alternating_training over 8 pets (CAM threshold 0.5): the store of
    initial pseudo-masks (equal) and the config it
    hands the alternating loop equal JAX's, where JAX's loop is not run (it
    is held against the port's in test_torch_cycle_parity.py); the port's
    loop runs, one alternation of one epoch and one 75-step boundary sweep
    at 32². JAX's compat builds its RefineConfig without
    ``loss="boundary"``, so it would refine with the ncut loss under the
    boundary protocol's parameters; the port passes it (ROADMAP queue 3).
    Also setup_dirs and initialize_model."""
    jmodel, model = frozen
    ds, jds = pets("trainval", 8)
    jgen = JLayerCAM.LayerCAMGenerator(jmodel, ["layer3", "layer4"], output_size=64)
    gen = PLayerCAM.LayerCAMGenerator(model, ["layer3", "layer4"], output_size=64)
    kw = dict(num_alternations=1, epochs_per_round=1, log=_quiet,
              seg_kwargs=dict(seg_size=32, lr=1e-3, **SEG))
    seen = {}

    def jax_loop(module, state, tx, store, cfg, **_kw):
        seen["jax"] = (store.as_arrays(), cfg)
        return state, store

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_segmentation, "create_seg_state", lambda *a, **k: (None, None))
        mp.setattr(jax_alternating, "run_alternating_training", jax_loop)
        port_loop = BL._run

        def spy(state, store, cfg, **loop_kw):
            seen["port"] = (store.as_arrays(), cfg)
            return port_loop(state, store, cfg, **loop_kw)

        mp.setattr(BL, "_run", spy)
        JBL.run_alternating_training(jax_batches(jds, 4, pad_to_full=True), jgen, **kw)
        handle, store = BL.run_alternating_training(batches(ds, 4, pad_to_full=True), gen, **kw)
    (jimages, jmasks, jkeys), jcfg = seen["jax"]
    (images, masks, keys), cfg = seen["port"]
    assert keys == jkeys == [f"{i:05d}" for i in range(8)]
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(masks, jmasks)
    assert 0.02 < masks.mean() < 0.98
    assert cfg.alternating.refine.loss == "boundary" and jcfg.alternating.refine.loss == "ncut"
    _assert_same_config(cfg, dataclasses.replace(jcfg, alternating=dataclasses.replace(
        jcfg.alternating, refine=dataclasses.replace(jcfg.alternating.refine, loss="boundary"))))
    assert isinstance(handle, Seg.SegModelHandle) and handle.input_size == 32
    assert store.keys() == keys and store.as_arrays()[1].shape == (8, 32, 32)
    dirs = BL.setup_dirs(str(tmp_path / "m"), str(tmp_path / "i"))
    assert dirs == JBL.setup_dirs(str(tmp_path / "m"), str(tmp_path / "i"))
    assert all(os.path.isdir(d) for d in dirs)
    fresh = BL.initialize_model(2, device="cpu", input_size=32, **SEG)
    assert fresh(np.zeros((1, 32, 32, 3), np.float32))["out"].shape == (1, 2, 32, 32)


# ---- Lovász, ExtraUtilities, Visualisation, RunInference --------------------

def test_lovasz_names_match_jax():
    rng = np.random.default_rng(4)
    probas = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    probas /= probas.sum(1, keepdims=True)
    labels = rng.integers(0, 3, (2, 8, 8))
    labels[0, :2] = 255
    logits = rng.standard_normal((2, 8, 8)).astype(np.float32)
    binary = rng.integers(0, 2, (2, 8, 8))
    cases = [
        ("lovasz_softmax", (probas, labels), dict(classes="present", per_image=True, ignore=255)),
        ("lovasz_softmax_flat", (probas.transpose(0, 2, 3, 1).reshape(-1, 3),
                                 np.clip(labels, 0, 2).reshape(-1)), {}),
        ("lovasz_hinge", (logits, binary), dict(per_image=False)),
        ("lovasz_hinge_flat", (logits.reshape(-1), binary.reshape(-1)), {}),
        ("binary_xloss", (logits, binary), dict(ignore=None)),
        ("xloss", (rng.standard_normal((2, 3, 8, 8)).astype(np.float32), labels), {}),
    ]
    for name, args, kw in cases:
        np.testing.assert_allclose(float(getattr(L, name)(*args, **kw)),
                                   float(getattr(JL, name)(*args, **kw)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(L.StableBCELoss()(logits, binary.astype(np.float32))),
                               float(JL.StableBCELoss()(logits, binary.astype(np.float32))),
                               rtol=1e-5)
    for a, b in zip(L.flatten_probas(probas, labels, ignore=255),
                    JL.flatten_probas(probas, labels, ignore=255)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(L.flatten_binary_scores(logits, binary, ignore=1),
                    JL.flatten_binary_scores(logits, binary, ignore=1)):
        np.testing.assert_array_equal(a, np.asarray(b))
    preds = rng.integers(0, 3, (2, 8, 8))
    assert L.iou_binary(preds, binary, ignore=255) == JL.iou_binary(preds, binary, ignore=255)
    np.testing.assert_array_equal(L.iou(preds, labels, 3, ignore=255, per_image=True),
                                  JL.iou(preds, labels, 3, ignore=255, per_image=True))
    lg = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(_np(L.lovasz_grad(torch.from_numpy(lg > 0).float())),
                                  np.asarray(JL.lovasz_grad(jnp.asarray(lg > 0, jnp.float32))))
    for vals, kw in (([1.0, float("nan"), 3.0], dict(ignore_nan=True)), ([], dict(empty=0)),
                     ((v for v in (2, 4)), {})):
        vals = list(vals)
        assert L.mean(iter(vals), **kw) == JL.mean(iter(vals), **kw)
    with pytest.raises(ValueError):
        L.mean([], empty="raise")
    assert L.isnan(float("nan")) and not L.isnan(1.0)


def test_extra_utilities_and_visualisation_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    pred, true = rng.integers(0, 2, (9, 11)), rng.integers(0, 2, (9, 11))
    assert Extra.compute_iou_and_acc(pred, torch.from_numpy(true)) == pytest.approx(
        JExtra.compute_iou_and_acc(pred, true), rel=1e-6)
    assert Extra.download_data is download_data
    img = rng.uniform(0, 255, (3, 16, 16)).astype(np.float32)
    cam = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    np.testing.assert_allclose(Vis.overlay_cam_on_image(torch.from_numpy(img), cam, alpha=0.4),
                               JVis.overlay_cam_on_image(img, cam, alpha=0.4), atol=1e-6)
    for pkg, tag in ((Vis, "port"), (JVis, "jax")):
        pkg.visualize_mask(img, cam > 0.5, title="t", save_path=str(tmp_path / f"m_{tag}.png"))
        pkg.plot_segmentation(img.transpose(1, 2, 0).astype(np.uint8), cam > 0.5,
                              save_path=str(tmp_path / f"s_{tag}.png"))
    for kind in ("m", "s"):
        a, b = (np.asarray(Image.open(tmp_path / f"{kind}_{t}.png")) for t in ("port", "jax"))
        np.testing.assert_array_equal(a, b)


def test_run_inference_names(monkeypatch):
    """norm_pred and compute_metrics against JAX's; main hands run_inference
    what JAX's main hands JAX's engine (the engine is held against JAX in
    test_torch_basnet.py; a BASNet forward at 256² takes seconds on a CPU)."""
    d = np.random.default_rng(7).standard_normal((2, 1, 9, 10)).astype(np.float32)
    np.testing.assert_allclose(_np(Run.norm_pred(d)), np.asarray(JRun.norm_pred(d)), atol=1e-6)
    pred = np.random.default_rng(8).uniform(0, 1, (9, 10))
    tri = np.random.default_rng(9).integers(1, 4, (9, 10))
    for a, b in zip(Run.compute_metrics(torch.from_numpy(pred), tri),
                    JRun.compute_metrics(pred, tri)):
        np.testing.assert_array_equal(a, b)
    jcalls, calls = _captured(monkeypatch, JRun, "run_inference"), _captured(
        monkeypatch, Run, "run_inference")
    kw = dict(model_path="missing.pth", dataset_root=None, output_folder=None, num_images=3,
              log=_quiet)
    assert JRun.main(**kw) == Run.main(device="cpu", **kw) == "ran"
    (jargs, jkw), (args, pkw) = jcalls[0], calls[0]
    assert pkw == {**jkw, "device": "cpu"}
    for a, b in zip(args[0].images + [args[0].labels], jargs[0].images + [jargs[0].labels]):
        np.testing.assert_array_equal(a, b)


def _captured(mp, module, name):
    calls = []
    mp.setattr(module, name, lambda *a, **k: calls.append((a, k)) or "ran")
    return calls


def _assert_same_config(cfg, jax_cfg):
    """Every field the two packages' ExperimentConfigs share is equal."""
    def common(a, b, path):
        if isinstance(b, dict):
            for k in a.keys() & b.keys():
                common(a[k], b[k], f"{path}.{k}")
        else:
            assert a == b, path

    common(dataclasses.asdict(cfg), dataclasses.asdict(jax_cfg), "cfg")


def test_supervised_and_ablation_names_match_jax(frozen, tmp_path):
    """The configs and arguments the reference-named drivers hand to the
    pipelines equal JAX's (each pipeline is held against JAX in its own
    test file); run_ablation reads a reference ``.pth`` into both packages'
    classifiers alike; main runs the reference's grid."""
    jmodel, model = frozen
    with pytest.MonkeyPatch.context() as mp:
        jcalls, calls = _captured(mp, JSup, "_run"), _captured(mp, Sup, "_run")
        kw = dict(data_path=None, num_epochs=2, batch_size=4, train_ratio=0.75, lr=3e-4,
                  extra="ignored", **SEG)
        assert JSup.run_supervised_training(**kw) == Sup.run_supervised_training(**kw) == "ran"
        (jargs, jkw), (args, pkw) = jcalls[0], calls[0]
        _assert_same_config(args[0], jargs[0])
        assert pkw == {**jkw, "device": None}

        path = tmp_path / "classifier.pth"
        sd = {("layer0.0." + k[6:]) if k.startswith("conv1.") else k: v
              for k, v in model.state_dict().items()}
        torch.save(sd, path)
        jcalls, calls = (_captured(mp, JAbl, "_run_ablation"),
                         _captured(mp, Abl, "_run_ablation"))
        jclassifier = JaxFrozen.__new__(JaxFrozen)
        jclassifier.__dict__.update(jmodel.__dict__)
        clone = port_frozen()
        args = (str(path), "loader", "test_loader", "LayerCAM", 0.3, 1.0, 1e-3, True, "r0")
        JAbl.run_ablation(jclassifier, *args, log=_quiet)
        Abl.run_ablation(clone, *args, log=_quiet)
        (jargs, jkw), (pargs, pkw) = jcalls[0], calls[0]
        assert jargs[0] is jclassifier.module and pargs[0] is clone
        assert {k: v for k, v in pkw.items() if k != "cfg"} == {
            k: v for k, v in jkw.items() if k != "cfg"}
        for k, v in clone.state_dict().items():
            if k.endswith("weight") and v.ndim == 4:
                name = k[:-len(".weight")]
                want = jclassifier.state_dict()[k]
                np.testing.assert_array_equal(_np(v), np.asarray(want), name)

        jcalls, calls = (_captured(mp, JAbl, "_run_experiment"),
                         _captured(mp, Abl, "_run_experiment"))
        grid = [("LayerCAM", 0.3, 1.0, 1e-3, True)]
        JAbl.run_abalation_experiment(grid, jmodel, num_repeats=2, log=_quiet)
        Abl.run_abalation_experiment(grid, model, num_repeats=2, log=_quiet)
        assert calls[0][0][0] == jcalls[0][0][0] == grid and calls[0][0][1] is model
        _assert_same_config(calls[0][0][2], jcalls[0][0][3])
        assert Abl.run_ablation_experiment is Abl.run_abalation_experiment
        jgrids, grids = (_captured(mp, JAbl, "run_abalation_experiment"),
                         _captured(mp, Abl, "run_abalation_experiment"))
        JAbl.main()
        Abl.main(device="cpu")
        assert grids[0][0][0] == jgrids[0][0][0] and len(grids[0][0][0]) == 12


# ---- devices and the import boundary ----------------------------------------

@pytest.mark.parametrize("call", [
    "FrozenResNetCAM", "train_fc_only", "evaluate_classification", "initialize_model",
    "keep_largest", "apply_dense_crf", "train_segmentation_model", "RunInference.main",
    "run_supervised_training", "run_abalation_experiment", "warmup_device"])
def test_device_none_raises_without_a_card(call, tmp_path):
    """``device=None`` means the card: without one each entry point raises,
    none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    from weaklysuperviseddl_tpu_torch.utils.profiling import warmup_device

    mask = np.ones((8, 8), np.uint8)
    model = port_frozen
    seg_root = tmp_path
    for sub in ("images_r", "pseudo_masks_r"):
        (seg_root / sub).mkdir()
        Image.fromarray(np.full((8, 8, 3) if sub == "images_r" else (8, 8), 255, np.uint8)).save(
            seg_root / sub / "0.png")
    calls = {
        "FrozenResNetCAM": lambda: FrozenResNetCAM(37, 18, 0.25),
        "train_fc_only": lambda: train_fc_only(model(), lambda: iter([]), epochs=1),
        "evaluate_classification": lambda: evaluate_classification(model(), lambda: iter([])),
        "initialize_model": lambda: Seg.initialize_model(2, **SEG),
        "keep_largest": lambda: PsuedoMasks.keep_largest(mask),
        "apply_dense_crf": lambda: CL.apply_dense_crf(np.zeros((8, 8, 3), np.uint8),
                                                      mask.astype(np.float32)),
        "train_segmentation_model": lambda: Seg.train_segmentation_model(
            run_id="r", root=str(seg_root), num_epochs=1, **SEG),
        "RunInference.main": lambda: Run.main(model_path="missing.pth", dataset_root=None,
                                              output_folder=None, num_images=1),
        "run_supervised_training": lambda: Sup.run_supervised_training(data_path=None),
        "run_abalation_experiment": lambda: Abl.run_abalation_experiment([]),
        "warmup_device": lambda: warmup_device(log=_quiet),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()


def test_surface_imports_neither_jax_nor_the_jax_package():
    """Every module of compat/, cam/cam.py and utils/profiling.py, by its AST."""
    pkg = ROOT / "weaklysuperviseddl_tpu_torch"
    paths = sorted((pkg / "compat").glob("*.py")) + [pkg / "cam" / "cam.py",
                                                     pkg / "utils" / "profiling.py"]
    assert len(paths) == 18
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "weaklysuperviseddl_tpu"), (
                    f"{path.name} imports {name}")


def test_package_imports_the_same_modules_as_jax():
    names = {"ClassificationModel", "ExtraUtilities", "LayerCAM", "PsuedoMasks",
             "SegmentationDataset", "SegmentationModel"}
    for name in names:
        assert hasattr(compat_pkg, name) and hasattr(jax_compat_pkg, name)
    jax_files = {p.stem for p in (ROOT / "weaklysuperviseddl_tpu" / "compat").glob("*.py")}
    port_files = {p.stem for p in (ROOT / "weaklysuperviseddl_tpu_torch" / "compat").glob("*.py")}
    assert port_files == jax_files
