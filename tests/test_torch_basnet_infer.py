"""BASNet's heavier entry points against the JAX package's: run_inference on
the same pets, the cosine schedule over a run, a basnet.pth through both
build_basnets, and the CLI (moved out of test_torch_basnet.py, whose module
fixtures they share by import, so that xdist starts this heavy file after
the long JAX files)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_basnet import CLIP, LR, LR_END, SIZE, bridged  # noqa: F401  (fixtures)
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.data import download_data as jax_download_data
from weaklysuperviseddl_tpu.pipelines import basnet_infer as jax_infer
import weaklysuperviseddl_tpu_torch.train.basnet as port_train
from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.pipelines import basnet_infer

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def test_cosine_schedule_matches_optax_over_a_run(bridged, monkeypatch):
    """train_basnet's learning rate at every step of a 2-epoch run against
    optax's cosine_decay_schedule, and the schedule alone over the demo's
    3,000 steps and past them; the loss history and the eval hook."""
    lrs, hook = [], []

    class Recording(port_train.Adam):
        def step(self):
            lrs.append(self.lr)
            return super().step()

    monkeypatch.setattr(port_train, "Adam", Recording)
    model = copy.deepcopy(bridged[0])
    rng = np.random.default_rng(1)
    images = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    targets = np.zeros((2, SIZE, SIZE), np.float32)
    targets[:, 8:24, 8:24] = 1.0
    _, history = port_train.train_basnet(
        model, images, targets, epochs=2, batch_size=2, lr=LR, clip_norm=CLIP, lr_end=LR_END,
        eval_hook=lambda m, e: hook.append((m is model, e)), eval_every=1, log=lambda s: None)
    sched = optax.cosine_decay_schedule(LR, 2, alpha=LR_END / LR)
    assert len(lrs) == 2
    for count, lr in enumerate(lrs):
        assert abs(lr - float(sched(count))) <= 1e-7
    counts = np.arange(0, 3200, 7)
    mine = port_train.cosine_decay(LR, 3000, LR_END / LR)
    want = optax.cosine_decay_schedule(LR, 3000, LR_END / LR)(counts)
    np.testing.assert_allclose([mine(int(c)) for c in counts], np.asarray(want), atol=1e-7,
                               rtol=0)
    assert len(history) == 2 and all(np.isfinite(history))
    assert hook == [(True, 1), (True, 2)]
    with pytest.raises(ValueError):
        port_train.train_basnet(model, images, targets, epochs=1, batch_size=3)


def test_basnet_pth_loads_in_both_packages(bridged, tmp_path):
    """A ``basnet.pth``-style file written by torch.save, loaded by both
    ``build_basnet``s, gives the same maps; without the file the port draws
    seeded random weights."""
    port, jmodel, _, forward = bridged
    path = str(tmp_path / "basnet.pth")
    torch.save(port.state_dict(), path)
    mine = basnet_infer.build_basnet(weights_path=path, device="cpu")
    assert not mine.training
    _, variables = jax_infer.build_basnet(weights_path=path)
    x = np.random.default_rng(7).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = mine(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = forward(variables, jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(w)[..., 0], atol=1e-5, rtol=0)
    # the bridged model's conv weights are init_weights' at seed 0 (only its
    # biases and BatchNorms were perturbed)
    drawn = basnet_infer.build_basnet(weights_path=str(tmp_path / "missing.pth"), device="cpu")
    convs = [n for n, m in port.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(torch.equal(drawn.get_submodule(n).weight, port.get_submodule(n).weight)
               for n in convs)
    # bfloat16 and float16 are compute dtypes (tests/test_torch_dtype.py,
    # test_torch_dtype_fp16.py); float64 is not
    with pytest.raises(ValueError, match="is not ported"):
        basnet_infer.build_basnet(device="cpu", dtype="float64")


def test_run_inference_matches_jax(bridged, tmp_path, monkeypatch):
    """The engine on 2 synthetic test pets in both packages: the raw dout
    maps, the normalised ones (where a map's range is above 1e-3: norm_pred
    magnifies float noise in a flat map), per-image IoU and accuracy, and the
    PNGs (the same size, within one grey level on at most 0.1 % of the
    pixels: 1-4 of 50,176 differ here)."""
    port, jmodel, variables, forward = bridged
    saliency_dout = basnet_infer.saliency_dout
    n = 2
    ds, jds = download_data(None, split="test", synthetic_size=n), \
        jax_download_data(None, split="test", synthetic_size=n)
    images = np.stack(ds.images)
    assert np.array_equal(images, np.stack(jds.images))

    raw = []
    monkeypatch.setattr(basnet_infer, "saliency_dout",
                        lambda *a: raw.append(saliency_dout(*a)) or raw[-1])
    logs = []
    results, mean_iou, mean_acc = basnet_infer.run_inference(
        ds, model=port, num_images=n, batch_size=8, output_folder=str(tmp_path / "port"),
        log=logs.append)
    dout = raw[0].numpy()
    x, _ = jax_infer.preprocess_batch(jnp.asarray(images), None, size=jax_infer.IMG_SIZE)
    jdout = np.asarray(forward(variables, jax_infer._normalize_images(x))[0])[..., 0]
    np.testing.assert_allclose(dout, jdout, atol=1e-5, rtol=0)
    norm = basnet_infer.norm_pred(torch.from_numpy(dout)).numpy()
    jnorm = np.asarray(jax_infer.norm_pred(jnp.asarray(jdout)))
    wide = (jdout.max(axis=(1, 2)) - jdout.min(axis=(1, 2))) > 1e-3
    assert wide.any()
    np.testing.assert_allclose(norm[wide], jnorm[wide], atol=1e-4, rtol=0)

    jresults, jmean_iou, jmean_acc = jax_infer.run_inference(
        jds, model=jmodel, variables=variables, num_images=n, batch_size=n,
        output_folder=str(tmp_path / "jax"), log=lambda s: None)
    assert len(results) == n
    np.testing.assert_allclose(results, jresults, atol=1e-6, rtol=0)
    assert mean_iou == pytest.approx(jmean_iou, abs=1e-6)
    assert mean_acc == pytest.approx(jmean_acc, abs=1e-6)
    assert logs[-1].startswith("Mean IoU: ")
    from PIL import Image

    for i in range(n):
        a = np.asarray(Image.open(tmp_path / "port" / f"{i}_saliency.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / f"{i}_saliency.png"))
        assert a.shape == b.shape == ds.trimaps[i].shape
        # (map * 255).astype(uint8) truncates: float noise flips a pixel by one
        # grey level where the map lies within it of a level
        assert np.abs(a.astype(int) - b).max() <= 1 and (a != b).mean() <= 1e-3, i


def test_cli_basnet_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["basnet", "--device", "cpu", "--num-images", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("0 - IoU: ") and out[-1].startswith("Mean IoU: ")
    assert sorted(os.listdir(tmp_path / "basnet_outputs")) == ["0_saliency.png",
                                                               "1_saliency.png"]

