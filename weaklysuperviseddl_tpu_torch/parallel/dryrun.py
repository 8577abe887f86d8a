"""The multi-device dryrun (port of ``__graft_entry__.dryrun_multichip``): every
stage of the cycle once on a ('data', 'model') mesh at tiny shapes
(DeepLabV3-ResNet18 at width 0.25, 32², 2 examples a data shard), printing
the JAX dryrun's stage lines in its order:

  1. one segmentation step, batch on 'data', conv output channels on 'model'
     (a model axis of 2 where the world is even and at least 4, as JAX's);
  2. a data-parallel epoch over a ragged dataset of 2·batch + 1;
  3. LayerCAM → pseudo-masks (rank 0, broadcast: LayerCAM goes through
     cuDNN's backward, which can give two runs different bits);
  4. the dense CRF of each rank's rows, exact and subsampled, and the
     keep-largest pass;
  5. the refinement of each rank's rows (plain, as JAX's ``use_pallas=False``);
  6. the sharded eval (confusion counters summed over 'data');
  7. data-parallel serving: rank 0 serves the trained weights, made whole,
     on a local mesh of one device per index of the data axis.

Every rank runs ``dryrun_multichip``; rank 0 prints. The inputs are JAX's
draws from ``np.random.default_rng(0)`` in JAX's order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
from weaklysuperviseddl_tpu_torch.masks.densecrf import apply_dense_crf
from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3, seed_dropout
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.parallel.collectives import all_reduce_value
from weaklysuperviseddl_tpu_torch.parallel.mesh import (
    batch_sharding,
    full_state_dict,
    is_main_rank,
    make_mesh,
    replicate_tree,
    shard_batch,
    visible_cards,
)
from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor
from weaklysuperviseddl_tpu_torch.train.refine import refine_from_soft_predictions
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    create_seg_state,
    evaluate_segmentation_sharded,
    seg_train_step,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.profiling import Stopwatch

SIZE = 32


def _check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _seg_model() -> DeepLabV3:
    return DeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25)


def dryrun_multichip(log=print, stopwatch: Stopwatch | None = None) -> dict:
    """The dryrun on every rank of the process group (world n); returns the
    figures it printed. ``stopwatch`` times each stage in place."""
    n = dist.get_world_size()
    model_axis = 2 if (n % 2 == 0 and n >= 4) else 1
    mesh = make_mesh(data=n // model_axis, model=model_axis)
    say = log if is_main_rank() else (lambda *a: None)
    dev = mesh.device
    sw = stopwatch if stopwatch is not None else Stopwatch(dev)
    batch = 2 * mesh.data  # 2 examples per data shard
    rng = np.random.default_rng(0)

    state = create_seg_state(_seg_model(), seed=0, lr=1e-3, mesh=mesh)
    images = rng.uniform(0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    masks = rng.integers(0, 2, (batch, SIZE, SIZE)).astype(np.int32)
    x, m, v = shard_batch(mesh, images, masks, np.ones((batch,), bool))
    seed_dropout(state.model, 1)
    with sw.phase("step", images=batch):
        loss = float(seg_train_step(state, x, m, v, mesh=mesh))
    _check(np.isfinite(loss), f"multichip step produced {loss}")
    say(f"dryrun_multichip OK: mesh data={mesh.data} x model={mesh.model}, "
        f"batch {batch}, loss {loss:.4f}")

    state2 = create_seg_state(_seg_model(), seed=2, lr=1e-3, mesh=mesh)
    n_imgs = batch * 2 + 1  # ragged on purpose: wrap-around padding and a short tail
    ds_images = rng.uniform(0, 255, (n_imgs, SIZE, SIZE, 3)).astype(np.uint8)
    ds_masks = rng.integers(0, 2, (n_imgs, SIZE, SIZE)).astype(np.uint8)
    with sw.phase("dp_epoch", images=n_imgs):
        state2, ep_loss = train_segmentation_model(state2, ds_images, ds_masks, num_epochs=1,
                                                   batch_size=batch, seg_size=SIZE, mesh=mesh,
                                                   log=lambda *a: None)
    _check(np.isfinite(ep_loss), f"dp epoch loss {ep_loss}")
    say(f"dryrun dp chunked epoch OK: loss {ep_loss:.4f}")

    labels = rng.integers(0, 5, (batch,)).astype(np.int64)
    cams = None
    with sw.phase("cam_mask", images=batch):
        if is_main_rank():
            clf = init_weights(CamClassifier(num_classes=5, depth=18, width_multiplier=0.25),
                               torch.Generator().manual_seed(3)).to(dev)
            cam, _ = layercam(clf, torch.from_numpy(images).to(dev),
                              torch.from_numpy(labels).to(dev),
                              target_layers=("layer3", "layer4"), alpha=1.0,
                              alpha_mode="per_layer", output_size=SIZE)
            cams = (cam, cam_to_mask(cam, 0.3, True))
        cam, pmasks = replicate_tree(mesh, cams)
    _check(tuple(pmasks.shape) == (batch, SIZE, SIZE), f"pseudo-masks {tuple(pmasks.shape)}")
    say("dryrun cam->mask OK")

    rows = batch_sharding(mesh, batch)
    cam_t = torch.where(cam[rows] < 0.3, 0.0, cam[rows])
    with sw.phase("crf", images=batch // mesh.data):
        crf_masks = keep_largest_batch(apply_dense_crf(x * 255.0, cam_t, n_iters=2))
        crf_sub = apply_dense_crf(x * 255.0, cam_t, n_iters=2, bilat_backend="subsampled",
                                  key_stride=2)
    share = (batch // mesh.data, SIZE, SIZE)
    _check(tuple(crf_masks.shape) == share and tuple(crf_sub.shape) == share,
           f"CRF masks {tuple(crf_masks.shape)}, {tuple(crf_sub.shape)}")
    say("dryrun crf OK")

    state2.model.eval()
    with sw.phase("refine", images=batch // mesh.data):
        with torch.no_grad():
            probs = torch.softmax(state2.model(x.permute(0, 3, 1, 2)), dim=1)
        _, rloss = refine_from_soft_predictions(probs.permute(0, 2, 3, 1).contiguous(), x,
                                                pmasks[rows].int(), num_steps=2,
                                                use_pallas=False)
    # the mean over the batch: every data shard holds as many images
    rloss = float(all_reduce_value(rloss, mesh.group("data"))) / mesh.data
    _check(np.isfinite(rloss), f"refinement loss {rloss}")
    say(f"dryrun refine OK: loss {rloss:.4f}")

    eval_images = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    true_fg = rng.integers(0, 2, (batch, SIZE, SIZE)).astype(np.int32)
    with sw.phase("eval", images=batch):
        iou, acc = evaluate_segmentation_sharded(state2.model, eval_images, true_fg, mesh)
    _check(0.0 <= iou <= 1.0 and 0.0 <= acc <= 1.0, f"eval iou {iou} acc {acc}")
    say(f"dryrun sharded eval OK: iou {iou:.3f} acc {acc:.3f}")

    weights = full_state_dict(state2.model)  # every rank of the model axis gathers
    served_images = rng.uniform(0, 255, (batch - 1, SIZE, SIZE, 3)).astype(np.uint8)
    with sw.phase("serving", images=batch - 1):
        if is_main_rank():
            replica = _seg_model()
            replica.load_state_dict(weights, strict=True)
            devices = ([torch.device("cpu")] * mesh.data if dev.type == "cpu"
                       else visible_cards()[:mesh.data])
            pred = Predictor(replica, size=SIZE, max_batch=batch,
                             mesh=make_mesh(data=mesh.data, devices=devices), packed=True)
            served = pred(served_images)
            _check(served.shape == (batch - 1, SIZE, SIZE), f"served {served.shape}")
        dist.barrier()
    say("dryrun dp serving OK")
    say("dryrun_multichip full-cycle OK")
    return {"mesh": mesh.shape, "batch": batch, "loss": loss, "epoch_loss": ep_loss,
            "refine_loss": rloss, "iou": iou, "acc": acc, "seconds": dict(sw.times)}
