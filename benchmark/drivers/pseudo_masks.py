"""The pseudo-mask stage: LayerCAM over the classifier, the threshold, the
dense CRF where the cell asks for it, the largest component and the
``MaskStore`` (``masks/pseudo.extract_cams`` then ``masks_from_cams``).

Set-up makes the classifier's weights from the seed (ResNet-50, layer4
dilated, BatchNorm on its running statistics), the seeded pets, and runs one
pass as the warm-up. A unit of the window is one pass over the pets: the
loader drained (``data/loader.batches``, padded to whole batches), CAMs
extracted on the device, masks derived batch by batch into a new store.

``check`` compares a seeded sample of each pass's pets with the plain
reference (``reference/cam.py``) in two stages and whole: the program's CAMs
against the reference's LayerCAM of the same pets (the mean absolute gap);
the program's stored masks against the reference's threshold, CRF and
largest component applied to the program's own CAMs (the share of mask
pixels that differ, leaving out pixels where the reference's CRF marginals
tie within ``TIE``); and the stored masks against the reference's masks
from its own CAMs, which holds the hand-over from the CAMs to the masks
(the share of pixels that differ, leaving out pixels whose reference CAM
lies within ``CAM_TIE`` of the threshold, with the CRF also every pixel
within the reach of its spatial kernel of one, and pixels whose marginals
tie within ``HANDOFF_TIE``).
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from benchmark.models import program_model, reference_model, set_precision

RATE = "pseudo_mask_img_per_s"
# a float32 filter and the float64 reference part where the CRF's marginals
# tie: pixels whose reference |Q1 - Q0| is under this are not compared
TIE = 1e-3
# the program's CAMs part from the reference's by up to a few thousandths at
# a pixel: pixels whose reference CAM is this near the threshold may fall on
# either side of it, and with the CRF they move their neighbours' marginals
CAM_TIE = 1e-2
HANDOFF_TIE = 2e-2


@dataclasses.dataclass
class State:
    model: object
    dataset: object
    sample: dict                     # (pass, row) → the stored mask
    rng: np.random.Generator
    crf: dict | None


def crf_kwargs(p: dict) -> dict | None:
    crf = p.get("crf")
    return None if crf is None else dict(crf)


def pets(run):
    from benchmark.inputs import pets as draw

    p = run.params
    images, labels, _ = draw(p["pets"], p["image_size"], p["image_size"], run.seed + 1,
                             run.device)
    return images, labels


def setup(run):
    from weaklysuperviseddl_tpu_torch.data.dataset import PetDataset

    from benchmark.inputs import make_weights

    p, cfg_m, dev = run.params, run.config, run.device
    set_precision(cfg_m)
    model = program_model(cfg_m, make_weights(reference_model(cfg_m), run.seed, dev), dev)
    images, labels = pets(run)
    images_np, labels_np = images.cpu().numpy(), labels.cpu().numpy().astype(np.int32)
    dataset = PetDataset(list(images_np), labels_np, [np.zeros(images_np.shape[1:3], np.uint8)]
                         * len(images_np), "train")
    state = State(model, dataset, {}, np.random.default_rng(run.seed), crf_kwargs(p))
    T = -(-p["pets"] // p["batch_size"])
    run.extra.update(batches_per_pass=T, batch=p["batch_size"])
    if run.trace and dev.type == "cuda":
        _span_k3(run)
    _, store = one_pass(state, run)                      # warm-up: every shape of a pass
    run.extra["fg_share"] = float(np.mean([store.get(k)[1].mean() for k in store.keys()]))
    return state


def one_pass(state: State, run):
    from weaklysuperviseddl_tpu_torch.data.loader import batches
    from weaklysuperviseddl_tpu_torch.masks.pseudo import extract_cams, masks_from_cams

    p = run.params
    loader = batches(state.dataset, p["batch_size"], pad_to_full=True)
    with run.spans("extract"):
        resident = extract_cams(loader, state.model, alpha=p["alpha"],
                                target_layers=tuple(p["target_layers"]),
                                alpha_mode=p["alpha_mode"], image_size=p["image_size"],
                                max_images=p["pets"])
        run.sync()
    with run.spans("derive"):
        store = masks_from_cams(resident, cam_thresh=p["cam_thresh"],
                                keep_largest_masks=True, use_crf=state.crf is not None,
                                crf_kwargs=state.crf)
    return resident, store


def _span_k3(run):
    """CUDA events around each bilateral-filter call of the CRF (K3), its
    query, key and value counts, for its roofline (benchmark side: the CRF
    module's own reference to the filter, wrapped)."""
    from weaklysuperviseddl_tpu_torch.masks import densecrf

    real = densecrf.gaussian_filter_cross
    calls = run.extra.setdefault("k3_calls", [])

    def timed(fq, fk, v):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(fq, fk, v)
        end.record()
        calls.append((start, end, fq.shape[0], fq.shape[1], fk.shape[1], fq.shape[2],
                      v.shape[2]))
        return out

    densecrf.gaussian_filter_cross = timed


def unit(state: State, run, index: int) -> float:
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda

    before = label_components_cuda.launches
    k3_before = len(run.extra.get("k3_calls", []))
    resident, store = one_pass(state, run)
    keys = store.keys()
    rows = state.rng.choice(len(keys), size=run.params["check_per_pass"], replace=False)
    cams = resident.cams[torch.from_numpy(rows).to(resident.cams.device)].cpu().numpy()
    for r, cam in zip(rows, cams):
        state.sample[(index, int(r))] = (cam, store.get(keys[r])[1].copy())
    if run.traced_unit == index:
        run.extra["traced_k2_launches"] = label_components_cuda.launches - before
        run.extra["traced_k3_calls"] = run.extra.get("k3_calls", [])[k3_before:]
    return float(len(keys))


def _reference_model(run):
    from benchmark.inputs import make_weights

    model = reference_model(run.config, "meta").to_empty(device=run.device)
    model.load_state_dict(make_weights(reference_model(run.config), run.seed, run.device))
    return model.eval()


def _crf(p: dict) -> dict | None:
    crf = crf_kwargs(p)
    if crf is not None and crf.pop("bilat_backend") != "subsampled":
        raise ValueError("the reference's CRF filters the stride-key_stride key subgrid")
    return crf


def reference_cams(run, rows: list[int], tf32: bool = False) -> torch.Tensor:
    from benchmark.reference.cam import cams
    from benchmark.reference.train import precision

    p = run.params
    images, labels = pets(run)
    idx = torch.tensor(rows, device=run.device)
    with precision(tf32):
        return cams(_reference_model(run), images[idx], labels[idx],
                    tuple(p["target_layers"]), p["alpha"])


def reference_masks(run, rows: list[int], cam: torch.Tensor, dtype=torch.float32):
    """The reference's stored masks of pets ``rows`` from the CAMs ``cam``,
    and each pixel's margin from a tie of the CRF's marginals."""
    from benchmark.reference.cam import masks
    from benchmark.reference.serve import keep_largest

    images, _ = pets(run)
    idx = torch.tensor(rows, device=run.device)
    m, margin = masks(images[idx], cam.to(run.device), run.params["cam_thresh"],
                      _crf(run.params), dtype)
    return keep_largest(m), margin


def mismatch_share(got: np.ndarray, want: np.ndarray, margin: np.ndarray) -> float:
    """The share of mask pixels that differ, leaving out those whose
    reference marginals lie within ``TIE`` of a tie."""
    return float(((got != want) & (margin >= TIE)).mean())


def handoff_share(got: np.ndarray, want: np.ndarray, margin: np.ndarray,
                  ref_cam: torch.Tensor, p: dict) -> float:
    """The share of mask pixels that differ between the stored masks and the
    reference's masks from its own CAMs, leaving out pixels whose reference
    CAM lies within ``CAM_TIE`` of the threshold and, with the CRF, every
    pixel within the spatial kernel's reach of one and every pixel whose
    marginals tie within ``HANDOFF_TIE``."""
    near = (ref_cam - p["cam_thresh"]).abs() < CAM_TIE
    keep = ~near.numpy()
    crf = p.get("crf")
    if crf is not None:
        r = max(1, int(3 * crf["gauss_sxy"]))
        near = torch.nn.functional.max_pool2d(near[:, None].float(), 2 * r + 1, stride=1,
                                              padding=r)[:, 0] > 0
        keep = ~near.numpy() & (margin >= HANDOFF_TIE)
    return float(((got != want) & keep).mean())


def check(state: State, run) -> list:
    keys = sorted(state.sample)
    cams = torch.from_numpy(np.stack([state.sample[k][0] for k in keys]))
    served = np.stack([state.sample[k][1] for k in keys])
    rows = [r for _, r in keys]
    state.model = state.dataset = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    unique = sorted(set(rows))
    want = dict(zip(unique, reference_cams(run, unique).cpu()))
    cam_gap = float(torch.stack([(cams[i] - want[r]).abs().mean()
                                 for i, r in enumerate(rows)]).mean())
    ref_cam = torch.stack([want[r] for r in rows])
    run.extra.setdefault("notes", {})["cam_widest_gap"] = float((cams - ref_cam).abs().max())
    # the derive stage on the program's own CAMs (its start is checked above)
    share = mismatch_share(served, *reference_masks(run, rows, cams))
    # both stages and the hand-over, on the reference's own CAMs
    handoff = handoff_share(served, *reference_masks(run, rows, ref_cam), ref_cam, run.params)
    lim = run.limits
    return [("cam_mean_gap", cam_gap, lim["cam_mean_gap"]),
            ("mask_mismatch_share", share, lim["mask_mismatch_share"]),
            ("handoff_mismatch_share", handoff, lim["handoff_mismatch_share"])]


LIMIT_MODES = ("control",)


def limit_readings(run, mode: str) -> dict:
    """The control, each stage's reference in the next lower precision put
    in the program's place: LayerCAM with TF32 on against LayerCAM in
    float32, the masks from the same CAMs in bfloat16 against float32, and
    the masks from the TF32 CAMs against those from the float32 CAMs."""
    rows = sorted(np.random.default_rng(run.seed).choice(
        run.params["pets"], size=run.params["check_per_pass"] * 4, replace=False).tolist())
    want = reference_cams(run, rows)
    got = reference_cams(run, rows, tf32=True)
    masks, margin = reference_masks(run, rows, want)
    low, _ = reference_masks(run, rows, want, dtype=torch.bfloat16)
    from_low, _ = reference_masks(run, rows, got)
    want, got = want.cpu(), got.cpu()
    return {"cam_mean_gap": float((got - want).abs().mean()),
            "mask_mismatch_share": mismatch_share(low, masks, margin),
            "handoff_mismatch_share": handoff_share(from_low, masks, margin, want, run.params),
            "cam_widest_gap": float((got - want).abs().max())}
