"""Offline visualisation, port of ``mvdetr_tpu/utils/visualize.py``.

- :func:`grid_overlay`: raw images warped to the BEV grid with grid lines
  burned in, to eyeball the homographies;
- :func:`shadow_points` and :func:`shadow_backprojected`: the deformable
  attention's sampling locations per camera in the BEV grid and
  back-projected into the images (the paper's "shadow" figures);
- :func:`detection_video_frames`: detections as per-camera boxes;
- :func:`capture_attention` and :func:`capture_forward_stages`: one
  inference forward of a model that returns what the figures need, the
  structures the JAX functions return;
- :func:`save_forward_stage_figures`: the per-stage channel-norm figures of
  ``--visualize``.

The host functions are numpy, as in the JAX package, and return uint8
images ``(H, W, 3)`` or arrays; saving is left to the caller, except in
:func:`save_forward_stage_figures`, which needs matplotlib.

The captures hook the modules from outside (forward hooks, removed after
the call), so the normal forward pays nothing for them. JAX's modules sow
the sampling locations as ``ref + clip(offsets, +-R) / [W, H]`` in the
``windowed`` and ``warped`` modes and unclipped in ``gather`` mode
(`mvdetr_tpu/models/deformable.py:182-188`); the port's windowed mode keeps
no reference map, so the capture builds the identity grid that
``resolve_attn_mode`` takes it for.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mvdetr_tpu_torch.geometry.projection import project_points
from mvdetr_tpu_torch.geometry.rig import CameraRig

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float64)
    img = (img - img.min()) / (img.max() - img.min() + 1e-8)
    return (img * 255).astype(np.uint8)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Undo the ImageNet normalisation, NHWC ``[..., 3]`` -> uint8."""
    out = np.asarray(img) * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def heatmap_overlay(heatmap: np.ndarray, image: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Burn a ``[H, W]`` heatmap into an image as a red overlay (resampled to
    the image's size where it differs)."""
    hm = np.asarray(heatmap, dtype=np.float64)
    hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-8)
    h, w = image.shape[:2]
    if hm.shape != (h, w):
        hm = warp_image_np(hm[..., None], np.diag([w / hm.shape[1], h / hm.shape[0], 1.0]), (h, w))[..., 0]
    out = np.asarray(image, dtype=np.float64).copy()
    out[..., 0] = out[..., 0] * (1 - alpha) + 255 * hm * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


def warp_image_np(img: np.ndarray, mat: np.ndarray, out_shape) -> np.ndarray:
    """Host perspective warp (``mat`` maps source to destination pixels),
    bilinear, zero padding; f64."""
    ho, wo = (int(v) for v in out_shape)
    inv = np.linalg.inv(mat)
    ys, xs = np.meshgrid(np.arange(ho, dtype=np.float64), np.arange(wo, dtype=np.float64), indexing="ij")
    pts = np.stack([xs, ys, np.ones_like(xs)], -1) @ inv.T
    sx = pts[..., 0] / pts[..., 2]
    sy = pts[..., 1] / pts[..., 2]
    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    out = np.zeros((ho, wo) + img.shape[2:], dtype=np.float64)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wgt = (1 - np.abs(sx - xi)) * (1 - np.abs(sy - yi)) * inb
            out += img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)] * wgt[..., None]
    return out


def grid_overlay(rig: CameraRig, images, world_reduce: int = 4, grid_step: int = 20) -> list:
    """Per-camera BEV projections of raw images (of any size: the
    homography is rescaled by the image's height) with green grid lines
    every ``grid_step`` cells."""
    out_shape = rig.Rworld_shape(world_reduce)
    mats = rig.proj_mats(world_reduce=world_reduce)
    results = []
    for cam, img in enumerate(images):
        sy = rig.img_shape[0] / img.shape[0]
        bev = _to_uint8(warp_image_np(np.asarray(img, dtype=np.float64), mats[cam] @ np.diag([sy, sy, 1.0]),
                                      out_shape))
        bev[::grid_step, :, :] = [0, 255, 0]
        bev[:, ::grid_step, :] = [0, 255, 0]
        results.append(bev)
    return results


def shadow_points(rig: CameraRig, sampling_locations: np.ndarray, attention_weights: np.ndarray, query_cells,
                  world_reduce: int = 4, downsample: int = 2) -> dict:
    """The attended points per camera in BEV cells: ``sampling_locations
    [Q, M, L, P, 2]`` (normalised) and ``attention_weights [Q, M, L, P]`` ->
    ``{cam: (points [Q*M*P, 2], weights [Q*M*P])}``. ``query_cells`` is
    accepted as in JAX and unused."""
    hs, ws = (v // downsample for v in rig.Rworld_shape(world_reduce))
    out = {}
    for cam in range(sampling_locations.shape[2]):
        pts = sampling_locations[:, :, cam, :, :].reshape(-1, 2) * np.array([ws, hs]) * downsample
        out[cam] = (pts, attention_weights[:, :, cam, :].reshape(-1))
    return out


def shadow_backprojected(rig: CameraRig, sampling_locations: np.ndarray, attention_weights: np.ndarray,
                         query_index: int, world_reduce: int = 4, downsample: int = 2):
    """One query's attended points (``sampling_locations [Q, M, L, P, 2]``
    normalised, ``attention_weights [Q, M, L, P]``, one frame's) in every
    camera: ``(bev, cams)`` with ``bev[cam] = (points [M*P, 2] in
    downsampled BEV cells, weights [M*P])`` and ``cams[cam] = (image points
    [M*P, 2] at z = 0, weights)``."""
    loc = np.asarray(sampling_locations)[query_index]  # [M, L, P, 2]
    wgt = np.asarray(attention_weights)[query_index]  # [M, L, P]
    hs, ws = (v // downsample for v in rig.Rworld_shape(world_reduce))
    coord_from_grid = np.linalg.inv(rig.Rworldgrid_from_worldcoord_mat(world_reduce, downsample))
    bev, cams = {}, {}
    for cam in range(loc.shape[1]):
        pts_grid = loc[:, cam].reshape(-1, 2) * np.array([ws, hs])  # xy cells
        weights = wgt[:, cam].reshape(-1)
        img_pts = project_points(rig.imgcoord_from_worldcoord_mat(cam, 0.0), project_points(coord_from_grid, pts_grid))
        bev[cam] = (pts_grid, weights)
        cams[cam] = (img_pts, weights)
    return bev, cams


def detection_video_frames(rig: CameraRig, det_rows: np.ndarray, images_by_frame, box_wh_m=(0.5, 1.8)) -> dict:
    """Detections ``det_rows [K, 3]`` (frame, x, y in the native grid) drawn
    as green boxes, ``box_wh_m`` metres wide and tall, on each camera's
    image: ``{frame: [image per camera]}`` in, the same with boxes out."""
    out = {}
    half_w = box_wh_m[0] / 2 / rig.worldcoord_unit
    for frame, imgs in images_by_frame.items():
        rows = det_rows[det_rows[:, 0] == frame]
        drawn = []
        for cam, img in enumerate(imgs):
            img = np.array(img, dtype=np.uint8).copy()
            h, w = img.shape[:2]
            sx = w / rig.img_shape[1]
            sy = h / rig.img_shape[0]
            for _, gx, gy in rows:
                wc = rig.worldcoord_from_worldgrid(np.array([[gx, gy]]))[0]
                foot = project_points(rig.imgcoord_from_worldcoord_mat(cam, 0.0), wc[None])[0]
                head = project_points(rig.imgcoord_from_worldcoord_mat(cam, box_wh_m[1]), wc[None])[0]
                side = project_points(rig.imgcoord_from_worldcoord_mat(cam, 0.0), (wc + [half_w, 0])[None])[0]
                bw = abs(side[0] - foot[0])
                x1, x2 = int((foot[0] - bw) * sx), int((foot[0] + bw) * sx)
                y1, y2 = int(head[1] * sy), int(foot[1] * sy)
                if x2 < 0 or x1 >= w or y2 < 0 or y1 >= h:
                    continue
                x1, x2 = np.clip([x1, x2], 0, w - 1)
                y1, y2 = np.clip([y1, y2], 0, h - 1)
                img[y1:y2 + 1, [x1, x2]] = [0, 255, 0]
                img[[y1, y2], x1:x2 + 1] = [0, 255, 0]
            drawn.append(img)
        out[frame] = drawn
    return out


def inference_outputs(model, batch):
    """The heads' outputs ``((world_heatmap, world_offset), (imgs_heatmap,
    imgs_offset, imgs_wh))`` of one eval-mode forward of ``batch`` on the
    model's device (the model's mode is put back)."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            return model(torch.as_tensor(batch["imgs"], device=dev),
                         torch.as_tensor(batch["affine_mats"], device=dev))[0]
    finally:
        model.train(was_training)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _identity_reference(h: int, w: int) -> torch.Tensor:
    """The normalised cell centres ``[H*W, 2]`` (x, y) of an ``h x w`` grid,
    as ``resolve_attn_mode`` builds the identity map."""
    ys, xs = np.meshgrid(np.linspace(0.5, h - 0.5, h) / h, np.linspace(0.5, w - 0.5, w) / w, indexing="ij")
    return torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32))


def _locations(attn, offsets: torch.Tensor, spatial_shape) -> torch.Tensor:
    """JAX's sown sampling locations ``[B, Q, M, L, P, 2]`` from one
    ``MSDeformAttn`` call's f32 ``offsets [B, Q, M, L, P, 2]``."""
    from mvdetr_tpu_torch.models.deformable import sampling_locations

    h, w = (int(v) for v in spatial_shape)
    b, q, m, l, p, _ = offsets.shape
    if attn.mode == "gather":  # [Q, 1, L, P or 1, 2]
        return sampling_locations(attn.reference_points.to(offsets.device), offsets, h, w)
    if attn.mode == "warped":  # the camera copies share the first one's map [H*W, L, P, 2]
        ref = torch.from_numpy(np.ascontiguousarray(attn.reference_map)).to(offsets.device)
        ref = ref.repeat(q // (h * w), 1, 1, 1)[:, None]
    else:
        ref = _identity_reference(h, w).to(offsets.device).repeat(q // (h * w), 1)[:, None, None, None, :]
    normalizer = torch.tensor([float(w), float(h)], device=offsets.device)
    return ref + torch.clamp(offsets, -float(attn.radius), float(attn.radius)) / normalizer


def capture_attention(model, batch):
    """One inference forward of ``model`` on ``batch`` (``imgs``,
    ``affine_mats``) capturing each deformable-attention layer's sampling
    (`deform_visualize.py:44-139` of the original MVDeTr takes these).
    Returns ``(outputs, layers)``: the model's outputs and, per encoder
    layer in order, ``{"sampling_locations": [B, Q, M, L, P, 2] normalised,
    "attention_weights": [B, Q, M, L, P]}`` f32 numpy arrays (the weights
    after the cast to the value's dtype, as JAX sows them). ``layers`` is
    empty for a model without deformable attention."""
    from mvdetr_tpu_torch.models.deformable import MSDeformAttn

    attns = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    seen = [{} for _ in attns]
    handles = []
    for rec, attn in zip(seen, attns):
        handles.append(attn.register_forward_pre_hook(lambda mod, args, rec=rec: rec.update(shape=args[2])))
        handles.append(attn.sampling_offsets.register_forward_hook(
            lambda mod, args, out, rec=rec: rec.update(offsets=out)))
        handles.append(attn.attention_weights.register_forward_hook(
            lambda mod, args, out, rec=rec: rec.update(logits=out)))
        handles.append(attn.value_proj.register_forward_hook(lambda mod, args, out, rec=rec: rec.update(dtype=out.dtype)))
    try:
        outputs = inference_outputs(model, batch)
    finally:
        for h in handles:
            h.remove()
    layers = []
    for rec, attn in zip(seen, attns):
        if "offsets" not in rec:
            continue
        m, l, p = attn.n_heads, attn.n_levels, attn.n_points
        b, q = rec["offsets"].shape[:2]
        offsets = rec["offsets"].reshape(b, q, m, l, p, 2).float()
        weights = torch.softmax(rec["logits"].reshape(b, q, m, l * p).float(), dim=-1).to(rec["dtype"])
        layers.append({"sampling_locations": to_numpy(_locations(attn, offsets, rec["shape"])),
                       "attention_weights": to_numpy(weights.reshape(b, q, m, l, p))})
    return outputs, layers


def capture_forward_stages(model, batch):
    """One inference forward capturing the per-stage maps that the original
    MVDeTr shows under ``visualize=True`` (`mvdetr.py:163-175,196-201,209-217`):
    ``img_featmap [B*N, Hf, Wf, C]`` (the per-view bottleneck map),
    ``world_inputs [B, N, Hw, Ww, C]`` (the warped stack) and
    ``world_feature [B, Hw, Ww, C]`` (the fused BEV feature), f32 numpy.
    Returns ``(outputs, stages)``."""
    stages = {}
    feat_module = model.bottleneck_dropout if model.bottleneck is not None else model.base

    def featmap(mod, args, out):
        out = out.flatten(0, 1) if out.dim() == 5 else out  # the bottleneck's dropout takes [B, N, C, H, W]
        stages["img_featmap"] = to_numpy(out.permute(0, 2, 3, 1))

    handles = [feat_module.register_forward_hook(featmap),
               model.world_feat.register_forward_pre_hook(
                   lambda mod, args: stages.update(world_inputs=to_numpy(args[0]))),
               model.world_feat.register_forward_hook(
                   lambda mod, args, out: stages.update(world_feature=to_numpy(out[0])))]
    try:
        outputs = inference_outputs(model, batch)
    finally:
        for h in handles:
            h.remove()
    return outputs, stages


def matplotlib_pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


STAGE_FIGURES = ("stage_img_featmap.jpg", "stage_world_inputs.jpg", "stage_world_feature.jpg")


def save_forward_stage_figures(model, batch, out_dir: str) -> list:
    """Write the per-stage channel-norm figures (``STAGE_FIGURES``) of
    :func:`capture_forward_stages` into ``out_dir``; returns their paths
    (none without matplotlib)."""
    plt = matplotlib_pyplot()
    if plt is None:
        return []
    os.makedirs(out_dir, exist_ok=True)
    _, stages = capture_forward_stages(model, batch)
    paths = []

    def norm(x):  # the channel L2 as the displayed intensity (`torch.norm(dim=1)`)
        return np.linalg.norm(x, axis=-1)

    if "img_featmap" in stages:
        fig, ax = plt.subplots()
        ax.imshow(norm(stages["img_featmap"][0]))
        ax.set_title("cam1 bottleneck feature (channel norm)")
        paths.append(os.path.join(out_dir, STAGE_FIGURES[0]))
        fig.savefig(paths[-1])
        plt.close(fig)
    if "world_inputs" in stages:
        wi = stages["world_inputs"]  # [B, N, Hw, Ww, C]
        n = wi.shape[1]
        fig, axes = plt.subplots(n, 1, figsize=(8, 2 * n))
        for cam in range(n):
            ax = axes[cam] if n > 1 else axes
            ax.imshow(norm(wi[0, cam]))
            ax.set_axis_off()
        fig.suptitle("warped per-camera BEV inputs (channel norm)")
        paths.append(os.path.join(out_dir, STAGE_FIGURES[1]))
        fig.savefig(paths[-1])
        plt.close(fig)
    if "world_feature" in stages:
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.imshow(norm(stages["world_feature"][0]))
        ax.set_title("fused world feature (channel norm)")
        paths.append(os.path.join(out_dir, STAGE_FIGURES[2]))
        fig.savefig(paths[-1])
        plt.close(fig)
    return paths
