"""Everything a run feeds the program, made from ``--seed``: the rig, the
weights, the training pool, the serving pool and the arrival schedule.

One generator reads each traffic file (``benchmark/traffic/<mix>.json``):
``kind`` ``train`` (a pool of batches, people per frame set, augmentation,
prefetch depth) or ``serve`` (a pool of frame sets, rigs, offered rate, the
rigs' phases as shares of their period, jitter). Every seed gets the same
amount of work: the same shapes, the same number of requests at the same
arrival phases, assigned to the rigs in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import reference
from benchmark.reference import geometry
from benchmark.reference.targets import build_targets

HEATMAP_BIAS = -2.19


class Seeds:
    """Independent streams drawn from one ``--seed`` (any whole number)."""

    def __init__(self, seed: int):
        state = np.random.SeedSequence(int(seed)).generate_state(5, dtype=np.uint64)
        self.weights, self.data, self.frames, self.dropout, self.schedule = (int(s) for s in state)


def rig_of(cfg: dict) -> dict:
    r = cfg["assumed"]["rig"]
    return geometry.make_rig(cfg["num_cam"], cfg["img_shape"], cfg["worldgrid_shape"], r["cell_meters"],
                             r["indexing"], r["worldcoord_unit"], r["origin_offset"], r["camera_height_m"],
                             r["camera_margin_m"], r["fov_x_deg"])


def input_hw(cfg: dict) -> tuple:
    """The frames' size at the model's input: stride 8 of the image at ``img_reduce``."""
    return tuple(s * 8 // cfg["img_reduce"] for s in cfg["img_shape"])


def make_weights(cfg: dict, rig: dict, seed: int, device) -> dict:
    """Every entry of the model's state dict, f32 on ``device``: LeCun-normal
    kernels (N(0, 1/fan_in)), zero biases, ones and zeros for the norms and
    running statistics, heatmap biases -2.19, the reference's offset bias,
    level embeddings N(0, 1) and the offset and attention-weight kernels
    N(0, scale^2); one normal draw on the device for all of them. The
    names and shapes are those of the configuration's reference model."""
    ref = reference.of(cfg)
    with torch.device("meta"):
        skeleton = ref.MVDeTr(cfg, rig)
    shapes = {k: tuple(v.shape) for k, v in skeleton.state_dict().items()}
    scale = cfg["assumed"]["weights"]["attention_scale"]
    random = [k for k in shapes if k.endswith("weight") and len(shapes[k]) >= 2 or k.endswith("lvl_embedding")]
    total = sum(math.prod(shapes[k]) for k in random)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device).split([math.prod(shapes[k]) for k in random])
    out = {}
    for k, z in zip(random, draw):
        shape = shapes[k]
        if k.endswith(("sampling_offsets.weight", "attention_weights.weight")):
            std = scale
        elif k.endswith("lvl_embedding"):
            std = 1.0
        else:
            std = 1.0 / math.sqrt(math.prod(shape[1:]))
        out[k] = (z * std).reshape(shape)
    offsets_bias = torch.as_tensor(ref.offset_bias(cfg))
    for k, shape in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(shape, dtype=torch.long, device=device)
        elif k.endswith("running_var") or (k.endswith("weight") and len(shape) == 1):
            out[k] = torch.ones(shape, device=device)
        elif k.endswith("sampling_offsets.bias"):
            out[k] = offsets_bias.to(device)
        elif k in ("img_heatmap.0.bias", "world_heatmap.0.bias"):
            out[k] = torch.full(shape, HEATMAP_BIAS, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def random_frames(cfg: dict, count: int, seed: int, device, pin: bool) -> np.ndarray:
    """``count`` frame sets ``[count, N, H, W, 3]`` of uniform uint8 at the
    model's input size, drawn on ``device`` and brought to host memory
    (pinned where ``pin``)."""
    h, w = input_hw(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randint(0, 256, (count, cfg["num_cam"], h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    host = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=pin and torch.cuda.is_available())
    host.copy_(frames)
    return host.numpy()


def random_affine(rng: np.random.Generator, img_shape, aug: dict) -> np.ndarray:
    """MVDeTr's view-coherent augmentation matrix (``image_utils.py:9-42``):
    horizontal flip, scale and translation about the full-resolution frame."""
    height, width = img_shape
    flip = np.eye(3)
    if rng.random() < aug["hflip"]:
        flip[0, 0], flip[0, 2] = -1.0, width
    s = rng.uniform(*aug["scale"])
    rs = np.eye(3)
    rs[:2] = [[s, 0.0, width / 2.0 - s * width / 2.0], [0.0, s, height / 2.0 - s * height / 2.0]]
    shift = np.eye(3)
    shift[0, 2] = rng.uniform(-1, 1) * aug["translate"] * width
    shift[1, 2] = rng.uniform(-1, 1) * aug["translate"] * height
    return shift @ rs @ flip


def frame_targets(cfg: dict, rig: dict, rng: np.random.Generator, people: int, affines: np.ndarray) -> tuple:
    """People at uniform cells of the full-resolution grid, their BEV
    targets, and each camera's targets through its feet (0 m) and heads
    (``people_height_m``) homographies and its augmentation affine."""
    gh, gw = cfg["worldgrid_shape"]
    img_h, img_w = cfg["img_shape"]
    r = cfg["img_reduce"]
    kernel, top_k = cfg["target_kernel_size"], cfg["top_k_targets"]
    pts = rng.uniform((0.0, 0.0), (gw, gh), (people, 2))
    world = build_targets((gh // cfg["world_reduce"], gw // cfg["world_reduce"]), pts[:, 0], pts[:, 1],
                          reduce=cfg["world_reduce"], top_k=top_k, kernel_size=kernel)
    feet = geometry.img_from_world(rig, 0.0)
    heads = geometry.img_from_world(rig, cfg["assumed"]["people_height_m"])

    def project(mat):
        hom = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ mat.T
        z = hom[:, 2:]
        return np.where(z > 1e-6, hom[:, :2] / np.where(z > 1e-6, z, 1.0), -1e6)

    cams = []
    for cam in range(cfg["num_cam"]):
        foot, head = project(affines[cam] @ feet[cam]), project(affines[cam] @ heads[cam])
        hgt = np.abs(foot[:, 1] - head[:, 1])
        cams.append(build_targets((-(-img_h // r), -(-img_w // r)), foot[:, 0], foot[:, 1], hgt / 2.5, hgt,
                                  reduce=r, top_k=top_k, kernel_size=kernel))
    return world, {k: np.stack([c[k] for c in cams]) for k in cams[0]}


def train_pool(cfg: dict, traffic: dict, rig: dict, seeds: Seeds, device) -> list:
    """``pool_batches`` batches of ``batch_size`` frame sets: frames in
    pinned host memory, augmentation affines ``[B, N, 3, 3]`` f32 and the
    stacked targets, as ``train_step`` takes them."""
    b, count = traffic["batch_size"], traffic["pool_batches"]
    frames = random_frames(cfg, b * count, seeds.frames, device, pin=True)
    rng = np.random.default_rng(seeds.data)
    lo, hi = traffic["people"]
    pool = []
    for i in range(count):
        affs, worlds, imgs_gt = [], [], []
        for _ in range(b):
            aff = np.stack([random_affine(rng, cfg["img_shape"], traffic["augmentation"])
                            for _ in range(cfg["num_cam"])])
            world, cams = frame_targets(cfg, rig, rng, int(rng.integers(lo, hi + 1)), aff)
            affs.append(aff.astype(np.float32))
            worlds.append(world)
            imgs_gt.append(cams)
        pool.append({"imgs": frames[i * b:(i + 1) * b], "affine_mats": np.stack(affs),
                     "world_gt": {k: np.stack([g[k] for g in worlds]) for k in worlds[0]},
                     "imgs_gt": {k: np.stack([g[k] for g in imgs_gt]) for k in imgs_gt[0]}})
    return pool


def serve_pool(cfg: dict, traffic: dict, seeds: Seeds, device) -> list:
    """``pool_frames`` requests of one frame set each: uint8 frames in
    pageable host memory and identity affines, no targets."""
    frames = random_frames(cfg, traffic["pool_frames"], seeds.frames, device, pin=False).copy()
    eye = np.tile(np.eye(3, dtype=np.float32), (1, cfg["num_cam"], 1, 1))
    return [{"imgs": frames[i:i + 1], "affine_mats": eye} for i in range(len(frames))]


def schedule(traffic: dict, seed: int, seconds: float, rate: float | None = None) -> list:
    """``(due seconds, rig, pool index)`` of every request due within
    ``seconds``: ``rigs`` periodic sources at ``rate / rigs`` each, rig r at
    the phase of a fixed share of the period (the seed permutes which rig
    takes which share), each arrival moved by a uniform jitter of
    +-``jitter_ms``; the pool cycles over each rig's requests."""
    rate = traffic["rate_per_s"] if rate is None else rate
    rigs = traffic["rigs"]
    period = rigs / rate
    rng = np.random.default_rng(seed)
    phases = rng.permutation(np.asarray(traffic["phases"], dtype=np.float64)) * period
    jitter = traffic["jitter_ms"] / 1e3
    pool = traffic["pool_frames"]
    out = []
    for r in range(rigs):
        k = 0
        while phases[r] + k * period < seconds:
            due = max(0.0, phases[r] + k * period + rng.uniform(-jitter, jitter))
            out.append((due, r, (r + k * rigs) % pool))
            k += 1
    return sorted(out)


def calibrate_running_stats(cfg: dict, rig: dict, weights: dict, frames: np.ndarray, device) -> None:
    """Set the running statistics of ``weights`` to the batch statistics
    that the reference's trunk takes over the calibration ``frames`` (one
    f32 forward), as a trained model's would be: a serving model normalises
    with them."""
    ref = reference.of(cfg)
    model = ref.MVDeTr(cfg, rig).to(device)
    model.load_state_dict(weights, strict=True)
    model.train()
    for m in model.modules():
        if hasattr(m, "calibrate"):
            m.calibrate = True
    eye = np.tile(np.eye(3, dtype=np.float32), (frames.shape[0], cfg["num_cam"], 1, 1))
    with torch.no_grad():
        model(torch.from_numpy(frames).to(device), ref.warp_coords(cfg, rig, eye).to(device))
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            weights[k] = v.detach().clone()
